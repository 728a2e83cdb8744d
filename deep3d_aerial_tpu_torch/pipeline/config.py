"""Pipeline configuration: same YAML schema as the reference config.yaml.

Sections and fields mirror reference run.py:63-128 so existing configs
drive this pipeline unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import yaml


@dataclasses.dataclass
class PipelineConfig:
    # PREPROCESS
    fext: str = ".png"
    cams_ori: str = "XrightYup"
    rotation_ori: str = "Rwc"
    translation_ori: str = "twc"
    image_w: int = 3712
    image_h: int = 5504
    image_scale: float = 0.5

    # VIEWSELECTION
    run_view_selection: bool = True
    view_selection_mode: str = "triangulated_points"
    scene_block_size: Sequence[float] = (300.0, 600.0, 600.0)
    block_overlap: float = 4.0
    bbx_border_scene: Optional[Sequence[float]] = None

    # DENSEMATCH
    run_mvs: bool = True
    view_num: int = 5
    num_depth: int = 384
    min_interval: float = 0.1
    model_type: str = "adamvs"
    # cascade hypothesis counts; None -> the model's default (48, 32, 8).
    # Must match the trained checkpoint's architecture.
    ndepths: Optional[Sequence[int]] = None
    # per-stage window ratios (reference predict.py:54-55 'depth_inter_r'
    # analog); None -> the model default (4, 2, 1). Set alongside ndepths
    # to match how the checkpoint was trained.
    depth_ratios: Optional[Sequence[float]] = None
    pretrain_weight: Optional[str] = None
    # Explicit opt-in to run inference from random weights (capability /
    # shape testing only — outputs are statistically garbage). Without it,
    # a missing/invalid pretrain_weight is a hard error, never a silent
    # degradation.
    allow_random_weights: bool = False
    # colour previews of each depth map; not ported: True raises
    # NotImplementedError (ROADMAP)
    display_depth: bool = False
    # ref views per forward; the port runs one, any other value raises
    # NotImplementedError (ROADMAP)
    infer_batch_size: int = 1
    # 'float32' | 'compensated' — double-single projective chain for
    # numerically deep scenes (reference float64 warp, module.py:560)
    warp_precision: str = "float32"
    # compute-path implementations: only 'pallas' is taken. It runs the
    # hand-written CUDA kernels (ops/sweep.py, ops/red_step2.py) on a CUDA
    # device and their plain PyTorch versions on the CPU; any other value
    # raises ValueError.
    warp_impl: str = "pallas"
    red_impl: str = "pallas"
    # feature dtype: only 'float32' is ported; 'bfloat16' raises
    # NotImplementedError (ROADMAP)
    compute_dtype: str = "float32"
    # a switch of the TPU sweep's source windows; the CUDA sweep reads its
    # taps straight from device memory and has none, so any value but None
    # raises ValueError
    strict_coverage: Optional[bool] = None
    # emit <name>_normal.pfm (normals from predicted depth) next to each
    # depth map — the optional normal-aware fusion input
    # (reference fusion_3d_normal.py:191-195)
    save_normals: bool = False
    # also export each depth map as an OpenMVS .dmap container (io.dmap —
    # binary parity with reference IO/dmap_io.py:173 ExportDepthDataRaw)
    # for direct OpenMVS DensifyPointCloud interop
    save_dmap: bool = False

    # FUSION
    run_depth_fusion: bool = True
    fusion_num: int = 10
    geo_consist_num: int = 4
    photomatric_threshold: float = 0.2
    position_threshold: float = 1.0
    depth_threshold: float = 0.01
    normal_threshold: float = 90.0
    pc_format: str = "ply"

    # CREATEMESH
    run_create_mesh: bool = True
    # 'auto' | 'graphcut3d' | '2.5d' — auto prefers the visibility-driven
    # 3D Delaunay + graph-cut core (native) when the .mvs scene exists
    mesh_method: str = "auto"
    recons_insert_distance: float = 1.5
    recons_decimate_ratio: float = 1.0
    refine_decimate_ratio: float = 1.0
    texture_decimate_ratio: float = 1.0
    refine_scale_times: int = 1
    # variational photo-consistency vertex refinement (OpenMVS RefineMesh
    # core, reference createmesh.py:82-112); opt-in — needs source images
    refine_photometric: bool = False
    # UV chart atlas texturing (OpenMVS TextureMesh parity, reference
    # createmesh.py:115-142); False = per-vertex best-view colors
    texture_atlas: bool = True
    # optional OpenMVS-style mesh YAML (reference mesh/config.yaml keys,
    # loaded by mesh.openmvs_config) — overrides the per-knob fields above
    mesh_config: str = ""

    # CREATEDSM
    run_create_dsm: bool = True
    dsm_source: str = "mesh"
    pc_select_method: str = "Robust_Max"
    pc_interpolation_method: Optional[str] = None
    dsm_uint: Sequence[float] = (0.2, 0.2)
    dsm_size: Sequence[int] = (2900, 2900)
    bbx_border_dsm: Optional[Sequence[float]] = None

    @property
    def max_w(self) -> int:
        return int(self.image_w * self.image_scale)

    @property
    def max_h(self) -> int:
        return int(self.image_h * self.image_scale)

    @classmethod
    def from_yaml(cls, path) -> "PipelineConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        kwargs = {}
        section_map = {
            "PREPROCESS": ["fext", "cams_ori", "rotation_ori", "translation_ori",
                           "image_w", "image_h", "image_scale"],
            "VIEWSELECTION": ["run_view_selection", "view_selection_mode",
                              "scene_block_size", "block_overlap",
                              "bbx_border_scene"],
            "DENSEMATCH": ["run_mvs", "view_num", "num_depth", "min_interval",
                           "model_type", "ndepths", "depth_ratios",
                           "pretrain_weight",
                           "allow_random_weights", "display_depth",
                           "warp_precision", "save_normals", "save_dmap",
                           "warp_impl", "red_impl", "compute_dtype",
                           "infer_batch_size", "strict_coverage"],
            "FUSION": ["run_depth_fusion", "fusion_num", "geo_consist_num",
                       "photomatric_threshold", "position_threshold",
                       "depth_threshold", "normal_threshold", "pc_format"],
            "CREATEMESH": ["run_create_mesh", "mesh_method",
                           "recons_insert_distance",
                           "recons_decimate_ratio", "refine_decimate_ratio",
                           "texture_decimate_ratio", "refine_scale_times",
                           "refine_photometric", "texture_atlas",
                           "mesh_config"],
            "CREATEDSM": ["run_create_dsm", "dsm_source", "pc_select_method",
                          "pc_interpolation_method", "dsm_uint", "dsm_size",
                          "bbx_border_dsm"],
        }
        for section, fields in section_map.items():
            data = raw.get(section, {}) or {}
            for f in fields:
                if f in data:
                    kwargs[f] = data[f]
        return cls(**kwargs)

    def to_yaml(self, path) -> None:
        doc = {
            "PREPROCESS": {
                "fext": self.fext, "cams_ori": self.cams_ori,
                "rotation_ori": self.rotation_ori,
                "translation_ori": self.translation_ori,
                "image_w": self.image_w, "image_h": self.image_h,
                "image_scale": self.image_scale,
            },
            "VIEWSELECTION": {
                "run_view_selection": self.run_view_selection,
                "view_selection_mode": self.view_selection_mode,
                "scene_block_size": list(self.scene_block_size),
                "block_overlap": self.block_overlap,
                "bbx_border_scene": (
                    list(self.bbx_border_scene) if self.bbx_border_scene else None
                ),
            },
            "DENSEMATCH": {
                "run_mvs": self.run_mvs, "view_num": self.view_num,
                "num_depth": self.num_depth, "min_interval": self.min_interval,
                "model_type": self.model_type,
                "ndepths": list(self.ndepths) if self.ndepths else None,
                "pretrain_weight": self.pretrain_weight,
                "allow_random_weights": self.allow_random_weights,
                "display_depth": self.display_depth,
                "warp_precision": self.warp_precision,
                "save_normals": self.save_normals,
                "save_dmap": self.save_dmap,
            },
            "FUSION": {
                "run_depth_fusion": self.run_depth_fusion,
                "fusion_num": self.fusion_num,
                "geo_consist_num": self.geo_consist_num,
                "photomatric_threshold": self.photomatric_threshold,
                "position_threshold": self.position_threshold,
                "depth_threshold": self.depth_threshold,
                "normal_threshold": self.normal_threshold,
                "pc_format": self.pc_format,
            },
            "CREATEMESH": {
                "run_create_mesh": self.run_create_mesh,
                "mesh_method": self.mesh_method,
                "recons_insert_distance": self.recons_insert_distance,
                "recons_decimate_ratio": self.recons_decimate_ratio,
                "refine_decimate_ratio": self.refine_decimate_ratio,
                "texture_decimate_ratio": self.texture_decimate_ratio,
                "refine_scale_times": self.refine_scale_times,
                "refine_photometric": self.refine_photometric,
                "texture_atlas": self.texture_atlas,
                "mesh_config": self.mesh_config,
            },
            "CREATEDSM": {
                "run_create_dsm": self.run_create_dsm,
                "dsm_source": self.dsm_source,
                "pc_select_method": self.pc_select_method,
                "pc_interpolation_method": self.pc_interpolation_method,
                "dsm_uint": list(self.dsm_uint),
                "dsm_size": list(self.dsm_size) if self.dsm_size else None,
                "bbx_border_dsm": (
                    list(self.bbx_border_dsm) if self.bbx_border_dsm else None
                ),
            },
        }
        with open(path, "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)
