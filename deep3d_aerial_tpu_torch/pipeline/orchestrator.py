"""End-to-end pipeline orchestrator (counterpart of
deep3d_aerial_tpu/pipeline/orchestrator.py), with the same file artifacts:

  workspace/
    export/               predef cams/images, image_path, viewpair, blocks (input)
    dense/MVS/            <name>_init.pfm, _prob.pfm, [_normal.pfm], <name>.txt
    dense/fusion/         scene_i.ply (+ scene_i.txt border)
    production/           copied final products

Ported: dense matching with AdaMVS and depth fusion. View selection and
COLMAP ingest, mesh and DSM, the `.dmap` and `.mvs` outputs, the pipelined
run, batched inference and depth previews are not: switching one on raises
NotImplementedError naming its ROADMAP item.

The pipeline runs on a CUDA device unless the caller asks for the CPU
(`device="cpu"`); with no CUDA device and no such request it raises.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..fusion import DepthFusion, FusionConfig, ViewGeometry
from ..fusion.fuse import ViewData
from ..io import text_formats as tf
from ..io.pfm import read_pfm, write_pfm
from ..io.ply import write_ply
from .config import PipelineConfig
from .dataset import EvalDataset

def _join(*parts):
    return os.path.join(*parts)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP A: "
        f"{item}); switch it off in the config or run deep3d_aerial_tpu")


# pipeline switches of stages that are not ported: (stage, ROADMAP item)
_UNPORTED_STAGES = {
    "run_view_selection": ("view selection",
                           "view selection and COLMAP ingest (sparse/)"),
    "run_create_mesh": ("mesh", "mesh and DSM with the .mvs handoff"),
    "run_create_dsm": ("DSM", "mesh and DSM with the .mvs handoff"),
}


def _check_dense_config(cfg: PipelineConfig) -> None:
    """Refuse a dense-matching setting the port does not run, before any
    work: an unported one raises NotImplementedError naming its ROADMAP
    item, one that has no meaning in the port raises ValueError."""
    if cfg.compute_dtype != "float32":
        raise _not_ported(f"compute_dtype {cfg.compute_dtype!r}", "bf16")
    if cfg.warp_precision != "float32":
        raise _not_ported(f"warp_precision {cfg.warp_precision!r}",
                          "compensated warp")
    if cfg.save_dmap:
        raise _not_ported("save_dmap", ".dmap/normals/run_dense_pipelined")
    if cfg.infer_batch_size != 1:
        raise _not_ported(f"infer_batch_size {cfg.infer_batch_size}",
                          "batched inference")
    if cfg.display_depth:
        raise _not_ported("display_depth", "depth previews")
    for key in ("warp_impl", "red_impl"):
        if getattr(cfg, key) != "pallas":
            raise ValueError(
                f"{key} {getattr(cfg, key)!r}: the port takes only 'pallas'. "
                "On a CUDA device it runs the CUDA kernels, on device='cpu' "
                "their plain PyTorch versions; there is no other choice")
    if cfg.strict_coverage is not None:
        raise ValueError(
            "strict_coverage belongs to the TPU sweep's source windows; the "
            "CUDA sweep reads its taps straight from device memory and has "
            "none. Remove it from the config")


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device to run on; a CUDA device that is not there raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "(CLI: --device cpu) to run the plain PyTorch path on the CPU")
    return dev


class AerialPipeline:
    def __init__(self, workspace: str, config: PipelineConfig,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.ws = workspace
        self.cfg = config
        # seconds per depth map of the last dense_match, host clock around
        # a forward that ends in a device->host copy
        self.map_seconds: List[float] = []

        self.export_path = _join(workspace, "export")
        self.dense_path = _join(workspace, "dense")
        self.mvs_path = _join(self.dense_path, "MVS")
        self.fusion_path = _join(self.dense_path, "fusion")
        self.production_path = _join(workspace, "production")
        for p in (self.export_path, self.dense_path, self.mvs_path,
                  self.fusion_path, self.production_path):
            os.makedirs(p, exist_ok=True)

    # ---------------- stage 1: view selection -------------------------
    def select_view(self) -> None:
        raise _not_ported(*_UNPORTED_STAGES["run_view_selection"])

    # ---------------- stage 2: dense matching -------------------------
    def build_model(self):
        """The configured AdaMVS on this pipeline's device, in eval mode,
        with the weights of `pretrain_weight` (the JAX package's `.npz`) or, with
        `allow_random_weights`, seeded random ones."""
        from ..models import build_model
        from ..weights import init_random_weights, load_jax_weights

        cfg = self.cfg
        _check_dense_config(cfg)
        kwargs = {"num_depth": cfg.num_depth}
        if cfg.ndepths:
            kwargs["ndepths"] = tuple(int(x) for x in cfg.ndepths)
        if cfg.depth_ratios:
            kwargs["depth_interval_ratios"] = tuple(
                float(x) for x in cfg.depth_ratios)
        model = build_model(cfg.model_type, **kwargs)
        if cfg.pretrain_weight and os.path.exists(cfg.pretrain_weight):
            load_jax_weights(model, cfg.pretrain_weight)
        elif cfg.allow_random_weights:
            # explicit capability-testing mode
            init_random_weights(model, seed=0)
        else:
            raise FileNotFoundError(
                f"pretrain_weight {cfg.pretrain_weight!r} not found. Dense "
                "matching from random weights produces garbage depth; set "
                "DENSEMATCH.allow_random_weights: true only for explicit "
                "capability/shape testing.")
        return model.to(self.device).eval()

    def dense_match(self, model=None) -> None:
        """Infer and write one depth map per reference view. `model`
        defaults to build_model()."""
        cfg = self.cfg
        _check_dense_config(cfg)
        if self.device.type == "cuda":
            # float32 compute: convolutions outside the kernels (feature
            # net, pair hourglass) must not drop to TF32 on the card
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            print("[mvs] compute_dtype float32: TF32 off for cuDNN and matmul")
        ds = EvalDataset(
            self.export_path,
            view_num=cfg.view_num,
            num_depth=cfg.num_depth,
            resize_scale=cfg.image_scale,
            max_h=cfg.max_h, max_w=cfg.max_w,
        )
        self.map_seconds = []
        if len(ds) == 0:
            return
        if model is None:
            model = self.build_model()
        from ..ops.normals import normals_from_depth

        dev = self.device
        with ThreadPoolExecutor(max_workers=2) as loader:
            futures = {i: loader.submit(ds.build, i)
                       for i in range(min(2, len(ds)))}
            for i in range(len(ds)):
                s = futures.pop(i).result()
                if i + 2 < len(ds):
                    futures[i + 2] = loader.submit(ds.build, i + 2)
                t0 = time.perf_counter()
                with torch.inference_mode():
                    out = model(torch.from_numpy(s.imgs).to(dev),
                                torch.from_numpy(s.rel_projs).to(dev),
                                s.depth_min, s.depth_max)
                    depth_t = out["depth"]
                    normals = None
                    if cfg.save_normals:
                        K_inv = torch.from_numpy(np.linalg.inv(
                            s.ref_cam.K).astype(np.float32)).to(dev)
                        normals = normals_from_depth(
                            torch.nan_to_num(depth_t, nan=0.0), K_inv
                        ).cpu().numpy()
                    depth = depth_t.cpu().numpy().astype(np.float32)
                    conf = out["photometric_confidence"].cpu().numpy().astype(
                        np.float32)
                took = time.perf_counter() - t0
                self.map_seconds.append(took)
                if not np.isfinite(depth).all():
                    # numeric blowup: zero the bad pixels (depth 0 = invalid,
                    # fusion masks depth <= 0) and say so
                    bad = ~np.isfinite(depth)
                    print(f"[mvs] WARNING: {int(bad.sum())} non-finite depth "
                          f"px in {s.ref_name}; zeroed")
                    depth = np.where(bad, 0.0, depth).astype(np.float32)
                    conf = np.where(bad | ~np.isfinite(conf), 0.0,
                                    conf).astype(np.float32)
                write_pfm(_join(self.mvs_path, f"{s.ref_name}_init.pfm"), depth)
                write_pfm(_join(self.mvs_path, f"{s.ref_name}_prob.pfm"), conf)
                if normals is not None:
                    # stored in [0, 1]; fusion reads *2 - 1
                    write_pfm(_join(self.mvs_path, f"{s.ref_name}_normal.pfm"),
                              (normals + 1.0) * 0.5)
                tf.write_mvs_cam(_join(self.mvs_path, f"{s.ref_name}.txt"),
                                 s.ref_cam)
                print(f"[mvs] {s.ref_name}: {took:.3f}s")

    # ---------------- stage 3: fusion ---------------------------------
    def fusion_session(self) -> "FusionSession":
        return FusionSession(self)

    def fuse_depth_map(self, block_indices: Optional[List[int]] = None) -> List[str]:
        session = self.fusion_session()
        results = []
        for bi in range(len(session.blocks)):
            if block_indices is not None and bi not in block_indices:
                continue
            out = session.fuse_block_index(bi)
            if out:
                results.append(out)
        return results

    # ---------------- stages 4-5: mesh, DSM ---------------------------
    def create_mesh(self) -> List[str]:
        raise _not_ported(*_UNPORTED_STAGES["run_create_mesh"])

    def create_dsm(self) -> Optional[str]:
        raise _not_ported(*_UNPORTED_STAGES["run_create_dsm"])

    # ---------------- production --------------------------------------
    def move_production(self) -> None:
        dst = _join(self.production_path, "Point_Cloud")
        os.makedirs(dst, exist_ok=True)
        for fname in os.listdir(self.fusion_path):
            if fname.endswith(".ply"):
                shutil.copy2(_join(self.fusion_path, fname), _join(dst, fname))

    # ---------------- full run ----------------------------------------
    def run_dense(self, model=None) -> None:
        """Every switched-on stage in order; `model` as for dense_match."""
        cfg = self.cfg
        # refuse before any work is done, not after dense matching
        for switch, (what, item) in _UNPORTED_STAGES.items():
            if getattr(cfg, switch):
                raise _not_ported(what, item)
        stages = [
            (cfg.run_mvs, "dense matching",
             lambda: self.dense_match(model=model)),
            (cfg.run_depth_fusion, "depth fusion", self.fuse_depth_map),
        ]
        for enabled, label, fn in stages:
            if not enabled:
                continue
            t0 = time.time()
            fn()
            print(f"[pipeline] {label}: {(time.time() - t0) / 60.0:.2f} min")
        self.move_production()


class FusionSession:
    """Stateful fusion over scene blocks with lazy view loading: views are
    read from disk on first use and shared across fuse_block calls, so the
    consumption-mask dedup persists across blocks."""

    def __init__(self, pipe: AerialPipeline):
        cfg = pipe.cfg
        self.pipe = pipe
        self.fusion = DepthFusion(FusionConfig(
            fusion_num=cfg.fusion_num,
            min_geo_consist=cfg.geo_consist_num,
            photometric_threshold=cfg.photomatric_threshold,
            position_threshold=cfg.position_threshold,
            depth_threshold=cfg.depth_threshold,
            normal_threshold_deg=cfg.normal_threshold,
            pc_format=cfg.pc_format,
        ), device=pipe.device)
        _, names = tf.read_image_paths(
            _join(pipe.export_path, "image_path.txt"))
        pairs = tf.read_view_pairs(_join(pipe.export_path, "viewpair.txt"))
        self.blocks = tf.read_blocks(_join(pipe.export_path, "blocks.txt"))
        self.name_of = {i: os.path.splitext(n)[0] for i, n in names.items()}
        self.pair_of = {ref: [s for s, _ in plist] for ref, plist in pairs}
        self.views: Dict[str, ViewData] = {}
        self._missing: set = set()

    def _get_view(self, name: str) -> Optional[ViewData]:
        if name in self.views:
            return self.views[name]
        if name in self._missing:
            return None
        pipe = self.pipe
        dpath = _join(pipe.mvs_path, f"{name}_init.pfm")
        cpath = _join(pipe.mvs_path, f"{name}.txt")
        if not (os.path.exists(dpath) and os.path.exists(cpath)):
            self._missing.add(name)
            return None
        cam = tf.read_mvs_cam(cpath)
        depth = read_pfm(dpath)[0]
        ppath = _join(pipe.mvs_path, f"{name}_prob.pfm")
        prob = read_pfm(ppath)[0] if os.path.exists(ppath) else None
        npath = _join(pipe.mvs_path, f"{name}_normal.pfm")
        normal = read_pfm(npath)[0] * 2.0 - 1.0 if os.path.exists(npath) else None
        img = None
        if cam.image_path and os.path.exists(cam.image_path):
            from PIL import Image

            im = Image.open(cam.image_path).convert("RGB")
            if im.size != (depth.shape[1], depth.shape[0]):
                im = im.resize((depth.shape[1], depth.shape[0]))
            img = np.asarray(im, np.float32) / 255.0
        self.views[name] = ViewData(
            name=name, image_id=cam.image_id,
            geom=ViewGeometry.create(cam.K, cam.T_cw),
            depth=depth, prob=prob, normal_cam=normal, image=img,
        )
        return self.views[name]

    def fuse_block_index(self, bi: int) -> Optional[str]:
        """Fuse one scene block -> fused PLY path (None if it has no
        available ref views)."""
        pipe = self.pipe
        bbx, refs = self.blocks[bi]
        view_list = []
        for r in refs:
            if r not in self.name_of or r not in self.pair_of:
                continue
            rname = self.name_of[r]
            if self._get_view(rname) is None:
                continue
            srcs = [self.name_of[s] for s in self.pair_of[r]
                    if s in self.name_of and self._get_view(self.name_of[s])]
            view_list.append((rname, srcs))
        if not view_list:
            return None
        fused = self.fusion.fuse_block(self.views, view_list, scene_range=bbx)
        scene = f"scene_{bi}"
        out_ply = _join(pipe.fusion_path, f"{scene}.ply")
        write_ply(out_ply, fused.xyz, fused.normals, fused.colors)
        tf.write_border(_join(pipe.fusion_path, f"{scene}.txt"), bbx)
        print(f"[fusion] {scene}: {fused.xyz.shape[0]} points")
        return out_ply
