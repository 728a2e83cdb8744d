"""End-to-end pipeline orchestrator (counterpart of
deep3d_aerial_tpu/pipeline/orchestrator.py), with the same file artifacts:

  workspace/
    sparse/               COLMAP model (input of view selection)
    export/               predef cams/images, image_path, viewpair, blocks,
                          scene_border (written by view selection, or input)
    dense/MVS/            <name>_init.pfm, _prob.pfm, [_normal.pfm], <name>.txt
    dense/fusion/         scene_i.ply (+ scene_i.txt border, scene_i.mvs)
    mesh/                 scene_i_mesh.ply, _mesh_refine.ply,
                          _mesh_refine_texture.ply (+ atlas .png)
    dsm/                  dsm.tif + dsm.tfw
    production/           copied final products

Ported: view selection from a COLMAP model, dense matching with AdaMVS,
CasMVSNet, UCSNet or MSREDNet (batched with `infer_batch_size`, with the
`.dmap` container and colour previews when switched on, and the
multi-host arguments `view_filter`, `view_order`, `on_view_done`), depth
fusion with the OpenMVS `.mvs` handoff, the mesh stage (graph-cut surface
from the `.mvs` scene through the native core, Taubin refine, the
photometric refine in PyTorch autograd on the pipeline's device when
switched on, the UV atlas texture), the DSM, and the pipelined run
(`run_dense_pipelined`: fusion and mesh on a host thread while dense
matching runs), in `compute_dtype` float32 or bfloat16 (the models' dtype;
the PFM, `.dmap` and PLY products stay float32), and in `warp_precision`
float32 or compensated (the models' argument: the double-single projection
in every sweep).

The pipeline runs on a CUDA device unless the caller asks for the CPU
(`device="cpu"`); with no CUDA device and no such request it raises.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..dsm import DSMConfig, DSMFromMesh, DSMFromPointCloud
from ..fusion import DepthFusion, FusionConfig, ViewGeometry
from ..fusion.fuse import ViewData
from ..io import text_formats as tf
from ..io.dmap import DepthDataRaw, write_dmap
from ..io.geotiff import write_geotiff, write_tfw
from ..io.pfm import read_pfm, write_pfm
from ..io.ply import read_ply, write_ply
from ..sparse import view_selection
from ..sparse.export import export_predef
from .colormaps import save_png
from .config import PipelineConfig
from .dataset import EvalDataset

def _join(*parts):
    return os.path.join(*parts)


def _check_dense_config(cfg: PipelineConfig) -> None:
    """Refuse a dense-matching setting the port does not run, before any
    work: an unknown value, or one that has no meaning in the port, raises
    ValueError."""
    from ..models import check_model_type
    from ..models.blocks import compensated_warp, compute_dtype

    check_model_type(cfg.model_type)
    compute_dtype(cfg.compute_dtype)
    compensated_warp(cfg.warp_precision)
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


def zero_non_finite(depth: torch.Tensor, conf: torch.Tensor):
    """A depth map's clean-up before anything reads it, in the JAX
    pipeline's order: where any depth pixel is not finite, that pixel's
    depth and confidence, and every non-finite confidence, become 0 (depth 0
    is invalid; fusion masks depth <= 0). Normals are taken after, from the
    cleaned depth. Returns (depth, conf, number of depth pixels zeroed)."""
    bad = ~torch.isfinite(depth)
    n_bad = int(bad.sum())
    if n_bad:
        depth = torch.where(bad, 0.0, depth)
        conf = torch.where(bad | ~torch.isfinite(conf), 0.0, conf)
    return depth, conf, n_bad


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
                 device: "str | torch.device" = "cuda",
                 data_folder: Optional[str] = None):
        self.device = resolve_device(device)
        self.ws = workspace
        self.cfg = config
        self.data_folder = data_folder
        # seconds per batch of infer_batch_size maps (one map when 1) of the
        # last dense_match, host clock around the forwards through the
        # device->host copy; map_batches names the maps of each entry
        self.map_seconds: List[float] = []
        self.map_batches: List[List[str]] = []
        # host seconds of each stage of the last run_dense or
        # run_dense_pipelined, by label; timeline: run_dense_pipelined's
        # events in seconds from its start
        self.stage_seconds: Dict[str, float] = {}
        self.timeline: Dict[str, float] = {}

        self.sparse_path = _join(workspace, "sparse")
        self.export_path = _join(workspace, "export")
        self.dense_path = _join(workspace, "dense")
        self.mvs_path = _join(self.dense_path, "MVS")
        self.fusion_path = _join(self.dense_path, "fusion")
        self.mesh_path = _join(workspace, "mesh")
        self.dsm_path = _join(workspace, "dsm")
        self.production_path = _join(workspace, "production")
        for p in (self.export_path, self.dense_path, self.mvs_path,
                  self.fusion_path, self.mesh_path, self.dsm_path,
                  self.production_path):
            os.makedirs(p, exist_ok=True)

    def _ensure_image_paths(self) -> None:
        """Build export/image_path.txt from the data folder when absent,
        matching COLMAP image names to files (by name, else by stem with
        the config's extension or a common one)."""
        out = _join(self.export_path, "image_path.txt")
        if os.path.exists(out) or self.data_folder is None:
            return
        from ..sparse import colmap

        _, images, _ = colmap.read_model(self.sparse_path)
        entries = []
        for im in sorted(images.values(), key=lambda v: v.id):
            path = _join(self.data_folder, im.name)
            if not os.path.exists(path):
                base = os.path.splitext(im.name)[0]
                for ext in (self.cfg.fext, ".png", ".jpg", ".jpeg", ".tif"):
                    cand = _join(self.data_folder, base + ext)
                    if os.path.exists(cand):
                        path = cand
                        break
            entries.append((im.id, im.name, os.path.abspath(path)))
        tf.write_image_paths(out, entries)

    # ---------------- stage 1: view selection -------------------------
    def select_view(self) -> None:
        """From the COLMAP model in sparse/: export/'s predef cameras and
        images (with depth ranges), image paths, scene blocks, view pairs
        and the scene border (host numpy, as the JAX package)."""
        cfg = self.cfg
        self._ensure_image_paths()
        export_predef(self.sparse_path, self.export_path)

        from ..sparse import colmap

        _, _, points = colmap.read_model(self.sparse_path)
        xyz = np.stack([p.xyz for p in points.values()]) if points else np.zeros((0, 3))
        blocks, border = view_selection.compute_scene_blocks(
            xyz,
            block_size=cfg.scene_block_size[1:3]
            if len(cfg.scene_block_size) == 3 else cfg.scene_block_size,
            overlap=cfg.block_overlap,
            bbx_border=cfg.bbx_border_scene,
        )
        block_refs, viewpairs = view_selection.select_views(
            self.sparse_path, blocks, mode=cfg.view_selection_mode,
            database_path=_join(self.ws, "database.db"),
        )
        tf.write_view_pairs(_join(self.export_path, "viewpair.txt"), viewpairs)
        tf.write_blocks(_join(self.export_path, "blocks.txt"), block_refs)
        tf.write_border(_join(self.export_path, "scene_border.txt"), border)

    # ---------------- stage 2: dense matching -------------------------
    def build_model(self):
        """The configured model on this pipeline's device, in eval mode,
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
        model = build_model(cfg.model_type, dtype=cfg.compute_dtype,
                            warp_precision=cfg.warp_precision, **kwargs)
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

    def eval_dataset(self, view_filter=None, view_order=None) -> EvalDataset:
        """The reference views dense_match infers, in its order: those of
        export/ (viewpair.txt), kept if `view_filter` holds their id, sorted
        by rank in `view_order` (ids it does not name last, in their order)."""
        cfg = self.cfg
        ds = EvalDataset(
            self.export_path,
            view_num=cfg.view_num,
            num_depth=cfg.num_depth,
            resize_scale=cfg.image_scale,
            max_h=cfg.max_h, max_w=cfg.max_w,
        )
        if view_filter is not None:
            ds.samples = [s for s in ds.samples if s[0] in view_filter]
        if view_order is not None:
            rank = {v: i for i, v in enumerate(view_order)}
            ds.samples.sort(key=lambda s: rank.get(s[0], 1 << 30))
        return ds

    def dense_match(self, model=None, view_filter=None, on_view_done=None,
                    view_order=None) -> None:
        """Infer and write one depth map per reference view. `model`
        defaults to build_model(). `view_filter`: optional set of ref image
        ids to process (multi-host ownership). `on_view_done(ref_id)`:
        called once every file of that view is written. `view_order`:
        optional ref-id order (see eval_dataset).

        `infer_batch_size` B > 1 runs the B forwards of a batch back to
        back on the device, then the batch's normals, then one
        device->host copy, and writes the files in sample order: the same
        kernels on the same inputs as B = 1, so the same files (on the card
        under torch.backends.cudnn.deterministic: cuDNN's default
        algorithms for the transposed convolutions sum in an order that
        varies from run to run). The last batch is not padded (the JAX
        package pads it for its compiled shape and discards the copies)."""
        cfg = self.cfg
        _check_dense_config(cfg)
        if self.device.type == "cuda":
            # convolutions outside the kernels (feature net, pair and 3-D
            # hourglasses) must not drop to TF32 on the card: float32 stays
            # float32, bfloat16 takes cuDNN's bfloat16 convs (float32 sums)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            print(f"[mvs] compute_dtype {cfg.compute_dtype}: TF32 off for "
                  "cuDNN and matmul")
        ds = self.eval_dataset(view_filter, view_order)
        # host seconds of each batch (a forward per map through one
        # device->host copy), and the names of the maps in it
        self.map_seconds = []
        self.map_batches = []
        if len(ds) == 0:
            return
        if model is None:
            model = self.build_model()
        B = max(1, int(cfg.infer_batch_size))
        with ThreadPoolExecutor(max_workers=2) as loader:
            futures = {i: loader.submit(ds.build, i)
                       for i in range(min(2 * B, len(ds)))}
            for start in range(0, len(ds), B):
                samples = []
                for i in range(start, min(start + B, len(ds))):
                    samples.append(futures.pop(i).result())
                    if i + 2 * B < len(ds):
                        futures[i + 2 * B] = loader.submit(ds.build, i + 2 * B)
                t0 = time.perf_counter()
                depth, conf, normals, n_bad = self._infer_batch(model, samples)
                took = time.perf_counter() - t0
                names = [s.ref_name for s in samples]
                self.map_seconds.append(took)
                self.map_batches.append(names)
                for k, s in enumerate(samples):
                    if n_bad[k]:
                        print(f"[mvs] WARNING: {n_bad[k]} non-finite depth px "
                              f"in {s.ref_name}; zeroed")
                    self._write_view(s, depth[k], conf[k],
                                     None if normals is None else normals[k])
                    if on_view_done is not None:
                        on_view_done(s.ref_id)
                print(f"[mvs] {names}: {took:.3f}s")

    def _infer_batch(self, model, samples):
        """The forwards of `samples`, back to back on the device, each map
        cleaned by zero_non_finite, the normals when switched on, and one
        device->host copy: (depth [B, H, W], conf [B, H, W], normals
        [B, H, W, 3] or None, non-finite depth pixels zeroed per map)."""
        from ..ops.normals import normals_from_depth

        dev = self.device
        with torch.inference_mode():
            outs = [model(torch.from_numpy(s.imgs).to(dev),
                          torch.from_numpy(s.rel_projs).to(dev),
                          s.depth_min, s.depth_max) for s in samples]
            parts, n_bad = [], []
            for s, out in zip(samples, outs):
                d, c, bad = zero_non_finite(out["depth"],
                                            out["photometric_confidence"])
                n_bad.append(bad)
                part = [d[..., None], c[..., None]]
                if self.cfg.save_normals:
                    K_inv = torch.from_numpy(np.linalg.inv(
                        s.ref_cam.K).astype(np.float32)).to(dev)
                    part.append(normals_from_depth(d, K_inv))
                parts.append(torch.cat(part, -1))
            host = torch.stack(parts).cpu().numpy()
        normals = host[..., 2:] if self.cfg.save_normals else None
        return host[..., 0], host[..., 1], normals, n_bad

    def _write_view(self, s, depth, conf, normals) -> None:
        """A view's files, in the JAX package's order: _init.pfm,
        _prob.pfm, [_normal.pfm], <name>.txt, [.dmap], [colour previews]."""
        cfg = self.cfg
        depth = np.ascontiguousarray(depth, np.float32)
        conf = np.ascontiguousarray(conf, np.float32)
        write_pfm(_join(self.mvs_path, f"{s.ref_name}_init.pfm"), depth)
        write_pfm(_join(self.mvs_path, f"{s.ref_name}_prob.pfm"), conf)
        if normals is not None:
            normals = np.ascontiguousarray(normals, np.float32)
            # stored in [0, 1]; fusion reads *2 - 1
            write_pfm(_join(self.mvs_path, f"{s.ref_name}_normal.pfm"),
                      (normals + 1.0) * 0.5)
        tf.write_mvs_cam(_join(self.mvs_path, f"{s.ref_name}.txt"), s.ref_cam)
        if cfg.save_dmap:
            # the OpenMVS raw container for DensifyPointCloud interop, with
            # the raw normals in [-1, 1] when they are saved
            cam = s.ref_cam
            R = cam.T_cw[:3, :3]
            C = -R.T @ cam.T_cw[:3, 3]
            write_dmap(_join(self.mvs_path, f"{s.ref_name}.dmap"), DepthDataRaw(
                image_file_name=s.ref_image_path,
                neighbor_ids=list(s.src_ids),
                image_size=(cam.height, cam.width),
                K=cam.K, R=R, C=C,
                d_min=float(s.depth_min), d_max=float(s.depth_max),
                depth=depth, normal=normals, confidence=conf))
        if cfg.display_depth:
            self._save_depth_preview(s.ref_name, depth, conf)

    def _save_depth_preview(self, name: str, depth: np.ndarray,
                            conf: np.ndarray) -> None:
        """Colour previews of depth (viridis, of -depth, non-finite pixels
        at the finite minimum) and confidence (magma, clipped to [0, 1]) in
        dense/MVS/color/, each scaled by its own range: the pixels of the
        JAX package's plt.imsave, written with PIL (pipeline/colormaps.py)."""
        color_dir = _join(self.mvs_path, "color")
        os.makedirs(color_dir, exist_ok=True)
        d = depth.copy()
        d[~np.isfinite(d)] = np.nanmin(d[np.isfinite(d)]) if np.isfinite(d).any() else 0
        save_png(_join(color_dir, f"{name}_init.png"), -d, "viridis")
        save_png(_join(color_dir, f"{name}_prob.png"),
                 np.nan_to_num(conf).clip(0, 1), "magma")

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

    @staticmethod
    def _write_mvs_scene(path, views: Dict[str, ViewData], fused) -> None:
        """Emit the OpenMVS Interface handoff next to the fused PLY
        (reference fusion_3d_normal.py:574-581): every loaded view, one
        platform each, and the fused points with their visibility."""
        from types import SimpleNamespace

        from ..io.mvs_interface import scene_from_fusion, write_mvs

        ordered = sorted(views.values(), key=lambda v: v.image_id)
        cam_records = []
        images = []
        id_to_index = {}
        for idx, v in enumerate(ordered):
            H, W = v.depth.shape
            cam_records.append(SimpleNamespace(K=v.geom.K, width=W, height=H))
            R_cw = np.asarray(v.geom.T_cw, np.float64)[:3, :3]
            center = np.asarray(v.geom.T_wc, np.float64)[:3, 3]
            images.append((v.image_id, idx, v.name, R_cw, center))
            id_to_index[v.image_id] = idx

        scene = scene_from_fusion(
            cam_records, images, fused.xyz, fused.visibility,
            normals=fused.normals, colors=fused.colors,
            image_id_to_index=id_to_index,
        )
        write_mvs(path, scene)

    # ---------------- stage 4: mesh -----------------------------------
    def create_mesh(self) -> List[str]:
        """ReconstructMesh + RefineMesh + TextureMesh equivalents per fused
        block (reference run_mesh pipeline, createmesh.py:145-172): the
        graph-cut surface from the block's .mvs scene (the 2.5-D mesh where
        the graph cut has none to offer), Taubin refine, the photometric
        refine on this pipeline's device when switched on, the texture."""
        from ..mesh import MeshConfig, create_mesh_from_scene
        from ..mesh.refine import RefineConfig, refine_mesh_file

        cfg = self.cfg
        mesh_cfg = photo_cfg = None
        atlas_kwargs = {}
        if cfg.mesh_config:
            # OpenMVS-style mesh YAML (reference mesh/config.yaml keys)
            from ..mesh.openmvs_config import load_openmvs_mesh_config

            mesh_cfg, _refine_cfg, photo_cfg, tex = \
                load_openmvs_mesh_config(cfg.mesh_config)
            if tex.get("ignored"):
                print(f"[mesh] config keys without an in-process equivalent "
                      f"(ignored): {', '.join(tex['ignored'])}")
            for key in ("empty_color", "outlier_threshold", "seam_level",
                        "global_seam_level", "size_multiple",
                        "packing_heuristic", "data_smoothness_ratio"):
                if key in tex:
                    atlas_kwargs[key] = tex[key]
        out = []
        for fname in sorted(os.listdir(self.fusion_path)):
            if not fname.endswith(".ply"):
                continue
            src = _join(self.fusion_path, fname)
            n_pts = read_ply(src)[0].shape[0]
            if n_pts < 4:
                # an (all but) empty fused block cannot seed a Delaunay
                # surface; meshing it would emit degenerate artifacts
                print(f"[mesh] WARNING: skipping {fname}: only {n_pts} "
                      f"fused points")
                continue
            dst = _join(self.mesh_path, fname.replace(".ply", "_mesh.ply"))
            # the visibility-driven graph-cut core reads the block's .mvs
            # scene (OpenMVS ReconstructMesh equivalent)
            mvs_path = _join(self.fusion_path, fname.replace(".ply", ".mvs"))
            create_mesh_from_scene(
                src, dst,
                mesh_cfg if mesh_cfg is not None else MeshConfig(
                    insert_distance=cfg.recons_insert_distance,
                    decimate_ratio=cfg.recons_decimate_ratio,
                ),
                mvs_path=mvs_path,
                method=cfg.mesh_method,
            )
            if cfg.refine_scale_times > 0:
                refined = _join(
                    self.mesh_path, fname.replace(".ply", "_mesh_refine.ply")
                )
                refine_mesh_file(dst, refined, RefineConfig(
                    iterations=10 * int(cfg.refine_scale_times),
                    decimate_ratio=cfg.refine_decimate_ratio,
                ))
                dst = refined
            views = self._texture_views()
            if cfg.refine_photometric and views:
                from ..mesh.refine import (PhotoRefineConfig,
                                           photometric_refine)
                from ..mesh.trimesh_io import read_mesh_ply, write_mesh_ply

                verts, faces = read_mesh_ply(dst)
                verts = photometric_refine(
                    verts, faces,
                    [(v.image, v.geom.K, v.geom.T_cw) for v in views],
                    photo_cfg if photo_cfg is not None else PhotoRefineConfig(
                        scales=max(1, int(cfg.refine_scale_times))),
                    device=self.device,
                )
                photo = _join(
                    self.mesh_path,
                    fname.replace(".ply", "_mesh_refine_photo.ply"))
                write_mesh_ply(photo, verts, faces)
                dst = photo
            if views:
                textured = _join(
                    self.mesh_path,
                    fname.replace(".ply", "_mesh_refine_texture.ply"),
                )
                if cfg.texture_atlas:
                    # full TextureMesh parity: UV chart atlas + PNG
                    from ..mesh.atlas import texture_atlas_mesh_file

                    texture_atlas_mesh_file(dst, textured, views,
                                            **atlas_kwargs)
                else:
                    from ..mesh.texture import texture_mesh_file

                    texture_mesh_file(dst, textured, views)
                dst = textured
            out.append(dst)
            print(f"[mesh] {dst}")
        return out

    def _texture_views(self):
        """TextureViews from the MVS per-view cam artifacts + source images."""
        from PIL import Image

        from ..mesh.texture import TextureView

        views = []
        for fname in sorted(os.listdir(self.mvs_path)):
            if not fname.endswith(".txt"):
                continue
            cam = tf.read_mvs_cam(_join(self.mvs_path, fname))
            if not (cam.image_path and os.path.exists(cam.image_path)):
                continue
            img = Image.open(cam.image_path).convert("RGB")
            if img.size != (cam.width, cam.height):
                img = img.resize((cam.width, cam.height))
            views.append(TextureView(
                geom=ViewGeometry.create(cam.K, cam.T_cw),
                image=np.asarray(img),
            ))
        return views

    # ---------------- stage 5: DSM ------------------------------------
    def create_dsm(self) -> Optional[str]:
        """dsm/dsm.tif + .tfw over the DSM border (the config's, else the
        scene border), from the meshes or the fused points."""
        cfg = self.cfg
        border_path = _join(self.export_path, "scene_border.txt")
        if cfg.bbx_border_dsm is not None:
            bbx = list(cfg.bbx_border_dsm)
        elif os.path.exists(border_path):
            bbx = list(tf.read_border(border_path))
        else:
            return None

        dcfg = DSMConfig(
            cell_size=tuple(cfg.dsm_uint),
            select_method=cfg.pc_select_method,
            interp_method=cfg.pc_interpolation_method,
        )

        if cfg.dsm_source == "mesh":
            from ..mesh.trimesh_io import read_mesh_ply

            grids = []
            for fname in sorted(os.listdir(self.mesh_path)):
                if fname.endswith(".ply"):
                    v, f = read_mesh_ply(_join(self.mesh_path, fname))
                    grids.append(DSMFromMesh(dcfg).create(v, f, bbx))
            if not grids:
                return None
            grid = np.full_like(grids[0], dcfg.nodata)
            for g in grids:
                grid = np.where(g != dcfg.nodata, np.maximum(grid, g), grid)
        else:
            pts = []
            for fname in sorted(os.listdir(self.fusion_path)):
                if fname.endswith(".ply"):
                    p, _, _ = read_ply(_join(self.fusion_path, fname))
                    pts.append(p)
            if not pts:
                return None
            allp = np.concatenate(pts)
            if allp.shape[0] == 0:
                print("[dsm] WARNING: no fused points; skipping DSM")
                return None
            grid = DSMFromPointCloud(dcfg).create(allp, bbx)

        out_tif = _join(self.dsm_path, "dsm.tif")
        write_geotiff(out_tif, grid, origin_xy=(bbx[0], bbx[3]),
                      cell_size=dcfg.cell_size, nodata=dcfg.nodata)
        write_tfw(_join(self.dsm_path, "dsm.tfw"), (bbx[0], bbx[3]),
                  dcfg.cell_size)
        print(f"[dsm] {out_tif} {grid.shape}")
        return out_tif

    # ---------------- production --------------------------------------
    def move_production(self) -> None:
        """Copy the products (.ply, .tif, .tfw) of fusion, mesh and DSM
        into production/Point_Cloud, Mesh and DSM."""
        mapping = {
            self.fusion_path: _join(self.production_path, "Point_Cloud"),
            self.mesh_path: _join(self.production_path, "Mesh"),
            self.dsm_path: _join(self.production_path, "DSM"),
        }
        for src, dst in mapping.items():
            os.makedirs(dst, exist_ok=True)
            for fname in os.listdir(src):
                if fname.endswith((".ply", ".tif", ".tfw")):
                    shutil.copy2(_join(src, fname), _join(dst, fname))

    # ---------------- pipelined run -----------------------------------
    def run_dense_pipelined(self, model=None) -> None:
        """Dense matching on this thread while a host worker fuses each
        scene block, in index order, as soon as its views are written, then
        meshes; then the DSM and the products, as run_dense.

        One fusion session serves every block, so the consumption state
        that keeps overlapping blocks from emitting a point twice spans
        them as in run_dense, and the products are run_dense's byte for
        byte. (The JAX package's worker fuses each block in a session of its
        own and duplicates points where blocks share views.) A view is
        final once dense_match has called on_view_done for it, i.e. after
        every file of it is written, or when dense_match is not to write it;
        the worker waits for a block's views (FusionSession.block_ready),
        writes a block's .mvs once the views it lists are final, and meshes
        once dense matching has ended (the texture takes every view). An
        exception of either thread fails the run.

        Sets stage_seconds (dense matching, depth fusion: the worker's time
        fusing blocks and writing their files, mesh, dsm, wall) and
        timeline: seconds from the start to the first block's fusion
        (first_block), to the last map written (last_map), to the end of
        dense matching (dense_done), of fusion (fusion_done) and of the
        worker (worker_done)."""
        cfg = self.cfg
        t_start = time.perf_counter()
        self.stage_seconds = {}
        timeline = self.timeline = {}

        def mark(key):
            timeline[key] = time.perf_counter() - t_start

        if cfg.run_view_selection:
            self.select_view()
            self.stage_seconds["view selection"] = time.perf_counter() - t_start
        _, names = tf.read_image_paths(_join(self.export_path, "image_path.txt"))
        name_of = {i: os.path.splitext(n)[0] for i, n in names.items()}
        pending = set()
        if cfg.run_mvs:
            _check_dense_config(cfg)
            pending = {name_of.get(r) for r, _ in self.eval_dataset().samples}
        done = set()
        dense_done = threading.Event()
        abort = threading.Event()
        changed = threading.Event()
        errors: List[BaseException] = []

        def ready(name):
            return dense_done.is_set() or name not in pending or name in done

        def on_view_done(ref_id):
            done.add(name_of.get(ref_id))
            mark("last_map")
            changed.set()
            if errors:  # the worker failed: stop dense matching too
                raise errors[0]

        def wait_until(cond):
            """Until cond() holds (True) or the run aborts (False)."""
            while not abort.is_set():
                changed.clear()
                if cond():
                    return True
                changed.wait()
            return False

        def host_worker():
            try:
                fusing = 0.0
                if cfg.run_depth_fusion:
                    # grad mode is per thread: fusion takes no gradients
                    with torch.no_grad():
                        session = FusionSession(self, ready=ready)
                        for bi in range(len(session.blocks)):
                            if not wait_until(lambda: session.block_ready(bi)):
                                return
                            t0 = time.perf_counter()
                            timeline.setdefault("first_block", t0 - t_start)
                            session.fuse_block_index(bi)
                            fusing += time.perf_counter() - t0
                        if not wait_until(dense_done.is_set):
                            return
                        t0 = time.perf_counter()
                        session.write_scenes()
                        fusing += time.perf_counter() - t0
                    self.stage_seconds["depth fusion"] = fusing
                    mark("fusion_done")
                if cfg.run_create_mesh:
                    if not wait_until(dense_done.is_set):
                        return
                    t0 = time.perf_counter()
                    self.create_mesh()
                    self.stage_seconds["mesh"] = time.perf_counter() - t0
                mark("worker_done")
            except BaseException as e:  # surfaces in the caller's thread
                errors.append(e)
                changed.set()

        worker = threading.Thread(target=host_worker, name="fusion-worker")
        worker.start()
        try:
            t0 = time.perf_counter()
            if cfg.run_mvs:
                self.dense_match(model=model, on_view_done=on_view_done)
                self.stage_seconds["dense matching"] = time.perf_counter() - t0
            mark("dense_done")
            dense_done.set()
        except BaseException as e:
            abort.set()
            changed.set()
            worker.join()
            if errors and errors[0] is not e:
                e.add_note(f"the fusion worker failed too: {errors[0]!r}")
            raise
        changed.set()
        worker.join()
        if errors:
            raise errors[0]
        if cfg.run_create_dsm:
            t0 = time.perf_counter()
            self.create_dsm()
            self.stage_seconds["dsm"] = time.perf_counter() - t0
        self.move_production()
        self.stage_seconds["wall"] = time.perf_counter() - t_start
        print("[pipeline] pipelined: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in self.stage_seconds.items())
            + "; timeline " + ", ".join(f"{k} {v:.2f} s" for k, v in timeline.items()))

    # ---------------- full run ----------------------------------------
    def run_dense(self, model=None) -> None:
        """Every switched-on stage in order; `model` as for dense_match."""
        cfg = self.cfg
        stages = [
            (cfg.run_view_selection, "view selection", self.select_view),
            (cfg.run_mvs, "dense matching",
             lambda: self.dense_match(model=model)),
            (cfg.run_depth_fusion, "depth fusion", self.fuse_depth_map),
            (cfg.run_create_mesh, "mesh", self.create_mesh),
            (cfg.run_create_dsm, "dsm", self.create_dsm),
        ]
        self.stage_seconds = {}
        for enabled, label, fn in stages:
            if not enabled:
                continue
            t0 = time.perf_counter()
            fn()
            self.stage_seconds[label] = time.perf_counter() - t0
            print(f"[pipeline] {label}: "
                  f"{self.stage_seconds[label] / 60.0:.2f} min")
        self.move_production()


class FusionSession:
    """Stateful fusion over scene blocks with lazy view loading: views are
    read from disk on first use and shared across fuse_block calls, so the
    consumption-mask dedup persists across blocks.

    `ready(name)`, when given, says whether a view's files are final (the
    pipelined run: a view dense matching has still to write is not). A view
    that is not is treated as absent and probed again later; so is one
    found absent at an earlier block (its map may have landed since), where
    the JAX session remembers it as missing for good. Each block's `.mvs`
    lists the views that the blocks fused so far probe, as a session over
    maps that are all on disk loads them; it is written once all of those
    are final (`write_scenes`)."""

    def __init__(self, pipe: AerialPipeline, ready=None):
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
        self._ready = ready if ready is not None else (lambda name: True)
        self._probed: set = set()  # names the blocks fused so far probe
        self._scenes: Dict[int, tuple] = {}  # block -> (.mvs views, fused)

    def _get_view(self, name: str) -> Optional[ViewData]:
        if name in self.views:
            return self.views[name]
        if name in self._missing or not self._ready(name):
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

    def _refs(self, bi: int):
        """(id, name) of block `bi`'s reference views that have view pairs."""
        return [(r, self.name_of[r]) for r in self.blocks[bi][1]
                if r in self.name_of and r in self.pair_of]

    def _src_names(self, r: int):
        return [self.name_of[s] for s in self.pair_of[r] if s in self.name_of]

    def block_ready(self, bi: int) -> bool:
        """Whether fusing block `bi` now gives what it gives once every map
        is written: each ref is final and, for a ref with a map, so is each
        source up to the fusion_num-th distinct one with a map (fusion takes
        the first fusion_num sources that have one, in view-pair order)."""
        self._missing.clear()
        for r, rname in self._refs(bi):
            if not self._ready(rname):
                return False
            if self._get_view(rname) is None:
                continue
            found = set()
            for sname in self._src_names(r):
                if len(found) == self.fusion.cfg.fusion_num:
                    break
                if not self._ready(sname):
                    return False
                if sname != rname and self._get_view(sname) is not None:
                    found.add(sname)
        return True

    def fuse_block_index(self, bi: int) -> Optional[str]:
        """Fuse one scene block -> fused PLY path (None if it has no
        available ref views). Writes scene_<bi>.ply and .txt, and the
        block's .mvs once its views are final (write_scenes)."""
        pipe = self.pipe
        bbx, _ = self.blocks[bi]
        self._missing.clear()
        view_list = []
        for r, rname in self._refs(bi):
            self._probed.add(rname)
            if self._get_view(rname) is None:
                continue
            names = self._src_names(r)
            self._probed.update(names)
            view_list.append((rname, [s for s in names if self._get_view(s)]))
        if not view_list:
            return None
        fused = self.fusion.fuse_block(self.views, view_list, scene_range=bbx)
        scene = f"scene_{bi}"
        out_ply = _join(pipe.fusion_path, f"{scene}.ply")
        write_ply(out_ply, fused.xyz, fused.normals, fused.colors)
        tf.write_border(_join(pipe.fusion_path, f"{scene}.txt"), bbx)
        self._scenes[bi] = (set(self._probed), fused)
        self.write_scenes()
        print(f"[fusion] {scene}: {fused.xyz.shape[0]} points")
        return out_ply

    def write_scenes(self) -> List[int]:
        """Write the `.mvs` of each fused block whose views are all final;
        returns the blocks written."""
        written = []
        for bi in sorted(self._scenes):
            names, fused = self._scenes[bi]
            if not all(self._ready(n) for n in names):
                continue
            views = {n: v for n in names if (v := self._get_view(n)) is not None}
            self.pipe._write_mvs_scene(
                _join(self.pipe.fusion_path, f"scene_{bi}.mvs"), views, fused)
            del self._scenes[bi]
            written.append(bi)
        return written
