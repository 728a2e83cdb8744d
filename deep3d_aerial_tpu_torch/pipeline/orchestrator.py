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
CasMVSNet, UCSNet or MSREDNet, depth fusion with the OpenMVS `.mvs`
handoff, the mesh stage (graph-cut surface from the `.mvs` scene through
the native core, Taubin refine, the photometric refine in PyTorch autograd
on the pipeline's device when switched on, the UV atlas texture) and the
DSM. The `.dmap` output, the pipelined run, batched inference and depth
previews are not: switching one on raises NotImplementedError naming its
ROADMAP item.

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

from ..dsm import DSMConfig, DSMFromMesh, DSMFromPointCloud
from ..fusion import DepthFusion, FusionConfig, ViewGeometry
from ..fusion.fuse import ViewData
from ..io import text_formats as tf
from ..io.geotiff import write_geotiff, write_tfw
from ..io.pfm import read_pfm, write_pfm
from ..io.ply import read_ply, write_ply
from ..sparse import view_selection
from ..sparse.export import export_predef
from .config import PipelineConfig
from .dataset import EvalDataset

def _join(*parts):
    return os.path.join(*parts)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP A: "
        f"{item}); switch it off in the config or run deep3d_aerial_tpu")


def _check_dense_config(cfg: PipelineConfig) -> None:
    """Refuse a dense-matching setting the port does not run, before any
    work: an unported one raises NotImplementedError naming its ROADMAP
    item, one that has no meaning in the port raises ValueError."""
    from ..models import check_model_type

    check_model_type(cfg.model_type)
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
        # seconds per depth map of the last dense_match, host clock around
        # a forward that ends in a device->host copy
        self.map_seconds: List[float] = []
        # host seconds of each stage of the last run_dense, by label
        self.stage_seconds: Dict[str, float] = {}

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
                    depth_t, conf_t, n_bad = zero_non_finite(
                        out["depth"], out["photometric_confidence"])
                    normals = None
                    if cfg.save_normals:
                        K_inv = torch.from_numpy(np.linalg.inv(
                            s.ref_cam.K).astype(np.float32)).to(dev)
                        normals = normals_from_depth(depth_t, K_inv).cpu().numpy()
                    depth = depth_t.cpu().numpy().astype(np.float32)
                    conf = conf_t.cpu().numpy().astype(np.float32)
                took = time.perf_counter() - t0
                self.map_seconds.append(took)
                if n_bad:
                    print(f"[mvs] WARNING: {n_bad} non-finite depth px in "
                          f"{s.ref_name}; zeroed")
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
        pipe._write_mvs_scene(
            _join(pipe.fusion_path, f"{scene}.mvs"), self.views, fused)
        print(f"[fusion] {scene}: {fused.xyz.shape[0]} points")
        return out_ply
