"""Depth-map fusion: consistency-checked, confidence-weighted 3D point merge
(counterpart of deep3d_aerial_tpu/fusion/fuse.py).

  * the consistency check of one ref view against all its source views is
    one batched call on the device (fusion/consistency.py)
  * the cross-view deduplication keeps an explicit in-memory "consumed"
    depth per view: ref views are processed in a fixed order, and src
    pixels a ref consumed are zeroed for every later ref

Inputs are in-memory per-view records; the pipeline layer reads them from
the PFM artifacts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.csr import VisibilityCSR
from .consistency import (
    ViewGeometry,
    backproject_to_world,
    consistency_check,
    normal_cos_threshold,
    normals_to_world,
)


@dataclasses.dataclass
class FusionConfig:
    fusion_num: int = 10
    min_geo_consist: int = 4
    photometric_threshold: float = 0.2
    position_threshold: float = 1.0
    depth_threshold: float = 0.01
    normal_threshold_deg: float = 90.0
    skip_line: int = 2
    pc_format: str = "ply"


@dataclasses.dataclass
class ViewData:
    """One depth-map product (what `<name>_init.pfm` + friends encode)."""

    name: str
    image_id: int
    geom: ViewGeometry
    depth: np.ndarray  # [H, W] float32
    prob: Optional[np.ndarray] = None  # [H, W]
    normal_cam: Optional[np.ndarray] = None  # [H, W, 3], camera frame
    image: Optional[np.ndarray] = None  # [H, W, 3] float in [0, 1]

    def __post_init__(self):
        H, W = self.depth.shape
        if self.prob is None:
            self.prob = np.ones((H, W), np.float32)
        if self.normal_cam is None:
            # default: facing the camera
            n = np.zeros((H, W, 3), np.float32)
            n[:, :, 2] = -1.0
            self.normal_cam = n
        if self.image is None:
            self.image = np.full((H, W, 3), 0.5, np.float32)


@dataclasses.dataclass
class FusedPoints:
    xyz: np.ndarray  # [N, 3]
    colors: np.ndarray  # [N, 3] uint8
    normals: np.ndarray  # [N, 3]
    visibility: VisibilityCSR  # per point: image ids seeing it


class DepthFusion:
    def __init__(self, config: FusionConfig = FusionConfig(),
                 device: "str | torch.device" = "cuda"):
        self.cfg = config
        self.device = torch.device(device)
        # consumption state persists across fuse_block calls: views shared by
        # overlapping blocks must not re-emit points an earlier block consumed
        self._work_depth: Dict[str, np.ndarray] = {}
        self._cos_th = normal_cos_threshold(config.normal_threshold_deg)

    def _check_many(self, d_ref, n_ref_w, g_ref, d_srcs, n_srcs, g_srcs,
                    prob_ref) -> Dict[str, np.ndarray]:
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        cfg = self.cfg
        res = consistency_check(
            t(d_ref), t(n_ref_w), t(g_ref), t(d_srcs), t(n_srcs), t(g_srcs),
            t(prob_ref),
            position_threshold=float(cfg.position_threshold),
            depth_threshold=float(cfg.depth_threshold),
            normal_cos_threshold=float(self._cos_th),
            confidence_threshold=float(cfg.photometric_threshold),
        )
        return {k: v.cpu().numpy() for k, v in res.items()}

    def fuse_block(
        self,
        views: Dict[str, ViewData],
        view_list: Sequence[Tuple[str, Sequence[str]]],
        scene_range: Optional[Sequence[float]] = None,
    ) -> FusedPoints:
        """Fuse one scene block.

        views     : name -> ViewData
        view_list : [(ref_name, [src_name, ...]), ...] in fusion order
        scene_range : optional [xmin, xmax, ymin, ymax, zmin, zmax] crop
        """
        cfg = self.cfg
        work_depth = self._work_depth
        for n, v in views.items():
            if n not in work_depth:
                work_depth[n] = v.depth.copy()

        all_pts, all_colors, all_normals = [], [], []
        all_vis_vals, all_vis_counts = [], []

        for ref_name, src_names in view_list:
            if ref_name not in views:
                continue
            ref = views[ref_name]
            d_ref = work_depth[ref_name]
            H, W = d_ref.shape

            srcs = []
            seen = set()
            for s in src_names:
                if s in views and s not in seen and s != ref_name:
                    seen.add(s)
                    srcs.append(s)
                if len(srcs) == cfg.fusion_num:
                    break
            if not srcs:
                continue

            n_ref_world = normals_to_world(ref.normal_cam, ref.geom)
            res = self._check_many(
                d_ref, n_ref_world, ref.geom.as_stack(),
                np.stack([work_depth[s] for s in srcs]),
                np.stack([views[s].normal_cam for s in srcs]),
                np.stack([views[s].geom.as_stack() for s in srcs]),
                ref.prob,
            )
            masks = res["mask"]  # [S, H, W]
            xyz_src = res["xyz_world_src"]  # [S, H, W, 3]
            angle_conf = res["angle_confidence"]  # [S, H, W]
            src_y, src_x = res["src_y"], res["src_x"]

            # consume matched src pixels so later refs don't duplicate them
            for k, s in enumerate(srcs):
                m = masks[k]
                work_depth[s][src_y[k][m], src_x[k][m]] = 0.0

            # confidence-weighted world average (ref contributes weight 1)
            world_ref = backproject_to_world(d_ref, ref.geom)
            conf_sum = 1.0 + angle_conf.sum(0)
            xyz_sum = world_ref + (angle_conf[..., None] * xyz_src).sum(0)
            avg_xyz = xyz_sum / conf_sum[..., None]

            geo_sum = 1 + masks.sum(0).astype(np.int32)
            final_mask = (geo_sum >= cfg.min_geo_consist) & (d_ref > 0)

            # ref depth carries its mask forward
            d_masked = d_ref.copy()
            d_masked[~final_mask] = 0.0
            work_depth[ref_name] = d_masked

            if final_mask.sum() < 10:
                continue

            sel = np.zeros_like(final_mask)
            idx = np.nonzero(final_mask.reshape(-1))[0][:: cfg.skip_line]
            sel.reshape(-1)[idx] = True

            pts = avg_xyz[sel]
            if scene_range is not None:
                inb = (
                    (pts[:, 0] > scene_range[0]) & (pts[:, 0] < scene_range[1])
                    & (pts[:, 1] > scene_range[2]) & (pts[:, 1] < scene_range[3])
                )
            else:
                inb = np.ones(len(pts), bool)

            colors = (ref.image[sel] * 255).astype(np.uint8)
            normals = n_ref_world[sel]

            vis_stack = np.concatenate(
                [np.full((1, H, W), ref.image_id, np.int32),
                 masks * np.array([views[s].image_id for s in srcs],
                                  np.int32)[:, None, None]],
                axis=0,
            )  # [S+1, H, W]
            vis_sel = vis_stack[:, sel]  # [S+1, N]

            pts = pts[inb]
            colors = colors[inb]
            normals = normals[inb]
            vis_sel = vis_sel[:, inb]

            all_pts.append(pts)
            all_colors.append(colors)
            all_normals.append(normals)
            # CSR build: transpose to [N, S+1] so the positive entries of
            # each row concatenate in point order
            cols = vis_sel.T
            pos = cols > 0
            all_vis_vals.append(cols[pos])
            all_vis_counts.append(pos.sum(1).astype(np.int64))

        if not all_pts:
            return FusedPoints(
                np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8),
                np.zeros((0, 3), np.float32),
                VisibilityCSR(np.zeros(0, np.int32), np.zeros(0, np.int64)),
            )
        return FusedPoints(
            np.concatenate(all_pts).astype(np.float32),
            np.concatenate(all_colors),
            np.concatenate(all_normals).astype(np.float32),
            VisibilityCSR(np.concatenate(all_vis_vals),
                          np.concatenate(all_vis_counts)),
        )
