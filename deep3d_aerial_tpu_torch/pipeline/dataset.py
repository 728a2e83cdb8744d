"""Evaluation sample builder: predef export -> per-ref-view network inputs.

Equivalent of the reference eval dataset
(reference mvs/mvs_cas/datasets/cas_normal_eval.py:10-182): reads
cameras.txt / images.txt / image_path.txt / viewpair.txt, loads + rescales +
center-crops each view, and assembles per-sample inputs. Differences:
poses are canonical (XrightYdown/Tcw) from ingest, projection matrices are
float64 host-side, and the model receives RELATIVE projections per stage.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Tuple

import numpy as np

from ..geometry.camera import proj_matrix, stage_relative_projections
from ..io import text_formats as tf
from . import preprocess


@dataclasses.dataclass
class EvalSample:
    ref_id: int
    ref_name: str
    imgs: np.ndarray  # [V, H, W, 3] float32 normalized
    rel_projs: np.ndarray  # [S, V-1, 4, 4] float32
    depth_min: float
    depth_max: float
    ref_cam: tf.MVSCam  # output-side camera artifact
    ref_image_path: str
    src_ids: tuple = ()  # source view ids (e.g. .dmap neighbor list)


class EvalDataset:
    def __init__(
        self,
        export_dir: str,
        view_num: int = 5,
        num_depth: int = 384,
        resize_scale: float = 1.0,
        max_h: int = 0,
        max_w: int = 0,
        normalize: str = "mean",
        num_stages: int = 3,
    ):
        self.export_dir = export_dir
        self.view_num = view_num
        self.num_depth = num_depth
        self.resize_scale = resize_scale
        self.max_h = max_h
        self.max_w = max_w
        self.normalize = normalize
        self.num_stages = num_stages

        self.cams = tf.read_predef_cameras(os.path.join(export_dir, "cameras.txt"))
        self.images = tf.read_predef_images(os.path.join(export_dir, "images.txt"))
        self.paths, self.names = tf.read_image_paths(
            os.path.join(export_dir, "image_path.txt")
        )
        pairs = tf.read_view_pairs(os.path.join(export_dir, "viewpair.txt"))
        self.samples: List[Tuple[int, List[int]]] = []
        for ref, plist in pairs:
            srcs = tf.expand_view_pairs(plist, view_num)
            if srcs and ref in self.images:
                self.samples.append((ref, srcs))

    def __len__(self):
        return len(self.samples)

    def load_image(self, image_id: int) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(self.paths[image_id]).convert("RGB"))

    def build(self, idx: int) -> EvalSample:
        ref_id, src_ids = self.samples[idx]
        view_ids = [ref_id] + list(src_ids)

        imgs = []
        projs = []
        ref_cam_out = None
        depth_min = depth_max = 0.0
        for v, vid in enumerate(view_ids):
            info = self.images[vid]
            cam = self.cams[info.camera_id]
            img = self.load_image(vid)

            img, cam = preprocess.scale_to_network(img, cam, self.resize_scale)
            max_h = self.max_h or img.shape[0]
            max_w = self.max_w or img.shape[1]
            img, cam = preprocess.crop_to_network(img, cam, max_h, max_w)

            P = proj_matrix(cam.K, info.pose)
            projs.append(P)
            imgs.append(preprocess.center_image(img, self.normalize))

            if v == 0:
                depth_min, depth_max = info.depth_min, info.depth_max
                interval = (depth_max - depth_min) / self.num_depth
                ref_cam_out = tf.MVSCam(
                    T_cw=info.pose.T_cw, K=cam.K,
                    depth_min=depth_min, depth_interval=interval,
                    depth_num=self.num_depth, depth_max=depth_max,
                    width=img.shape[1], height=img.shape[0],
                    image_id=vid, name=os.path.splitext(info.name)[0],
                    image_path=self.paths[vid],
                )

        rel = stage_relative_projections(np.stack(projs), self.num_stages)
        return EvalSample(
            ref_id=ref_id,
            ref_name=os.path.splitext(self.images[ref_id].name)[0],
            imgs=np.stack(imgs).astype(np.float32),
            rel_projs=rel.astype(np.float32),
            depth_min=float(depth_min),
            depth_max=float(depth_max),
            ref_cam=ref_cam_out,
            ref_image_path=self.paths[ref_id],
            src_ids=tuple(src_ids),
        )

    def __iter__(self) -> Iterator[EvalSample]:
        for i in range(len(self)):
            yield self.build(i)
