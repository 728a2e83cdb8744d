"""WHU-OMVS training dataset loader (a copy of the JAX package's
train/dataset_whu.py, comments aside, with one deviation: images are read
with PIL).

Layout parity with the reference loader (its datasets/cas_whu_omvs.py:
209-520):

  data_folder/index.txt                       scene list
  <scene>/images/<name>.png                   RGB views
  <scene>/cams/<name>.txt                     'Twc' + 4x4 (XrightYup) + K_mat
                                              + 3x3 + 'dmin dmax interval'
  <scene>/depths/<name>.exr                   GT depth (float EXR)
  <scene>/masks/<name>.png                    validity mask
  <scene>/normals/<name>.exr                  GT normals [0,1] XrightYup
  <scene>/info/viewpair.txt, image_path.txt   pair + name tables

Samples: imgs [V, H, W, 3] (normalized), rel_projs [S, V-1, 4, 4],
depth_min/max, depth_gt [H, W], mask [H, W] (+ optional normal GT).

The deviation: the JAX module reads every image with cv2, which the port
does not depend on. Here PNG and JPG views are read with PIL as RGB
(`read_rgb`), which for 8-bit PNGs is the array cv2's imread + BGR->RGB
gives. cv2 is imported lazily in the branches that need it alone: EXR
depth and masks (`gt_format` 'exr_mask'), 16-bit PNG depth ('png64') and
EXR normals.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.camera import Pose, stage_relative_projections
from ..pipeline import preprocess
from ..pipeline.augment import PHOTOMETRIC_DRAWS


@dataclasses.dataclass
class TrainSample:
    imgs: np.ndarray
    rel_projs: np.ndarray
    depth_min: float
    depth_max: float
    depth_gt: np.ndarray
    mask: np.ndarray
    normal_gt: Optional[np.ndarray] = None
    K_inv: Optional[np.ndarray] = None  # ref-view inverse intrinsics


def read_train_cam(path) -> Tuple[Pose, np.ndarray, float, float]:
    """Parse the rednet-style training cam txt: 'Twc' header, 4x4 Twc in
    XrightYup axes, 'K_mat', 3x3 K, depth line 'dmin dmax interval'."""
    words = open(path).read().split()
    T = np.array(words[1:17], dtype=np.float64).reshape(4, 4)
    K = np.array(words[18:27], dtype=np.float64).reshape(3, 3)
    dmin, dmax = float(words[27]), float(words[28])
    pose = Pose.from_convention(
        T[:3, :3], T[:3, 3], axes="xrightyup", rotation="Rwc", translation="twc"
    )
    return pose, K, dmin, dmax


def read_rgb(path) -> np.ndarray:
    """An image as uint8 RGB [H, W, 3] (PIL)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _read_name_table(path) -> Dict[int, str]:
    tokens = open(path).read().split()
    n = int(tokens[0])
    return {int(tokens[i * 3 + 1]): tokens[i * 3 + 2] for i in range(n)}


class WHUOMVSDataset:
    def __init__(
        self,
        data_folder: str,
        view_num: int = 5,
        normalize: str = "mean",
        max_h: int = 0,
        max_w: int = 0,
        num_stages: int = 3,
        with_normals: bool = False,
        gt_format: str = "exr_mask",
        augment: bool = False,
        seed: int = 0,
    ):
        """gt_format: 'exr_mask' (WHU-OMVS: EXR depth + PNG mask),
        'pfm' (DTU/BlendedMVS-style PFM depth, cas_whu_omvs.py:438-440),
        'png64' (WHU-MVS 16-bit PNG depth / 64, :436-437)."""
        self.data_folder = data_folder
        self.view_num = view_num
        self.normalize = normalize
        self.max_h = max_h
        self.max_w = max_w
        self.num_stages = num_stages
        self.with_normals = with_normals
        self.gt_format = gt_format
        self.augment = augment
        self._aug_rng = np.random.default_rng(seed)

        self.samples: List[Tuple[str, int, List[int], Dict[int, str]]] = []
        index_path = os.path.join(data_folder, "index.txt")
        scenes = open(index_path).read().split() if os.path.exists(index_path) else []
        for scene in scenes:
            info = os.path.join(data_folder, scene, "info")
            names = _read_name_table(os.path.join(info, "image_path.txt"))
            with open(os.path.join(info, "viewpair.txt")) as f:
                n = int(f.readline())
                for _ in range(n):
                    ref = int(f.readline().strip())
                    srcs = [int(x) for x in f.readline().split()[1::2]]
                    srcs = srcs[: view_num - 1]
                    if srcs:
                        if len(srcs) < view_num - 1:
                            srcs += [srcs[0]] * (view_num - 1 - len(srcs))
                        self.samples.append((scene, ref, srcs, names))

    def __len__(self):
        return len(self.samples)

    def _scene_path(self, scene, sub, name, ext):
        return os.path.join(self.data_folder, scene, sub, name + ext)

    def _read_gt_depth(self, scene, ref_base):
        if self.gt_format == "exr_mask":
            import cv2

            depth = cv2.imread(
                self._scene_path(scene, "depths", ref_base, ".exr"),
                cv2.IMREAD_UNCHANGED,
            )
            if depth is None:
                raise FileNotFoundError(
                    self._scene_path(scene, "depths", ref_base, ".exr")
                )
            if depth.ndim == 3:
                depth = depth[..., 0]
            mask_img = cv2.imread(
                self._scene_path(scene, "masks", ref_base, ".png"),
                cv2.IMREAD_GRAYSCALE,
            )
            mask = (
                (mask_img.astype(np.float32) / 255.0) > 0.5
                if mask_img is not None
                else depth > 0
            )
        elif self.gt_format == "pfm":
            from ..io.pfm import read_pfm

            depth = read_pfm(
                self._scene_path(scene, "depths", ref_base, ".pfm")
            )[0]
            mask = depth > 0
        elif self.gt_format == "png64":
            import cv2

            raw = cv2.imread(
                self._scene_path(scene, "depths", ref_base, ".png"),
                cv2.IMREAD_UNCHANGED,
            )
            depth = raw.astype(np.float32) / 64.0
            mask = depth > 0
        else:
            raise ValueError(f"unknown gt_format {self.gt_format!r}")
        depth = depth.astype(np.float32)
        depth[~mask] = 0.0
        return depth, mask

    def build(self, idx: int) -> TrainSample:
        scene, ref, srcs, names = self.samples[idx]
        view_ids = [ref] + srcs

        imgs, projs = [], []
        dmin = dmax = 0.0
        ref_name = names[ref]
        ref_K = None
        gt_window = None  # ref-view crop window, applied identically to GT
        for v, vid in enumerate(view_ids):
            name = os.path.splitext(names[vid])[0]
            img = read_rgb(self._scene_path(scene, "images", name, ".png"))
            pose, K, d0, d1 = read_train_cam(
                self._scene_path(scene, "cams", name, ".txt")
            )
            if self.max_h and self.max_w:
                from ..geometry.camera import Camera

                cam = Camera(0, img.shape[1], img.shape[0],
                             K[0, 0], K[1, 1], K[0, 2], K[1, 2])
                if v == 0:
                    gt_window = preprocess.crop_window(
                        img.shape[0], img.shape[1], self.max_h, self.max_w
                    )
                img, cam = preprocess.crop_to_network(
                    img, cam, self.max_h, self.max_w
                )
                K = cam.K
            if v == 0:
                ref_K = K.copy()
            P = pose.T_cw.copy()
            P[:3, :4] = K @ P[:3, :4]
            projs.append(P)
            if self.augment:
                from ..pipeline.augment import random_photometric

                img = random_photometric(img.astype(np.uint8), self._aug_rng)
            imgs.append(preprocess.center_image(img, self.normalize))
            if v == 0:
                dmin, dmax = d0, d1

        ref_base = os.path.splitext(ref_name)[0]
        depth, mask = self._read_gt_depth(scene, ref_base)

        H, W = imgs[0].shape[:2]
        if gt_window is not None:
            # slice GT with the SAME center-crop window as the ref image —
            # a top-left [:H,:W] slice would shift GT spatially whenever the
            # source image exceeds (max_h, max_w)
            sh, sw, H, W = gt_window
        else:
            sh = sw = 0
        depth = depth[sh:sh + H, sw:sw + W]
        mask = mask[sh:sh + H, sw:sw + W]

        normal = None
        if self.with_normals:
            npath = self._scene_path(scene, "normals", ref_base, ".exr")
            if os.path.exists(npath):
                import cv2

                n = cv2.imread(npath, cv2.IMREAD_UNCHANGED)[..., ::-1]
                n = np.clip(n * 2.0 - 1.0, -1.0, 1.0)
                n[:, :, 1] *= -1.0  # XrightYup -> XrightYdown
                n[:, :, 2] *= -1.0
                n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
                normal = n[sh:sh + H, sw:sw + W].astype(np.float32)

        rel = stage_relative_projections(np.stack(projs), self.num_stages)
        return TrainSample(
            imgs=np.stack(imgs).astype(np.float32),
            rel_projs=rel.astype(np.float32),
            depth_min=float(dmin),
            depth_max=float(dmax),
            depth_gt=depth,
            mask=mask.astype(np.float32),
            normal_gt=normal,
            K_inv=np.linalg.inv(ref_K).astype(np.float32),
        )

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                shard: Tuple[int, int] = (0, 1)):
        """Yield stacked batch dicts ready for parallel.make_train_step.

        shard (i, n): of each global batch of batch_size samples, only the
        i-th of n equal contiguous shares (a dp rank's: the share
        parallel.shard_batch takes), in the order one process would use;
        the other samples are not read, but with augmentation their draws
        are skipped, so each sample is augmented as in one process.
        ValueError when n does not divide batch_size."""
        index, count = shard
        if batch_size % count:
            raise ValueError(f"a batch of {batch_size} does not split into {count} "
                             "equal shares")
        share = range(index * batch_size // count, (index + 1) * batch_size // count)
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = []
            for pos, j in enumerate(order[i:i + batch_size]):
                if pos in share:
                    samples.append(self.build(j))
                elif self.augment:  # the draws build(j) would take
                    self._aug_rng.uniform(
                        size=PHOTOMETRIC_DRAWS * (1 + len(self.samples[j][2])))
            batch = {
                "imgs": np.stack([s.imgs for s in samples]),
                "rel_projs": np.stack([s.rel_projs for s in samples]),
                "depth_min": np.array([s.depth_min for s in samples], np.float32),
                "depth_max": np.array([s.depth_max for s in samples], np.float32),
                "depth_gt": np.stack([s.depth_gt for s in samples]),
                "mask": np.stack([s.mask for s in samples]),
            }
            if all(s.normal_gt is not None for s in samples):
                batch["normal_gt"] = np.stack(
                    [s.normal_gt for s in samples])
                batch["K_inv"] = np.stack([s.K_inv for s in samples])
            yield batch


def read_blendedmvs_cam(path) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Standard MVSNet/BlendedMVS cam txt ('extrinsic' + 4x4 Tcw direct,
    'intrinsic' + 3x3 K, 'dmin dinterval dnum dmax' — reference
    tr_read_blendedmvs_cam, cas_rscv.py:387-417) ->
    (T_cw [4,4], K [3,3], dmin, dmax)."""
    words = open(path).read().split()
    T_cw = np.array(words[1:17], dtype=np.float64).reshape(4, 4)
    K = np.array(words[18:27], dtype=np.float64).reshape(3, 3)
    dmin = float(words[27])
    dmax = float(words[30]) if len(words) > 30 else (
        dmin + float(words[28]) * float(words[29]))
    return T_cw, K, dmin, dmax


class BlendedMVSDataset(WHUOMVSDataset):
    """BlendedMVS-layout training set (reference BlendedMVS_list,
    cas_rscv.py:195-240):

      root/index.txt                          scan list
      <scan>/blended_images/%08d.jpg          RGB views
      <scan>/cams/%08d_cam.txt                MVSNet cam txt (Tcw direct)
      <scan>/cams/pair.txt                    'N; ref; k src score ...'
      <scan>/rendered_depth_maps/%08d.pfm     GT depth
    """

    def __init__(self, data_folder: str, view_num: int = 5,
                 normalize: str = "mean", max_h: int = 0, max_w: int = 0,
                 num_stages: int = 3, augment: bool = False, seed: int = 0):
        self.data_folder = data_folder
        self.view_num = view_num
        self.normalize = normalize
        self.max_h = max_h
        self.max_w = max_w
        self.num_stages = num_stages
        self.with_normals = False
        self.gt_format = "pfm"
        self.augment = augment
        self._aug_rng = np.random.default_rng(seed)

        self.samples = []
        index_path = os.path.join(data_folder, "index.txt")
        scans = (open(index_path).read().split()
                 if os.path.exists(index_path) else [])
        for scan in scans:
            pair_path = os.path.join(data_folder, scan, "cams", "pair.txt")
            with open(pair_path) as f:
                n = int(f.readline())
                for _ in range(n):
                    ref = int(f.readline().strip())
                    srcs = [int(x) for x in f.readline().split()[1::2]]
                    srcs = srcs[: view_num - 1]
                    if srcs:
                        if len(srcs) < view_num - 1:
                            srcs += [srcs[0]] * (view_num - 1 - len(srcs))
                        self.samples.append((scan, ref, srcs, None))

    def build(self, idx: int) -> TrainSample:
        scan, ref, srcs, _ = self.samples[idx]
        view_ids = [ref] + srcs
        root = os.path.join(self.data_folder, scan)

        imgs, projs = [], []
        dmin = dmax = 0.0
        ref_K = None
        gt_window = None
        for v, vid in enumerate(view_ids):
            img = read_rgb(os.path.join(root, "blended_images", f"{vid:08d}.jpg"))
            T_cw, K, d0, d1 = read_blendedmvs_cam(
                os.path.join(root, "cams", f"{vid:08d}_cam.txt"))
            if self.max_h and self.max_w:
                from ..geometry.camera import Camera

                cam = Camera(0, img.shape[1], img.shape[0],
                             K[0, 0], K[1, 1], K[0, 2], K[1, 2])
                if v == 0:
                    gt_window = preprocess.crop_window(
                        img.shape[0], img.shape[1], self.max_h, self.max_w)
                img, cam = preprocess.crop_to_network(
                    img, cam, self.max_h, self.max_w)
                K = cam.K
            if v == 0:
                ref_K = K.copy()
                dmin, dmax = d0, d1
            P = T_cw.copy()
            P[:3, :4] = K @ P[:3, :4]
            projs.append(P)
            if self.augment:
                from ..pipeline.augment import random_photometric

                img = random_photometric(img.astype(np.uint8), self._aug_rng)
            imgs.append(preprocess.center_image(img, self.normalize))

        from ..io.pfm import read_pfm

        depth = read_pfm(
            os.path.join(root, "rendered_depth_maps", f"{ref:08d}.pfm"))[0]
        mask = depth > 0
        depth = depth.astype(np.float32)
        depth[~mask] = 0.0

        H, W = imgs[0].shape[:2]
        if gt_window is not None:
            sh, sw, H, W = gt_window
        else:
            sh = sw = 0
        depth = depth[sh:sh + H, sw:sw + W]
        mask = mask[sh:sh + H, sw:sw + W]

        rel = stage_relative_projections(np.stack(projs), self.num_stages)
        return TrainSample(
            imgs=np.stack(imgs).astype(np.float32),
            rel_projs=rel.astype(np.float32),
            depth_min=float(dmin),
            depth_max=float(dmax),
            depth_gt=depth,
            mask=mask.astype(np.float32),
            K_inv=np.linalg.inv(ref_K).astype(np.float32),
        )
