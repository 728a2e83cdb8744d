"""Camera conventions and projective algebra.

The framework uses ONE canonical convention internally:

  * camera axes  : XrightYdown (x → right of image, y → bottom, z → forward)
  * pose storage : world-to-camera transform T_cw, so  X_cam = R_cw @ X_w + t_cw

All other conventions (the 8 axis frames x {Rwc,Rcw} x {twc,tcw} the reference
supports via its ``ORotation`` table, reference format/cameras.py:19-137)
are converted at ingest time by :meth:`Pose.from_convention` and re-emitted by
:meth:`Pose.to_convention`.

Derivation of the conversion rules (O maps convention-frame camera coordinates
to canonical camera coordinates, X_canon = O @ X_conv; all O are orthogonal):

  R_cw_canon = O @ R_cw_conv          t_cw_canon = O @ t_cw_conv
  R_wc_canon = R_wc_conv @ O^T        t_wc is frame-independent (world vector)

Everything here is plain NumPy (host-side, float64) — the device-side compute
path receives already-canonical 4x4 projection matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

# Rotation bringing each convention's camera axes to the canonical
# XrightYdown axes (columns = convention basis vectors expressed canonically).
AXIS_ROTATIONS = {
    "xrightydown": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float64),
    "xleftydown": np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float64),
    "xleftyup": np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], dtype=np.float64),
    "xrightyup": np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float64),
    "xdownyright": np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], dtype=np.float64),
    "xdownyleft": np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float64),
    "xupyleft": np.array([[0, -1, 0], [-1, 0, 0], [0, 0, -1]], dtype=np.float64),
    "xupyright": np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=np.float64),
}


def _axis_rotation(name: str) -> np.ndarray:
    key = name.lower()
    if key not in AXIS_ROTATIONS:
        raise ValueError(
            f"unknown camera axis convention {name!r}; "
            f"one of {sorted(AXIS_ROTATIONS)}"
        )
    return AXIS_ROTATIONS[key]


@dataclasses.dataclass
class Camera:
    """Pinhole(+OpenCV distortion) intrinsics.

    Mirrors the reference 'predef' camera record
    (reference IO/params_io.py:67-90): id, size, pixelsize, fx fy cx cy,
    distortion [k1 k2 p1 p2].
    """

    camera_id: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    pixelsize: float = 0.0
    distortion: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    model: str = "OPENCV"

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    def scaled(self, scale: float) -> "Camera":
        """Intrinsics after uniform image rescale by `scale`."""
        return dataclasses.replace(
            self,
            width=int(self.width * scale),
            height=int(self.height * scale),
            fx=self.fx * scale,
            fy=self.fy * scale,
            cx=self.cx * scale,
            cy=self.cy * scale,
        )

    def cropped(self, start_x: int, start_y: int, new_w: int, new_h: int) -> "Camera":
        """Intrinsics after taking the window [start:start+new] of the image."""
        return dataclasses.replace(
            self,
            width=new_w,
            height=new_h,
            cx=self.cx - start_x,
            cy=self.cy - start_y,
        )


@dataclasses.dataclass
class Pose:
    """Canonical camera pose: XrightYdown axes, world-to-camera (R_cw, t_cw)."""

    R_cw: np.ndarray  # (3, 3)
    t_cw: np.ndarray  # (3,)

    def __post_init__(self):
        self.R_cw = np.asarray(self.R_cw, dtype=np.float64).reshape(3, 3)
        self.t_cw = np.asarray(self.t_cw, dtype=np.float64).reshape(3)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_convention(
        cls,
        R: np.ndarray,
        t: np.ndarray,
        axes: str = "xrightydown",
        rotation: str = "Rcw",
        translation: str = "tcw",
    ) -> "Pose":
        """Build a canonical pose from any supported external convention."""
        O = _axis_rotation(axes)
        R = np.asarray(R, dtype=np.float64).reshape(3, 3)
        t = np.asarray(t, dtype=np.float64).reshape(3)

        if rotation == "Rcw":
            R_cw = O @ R
        elif rotation == "Rwc":
            # R_wc_canon = R_wc_conv @ O.T ; R_cw = R_wc_canon^-1
            R_cw = (R @ O.T).T
        else:
            raise ValueError("rotation must be 'Rcw' or 'Rwc'")

        if translation == "tcw":
            t_cw = O @ t
        elif translation == "twc":
            t_cw = -R_cw @ t
        else:
            raise ValueError("translation must be 'tcw' or 'twc'")

        return cls(R_cw, t_cw)

    @classmethod
    def from_matrix(cls, T_cw: np.ndarray) -> "Pose":
        T_cw = np.asarray(T_cw, dtype=np.float64)
        return cls(T_cw[:3, :3], T_cw[:3, 3])

    # -- exports -----------------------------------------------------------
    def to_convention(
        self,
        axes: str = "xrightydown",
        rotation: str = "Rcw",
        translation: str = "tcw",
    ) -> Tuple[np.ndarray, np.ndarray]:
        O = _axis_rotation(axes)
        if rotation == "Rcw":
            R = O.T @ self.R_cw
        elif rotation == "Rwc":
            R = self.R_wc @ O
        else:
            raise ValueError("rotation must be 'Rcw' or 'Rwc'")
        if translation == "tcw":
            t = O.T @ self.t_cw
        elif translation == "twc":
            t = self.center
        else:
            raise ValueError("translation must be 'tcw' or 'twc'")
        return R, t

    @property
    def R_wc(self) -> np.ndarray:
        return self.R_cw.T

    @property
    def center(self) -> np.ndarray:
        """Camera center in world coordinates (t_wc)."""
        return -self.R_cw.T @ self.t_cw

    @property
    def T_cw(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = self.R_cw
        T[:3, 3] = self.t_cw
        return T

    @property
    def T_wc(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = self.R_wc
        T[:3, 3] = self.center
        return T

    # -- projective ops ----------------------------------------------------
    def world_to_image(
        self, K: np.ndarray, points_w: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Project world points (N,3) -> pixel coords (N,2) and depths (N,)."""
        points_w = np.asarray(points_w, dtype=np.float64).reshape(-1, 3)
        pc = points_w @ self.R_cw.T + self.t_cw
        depth = pc[:, 2]
        uvw = pc @ np.asarray(K, dtype=np.float64).T
        uv = uvw[:, :2] / uvw[:, 2:3]
        return uv, depth

    def image_to_world(
        self, K: np.ndarray, uv: np.ndarray, depth: np.ndarray
    ) -> np.ndarray:
        """Back-project pixels (N,2) at depths (N,) -> world points (N,3)."""
        uv = np.asarray(uv, dtype=np.float64).reshape(-1, 2)
        depth = np.asarray(depth, dtype=np.float64).reshape(-1)
        ones = np.ones_like(depth)
        pix = np.stack([uv[:, 0], uv[:, 1], ones], axis=-1) * depth[:, None]
        pc = pix @ np.linalg.inv(np.asarray(K, dtype=np.float64)).T
        return pc @ self.R_wc.T + self.center


def proj_matrix(K: np.ndarray, pose: Pose) -> np.ndarray:
    """4x4 projection: rows 0-2 = K @ [R_cw | t_cw], row 3 = [0 0 0 1].

    Same layout the reference feeds its networks
    (reference mvs/mvs_cas/datasets/cas_normal_eval.py:138-143).
    """
    P = pose.T_cw.copy()
    P[:3, :4] = np.asarray(K, dtype=np.float64) @ P[:3, :4]
    return P


def relative_projections(P: np.ndarray) -> np.ndarray:
    """[V, 4, 4] view projections -> [V-1, 4, 4] src-relative-to-ref transforms.

    rel_v = P_v @ inv(P_0), computed HOST-SIDE in float64. This inverse must
    never run in fp32 on device: cond(K[R|t]) ~ 1e4 for aerial focal lengths,
    which costs ~0.1-1 px of warp accuracy (the reason the reference grew a
    float64 warp variant, module.py:560).
    """
    P = np.asarray(P, dtype=np.float64)
    ref_inv = np.linalg.inv(P[0])
    return (P[1:] @ ref_inv).astype(np.float64)


def stage_relative_projections(P: np.ndarray, num_stages: int = 3) -> np.ndarray:
    """[V, 4, 4] full-res projections -> [S, V-1, 4, 4] per-stage rel projs."""
    return np.stack(
        [relative_projections(Ps) for Ps in stage_proj_pyramid(P, num_stages)]
    )


def scale_intrinsics(K: np.ndarray, scale: float) -> np.ndarray:
    K = np.asarray(K, dtype=np.float64).copy()
    K[0, :] *= scale
    K[1, :] *= scale
    return K


def stage_proj_pyramid(P: np.ndarray, num_stages: int = 3) -> list:
    """Coarse-to-fine projection pyramid: stage k scales pixel rows by 2^-(S-1-k).

    Stage `num_stages-1` is full resolution; matches the reference's
    /2, /4 row scaling (cas_normal_eval.py:153-162).
    """
    out = []
    for stage in range(num_stages):
        factor = 2.0 ** (num_stages - 1 - stage)
        Ps = np.asarray(P, dtype=np.float64).copy()
        Ps[..., :2, :] = Ps[..., :2, :] / factor
        out.append(Ps)
    return out


def qvec2rotmat(qvec: Sequence[float]) -> np.ndarray:
    """Hamilton quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = (float(v) for v in qvec)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float64,
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> Hamilton quaternion (w, x, y, z), w >= 0."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
            q = np.array(
                [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
                 (R[0, 2] + R[2, 0]) / s]
            )
        elif i == 1:
            s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2.0
            q = np.array(
                [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
                 (R[1, 2] + R[2, 1]) / s]
            )
        else:
            s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2.0
            q = np.array(
                [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                 (R[1, 2] + R[2, 1]) / s, 0.25 * s]
            )
    if q[0] < 0:
        q = -q
    return q
