"""ctypes bridge to the C++ host-side cores (counterpart of
deep3d_aerial_tpu/utils/native.py).

The library is compiled at first use by `g++` from the checkout's
`native/dsm_reduce.cc` and `native/delaunay_mesh.cc`, with the flags of
`native/CMakeLists.txt`, into `<checkout>/build/native/`, named by a hash of
the sources, the flags and the CPU that `-march=native` resolves to, and
loaded with `ctypes`. A library that exists is reused. Each build writes to
a temporary name and moves it into place, so processes that build at once
do not collide. Nothing builds when a module is imported.

There is no fallback: a failed build raises with the compiler's output, so
no caller quietly takes a NumPy or 2.5-D path instead. The NumPy bodies of
the rasterisers and of `grid_decimate` stay reachable by name
(`dsm.rasterize.*_numpy`, `mesh.reconstruct.grid_decimate_numpy`) as the
plain versions the tests hold the native entries against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared", "-Wall")
SOURCES = ("dsm_reduce.cc", "delaunay_mesh.cc")

_REPO = Path(__file__).resolve().parents[2]
_NATIVE = _REPO / "native"
_BUILD = _REPO / "build" / "native"
_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_d, _i64 = ctypes.c_double, ctypes.c_int64
_REDUCE = [_f32p, _i64, _d, _d, _d, _d, _i64, _i64, ctypes.c_float, _f32p]
_SIGNATURES = {
    "dsm_reduce_max": (_i64, _REDUCE),
    "dsm_reduce_robust_max": (_i64, _REDUCE),
    "grid_decimate": (_i64, [_f32p, _i64, _d, _i64p]),
    "rasterize_mesh_max": (_i64, [_f64p, _i64, _d, _d, _d, _d, _i64, _i64,
                                  ctypes.c_float, _f32p]),
    "d3d_reconstruct_mesh": (ctypes.c_int, [
        _f64p, ctypes.c_int, _i32p, _i64p, _f64p, ctypes.c_int, _d, _d,
        ctypes.c_int, ctypes.POINTER(_i32p), _i64p]),
    "d3d_free": (None, [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def _target(cxx: str) -> str:
    """What `-march=native` means to `cxx` on this machine (its -march=
    and -mtune= lines), so that a build directory shared between machines
    never hands one CPU a library built for another."""
    try:
        out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True).stdout
    except OSError:
        return ""
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def library_path() -> Path:
    """The library of native/*.cc, named by a hash of the sources, the
    flags and the target CPU: a changed source builds anew."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (_NATIVE / name).read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS + (_target(CXX),)).encode())
    return _BUILD / f"libaerial3d_native_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library if it is missing; returns the seconds taken (0.0
    when it existed). The compiler's output is kept beside the library as
    `<lib>.log`. Raises RuntimeError, with that output, when g++ fails."""
    out = library_path()
    if out.exists():
        return 0.0
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), *(str(_NATIVE / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"native library build failed: cannot run "
                           f"{CXX!r}: {e}") from e
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed ({CXX} exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return took


def load_native() -> ctypes.CDLL:
    """The loaded library, built first if missing; raises if it cannot be."""
    global _LIB
    with _lock:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for fn, (restype, argtypes) in _SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIB = lib
        return _LIB


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def dsm_reduce(points: np.ndarray, bbx, cell, shape, nodata: float,
               robust: bool) -> np.ndarray:
    """Native per-cell (robust-)max."""
    lib = load_native()
    pts = np.ascontiguousarray(points, np.float32)
    rows, cols = shape
    grid = np.full(rows * cols, np.float32(nodata), np.float32)
    fn = lib.dsm_reduce_robust_max if robust else lib.dsm_reduce_max
    fn(_fp(pts), len(pts), float(bbx[0]), float(bbx[3]),
       float(cell[0]), float(cell[1]), rows, cols, np.float32(nodata),
       _fp(grid))
    return grid.reshape(rows, cols)


def grid_decimate_indices(points: np.ndarray, spacing: float) -> np.ndarray:
    lib = load_native()
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.int64)
    n = lib.grid_decimate(_fp(pts), len(pts), float(spacing),
                          out.ctypes.data_as(_i64p))
    return out[:n]


def reconstruct_mesh_native(
    points: np.ndarray,          # [N, 3] float
    vis_values: np.ndarray,      # CSR camera indices (int32)
    vis_offsets: np.ndarray,     # [N+1] int64
    cam_centers: np.ndarray,     # [M, 3] float
    alpha_vis: float = 1.0,
    inside_w: float = 2.0,
    min_component: int = 20,
) -> Optional[np.ndarray]:
    """Visibility-driven 3D Delaunay + graph-cut surface (the OpenMVS
    ReconstructMesh equivalent, native/delaunay_mesh.cc) -> [T, 3] int32
    triangle indices into `points`, or None when the core returns an error
    code (too few points, no tetrahedra): the algorithm's own rule."""
    lib = load_native()
    pts = np.ascontiguousarray(points, np.float64)
    vals = np.ascontiguousarray(vis_values, np.int32)
    offs = np.ascontiguousarray(vis_offsets, np.int64)
    cams = np.ascontiguousarray(cam_centers, np.float64)
    out_tris = _i32p()
    out_n = ctypes.c_int64(0)
    rc = lib.d3d_reconstruct_mesh(
        pts.ctypes.data_as(_f64p), pts.shape[0],
        vals.ctypes.data_as(_i32p), offs.ctypes.data_as(_i64p),
        cams.ctypes.data_as(_f64p), cams.shape[0],
        float(alpha_vis), float(inside_w), int(min_component),
        ctypes.byref(out_tris), ctypes.byref(out_n),
    )
    if rc != 0 or out_n.value == 0:
        if out_tris:
            lib.d3d_free(out_tris)
        return np.zeros((0, 3), np.int32) if rc == 0 else None
    tris = np.ctypeslib.as_array(out_tris, shape=(out_n.value, 3)).copy()
    lib.d3d_free(out_tris)
    return tris


def rasterize_mesh_native(
    tri_xyz: np.ndarray,  # [F, 3, 3] triangle vertices
    bbx, cell, shape, nodata: float,
) -> np.ndarray:
    """Native max-z triangle rasterization (dsm/rasterize hot loop)."""
    lib = load_native()
    tris = np.ascontiguousarray(tri_xyz, np.float64)
    rows, cols = shape
    grid = np.empty(rows * cols, np.float32)
    lib.rasterize_mesh_max(
        tris.ctypes.data_as(_f64p), tris.shape[0],
        float(bbx[0]), float(bbx[3]), float(cell[0]), float(cell[1]),
        rows, cols, np.float32(nodata), grid.ctypes.data_as(_f32p),
    )
    return grid.reshape(rows, cols)
