"""Build and load the port's hand-written CUDA kernels.

Every source in `deep3d_aerial_tpu_torch/csrc/` is compiled at first use by
`nvcc` for `sm_90a` into a shared library with a plain C interface, named by
a hash of its source and flags, under `<checkout>/build/torch_kernels/`, and
loaded with `ctypes`. A library that exists is reused; a changed source
builds anew. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

SOURCES = ("sweep", "red_step2")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "sweep": {
        "sweep_corr_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sweep_cost_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "red_step2": {
        "red_step2_f32": [_P, _I, _P, _P] + [_P] * 8 + [_P] * 4
                         + [_I, _I, _I, _P],
    },
}


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"{name}_{key}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library of `names`, one nvcc process per
    source, all started together. Returns seconds per source built; the
    compiler's output (ptxas register and spill report) is kept beside
    each library as `<lib>.log`."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _ARGTYPES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (or its own code)."""
    if rc != 0:
        raise RuntimeError(f"{what}: {lib.error_string(rc).decode()} (code {rc})")
