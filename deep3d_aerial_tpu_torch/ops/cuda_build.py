"""Build and load the port's hand-written CUDA kernels.

Every source in `deep3d_aerial_tpu_torch/csrc/` is compiled at first use by
`nvcc` for `sm_90a` into a shared library with a plain C interface, named by
a hash of its source and flags, under `<checkout>/build/torch_kernels/`, and
loaded with `ctypes`. A library that exists is reused; a changed source,
or a changed header of `csrc/` that it includes, builds anew. Nothing here
runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

SOURCES = ("sweep", "red_step2", "red_step4")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[int, "torch.Tensor"] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the sweep entries: sweep_<mode>_<f32|bf16>[_comp] (the compensated
# projection takes the same arguments)
_SWEEP_ARGS = {"corr": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
               "cost": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
               "var": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}
_ARGTYPES = {
    "sweep": {f"sweep_{mode}_{dt}{comp}": args
              for mode, args in _SWEEP_ARGS.items()
              for dt in ("f32", "bf16") for comp in ("", "_comp")},
    "red_step2": {
        "red_step2_f32": [_P, _I, _P, _P, _P] + [_P] * 8 + [_I, _I, _I, _P],
        "red_step2_bf16": [_P, _I, _P, _P, _P] + [_P] * 9 + [_I, _I, _I, _P],
        "red_step2_param_floats": [_I, _I],
    },
    "red_step4": {
        "cf_conv3x3_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "cf_conv3x3_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "cf_conv3x3_scratch_floats": [_I, _I, _I, _I, _I, _I],
        "cf_conv3x3_tickets": [_I, _I, _I, _I, _I, _I],
        "red_step4_param_floats": [_I, _I],
        "red_step4_scratch_floats": [_I, _I, _I, _I],
        "red_step4_tickets": [_I, _I, _I, _I],
        "red_step4_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I, _I, ctypes.POINTER(_I), _P],
        "red_step4_bf16": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _I, ctypes.POINTER(_I), _P],
    },
}
# entries that return a size instead of an error code
_RESTYPES = {"red_step2_param_floats": _L, "red_step4_param_floats": _L,
             "red_step4_scratch_floats": _L, "red_step4_tickets": _L,
             "cf_conv3x3_scratch_floats": _L, "cf_conv3x3_tickets": _L}


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources(name: str) -> List[Path]:
    """csrc/<name>.cu and every header of csrc/ it includes (by
    `#include "..."`, followed into the headers)."""
    out, todo = [], [_CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in out:
            continue
        out.append(path)
        todo += [_CSRC / m.group(1) for m in
                 _INCLUDE.finditer(path.read_text())]
    return out


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of the source, the
    headers it includes and the flags: a changed header builds anew."""
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"{name}_{h.hexdigest()[:16]}.so"


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
                getattr(lib, fn).restype = _RESTYPES.get(fn, _I)
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def tickets(device, n: int):
    """At least n int32 zeros on `device`, kept per device: the conv
    template's K splits count on them, and each tile's last split sets its
    count back to 0, so the buffer is all zeros again when a launch ends.
    Launches on one stream at a time share it."""
    import torch

    device = torch.device(device)
    if device.index is None:  # "cuda": the current device, named by index
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        t = _tickets.get(device.index)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
            _tickets[device.index] = t
        return t


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (or its own code)."""
    if rc != 0:
        raise RuntimeError(f"{what}: {lib.error_string(rc).decode()} (code {rc})")
