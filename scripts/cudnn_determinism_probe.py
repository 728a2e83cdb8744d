"""Run-to-run reproducibility of the port's forwards on a CUDA card, and
what cuDNN's deterministic algorithms cost.

For each model at the 384x512 main-path frame (seeded random weights, the
synthetic survey of chip_smoke.py) and AdaMVS at 1856x2752, three modes:
`default` (cuDNN's own choice), `global` (torch.backends.cudnn.deterministic
for every call) and `transposed` (deterministic only around the transposed
convolutions of ops/conv.py). Each mode runs one forward three times and
says whether the depth maps are the same bytes, then the modes are timed
in three alternating rounds (CUDA events over host-issued forwards).

    python3 scripts/cudnn_determinism_probe.py

Needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MODES = ("default", "global", "transposed")


@contextlib.contextmanager
def deterministic(on):
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class _TransposedDeterministic:
    """Stands in for ops/conv.py's `F`: its transposed convolutions take
    cuDNN's deterministic algorithms when the mode says so."""

    def __init__(self, mode):
        self.mode = mode

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def conv_transpose2d(self, *args, **kw):
        with deterministic(self.mode["m"] != "default"):
            return torch.nn.functional.conv_transpose2d(*args, **kw)

    def conv_transpose3d(self, *args, **kw):
        with deterministic(self.mode["m"] != "default"):
            return torch.nn.functional.conv_transpose3d(*args, **kw)


def main() -> int:
    if not torch.cuda.is_available():
        print("cudnn_determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.ops import conv as convmod
    from deep3d_aerial_tpu_torch.ops import cuda_build
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda_build.build()
    dev = torch.device("cuda")
    mode = {"m": "default"}
    convmod.F = _TransposedDeterministic(mode)

    def forward(model, inputs, m):
        mode["m"] = m
        with torch.inference_mode(), deterministic(m == "global"):
            return model(*inputs)["depth"].clone()

    def ms_a_forward(model, inputs, m, n):
        mode["m"] = m
        with torch.inference_mode(), deterministic(m == "global"):
            model(*inputs)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                model(*inputs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n

    cases = ((cs.H0, cs.W0, ("adamvs", "msrednet", "casmvsnet", "ucsnet"), 10),
             (cs.FULL_H, cs.FULL_W, ("adamvs",), 4))
    for H, W, models, n in cases:
        cam, poses = cs.survey(W, H)
        imgs, rel, dmin, dmax, _ = cs.sample(cam, poses, dev, ref=1)
        inputs = (imgs, rel, dmin, dmax)
        for name in models:
            kw = {"ndepths": cs.UCS_NDEPTHS} if name == "ucsnet" else {}
            model = init_random_weights(build_model(name, **kw), seed=0).to(dev).eval()
            for m in MODES:
                outs = [forward(model, inputs, m) for _ in range(3)]
                diff = max(float((outs[0] - o).abs().max()) for o in outs[1:])
                same = all(torch.equal(outs[0], o) for o in outs[1:])
                print(f"[det] {name} {H}x{W} {m}: run to run equal {same}, "
                      f"max diff {diff:.3e}", flush=True)
            times = {m: [] for m in MODES}
            for rnd in range(3):
                for m in (MODES if rnd % 2 == 0 else MODES[::-1]):
                    times[m].append(ms_a_forward(model, inputs, m, n))
            print(f"[det] {name} {H}x{W} ms a forward (CUDA events, {n} host-issued "
                  f"forwards, 3 rounds alternating): " + ", ".join(
                      f"{m} {np.median(v):.3f} {[round(x, 3) for x in v]}"
                      for m, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
