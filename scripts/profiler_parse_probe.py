"""What reading a torch.profiler session's device events costs on a CUDA
card, by the two ways to read them: torch's own parse (`prof.events()`,
which builds a Python tree of every CPU op and device event) and
`utils/profiling.session_events` on the session's raw results (what
`device_events` reads). Each case is profiled as `device_events` profiles
(CPU and CUDA activities, 64 sentinel kernels, 0.1 s wait), and, for the
parse, with the CUDA activity alone. Prints, per session: the seconds to run it,
to read its events each way, the events of all kinds, the device events, and
their summed device us (equal between the ways).

Cases: 12 calls of the plain K1 sweep (sweep_corr_plain) and of the plain K2
sweep at AdaMVS's stage 1 (96x128, C 32, 4 source views, 48 and 8 planes),
50 calls of the K1 kernel, and one MSREDNet train step at 384x512.

    python3 scripts/profiler_parse_probe.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deep3d_aerial_tpu_torch.utils.profiling import session_events  # noqa: E402


def session(fn, activities):
    from torch.autograd import DeviceType
    from torch.profiler import profile

    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
        fn()
        torch.cuda.synchronize()
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    raw = [e for e in session_events(prof.profiler.kineto_results, DeviceType.CUDA)
           if "spin_kernel" not in e.name]
    t2 = time.perf_counter()
    parsed = prof.events()
    dev = [e for e in parsed if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.name]
    t3 = time.perf_counter()
    return dict(run_s=round(t1 - t0, 3), raw_s=round(t2 - t1, 3),
                parse_s=round(t3 - t2, 3), n_all=len(parsed), n_dev=len(dev),
                n_raw=len(raw), dev_us=round(sum(e.time_range.elapsed_us() for e in dev), 1),
                raw_us=round(sum(e.time_range.elapsed_us() for e in raw), 1))


def main():
    from torch.profiler import ProfilerActivity as PA

    from deep3d_aerial_tpu_torch.ops import cuda_build
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_corr_plain, sweep_cost_plain
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer
    from deep3d_aerial_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build()
    dev = torch.device("cuda")
    cam0, poses0 = cs.survey(cs.W0, cs.H0)
    g = torch.Generator(device=dev).manual_seed(0)
    H, W, C = 96, 128, 32
    rel = cs.stage_rel(cam0, poses0, 0, dev)
    ref = torch.randn((H, W, C), generator=g, device=dev)
    srcs = torch.randn((4, H, W, C), generator=g, device=dev)
    d = cs.stage_planes(cam0, poses0, 0, H, W, dev)
    dpair = cs.stage_planes(cam0, poses0, 0, H, W, dev, n=48)
    wts = torch.rand((4, H, W), generator=g, device=dev) * 0.9 + 0.1
    model = cs.train_model("msrednet", ndepths=cs.MODEL_NDEPTHS["msrednet"]).to(dev)
    step = make_train_step(model, make_optimizer(model.named_parameters(), cs.TRAIN_LR),
                           pair_weight=0.0)
    batch = cs.train_batch(cam0, poses0, dev, ref=0)
    cases = {
        "sweep_corr_plain x12": lambda: [sweep_corr_plain(ref, srcs, rel, dpair)
                                         for _ in range(12)],
        "sweep_corr x50": lambda: [sweep_corr(ref, srcs, rel, dpair) for _ in range(50)],
        "sweep_cost_plain x12": lambda: [sweep_cost_plain(ref, srcs, rel, d, wts)
                                         for _ in range(12)],
        "msrednet train step": lambda: step(batch),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        for acts in ([PA.CPU, PA.CUDA], [PA.CUDA]):
            print(f"[profiler] {name} {[a.name for a in acts]} "
                  + json.dumps(session(fn, acts)), flush=True)


if __name__ == "__main__":
    main()
