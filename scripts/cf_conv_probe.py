"""Where the time of the port's conv template (K5, csrc/red_step4.cu) goes,
on a CUDA card: builds the template with parts of its work compiled out
and times each variant with torch.profiler (device us per launch, mean of
10) at a few of RedStep4's conv shapes.

    python3 scripts/cf_conv_probe.py

Variants: base; nomma (the MMAs replaced by one add); nohalo (no input
staging); now (no weight staging); nost (no output stores); noload (no
staging at all); skeleton (none of the four). Only `base` computes the
conv; the others measure what is left when a part is gone. The variants
are built into build/cf_conv_probe/ from the checkout's source.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deep3d_aerial_tpu_torch.ops.cf_conv import pack_weight  # noqa: E402
from deep3d_aerial_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc  # noqa: E402

PARTS = ("SKIP_MMA", "SKIP_HALO", "SKIP_W", "SKIP_ST")
VARIANTS = {"base": (), "nomma": ("SKIP_MMA",), "nohalo": ("SKIP_HALO",),
            "now": ("SKIP_W",), "nost": ("SKIP_ST",), "noload": ("SKIP_HALO", "SKIP_W"),
            "skeleton": PARTS}
SHAPES = [(16, 16, 384, 512), (16, 16, 1856, 2752), (64, 64, 96, 128),
          (128, 128, 48, 64), (128, 128, 12, 16)]
# each part of the source and the same code with a switch around it
EDITS = [
    ("""            mma_tf32(acl[mi][nf], al, bh0, bh1);
            mma_tf32(acl[mi][nf], ah, bl0, bl1);
            mma_tf32(acc[mi][nf], ah, bh0, bh1);""", """#if !SKIP_MMA
            mma_tf32(acl[mi][nf], al, bh0, bh1);
            mma_tf32(acl[mi][nf], ah, bl0, bl1);
            mma_tf32(acc[mi][nf], ah, bh0, bh1);
#else
            acc[mi][nf][0] += __uint_as_float(ah[0] ^ bh0 ^ al[1] ^ bl1);
#endif"""),
    ("for (int c = 0; c < kCC; ++c) {\n      const int ci = chunk * kCC + c;",
     "for (int c = 0; c < kCC * !SKIP_HALO; ++c) {\n      const int ci = chunk * kCC + c;"),
    ("if (e < kWPieces) cp_async16(", "if (!SKIP_W && e < kWPieces) cp_async16("),
    ("p.out[co * HWo + pix] = v;", "if (!SKIP_ST || v == 12345.f) p.out[co * HWo + pix] = v;"),
]


def build(out_dir: Path):
    src = (REPO / "deep3d_aerial_tpu_torch" / "csrc" / "red_step4.cu").read_text()
    for old, new in EDITS:
        if old not in src:
            raise RuntimeError(f"the conv template changed; update EDITS: {old[:40]!r}")
        src = src.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "probe.cu"
    cu.write_text(src)
    procs = {}
    for name, off in VARIANTS.items():
        flags = [f"-D{k}={int(k in off)}" for k in PARTS]
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log[-3000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("cf_conv_probe: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir = REPO / "build" / "cf_conv_probe"
    build(out_dir)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ops = []
    for ci, co, H, W in SHAPES:
        x = torch.randn((ci, H, W), generator=g, device=dev)
        w = torch.randn((co, ci, 3, 3), generator=g, device=dev) / (9 * ci) ** 0.5
        ops.append(((ci, co, H, W), x, pack_weight(w, "same"), torch.zeros(co, device=dev),
                    torch.empty((co, H, W), device=dev)))
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = lib.cf_conv3x3_f32
        fn.argtypes = [P, P, P, I, I, I, I, I, I, P, P, P, P]
        fn.restype = I
        for q in ("cf_conv3x3_scratch_floats", "cf_conv3x3_tickets"):
            getattr(lib, q).argtypes = [I] * 6
            getattr(lib, q).restype = ctypes.c_longlong
        row = []
        for (ci, co, H, W), x, pk, b, out in ops:
            scratch = torch.empty(max(1, lib.cf_conv3x3_scratch_floats(ci, co, H, W, 0, 0)),
                                  device=dev)
            tickets = torch.zeros(max(1, lib.cf_conv3x3_tickets(ci, co, H, W, 0, 0)),
                                  dtype=torch.int32, device=dev)

            def call():
                rc = fn(x.data_ptr(), pk.data_ptr(), b.data_ptr(), ci, co, H, W, 0, 0,
                        out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
            row.append(f"{ci}->{co} {H}x{W}: "
                       + (f"{sum(us) / len(us):.1f}" if us else "not measured"))
        print(f"{name:9s} " + " | ".join(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
