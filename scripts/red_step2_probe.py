"""Where the time of the RedStep2 step (K3, csrc/red_step2.cu) goes, on a
CUDA card: builds the kernel with parts of its work compiled out (and with
another warp count) and times each variant's three launches with
torch.profiler (device us per launch, mean of 10) at the AdaMVS main
path's stage shapes and the 1856x2752 frame, on the softmax-fold entry.

    python3 scripts/red_step2_probe.py [--parent DIR] [--variants base,parent]

Variants: base; w8 (the two GRU levels at 8 warps a block instead of
16); anywave (L1's tile size chosen without the half-full last wave); nomma
(the MMAs replaced by one add); noload (no per-tile input copies: the tile
computes on what the shared memory holds); skeleton (neither). base, w8
and anywave compute the step; the others measure what is left when a part
is gone. The variants are built into build/red_step2_probe/ from the
checkout's source; with --parent DIR (a checkout of an earlier commit,
unpacked with `git archive`), `parent` is that checkout's red_step2.cu as
it is. Each shape times the variants in order, then in reverse (parent,
base, base, parent), and prints both readings; a variant that refuses a
shape (the parent at a cost width it had no instance for) reads "not run".
Device time comes from utils/profiling.py:device_events, whose sessions
must list the 30 launches of 10 steps. Cin 64 (AdaMVS at base 16, stage 1)
runs the chunked conv1.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deep3d_aerial_tpu_torch.models.cascade import OnlineSoftmaxState  # noqa: E402
from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2  # noqa: E402
from deep3d_aerial_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc  # noqa: E402
from deep3d_aerial_tpu_torch.utils.profiling import device_events  # noqa: E402
from deep3d_aerial_tpu_torch.weights import init_random_weights  # noqa: E402

SHAPES = [(32, 96, 128, True), (16, 192, 256, True), (8, 384, 512, False),
          (8, 1856, 2752, False), (64, 96, 128, True)]
MMA = """              mma_tf32(alh[i][n], al, bh0, bh1);
              mma_tf32(ahl[i][n], ah, bl0, bl1);
              mma_tf32(acc[i][n], ah, bh0, bh1);"""
NO_MMA = "              acc[i][n][0] += __uint_as_float(ah[0] ^ bh0 ^ al[1] ^ bl1);"
LOAD = "cp_async4(dst + ch * cs + spos[k],"
NO_LOAD = "if (false) cp_async4(dst + ch * cs + spos[k],"
WARPS = "constexpr int kGruThreads = 512;"
WAVES = "constexpr bool kFullWaves[3] = {true, false, false};"
VARIANTS = {"base": [], "w8": [(WARPS, "constexpr int kGruThreads = 256;")],
            "anywave": [(WAVES, "constexpr bool kFullWaves[3] = {false, false, false};")],
            "nomma": [(MMA, NO_MMA)], "noload": [(LOAD, NO_LOAD)],
            "skeleton": [(MMA, NO_MMA), (LOAD, NO_LOAD)]}


def build(out_dir: Path, variants, parent=None):
    csrc = REPO / "deep3d_aerial_tpu_torch" / "csrc"
    src = (csrc / "red_step2.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    if parent is not None and "parent" in variants:
        pcsrc = Path(parent).resolve() / "deep3d_aerial_tpu_torch" / "csrc"
        so = out_dir / "parent.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(pcsrc), "-o", str(so), str(pcsrc / "red_step2.cu")]
        procs["parent"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
    for name, edits in VARIANTS.items():
        if name not in variants:
            continue
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"red_step2.cu changed; update the probe: {old[:40]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [line.split(":")[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[probe] {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit")
    ap.add_argument("--variants", default=",".join(VARIANTS) + ",parent",
                    help="comma-separated variants to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("red_step2_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    variants = args.variants.split(",")
    libs = build(REPO / "build" / "red_step2_probe", variants, args.parent)
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.red_step2_f32.argtypes = [P, I, P, P, P] + [P] * 8 + [I, I, I, P]
        lib.red_step2_f32.restype = I
    g = torch.Generator(device=dev).manual_seed(0)
    order = list(libs)
    for C, H, W, up in SHAPES:
        mod = init_random_weights(RedStep2(C, up=up), seed=0).to(dev)
        packed = mod._packed_params()
        cost = torch.randn((C, H, W), generator=g, device=dev)
        s1 = torch.randn((8, H, W), generator=g, device=dev) * 0.5
        s2 = torch.randn((16, (H + 1) // 2, (W + 1) // 2), generator=g, device=dev) * 0.5
        shape = (2 * H, 2 * W) if up else (H, W)
        osm = OnlineSoftmaxState.init(shape, device=dev)
        dv = torch.full(shape, 100.0, device=dev)
        s1n, s2n = torch.empty_like(s1), torch.empty_like(s2)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {name: [] for name in order}
        for name in order + order[::-1]:
            lib = libs[name]

            def step():
                return lib.red_step2_f32(cost.data_ptr(), C, s1.data_ptr(), s2.data_ptr(),
                                         packed.data_ptr(), s1n.data_ptr(), s2n.data_ptr(),
                                         None, *(t.data_ptr() for t in osm), dv.data_ptr(),
                                         H, W, int(up), stream)
            if step() != 0:
                row[name].append("not run")
                continue
            torch.cuda.synchronize()
            evs = device_events(lambda: [step() for _ in range(10)],
                                lambda evs: len(evs) == 30)
            row[name].append([round(sum(e.time_range.elapsed_us() for e in evs[k::3]) / 10, 1)
                              for k in range(3)])
        print(f"[probe] Cin{C} {H}x{W} up={up}: device us per launch (L1, L2, L3), "
              f"in order then reversed: {row}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
