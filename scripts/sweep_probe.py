"""Where the time of the plane-sweep kernels (K1 pair, K2 cost, K2v
variance; csrc/sweep.cu) goes, on a CUDA card: builds the kernels with
parts of their work compiled out or with another launch geometry, and
times each variant's launches with torch.profiler (device us per call,
mean of 10) at the AdaMVS / MSREDNet main path's stage shapes (V 4, K 8;
K1 over all 48 stage-1 planes) and the 1856x2752 frame's three stage
shapes. Variants that compute the function print their max abs error
against the plain version.

    python3 scripts/sweep_probe.py [--parent DIR]

Variants: base; quad / wide (cost and variance with one lane per channel
quad, or one thread per pixel, at every C, where base picks by C); swap
(4 planes a lane-per-quad cost block and 8 a variance block, where base
takes 8 and 4);
kb8 / kb1 (8 planes, or the fewest, a one-thread-per-pixel block at every
shape, where base picks by grid size); bps2, wbps3 (register budget for 2 blocks of 256 threads per
SM instead of 3 on the lane-per-quad kernels, 3 instead of 4 on the
one-thread-per-pixel ones); noload (the 4 tap loads replaced
by a value computed from the tap descriptor: geometry, sums and stores
without taps); nodesc (the projection replaced by a value computed from
the depth: taps at arbitrary places, no geometry). With --parent DIR (a checkout of an earlier
commit), its csrc/sweep.cu is built too and timed through its own C
entries, where it has the old geometry (rels [V, 12], one K1 launch per
view and chunk of 8 planes). Variants are built into build/sweep_probe/.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deep3d_aerial_tpu_torch.ops import sweep as sw  # noqa: E402
from deep3d_aerial_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc  # noqa: E402
from deep3d_aerial_tpu_torch.utils.profiling import device_events  # noqa: E402

TAPS = """  const float4 v0 = quad(b), v1 = quad(b + G);
  const float4 v2 = quad(b + rowq), v3 = quad(b + rowq + G);"""
NO_TAPS = """  const float4 v0 = make_float4(w.x, (float)off, w.z, w.w), v1 = v0, v2 = v0, v3 = v0;"""
DESC = "  float p[3];\n#pragma unroll\n  for (int a = 0; a < 3; ++a) p[a] = __fadd_rn(__fmul_rn(g.r[a], d), g.t[a]);"
MIN_BLOCKS = "constexpr long long kMinBlocks = 1024;"
COST_PLANES = "constexpr int kCostPlanes = 8;"
VAR_PLANES = "constexpr int kVarPlanes = 4;"
BPS = "constexpr int kBlocksPerSM = 3;"
QUAD = "constexpr int kQuadLanesFrom = 16;"
BPS_WIDE = "constexpr int kBlocksPerSMWide = 4;"
VARIANTS = {
    "base": [],
    "quad": [(QUAD, "constexpr int kQuadLanesFrom = 8;")],
    "wide": [(QUAD, "constexpr int kQuadLanesFrom = 64;")],
    "swap": [(COST_PLANES, "constexpr int kCostPlanes = 4;"),
             (VAR_PLANES, "constexpr int kVarPlanes = 8;")],
    "kb8": [(MIN_BLOCKS, "constexpr long long kMinBlocks = 0;")],
    "kb1": [(MIN_BLOCKS, "constexpr long long kMinBlocks = 1LL << 40;")],
    "bps2": [(BPS, "constexpr int kBlocksPerSM = 2;")],
    "wbps3": [(BPS_WIDE, "constexpr int kBlocksPerSMWide = 3;")],
    "noload": [(TAPS, NO_TAPS)],
    "nodesc": [(DESC, "  w = make_float4(d, d, d, d);\n  off = ((int)d & 1023) * G;\n}\n#if 0\n"),
               ("// This lane's channel quad of the bilinear sample", "#endif\n// This lane's channel quad of the bilinear sample")],
}
COMPUTES = ("base", "quad", "wide", "swap", "kb8", "kb1", "bps2", "wbps3", "parent")
P, I = ctypes.c_void_p, ctypes.c_int
# C-entry calls made so far (each is one launch)
LAUNCHES = [0]


def build(out_dir: Path, parent):
    src = (REPO / "deep3d_aerial_tpu_torch" / "csrc" / "sweep.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"sweep.cu changed; update the probe: {old[:40]!r}")
            text = text.replace(old, new)
        texts[name] = text
    if parent is not None:
        texts["parent"] = (Path(parent) / "deep3d_aerial_tpu_torch" / "csrc"
                           / "sweep.cu").read_text()
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = sorted({line.split("Used")[-1].strip() for line in log.splitlines()
                       if "registers" in line})
        print(f"[probe] {name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(so))
        old = name == "parent"
        lib.sweep_corr_f32.argtypes = [P] * 5 + [I] * (4 if old else 5) + [P]
        lib.sweep_cost_f32.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.sweep_var_f32.argtypes = [P] * 5 + [I] * 5 + [P]
        libs[name] = lib
    return libs


def device_us(fn, calls=10):
    """Mean device us per call of `fn` (all its launches) from a profiler
    session (`device_events`) that lists one kernel for each C-entry call."""
    before = LAUNCHES[0]
    fn()
    torch.cuda.synchronize()
    want = (LAUNCHES[0] - before) * calls

    def run():
        for _ in range(calls):
            fn()
    evs = device_events(run, lambda evs: len(evs) == want)
    return round(sum(e.time_range.elapsed_us() for e in evs) / calls, 2)


def calls(lib, name, mode, a, out, stream):
    """The call of one mode on inputs `a` through library `lib`."""
    ref, srcs, rels, d, wts = a["ref"], a["srcs"], a["rels"], a["d"], a["wts"]
    H, W, C = ref.shape
    V, K = srcs.shape[0], d.shape[0]

    def ok(rc):
        LAUNCHES[0] += 1
        if rc != 0:
            raise RuntimeError(f"{name} {mode}: error {rc}")

    if name == "parent":
        rel12 = rels[:, :3, :].reshape(V, 12).contiguous()
        if mode == "corr":
            def run():
                for v in range(V):
                    for k0 in range(0, K, cs.CHUNK):
                        ok(lib.sweep_corr_f32(ref.data_ptr(), srcs[v].data_ptr(),
                                              rel12[v].data_ptr(), d[k0].data_ptr(),
                                              out[v, k0].data_ptr(), cs.CHUNK, H, W, C,
                                              stream))
            return run
        rels = rel12
    if mode == "corr":
        return lambda: ok(lib.sweep_corr_f32(ref.data_ptr(), srcs.data_ptr(),
                                             rels.data_ptr(), d.data_ptr(),
                                             out.data_ptr(), V, K, H, W, C, stream))
    if mode == "cost":
        return lambda: ok(lib.sweep_cost_f32(ref.data_ptr(), srcs.data_ptr(),
                                             rels.data_ptr(), d.data_ptr(),
                                             wts.data_ptr(), out.data_ptr(), V, K,
                                             H, W, C, stream))
    return lambda: ok(lib.sweep_var_f32(ref.data_ptr(), srcs.data_ptr(),
                                        rels.data_ptr(), d.data_ptr(), out.data_ptr(),
                                        V, K, H, W, C, stream))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of an earlier commit to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build(REPO / "build" / "sweep_probe", args.parent)
    g = torch.Generator(device=dev).manual_seed(0)
    cam0, poses0 = cs.survey(cs.W0, cs.H0)
    camF, posesF = cs.survey(cs.FULL_W, cs.FULL_H)
    V1 = cs.VIEWS - 1
    cases = [("corr", "stage1", cam0, poses0, 0, 32, cs.NDEPTHS[0])]
    for mode in ("cost", "var"):
        cases += [(mode, f"stage{s + 1}", cam0, poses0, s, c, cs.CHUNK)
                  for s, c in enumerate(cs.CHANNELS)]
        cases += [(mode, f"full-res stage{s + 1}", camF, posesF, s, c, cs.CHUNK)
                  for s, c in enumerate(cs.CHANNELS)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for mode, tag, cam, poses, stage, C, K in cases:
        H, W = (cs.FULL_H, cs.FULL_W) if tag.startswith("full-res") else (cs.H0, cs.W0)
        H, W = H >> (2 - stage), W >> (2 - stage)
        a = {"ref": torch.randn((H, W, C), generator=g, device=dev),
             "srcs": torch.randn((V1, H, W, C), generator=g, device=dev),
             "rels": cs.stage_rel(cam, poses, stage, dev),
             "d": cs.stage_planes(cam, poses, stage, H, W, dev, n=K),
             "wts": torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1}
        if mode == "corr":
            plain = sw.sweep_corr_plain(a["ref"], a["srcs"], a["rels"], a["d"])
        elif mode == "cost":
            plain = sw.sweep_cost_plain(a["ref"], a["srcs"], a["rels"], a["d"], a["wts"])
        else:
            plain = sw.sweep_var_plain(a["ref"], a["srcs"], a["rels"], a["d"])
        row = {}
        for name, lib in libs.items():
            out = torch.full_like(plain, float("nan"))
            fn = calls(lib, name, mode, a, out, stream)
            us = device_us(fn)
            err = ""
            if name in COMPUTES:
                fn()
                torch.cuda.synchronize()
                err = f" err {float((out - plain).abs().max()):.1e}"
            row[name] = f"{us}{err}"
        print(f"[probe] {mode} {tag} {H}x{W} C{C} V{V1} K{K}: device us per call "
              + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        del a, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
