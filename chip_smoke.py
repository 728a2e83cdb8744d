"""The PyTorch port's driver on one CUDA card (an H100 in this repository's
measurements): builds the hand-written kernels from csrc/, holds each
against its plain PyTorch version, runs the pipeline's main path (AdaMVS
dense matching + fusion at 384x512, default configuration, seeded random
weights), compares the kernel path with the plain path end to end, and runs
one 1856x2752 production frame.

    python3 chip_smoke.py

Needs a CUDA device and the repository around it; exits non-zero, printing
no result, otherwise. Any failed check raises. The last three lines of
standard output are: the `kernels` JSON line, the card's name and power
limit as nvidia-smi gives them, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Kernel numbers (one entry per kernel): `ms`, `plain_ms`, `bound_ms` and
`library_ms` are per depth map of the main path at 384x512, i.e. the
per-launch time at each stage's shape times that stage's launches per map,
summed over stages. `ms` and `plain_ms` are device time: the durations of
the device work one call launches, read from torch.profiler (CUPTI), so the
host's time to issue the launches is not in them (the `[kernel]` lines also
print the CUDA-event time of a host-issued loop of calls, which is).
`launches` is the count over the main-path run;
`max_abs_err` is the largest kernel-vs-plain difference over all checked
shapes (full-res included). No single PyTorch call computes any of the
three functions (projection + bilinear taps + channel reduction, or a
whole GRU step), so `library_ms` is null.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# main path: the default AdaMVS configuration at 384x512
H0, W0 = 384, 512
VIEWS = 5
NDEPTHS = (48, 32, 8)
CHANNELS = (32, 16, 8)
CHUNK = 8
FULL_H, FULL_W = 1856, 2752

# kernel vs plain on the card, stated before measuring: the kernels round
# the projection exactly as the plain chain does, but nvcc contracts the
# feature products and the sums run in another order (and cuDNN sums the
# convolutions in its own order): unit-scale values agree to ~1e-6
TOL_SWEEP = 1e-4
TOL_RED = 1e-4
# end to end (as the CPU parity tests): depth within 1e-3 of the depth
# range, confidence within 1e-4
TOL_DEPTH_FRAC = 1e-3
TOL_CONF = 1e-4


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# synthetic survey: textured terrain seen by a nadir camera grid
# ---------------------------------------------------------------------------


def terrain_z(x, y):
    return (3.0 * torch.sin(0.08 * x) * torch.cos(0.06 * y)
            + 1.5 * torch.sin(0.021 * x + 0.033 * y))


def texture(x, y):
    return (0.5 + 0.2 * torch.sin(0.9 * x) * torch.cos(0.7 * y)
            + 0.15 * torch.sin(0.23 * x + 1.3 * y)
            + 0.15 * torch.sin(2.1 * x - 1.7 * y))


def survey(W, H, nx=3, ny=2, seed=7):
    """Cameras of the full-res survey geometry (focal 130 px per 96 px of
    width: f = 3727 at 2752 wide, ~55% side-lap at 100 m), scaled to W x H."""
    from deep3d_aerial_tpu_torch.geometry.camera import Camera, Pose

    rng = np.random.default_rng(seed)
    f = 130.0 * W / 96.0
    cam = Camera(camera_id=1, width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2)
    fp = W / f * 100.0
    R_down = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    poses = []
    for gy in range(ny):
        for gx in range(nx):
            c = np.array([(gx - (nx - 1) / 2) * 0.45 * fp,
                          (gy - (ny - 1) / 2) * 0.45 * fp * H / W,
                          100.0 + rng.uniform(-2, 2)])
            poses.append(Pose(R_down, -R_down @ c))
    return cam, poses


def render(cam, pose, dev):
    """(gray image [H, W] in [0, 1], depth [H, W]) by ray-casting the
    height field (fixed-point iteration), on the device."""
    K = torch.tensor(cam.K, dtype=torch.float64, device=dev)
    Rwc = torch.tensor(pose.R_wc, dtype=torch.float64, device=dev)
    t = torch.tensor(pose.center, dtype=torch.float64, device=dev)
    gy, gx = torch.meshgrid(torch.arange(cam.height, dtype=torch.float64, device=dev),
                            torch.arange(cam.width, dtype=torch.float64, device=dev),
                            indexing="ij")
    rays = torch.stack([gx, gy, torch.ones_like(gx)], -1) @ torch.linalg.inv(K).T @ Rwc.T
    depth = (0.0 - t[2]) / rays[..., 2]
    for _ in range(30):
        w = t + rays * depth[..., None]
        depth = (terrain_z(w[..., 0], w[..., 1]) - t[2]) / rays[..., 2]
    w = t + rays * depth[..., None]
    return texture(w[..., 0], w[..., 1]).clamp(0, 1).float(), depth.float()


def write_workspace(ws: Path, cam, poses, dev):
    """export/ of a survey, written with the port's own text formats:
    cameras, images (depth range from the rendered depths), image paths,
    view pairs (nearest centres first) and one scene block."""
    from PIL import Image

    from deep3d_aerial_tpu_torch.io import text_formats as tf

    (ws / "images").mkdir(parents=True)
    export = ws / "export"
    export.mkdir()
    entries, images = [], []
    for i, pose in enumerate(poses, start=1):
        img, depth = render(cam, pose, dev)
        path = ws / "images" / f"im_{i:02d}.png"
        Image.fromarray(np.dstack([(img.cpu().numpy() * 255).astype(np.uint8)] * 3)
                        ).save(path)
        d = depth.cpu().numpy()
        pad = (d.max() - d.min()) / 4 + 1.0
        images.append(tf.PredefImage(i, 1, pose, d.min() - pad, d.max() + pad,
                                     path.name))
        entries.append((i, path.name, str(path)))
    tf.write_predef_cameras(export / "cameras.txt", [cam])
    tf.write_predef_images(export / "images.txt", images)
    tf.write_image_paths(export / "image_path.txt", entries)
    centers = np.stack([p.center for p in poses])
    pairs = []
    for i in range(len(poses)):
        dist = np.linalg.norm(centers - centers[i], axis=1)
        order = [j for j in np.argsort(dist) if j != i]
        pairs.append((i + 1, [(j + 1, float(1.0 / dist[j])) for j in order]))
    tf.write_view_pairs(export / "viewpair.txt", pairs)
    tf.write_blocks(export / "blocks.txt",
                    [([-200.0, 200.0, -200.0, 200.0, -50.0, 50.0],
                      list(range(1, len(poses) + 1)))])


def sample(cam, poses, dev, ref=0, views=VIEWS):
    """One network input in memory (the dataset's normalisation and
    per-stage relative projections): (imgs, rel_projs, dmin, dmax, ref depth)."""
    from deep3d_aerial_tpu_torch.geometry.camera import (
        proj_matrix,
        stage_relative_projections,
    )
    from deep3d_aerial_tpu_torch.pipeline.preprocess import center_image

    c = np.stack([p.center for p in poses])
    order = [ref] + [j for j in np.argsort(np.linalg.norm(c - c[ref], axis=1))
                     if j != ref][:views - 1]
    imgs, projs, ref_depth = [], [], None
    for j in order:
        img, depth = render(cam, poses[j], dev)
        rgb = np.repeat((img.cpu().numpy() * 255)[..., None], 3, -1)
        imgs.append(center_image(rgb.astype(np.float32)))
        projs.append(proj_matrix(cam.K, poses[j]))
        if ref_depth is None:
            ref_depth = depth
    rel = stage_relative_projections(np.stack(projs), 3).astype(np.float32)
    d = ref_depth.cpu().numpy()
    pad = (d.max() - d.min()) / 4 + 1.0
    return (torch.from_numpy(np.stack(imgs).astype(np.float32)).to(dev),
            torch.from_numpy(rel).to(dev), float(d.min() - pad),
            float(d.max() + pad), ref_depth)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def loop_ms(fn, iters):
    """Mean milliseconds per call of a host-issued loop of calls, from
    CUDA events, after one warm call: device time plus whatever the host
    takes to issue the launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device milliseconds per call, after one warm call: the summed
    durations of the device work (kernels, copies, fills) that `iters` calls
    launch, from torch.profiler (CUPTI). The host's issue time and the gaps
    between launches are not in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us == 0:
        raise RuntimeError("torch.profiler saw no device work: device time "
                           "not measured")
    return us / 1e3 / iters


def bound_ms(nbytes, flops):
    """(least time in ms, 'bytes' or 'operations'): each input read once
    and each output written once over the memory rate, against the
    arithmetic over the fp32 peak."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# projection (3 rays, p = ray*d + t, two divides) + floor/fraction + the
# four bilinear weights, per (plane, pixel, view)
GEOM_FLOPS = 30


def sweep_corr_work(K, H, W, C):
    nbytes = 4 * (2 * H * W * C + 2 * K * H * W + 12)
    flops = K * H * W * (GEOM_FLOPS + 8 * C + 2 * C)  # 4 taps, dot, mean
    return nbytes, flops


def sweep_cost_work(V, K, H, W, C):
    nbytes = 4 * ((V + 1) * H * W * C + K * H * W + V * H * W + K * C * H * W
                  + 12 * V)
    flops = K * H * W * (V * (GEOM_FLOPS + 11 * C + 1) + C)  # taps, *ref*w+, /
    return nbytes, flops


def red_step2_work(cin, H, W, up, n_weights):
    """Convolution multiply-adds x 2 (the pointwise GRU math is ~1% of it
    and left out); bytes: cost and both states in, states and score out,
    and the weights."""
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    macs = (H * W * 9 * (cin * 8 + 16 * 16 + 16 * 8)
            + H2 * W2 * 9 * (8 * 16 + 32 * 32 + 32 * 16 + 16 * 8)
            + H * W * 9 * 8)
    score = 4 * H * W if up else H * W
    nbytes = 4 * (cin * H * W + 2 * 8 * H * W + 2 * 16 * H2 * W2 + score
                  + n_weights)
    return nbytes, 2 * macs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(dev, cam0, poses0, camF, posesF):
    """Each kernel against its plain version at the main path's shapes
    (+ 1856x2752 stage 3 for K2 and K3). Returns per-shape records."""
    from deep3d_aerial_tpu_torch.geometry.camera import (
        proj_matrix,
        stage_relative_projections,
    )
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2
    from deep3d_aerial_tpu_torch.ops.depth_samplers import window_depth_samples
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2, red_step2_plain
    from deep3d_aerial_tpu_torch.ops.sweep import (
        sweep_corr,
        sweep_corr_plain,
        sweep_cost,
        sweep_cost_plain,
    )
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    g = torch.Generator(device=dev).manual_seed(0)
    records = []

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def geometry(cam, poses, stage):
        P = np.stack([proj_matrix(cam.K, p) for p in poses[:VIEWS]])
        rel = stage_relative_projections(P, 3)[stage].astype(np.float32)
        return torch.from_numpy(rel).to(dev)

    def planes(cam, poses, stage, H, W):
        _, depth = render(cam, poses[0], dev)
        center = torch.nn.functional.interpolate(
            depth[None, None], size=(H, W), mode="bilinear",
            align_corners=False)[0, 0]
        if stage == 0:
            lo, hi = float(depth.min()) - 10, float(depth.max()) + 10
            d = torch.linspace(lo, hi, NDEPTHS[0], device=dev)[:CHUNK]
            return d[:, None, None].expand(CHUNK, H, W).contiguous()
        interval = (2.0 if stage == 1 else 1.0) * 0.1
        return window_depth_samples(center, CHUNK, interval).contiguous()

    def compare(name, shape_tag, kernel_fn, plain_fn, tol, work, per_map, iters):
        out_k = kernel_fn()
        out_p = plain_fn()
        torch.cuda.synchronize()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        err = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
        rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-3)).max())
                  for a, b in zip(outs_k, outs_p))
        finite = all(bool(torch.isfinite(a).all()) for a in outs_k)
        ms = device_ms(kernel_fn, iters)
        loop = loop_ms(kernel_fn, iters)
        plain_ms = device_ms(plain_fn, max(1, iters // 4))
        b_ms, b_by = bound_ms(*work)
        rec = dict(name=name, shape=shape_tag, max_abs_err=err,
                   max_rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, per_map=per_map)
        records.append(rec)
        log(f"[kernel] {name:10s} {shape_tag:28s} err {err:.3e} (rel {rel:.3e}, "
            f"tol {tol:g}) device ms: kernel {ms:.4f} plain {plain_ms:.4f} "
            f"bound {b_ms:.4f} ({b_by}, {b_ms / ms:.1%} of it reached); "
            f"host-issued loop {loop:.4f} ms/call; launches/map {per_map}")
        if not finite or not err <= tol:
            raise AssertionError(f"{name} {shape_tag}: kernel vs plain "
                                 f"max abs err {err} > {tol} (finite={finite})")

    V1 = VIEWS - 1
    for stage, (C, D) in enumerate(zip(CHANNELS, NDEPTHS)):
        s = 2 ** (2 - stage)
        H, W = H0 // s, W0 // s
        rel = geometry(cam0, poses0, stage)
        ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
        d = planes(cam0, poses0, stage, H, W)
        tag = f"stage{stage + 1} {H}x{W} C{C}"
        if stage == 0:
            compare("sweep_corr", tag + f" K{CHUNK}",
                    lambda: sweep_corr(ref, srcs[0], rel[0], d),
                    lambda: sweep_corr_plain(ref, srcs[0], rel[0], d),
                    TOL_SWEEP, sweep_corr_work(CHUNK, H, W, C),
                    V1 * D // CHUNK, 50)
        wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
        compare("sweep_cost", tag + f" V{V1} K{CHUNK}",
                lambda: sweep_cost(ref, srcs, rel, d, wts),
                lambda: sweep_cost_plain(ref, srcs, rel, d, wts),
                TOL_SWEEP, sweep_cost_work(V1, CHUNK, H, W, C), D // CHUNK, 50)
        up = stage < 2
        mod = init_random_weights(RedStep2(C, up=up), seed=stage).to(dev)
        params = dict(mod.named_parameters())
        packed = mod._packed_params()
        cost, s1 = rnd(C, H, W), rnd(8, H, W, scale=0.5)
        s2 = rnd(16, (H + 1) // 2, (W + 1) // 2, scale=0.5)
        n_w = sum(p.numel() for p in params.values())
        with torch.no_grad():
            compare("red_step2", tag + (" up" if up else ""),
                    lambda: red_step2(params, cost, s1, s2, up=up, packed=packed),
                    lambda: red_step2_plain(params, cost, s1, s2, up=up),
                    TOL_RED, red_step2_work(C, H, W, up, n_w), D, 50)

    # production frame, stage 3 (1856x2752, C=8): K2 and K3
    H, W, C = FULL_H, FULL_W, CHANNELS[2]
    rel = geometry(camF, posesF, 2)
    ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
    d = planes(camF, posesF, 2, H, W)
    wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
    tag = f"full-res stage3 {H}x{W} C{C}"
    compare("sweep_cost", tag + f" V{V1} K{CHUNK}",
            lambda: sweep_cost(ref, srcs, rel, d, wts),
            lambda: sweep_cost_plain(ref, srcs, rel, d, wts),
            TOL_SWEEP, sweep_cost_work(V1, CHUNK, H, W, C), 1, 5)
    del ref, srcs, wts
    mod = init_random_weights(RedStep2(C, up=False), seed=3).to(dev)
    params = dict(mod.named_parameters())
    packed = mod._packed_params()
    cost, s1 = rnd(C, H, W), rnd(8, H, W, scale=0.5)
    s2 = rnd(16, (H + 1) // 2, (W + 1) // 2, scale=0.5)
    n_w = sum(p.numel() for p in params.values())
    with torch.no_grad():
        compare("red_step2", tag,
                lambda: red_step2(params, cost, s1, s2, up=False, packed=packed),
                lambda: red_step2_plain(params, cost, s1, s2, up=False),
                TOL_RED, red_step2_work(C, H, W, False, n_w), 8, 5)
    torch.cuda.empty_cache()
    return records


class _Marked(torch.nn.Module):
    """The pipeline's model with CUDA events at its phase boundaries."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.events = []  # per map: [(label, event), ...]

    def forward(self, *args):
        marks = []

        def mark(label):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((label, e))

        mark("start")
        out = self.model(*args, mark=mark)
        self.events.append(marks)
        return out


def phase_main_path(dev, cam0, poses0, counters):
    """AerialPipeline(...).run_dense() on a synthetic workspace: dense
    matching + fusion at 384x512, default AdaMVS, seeded random weights."""
    from deep3d_aerial_tpu_torch.io.pfm import read_pfm
    from deep3d_aerial_tpu_torch.io.ply import read_ply
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp) / "ws"
        write_workspace(ws, cam0, poses0, dev)
        cfg = PipelineConfig(
            image_w=W0, image_h=H0, image_scale=1.0, view_num=VIEWS,
            allow_random_weights=True, run_view_selection=False,
            run_create_mesh=False, run_create_dsm=False,
            fusion_num=4, geo_consist_num=2, photomatric_threshold=0.0,
            position_threshold=2.0, depth_threshold=0.05,
            normal_threshold=180.0,
        )
        pipe = AerialPipeline(str(ws), cfg, device=dev)
        model = _Marked(pipe.build_model())
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        pipe.run_dense(model=model)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}

        maps = sorted((ws / "dense" / "MVS").glob("*_init.pfm"))
        n = len(maps)
        if n != len(poses0):
            raise AssertionError(f"{n} depth maps for {len(poses0)} views")
        for p in maps:
            d = read_pfm(p)[0]
            if d.shape != (H0, W0) or not np.isfinite(d).all():
                raise AssertionError(f"{p.name}: shape {d.shape}, finite "
                                     f"{np.isfinite(d).mean()}")
            if not (ws / "dense" / "MVS" / p.name.replace("_init", "_prob")).exists():
                raise AssertionError(f"no prob map beside {p.name}")
        plys = sorted((ws / "dense" / "fusion").glob("scene_*.ply"))
        if not plys:
            raise AssertionError("fusion wrote no PLY")
        points = sum(read_ply(p)[0].shape[0] for p in plys)

    per_map = {"sweep_corr": (VIEWS - 1) * NDEPTHS[0] // CHUNK,
               "sweep_cost": sum(d // CHUNK for d in NDEPTHS),
               "red_step2": sum(NDEPTHS)}
    for name, k in per_map.items():
        if launches[name] != k * n:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"main path, expected {k} x {n} maps")
    stage_ms = {}
    for marks in model.events[1:]:  # the first map warms up
        for (_, a), (label, b) in zip(marks, marks[1:]):
            stage_ms.setdefault(label, []).append(a.elapsed_time(b))
    secs = pipe.map_seconds
    steady = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    log(f"[main] {n} maps at {H0}x{W0}, {VIEWS} views, ndepths {NDEPTHS}: "
        f"run_dense {total:.2f} s; per map first {secs[0]:.3f} s, "
        f"median after {steady * 1e3:.2f} ms = {1.0 / steady:.2f} maps/s; "
        f"fused points {points}")
    log("[main] launches " + json.dumps(launches) + " per map "
        + json.dumps(per_map))
    log("[main] per-stage ms between CUDA events, idle gaps included "
        "(median over maps 2..n): " + json.dumps(
        {k: round(float(np.median(v)), 4) for k, v in stage_ms.items()}))
    return launches, steady


def phase_end_to_end(dev, cam0, poses0):
    """One sample through the forward with the kernels and with their plain
    versions (same weights)."""
    from deep3d_aerial_tpu_torch.models.adamvs import AdaMVS
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(cam0, poses0, dev, ref=1)
    mk = init_random_weights(AdaMVS(), seed=0).to(dev).eval()
    mp = AdaMVS(warp_impl="plain", red_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    with torch.no_grad():
        ok = mk(imgs, rel, dmin, dmax)
        op = mp(imgs, rel, dmin, dmax)
    dtol = TOL_DEPTH_FRAC * (dmax - dmin)
    res = {}
    for s in ("stage1", "stage2", "stage3"):
        dd = float((ok[s]["depth"] - op[s]["depth"]).abs().max())
        dc = float((ok[s]["photometric_confidence"]
                    - op[s]["photometric_confidence"]).abs().max())
        res[s] = (dd, dc)
        log(f"[e2e] {s}: kernel vs plain depth max |diff| {dd:.3e} m "
            f"(tol {dtol:.3e}), confidence {dc:.3e} (tol {TOL_CONF:g})")
        if not (dd <= dtol and dc <= TOL_CONF):
            raise AssertionError(f"end to end {s}: depth {dd}, conf {dc}")
    dp = float((ok["stage1"]["pair_results"] - op["stage1"]["pair_results"]).abs().max())
    log(f"[e2e] pair depth max |diff| {dp:.3e} m")
    if not dp <= dtol:
        raise AssertionError(f"end to end pair depth {dp}")
    profile_forward(mk, (imgs, rel, dmin, dmax))
    return res


def profile_forward(model, inputs):
    """Device busy time of one 384x512 forward (torch.profiler, CUPTI),
    by kernel family, against the unprofiled forward's wall time: the
    device's idle share of a map."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(*inputs)
            torch.cuda.synchronize()
    wall = float(np.median(walls))
    fams = {"sweep_pair": "K1 sweep_corr", "sweep_cost": "K2 sweep_cost",
            "conv3x3_kernel": "K3 red_step2"}
    busy = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        fam = next((v for k, v in fams.items() if k in e.name), "other (PyTorch ops, cuDNN)")
        busy[fam] = busy.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(busy.values())
    if total == 0:
        log(f"[profile] forward {wall:.2f} ms wall; device time not measured "
            "(the profiler saw no device events)")
        return
    log(f"[profile] one 384x512 forward: {wall:.2f} ms wall (median of 3, "
        f"unprofiled), device busy {total:.2f} ms, idle share "
        f"{1 - total / wall:.3f}; busy ms by family " + json.dumps(
            {k: round(v, 3) for k, v in sorted(busy.items())}))


def phase_production_frame(dev, camF, posesF):
    """One 1856x2752 map through the kernel forward at the f=3727 survey
    geometry: every pixel finite."""
    from deep3d_aerial_tpu_torch.models.adamvs import AdaMVS
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(camF, posesF, dev, ref=1)
    model = init_random_weights(AdaMVS(), seed=0).to(dev).eval()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model(imgs, rel, dmin, dmax)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(imgs, rel, dmin, dmax)
        depth = out["depth"]
        finite = float(torch.isfinite(depth).float().mean())
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[fullres] {FULL_H}x{FULL_W} f={camF.fx:.1f}: {tuple(depth.shape)}, "
        f"finite {finite * 100:.4f}% of pixels, {took:.3f} s per map, "
        f"peak device memory {peak:.2f} GiB")
    if tuple(depth.shape) != (FULL_H, FULL_W) or finite != 1.0:
        raise AssertionError(f"full-res map: shape {tuple(depth.shape)}, "
                             f"finite share {finite}")
    return took


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "deep3d_aerial_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from deep3d_aerial_tpu_torch.ops import cuda_build
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost

    dev = torch.device("cuda")
    # float32 throughout: no TF32 in cuDNN convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    took = cuda_build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall "
        + json.dumps({k: round(v, 1) for k, v in took.items()}))
    for name in cuda_build.SOURCES:
        for line in cuda_build.library_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    cam0, poses0 = survey(W0, H0)
    camF, posesF = survey(FULL_W, FULL_H)

    t = time.perf_counter()
    records = phase_kernels(dev, cam0, poses0, camF, posesF)
    log(f"[phase] kernels {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counters = (sweep_corr, sweep_cost, red_step2)
    launches, _ = phase_main_path(dev, cam0, poses0, counters)
    log(f"[phase] main path {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_end_to_end(dev, cam0, poses0)
    log(f"[phase] end to end {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_production_frame(dev, camF, posesF)
    log(f"[phase] production frame {time.perf_counter() - t:.1f} s")

    src = {"sweep_corr": ("deep3d_aerial_tpu_torch/csrc/sweep.cu",
                          "deep3d_aerial_tpu/ops/pallas_sweep.py:235"),
           "sweep_cost": ("deep3d_aerial_tpu_torch/csrc/sweep.cu",
                          "deep3d_aerial_tpu/ops/pallas_sweep.py:520"),
           "red_step2": ("deep3d_aerial_tpu_torch/csrc/red_step2.cu",
                         "deep3d_aerial_tpu/ops/pallas_red.py:250")}
    kernels = []
    for name, (source, replaces) in src.items():
        rs = [r for r in records if r["name"] == name]
        main = [r for r in rs if not r["shape"].startswith("full-res")]

        def per_map(key):
            return sum(r[key] * r["per_map"] for r in main)

        bms = per_map("bound_ms")
        # per-map bound: say which side bounds the stage that dominates it
        by = max(main, key=lambda r: r["bound_ms"] * r["per_map"])["bound_by"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": per_map("ms"), "plain_ms": per_map("plain_ms"),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
