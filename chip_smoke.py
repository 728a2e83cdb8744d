"""The PyTorch port's driver on one CUDA card (an H100 in this repository's
measurements): builds the hand-written kernels from csrc/ and the native
host library from native/ (g++), holds each kernel against its plain
PyTorch version, and for each ported model -- AdaMVS, MSREDNet, CasMVSNet,
UCSNet -- runs the pipeline's main path (dense matching, fusion with the
.mvs handoff, the graph-cut mesh with refine and atlas texture, and the
DSM, at 384x512, default configuration, seeded random weights; CasMVSNet's
from a COLMAP model, through the default view selection), compares the
kernel path with the plain path end to end, and runs one 1856x2752
production frame. `[refine]` holds the photometric refine on the card
against the CPU (on the AdaMVS path's mesh, and on a 183k-vertex plane),
and `[main:fullres]` runs the default pipeline end to end on the
1856x2752 survey. `[main:pipelined]` runs a 2 x 2 survey at 1856x2752
(PIPELINED_NX: until PR 12 the 3 x 2 one in three blocks, 281.7 s with
`[fusion:cli]`; the cut pays for the multi-card phases) in two scene
blocks sharing views twice, run_dense one map at a time and
run_dense_pipelined in batches of 2 with `.dmap` and depth previews, and
holds the two to the same bytes in every product (maps, fused clouds,
`.mvs` scenes, meshes, DSM); it times the forward alone and beside a
fusing thread (the GIL's cost), and `[fusion:cli]` runs the standalone
fusion CLI on its maps to PLY and LAS. Then training: `[train:grad]` holds each kernel's
autograd Function (kernel forward, plain-VJP backward: ops/autograd.py)
against plain autograd on the card, `[train:step:<model>]` one train step
of each model through the kernels against the plain path,
`[train:adamvs]` the trainer at its CLI's defaults (384x768, two epochs
on a rendered WHU-layout folder, `--resume`, `--mode test`, the trained
params.npz through the pipeline's dense_match), and
`[train:<msrednet|casmvsnet|ucsnet>]` three steps of each other model.
Between the inference phases and training, the bfloat16 operating point
(compute_dtype bfloat16): `[kernel:bf16]` holds each kernel's bfloat16 mode
against its plain bfloat16 version at every stage shape of the 384x512
point (in bfloat16 ulps, TOL_BF16_ULPS_*), `[main:bf16:<model>]` runs each
model's main path to fusion in bfloat16 with every bfloat16 kernel of the
path counted, `[e2e:bf16:<model>]` holds each bfloat16 forward's kernels
against its plain versions (within 2x bfloat16's own distance from
float32) and profiles it, and `[fullres:bf16:adamvs]` runs one 1856x2752
bfloat16 map (finite share 100%). Then warp_precision 'compensated' (the
double-single projection): `[kernel:compensated]` holds K1/K2/K2v's
compensated modes, float32 and bfloat16, against their compensated plain
versions at every stage shape of the 384x512 point and at 1856x2752, with
the float32 projection's time beside each; `[main:compensated*]` runs the
AdaMVS and CasMVSNet main paths to fusion, float32 and bfloat16, every
sweep launch a compensated one; `[e2e:compensated]` holds AdaMVS's
compensated forward kernels against plain; `[fullres:compensated:adamvs]`
runs one 1856x2752 map (finite share 100%) against the float32
projection's. `[shards:<model>]` runs each model at depth_shards 2, kernels
against plain, its launches equal to depth_shards 1's, its seconds a map
beside them. Then the multi-card phases (parallel/: dp x sp over
torch.distributed): `[parallel:infer:<adamvs|casmvsnet>]` runs
make_infer_step at the 384x512 point with depth_shards 2 on a mesh of sp 2
and dp the card pairs (up to 4 cards; NCCL, one rank a card) or, on one
card, two gloo ranks sharing cuda:0 (the line says which, and that its
times are no collective times), in processes spawned by
parallel.launch.spawn, against the one-process forward on cuda:0 under
cudnn.deterministic, each rank's launches held to `sharded_launches`;
`[parallel:train]` one sharded AdaMVS train step against the one-process
step ([train:step]'s limits, parameters equal on every rank);
`[multihost]` launch_local with 2 hosts on the 384x512 survey in three
blocks against a one-host dense_match: maps and fused blocks byte-equal.
`[widths]` (after `[shards:*]`; alone with `--phases widths`) runs the
kernels at the channel counts of base widths other than 8: AdaMVS and
MSREDNet forwards at base 16, 3 and 4 (float32 and bfloat16) count each
kernel's launches by channel count (the wrappers' `launches_by_width`),
each against its plain forward; CasMVSNet with norm 'batch' and 'layer'
against plain; DeformConv2d and depth_from_normal on the card against the
CPU; K1/K2/K2v at C 64, 12 and 4 (each also once in the compensated
projection) and K3 at Cin 64 and 4 against their plain versions, K4 and
K5 at MSREDNet base 16's cost
widths; their rows join the kernels line (`<kernel>:C<n>`,
`red_step2:Cin<n>`, `red_step4:base16`, `cf_conv3x3:base16`, per map of
the forward that launches the width).

    python3 chip_smoke.py [--phases widths]

Needs a CUDA device and the repository around it; exits non-zero, printing
no result, otherwise. Each `[phase]` line also goes to standard error. Any failed check raises. The last three lines of
standard output are: the `kernels` JSON line, the card's name and power
limit as nvidia-smi gives them, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Kernel numbers (one entry per kernel, then one per kernel's bfloat16
mode, named `<kernel>:bf16`, from the bfloat16 phases, with `max_ulps`,
then one per sweep's compensated mode, `<kernel>:compensated` and
`<kernel>:bf16:compensated`, with `float32_mode_ms`, the float32
projection's time on the same inputs):
`ms`, `plain_ms`, `bound_ms` and `library_ms` are per depth map of the
main path at 384x512 of the model that `per_map_of` names, i.e. the
per-launch time at each stage's shape times that stage's launches per
map, summed over stages. `ms` and
`plain_ms` are device time: the durations of the device work one call
launches, read from torch.profiler (CUPTI), so the host's time to issue the
launches is not in them (the `[kernel]` lines also print the CUDA-event
time of a host-issued loop of calls, which is). `launches` is the count
over that model's main-path run; `max_abs_err` is the largest
kernel-vs-plain difference over all checked shapes (full-res included).
K3 is checked by both its entries, the score-writing one and the main
path's, which folds the score into the sweep's online-softmax state (3
launches a step: `[profile:red_step2]`); its per-map numbers are the
fold's, and `[host:red_step2]` times stage 1's sweep with the fold against
K3 plus the eager softmax update. K5, the channel-first conv template, runs
inside K4's step (9 of its 11 launches, two of them grouped over the four
levels): its per-map numbers come from the step's 15 conv shapes per stage,
each launched on its own as often as a map runs it, and are part of K4's.
Bounds: conv work (K3, K4, K5) at the tensor cores' fp32-exact rate, the
sweeps' arithmetic at the fp32 CUDA-core rate; a conv `[kernel]` line
prints the CUDA-core bound beside it. Only K5 has a single PyTorch call
that computes the same function (one cuDNN convolution), so `library_ms`
is null for the others (projection + bilinear taps + channel reduction, or
a whole GRU step); K3's entry carries `convs_cudnn_ms`, a yardstick of its
8 convs alone, each as one cuDNN call. Each entry also carries `backward`
(the route of its gradient), `bwd_ms` (the plain VJP's device ms per map
of the same path, from `[train:grad]`; null for K5, whose backward is
K4's), `grad_err` (the largest Function-vs-plain-autograd gradient error
over the max |grad|) and `train_launches_per_step` (per model trained).
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3;
# fp32-exact convolution on the dense TF32 tensor cores (3xTF32: three
# products per multiply-add) at a third of 495 TFLOP/s
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32X3 = 495e12 / 3
# bfloat16 products on the dense tensor cores (the bf16 modes' MMAs)
PEAK_BF16 = 989e12

# main path: the default AdaMVS configuration at 384x512
H0, W0 = 384, 512
VIEWS = 5
NDEPTHS = (48, 32, 8)
CHANNELS = (32, 16, 8)
CHUNK = 8
FULL_H, FULL_W = 1856, 2752

# MSREDNet at its published widths: base 8, 'unet' features 32/16/8,
# RedStep4 hidden 8/16/32/64, the same planes per stage
MSRED_CHANNELS = (32, 16, 8)
# UCSNet's planes per stage (CasMVSNet takes NDEPTHS); both at their
# published widths: base 8, features 32/16/8 ('fpn' and 'unet'), a
# CostRegNet3D of base 8 per stage
UCS_NDEPTHS = (64, 32, 8)
# one RedStep2 step (csrc/red_step2.cu): 3 launches, one per level
RED2_LAUNCHES = 3
# one RedStep4 step (csrc/red_step4.cu): 11 launches, 9 of them the conv
# template (conv1-3, the grouped gates and candidates, upconv3-1, score)
# over the step's 15 convolutions
RED4_LAUNCHES = 11
RED4_CONVS = 9

# kernel vs plain on the card, stated before measuring: the kernels round
# the projection exactly as the plain chain does, but nvcc contracts the
# feature products and the sums run in another order (and cuDNN sums the
# convolutions in its own order): unit-scale values agree to ~1e-6
TOL_SWEEP = 1e-4
# K3 (3xTF32 tensor-core convs, fp32 sums in another order than cuDNN):
# ~1e-6 on unit-scale states and scores; its softmax fold repeats
# OnlineSoftmaxState.update's operations in order (expf, no contraction),
# its depth sum acc compared relative to the depth scale
TOL_RED = 1e-4
# K2v sums the same warps in another order (the ref first) and squares
# them: ~1e-6 on unit-scale features, as for K2. K5 sums its 9*Ci products
# in another order than cuDNN: ~1e-6 at Ci 128 on unit-scale inputs. K4,
# three chained planes: its one-group GroupNorm sums the whole map in
# per-block partials (a fixed order, in double at the end) where cuDNN's
# plain version takes torch.mean; the normalised values agree to ~1e-6
# and the GRU keeps them bounded, so 1e-4 absolute as for K3.
TOL_VAR = 1e-4
TOL_CONV = 1e-4
TOL_RED4 = 1e-4
# end to end (as the CPU parity tests): depth within 1e-3 of the depth
# range, confidence within 1e-4
TOL_DEPTH_FRAC = 1e-3
TOL_CONF = 1e-4
# bfloat16 modes, kernel against its plain bfloat16 version on the same
# inputs, stated before measuring, in bfloat16 ulps of each output's largest
# magnitude (one ulp of M: 2^(floor(log2 M) - 7)). Both compute the same
# float32 value up to the order of its sums and round it to bfloat16 at
# the same places, so a value that falls near a rounding boundary can round
# the other way: one ulp of that value. The sweeps and K5 round once (2
# ulps); K3 and K4, over 3 chained planes, round at every layer and carry
# a flipped rounding through the GRU into the next plane (8 ulps).
TOL_BF16_ULPS_SWEEP = 2
TOL_BF16_ULPS_CONV = 2
TOL_BF16_ULPS_RED = 8
# a bfloat16 forward, kernels against plain versions (same weights and
# inputs): within 2x the distance bfloat16 itself puts between the plain
# bfloat16 forward and the plain float32 one, measured in the same run
# (the CPU tests' rule against the JAX package), or the float32 tolerances
# above where those are larger
BF16_GAP_FACTOR = 2.0
# photometric refine, card against CPU, within this x the mesh's mean edge,
# for every step taken from the same vertices: the two compute the vertex
# normals alike (mesh/refine.py: `_cross`, `_corner_passes`), so a vertex
# whose face normals nearly cancel points the same way on both, but the
# Laplacian's scatter-add (index_add, atomic on the card) and the sums over
# views and taps reduce in other orders: a few ulps of the coordinates a
# step (a step moves a vertex by at most 0.05 mean edges). A whole run is
# not held to it: the refinement is chaotic at float32 resolution. The bilinear
# sample's gradient jumps where a tap crosses a pixel border, and the step
# is normalised by the largest normal gradient, so one vertex's jump
# rescales every step; on the CPU alone a 1-ulp change of the input mesh
# moved a 20-step refine of a pipeline mesh by 0.28 (zncc) and 0.24
# (variance) mean edges, one step by 3.1e-6 (scripts/mesh_probe.py chaos).
# The whole run's card-vs-CPU distance is printed, not gated.
TOL_REFINE_EDGE = 1e-4
# the mesh stage's graph cut (native/delaunay_mesh.cc, from the JAX
# package) gets about this many fused points a block: the config's
# recons_decimate_ratio is set to it before the stage. The core's cost
# grows about as the square of its input (likely its locate per point
# after the insertions, native/delaunay_mesh.cc:342-350): 20k points took
# 31 s and 60k 256 s on one core of a Sapphire Rapids host
# (scripts/mesh_probe.py graphcut), so the 180k points of a 384x512 main
# path would take half an hour or more
GRAPHCUT_POINTS = 8000


def log(*a):
    print(*a, flush=True)
    # each phase's end goes to standard error too: a run stopped by a time
    # limit then shows there the last phase that it finished
    if a and str(a[0]).startswith("[phase]"):
        print(*a, file=sys.stderr, flush=True)


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


def write_workspace(ws: Path, cam, poses, dev, columns=0):
    """export/ of a survey, written with the port's own text formats:
    cameras, images (depth range from the rendered depths), image paths,
    view pairs (nearest centres first) and one scene block; with `columns`
    (the survey's nx) one block per column instead, each over its column's
    footprint with that column's views as refs, and the view pairs listed
    column by column, the order in which a block-by-block survey hands its
    views over (dense matching takes them in that order)."""
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
    blocks = [([-200.0, 200.0, -200.0, 200.0, -50.0, 50.0],
               list(range(1, len(poses) + 1)))]
    if columns:
        border = footprint(cam, poses)
        hx = 0.5 * cam.width / cam.fx * centers[:, 2].mean()
        col = [list(range(gx, len(poses), columns)) for gx in range(columns)]
        blocks = [([float(centers[c[0], 0] - hx), float(centers[c[0], 0] + hx)]
                   + border[2:], [j + 1 for j in c]) for c in col]
        pairs = [pairs[j] for c in col for j in c]
    tf.write_view_pairs(export / "viewpair.txt", pairs)
    tf.write_blocks(export / "blocks.txt", blocks)
    tf.write_border(export / "scene_border.txt", footprint(cam, poses))


def footprint(cam, poses):
    """The survey's ground footprint at the terrain's level (x0, x1, y0,
    y1, z0, z1): the DSM's border."""
    c = np.stack([p.center for p in poses])
    hx = 0.5 * cam.width / cam.fx * c[:, 2].mean()
    hy = 0.5 * cam.height / cam.fy * c[:, 2].mean()
    return [float(c[:, 0].min() - hx), float(c[:, 0].max() + hx),
            float(c[:, 1].min() - hy), float(c[:, 1].max() + hy), -50.0, 50.0]


def write_colmap_workspace(ws: Path, cam, poses, dev, n_points=4000, seed=5):
    """images/ and sparse/ of a survey: a COLMAP model written with the
    port's sparse.colmap -- the camera, each image's pose, and terrain
    points over the survey's footprint with their tracks (each point in
    every image it projects into). export/ is left to view selection."""
    from PIL import Image

    from deep3d_aerial_tpu_torch.geometry.camera import rotmat2qvec
    from deep3d_aerial_tpu_torch.sparse import colmap

    (ws / "images").mkdir(parents=True)
    for i, pose in enumerate(poses, start=1):
        img, _ = render(cam, pose, dev)
        Image.fromarray(np.dstack([(img.cpu().numpy() * 255).astype(np.uint8)] * 3)
                        ).save(ws / "images" / f"im_{i:02d}.png")
    rng = np.random.default_rng(seed)
    c = np.stack([p.center for p in poses])
    half = 0.6 * cam.width / cam.fx * 100.0
    x = rng.uniform(c[:, 0].min() - half, c[:, 0].max() + half, n_points)
    y = rng.uniform(c[:, 1].min() - half, c[:, 1].max() + half, n_points)
    xyz = np.stack([x, y, terrain_z(torch.from_numpy(x), torch.from_numpy(y)).numpy()], -1)
    tracks = {p: [] for p in range(n_points)}
    obs = {}
    for i, pose in enumerate(poses, start=1):
        uv, d = pose.world_to_image(cam.K, xyz)
        vis = ((uv[:, 0] >= 0) & (uv[:, 0] < cam.width) & (uv[:, 1] >= 0)
               & (uv[:, 1] < cam.height) & (d > 0))
        obs[i] = [(uv[p], p) for p in np.nonzero(vis)[0]]
        for k, (_, p) in enumerate(obs[i]):
            tracks[p].append((i, k))
    points = {p + 1: colmap.ColmapPoint3D(
        p + 1, xyz[p], np.array([128, 128, 128], np.uint8), 0.5,
        np.array([t[0] for t in tr], np.int64), np.array([t[1] for t in tr], np.int64))
        for p, tr in tracks.items() if len(tr) >= 2}
    cameras = {1: colmap.ColmapCamera(1, "PINHOLE", cam.width, cam.height,
                                      np.array([cam.fx, cam.fy, cam.cx, cam.cy]))}
    images = {i: colmap.ColmapImage(
        i, rotmat2qvec(pose.R_cw), pose.t_cw, 1, f"im_{i:02d}.png",
        np.array([uv for uv, _ in obs[i]]).reshape(-1, 2),
        np.array([p + 1 if p + 1 in points else -1 for _, p in obs[i]], np.int64))
        for i, pose in enumerate(poses, start=1)}
    (ws / "sparse").mkdir()
    colmap.write_model(cameras, images, points, ws / "sparse")
    return len(points)


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


def own_launches():
    """Device launches of the port's kernels so far, from the wrappers'
    counters: a sweep call is one launch, a RedStep2 step RED2_LAUNCHES, a
    RedStep4 step its two GRU passes beside the conv-template launches it
    adds to cf_conv3x3's count."""
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost, sweep_var

    return (sweep_corr.launches + sweep_cost.launches + sweep_var.launches
            + RED2_LAUNCHES * red_step2.launches
            + (RED4_LAUNCHES - RED4_CONVS) * red_step4.launches + cf_conv3x3.launches)


# the names of the port's kernels (csrc/*.cu), as the profiler lists them
OWN_KERNEL = re.compile(r"\b(sweep_\w+_kernel|red2_level\d_kernel|gru_(reset|update)_kernel"
                        r"|conv_mma_kernel)\b")


def device_ms(fn, iters):
    """Mean device milliseconds per call, after one warm call: the summed
    durations of the device work (kernels, copies, fills) that `iters` calls
    launch, from torch.profiler (CUPTI, `device_events`). The host's issue
    time and the gaps between launches are not in it. Each session must
    list one event of the port's kernels for each launch that the wrappers'
    counters add (`own_launches`) over the warm call, times `iters`; a
    session that does not is measured again, and five in a row raise. A
    session of the port's kernels whose events are all theirs is thus
    complete and is taken as it is; otherwise (plain versions, yardsticks)
    the larger of two sessions is, since a lost event of a PyTorch or
    cuDNN kernel, which no counter sees, would only lower the sum (a plain
    version's session can even list no event at all). (Up to PR 10 every call took
    two sessions; PR 11 took the second off the port's own kernels for the
    script's time.)"""
    from deep3d_aerial_tpu_torch.utils.profiling import device_events

    before = own_launches()
    fn()
    torch.cuda.synchronize()
    want = (own_launches() - before) * iters

    def run():
        for _ in range(iters):
            fn()

    def whole(evs):
        return sum(1 for e in evs if OWN_KERNEL.search(e.name)) == want
    evs = device_events(run, whole)
    us = sum(e.time_range.elapsed_us() for e in evs)
    if not want or not all(OWN_KERNEL.search(e.name) for e in evs):
        us = max(us, sum(e.time_range.elapsed_us() for e in device_events(run, whole)))
    if us <= 0:
        raise RuntimeError("torch.profiler saw no device work: device time not measured")
    return us / 1e3 / iters


def kernels_of(evs):
    """The kernel events of `evs` (memsets and copies left out)."""
    return [e for e in evs if "Memset" not in e.name and "Memcpy" not in e.name]


def kernel_events(fn, per_call, what):
    """The kernel events of three profiled calls of `fn` (`device_events`),
    in start order, holding exactly `per_call` launches a call: a session
    that lists another count (a lost event) is measured again, and five in
    a row raise, with the events listed."""
    from deep3d_aerial_tpu_torch.utils.profiling import device_events

    calls = 3

    def run():
        for _ in range(calls):
            fn()
    try:
        return kernels_of(device_events(
            run, lambda evs: len(kernels_of(evs)) == calls * per_call))
    except AssertionError as e:
        raise AssertionError(f"{what}: not {per_call} launches a call: {e}") from None


def one_call(evs, kernels, what):
    """The last run of len(kernels) consecutive events whose names hold
    `kernels` in order (one whole call of a multi-launch step)."""
    n = len(kernels)
    for i in range(len(evs) - n, -1, -1):
        if all(k in e.name for k, e in zip(kernels, evs[i:i + n])):
            return evs[i:i + n]
    raise AssertionError(f"{what}: no call launched {', '.join(kernels)} in order: "
                         + ", ".join(e.name[:40] for e in evs))


def bound_ms(nbytes, flops, peak=PEAK_FP32):
    """(least time in ms, 'bytes' or 'operations'): each input read once
    and each output written once over the memory rate, against the
    arithmetic over `peak` (conv work: PEAK_TF32X3)."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# projection (3 rays, p = ray*d + t, two divides) + floor/fraction + the
# four bilinear weights, per (plane, pixel, view)
GEOM_FLOPS = 30
# the compensated projection (csrc/sweep.cu, a division counted as one
# operation): per (plane, pixel, view) p = ray*d + t in double-single (3 x
# (ds_mul 27 + ds_add 14)), the z guards, two compensated divisions (2 x
# 47) and the behind test, 225, plus the float32 mode's taps and weights
# after it; per (pixel, view) the double-single ray (3 x (2 ds_mul + 2
# ds_add) = 246)
GEOM_FLOPS_COMP = 243
RAY_FLOPS_COMP = 246


def _comp_flops(V, K, H, W, comp):
    """The compensated projection's operations beyond GEOM_FLOPS."""
    if not comp:
        return 0
    return V * K * H * W * (GEOM_FLOPS_COMP - GEOM_FLOPS) + V * H * W * RAY_FLOPS_COMP


# `fb`: bytes of a feature and output element (4 float32, 2 bfloat16);
# projections, depths and weights stay float32; `comp`: the compensated
# projection
def sweep_corr_work(V, K, H, W, C, fb=4, comp=False):
    nbytes = fb * ((V + 1) * H * W * C + V * K * H * W) + 4 * (K * H * W + 12 * V)
    flops = V * K * H * W * (GEOM_FLOPS + 8 * C + 2 * C)  # 4 taps, dot, mean
    return nbytes, flops + _comp_flops(V, K, H, W, comp)


def sweep_cost_work(V, K, H, W, C, fb=4, comp=False):
    nbytes = (fb * ((V + 1) * H * W * C + K * C * H * W)
              + 4 * (K * H * W + V * H * W + 12 * V))
    flops = K * H * W * (V * (GEOM_FLOPS + 11 * C + 1) + C)  # taps, *ref*w+, /
    return nbytes, flops + _comp_flops(V, K, H, W, comp)


def sweep_var_work(V, K, H, W, C, fb=4, comp=False):
    nbytes = fb * ((V + 1) * H * W * C + K * C * H * W) + 4 * (K * H * W + 12 * V)
    flops = K * H * W * (V * (GEOM_FLOPS + 11 * C) + 5 * C)  # taps, s, q; var
    return nbytes, flops + _comp_flops(V, K, H, W, comp)


def red_step4_convs(cin, H, W):
    """The 15 convolutions of one RedStep4 step at H x W, in launch order:
    (name, Ci, Co, input H, input W, mode)."""
    h, w = [H >> l for l in range(4)], [W >> l for l in range(4)]
    return [("conv1", cin, 16, h[0], w[0], "down"),
            ("conv2", 16, 32, h[1], w[1], "down"),
            ("conv3", 32, 64, h[2], w[2], "down"),
            ("gates1", cin + 8, 16, h[0], w[0], "same"),
            ("gates2", 32, 32, h[1], w[1], "same"),
            ("gates3", 64, 64, h[2], w[2], "same"),
            ("gates4", 128, 128, h[3], w[3], "same"),
            ("cand1", cin + 8, 8, h[0], w[0], "same"),
            ("cand2", 32, 16, h[1], w[1], "same"),
            ("cand3", 64, 32, h[2], w[2], "same"),
            ("cand4", 128, 64, h[3], w[3], "same"),
            ("upconv3", 64, 32, h[3], w[3], "up"),
            ("upconv2", 32, 16, h[2], w[2], "up"),
            ("upconv1", 16, 8, h[1], w[1], "up"),
            ("score", 8, 1, h[0], w[0], "same")]


def cudnn_conv(x, w, b, mode):
    """One cuDNN call computing a K5-shaped conv ('down': the input padded
    once beforehand, outside the timed call)."""
    from deep3d_aerial_tpu_torch.ops.conv import same_pads

    F = torch.nn.functional
    if mode == "same":
        return lambda: F.conv2d(x[None], w, b, padding=1)
    if mode == "down":
        (yl, yh), (xl, xh) = (same_pads(n, 3, 2) for n in x.shape[1:])
        xp = F.pad(x[None], (xl, xh, yl, yh))
        return lambda: F.conv2d(xp, w, b, stride=2)
    H, W = x.shape[1:]
    return lambda: F.conv_transpose2d(x[None], w, b, stride=2)[..., :2 * H, :2 * W]


def red_step2_convs(cin, H, W, up):
    """The 8 convolutions of one RedStep2 step at H x W, in order: (name,
    Ci, Co, input H, input W, mode)."""
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    return [("conv1", cin, 8, H, W, "same"), ("gates1", 16, 16, H, W, "same"),
            ("cand1", 16, 8, H, W, "same"), ("conv2", 8, 16, H, W, "down"),
            ("gates2", 32, 32, H2, W2, "same"), ("cand2", 32, 16, H2, W2, "same"),
            ("upconv1", 16, 8, H2, W2, "up"),
            ("score", 8, 1, H, W, "up" if up else "same")]


def conv_work(ci, co, H, W, mode, eb=4):
    """One 3x3 conv: input, output and weights once (`eb` bytes an element;
    the bias float32); multiply-adds x 2 (a transposed conv: 9 taps per
    input pixel)."""
    Ho, Wo = {"same": (H, W), "down": ((H + 1) // 2, (W + 1) // 2),
              "up": (2 * H, 2 * W)}[mode]
    macs = ci * co * 9 * (H * W if mode == "up" else Ho * Wo)
    return eb * (ci * H * W + co * Ho * Wo + ci * 9 * co) + 4 * co, 2 * macs


def red_step4_work(cin, H, W, n_weights, eb=4):
    """The 15 convs' multiply-adds x 2 (GroupNorm and GRU pointwise math
    are ~1% and left out); bytes (`eb` an element): cost and the four
    states in, the states and the score out, and the weights."""
    flops = sum(conv_work(*c[1:])[1] for c in red_step4_convs(cin, H, W))
    states = sum(c * (H >> l) * (W >> l) for l, c in enumerate((8, 16, 32, 64)))
    return eb * (cin * H * W + 2 * states + H * W + n_weights), flops


def red_step2_work(cin, H, W, up, n_weights, fold=False, eb=4):
    """Convolution multiply-adds x 2 (the pointwise GRU and softmax math is
    ~1% of it and left out); bytes (`eb` an element): cost and both states
    in, states out, the weights, and the score out, or with `fold` the
    float32 online-softmax state (4 maps) in and out and the plane's depth
    in, at the score's shape."""
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    macs = (H * W * 9 * (cin * 8 + 16 * 16 + 16 * 8)
            + H2 * W2 * 9 * (8 * 16 + 32 * 32 + 32 * 16 + 16 * 8)
            + H * W * 9 * 8)
    score = 4 * H * W if up else H * W
    nbytes = (eb * (cin * H * W + 2 * 8 * H * W + 2 * 16 * H2 * W2 + n_weights)
              + (4 * 9 * score if fold else eb * score))
    return nbytes, 2 * macs


def bf16_ulps(outs_k, outs_p):
    """The largest kernel-vs-plain difference of any output, in bfloat16
    ulps of that output's largest magnitude (TOL_BF16_ULPS_*)."""
    worst = 0.0
    for a, b in zip(outs_k, outs_p):
        top = float(b.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133
        worst = max(worst, float((a.float() - b.float()).abs().max()) / ulp)
    return worst


def compare_kernel(records, name, shape_tag, kernel_fn, plain_fn, tol, work,
                   per_map, iters, n_calls=1, library_fn=None, conv=False,
                   time_fns=None, ulps=None):
    """Kernel against its plain version on the same inputs: max abs error
    (raises above `tol`; for a bfloat16 mode, `ulps`, above that many
    bfloat16 ulps, `bf16_ulps`), device ms of both (and of `library_fn`,
    one PyTorch call computing the same function), the bound from `work`
    (bytes, flops; `conv`: the flops at the tensor cores' fp32-exact rate,
    or with `ulps` at their bfloat16 rate, the CUDA-core bound printed
    beside it). Raises if a time is below its bound. Times are per call of
    the kernel's function, which is `kernel_fn` over `n_calls`; `time_fns`
    (kernel, plain) are timed instead where the checked functions do
    set-up work of their own."""
    out_k = kernel_fn()
    out_p = plain_fn()
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs_k, outs_p))
    rel = max(float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1e-3)).max())
              for a, b in zip(outs_k, outs_p))
    finite = all(bool(torch.isfinite(a).all()) for a in outs_k)
    n_ulps = bf16_ulps(outs_k, outs_p) if ulps is not None else None
    time_k, time_p = time_fns or (kernel_fn, plain_fn)
    ms = device_ms(time_k, iters) / n_calls
    loop = loop_ms(time_k, iters) / n_calls
    plain_ms = device_ms(time_p, max(1, iters // 4)) / n_calls
    lib_ms = device_ms(library_fn, iters) if library_fn is not None else None
    peak = (PEAK_BF16 if ulps is not None else PEAK_TF32X3) if conv else PEAK_FP32
    b_ms, b_by = bound_ms(*work, peak)
    old = f" (fp32 CUDA cores: {bound_ms(*work)[0]:.4f})" if conv else ""
    rec = dict(name=name, shape=shape_tag, max_abs_err=err,
               max_rel_err=rel, tol=tol if ulps is None else f"{ulps} bf16 ulps",
               ulps=n_ulps, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               per_map=per_map)
    records.append(rec)
    lib = "" if lib_ms is None else f" library {lib_ms:.4f}"
    check = (f"tol {tol:g}" if ulps is None
             else f"{n_ulps:.2f} bf16 ulps of the largest output, tol {ulps}")
    log(f"[kernel] {name:10s} {shape_tag:28s} err {err:.3e} (rel {rel:.3e}, "
        f"{check}) device ms: kernel {ms:.4f} plain {plain_ms:.4f}{lib} "
        f"bound {b_ms:.4f}{old} ({b_by}, {b_ms / ms:.1%} of it reached); "
        f"host-issued loop {loop:.4f} ms/call; launches/map {per_map}")
    ok = err <= tol if ulps is None else n_ulps <= ulps
    if not finite or not ok:
        raise AssertionError(f"{name} {shape_tag}: kernel vs plain "
                             f"max abs err {err} ({n_ulps} bf16 ulps) over its "
                             f"tolerance (finite={finite})")
    if ms < b_ms:
        raise AssertionError(f"{name} {shape_tag}: {ms} ms is below its "
                             f"{b_ms} ms bound: the work count is wrong")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def stage_rel(cam, poses, stage, dev):
    """[V-1, 4, 4] relative projections of the survey's first VIEWS views
    at one stage's resolution."""
    from deep3d_aerial_tpu_torch.geometry.camera import (
        proj_matrix,
        stage_relative_projections,
    )

    P = np.stack([proj_matrix(cam.K, p) for p in poses[:VIEWS]])
    rel = stage_relative_projections(P, 3)[stage].astype(np.float32)
    return torch.from_numpy(rel).to(dev)


def stage_planes(cam, poses, stage, H, W, dev, n=CHUNK):
    """n depth planes [n, H, W] (a chunk of CHUNK by default) as the main
    path's stage gives them: the first n of stage 1's uniform planes over
    the range, a window around the rendered depth after."""
    from deep3d_aerial_tpu_torch.ops.depth_samplers import window_depth_samples

    _, depth = render(cam, poses[0], dev)
    center = torch.nn.functional.interpolate(
        depth[None, None], size=(H, W), mode="bilinear",
        align_corners=False)[0, 0]
    if stage == 0:
        lo, hi = float(depth.min()) - 10, float(depth.max()) + 10
        d = torch.linspace(lo, hi, NDEPTHS[0], device=dev)[:n]
        return d[:, None, None].expand(n, H, W).contiguous()
    interval = (2.0 if stage == 1 else 1.0) * 0.1
    return window_depth_samples(center, n, interval).contiguous()


def sweep_breakdown(fn, kernel, what):
    """Device microseconds of one launch of a sweep wrapper (median over
    three profiled calls); raises unless each call is exactly one launch of
    `kernel` (no copy of the projections, no other work)."""
    fn()
    torch.cuda.synchronize()
    evs = kernel_events(fn, 1, what)
    if any(kernel not in e.name for e in evs):
        raise AssertionError(f"{what} launched " + ", ".join(e.name[:60] for e in evs)
                             + f", not only {kernel}")
    us = float(np.median([e.time_range.elapsed_us() for e in evs]))
    log(f"[profile:sweep] {what}: one launch, {us:.1f} us of device time (median of "
        f"{len(evs)}; {evs[0].name[:40]})")
    return us


def phase_kernels(dev, cam0, poses0, camF, posesF):
    """Each AdaMVS kernel against its plain version at the main path's
    shapes (+ 1856x2752 stage 3 for K2 and K3); K3 by both entries, with
    its convs' cuDNN yardstick and per-launch profile. Returns (per-shape
    records, K3's conv yardstick in device ms per map)."""
    from deep3d_aerial_tpu_torch.models.cascade import OnlineSoftmaxState
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2
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

    def compare(*args, **kw):
        compare_kernel(records, *args, **kw)

    def red2_case(C, H, W, up, seed, per_map, iters, tag):
        """K3 at one shape: the score-writing entry (one step), then the
        main path's entry, the softmax fold, over 3 chained planes from
        OnlineSoftmaxState.init; then the step's 8 convs as cuDNN calls
        (the convs' yardstick) and its per-launch profile. Returns the
        yardstick's device ms."""
        mod = init_random_weights(RedStep2(C, up=up), seed=seed).to(dev)
        params = dict(mod.named_parameters())
        packed = mod._packed_params()
        cost, s1 = rnd(C, H, W), rnd(8, H, W, scale=0.5)
        s2 = rnd(16, (H + 1) // 2, (W + 1) // 2, scale=0.5)
        n_w = sum(p.numel() for p in params.values())
        shape = (2 * H, 2 * W) if up else (H, W)
        costs = [rnd(C, H, W) for _ in range(3)]
        dvs = [d + torch.rand(shape, generator=g, device=dev) for d in (95.0, 100.0, 105.0)]
        dscale = max(float(dv.max()) for dv in dvs)

        def planes(fold, osm):
            a, b = s1, s2
            for c, dv in zip(costs, dvs):
                if fold:
                    _, a, b = red_step2(params, c, a, b, up=up, packed=packed, osm=osm, dv=dv)
                else:
                    sc, a, b = red_step2_plain(params, c, a, b, up=up)
                    osm = OnlineSoftmaxState.update(osm, sc, dv)
            return osm, a, b

        def checked(fold):
            # acc sums e * depth: compared relative to the depth scale
            (m, s, acc, pmax), a, b = planes(fold, OnlineSoftmaxState.init(shape, device=dev))
            return m, s, acc / dscale, pmax, a, b

        osm_t = OnlineSoftmaxState.init(shape, device=dev)
        with torch.no_grad():
            compare("red_step2", tag + (" up" if up else "") + " score entry",
                    lambda: red_step2(params, cost, s1, s2, up=up, packed=packed),
                    lambda: red_step2_plain(params, cost, s1, s2, up=up),
                    TOL_RED, red_step2_work(C, H, W, up, n_w), 0, iters, conv=True)
            compare("red_step2", tag + (" up" if up else "") + " softmax fold",
                    lambda: checked(True), lambda: checked(False), TOL_RED,
                    red_step2_work(C, H, W, up, n_w, fold=True), per_map, iters,
                    n_calls=3, conv=True,
                    time_fns=(lambda: planes(True, osm_t), lambda: planes(False, osm_t)))
            convs = []
            for _, ci, co, h, w, mode in red_step2_convs(C, H, W, up):
                wt = rnd(*((ci, co, 3, 3) if mode == "up" else (co, ci, 3, 3)),
                         scale=(9 * ci) ** -0.5)
                convs.append(cudnn_conv(rnd(ci, h, w), wt, rnd(co, scale=0.1), mode))

            def run_convs():
                for f in convs:
                    f()
            yard = device_ms(run_convs, iters)
            log(f"[kernel] red_step2  {tag}: yardstick of the convs alone (the step's 8 "
                f"convs, one cuDNN fp32 call each, TF32 off, summed): {yard:.4f} device ms")
            red2_breakdown(params, packed, cost, s1, s2, up, dvs[0], tag)
        return yard

    def red2_breakdown(params, packed, cost, s1, s2, up, dv, tag):
        """Device microseconds of each launch of one fused step (the last
        whole step of three profiled), labelled by level; raises unless a
        step is exactly RED2_LAUNCHES launches."""
        osm = OnlineSoftmaxState.init(dv.shape, device=dev)

        def step():
            red_step2(params, cost, s1, s2, up=up, packed=packed, osm=osm, dv=dv)

        step()
        torch.cuda.synchronize()
        want = [("L1 x1+gates1+cand1", "red2_level1"), ("L2 x2+gates2+cand2", "red2_level2"),
                ("L3 upconv1+score+softmax", "red2_level3")]
        what = f"RedStep2 steps at {tag}"
        evs = one_call(kernel_events(step, RED2_LAUNCHES, what),
                       [k for _, k in want], what)
        us = [[lab, round(e.time_range.elapsed_us(), 1)] for (lab, _), e in zip(want, evs)]
        log(f"[profile:red_step2] {tag}: one step, {len(evs)} launches, "
            f"{sum(u for _, u in us):.1f} us of device time: " + json.dumps(us))

    V1 = VIEWS - 1
    yard = 0.0
    for stage, (C, D) in enumerate(zip(CHANNELS, NDEPTHS)):
        s = 2 ** (2 - stage)
        H, W = H0 // s, W0 // s
        rel = stage_rel(cam0, poses0, stage, dev)
        ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
        d = stage_planes(cam0, poses0, stage, H, W, dev)
        tag = f"stage{stage + 1} {H}x{W} C{C}"
        if stage != 1:
            # K1: every view's volume over stage 1's planes, one launch a
            # map (at stage 3's shape only profiled, for comparison)
            dpair = stage_planes(cam0, poses0, 0, H, W, dev, n=NDEPTHS[0])
            if stage == 0:
                compare("sweep_corr", tag + f" V{V1} D{NDEPTHS[0]}",
                        lambda: sweep_corr(ref, srcs, rel, dpair),
                        lambda: sweep_corr_plain(ref, srcs, rel, dpair),
                        TOL_SWEEP, sweep_corr_work(V1, NDEPTHS[0], H, W, C), 1, 50)
            sweep_breakdown(lambda: sweep_corr(ref, srcs, rel, dpair), "sweep_pair",
                            f"sweep_corr {tag} V{V1} D{NDEPTHS[0]}"
                            + ("" if stage == 0 else " (not a main-path shape)"))
            del dpair
        wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
        compare("sweep_cost", tag + f" V{V1} K{CHUNK}",
                lambda: sweep_cost(ref, srcs, rel, d, wts),
                lambda: sweep_cost_plain(ref, srcs, rel, d, wts),
                TOL_SWEEP, sweep_cost_work(V1, CHUNK, H, W, C), D // CHUNK, 50)
        if stage != 1:
            sweep_breakdown(lambda: sweep_cost(ref, srcs, rel, d, wts), "sweep_cost",
                            f"sweep_cost {tag} V{V1} K{CHUNK}")
        yard += D * red2_case(C, H, W, stage < 2, stage, D, 50, tag)

    # production frame, stages 1-2 (464x688 C32, 928x1376 C16): K2
    for stage in (0, 1):
        H, W, C = FULL_H >> (2 - stage), FULL_W >> (2 - stage), CHANNELS[stage]
        rel = stage_rel(camF, posesF, stage, dev)
        ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
        d = stage_planes(camF, posesF, stage, H, W, dev)
        wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
        compare("sweep_cost", f"full-res stage{stage + 1} {H}x{W} C{C} V{V1} K{CHUNK}",
                lambda: sweep_cost(ref, srcs, rel, d, wts),
                lambda: sweep_cost_plain(ref, srcs, rel, d, wts),
                TOL_SWEEP, sweep_cost_work(V1, CHUNK, H, W, C), 0, 5)
    # production frame, stage 3 (1856x2752, C=8): K2 and K3
    H, W, C = FULL_H, FULL_W, CHANNELS[2]
    rel = stage_rel(camF, posesF, 2, dev)
    ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
    d = stage_planes(camF, posesF, 2, H, W, dev)
    wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
    tag = f"full-res stage3 {H}x{W} C{C}"
    compare("sweep_cost", tag + f" V{V1} K{CHUNK}",
            lambda: sweep_cost(ref, srcs, rel, d, wts),
            lambda: sweep_cost_plain(ref, srcs, rel, d, wts),
            TOL_SWEEP, sweep_cost_work(V1, CHUNK, H, W, C), 1, 5)
    del ref, srcs, wts
    red2_case(C, H, W, False, 3, 8, 5, tag)
    torch.cuda.empty_cache()
    log(f"[kernel] red_step2 per AdaMVS {H0}x{W0} map: yardstick of the convs alone "
        f"(8 cuDNN calls a step x {sum(NDEPTHS)} steps) {yard:.4f} device ms")
    return records, yard


def conv_operands(rnd, ci, co, H, W, mode):
    """A K5 conv's input, weight (conv OIHW or transposed [in, out, 3, 3]),
    bias and packed weight, drawn from `rnd`."""
    from deep3d_aerial_tpu_torch.ops.cf_conv import pack_weight

    x = rnd(ci, H, W)
    w = rnd(*((ci, co, 3, 3) if mode == "up" else (co, ci, 3, 3)), scale=(9 * ci) ** -0.5)
    return x, w, rnd(co, scale=0.1), pack_weight(w, mode)


def k5_per_map(rnd, channels, records, what):
    """K5 per map of a MSREDNet whose stages give RedStep4 the cost widths
    `channels`: the 15 convs of each stage's step, D_stage times each, each
    shape held against its plain version once and then launched as often
    as a map launches it (kernel, plain version, library call). Returns the
    per-map numbers; max_abs_err also covers the `records` named
    cf_conv3x3."""
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3, cf_conv3x3_plain

    items, err, b_by, old_bound = [], 0.0, {}, 0.0
    for stage, (C, D) in enumerate(zip(channels, NDEPTHS)):
        H, W = H0 >> (2 - stage), W0 >> (2 - stage)
        for _, ci, co, h, w, mode in red_step4_convs(C, H, W):
            x, wt, b, pk = conv_operands(rnd, ci, co, h, w, mode)
            k = cf_conv3x3(x, wt, b, mode=mode, relu=False, packed=pk)
            err = max(err, float((k - cf_conv3x3_plain(
                x, wt, b, mode=mode, relu=False)).abs().max()))
            bms, by = bound_ms(*conv_work(ci, co, h, w, mode), PEAK_TF32X3)
            b_by[by] = b_by.get(by, 0.0) + bms * D
            old_bound += bound_ms(*conv_work(ci, co, h, w, mode))[0] * D
            items.append((D, x, wt, b, pk, mode))
    if not err <= TOL_CONV:
        raise AssertionError(f"cf_conv3x3 at the step's shapes: max abs err "
                             f"{err} > {TOL_CONV}")

    def per_map(make):
        calls = [(D, make(x, w, b, pk, mode)) for D, x, w, b, pk, mode in items]

        def run():
            for D, fn in calls:
                for _ in range(D):
                    fn()
        return device_ms(run, 1)

    k5 = {
        "ms": per_map(lambda x, w, b, pk, m: lambda: cf_conv3x3(
            x, w, b, mode=m, relu=False, packed=pk)),
        "plain_ms": per_map(lambda x, w, b, pk, m: lambda: cf_conv3x3_plain(
            x, w, b, mode=m, relu=False)),
        "library_ms": per_map(lambda x, w, b, pk, m: cudnn_conv(x, w, b, m)),
        "bound_ms": sum(b_by.values()), "bound_by": max(b_by, key=b_by.get),
        "max_abs_err": max([err] + [r["max_abs_err"] for r in records
                                    if r["name"] == "cf_conv3x3"]),
    }
    if k5["ms"] < k5["bound_ms"]:
        raise AssertionError(f"cf_conv3x3 per map: {k5['ms']} ms is below its "
                             f"{k5['bound_ms']} ms bound")
    log(f"[kernel] cf_conv3x3 per {what} ({len(items) // len(NDEPTHS)} convs x "
        f"{sum(NDEPTHS)} steps, {len(items)} shapes, max abs err {err:.3e}): "
        f"device ms kernel {k5['ms']:.4f} plain {k5['plain_ms']:.4f} library "
        f"{k5['library_ms']:.4f} bound {k5['bound_ms']:.4f} (fp32 CUDA cores: "
        f"{old_bound:.4f}) ({k5['bound_by']}, "
        f"{k5['bound_ms'] / k5['ms']:.1%} of it reached)")
    del items
    return k5


def phase_kernels_msrednet(dev, cam0, poses0, camF, posesF):
    """Each MSREDNet kernel against its plain version at the main path's
    shapes (+ 1856x2752 stage 3 for K2v and K4): K2v per stage, K5 in each
    mode at shapes the step launches, K4 chained over 3 planes per stage.
    Then K5 per map: every conv shape of a map's steps, each held against
    its plain version once and then launched as often as a map launches it
    (kernel, plain version, library call). Returns (records, K5 per map)."""
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep4
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3, cf_conv3x3_plain
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4, red_step4_plain
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_var, sweep_var_plain
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    g = torch.Generator(device=dev).manual_seed(1)
    records = []
    V1 = VIEWS - 1

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def compare(*args, **kw):
        compare_kernel(records, *args, **kw)

    def var_case(cam, poses, stage, H, W, C, per_map, iters, tag):
        rel = stage_rel(cam, poses, stage, dev)
        ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
        d = stage_planes(cam, poses, stage, H, W, dev)
        compare("sweep_var", tag + f" V{V1} K{CHUNK}",
                lambda: sweep_var(ref, srcs, rel, d),
                lambda: sweep_var_plain(ref, srcs, rel, d),
                TOL_VAR, sweep_var_work(V1, CHUNK, H, W, C), per_map, iters)
        if stage != 1:
            sweep_breakdown(lambda: sweep_var(ref, srcs, rel, d), "sweep_var",
                            f"sweep_var {tag} V{V1} K{CHUNK}")

    def red4_case(C, H, W, per_map, iters, tag):
        mod = init_random_weights(RedStep4(C), seed=C).to(dev)
        params = dict(mod.named_parameters())
        packed = mod._packed.get(mod)
        costs = [rnd(C, H, W) for _ in range(3)]
        s0 = [rnd(c, H >> l, W >> l, scale=0.5)
              for l, c in enumerate((8, 16, 32, 64))]
        n_w = sum(p.numel() for p in params.values())

        def chain(step):
            states = s0
            for cost in costs:
                score, *states = step(cost, *states)
            return (score, *states)

        with torch.no_grad():
            compare("red_step4", tag + " 3 planes",
                    lambda: chain(lambda *a: red_step4(params, *a, packed=packed)),
                    lambda: chain(lambda *a: red_step4_plain(params, *a)),
                    TOL_RED4, red_step4_work(C, H, W, n_w), per_map, iters,
                    n_calls=3, conv=True)

    def step_breakdown(C, H, W, tag):
        """Device microseconds of each launch of one step (the last whole
        step of three profiled), labelled by layer in launch order; raises
        unless a step is exactly RED4_LAUNCHES launches."""
        mod = init_random_weights(RedStep4(C), seed=C).to(dev)
        params, packed = dict(mod.named_parameters()), mod._packed.get(mod)
        cost, states = rnd(C, H, W), mod.init_states(H, W, device=dev)

        def step():
            red_step4(params, cost, *states, packed=packed)

        what = f"RedStep4 steps at {tag}"
        with torch.no_grad():
            step()
            torch.cuda.synchronize()
            evs = kernel_events(step, RED4_LAUNCHES, what)
        want = [("conv1", "conv_mma"), ("conv2", "conv_mma"), ("conv3", "conv_mma"),
                ("gates1-4", "conv_mma"), ("reset", "gru_reset"),
                ("cand1-4", "conv_mma"), ("update", "gru_update"),
                ("upconv3", "conv_mma"), ("upconv2", "conv_mma"),
                ("upconv1", "conv_mma"), ("score", "conv_mma")]
        evs = one_call(evs, [k for _, k in want], what)
        us = [[lab, round(e.time_range.elapsed_us(), 1)] for (lab, _), e in zip(want, evs)]
        log(f"[profile:red_step4] {tag}: one step, {len(evs)} launches, "
            f"{sum(u for _, u in us):.1f} us of device time: " + json.dumps(us))

    for stage, (C, D) in enumerate(zip(MSRED_CHANNELS, NDEPTHS)):
        s = 2 ** (2 - stage)
        H, W = H0 // s, W0 // s
        tag = f"stage{stage + 1} {H}x{W} C{C}"
        var_case(cam0, poses0, stage, H, W, C, D // CHUNK, 50, tag)
        red4_case(C, H, W, D, 20, tag)
        step_breakdown(C, H, W, tag)
    # K5 in each mode at shapes the stage-3 step launches (8 per map each),
    # and gru4's gates at stage 1 (48 per map), where the warps split K
    for name, ci, co, H, W, mode, n in (
            ("gates1 16->16", 16, 16, H0, W0, "same", NDEPTHS[2]),
            ("conv1 8->16", 8, 16, H0, W0, "down", NDEPTHS[2]),
            ("upconv1 16->8", 16, 8, H0 // 2, W0 // 2, "up", NDEPTHS[2]),
            ("gates4 128->128", 128, 128, H0 // 8, W0 // 8, "same", NDEPTHS[2]),
            ("gates4 128->128", 128, 128, H0 // 32, W0 // 32, "same", NDEPTHS[0])):
        x, w, b, pk = conv_operands(rnd, ci, co, H, W, mode)
        compare("cf_conv3x3", f"{mode} {name} from {H}x{W}",
                lambda: cf_conv3x3(x, w, b, mode=mode, relu=False, packed=pk),
                lambda: cf_conv3x3_plain(x, w, b, mode=mode, relu=False),
                TOL_CONV, conv_work(ci, co, H, W, mode), n, 50,
                library_fn=cudnn_conv(x, w, b, mode), conv=True)
    # production frame (1856x2752): K2v at each stage, K4 at stage 3
    for stage in (0, 1):
        H, W, C = FULL_H >> (2 - stage), FULL_W >> (2 - stage), MSRED_CHANNELS[stage]
        var_case(camF, posesF, stage, H, W, C, 0, 5,
                 f"full-res stage{stage + 1} {H}x{W} C{C}")
    tag = f"full-res stage3 {FULL_H}x{FULL_W} C8"
    var_case(camF, posesF, 2, FULL_H, FULL_W, 8, 1, 5, tag)
    red4_case(8, FULL_H, FULL_W, NDEPTHS[2], 2, tag)
    torch.cuda.empty_cache()

    k5 = k5_per_map(rnd, MSRED_CHANNELS, records, f"MSREDNet {H0}x{W0} map")
    torch.cuda.empty_cache()
    return records, k5


def phase_kernels_bf16(dev, cam0, poses0):
    """Each kernel's bfloat16 mode against its plain bfloat16 version at
    every stage shape of the 384x512 point (tolerances TOL_BF16_ULPS_*):
    K1 at stage 1, K2 and K2v per stage (a chunk), K3 by both entries (one
    step; the fold over 3 chained planes) with its 8 convs in cuDNN
    bfloat16 as the yardstick, K4 over 3 chained planes, and K5 per
    MSREDNet map (every conv shape of the step, each checked once, then
    launched as often as a map launches it, beside one cuDNN bfloat16 call
    each). Bounds: 2-byte features, states and outputs at the memory rate;
    the products at the tensor cores' bfloat16 rate (the sweeps'
    arithmetic, float32 in both modes, at the CUDA cores'). Returns
    (records, K5 per map, K3's conv yardstick per AdaMVS map)."""
    from deep3d_aerial_tpu_torch.models.cascade import OnlineSoftmaxState
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
    from deep3d_aerial_tpu_torch.ops.cf_conv import (
        cf_conv3x3,
        cf_conv3x3_plain,
        pack_weight,
    )
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2, red_step2_plain
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4, red_step4_plain
    from deep3d_aerial_tpu_torch.ops.sweep import (
        sweep_corr,
        sweep_corr_plain,
        sweep_cost,
        sweep_cost_plain,
        sweep_var,
        sweep_var_plain,
    )
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    records = []
    V1 = VIEWS - 1

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def compare(*args, **kw):
        compare_kernel(records, *args, **kw)

    def conv_operands(ci, co, H, W, mode):
        x = rnd(ci, H, W)
        w = rnd(*((ci, co, 3, 3) if mode == "up" else (co, ci, 3, 3)),
                scale=(9 * ci) ** -0.5, dtype=torch.float32)
        b = rnd(co, scale=0.1, dtype=torch.float32)
        return x, w, b, pack_weight(w, mode, bf)

    def cudnn_bf16(x, w, b, mode):
        return cudnn_conv(x, w.to(bf), b.to(bf), mode)

    yard = 0.0
    with torch.no_grad():
        for stage, (C, D) in enumerate(zip(CHANNELS, NDEPTHS)):
            H, W = H0 >> (2 - stage), W0 >> (2 - stage)
            tag = f"bf16 stage{stage + 1} {H}x{W} C{C}"
            rel = stage_rel(cam0, poses0, stage, dev)
            ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
            d = stage_planes(cam0, poses0, stage, H, W, dev)
            if stage == 0:
                dpair = stage_planes(cam0, poses0, 0, H, W, dev, n=NDEPTHS[0])
                compare("sweep_corr:bf16", tag + f" V{V1} D{NDEPTHS[0]}",
                        lambda: sweep_corr(ref, srcs, rel, dpair),
                        lambda: sweep_corr_plain(ref, srcs, rel, dpair), 0.0,
                        sweep_corr_work(V1, NDEPTHS[0], H, W, C, fb=2), 1, 10,
                        ulps=TOL_BF16_ULPS_SWEEP)
                del dpair
            wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
            compare("sweep_cost:bf16", tag + f" V{V1} K{CHUNK}",
                    lambda: sweep_cost(ref, srcs, rel, d, wts),
                    lambda: sweep_cost_plain(ref, srcs, rel, d, wts), 0.0,
                    sweep_cost_work(V1, CHUNK, H, W, C, fb=2), D // CHUNK, 10,
                    ulps=TOL_BF16_ULPS_SWEEP)
            compare("sweep_var:bf16", tag + f" V{V1} K{CHUNK}",
                    lambda: sweep_var(ref, srcs, rel, d),
                    lambda: sweep_var_plain(ref, srcs, rel, d), 0.0,
                    sweep_var_work(V1, CHUNK, H, W, C, fb=2), D // CHUNK, 10,
                    ulps=TOL_BF16_ULPS_SWEEP)

            # K3: one step by the score entry, then the fold over 3 planes
            up = stage < 2
            mod = init_random_weights(RedStep2(C, up=up), seed=stage).to(dev)
            params = dict(mod.named_parameters())
            packed = mod._packed_params(bf)
            n_w = sum(p.numel() for p in params.values())
            cost, s1 = rnd(C, H, W), rnd(8, H, W, scale=0.5)
            s2 = rnd(16, (H + 1) // 2, (W + 1) // 2, scale=0.5)
            shape = (2 * H, 2 * W) if up else (H, W)
            costs = [rnd(C, H, W) for _ in range(3)]
            dvs = [dd + torch.rand(shape, generator=g, device=dev) for dd in (95.0, 100.0, 105.0)]
            dscale = max(float(dv.max()) for dv in dvs)

            def planes(fold, osm, params=params, packed=packed, costs=costs, dvs=dvs,
                       s1=s1, s2=s2, up=up):
                a, b = s1, s2
                for c, dv in zip(costs, dvs):
                    if fold:
                        _, a, b = red_step2(params, c, a, b, up=up, packed=packed,
                                            osm=osm, dv=dv)
                    else:
                        sc, a, b = red_step2_plain(params, c, a, b, up=up)
                        osm = OnlineSoftmaxState.update(osm, sc, dv)
                return osm, a, b

            def checked(fold, planes=planes, shape=shape, dscale=dscale):
                (m, s_, acc, pmax), a, b = planes(
                    fold, OnlineSoftmaxState.init(shape, device=dev))
                return m, s_, acc / dscale, pmax, a, b

            osm_t = OnlineSoftmaxState.init(shape, device=dev)
            # the score entry checked only (the main path takes the fold)
            got = red_step2(params, cost, s1, s2, up=up, packed=packed)
            n_ulps = bf16_ulps(got, red_step2_plain(params, cost, s1, s2, up=up))
            log(f"[kernel:bf16] red_step2 {tag} score entry: {n_ulps:.2f} bf16 ulps of "
                f"the largest output (tol {TOL_BF16_ULPS_RED})")
            if not (n_ulps <= TOL_BF16_ULPS_RED and all(bool(torch.isfinite(t).all())
                                                        for t in got)):
                raise AssertionError(f"red_step2:bf16 {tag} score entry: {n_ulps} ulps")
            compare("red_step2:bf16", tag + (" up" if up else "") + " softmax fold",
                    lambda: checked(True), lambda: checked(False), 0.0,
                    red_step2_work(C, H, W, up, n_w, fold=True, eb=2), D, 10,
                    n_calls=3, conv=True, ulps=TOL_BF16_ULPS_RED,
                    time_fns=(lambda: planes(True, osm_t), lambda: planes(False, osm_t)))
            convs = []
            for _, ci, co, h, w, mode in red_step2_convs(C, H, W, up):
                x, wt, b, _ = conv_operands(ci, co, h, w, mode)
                convs.append(cudnn_bf16(x, wt, b, mode))

            def run_convs(convs=convs):
                for f in convs:
                    f()
            yard_s = device_ms(run_convs, 10)
            yard += D * yard_s
            log(f"[kernel:bf16] red_step2 {tag}: yardstick of the convs alone (8 cuDNN "
                f"bfloat16 calls) {yard_s:.4f} device ms a step")

            # K4 over 3 chained planes (MSREDNet's stage shapes)
            mod4 = init_random_weights(RedStep4(C), seed=C).to(dev)
            params4 = dict(mod4.named_parameters())
            packed4 = mod4._packed.get(mod4, bf)
            costs4 = [rnd(C, H, W) for _ in range(3)]
            s0 = [rnd(c, H >> l, W >> l, scale=0.5) for l, c in enumerate((8, 16, 32, 64))]
            n_w4 = sum(p.numel() for p in params4.values())

            def chain(step, costs4=costs4, s0=s0):
                states = s0
                for c in costs4:
                    score, *states = step(c, *states)
                return (score, *states)

            compare("red_step4:bf16", tag + " 3 planes",
                    lambda: chain(lambda *a: red_step4(params4, *a, packed=packed4)),
                    lambda: chain(lambda *a: red_step4_plain(params4, *a)), 0.0,
                    red_step4_work(C, H, W, n_w4, eb=2), D, 5, n_calls=3, conv=True,
                    ulps=TOL_BF16_ULPS_RED)
        del ref, srcs

        # K5 per map: the 15 convs of each stage's step, D_stage times each
        items, err, worst, b_by = [], 0.0, 0.0, {}
        for stage, (C, D) in enumerate(zip(MSRED_CHANNELS, NDEPTHS)):
            H, W = H0 >> (2 - stage), W0 >> (2 - stage)
            for _, ci, co, h, w, mode in red_step4_convs(C, H, W):
                x, wt, b, pk = conv_operands(ci, co, h, w, mode)
                k = cf_conv3x3(x, wt, b, mode=mode, relu=False, packed=pk)
                p = cf_conv3x3_plain(x, wt, b, mode=mode, relu=False)
                err = max(err, float((k.float() - p.float()).abs().max()))
                worst = max(worst, bf16_ulps((k,), (p,)))
                bms, by = bound_ms(*conv_work(ci, co, h, w, mode, eb=2), PEAK_BF16)
                b_by[by] = b_by.get(by, 0.0) + bms * D
                items.append((D, x, wt, b, pk, mode))
        if not worst <= TOL_BF16_ULPS_CONV:
            raise AssertionError(f"cf_conv3x3:bf16 at the step's shapes: {worst} bf16 "
                                 f"ulps > {TOL_BF16_ULPS_CONV}")

        def per_map(make):
            calls = [(D, make(x, w, b, pk, mode)) for D, x, w, b, pk, mode in items]

            def run():
                for D, fn in calls:
                    for _ in range(D):
                        fn()
            return device_ms(run, 1)

        k5 = {
            "ms": per_map(lambda x, w, b, pk, m: lambda: cf_conv3x3(
                x, w, b, mode=m, relu=False, packed=pk)),
            "plain_ms": per_map(lambda x, w, b, pk, m: lambda: cf_conv3x3_plain(
                x, w, b, mode=m, relu=False)),
            "library_ms": per_map(lambda x, w, b, pk, m: cudnn_bf16(x, w, b, m)),
            "bound_ms": sum(b_by.values()), "bound_by": max(b_by, key=b_by.get),
            "max_abs_err": err, "ulps": worst,
        }
        if k5["ms"] < k5["bound_ms"]:
            raise AssertionError(f"cf_conv3x3:bf16 per map: {k5['ms']} ms is below "
                                 f"its {k5['bound_ms']} ms bound")
        log(f"[kernel:bf16] cf_conv3x3 per MSREDNet 384x512 map ({len(items)} shapes, max "
            f"abs err {err:.3e}, {worst:.2f} bf16 ulps, tol {TOL_BF16_ULPS_CONV}): device ms "
            f"kernel {k5['ms']:.4f} plain {k5['plain_ms']:.4f} library (cuDNN bfloat16) "
            f"{k5['library_ms']:.4f} bound {k5['bound_ms']:.4f} ({k5['bound_by']}, "
            f"{k5['bound_ms'] / k5['ms']:.1%} of it reached)")
        del items
    torch.cuda.empty_cache()
    log(f"[kernel:bf16] red_step2 per AdaMVS {H0}x{W0} map: yardstick of the convs alone "
        f"(8 cuDNN bfloat16 calls a step x {sum(NDEPTHS)} steps) {yard:.4f} device ms")
    return records, k5, yard


class _PerPlane:
    """A regularizer whose step is the module's whole forward, so every
    plane gathers its parameters and checks its packed-weight cache again."""

    def __init__(self, module):
        self.module = module

    def init_states(self, *args, **kw):
        return self.module.init_states(*args, **kw)

    def plane_step(self, device, dtype=torch.float32):
        return self.module


def phase_host_per_plane(dev, cam0, poses0):
    """Host time to issue one RedStep4 plane on the kernel path at stage
    1's shape (96x128, Cin 32, where the main path waits most on the
    host): the module's forward per plane (parameters gathered, packed-
    weight cache checked, every plane) against the step gathered once
    (`plane_step`, as streaming_sweep takes it). Each reading is the median
    host clock over 16 planes issued back to back after a synchronize (304
    launches, inside the launch queue, so the clock reads the issue, not
    the device); then stage 1's whole 48-plane sweep, wall ms with a
    synchronize, each way. Rounds alternate the two ways."""
    from deep3d_aerial_tpu_torch.models.cascade import streaming_sweep
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep4
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    C, H, W, D = MSRED_CHANNELS[0], H0 // 4, W0 // 4, NDEPTHS[0]
    g = torch.Generator(device=dev).manual_seed(3)
    mod = init_random_weights(RedStep4(C), seed=C).to(dev)
    cost = torch.randn((C, H, W), generator=g, device=dev)
    states = mod.init_states(H, W, device=dev)
    rel = stage_rel(cam0, poses0, 0, dev)
    ref = torch.randn((H, W, C), generator=g, device=dev)
    srcs = torch.randn((VIEWS - 1, H, W, C), generator=g, device=dev)
    depths = torch.linspace(90.0, 110.0, D, device=dev)   # the survey's ~100 m

    def issue_ms(step):
        torch.cuda.synchronize()
        took = []
        for _ in range(16):
            t0 = time.perf_counter()
            step(cost, *states)
            took.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(took)) * 1e3

    def sweep_ms(reg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streaming_sweep(reg, False, depths, ref, srcs, rel, None,
                        plane_chunk=CHUNK, cost_mode="variance")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def host_us(fn):
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        return (time.perf_counter() - t0) / 200 * 1e6

    res = {k: [] for k in ("issue module", "issue step", "sweep module", "sweep step")}
    with torch.no_grad():
        issue_ms(mod), sweep_ms(mod), sweep_ms(_PerPlane(mod))   # warm
        for _ in range(3):
            res["issue module"].append(issue_ms(mod))
            res["issue step"].append(issue_ms(mod.plane_step(dev)))
            res["sweep module"].append(sweep_ms(_PerPlane(mod)))
            res["sweep step"].append(sweep_ms(mod))
    med = {k: float(np.median(v)) for k, v in res.items()}
    log(f"[host:red_step4] {H}x{W} Cin{C}, host ms to issue one plane (median "
        f"of 16, per round): module per plane {res['issue module']}, step "
        f"gathered once {res['issue step']}; the per-plane gathering alone: "
        f"dict(named_parameters()) {host_us(lambda: dict(mod.named_parameters())):.1f} us, "
        f"packed-cache check {host_us(lambda: mod._packed.get(mod)):.1f} us")
    log(f"[host:red_step4] stage-1 sweep ({D} planes) wall ms per round: module "
        f"per plane {res['sweep module']}, step gathered once {res['sweep step']}; "
        f"medians {med['sweep module']:.3f} -> {med['sweep step']:.3f} ms, issue "
        f"{med['issue module']:.4f} -> {med['issue step']:.4f} ms a plane")
    return med


class _Unfused:
    """RedStep2 whose step returns the score (K3's score-writing entry), so
    the sweep runs OnlineSoftmaxState.update eagerly after each plane, as
    before the fold."""

    def __init__(self, module):
        self.module = module

    def init_states(self, *args, **kw):
        return self.module.init_states(*args, **kw)

    def plane_step(self, device, dtype=torch.float32):
        step = self.module.plane_step(device, dtype)
        return lambda *a: step(*a)


def phase_host_red_step2(dev, cam0, poses0):
    """Stage 1's 48-plane AdaMVS sweep (96x128, Cin 32, scores at 192x256,
    where the main path waits most on the host), wall ms with a synchronize:
    K3 with the softmax fold (the main path) against K3's score entry plus
    the eager OnlineSoftmaxState.update (12 PyTorch ops a plane), in
    alternating rounds; the two sweeps' depth and confidence must agree."""
    from deep3d_aerial_tpu_torch.models.cascade import streaming_sweep
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    C, H, W, D = CHANNELS[0], H0 // 4, W0 // 4, NDEPTHS[0]
    g = torch.Generator(device=dev).manual_seed(4)
    mod = init_random_weights(RedStep2(C, up=True), seed=0).to(dev)
    rel = stage_rel(cam0, poses0, 0, dev)
    ref = torch.randn((H, W, C), generator=g, device=dev)
    srcs = torch.randn((VIEWS - 1, H, W, C), generator=g, device=dev)
    wts = torch.rand((VIEWS - 1, H, W), generator=g, device=dev) * 0.9 + 0.1
    depths = torch.linspace(90.0, 110.0, D, device=dev)   # the survey's ~100 m

    def sweep_ms(reg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = streaming_sweep(reg, True, depths, ref, srcs, rel, wts, plane_chunk=CHUNK)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    res = {"fold": [], "eager": []}
    with torch.no_grad():
        _, (df, cf) = sweep_ms(mod)
        _, (de, ce) = sweep_ms(_Unfused(mod))
        dd, dc = float((df - de).abs().max()), float((cf - ce).abs().max())
        if not (dd <= TOL_DEPTH_FRAC * 20.0 and dc <= TOL_CONF):
            raise AssertionError(f"stage-1 sweep, fold vs eager update: depth {dd}, conf {dc}")
        for i in range(6):
            for way in (("fold", "eager") if i % 2 == 0 else ("eager", "fold")):
                reg = mod if way == "fold" else _Unfused(mod)
                res[way].append(round(sweep_ms(reg)[0], 3))
    med = {k: float(np.median(v)) for k, v in res.items()}
    log(f"[host:red_step2] stage-1 sweep ({D} planes, {H}x{W} Cin{C}, up) wall ms per "
        f"round: softmax fold {res['fold']}, K3 + eager update {res['eager']}; medians "
        f"{med['eager']:.3f} -> {med['fold']:.3f} ms ({med['eager'] / med['fold']:.2f}x); "
        f"fold vs eager depth {dd:.2e} m, confidence {dc:.2e}")
    return med


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


def phase_main_path(dev, cam0, poses0, counters, per_map, model_type="adamvs",
                    eager_updates=0, colmap=False, after=None,
                    compute_dtype="float32", mesh=True, warp_precision="float32"):
    """AerialPipeline(...).run_dense() on a synthetic workspace: dense
    matching, fusion with the .mvs handoff, and the default mesh and DSM
    stages at 384x512, the model's default configuration (the graph cut's
    input capped, `cap_graphcut_input`), seeded random weights; the mesh
    and DSM products are checked by `check_mesh_dsm`, and `after(pipe, ws)`
    runs before the workspace goes. `per_map`: the exact launches of each
    counter per map;
    `eager_updates`: the OnlineSoftmaxState.update calls per map (0 where
    the regularizer's step folds the softmax). With `colmap` the workspace
    holds a COLMAP model and the images only, and the run starts with the
    default view selection (image paths from `data_folder`); every
    selected reference view must get a depth map. `compute_dtype` is the
    config's (`[main:bf16:<model>]` for bfloat16), and so is
    `warp_precision` (`[main:compensated*]`: every sweep launch must be a
    compensated one, and none in a float32 run); without `mesh` the run
    stops after fusion (no mesh, no DSM). Returns (launches, median
    seconds per map, median ms between the forward's marks by label)."""
    from deep3d_aerial_tpu_torch.io import text_formats as tf
    from deep3d_aerial_tpu_torch.io.pfm import read_pfm
    from deep3d_aerial_tpu_torch.models import cascade
    from deep3d_aerial_tpu_torch.io.ply import read_ply
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp) / "ws"
        if colmap:
            n_points = write_colmap_workspace(ws, cam0, poses0, dev)
        else:
            write_workspace(ws, cam0, poses0, dev)
        cfg = PipelineConfig(
            image_w=W0, image_h=H0, image_scale=1.0, view_num=VIEWS,
            allow_random_weights=True, run_view_selection=colmap,
            fusion_num=4, geo_consist_num=2, photomatric_threshold=0.0,
            position_threshold=2.0, depth_threshold=0.05,
            normal_threshold=180.0, model_type=model_type,
            compute_dtype=compute_dtype, run_create_mesh=mesh, run_create_dsm=mesh,
            warp_precision=warp_precision,
        )
        pipe = AerialPipeline(str(ws), cfg, device=dev,
                              data_folder=str(ws / "images") if colmap else None)
        model = _Marked(pipe.build_model())
        cap_graphcut_input(pipe)
        update = cascade.OnlineSoftmaxState.update
        updates = [0]

        def counted(*args):
            updates[0] += 1
            return update(*args)

        cascade.OnlineSoftmaxState.update = staticmethod(counted)
        try:
            sweeps = [c for c in counters if hasattr(c, "launches_compensated")]
            for c in counters:
                c.launches = c.launches_bf16 = 0
            for c in sweeps:
                c.launches_compensated = 0
            t0 = time.perf_counter()
            with GraphCutCount() as graphcut:
                pipe.run_dense(model=model)
                torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
            launches_bf16 = {c.__name__: c.launches_bf16 for c in counters}
            launches_comp = {c.__name__: c.launches_compensated for c in sweeps}
        finally:
            cascade.OnlineSoftmaxState.update = staticmethod(update)
        # every launch of a bfloat16 run went to a kernel's bfloat16 entry,
        # and none of a float32 run did; likewise every sweep launch of a
        # compensated run to a compensated entry
        want_bf16 = launches if compute_dtype == "bfloat16" else dict.fromkeys(launches, 0)
        if launches_bf16 != want_bf16:
            raise AssertionError(f"[main:{model_type}] {compute_dtype}: bfloat16-entry "
                                 f"launches {launches_bf16}, want {want_bf16}")
        want_comp = {k: launches[k] if warp_precision == "compensated" else 0
                     for k in launches_comp}
        if launches_comp != want_comp:
            raise AssertionError(f"[main:{model_type}] {warp_precision}: compensated "
                                 f"launches {launches_comp}, want {want_comp}")

        maps = sorted((ws / "dense" / "MVS").glob("*_init.pfm"))
        n = len(maps)
        want = [f"im_{i:02d}" for i in range(1, len(poses0) + 1)]
        if colmap:
            for f in ("viewpair.txt", "blocks.txt", "scene_border.txt",
                      "image_path.txt", "cameras.txt", "images.txt"):
                if not (ws / "export" / f).is_file():
                    raise AssertionError(f"view selection wrote no export/{f}")
            refs = [r for r, _ in tf.read_view_pairs(ws / "export" / "viewpair.txt")]
            want = [f"im_{r:02d}" for r in sorted(refs)]
            log(f"[main:{model_type}] view selection from a COLMAP model of "
                f"{len(poses0)} images and {n_points} points: {len(refs)} "
                f"reference views, "
                f"{len(tf.read_blocks(ws / 'export' / 'blocks.txt'))} block(s)")
        got = [p.name[:-len("_init.pfm")] for p in maps]
        if got != want:
            raise AssertionError(f"depth maps {got}, expected one per reference "
                                 f"view {want}")
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
        if mesh:
            stats = check_mesh_dsm(ws, cfg, graphcut)
            log_mesh_dsm(model_type, stats, pipe.stage_seconds, cfg.recons_decimate_ratio)
        if after is not None:
            after(pipe, ws)

    tag = "main" if model_type == "adamvs" else f"main:{model_type}"
    if compute_dtype != "float32":
        tag = f"main:bf16:{model_type}"
    if warp_precision != "float32":
        tag = ("main:compensated" if (model_type, compute_dtype) == ("adamvs", "float32")
               else "main:compensated:" + tag[len("main:"):])
    for name, k in per_map.items():
        if launches[name] != k * n:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"main path, expected {k} x {n} maps")
    if updates[0] != eager_updates * n:
        raise AssertionError(f"{updates[0]} eager online-softmax updates on the "
                             f"main path, expected {eager_updates} x {n} maps")
    stage_ms = {}
    for marks in model.events[1:]:  # the first map warms up
        for (_, a), (label, b) in zip(marks, marks[1:]):
            stage_ms.setdefault(label, []).append(a.elapsed_time(b))
    secs = pipe.map_seconds
    steady = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    log(f"[{tag}] {n} maps at {H0}x{W0}, {VIEWS} views, ndepths {model.model.ndepths}: "
        f"run_dense {total:.2f} s ({'mesh and DSM included' if mesh else 'to fusion'}); "
        f"per map first {secs[0]:.3f} s, "
        f"median after {steady * 1e3:.2f} ms = {1.0 / steady:.2f} maps/s; "
        f"fused points {points}")
    log(f"[{tag}] launches " + json.dumps(launches) + " per map "
        + json.dumps(per_map) + "; of them at a bfloat16 entry "
        + json.dumps(launches_bf16) + "; at a compensated entry "
        + json.dumps(launches_comp) + f"; eager online-softmax updates {updates[0]} "
        f"({eager_updates} per map)")
    med = {k: float(np.median(v)) for k, v in stage_ms.items()}
    log(f"[{tag}] per-stage ms between CUDA events, idle gaps included "
        "(median over maps 2..n): " + json.dumps(
        {k: round(v, 4) for k, v in med.items()}))
    if any(k.endswith(".cost_reg") for k in med):
        total = sum(med.values())
        reg = sum(v for k, v in med.items() if k.endswith(".cost_reg"))
        vol = sum(v for k, v in med.items() if k.endswith(".volume"))
        log(f"[{tag}] of {total:.3f} ms between a forward's marks: CostRegNet3D "
            f"{reg:.3f} ms ({reg / total:.3f}), K2v volumes {vol:.3f} ms "
            f"({vol / total:.3f})")
    return launches, steady, med


# ---------------------------------------------------------------------------
# the mesh and DSM stages: what the main path writes, and the refine
# ---------------------------------------------------------------------------


class GraphCutCount:
    """While installed, counts the mesh stage's calls into the native graph
    cut (`utils.native.reconstruct_mesh_native`), the points they pass and
    the surfaces (faces) they get back."""

    def __enter__(self):
        from deep3d_aerial_tpu_torch.utils import native

        self.calls = self.surfaces = self.points = self.faces = 0
        self._native, self._fn = native, native.reconstruct_mesh_native

        def counted(points, *args, **kw):
            self.calls += 1
            self.points += len(points)
            tris = self._fn(points, *args, **kw)
            if tris is not None:
                self.surfaces += 1
                self.faces += len(tris)
            return tris

        native.reconstruct_mesh_native = counted
        return self

    def __exit__(self, *exc):
        self._native.reconstruct_mesh_native = self._fn


def cap_graphcut_input(pipe):
    """Before the pipeline's mesh stage, set its recons_decimate_ratio so
    that the largest fused block gives the graph cut about GRAPHCUT_POINTS
    points (see there)."""
    from deep3d_aerial_tpu_torch.io.ply import read_ply

    stage = pipe.create_mesh

    def create_mesh():
        n = max([read_ply(p)[0].shape[0]
                 for p in Path(pipe.fusion_path).glob("scene_*.ply")] or [1])
        pipe.cfg.recons_decimate_ratio = min(1.0, GRAPHCUT_POINTS / max(n, 1))
        return stage()

    pipe.create_mesh = create_mesh


def check_mesh_dsm(ws: Path, cfg, graphcut) -> dict:
    """What the default mesh and DSM stages must leave in workspace `ws`
    (raises otherwise): a `.mvs` scene beside each fused block, read back
    with one vertex per fused point; for each block of at least 4 points
    `_mesh.ply`, `_mesh_refine.ply` and the atlas-textured
    `_mesh_refine_texture.ply` + `.png`, with faces and every index in
    range; the graph cut called once, with a surface back, for each block
    of at least 16 points; production/DSM/dsm.tif of the shape its border
    and `dsm_uint` give, with valid cells, whose heights lie in the z-range
    of the mesh vertices (a max over triangles of heights interpolated
    between their corners cannot leave it) and that range within the fused
    points' z-range widened by a tenth of it on each side (the Taubin
    smoothing of the clean and refine steps, lambda 0.5 / mu -0.53 over 11
    passes, is no convex average: its negative step can carry a vertex
    past its neighbours);
    production/Mesh and production/DSM holding the .ply/.tif/.tfw files of
    mesh/ and dsm/. Returns the sizes it saw."""
    from PIL import Image

    from deep3d_aerial_tpu_torch.io import text_formats as tf
    from deep3d_aerial_tpu_torch.io.geotiff import read_geotiff
    from deep3d_aerial_tpu_torch.io.mvs_interface import read_mvs
    from deep3d_aerial_tpu_torch.io.ply import read_ply
    from deep3d_aerial_tpu_torch.mesh.atlas import read_textured_mesh_ply
    from deep3d_aerial_tpu_torch.mesh.trimesh_io import read_mesh_ply

    def faces_ok(name, v, f):
        if len(f) == 0 or f.min() < 0 or f.max() >= len(v) or not np.isfinite(v).all():
            raise AssertionError(f"{name}: {len(v)} vertices, {len(f)} faces, "
                                 f"indices {f.min() if len(f) else None}.."
                                 f"{f.max() if len(f) else None}")

    mesh = ws / "mesh"
    plys = sorted((ws / "dense" / "fusion").glob("scene_*.ply"))
    if not plys:
        raise AssertionError("fusion wrote no PLY")
    z, points, faces, cut_blocks, atlas = [], 0, 0, 0, []
    for ply in plys:
        pts = read_ply(ply)[0]
        points += len(pts)
        z.append(pts[:, 2])
        mvs = ply.with_suffix(".mvs")
        if not mvs.is_file():
            raise AssertionError(f"no {mvs.name} beside {ply.name}")
        n_mvs = read_mvs(mvs).vertices.shape[0]
        if n_mvs != len(pts):
            raise AssertionError(f"{mvs.name}: {n_mvs} vertices, {ply.name} "
                                 f"{len(pts)} points")
        if len(pts) < 4:
            continue
        cut_blocks += len(pts) >= 16
        for suffix in ("_mesh", "_mesh_refine"):
            name = f"{ply.stem}{suffix}.ply"
            faces_ok(name, *read_mesh_ply(mesh / name))
        name = f"{ply.stem}_mesh_refine_texture.ply"
        v, f, uv, png = read_textured_mesh_ply(mesh / name)
        faces_ok(name, v, f)
        if png != f"{ply.stem}_mesh_refine_texture.png" or not (mesh / png).is_file():
            raise AssertionError(f"{name}: texture {png!r} missing")
        if not (np.isfinite(uv).all() and uv.min() >= 0 and uv.max() <= 1):
            raise AssertionError(f"{name}: uv outside [0, 1]")
        atlas.append(Image.open(mesh / png).size)
        faces += len(f)
    if not cut_blocks or graphcut.calls != cut_blocks or graphcut.surfaces != cut_blocks:
        raise AssertionError(
            f"graph cut: {graphcut.calls} calls, {graphcut.surfaces} surfaces "
            f"for {cut_blocks} blocks of >= 16 points: the mesh stage did not "
            "take the graph-cut path")

    bbx = tf.read_border(ws / "export" / "scene_border.txt")
    dx, dy = cfg.dsm_uint
    shape = (int(np.ceil((bbx[3] - bbx[2]) / dy)), int(np.ceil((bbx[1] - bbx[0]) / dx)))
    grid, origin, cell, nodata = read_geotiff(ws / "production" / "DSM" / "dsm.tif")
    if grid.shape != shape or tuple(cell) != (dx, dy) or tuple(origin) != (bbx[0], bbx[3]):
        raise AssertionError(f"dsm.tif: shape {grid.shape}, cell {cell}, origin "
                             f"{origin}; expected {shape}, {(dx, dy)}, {(bbx[0], bbx[3])}")
    valid = grid != nodata
    z = np.concatenate(z)
    vz = np.concatenate([read_mesh_ply(p)[0][:, 2] for p in mesh.glob("*.ply")])
    margin = 0.1 * (z.max() - z.min())
    if vz.min() < z.min() - margin or vz.max() > z.max() + margin:
        raise AssertionError(f"mesh vertices at heights {vz.min()}..{vz.max()}, "
                             f"fused points {z.min()}..{z.max()}")
    if not valid.any() or grid[valid].min() < vz.min() or grid[valid].max() > vz.max():
        raise AssertionError(
            f"dsm.tif: valid share {valid.mean()}, heights "
            f"{grid[valid].min() if valid.any() else None}.."
            f"{grid[valid].max() if valid.any() else None} outside the mesh "
            f"vertices' {vz.min()}..{vz.max()}")
    for src, dst in (("mesh", "Mesh"), ("dsm", "DSM")):
        want = sorted(p.name for p in (ws / src).iterdir()
                      if p.name.endswith((".ply", ".tif", ".tfw")))
        got = sorted(p.name for p in (ws / "production" / dst).iterdir())
        if not want or got != want:
            raise AssertionError(f"production/{dst}: {got}, expected {want}")
        for n in want:
            if (ws / src / n).read_bytes() != (ws / "production" / dst / n).read_bytes():
                raise AssertionError(f"production/{dst}/{n} differs from {src}/{n}")
    return {"blocks": len(plys), "points": points, "faces": faces, "atlas": atlas,
            "graphcut_points": graphcut.points, "graphcut_faces": graphcut.faces,
            "dsm_shape": grid.shape, "valid": float(valid.mean()),
            "dsm_z": (float(grid[valid].min()), float(grid[valid].max())),
            "points_z": (float(z.min()), float(z.max()))}


def log_mesh_dsm(tag, stats, secs, ratio):
    log(f"[mesh:{tag}] {stats['blocks']} block(s), {stats['points']} fused points; "
        f"graph cut on {stats['graphcut_points']} (recons_decimate_ratio "
        f"{ratio:.5f}) -> {stats['graphcut_faces']} faces; textured mesh "
        f"{stats['faces']} faces, atlas {stats['atlas']}; mesh stage "
        f"{secs['mesh']:.2f} s (host clock; refine, texture and files included)")
    log(f"[dsm:{tag}] {stats['dsm_shape'][0]}x{stats['dsm_shape'][1]} cells, valid "
        f"share {stats['valid']:.4f}, heights {stats['dsm_z'][0]:.3f}.."
        f"{stats['dsm_z'][1]:.3f} m (fused points {stats['points_z'][0]:.3f}.."
        f"{stats['points_z'][1]:.3f}); DSM stage {secs['dsm']:.2f} s; stages "
        + json.dumps({k: round(v, 3) for k, v in secs.items()}))


def refine_case(dev, verts, faces, views, cfg, tag):
    """photometric_refine on the card against the CPU: every step of the
    card's run is taken again on the CPU from the same vertices and must
    agree within TOL_REFINE_EDGE x the mean edge; the whole runs' distance
    is printed (see TOL_REFINE_EDGE). Also the card's ms a step between
    CUDA events over 10 steps, the whole call's host seconds and its peak
    device memory. Returns the card's vertices of the whole call."""
    from deep3d_aerial_tpu_torch.mesh import refine

    verts = np.asarray(verts, np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = refine.photometric_refine(verts, faces, views, cfg, device=dev)
    host_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    want = refine.photometric_refine(verts, faces, views, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0

    card, v, mean_edge = refine.refine_setup(verts, faces, views, cfg, dev)
    host, _, _ = refine.refine_setup(verts, faces, views, cfg, "cpu")
    step_err = 0.0
    for s in range(cfg.scales):
        step = cfg.gradient_step * mean_edge * (0.5 ** s)
        for _ in range(cfg.iterations):
            nxt = refine.refine_update(card, v, step)
            again = refine.refine_update(host, v.cpu(), step)
            step_err = max(step_err, float((nxt.cpu() - again).abs().max()))
            v = nxt
    step = cfg.gradient_step * mean_edge
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        v = refine.refine_update(card, v, step)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 10
    drift = float(np.abs(got - want).max())
    moved = float(np.abs(want - verts).max())
    steps = cfg.scales * cfg.iterations
    log(f"[refine] {tag} {cfg.energy}: {len(verts)} vertices, {len(faces)} faces, "
        f"{len(views)} views, {steps} steps; max |card - cpu| of a step from the "
        f"same vertices {step_err:.3e} m = {step_err / mean_edge:.3e} mean edges "
        f"(tolerance {TOL_REFINE_EDGE}); whole runs {drift / mean_edge:.3e} mean "
        f"edges apart, moved {moved / mean_edge:.3e}; card {ms:.3f} ms a step "
        f"(CUDA events over 10 host-issued steps), whole call {host_s:.3f} s host, "
        f"peak device memory {peak:.3f} GiB; cpu {cpu_s:.3f} s")
    if (not np.isfinite(got).all() or step_err > TOL_REFINE_EDGE * mean_edge
            or moved == 0 or np.abs(got - verts).max() == 0):
        raise AssertionError(f"[refine] {tag} {cfg.energy}: a step card vs cpu "
                             f"{step_err} (mean edge {mean_edge}), moved {moved}")
    return got


def phase_refine_pipeline(dev, pipe, ws):
    """[refine] (a): the AdaMVS main path's `_mesh_refine.ply` with its
    texture views, both energies, card against CPU; then the pipeline's
    mesh stage with `refine_photometric` switched on, on the card, which
    must write `_mesh_refine_photo.ply` (the refined vertices, the same
    faces) and texture it."""
    from deep3d_aerial_tpu_torch.mesh.refine import PhotoRefineConfig
    from deep3d_aerial_tpu_torch.mesh.trimesh_io import read_mesh_ply

    src = sorted((ws / "mesh").glob("scene_*_mesh_refine.ply"))[0]
    verts, faces = read_mesh_ply(src)
    views = [(v.image, v.geom.K, v.geom.T_cw) for v in pipe._texture_views()]
    # the pipeline's default: scales = refine_scale_times, 20 steps each
    scales = max(1, int(pipe.cfg.refine_scale_times))
    for energy in ("zncc", "variance"):
        refine_case(dev, verts, faces, views,
                    PhotoRefineConfig(scales=scales, energy=energy), f"main {src.name}")
    pipe.cfg.refine_photometric = True
    t0 = time.perf_counter()
    pipe.create_mesh()
    took = time.perf_counter() - t0
    photo = src.with_name(src.name.replace("_mesh_refine", "_mesh_refine_photo"))
    v, f = read_mesh_ply(photo)
    moved = float(np.abs(v - verts).max())
    log(f"[refine] pipeline mesh stage with refine_photometric on the card: "
        f"{took:.2f} s; {photo.name} moved {moved:.3e} m")
    if not np.array_equal(f, faces) or not np.isfinite(v).all() or moved == 0:
        raise AssertionError(f"{photo.name}: faces equal {np.array_equal(f, faces)}, "
                             f"finite {np.isfinite(v).all()}, moved {moved}")
    textured = src.with_name(src.name.replace("_mesh_refine", "_mesh_refine_texture"))
    from deep3d_aerial_tpu_torch.mesh.atlas import read_textured_mesh_ply

    tv = read_textured_mesh_ply(textured)[0]
    if not np.array_equal(tv, v):
        raise AssertionError(f"{textured.name} is not the texture of {photo.name}")


def phase_refine_plane(dev):
    """[refine] (b): the 428x428-vertex plane of tests/test_mesh.py (183k
    vertices, 364k faces, 2 views of a 64x64 image), both energies, 5
    steps at one scale (10 at two until PR 11 needed the script's time),
    card against CPU."""
    from deep3d_aerial_tpu_torch.mesh.refine import PhotoRefineConfig

    n_side = 428
    xs, ys = np.meshgrid(np.arange(n_side, dtype=np.float32),
                         np.arange(n_side, dtype=np.float32))
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(n_side * n_side, np.float32)], -1)
    i = (ys[:-1, :-1] * n_side + xs[:-1, :-1]).astype(np.int64).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + n_side], -1),
                            np.stack([i + 1, i + n_side + 1, i + n_side], -1)]).astype(np.int32)
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 500.0
    img = np.random.default_rng(0).uniform(0, 1, (64, 64)).astype(np.float32)
    views = [(img, K, T), (img + 0.01, K, T)]
    for energy in ("zncc", "variance"):
        refine_case(dev, verts, faces, views,
                    PhotoRefineConfig(scales=1, iterations=5, energy=energy), "plane 428x428")


def phase_fullres_pipeline(dev, camF, posesF):
    """[main:fullres] one run_dense of the 1856x2752 survey: AdaMVS, its six
    maps, every default stage (dense matching, fusion with the .mvs
    handoff, mesh, DSM), seeded random weights."""
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp) / "ws"
        t0 = time.perf_counter()
        write_workspace(ws, camF, posesF, dev)
        setup = time.perf_counter() - t0
        cfg = PipelineConfig(
            image_w=FULL_W, image_h=FULL_H, image_scale=1.0, view_num=VIEWS,
            allow_random_weights=True, run_view_selection=False,
            fusion_num=4, geo_consist_num=2, photomatric_threshold=0.0,
            position_threshold=2.0, depth_threshold=0.05, normal_threshold=180.0)
        pipe = AerialPipeline(str(ws), cfg, device=dev)
        cap_graphcut_input(pipe)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with GraphCutCount() as graphcut:
            pipe.run_dense()
            torch.cuda.synchronize()
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_maps = len(list((ws / "dense" / "MVS").glob("*_init.pfm")))
        if n_maps != len(posesF):
            raise AssertionError(f"[main:fullres] {n_maps} depth maps, expected {len(posesF)}")
        stats = check_mesh_dsm(ws, cfg, graphcut)
        # the fusion stage's device work: the same maps fused again (the
        # same files) in one profiler session. No counter knows its launch
        # count, so a record the profiler loses would read low
        from deep3d_aerial_tpu_torch.utils.profiling import device_events

        evs = device_events(pipe.fuse_depth_map, lambda evs: len(evs) > 0)
        busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
        copies = sum(e.time_range.elapsed_us() for e in evs if "Memcpy" in e.name) / 1e3
    log(f"[fusion:fullres] device busy {busy:.2f} ms ({len(kernels_of(evs))} kernels, "
        f"copies {copies:.2f} ms; torch.profiler) of the stage's "
        f"{pipe.stage_seconds['depth fusion']:.2f} s on the host clock")
    log(f"[main:fullres] {n_maps} maps at {FULL_H}x{FULL_W}: run_dense {total:.2f} s "
        f"(workspace written in {setup:.2f} s before), stages "
        + json.dumps({k: round(v, 3) for k, v in pipe.stage_seconds.items()})
        + f"; per map {json.dumps([round(s, 3) for s in pipe.map_seconds])} s; "
        f"fused points {stats['points']}; peak device memory {peak:.2f} GiB")
    log_mesh_dsm("fullres", stats, pipe.stage_seconds, cfg.recons_decimate_ratio)


def same_files(a: Path, b: Path, sub: str, pattern="*"):
    """(names, differing): the files matching `pattern` under a/sub and
    b/sub, which must be the same names; those whose bytes differ."""
    fa = sorted(p.name for p in (a / sub).glob(pattern) if p.is_file())
    fb = sorted(p.name for p in (b / sub).glob(pattern) if p.is_file())
    if fa != fb or not fa:
        raise AssertionError(f"{sub}/{pattern}: {fa} against {fb}")
    return fa, [n for n in fa if (a / sub / n).read_bytes() != (b / sub / n).read_bytes()]


def forward_seconds(model, s, dev, n):
    """Host seconds of n forwards of sample `s`, each through a sync."""
    inputs = (torch.from_numpy(s.imgs).to(dev), torch.from_numpy(s.rel_projs).to(dev),
              s.depth_min, s.depth_max)
    took = []
    with torch.inference_mode():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            took.append(time.perf_counter() - t0)
    return took


# cuDNN's default algorithms for the transposed convolutions (F.conv_transpose2d
# and 3d: the feature nets, AdaMVS's pair hourglass, CostRegNet3D) sum in an
# order that varies from run to run on the card: one forward of any model,
# run three times, gave maps up to 1e-4 m apart, and with the deterministic
# algorithms (for those convolutions alone, or for all) none; the
# deterministic ones cost CasMVSNet and UCSNet ~4.5 ms of ~22 a 384x512
# forward and AdaMVS 34 ms of 251 at 1856x2752 on an H100 80GB HBM3 at
# 700 W (scripts/cudnn_determinism_probe.py), so the pipeline keeps the
# default and [main:pipelined], which holds two runs to the same bytes,
# runs under these


# [main:pipelined]'s survey: PIPELINED_NX columns of PIPELINED_NY views at
# 1856x2752, one scene block a column. PR 11 ran the 3 x 2 survey (6 maps,
# 3 blocks: 281.7 s with [fusion:cli], most of it the two runs' mesh
# stages); 2 x 2 (4 maps, 2 blocks) pays for the multi-card phases
PIPELINED_NX, PIPELINED_NY = 2, 2


def phase_pipelined(dev, counters, per_map):
    """[main:pipelined] the 1856x2752 survey of PIPELINED_NX x PIPELINED_NY
    views in PIPELINED_NX scene blocks, one per column, that share source
    views (fusion_num 2), AdaMVS with seeded
    random weights, every default stage (the graph cut's input capped),
    normals saved; two runs on copies of one workspace: run_dense one map
    at a time, and run_dense_pipelined with infer_batch_size 2, `.dmap` and
    depth previews. The two must write the same bytes: depth, confidence
    and normal maps, the fused PLYs, `.mvs` scenes, meshes and DSM; so the
    cell runs under torch.backends.cudnn.deterministic (see above). Each
    `.dmap` reads back as its PFMs; each preview is at the map's size.
    Then what the GIL costs a forward: forwards timed alone and while a
    thread fuses the maps, and `[fusion:cli]`. Returns the pipelined run's
    kernel launches."""
    # the main path's fusion thresholds, the position threshold (pixels)
    # scaled with the focal length from 384x512: random weights give each
    # map a near-constant depth that misses its neighbours' by up to ~1 m,
    # which moves a reprojection by ~12 px at f = 3727 (by ~2 px at 384x512),
    # and at 2 px two of the three blocks of the 3 x 2 survey fused 0 and 5
    # points
    camF, posesF = survey(FULL_W, FULL_H, nx=PIPELINED_NX, ny=PIPELINED_NY)
    settings = dict(
        image_w=FULL_W, image_h=FULL_H, image_scale=1.0, view_num=VIEWS,
        allow_random_weights=True, run_view_selection=False, save_normals=True,
        fusion_num=2, geo_consist_num=2, photomatric_threshold=0.0,
        position_threshold=2.0 * FULL_W / W0, depth_threshold=0.05,
        normal_threshold=180.0)
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _pipelined_runs(dev, camF, posesF, counters, per_map, settings)
    finally:
        torch.backends.cudnn.deterministic = before


def _pipelined_runs(dev, camF, posesF, counters, per_map, settings):
    import threading

    from deep3d_aerial_tpu_torch.io.dmap import read_dmap
    from deep3d_aerial_tpu_torch.io.pfm import read_pfm
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_workspace(tmp / "src", camF, posesF, dev, columns=PIPELINED_NX)
        runs = {}
        for tag, kw in (("sequential", {}),
                        ("pipelined", {"infer_batch_size": 2, "save_dmap": True,
                                       "display_depth": True})):
            ws = tmp / tag
            shutil.copytree(tmp / "src" / "export", ws / "export")
            pipe = AerialPipeline(str(ws), PipelineConfig(**settings, **kw), device=dev)
            cap_graphcut_input(pipe)
            model = runs["sequential"]["model"] if runs else pipe.build_model()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            with GraphCutCount() as graphcut:
                if tag == "pipelined":
                    pipe.run_dense_pipelined(model=model)
                else:
                    pipe.run_dense(model=model)
                torch.cuda.synchronize()
            runs[tag] = {"ws": ws, "pipe": pipe, "model": model,
                         "wall": time.perf_counter() - t0,
                         "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "launches": {c.__name__: c.launches for c in counters},
                         "graphcut": graphcut, "cfg": pipe.cfg}
        seq, pip = runs["sequential"], runs["pipelined"]
        n_maps = len(posesF)
        for tag, r in runs.items():
            for name, k in per_map.items():
                if r["launches"][name] != k * n_maps:
                    raise AssertionError(f"[main:pipelined] {tag}: {name} launched "
                                         f"{r['launches'][name]} times, expected {k} x {n_maps}")
        stats = check_mesh_dsm(pip["ws"], pip["cfg"], pip["graphcut"])
        if stats["blocks"] != PIPELINED_NX:
            raise AssertionError(f"[main:pipelined] {stats['blocks']} fused blocks, expected "
                                 f"{PIPELINED_NX}")
        compared = {}
        for sub, pattern in (("dense/MVS", "*.pfm"), ("dense/MVS", "*.txt"),
                             ("dense/fusion", "*"), ("mesh", "*"), ("dsm", "*"),
                             ("production/Point_Cloud", "*"), ("production/Mesh", "*"),
                             ("production/DSM", "*")):
            names, differ = same_files(seq["ws"], pip["ws"], sub, pattern)
            if differ:
                raise AssertionError(f"[main:pipelined] {sub}: {differ} differ between "
                                     "run_dense and run_dense_pipelined")
            compared[f"{sub}/{pattern}"] = len(names)
        mvs = pip["ws"] / "dense" / "MVS"
        for i in range(1, n_maps + 1):
            name = f"im_{i:02d}"
            d = read_dmap(mvs / f"{name}.dmap")
            depth, conf = read_pfm(mvs / f"{name}_init.pfm")[0], read_pfm(mvs / f"{name}_prob.pfm")[0]
            normal = read_pfm(mvs / f"{name}_normal.pfm")[0] * 2.0 - 1.0
            if not (np.array_equal(d.depth, depth) and np.array_equal(d.confidence, conf)
                    and np.abs(d.normal - normal).max() <= 1e-6):
                raise AssertionError(f"[main:pipelined] {name}.dmap does not read back as its PFMs")
            for suffix in ("init", "prob"):
                png = mvs / "color" / f"{name}_{suffix}.png"
                if Image.open(png).size != (FULL_W, FULL_H):
                    raise AssertionError(f"[main:pipelined] {png.name}: {Image.open(png).size}")
        t = pip["pipe"].timeline
        log(f"[main:pipelined] {n_maps} maps at {FULL_H}x{FULL_W}, {PIPELINED_NX} "
            f"blocks sharing views "
            f"(fusion_num 2, position_threshold {settings['position_threshold']:.3f} px), "
            f"fused points {stats['points']}, graph cut on {stats['graphcut_points']}: "
            f"byte-equal between the runs " + json.dumps(compared)
            + f"; {n_maps} .dmap read back as their PFMs, {2 * n_maps} previews at "
            f"{FULL_W}x{FULL_H}")
        for tag, r in runs.items():
            pipe = r["pipe"]
            log(f"[main:pipelined] {tag}: wall {r['wall']:.2f} s, stages "
                + json.dumps({k: round(v, 3) for k, v in pipe.stage_seconds.items()})
                + f"; forwards through the copy {sum(pipe.map_seconds):.3f} s of dense "
                f"matching (the rest: waits for the loader and file writes)"
                + f"; per batch {json.dumps([round(x, 3) for x in pipe.map_seconds])} s "
                f"({json.dumps(pipe.map_batches)}); peak device memory {r['peak']:.2f} GiB; "
                f"launches {json.dumps(r['launches'])}")
        log(f"[main:pipelined] timeline (s from the start) " + json.dumps(
            {k: round(v, 3) for k, v in t.items()}) + f": the worker began block 0 at "
            f"{t['first_block']:.3f} s, the last map was written at {t['last_map']:.3f} s: "
            f"{max(0.0, t['last_map'] - t['first_block']):.3f} s of fusion overlapped dense "
            f"matching; wall {pip['wall']:.2f} s against run_dense's {seq['wall']:.2f} s "
            f"({pip['wall'] / seq['wall']:.3f})")

        # the GIL: the forward alone, then while a thread fuses run_dense's
        # maps into a scratch directory
        model = seq["model"]
        probe = AerialPipeline(str(seq["ws"]), seq["cfg"], device=dev)
        probe.fusion_path = str(tmp / "gil")
        Path(probe.fusion_path).mkdir()
        s = probe.eval_dataset().build(0)
        forward_seconds(model, s, dev, 2)
        alone = forward_seconds(model, s, dev, 8)
        stop, fused = threading.Event(), [0]

        def fuse():  # one block at a time, so that the join waits less
            with torch.no_grad():
                while not stop.is_set():
                    probe.fuse_depth_map(block_indices=[fused[0] % PIPELINED_NX])
                    fused[0] += 1

        worker = threading.Thread(target=fuse)
        worker.start()
        try:
            time.sleep(1.0)
            busy = forward_seconds(model, s, dev, 8)
        finally:
            stop.set()
            worker.join()
        a, b = float(np.median(alone)), float(np.median(busy))
        log(f"[main:pipelined] GIL: forward at {FULL_H}x{FULL_W} (host clock through a "
            f"sync, median of 8) {a * 1e3:.1f} ms alone, {b * 1e3:.1f} ms while a thread "
            f"fuses the maps, block by block ({b / a:.3f}x; {fused[0]} blocks fused; alone {json.dumps([round(x * 1e3, 1) for x in alone])}, "
            f"beside fusion {json.dumps([round(x * 1e3, 1) for x in busy])} ms)")
        t0 = time.perf_counter()
        phase_fusion_cli(pip["ws"], settings)
        log(f"[phase] fusion:cli {time.perf_counter() - t0:.1f} s")
    return pip["launches"]


def phase_fusion_cli(ws: Path, settings):
    """[fusion:cli] python -m deep3d_aerial_tpu_torch.fusion, in-process, on
    a workspace's dense/MVS, with --pc_format las and ply (on the card, its
    default): the same point counts per block, the LAS within its 0.001 m
    storage step of the PLY (half a step, plus float32's resolution of the
    PLY's coordinates), the same borders, also as the pipeline's."""
    from deep3d_aerial_tpu_torch.fusion.__main__ import main as fusion_main
    from deep3d_aerial_tpu_torch.io.las import read_las
    from deep3d_aerial_tpu_torch.io.ply import read_ply

    args = ["--project_folder", str(ws / "export"), "--mvs_path", str(ws / "dense" / "MVS"),
            "--fusion_num", str(settings["fusion_num"]),
            "--min_geo_consist_num", str(settings["geo_consist_num"]),
            "--photomatric_threshold", str(settings["photomatric_threshold"]),
            "--position_threshold", str(settings["position_threshold"]),
            "--depth_threshold", str(settings["depth_threshold"]),
            "--normal_threshold", str(settings["normal_threshold"])]
    secs = {}
    for fmt in ("ply", "las"):
        t0 = time.perf_counter()
        fusion_main(args + ["--output_path", str(ws / f"cli_{fmt}"), "--pc_format", fmt])
        torch.cuda.synchronize()
        secs[fmt] = time.perf_counter() - t0
    counts, worst = [], 0.0
    for ply in sorted((ws / "cli_ply").glob("scene_*.ply")):
        p = read_ply(ply)[0]
        las, colors, header = read_las(ws / "cli_las" / ply.with_suffix(".las").name)
        err = np.abs(las - p) - (0.0005 + 1e-6 * np.abs(p))
        if len(las) != len(p) or (len(p) and err.max() > 0) or colors is None:
            raise AssertionError(f"[fusion:cli] {ply.stem}: LAS {len(las)} points, PLY "
                                 f"{len(p)}, worst excess {err.max() if len(p) else 0}")
        worst = max(worst, float(np.abs(las - p).max()) if len(p) else 0.0)
        for border in (ws / "cli_las" / f"{ply.stem}.txt",
                       ws / "dense" / "fusion" / f"{ply.stem}.txt"):
            if border.read_bytes() != ply.with_suffix(".txt").read_bytes():
                raise AssertionError(f"[fusion:cli] {border} differs from {ply.stem}.txt")
        counts.append(len(p))
    if len(counts) != PIPELINED_NX or sum(counts) == 0:
        raise AssertionError(f"[fusion:cli] blocks fused: {counts}")
    log(f"[fusion:cli] {len(counts)} blocks, points {counts} in PLY and LAS alike (LAS "
        f"within {worst:.2e} m of the PLY), borders equal; ply {secs['ply']:.2f} s, "
        f"las {secs['las']:.2f} s (host clock, views loaded included)")


def compare_forwards(tag, mk, mp, inputs):
    """A forward through the kernels (`mk`) against the same forward
    through their plain versions (`mp`, same weights), per stage: depth
    within TOL_DEPTH_FRAC of the range, confidence within TOL_CONF.
    Returns both forwards' outputs."""
    with torch.no_grad():
        ok, op = mk(*inputs), mp(*inputs)
    hold_forward(tag, ok, op, *inputs[2:])
    return ok, op


def hold_forward(tag, ok, op, dmin, dmax):
    """A float32 forward's outputs through the kernels (`ok`) against the
    plain forward's (`op`), per stage: depth within TOL_DEPTH_FRAC of the
    range, confidence within TOL_CONF, every depth finite."""
    dtol = TOL_DEPTH_FRAC * (dmax - dmin)
    for s in ("stage1", "stage2", "stage3"):
        dd = float((ok[s]["depth"] - op[s]["depth"]).abs().max())
        dc = float((ok[s]["photometric_confidence"]
                    - op[s]["photometric_confidence"]).abs().max())
        finite = bool(torch.isfinite(ok[s]["depth"]).all())
        log(f"[{tag}] {s}: kernel vs plain depth max |diff| {dd:.3e} m (tol "
            f"{dtol:.3e}), confidence {dc:.3e} (tol {TOL_CONF:g})")
        if not (finite and dd <= dtol and dc <= TOL_CONF):
            raise AssertionError(f"{tag} {s}: depth {dd}, conf {dc}, finite {finite}")


def phase_end_to_end(dev, cam0, poses0):
    """One sample through the forward with the kernels and with their plain
    versions (same weights)."""
    from deep3d_aerial_tpu_torch.models.adamvs import AdaMVS
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(cam0, poses0, dev, ref=1)
    mk = init_random_weights(AdaMVS(), seed=0).to(dev).eval()
    mp = AdaMVS(warp_impl="plain", red_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    ok, op = compare_forwards("e2e", mk, mp, (imgs, rel, dmin, dmax))
    dtol = TOL_DEPTH_FRAC * (dmax - dmin)
    dp = float((ok["stage1"]["pair_results"] - op["stage1"]["pair_results"]).abs().max())
    log(f"[e2e] pair depth max |diff| {dp:.3e} m")
    if not dp <= dtol:
        raise AssertionError(f"end to end pair depth {dp}")
    profile_forward(mk, (imgs, rel, dmin, dmax),
                    {"sweep_pair": "K1 sweep_corr", "sweep_cost": "K2 sweep_cost",
                     "red2_level": "K3 red_step2"})


def phase_end_to_end_msrednet(dev, cam0, poses0):
    """One sample through the MSREDNet forward with the kernels and with
    their plain versions (same weights), then the kernel forward profiled:
    returns its busy ms and device launches by kernel family."""
    from deep3d_aerial_tpu_torch.models.msrednet import MSREDNet
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(cam0, poses0, dev, ref=1)
    mk = init_random_weights(MSREDNet(), seed=0).to(dev).eval()
    mp = MSREDNet(warp_impl="plain", red_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    compare_forwards("e2e:msrednet", mk, mp, (imgs, rel, dmin, dmax))
    # two forwards profiled: exactly their conv-template launches
    want = 2 * RED4_CONVS * sum(NDEPTHS)
    busy, counts = profile_forward(
        mk, (imgs, rel, dmin, dmax),
        {"sweep_var": "K2v sweep_var", "conv_mma_kernel": "K5 cf_conv3x3 (in K4)",
         "gru_": "K4 GroupNorm + GRU passes"},
        "profile:msrednet", calls=2)
    got = counts.get("K5 cf_conv3x3 (in K4)", 0)
    log(f"[profile:msrednet] conv-template launches in two forwards' device "
        f"events: {got} (expected 2 x {RED4_CONVS} x {sum(NDEPTHS)} planes)")
    if got != want:
        raise AssertionError(f"{got} conv-template launches in two MSREDNet "
                             f"forwards, expected {want}")
    return busy, counts


# cuDNN's (and its CUTLASS-style) convolution kernels, as the profiler lists
# them: implicit GEMMs (fprop; dgrad for the transposed convs) and the
# layout transforms cuDNN launches around them
CONV_FAMILY = ("conv", "Conv", "fprop", "dgrad", "gemm", "xmma", "cutlass",
               "implicit", "nchwToNhwc", "nhwcToNchw")


def phase_end_to_end_volume(dev, cam0, poses0, model_type):
    """One sample through the CasMVSNet / UCSNet forward with K2v and with
    its plain version (same weights): depth (and UCSNet's sigma) within
    TOL_DEPTH_FRAC of the range, confidence within TOL_CONF. Then the
    kernel forward profiled: device busy against wall, and device ms by
    family -- K2v, cuDNN convs, other -- with the convs split into
    CostRegNet3D's 3-D ones and the feature net's 2-D ones by profiling the
    feature net alone."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.models.casmvsnet import stage_features
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(cam0, poses0, dev, ref=1)
    mk = init_random_weights(build_model(model_type), seed=0).to(dev).eval()
    mp = build_model(model_type, warp_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    check_volume_forwards(f"e2e:{model_type}", model_type, mk, mp, (imgs, rel, dmin, dmax))
    fams = {"sweep_var": "K2v sweep_var"}
    fams.update({k: "cuDNN convs" for k in CONV_FAMILY})
    busy, counts = profile_forward(mk, (imgs, rel, dmin, dmax), fams,
                                   f"profile:{model_type}")
    feat, _ = profile_forward(lambda x: stage_features(mk.feature, x), (imgs,),
                              fams, f"profile:{model_type}:features")
    if busy:
        conv, conv2d = busy.get("cuDNN convs", 0.0), feat.get("cuDNN convs", 0.0)
        log(f"[profile:{model_type}] device ms a forward: K2v "
            f"{busy.get('K2v sweep_var', 0.0):.3f} in "
            f"{counts.get('K2v sweep_var', 0)} launches; cuDNN convs {conv:.3f} "
            f"(CostRegNet3D's 3-D {conv - conv2d:.3f}, FeatureNet's 2-D "
            f"{conv2d:.3f}); other {busy.get('other (PyTorch ops, cuDNN)', 0.0):.3f}")
    return busy


def check_volume_forwards(tag, model_type, mk, mp, inputs):
    """A CasMVSNet / UCSNet forward through K2v (`mk`) against the same
    forward through its plain version (`mp`, same weights) on `inputs`:
    depth (and UCSNet's sigma) within TOL_DEPTH_FRAC of the range,
    confidence within TOL_CONF where both paths truncate the expected
    plane index to the same plane. The scores are each stage's
    CostRegNet3D outputs, one call a depth block (depth_shards), in order."""
    dmin, dmax = inputs[2:]
    calls_k, calls_p = {}, {}
    hooks = [getattr(m, f"cost_reg{s}").register_forward_hook(
        lambda mod, args, out, s=s, got=got: got.setdefault(f"stage{s + 1}", []).append(
            out[:, 0].reshape(-1, *out.shape[-2:])))
        for m, got in ((mk, calls_k), (mp, calls_p)) for s in range(3)]
    with torch.no_grad():
        ok = mk(*inputs)
        op = mp(*inputs)
    for h in hooks:
        h.remove()
    scores_k, scores_p = ({s: torch.cat(v) for s, v in got.items()}
                          for got in (calls_k, calls_p))
    dtol = TOL_DEPTH_FRAC * (dmax - dmin)
    dev = ok["depth"].device
    for s in ("stage1", "stage2", "stage3"):
        diffs = {k: float((ok[s][k] - op[s][k]).abs().max()) for k in op[s]}
        finite = all(bool(torch.isfinite(v).all()) for v in ok[s].values())
        # the confidence gathers a window at the TRUNCATED expected plane
        # index: where that index sits on an integer, the two paths may
        # truncate it to neighbouring planes and gather other windows. So
        # confidence is held to TOL_CONF where both paths' truncated index
        # agree, and a pixel where they differ must have both indices
        # within 1e-3 of one integer.
        D = scores_k[s].shape[0]
        ks = torch.arange(D, dtype=torch.float32, device=dev)[:, None, None]
        ik, ip = ((torch.softmax(sc[s], 0) * ks).sum(0) for sc in (scores_k, scores_p))
        same = ik.clamp(0, D - 1).long() == ip.clamp(0, D - 1).long()
        edge = torch.round(ip)
        on_edge = ((ik - edge).abs() <= 1e-3) & ((ip - edge).abs() <= 1e-3)
        dc = (ok[s]["photometric_confidence"] - op[s]["photometric_confidence"]).abs()
        diffs["photometric_confidence"] = float(dc[same].max())
        flips = int((~same).sum())
        log(f"[{tag}] {s}: kernel vs plain max |diff| " + json.dumps(
            {k: float(f"{v:.3e}") for k, v in diffs.items()})
            + f" (depth and variance tol {dtol:.3e} m, confidence tol {TOL_CONF:g} "
            f"where the truncated plane index agrees); {flips} of {same.numel()} "
            f"pixels truncate to another plane, all within 1e-3 of an integer: "
            f"{bool(on_edge[~same].all())}")
        if not bool(on_edge[~same].all()):
            raise AssertionError(f"{model_type} end to end {s}: the plane index "
                                 "differs away from an integer")
        for k, v in diffs.items():
            if not finite or not v <= (TOL_CONF if k == "photometric_confidence" else dtol):
                raise AssertionError(f"{model_type} end to end {s} {k}: {v} "
                                     f"(finite {finite})")
    return ok


def phase_end_to_end_bf16(dev, cam0, poses0, model_type):
    """One sample through the model's bfloat16 forward with the kernels and
    with their plain versions, and through the plain float32 forward (same
    weights): kernel vs plain within BF16_GAP_FACTOR x the plain bfloat16
    vs float32 distance (or the float32 tolerances, where larger), per
    stage, depth and confidence. Then the kernel forward profiled: device
    busy against wall, device ms by family (`[profile:bf16:<model>]`)."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(cam0, poses0, dev, ref=1)
    plain = {"warp_impl": "plain"}
    if model_type in ("adamvs", "msrednet"):
        plain["red_impl"] = "plain"
    mk = init_random_weights(build_model(model_type, dtype="bfloat16"),
                             seed=0).to(dev).eval()
    outs = {}
    with torch.no_grad():
        outs["kernel"] = mk(imgs, rel, dmin, dmax)
        for name, dt in (("plain", "bfloat16"), ("plain32", "float32")):
            m = build_model(model_type, dtype=dt, **plain).to(dev).eval()
            m.load_state_dict(mk.state_dict())
            outs[name] = m(imgs, rel, dmin, dmax)
            del m
    res = hold_bf16_forward(f"e2e:bf16:{model_type}", outs, dmin, dmax)
    # where a bfloat16 forward's device time goes, by family
    fams = {"sweep_pair": "K1", "sweep_cost": "K2", "sweep_var": "K2v", "red2_level": "K3",
            "conv_mma": "K5 (in K4)", "gru_": "K4 GRU passes"}
    fams.update({k: "cuDNN convs" for k in CONV_FAMILY})
    profile_forward(mk, (imgs, rel, dmin, dmax), fams, f"profile:bf16:{model_type}")
    return res


def hold_bf16_forward(tag, outs, dmin, dmax):
    """A bfloat16 forward's outputs through the kernels (`outs['kernel']`)
    against the plain bfloat16 forward's (`outs['plain']`), per stage,
    depth and confidence: within BF16_GAP_FACTOR x the plain bfloat16 vs
    plain float32 (`outs['plain32']`) distance, or the float32 tolerances
    where larger. Returns {stage: {key: (diff, gap)}}."""
    res = {}
    for s in ("stage1", "stage2", "stage3"):
        row = {}
        for key, floor in (("depth", TOL_DEPTH_FRAC * (dmax - dmin)),
                           ("photometric_confidence", TOL_CONF)):
            k, p, p32 = (outs[n][s][key].float() for n in ("kernel", "plain", "plain32"))
            diff, gap = float((k - p).abs().max()), float((p - p32).abs().max())
            tol = max(BF16_GAP_FACTOR * gap, floor)
            finite = bool(torch.isfinite(k).all())
            row[key] = (diff, gap)
            log(f"[{tag}] {s} {key}: kernel vs plain bf16 max |diff| "
                f"{diff:.3e}; plain bf16 vs plain fp32 {gap:.3e}; tol {tol:.3e}")
            if not (finite and diff <= tol):
                raise AssertionError(f"{tag} {s} {key}: {diff} > {tol} (finite {finite})")
        res[s] = row
    return res


def profile_forward(model, inputs, fams, tag="profile", calls=1):
    """Device busy time of a 384x512 forward (torch.profiler, CUPTI; the
    mean over `calls` profiled forwards), by kernel family (`fams`: name
    substring -> family), against the unprofiled forward's wall time: the
    device's idle share of a map. Returns (busy ms per forward, device
    launches over the `calls` forwards) by family, empty if the profiler
    saw no device events. The session must list one event of the port's
    kernels for each launch the wrappers count (as in `device_ms`)."""
    from deep3d_aerial_tpu_torch.utils.profiling import device_events

    walls = []
    with torch.no_grad():
        before = own_launches()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        want = (own_launches() - before) // 3 * calls
        evs = device_events(lambda: [model(*inputs) for _ in range(calls)],
                            lambda evs: sum(1 for e in evs
                                            if OWN_KERNEL.search(e.name)) == want)
    wall = float(np.median(walls))
    busy, counts = {}, {}
    for e in evs:
        fam = next((v for k, v in fams.items() if k in e.name), "other (PyTorch ops, cuDNN)")
        busy[fam] = busy.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        counts[fam] = counts.get(fam, 0) + 1
    total = sum(busy.values())
    if total == 0:
        log(f"[{tag}] forward {wall:.2f} ms wall; device time not measured "
            "(the profiler saw no device events)")
        return {}, {}
    log(f"[{tag}] one 384x512 forward: {wall:.2f} ms wall (median of 3, "
        f"unprofiled), device busy {total:.2f} ms, idle share "
        f"{1 - total / wall:.3f}; busy ms by family " + json.dumps(
            {k: round(v, 3) for k, v in sorted(busy.items())})
        + f"; device launches by family over {calls} forward(s) "
        + json.dumps(dict(sorted(counts.items()))))
    return busy, counts


def phase_production_frame(dev, camF, posesF, model_type="adamvs",
                           compute_dtype="float32"):
    """One 1856x2752 map through the model's kernel forward at the f=3727
    survey geometry, in `compute_dtype`: every pixel finite."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    imgs, rel, dmin, dmax, _ = sample(camF, posesF, dev, ref=1)
    model = init_random_weights(build_model(model_type, dtype=compute_dtype),
                                seed=0).to(dev).eval()
    tag = "fullres" if model_type == "adamvs" else f"fullres:{model_type}"
    if compute_dtype != "float32":
        tag = f"fullres:bf16:{model_type}"
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
    log(f"[{tag}] {FULL_H}x{FULL_W} f={camF.fx:.1f}: {tuple(depth.shape)}, "
        f"finite {finite * 100:.4f}% of pixels, {took:.3f} s per map, "
        f"peak device memory {peak:.2f} GiB")
    if tuple(depth.shape) != (FULL_H, FULL_W) or finite != 1.0:
        raise AssertionError(f"{tag} map: shape {tuple(depth.shape)}, "
                             f"finite share {finite}")
    return took


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions, one step kernel vs plain, the
# trainer at its CLI's defaults
# ---------------------------------------------------------------------------

# [train:grad], stated before measuring: a Function's backward is its plain
# version's VJP on the same inputs as plain autograd's, so the two agree up
# to the order in which the gathers' backward (index_add, atomic on the
# card) adds: ~1e-7 of the largest gradient entry; 1e-5 leaves room
TOL_GRAD_FN = 1e-5
# [train:step:*], kernel path vs plain path, one step on the same weights
# and batch: the forwards differ by ~1e-6 (the kernels' sums in another
# order), which the loss shows at ~1e-6 relative: TOL_STEP_LOSS. The
# gradient is another matter: the cascade's later stages sample depths
# around the earlier stages' output and the bilinear taps' gradient steps
# where a tap crosses a pixel border, so a 1e-6 change of the forward can
# move a gradient by far more (on the CPU the JAX package's own UCSNet
# gradient moves by 6.1e-3 of a leaf's largest entry when the images
# change by one ulp). The phase measures that conditioning on the card:
# the plain path again with the images scaled by (1 + 2^-22), cuDNN in its
# deterministic algorithms so that the difference is the input's alone.
# A leaf's gradient error is |g - g_plain| over its largest entry plus
# 1e-3 of the model's largest gradient (a leaf ~0 by symmetry, the score
# bias under the softmax over planes), and the kernel path's largest must
# stay within TOL_STEP_GRAD or STEP_COND times the one-ulp run's. The
# parameters after one rmsprop update (from nu = 0 a gradient g moves a
# parameter by lr * u(g), u(g) = g / sqrt(0.1 g^2 + 1e-8)): each within
# lr * (u(g + d) - u(g - d)) of the plain path's, d the gradient error
# allowed for its leaf, plus 1e-6 for the update's own rounding.
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD = 1e-3
STEP_COND = 3.0
TRAIN_LR = 1e-3
# [train:adamvs]: the trainer CLI's defaults (5 views, num_depth 384,
# ndepths 48/32/8, max_h 384, max_w 768, batch 1, rmsprop at 1e-3) on a
# WHU-layout folder rendered here: 2 train and 2 val reference views of a
# 4 x 3 survey at 384 x 768 (8 train views until the bfloat16 phases, 4
# until the compensated-warp and depth-shard phases needed the script's
# time)
TRAIN_H, TRAIN_W = 384, 768
TRAIN_REFS, VAL_REFS = list(range(2)), [9, 10]
TRAIN_EPOCHS = 2


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def grad_case(dev, name, tag, fn, plain, tensors, calls, iters):
    """One Function at one shape: gradients of a seeded random projection
    of its outputs with respect to every tensor that requires one, through
    the Function (the kernel forward, `fn`) and by plain autograd on the
    card (`plain`); the max abs error over the max |grad| per input (raises
    above TOL_GRAD_FN). Times (device ms a call): the Function's forward
    and its backward (the plain version's recompute and VJP, which is all
    that plain autograd's forward + backward would run: the two read
    within 1% of each other in every run up to PR 10, so that yardstick is
    no longer timed). `calls`: the calls a map (a training step's forward)
    makes at this shape."""
    leaves = [t for t in tensors if t.requires_grad]
    outs = _tuple(fn())
    g = torch.Generator(device=dev).manual_seed(11)
    proj = [torch.randn(o.shape, generator=g, device=dev) for o in outs]
    got = torch.autograd.grad(outs, leaves, proj)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    want = torch.autograd.grad(_tuple(plain()), leaves, proj)
    t1.record()
    t1.synchronize()
    est = t0.elapsed_time(t1)
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(got, want)]
    err = max(errs)
    if not all(bool(torch.isfinite(a).all()) for a in got) or not err <= TOL_GRAD_FN:
        raise AssertionError(f"[train:grad] {name} {tag}: Function vs plain autograd "
                             f"relative errors {errs} (tol {TOL_GRAD_FN})")
    if not all(o.grad_fn is not None and "KernelFn" in type(o.grad_fn).__name__
               for o in outs):
        raise AssertionError(f"[train:grad] {name} {tag}: the outputs do not come "
                             "from the kernel's Function")
    fwd = device_ms(fn, iters)
    held = _tuple(fn())

    def backward():
        torch.autograd.grad(held, leaves, proj, retain_graph=True)
    # the plain VJPs take up to seconds a call and launch hundreds of
    # kernels: as many calls a session as fit in ~0.3 s, one to three
    n = max(1, min(3, int(0.3e3 / max(est, 1e-3))))
    bwd = device_ms(backward, n)
    log(f"[train:grad] {name:10s} {tag:30s} grad err {err:.2e} over {len(leaves)} "
        f"inputs (tol {TOL_GRAD_FN:g}); device ms: forward (kernel) {fwd:.4f}, "
        f"backward (plain VJP) {bwd:.4f}; calls a map {calls}")
    del held
    return {"name": name, "shape": tag, "grad_err": err, "fwd_ms": fwd,
            "bwd_ms": bwd, "calls": calls}


def phase_train_grad(dev, cam0, poses0):
    """[train:grad]: each Function (K1, K2, K2v, K3, K4) against plain
    autograd at the 384x512 main paths' stage shapes (K1 at stages 1 and
    3), every input and parameter taking a gradient."""
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
    from deep3d_aerial_tpu_torch.ops import red_step4 as rs4
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3, cf_conv3x3_plain
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2, red_step2_plain
    from deep3d_aerial_tpu_torch.ops.sweep import (
        sweep_corr,
        sweep_corr_plain,
        sweep_cost,
        sweep_cost_plain,
        sweep_var,
        sweep_var_plain,
    )
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).requires_grad_()

    V1 = VIEWS - 1
    records = []
    for stage, (C, D) in enumerate(zip(CHANNELS, NDEPTHS)):
        s = 2 ** (2 - stage)
        H, W = H0 // s, W0 // s
        rel = stage_rel(cam0, poses0, stage, dev)
        ref, srcs = rnd(H, W, C), rnd(V1, H, W, C)
        d = stage_planes(cam0, poses0, stage, H, W, dev).requires_grad_()
        wts = (torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1).requires_grad_()
        tag = f"stage{stage + 1} {H}x{W} C{C}"
        if stage != 1:
            # K1 runs at stage 1 only; at stage 3's shape a chunk of planes
            nd = NDEPTHS[0] if stage == 0 else CHUNK
            dp = stage_planes(cam0, poses0, 0, H, W, dev, n=nd).requires_grad_()
            records.append(grad_case(
                dev, "sweep_corr", tag + f" V{V1} D{nd}",
                lambda: sweep_corr(ref, srcs, rel, dp),
                lambda: sweep_corr_plain(ref, srcs, rel, dp), [ref, srcs, dp],
                1 if stage == 0 else 0, 10))
            del dp
        records.append(grad_case(
            dev, "sweep_cost", tag + f" V{V1} K{CHUNK}",
            lambda: sweep_cost(ref, srcs, rel, d, wts),
            lambda: sweep_cost_plain(ref, srcs, rel, d, wts), [ref, srcs, d, wts],
            D // CHUNK, 10))
        records.append(grad_case(
            dev, "sweep_var", tag + f" V{V1} K{CHUNK}",
            lambda: sweep_var(ref, srcs, rel, d), lambda: sweep_var_plain(ref, srcs, rel, d),
            [ref, srcs, d], D // CHUNK, 10))
        up = stage < 2
        m2 = init_random_weights(RedStep2(C, up=up), seed=stage).to(dev)
        p2 = dict(m2.named_parameters())
        packed = m2._packed_params()
        cost, s1 = rnd(C, H, W), rnd(8, H, W, scale=0.5)
        s2 = rnd(16, (H + 1) // 2, (W + 1) // 2, scale=0.5)
        records.append(grad_case(
            dev, "red_step2", tag + (" up" if up else ""),
            lambda: red_step2(p2, cost, s1, s2, up=up, packed=packed),
            lambda: red_step2_plain(p2, cost, s1, s2, up=up),
            [cost, s1, s2, *p2.values()], D, 10))
        m4 = init_random_weights(RedStep4(C), seed=stage).to(dev)
        p4 = dict(m4.named_parameters())
        packed4 = m4._packed.get(m4)
        states = [rnd(c, H >> l, W >> l, scale=0.5) for l, c in enumerate(rs4.HIDDEN)]
        records.append(grad_case(
            dev, "red_step4", tag,
            lambda: rs4.red_step4(p4, cost, *states, packed=packed4),
            lambda: rs4.red_step4_plain(p4, cost, *states),
            [cost, *states, *p4.values()], D, 5))
        del ref, srcs, d, wts, cost, s1, s2, states
        torch.cuda.empty_cache()
    # K5's own Function (no training path calls it alone: K4's covers the
    # launches inside a RedStep4 step), at one of the step's conv shapes
    x, w, b = rnd(16, H0, W0), rnd(16, 16, 3, 3, scale=1 / 12), rnd(16, scale=0.1)
    records.append(grad_case(
        dev, "cf_conv3x3", f"same 16->16 {H0}x{W0}", lambda: cf_conv3x3(x, w, b),
        lambda: cf_conv3x3_plain(x, w, b), [x, w, b], 0, 10))
    per_map = {}
    for r in records:
        e = per_map.setdefault(r["name"], {"bwd_ms": 0.0, "fwd_ms": 0.0,
                                           "grad_err": 0.0})
        for k in ("bwd_ms", "fwd_ms"):
            e[k] += r[k] * r["calls"]
        e["grad_err"] = max(e["grad_err"], r["grad_err"])
    for name, e in per_map.items():
        log(f"[train:grad] {name}: per {H0}x{W0} map (calls a map x device ms a call, "
            f"summed over stages): forward {e['fwd_ms']:.3f} ms, backward (plain VJP) "
            f"{e['bwd_ms']:.3f} ms; largest grad err {e['grad_err']:.2e}")
    return per_map


class StepTimer:
    """A train step (train/step.py) with CUDA events at its marks: per step
    the device-clock ms of its forward, backward and optimizer phases (the
    gaps the host leaves included), and its logs."""

    def __init__(self, step):
        self.step = step
        self.events = []
        self.logs = []

    def __call__(self, batch, mark=None):
        marks = []

        def rec(label):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((label, e))
        rec("start")
        logs = self.step(batch, mark=rec)
        self.events.append(marks)
        self.logs.append(logs)
        return logs

    def split(self, skip=2):
        """Median ms of each phase and of the whole step over steps
        skip+1..n."""
        torch.cuda.synchronize()
        per = {}
        for marks in self.events[skip:] or self.events[-1:]:
            for (_, a), (label, b) in zip(marks, marks[1:]):
                per.setdefault(label, []).append(a.elapsed_time(b))
            per.setdefault("step", []).append(marks[0][1].elapsed_time(marks[-1][1]))
        return {k: float(np.median(v)) for k, v in per.items()}


def idle_share(step, batch):
    """(device busy ms, step wall ms between CUDA events, idle share) of
    one profiled train step: the union of its device events' intervals
    (torch.profiler, `device_events`, which must list one event of the
    port's kernels for each launch the counters add) over the step's wall."""
    from deep3d_aerial_tpu_torch.utils.profiling import device_events

    walls = []

    def run():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(batch)
        b.record()
        walls.append((a, b))

    before = own_launches()
    run()
    torch.cuda.synchronize()
    want = own_launches() - before
    evs = device_events(run, lambda evs: sum(
        1 for e in evs if OWN_KERNEL.search(e.name)) == want)
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    a, b = walls[-1]
    wall = a.elapsed_time(b)
    busy_ms = busy / 1e3
    return busy_ms, wall, 1.0 - busy_ms / wall


def train_model(model_type, impl="kernel", seed=21, **kw):
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    if impl == "plain":
        kw["warp_impl"] = "plain"
        if model_type in ("adamvs", "msrednet"):
            kw["red_impl"] = "plain"
    return init_random_weights(build_model(model_type, **kw), seed=seed)


def train_batch(cam, poses, dev, ref=0):
    imgs, rel, dmin, dmax, depth = sample(cam, poses, dev, ref=ref)
    return {"imgs": imgs[None], "rel_projs": rel[None],
            "depth_min": torch.tensor([dmin], device=dev),
            "depth_max": torch.tensor([dmax], device=dev),
            "depth_gt": depth[None], "mask": (depth > 0).float()[None]}


MODEL_NDEPTHS = {"adamvs": NDEPTHS, "msrednet": NDEPTHS, "casmvsnet": NDEPTHS,
                 "ucsnet": UCS_NDEPTHS}


def train_counters(model_type):
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost, sweep_var

    nd = MODEL_NDEPTHS[model_type]
    chunks = sum(d // CHUNK for d in nd)
    return {"adamvs": {sweep_corr: 1, sweep_cost: chunks, red_step2: sum(nd)},
            "msrednet": {sweep_var: chunks, red_step4: sum(nd),
                         cf_conv3x3: RED4_CONVS * sum(nd)},
            "casmvsnet": {sweep_var: chunks}, "ucsnet": {sweep_var: chunks}}[model_type]


def phase_train_step_parity(dev, cam0, poses0, model_type):
    """[train:step:<model>]: one train step on the same seeded weights and
    batch through the kernel path and through the plain path
    (warp_impl/red_impl 'plain') on the card at 384x512 and the model's
    main-path planes, and the plain path again on images scaled by
    (1 + 2^-22) to measure the gradient's conditioning: the loss, every
    parameter's gradient and the parameters after one rmsprop update, each
    within its stated tolerance. The kernel step must launch exactly the
    main path's kernels (one forward's worth), the plain ones none."""
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer
    from deep3d_aerial_tpu_torch.train.step import make_train_step

    batch = train_batch(cam0, poses0, dev)
    nudged = dict(batch, imgs=batch["imgs"] * (1 + 2.0 ** -22))
    pair_w = 1.0 if model_type == "adamvs" else 0.0
    counters = train_counters(model_type)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for impl, b in (("kernel", batch), ("plain", batch), ("nudged", nudged)):
            model = train_model(model_type, "plain" if impl == "nudged" else impl,
                                ndepths=MODEL_NDEPTHS[model_type]).to(dev)
            opt = make_optimizer(model.named_parameters(), TRAIN_LR)
            grads = {}
            update = opt.step
            opt.step = lambda g, update=update, grads=grads: grads.update(
                {n: t.clone() for n, t in g.items()}) or update(g)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            logs = make_train_step(model, opt, pair_weight=pair_w)(b)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
            want = {c.__name__: (k if impl == "kernel" else 0) for c, k in counters.items()}
            if launches != want:
                raise AssertionError(f"[train:step:{model_type}] {impl} step launched "
                                     f"{launches}, expected {want}")
            out[impl] = (logs, grads, {n: p.detach().clone()
                                       for n, p in model.named_parameters()}, secs)
            del model, opt
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lk, gk, pk, sk), (lp, gp, pp, sp), (_, gu, _, _) = (
        out["kernel"], out["plain"], out["nudged"])
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    scale = max(float(g.abs().max()) for g in gp.values())

    def rel(a, b):
        return {n: float((a[n] - g).abs().max()) / (float(g.abs().max()) + 1e-3 * scale)
                for n, g in b.items()}
    rk, ru = rel(gk, gp), rel(gu, gp)
    worst = max(rk, key=rk.get)
    allowed = max(TOL_STEP_GRAD, STEP_COND * max(ru.values()))
    def u(x):
        return x / torch.sqrt(0.1 * x * x + 1e-8)
    param_err = 0.0
    for n, g in gp.items():
        d = allowed * (float(g.abs().max()) + 1e-3 * scale)
        atol = TRAIN_LR * (u(g + d) - u(g - d)) + 1e-6
        param_err = max(param_err, float(((pk[n] - pp[n]).abs() / atol).max()))
    log(f"[train:step:{model_type}] {H0}x{W0}, {VIEWS} views, ndepths "
        f"{MODEL_NDEPTHS[model_type]}: loss kernel {lk['total']:.6f} plain "
        f"{lp['total']:.6f} (largest log rel err {loss_err:.2e}, tol {TOL_STEP_LOSS:g}); "
        f"gradient error, kernel vs plain: {rk[worst]:.3e} ({worst}); plain on images "
        f"scaled by 1 + 2^-22 vs plain: {max(ru.values()):.3e}; allowed {allowed:.3e}; "
        f"params after one rmsprop update at {param_err:.3f} of their tolerance; host s a "
        f"step: kernel {sk:.3f}, plain {sp:.3f}")
    if not (np.isfinite(lk["total"]) and loss_err <= TOL_STEP_LOSS
            and rk[worst] <= allowed and param_err <= 1.0):
        raise AssertionError(f"[train:step:{model_type}] kernel vs plain step: loss "
                             f"{loss_err}, grad {rk[worst]} ({worst}) > {allowed}, "
                             f"params {param_err}")
    return rk[worst], max(ru.values())


def phase_train_steps(dev, cam0, poses0, model_type, steps=3):
    """[train:<model>]: `steps` train steps of the kernel path at 384x512
    and the model's main-path planes (the batch cycling over three
    reference views): ms a step split into forward, backward and optimizer
    (CUDA events, median of steps 3..n), peak device memory, the loss per
    step, and the idle share of one more, profiled, step. Every step must
    launch exactly one forward's kernels."""
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer
    from deep3d_aerial_tpu_torch.train.step import make_train_step

    model = train_model(model_type, ndepths=MODEL_NDEPTHS[model_type]).to(dev)
    opt = make_optimizer(model.named_parameters(), TRAIN_LR)
    timer = StepTimer(make_train_step(model, opt, pair_weight=float(model_type == "adamvs")))
    batches = [train_batch(cam0, poses0, dev, ref=r) for r in range(3)]
    counters = train_counters(model_type)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    for i in range(steps):
        timer(batches[i % 3])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    got = {c.__name__: c.launches for c in counters}
    want = {c.__name__: k * steps for c, k in counters.items()}
    if got != want:
        raise AssertionError(f"[train:{model_type}] {steps} steps launched {got}, "
                             f"expected {want}")
    split = timer.split()
    losses = [l["total"] for l in timer.logs]
    busy, wall, idle = idle_share(timer, batches[0])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[train:{model_type}] non-finite loss: {losses}")
    log(f"[train:{model_type}] {H0}x{W0}, {VIEWS} views, ndepths "
        f"{MODEL_NDEPTHS[model_type]}, {steps} steps: ms a step {split['step']:.2f} = "
        f"forward {split['forward']:.2f} + backward {split['backward']:.2f} + optimizer "
        f"{split['optimizer']:.2f} (CUDA events, median of steps 3..{steps}); peak "
        f"memory {peak:.2f} GiB; profiled step: device busy {busy:.2f} of {wall:.2f} ms, "
        f"idle {idle:.3f}; losses {[round(l, 4) for l in losses]}; launches {got}")
    return {"step_ms": split, "peak_gib": peak, "idle": idle,
            "launches": {k: v // steps for k, v in got.items()}}


def write_whu_folder(root: Path, cam, poses, dev, refs, views=VIEWS):
    """A WHU-OMVS layout training folder of one scene rendered from the
    survey (train/dataset_whu.py's layout, GT depth as PFM): images/*.png,
    cams/*.txt ('Twc' in XrightYup axes, 'K_mat', 'dmin dmax interval'),
    depths/*.pfm, info/image_path.txt and info/viewpair.txt with the
    `refs` as reference views, each with its views-1 nearest as sources."""
    from PIL import Image

    from deep3d_aerial_tpu_torch.io.pfm import write_pfm

    scene = root / "scene"
    for sub in ("images", "cams", "depths", "info"):
        (scene / sub).mkdir(parents=True)
    (root / "index.txt").write_text("scene\n")
    K = cam.K
    for i, pose in enumerate(poses, start=1):
        img, depth = render(cam, pose, dev)
        name = f"v{i:03d}"
        Image.fromarray(np.dstack([(img.cpu().numpy() * 255).astype(np.uint8)] * 3)
                        ).save(scene / "images" / f"{name}.png")
        d = depth.cpu().numpy()
        write_pfm(scene / "depths" / f"{name}.pfm", d.astype(np.float32))
        pad = (d.max() - d.min()) / 4 + 1.0
        R, t = pose.to_convention(axes="xrightyup", rotation="Rwc", translation="twc")
        with open(scene / "cams" / f"{name}.txt", "w") as f:
            f.write("Twc\n")
            for r in range(3):
                f.write(f"{R[r, 0]:.9f} {R[r, 1]:.9f} {R[r, 2]:.9f} {t[r]:.9f}\n")
            f.write("0 0 0 1\n\nK_mat\n")
            f.write(f"{K[0, 0]:.6f} 0 {K[0, 2]:.6f}\n0 {K[1, 1]:.6f} {K[1, 2]:.6f}\n0 0 1\n\n")
            f.write(f"{d.min() - pad:.6f} {d.max() + pad:.6f} 0.1\n")
    with open(scene / "info" / "image_path.txt", "w") as f:
        f.write(f"{len(poses)}\n")
        for i in range(1, len(poses) + 1):
            f.write(f"{i} v{i:03d}.png images/v{i:03d}.png\n")
    centers = np.stack([p.center for p in poses])
    with open(scene / "info" / "viewpair.txt", "w") as f:
        f.write(f"{len(refs)}\n")
        for r in refs:
            dist = np.linalg.norm(centers - centers[r], axis=1)
            srcs = [j for j in np.argsort(dist) if j != r][:views - 1]
            f.write(f"{r + 1}\n{len(srcs)} "
                    + " ".join(f"{j + 1} {1.0 / dist[j]:.4f}" for j in srcs) + "\n")


def phase_train_adamvs(dev):
    """[train:adamvs]: the slice's path at full width. AdaMVS at the
    trainer CLI's defaults on a rendered WHU-layout folder (8 train, 2 val
    samples at 384x768, GT depth as PFM): TRAIN_EPOCHS epochs through
    Trainer.fit as the CLI builds it (train/__main__.py: build), then the
    CLI with --resume for one more epoch, then --mode test. Gates: every
    loss finite; the checkpoints named as the JAX package names them;
    resume restores the parameters and the optimizer state bit for bit;
    the exported params.npz, as pretrain_weight, drives the pipeline's
    dense_match to finite maps; every step and eval map launches exactly a
    forward's kernels. Returns (step split, peak GiB, idle share, launches
    a step)."""
    import re as _re

    from deep3d_aerial_tpu_torch.io.pfm import read_pfm
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
    from deep3d_aerial_tpu_torch.train.__main__ import build, main, parse_args

    cam, poses = survey(TRAIN_W, TRAIN_H, nx=4, ny=3, seed=8)
    counters = train_counters("adamvs")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_whu_folder(tmp / "train", cam, poses, dev, TRAIN_REFS)
        write_whu_folder(tmp / "val", cam, poses, dev, VAL_REFS)
        log(f"[train:adamvs] wrote the WHU-layout folders ({len(poses)} views at "
            f"{TRAIN_H}x{TRAIN_W}, {len(TRAIN_REFS)} train / {len(VAL_REFS)} val "
            f"samples) in {time.perf_counter() - t0:.1f} s")
        logdir = tmp / "ckpt"
        argv = ["--data_folder", str(tmp / "train"), "--val_folder", str(tmp / "val"),
                "--gt_format", "pfm", "--logdir", str(logdir)]
        trainer, train_ds, val_ds = build(parse_args(argv + ["--epochs", str(TRAIN_EPOCHS)]))
        if (train_ds.view_num, trainer.model.num_depth, trainer.model.ndepths,
                train_ds.max_h, train_ds.max_w, trainer.optimizer.kind) != (
                VIEWS, 384, NDEPTHS, TRAIN_H, TRAIN_W, "rmsprop"):
            raise AssertionError("[train:adamvs] the CLI's defaults changed")
        timer = StepTimer(trainer.step_fn)
        trainer.step_fn = timer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        trainer.fit(lambda: train_ds.batches(1, shuffle=True),
                    lambda: val_ds.batches(1, shuffle=False))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        got = {c.__name__: c.launches for c in counters}
        n_steps = len(timer.logs)
        maps = n_steps + TRAIN_EPOCHS * len(VAL_REFS)   # steps + eval maps
        want = {c.__name__: k * maps for c, k in counters.items()}
        if n_steps != TRAIN_EPOCHS * len(TRAIN_REFS) or got != want:
            raise AssertionError(f"[train:adamvs] {n_steps} steps launched {got}, "
                                 f"expected {want}")
        losses = [l["total"] for l in timer.logs]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[train:adamvs] non-finite losses {losses}")
        names = sorted(p.name for p in logdir.iterdir() if p.name.startswith("model_"))
        if (len(names) != TRAIN_EPOCHS or not all(
                _re.fullmatch(rf"model_{e:06d}_\d+\.\d{{4}}", n)
                for e, n in enumerate(names))):
            raise AssertionError(f"[train:adamvs] checkpoint names {names}")
        split = timer.split()
        log(f"[train:adamvs] {TRAIN_EPOCHS} epochs, {n_steps} steps at {TRAIN_H}x{TRAIN_W}, "
            f"{VIEWS} views, ndepths {NDEPTHS}, num_depth 384, rmsprop lr {TRAIN_LR:g}: "
            f"fit {fit_s:.1f} s; ms a step {split['step']:.2f} = forward "
            f"{split['forward']:.2f} + backward {split['backward']:.2f} + optimizer "
            f"{split['optimizer']:.2f} (CUDA events, median of steps 3..{n_steps}); peak "
            f"memory {peak:.2f} GiB")
        log(f"[train:adamvs] loss per step: {[round(l, 4) for l in losses]}")
        log(f"[train:adamvs] checkpoints {names}; launches {got} ({maps} forwards: "
            f"{n_steps} steps + {TRAIN_EPOCHS * len(VAL_REFS)} eval maps)")

        # resume: a fresh trainer restores the last checkpoint bit for bit
        fresh, _, _ = build(parse_args(argv + ["--epochs", str(TRAIN_EPOCHS + 1)]))
        if not fresh.resume() or fresh.epoch != TRAIN_EPOCHS:
            raise AssertionError("[train:adamvs] resume found no checkpoint")
        params = dict(trainer.model.named_parameters())
        bad = [n for n, p in fresh.model.named_parameters() if not torch.equal(p, params[n])]
        a, b = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
        bad += [f"nu.{n}" for n, t in a["nu"].items() if not torch.equal(t, b["nu"][n])]
        if bad or a["count"] != b["count"]:
            raise AssertionError(f"[train:adamvs] resume differs: {bad[:5]}, count "
                                 f"{a['count']} vs {b['count']}")
        log(f"[train:adamvs] resume: a fresh trainer restores {names[-1]}: "
            f"{len(params)} parameters, the optimizer's moments and count "
            f"({a['count']}) bit for bit")
        # one more step, profiled, for the idle share (after the checks above:
        # it moves the parameters)
        busy, wall, idle = idle_share(timer, next(iter(train_ds.batches(1, shuffle=False))))
        log(f"[train:adamvs] profiled step: device busy {busy:.2f} of {wall:.2f} ms, "
            f"idle {idle:.3f}")
        del fresh, trainer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed, _ = main(argv + ["--epochs", str(TRAIN_EPOCHS + 1), "--resume"])
        names = sorted(p.name for p in logdir.iterdir() if p.name.startswith("model_"))
        if len(names) != TRAIN_EPOCHS + 1 or resumed.optimizer.count != (
                (TRAIN_EPOCHS + 1) * len(TRAIN_REFS)):
            raise AssertionError(f"[train:adamvs] --resume: {names}, count "
                                 f"{resumed.optimizer.count}")
        _, metrics = main(argv + ["--resume", "--mode", "test"])
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"[train:adamvs] --mode test metrics {metrics}")
        log(f"[train:adamvs] --resume: one more epoch, checkpoints {names}; --mode test "
            f"on the val folder: " + json.dumps({k: round(v, 5) for k, v in metrics.items()})
            + f" ({time.perf_counter() - t0:.1f} s)")
        del resumed

        # the exported params.npz as the pipeline's pretrain_weight
        ws = tmp / "ws"
        write_workspace(ws, cam, poses[:6], dev)
        npz = logdir / names[-1] / "params.npz"
        cfg = PipelineConfig(image_w=TRAIN_W, image_h=TRAIN_H, image_scale=1.0,
                             view_num=VIEWS, pretrain_weight=str(npz))
        AerialPipeline(str(ws), cfg, device=dev).dense_match()
        maps_out = sorted((ws / "dense" / "MVS").glob("*_init.pfm"))
        for p in maps_out:
            d = read_pfm(p)[0]
            if d.shape != (TRAIN_H, TRAIN_W) or not np.isfinite(d).all():
                raise AssertionError(f"[train:adamvs] {p.name} from the trained "
                                     f"params.npz: shape {d.shape}, finite "
                                     f"{np.isfinite(d).mean()}")
        if len(maps_out) != 6:
            raise AssertionError(f"[train:adamvs] dense_match wrote {len(maps_out)} maps")
        log(f"[train:adamvs] {names[-1]}/params.npz as pretrain_weight: dense_match wrote "
            f"{len(maps_out)} finite {TRAIN_H}x{TRAIN_W} depth maps")
    per_step = {k: v // maps for k, v in got.items()}
    return {"step_ms": split, "peak_gib": peak, "idle": idle, "launches": per_step}


def phase_bf16(dev, cam0, poses0, camF, posesF):
    """The bfloat16 operating point: every kernel's bfloat16 mode against
    its plain version (`[kernel:bf16]`), each model's main path to fusion in
    compute_dtype bfloat16 (`[main:bf16:<model>]`: the wrappers' counters
    set to 0 just before and read just after, each bfloat16 kernel of the
    path launched), its forward kernel vs plain (`[e2e:bf16:<model>]`), and
    one 1856x2752 AdaMVS map (`[fullres:bf16:adamvs]`). Returns the
    bfloat16 rows of the `kernels` line."""
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost, sweep_var

    t = time.perf_counter()
    records, k5, yard = phase_kernels_bf16(dev, cam0, poses0)
    log(f"[phase] kernels:bf16 {time.perf_counter() - t:.1f} s")
    N = NDEPTHS
    cases = [
        ("adamvs", (sweep_corr, sweep_cost, red_step2),
         {"sweep_corr": 1, "sweep_cost": sum(d // CHUNK for d in N), "red_step2": sum(N)}, 0),
        ("msrednet", (sweep_var, red_step4, cf_conv3x3),
         {"sweep_var": sum(d // CHUNK for d in N), "red_step4": sum(N),
          "cf_conv3x3": RED4_CONVS * sum(N)}, sum(N)),
        ("casmvsnet", (sweep_var,), {"sweep_var": sum(d // CHUNK for d in N)}, 0),
        ("ucsnet", (sweep_var,), {"sweep_var": sum(d // CHUNK for d in UCS_NDEPTHS)}, 0),
    ]
    launches = {}
    for model_type, counters, per_map, eager in cases:
        t = time.perf_counter()
        got, _, _ = phase_main_path(dev, cam0, poses0, counters, per_map,
                                    model_type=model_type, eager_updates=eager,
                                    compute_dtype="bfloat16", mesh=False)
        launches[model_type] = got
        log(f"[phase] main:bf16:{model_type} {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_end_to_end_bf16(dev, cam0, poses0, model_type)
        log(f"[phase] e2e:bf16:{model_type} {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_production_frame(dev, camF, posesF, compute_dtype="bfloat16")
    log(f"[phase] fullres:bf16:adamvs {time.perf_counter() - t:.1f} s")

    adamvs, msred = f"AdaMVS {H0}x{W0} bf16 map", f"MSREDNet {H0}x{W0} bf16 map"
    src = {"sweep_corr": ("sweep.cu", "pallas_sweep.py:235", adamvs, "adamvs"),
           "sweep_cost": ("sweep.cu", "pallas_sweep.py:520", adamvs, "adamvs"),
           "red_step2": ("red_step2.cu", "pallas_red.py:250", adamvs, "adamvs"),
           "sweep_var": ("sweep.cu", "pallas_sweep.py:520", msred, "msrednet"),
           "red_step4": ("red_step4.cu", "pallas_red4.py:138", msred, "msrednet")}
    kernels = []
    for name, (source, replaces, path, model) in src.items():
        rs = [r for r in records if r["name"] == f"{name}:bf16" and r["per_map"]]
        bms = sum(r["bound_ms"] * r["per_map"] for r in rs)
        kernels.append({
            "name": f"{name}:bf16", "route": "cuda",
            "source": f"deep3d_aerial_tpu_torch/csrc/{source}",
            "replaces": f"deep3d_aerial_tpu/ops/{replaces}",
            "launches": launches[model][name],
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["name"] == f"{name}:bf16"),
            "max_ulps": max(r["ulps"] for r in records if r["name"] == f"{name}:bf16"),
            "ms": sum(r["ms"] * r["per_map"] for r in rs),
            "plain_ms": sum(r["plain_ms"] * r["per_map"] for r in rs),
            "bound_ms": bms,
            "bound_by": max(rs, key=lambda r: r["bound_ms"] * r["per_map"])["bound_by"],
            "library_ms": None, "per_map_of": path,
        })
        if name == "red_step2":  # not a library call: the convs alone
            kernels[-1]["convs_cudnn_ms"] = yard
        if name == "sweep_var":
            kernels[-1]["launches_by_path"] = {m: launches[m]["sweep_var"]
                                               for m in ("msrednet", "casmvsnet", "ucsnet")}
    kernels.append({
        "name": "cf_conv3x3:bf16", "route": "cuda",
        "source": "deep3d_aerial_tpu_torch/csrc/red_step4.cu",
        "replaces": "deep3d_aerial_tpu/ops/pallas_cf_conv.py:150",
        "launches": launches["msrednet"]["cf_conv3x3"], "max_abs_err": k5["max_abs_err"],
        "max_ulps": k5["ulps"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "per_map_of": msred + f" (inside red_step4, {RED4_CONVS} per step)",
    })
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its bfloat16 main path")
    return kernels


# ---------------------------------------------------------------------------
# the compensated warp (warp_precision 'compensated') and depth shards
# ---------------------------------------------------------------------------


def phase_kernels_compensated(dev, cam0, poses0, camF, posesF):
    """K1, K2 and K2v in the compensated projection (the `*_comp` entries)
    against their compensated plain versions, in float32 (TOL_SWEEP,
    TOL_VAR) and bfloat16 (TOL_BF16_ULPS_SWEEP): at every stage shape of
    the 384x512 point (K1 at stage 1, K2 and K2v a chunk a stage), and K2
    and K2v at the 1856x2752 frame's full-resolution stage (checked once
    and the kernel timed, the plain version not: per_map 0). Beside each,
    the float32 projection's device ms on the same inputs
    (`float32_mode_ms`). Bounds count the chain's operations
    (GEOM_FLOPS_COMP, RAY_FLOPS_COMP). Returns the records."""
    from deep3d_aerial_tpu_torch.ops.sweep import (
        sweep_corr,
        sweep_corr_plain,
        sweep_cost,
        sweep_cost_plain,
        sweep_var,
        sweep_var_plain,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    records = []
    V1 = VIEWS - 1
    shapes = [(stage, C, D, H0 >> (2 - stage), W0 >> (2 - stage), D // CHUNK)
              for stage, (C, D) in enumerate(zip(CHANNELS, NDEPTHS))]
    shapes.append((2, CHANNELS[2], CHUNK, FULL_H, FULL_W, 0))
    with torch.no_grad():
        for stage, C, D, H, W, per_map in shapes:
            cam, poses = (cam0, poses0) if per_map else (camF, posesF)
            rel = stage_rel(cam, poses, stage, dev)
            d = stage_planes(cam, poses, stage, H, W, dev)
            wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
            ref32 = torch.randn((H, W, C), generator=g, device=dev)
            srcs32 = torch.randn((V1, H, W, C), generator=g, device=dev)
            for dt, fb in ((torch.float32, 4), (torch.bfloat16, 2)):
                ref, srcs = ref32.to(dt), srcs32.to(dt)
                bf = dt == torch.bfloat16
                suffix = ":bf16:compensated" if bf else ":compensated"
                tag = (f"{'bf16 ' if bf else ''}stage{stage + 1} {H}x{W} C{C}"
                       + ("" if per_map else " full-res"))
                cases = [("sweep_cost", sweep_cost, sweep_cost_plain, sweep_cost_work,
                          (d, wts), TOL_SWEEP, CHUNK, per_map),
                         ("sweep_var", sweep_var, sweep_var_plain, sweep_var_work,
                          (d,), TOL_VAR, CHUNK, per_map)]
                if stage == 0:
                    dpair = stage_planes(cam, poses, 0, H, W, dev, n=NDEPTHS[0])
                    cases.insert(0, ("sweep_corr", sweep_corr, sweep_corr_plain,
                                     sweep_corr_work, (dpair,), TOL_SWEEP, NDEPTHS[0], 1))
                for name, kern, plain, work, args, tol, K, pm in cases:
                    n = kern.launches_compensated

                    def kernel_fn(kern=kern, args=args):
                        return kern(ref, srcs, rel, *args, compensated=True)

                    def plain_fn(plain=plain, args=args):
                        return plain(ref, srcs, rel, *args, compensated=True)
                    # K1's plain version is ~6000 small launches a call:
                    # one call a profiler session
                    iters = 4 if name == "sweep_corr" else 10
                    if per_map:
                        compare_kernel(records, name + suffix, tag + f" V{V1} K{K}",
                                       kernel_fn, plain_fn, 0.0 if bf else tol,
                                       work(V1, K, H, W, C, fb=fb, comp=True), pm, iters,
                                       ulps=TOL_BF16_ULPS_SWEEP if bf else None)
                    else:
                        check_full_res(records, name + suffix, tag + f" V{V1} K{K}",
                                       kernel_fn, plain_fn, tol, bf,
                                       work(V1, K, H, W, C, fb=fb, comp=True))
                    if kern.launches_compensated <= n:
                        raise AssertionError(f"{name}{suffix}: no compensated launch")
                    iters = 10 if per_map else 3
                    f32_ms = device_ms(lambda kern=kern, args=args: kern(ref, srcs, rel, *args),
                                       iters)
                    records[-1]["float32_mode_ms"] = f32_ms
                    log(f"[kernel:compensated] {name + suffix} {tag}: compensated "
                        f"{records[-1]['ms']:.4f} ms, float32 projection {f32_ms:.4f} ms "
                        f"({records[-1]['ms'] / f32_ms:.2f}x) a launch")
            del ref32, srcs32, ref, srcs, wts, d
            torch.cuda.empty_cache()
    return records


def check_full_res(records, name, shape_tag, kernel_fn, plain_fn, tol, bf, work):
    """A kernel against its plain version at a full-resolution shape,
    checked once (max abs error within `tol`, or TOL_BF16_ULPS_SWEEP in
    bfloat16), the kernel's device ms timed, the plain version's not: a
    record with per_map 0 and plain_ms None."""
    out_k, out_p = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    n_ulps = bf16_ulps((out_k,), (out_p,)) if bf else None
    finite = bool(torch.isfinite(out_k).all())
    del out_k, out_p
    ms = device_ms(kernel_fn, 3)
    b_ms, b_by = bound_ms(*work)
    records.append(dict(name=name, shape=shape_tag, max_abs_err=err, ulps=n_ulps,
                        ms=ms, plain_ms=None, library_ms=None, bound_ms=b_ms,
                        bound_by=b_by, per_map=0))
    check = f"tol {tol:g}" if not bf else f"{n_ulps:.2f} bf16 ulps, tol {TOL_BF16_ULPS_SWEEP}"
    log(f"[kernel] {name:10s} {shape_tag:28s} err {err:.3e} ({check}) device ms: "
        f"kernel {ms:.4f} (plain not timed) bound {b_ms:.4f} ({b_by}, {b_ms / ms:.1%} "
        "of it reached)")
    ok = n_ulps <= TOL_BF16_ULPS_SWEEP if bf else err <= tol
    if not finite or not ok:
        raise AssertionError(f"{name} {shape_tag}: kernel vs plain max abs err {err} "
                             f"({n_ulps} bf16 ulps) over its tolerance (finite={finite})")
    if ms < b_ms:
        raise AssertionError(f"{name} {shape_tag}: {ms} ms is below its {b_ms} ms bound")


def phase_compensated(dev, cam0, poses0, camF, posesF):
    """warp_precision 'compensated': `[kernel:compensated]`, then the main
    path to fusion with every sweep launch a compensated one -- AdaMVS
    (`[main:compensated]`, K1 and K2) and CasMVSNet (K2v), each in float32
    and bfloat16 -- with AdaMVS's compensated forward kernel vs plain
    (`[e2e:compensated]`), and one 1856x2752 AdaMVS map
    (`[fullres:compensated:adamvs]`: 100% finite, its seconds, and its
    largest depth difference from the float32 projection's map on the same
    weights). Returns the compensated rows of the `kernels` line."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost, sweep_var
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    t = time.perf_counter()
    records = phase_kernels_compensated(dev, cam0, poses0, camF, posesF)
    log(f"[phase] kernel:compensated {time.perf_counter() - t:.1f} s")
    runs = {("adamvs", "float32"): ((sweep_corr, sweep_cost),
                                    {"sweep_corr": 1,
                                     "sweep_cost": sum(d // CHUNK for d in NDEPTHS)}),
            ("casmvsnet", "float32"): ((sweep_var,),
                                       {"sweep_var": sum(d // CHUNK for d in NDEPTHS)})}
    runs[("adamvs", "bfloat16")] = runs[("adamvs", "float32")]
    runs[("casmvsnet", "bfloat16")] = runs[("casmvsnet", "float32")]
    launches = {}
    for (model_type, dtype), (counters, per_map) in runs.items():
        t = time.perf_counter()
        launches[(model_type, dtype)], _, _ = phase_main_path(
            dev, cam0, poses0, counters, per_map, model_type=model_type,
            compute_dtype=dtype, mesh=False, warp_precision="compensated")
        log(f"[phase] main:compensated:{dtype}:{model_type} {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    inputs = sample(cam0, poses0, dev, ref=1)[:4]
    mk = init_random_weights(build_model("adamvs", warp_precision="compensated"),
                             seed=0).to(dev).eval()
    mp = build_model("adamvs", warp_precision="compensated", warp_impl="plain",
                     red_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    compare_forwards("e2e:compensated", mk, mp, inputs)
    del mk, mp
    log(f"[phase] e2e:compensated {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    imgs, rel, dmin, dmax, _ = sample(camF, posesF, dev, ref=1)
    maps, took = {}, 0.0
    for prec in ("float32", "compensated"):
        model = init_random_weights(build_model("adamvs", warp_precision=prec),
                                    seed=0).to(dev).eval()
        with torch.no_grad():
            maps[prec] = model(imgs, rel, dmin, dmax)["depth"]
            if prec == "compensated":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                maps[prec] = model(imgs, rel, dmin, dmax)["depth"]
                torch.cuda.synchronize()
                took = time.perf_counter() - t0
        del model
    depth = maps["compensated"]
    finite = float(torch.isfinite(depth).float().mean())
    diff = (depth - maps["float32"]).abs()
    log(f"[fullres:compensated:adamvs] {FULL_H}x{FULL_W} f={camF.fx:.1f}: "
        f"{tuple(depth.shape)}, finite {finite * 100:.4f}% of pixels, {took:.3f} s per "
        f"map; depth against the float32 projection's map: max |diff| "
        f"{float(diff.max()):.4e} m, median {float(diff.median()):.4e} m, "
        f"{float((diff > 1e-3).float().mean()) * 100:.3f}% of pixels over 1e-3 m")
    if tuple(depth.shape) != (FULL_H, FULL_W) or finite != 1.0:
        raise AssertionError(f"fullres:compensated map: shape {tuple(depth.shape)}, "
                             f"finite share {finite}")
    del maps, depth, diff
    torch.cuda.empty_cache()
    log(f"[phase] fullres:compensated:adamvs {time.perf_counter() - t:.1f} s")

    paths = {"sweep_corr": ("adamvs", f"AdaMVS {H0}x{W0}"),
             "sweep_cost": ("adamvs", f"AdaMVS {H0}x{W0}"),
             "sweep_var": ("casmvsnet", f"CasMVSNet {H0}x{W0}")}
    kernels = []
    for dtype, suffix in (("float32", ":compensated"), ("bfloat16", ":bf16:compensated")):
        for name, (model_type, path) in paths.items():
            rs = [r for r in records if r["name"] == name + suffix]
            main = [r for r in rs if r["per_map"]]
            row = {
                "name": name + suffix, "route": "cuda",
                "source": "deep3d_aerial_tpu_torch/csrc/sweep.cu",
                "replaces": "deep3d_aerial_tpu/ops/pallas_sweep.py:"
                            + ("235" if name == "sweep_corr" else "520"),
                "launches": launches[(model_type, dtype)][name],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] * r["per_map"] for r in main),
                "plain_ms": sum(r["plain_ms"] * r["per_map"] for r in main),
                "bound_ms": sum(r["bound_ms"] * r["per_map"] for r in main),
                "bound_by": max(main, key=lambda r: r["bound_ms"] * r["per_map"])["bound_by"],
                "library_ms": None,
                "float32_mode_ms": sum(r["float32_mode_ms"] * r["per_map"] for r in main),
                "per_map_of": f"{path} {'bf16 ' if dtype == 'bfloat16' else ''}map, "
                              "warp_precision compensated",
            }
            if dtype == "bfloat16":
                row["max_ulps"] = max(r["ulps"] for r in rs)
            if row["launches"] <= 0:
                raise AssertionError(f"{row['name']}: no launch on its compensated main path")
            kernels.append(row)
    return kernels


SHARD_COUNTERS = {"adamvs": ("sweep_corr", "sweep_cost", "red_step2"),
                  "msrednet": ("sweep_var", "red_step4", "cf_conv3x3"),
                  "casmvsnet": ("sweep_var",), "ucsnet": ("sweep_var",)}


def phase_shards(dev, cam0, poses0, model_type):
    """`[shards:<model>]`: the model at depth_shards 2 (384x512, published
    widths, seeded weights) through the kernels against its plain versions
    (the forward limits; the volume models by check_volume_forwards), its
    kernel launches a forward equal to depth_shards 1's, and the seconds a
    map beside depth_shards 1's (host clock through a synchronize, median
    of 3 after a warm forward, alternating)."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.ops import cf_conv, red_step2, red_step4, sweep
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    wrappers = {"sweep_corr": sweep.sweep_corr, "sweep_cost": sweep.sweep_cost,
                "sweep_var": sweep.sweep_var, "red_step2": red_step2.red_step2,
                "red_step4": red_step4.red_step4, "cf_conv3x3": cf_conv.cf_conv3x3}
    counters = [wrappers[n] for n in SHARD_COUNTERS[model_type]]
    inputs = sample(cam0, poses0, dev, ref=1)[:4]
    models = {n: build_model(model_type, depth_shards=n).to(dev).eval() for n in (1, 2)}
    init_random_weights(models[2], seed=0)
    models[1].load_state_dict(models[2].state_dict())
    plain = {"warp_impl": "plain"}
    if model_type in ("adamvs", "msrednet"):
        plain["red_impl"] = "plain"
    mp = build_model(model_type, depth_shards=2, **plain).to(dev).eval()
    mp.load_state_dict(models[2].state_dict())
    tag = f"shards:{model_type}"
    if model_type in ("casmvsnet", "ucsnet"):
        check_volume_forwards(tag, model_type, models[2], mp, inputs)
    else:
        compare_forwards(tag, models[2], mp, inputs)
    del mp
    launches, secs = {}, {1: [], 2: []}
    with torch.no_grad():
        for n in (1, 2):
            before = [c.launches for c in counters]
            models[n](*inputs)
            torch.cuda.synchronize()
            launches[n] = {c.__name__: c.launches - b for c, b in zip(counters, before)}
        for _ in range(3):
            for n in (1, 2):
                t0 = time.perf_counter()
                models[n](*inputs)
                torch.cuda.synchronize()
                secs[n].append(time.perf_counter() - t0)
    med = {n: float(np.median(v)) for n, v in secs.items()}
    log(f"[{tag}] depth_shards 2 at {H0}x{W0}, ndepths {models[2].ndepths}: launches a "
        f"forward {json.dumps(launches[2])} (depth_shards 1: {json.dumps(launches[1])}); "
        f"seconds a map (median of 3) {med[2]:.4f} against {med[1]:.4f} "
        f"({med[2] / med[1]:.3f}x)")
    if launches[2] != launches[1] or not all(launches[2].values()):
        raise AssertionError(f"{tag}: launches {launches[2]} against {launches[1]}")
    return med


# ---------------------------------------------------------------------------
# every channel count: the widths a base width other than 8 gives the kernels
# ---------------------------------------------------------------------------

# (wrapper, C, stage): the sweeps at the new instances' widths (4 and 64)
# and at one width of the runtime-C path (12), each at the stage of the
# 384x512 point where a model reaches it: C = 4b at stage 1 (b = 16, 3),
# C = b at stage 3 (b = 4). K1 takes C = 4b, and no model takes a base
# below 2 (the JAX AdaMVS at base 1 raises in its initializer), so K1 at
# C = 4 is checked and timed but launched by no forward: it has no row in
# the kernels line.
WIDTH_SWEEPS = (("sweep_corr", 64, 0), ("sweep_corr", 12, 0), ("sweep_corr", 4, 0),
                ("sweep_cost", 64, 0), ("sweep_cost", 12, 0), ("sweep_cost", 4, 2),
                ("sweep_var", 64, 0), ("sweep_var", 12, 0), ("sweep_var", 4, 2))
# the base widths whose AdaMVS and MSREDNet forwards count those launches
WIDTH_BASES = (16, 3, 4)
# K3 at Cin 64 (AdaMVS base 16, stage 1: conv1 in two chunks of 32) and at
# Cin 4 (base 4, stage 3: zero planes up to 8)
WIDTH_RED2 = ((64, 0), (4, 2))
# MSREDNet at base 16: K4 (base 8, as the JAX package builds it) and K5 at
# the cost widths 64, 32, 16
WIDTH_MSRED = (64, 32, 16)
WIDTH_ITERS = 10
# DeformConv2d and depth_from_normal, card against CPU: 1e-5 (relative for
# depth_from_normal). Both are plain gathers and elementwise ops, but
# DeformConv2d's offset, mask and 1x1 convs sum in another order in cuDNN
# (run under cudnn.deterministic, no TF32) than on the CPU, and an offset's
# rounding moves its bilinear taps along the image's gradient. So where
# float32 itself is farther from exact than 1e-5 allows, the card is held
# to CARD_CPU_GAP_FACTOR x the CPU's own float32 distance to the same
# module in float64, measured in the same run (the rule of BF16_GAP_FACTOR)
TOL_CARD_CPU = 1e-5
CARD_CPU_GAP_FACTOR = 2.0


def width_base(C, stage):
    """The base width b whose model gives a kernel C channels at `stage`."""
    return C // 4 if stage == 0 else C


def phase_widths(dev, cam0, poses0):
    """`[widths]`: the kernels at the channel counts of base widths other
    than 8, and the modules no earlier phase runs. AdaMVS and MSREDNet
    forwards at base 16, 3 and 4 (384x512, float32 and bfloat16), each
    with its wrappers' counters set to 0 just before it and read just
    after (per channel count, `launches_by_width`), each against its plain
    forward (same weights; bfloat16 within BF16_GAP_FACTOR x the plain
    bfloat16 vs float32 distance, as `[e2e:bf16:*]`); CasMVSNet with norm 'batch'
    (non-trivial statistics) and 'layer', kernels against plain;
    DeformConv2d and depth_from_normal on the card against the CPU; then
    K1/K2/K2v at C 64, 12 and 4 (float32 and bfloat16, timed, then each
    once in the compensated projection), K3 at Cin 64 and 4
    (score entry and softmax fold), K4 and K5 at MSREDNet base 16's cost
    widths, each against its plain version and timed. Returns the width
    rows of the `kernels` line (per map of the forward that launches the
    width)."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.models.blocks import BatchNorm, DeformConv2d
    from deep3d_aerial_tpu_torch.models.cascade import OnlineSoftmaxState
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
    from deep3d_aerial_tpu_torch.ops import normals
    from deep3d_aerial_tpu_torch.ops import sweep as sw
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2, red_step2_plain
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4, red_step4_plain
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    t0 = time.perf_counter()
    wrappers = {"sweep_corr": sw.sweep_corr, "sweep_cost": sw.sweep_cost,
                "sweep_var": sw.sweep_var, "red_step2": red_step2, "red_step4": red_step4}
    paths = {"adamvs": ("sweep_corr", "sweep_cost", "red_step2"),
             "msrednet": ("sweep_var", "red_step4")}
    imgs, rel, dmin, dmax, ref_depth = sample(cam0, poses0, dev, ref=1)
    inputs = (imgs, rel, dmin, dmax)

    # the forwards: launches by channel count, each base and dtype
    seen, k5_launches = {}, {}
    for model_type, names in paths.items():
        for b in WIDTH_BASES:
            for dt in ("float32", "bfloat16"):
                mk = init_random_weights(build_model(model_type, base_channels=b,
                                                     dtype=getattr(torch, dt)),
                                         seed=b).to(dev).eval()
                for n in names:
                    wrappers[n].launches = 0
                    wrappers[n].launches_by_width.clear()
                cf_conv3x3.launches = 0
                with torch.no_grad():
                    out = mk(*inputs)
                torch.cuda.synchronize()
                got = {n: dict(wrappers[n].launches_by_width) for n in names}
                total = {n: wrappers[n].launches for n in names}
                k5_launches[(model_type, b, dt)] = cf_conv3x3.launches
                seen[(model_type, b, dt)] = got
                log(f"[widths] {model_type} base {b} {dt} {H0}x{W0}: launches by "
                    f"channel count " + json.dumps({n: {str(c): k for c, k in sorted(v.items())}
                                                    for n, v in got.items()})
                    + (f", cf_conv3x3 {cf_conv3x3.launches}" if model_type == "msrednet" else ""))
                if any(total[n] <= 0 or sum(got[n].values()) != total[n] for n in names):
                    raise AssertionError(f"widths {model_type} base {b} {dt}: launches "
                                         f"{total}, by width {got}")
                # the same forward through the plain versions (same weights)
                outs = {"kernel": out}
                with torch.no_grad():
                    for pn, pdt in (("plain", dt), ("plain32", "float32")):
                        if pn == "plain32" and dt == "float32":
                            continue
                        mp = build_model(model_type, base_channels=b, dtype=getattr(torch, pdt),
                                         warp_impl="plain", red_impl="plain").to(dev).eval()
                        mp.load_state_dict(mk.state_dict())
                        outs[pn] = mp(*inputs)
                        del mp
                tag = f"widths:{model_type}:base{b}:{dt}"
                if dt == "float32":
                    hold_forward(tag, outs["kernel"], outs["plain"], dmin, dmax)
                else:
                    hold_bf16_forward(tag, outs, dmin, dmax)
                del mk, out, outs
    log(f"[widths] forwards {time.perf_counter() - t0:.1f} s")

    # CasMVSNet with the 'batch' and 'layer' norms, K2v against plain
    for norm in ("batch", "layer"):
        mk = init_random_weights(build_model("casmvsnet", norm=norm), seed=3)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for m in mk.modules():
                if isinstance(m, BatchNorm):
                    m.mean.copy_(torch.randn(m.mean.shape, generator=gen) * 0.3)
                    m.var.copy_(torch.rand(m.var.shape, generator=gen) * 1.5 + 0.5)
        mk = mk.to(dev).eval()
        mp = build_model("casmvsnet", norm=norm, warp_impl="plain").to(dev).eval()
        mp.load_state_dict(mk.state_dict())
        sw.sweep_var.launches = 0
        check_volume_forwards(f"widths:casmvsnet:{norm}", "casmvsnet", mk, mp, inputs)
        log(f"[widths] casmvsnet norm '{norm}': {sw.sweep_var.launches} sweep_var launches")
        if sw.sweep_var.launches <= 0:
            raise AssertionError(f"casmvsnet norm {norm}: no sweep_var launch")
        del mk, mp

    # DeformConv2d and depth_from_normal, the card against the CPU
    x = imgs[0].permute(2, 0, 1)[None].float().cpu()
    dc = init_random_weights(DeformConv2d(3, 8), seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for conv in (dc.p_conv, dc.m_conv):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.3)
        off = dc.p_conv(x)
        want = dc(x)
        want64 = copy.deepcopy(dc).double()(x.double())
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            got = dc.to(dev)(x.to(dev)).cpu()
        finally:
            torch.backends.cudnn.deterministic = deterministic
    err = float((got - want).abs().max())
    gap = float((want.double() - want64).abs().max())
    err64 = float((got.double() - want64).abs().max())
    tol = max(TOL_CARD_CPU, CARD_CPU_GAP_FACTOR * gap)
    log(f"[widths] DeformConv2d 3->8 at {H0}x{W0}, offsets up to "
        f"{float(off.abs().max()):.2f} px, largest |value| {float(want.abs().max()):.3f}: "
        f"card vs CPU max |diff| {err:.3e} (tol {tol:.3e}); against float64 on the CPU: "
        f"card {err64:.3e}, CPU float32 {gap:.3e}")
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"DeformConv2d card vs CPU {err} > {tol}")
    cam = cam0
    K = torch.tensor(cam.K, dtype=torch.float32)
    depth = ref_depth.float().cpu()
    normal = normals.normals_from_depth(depth, torch.linalg.inv(K))
    gray = imgs[0].mean(-1).float().cpu()
    want = normals.depth_from_normal(depth, normal, K, gray)
    got = normals.depth_from_normal(depth.to(dev), normal.to(dev), K.to(dev),
                                    gray.to(dev)).cpu()
    wgot = normals.depth_gradient_weights(gray.to(dev)).cpu()
    werr = float((wgot - normals.depth_gradient_weights(gray)).abs().max())
    rel_err = float(((got - want).abs() / want.abs()).max())
    log(f"[widths] depth_from_normal at {H0}x{W0}: card vs CPU max relative "
        f"diff {rel_err:.3e}, edge weights max |diff| {werr:.3e} (tol {TOL_CARD_CPU:g})")
    if not (rel_err <= TOL_CARD_CPU and werr <= TOL_CARD_CPU):
        raise AssertionError(f"depth_from_normal card vs CPU {rel_err}, weights {werr}")
    log(f"[widths] modules {time.perf_counter() - t0:.1f} s")

    # the kernels at the new widths, against their plain versions
    g = torch.Generator(device=dev).manual_seed(13)
    records = []
    V1 = VIEWS - 1

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    plains = {"sweep_corr": sw.sweep_corr_plain, "sweep_cost": sw.sweep_cost_plain,
              "sweep_var": sw.sweep_var_plain}
    works = {"sweep_corr": sweep_corr_work, "sweep_cost": sweep_cost_work,
             "sweep_var": sweep_var_work}
    for name, C, stage in WIDTH_SWEEPS:
        H, W = H0 >> (2 - stage), W0 >> (2 - stage)
        rel_s = stage_rel(cam0, poses0, stage, dev)
        K = NDEPTHS[0] if name == "sweep_corr" else CHUNK
        d = stage_planes(cam0, poses0, stage, H, W, dev, n=K)
        wts = torch.rand((V1, H, W), generator=g, device=dev) * 0.9 + 0.1
        extra = (wts,) if name == "sweep_cost" else ()
        model = "msrednet" if name == "sweep_var" else "adamvs"
        b = width_base(C, stage)
        for dt in (torch.float32, torch.bfloat16):
            bf = dt == torch.bfloat16
            ref, srcs = rnd(H, W, C).to(dt), rnd(V1, H, W, C).to(dt)
            kern, plain = wrappers[name], plains[name]
            per_map = seen.get((model, b, "bfloat16" if bf else "float32"),
                               {}).get(name, {}).get(C, 0)
            compare_kernel(
                records, f"{name}:C{C}" + (":bf16" if bf else ""),
                f"stage{stage + 1} {H}x{W} C{C} V{V1} K{K}",
                lambda: kern(ref, srcs, rel_s, d, *extra),
                lambda: plain(ref, srcs, rel_s, d, *extra), TOL_SWEEP,
                works[name](V1, K, H, W, C, fb=2 if bf else 4), per_map, WIDTH_ITERS,
                ulps=TOL_BF16_ULPS_SWEEP if bf else None)
            records[-1].update(model=model, base=b, stage=stage, C=C)
            # the compensated projection at the same width, checked once
            nc = kern.launches_compensated
            with torch.no_grad():
                got = kern(ref, srcs, rel_s, d, *extra, compensated=True)
                want = plain(ref, srcs, rel_s, d, *extra, compensated=True)
            err = float((got.float() - want.float()).abs().max())
            n_ulps = bf16_ulps((got,), (want,)) if bf else None
            finite = bool(torch.isfinite(got).all())
            log(f"[widths] {name}:C{C}{':bf16' if bf else ''} compensated: kernel vs plain "
                f"max |diff| {err:.3e} (" + (f"{n_ulps:.2f} bf16 ulps, tol "
                                             f"{TOL_BF16_ULPS_SWEEP})" if bf else
                                             f"tol {TOL_SWEEP:g})"))
            ok = n_ulps <= TOL_BF16_ULPS_SWEEP if bf else err <= TOL_SWEEP
            if not (finite and ok and kern.launches_compensated == nc + 1):
                raise AssertionError(f"{name} C{C} {dt} compensated: {err} ({n_ulps} ulps), "
                                     f"finite {finite}, launches "
                                     f"{kern.launches_compensated - nc}")
            del got, want
    log(f"[widths] sweeps {time.perf_counter() - t0:.1f} s")

    for C, stage in WIDTH_RED2:
        H, W, up = H0 >> (2 - stage), W0 >> (2 - stage), stage < 2
        b = width_base(C, stage)
        mod = init_random_weights(RedStep2(C, up=up), seed=C).to(dev)
        params, packed = dict(mod.named_parameters()), mod._packed_params()
        cost, s1 = rnd(C, H, W), rnd(8, H, W, scale=0.5)
        s2 = rnd(16, (H + 1) // 2, (W + 1) // 2, scale=0.5)
        n_w = sum(p.numel() for p in params.values())
        shape = (2 * H, 2 * W) if up else (H, W)
        costs = [rnd(C, H, W) for _ in range(3)]
        dvs = [torch.full(shape, 100.0 + k, device=dev) for k in range(3)]

        def planes(fold, osm):
            a, c = s1, s2
            for cst, dv in zip(costs, dvs):
                if fold:
                    _, a, c = red_step2(params, cst, a, c, up=up, packed=packed, osm=osm, dv=dv)
                else:
                    sc, a, c = red_step2_plain(params, cst, a, c, up=up)
                    osm = OnlineSoftmaxState.update(osm, sc, dv)
            return osm, a, c

        def checked(fold):
            (m, s, acc, pmax), a, c = planes(fold, OnlineSoftmaxState.init(shape, device=dev))
            return m, s, acc / 102.0, pmax, a, c  # acc sums e * depth

        osm_t = OnlineSoftmaxState.init(shape, device=dev)
        tag = f"stage{stage + 1} {H}x{W} Cin{C}" + (" up" if up else "")
        per_map = seen[("adamvs", b, "float32")]["red_step2"].get(C, 0)
        with torch.no_grad():
            compare_kernel(records, f"red_step2:Cin{C}", tag + " score entry",
                           lambda: red_step2(params, cost, s1, s2, up=up, packed=packed),
                           lambda: red_step2_plain(params, cost, s1, s2, up=up),
                           TOL_RED, red_step2_work(C, H, W, up, n_w), 0, WIDTH_ITERS,
                           conv=True)
            compare_kernel(records, f"red_step2:Cin{C}", tag + " softmax fold",
                           lambda: checked(True), lambda: checked(False), TOL_RED,
                           red_step2_work(C, H, W, up, n_w, fold=True), per_map,
                           WIDTH_ITERS, n_calls=3, conv=True,
                           time_fns=(lambda: planes(True, osm_t), lambda: planes(False, osm_t)))
        records[-1].update(model="adamvs", base=b, stage=stage, C=C)

    msred = seen[("msrednet", 16, "float32")]["red_step4"]
    for stage, C in enumerate(WIDTH_MSRED):
        H, W = H0 >> (2 - stage), W0 >> (2 - stage)
        mod = init_random_weights(RedStep4(C), seed=C).to(dev)
        params, packed = dict(mod.named_parameters()), mod._packed.get(mod)
        costs = [rnd(C, H, W) for _ in range(3)]
        s0 = [rnd(c, H >> l, W >> l, scale=0.5) for l, c in enumerate((8, 16, 32, 64))]
        n_w = sum(p.numel() for p in params.values())

        def chain(step):
            states = s0
            for cst in costs:
                score, *states = step(cst, *states)
            return (score, *states)

        with torch.no_grad():
            compare_kernel(records, "red_step4:base16",
                           f"stage{stage + 1} {H}x{W} Cin{C} 3 planes",
                           lambda: chain(lambda *a: red_step4(params, *a, packed=packed)),
                           lambda: chain(lambda *a: red_step4_plain(params, *a)),
                           TOL_RED4, red_step4_work(C, H, W, n_w), msred.get(C, 0), 5,
                           n_calls=3, conv=True)
    k5 = k5_per_map(rnd, WIDTH_MSRED, [],
                    f"MSREDNet(base_channels=16) {H0}x{W0} map (Cin {WIDTH_MSRED})")
    torch.cuda.empty_cache()
    log(f"[widths] kernels {time.perf_counter() - t0:.1f} s")

    # the rows: per map of the forward that launches each width
    src = {"sweep_corr": ("sweep.cu", "pallas_sweep.py:235"),
           "sweep_cost": ("sweep.cu", "pallas_sweep.py:520"),
           "sweep_var": ("sweep.cu", "pallas_sweep.py:520"),
           "red_step2": ("red_step2.cu", "pallas_red.py:250"),
           "red_step4": ("red_step4.cu", "pallas_red4.py:138")}
    names = {"adamvs": "AdaMVS", "msrednet": "MSREDNet"}
    kernels = []
    for row in dict.fromkeys(r["name"] for r in records):
        rs = [r for r in records if r["name"] == row]
        main = [r for r in rs if r["per_map"]]
        kernel = row.split(":")[0]
        bf = row.endswith(":bf16")
        if not main:
            log(f"[widths] {row}: no forward launches it (no row in the kernels line)")
            continue
        if kernel == "red_step4":
            launches, path = sum(msred.values()), (f"MSREDNet(base_channels=16) {H0}x{W0} "
                                                   f"map, Cin {WIDTH_MSRED}")
        else:
            r0 = main[0]
            C = r0["C"]
            launches = seen[(r0["model"], r0["base"], "bfloat16" if bf else "float32")][
                kernel].get(C, 0)
            path = (f"{names[r0['model']]}(base_channels={r0['base']}) {H0}x{W0} "
                    f"{'bf16 ' if bf else ''}map, C{C} at stage {r0['stage'] + 1}")
        kernels.append({
            "name": row, "route": "cuda",
            "source": f"deep3d_aerial_tpu_torch/csrc/{src[kernel][0]}",
            "replaces": f"deep3d_aerial_tpu/ops/{src[kernel][1]}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] * r["per_map"] for r in main),
            "plain_ms": sum(r["plain_ms"] * r["per_map"] for r in main),
            "bound_ms": sum(r["bound_ms"] * r["per_map"] for r in main),
            "bound_by": max(main, key=lambda r: r["bound_ms"] * r["per_map"])["bound_by"],
            "library_ms": None, "per_map_of": path,
        })
        if bf:
            kernels[-1]["max_ulps"] = max(r["ulps"] for r in rs)
    kernels.append({
        "name": "cf_conv3x3:base16", "route": "cuda",
        "source": "deep3d_aerial_tpu_torch/csrc/red_step4.cu",
        "replaces": "deep3d_aerial_tpu/ops/pallas_cf_conv.py:150",
        "launches": k5_launches[("msrednet", 16, "float32")],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "per_map_of": f"MSREDNet(base_channels=16) {H0}x{W0} map (inside red_step4, "
                      f"{RED4_CONVS} per step; gru1 at ci = Cin + 8)",
    })
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its forward")
    log(f"[phase] widths {time.perf_counter() - t0:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# multi-card: dp x sp (parallel/) and the multi-host driver
# ---------------------------------------------------------------------------

# planes a sharded rank takes a kernel launch (the streaming sweep's chunk
# and the volume's: the largest divisor of a block's planes up to 8)
PARALLEL_MODELS = ("adamvs", "casmvsnet")
PARALLEL_STEPS = 3


def parallel_layout():
    """(backend, dp, sp, note): sp 2 and dp the card pairs (up to 4 cards)
    on NCCL, one rank a card; on one card two gloo ranks sharing cuda:0."""
    n = torch.cuda.device_count()
    if n >= 2:
        return "nccl", min(2, n // 2), 2, f"NCCL, one rank a card, {n} card(s)"
    return "gloo", 1, 2, ("gloo, both ranks on cuda:0 (1 card): its times are no "
                          "collective times")


def rank_launches():
    from deep3d_aerial_tpu_torch.ops import red_step2, sweep

    return {f.__name__: f.launches for f in (sweep.sweep_corr, sweep.sweep_cost,
                                             sweep.sweep_var, red_step2.red_step2)}


def sharded_launches(name):
    """A rank's launches a map at sp 2 and depth_shards 2: K1 once, K3 once
    a plane of its block (half a map's), K2 and K2v once a chunk of its
    block (the largest divisor of D/2 up to 8 planes: half a map's at
    stages of 48 and 32 planes, one launch of 4 planes at the 8-plane
    stage, where one process takes one launch of 8)."""
    from deep3d_aerial_tpu_torch.models.cascade import largest_divisor

    chunks = sum(d // 2 // largest_divisor(d // 2, CHUNK) for d in NDEPTHS)
    return {"adamvs": dict(sweep_corr=1, sweep_cost=chunks, sweep_var=0,
                           red_step2=sum(NDEPTHS) // 2),
            "casmvsnet": dict(sweep_corr=0, sweep_cost=0, sweep_var=chunks,
                              red_step2=0)}[name]


def parallel_rank(dev, path, dp, sp):
    """One rank of [parallel:infer] and [parallel:train] (spawned by
    parallel.launch.spawn): the sharded infer step of each model on the
    whole batch (launches, seconds a call, the gathers' ms), then
    PARALLEL_STEPS sharded AdaMVS train steps on this rank's share (the
    first one's logs, gradients and parameters; ms a step and of its
    all-reduce from CUDA events at the step's marks)."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.parallel import make_mesh, shard_batch
    from deep3d_aerial_tpu_torch.parallel.context import gather_rows
    from deep3d_aerial_tpu_torch.parallel.train_step import make_infer_step, make_train_step
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = torch.load(path, weights_only=False)
    batch = data["batch"]
    mesh = make_mesh({"dp": dp, "sp": sp})
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev)}
    args = [batch[k] for k in ("imgs", "rel_projs", "depth_min", "depth_max")]
    for name in PARALLEL_MODELS:
        model = build_model(name, depth_shards=2).to(dev).eval()
        model.load_state_dict(data["weights"][name])
        infer = make_infer_step(model, mesh)
        mesh.gathered.clear()
        before = rank_launches()
        res = infer(*args)
        torch.cuda.synchronize(dev)
        launches = {k: v - before[k] for k, v in rank_launches().items()}
        gathers = dict(mesh.gathered)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            infer(*args)
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
        gather_ms = 0.0
        for (axis, shape, dtype), count in gathers.items():
            rows = torch.zeros(shape, dtype=dtype, device=dev)
            times = []
            for _ in range(6):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                gather_rows(rows, mesh, axis)
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
            gather_ms += count * float(np.median(times[1:])) * 1e3
        out[name] = {"out": {k: v.cpu() for k, v in res.items()}, "launches": launches,
                     "secs": float(np.median(secs)), "gathers": sum(gathers.values()),
                     "gather_ms": gather_ms}
        del model, infer, res

    model = build_model("adamvs", depth_shards=2).to(dev)
    model.load_state_dict(data["weights"]["train"])
    opt = make_optimizer(model.named_parameters(), TRAIN_LR)
    grads = {}
    update = opt.step

    def first_grads(g):
        if not grads:
            grads.update({n: t.detach().cpu().clone() for n, t in g.items()})
        update(g)
    opt.step = first_grads
    timer = StepTimer(make_train_step(model, opt, pair_weight=1.0, mesh=mesh))
    share = shard_batch(batch, mesh)
    for i in range(PARALLEL_STEPS):
        logs = timer(share)
        if i == 0:
            out["train"] = {"logs": logs, "grads": dict(grads), "params": {
                n: p.detach().cpu().clone() for n, p in model.named_parameters()}}
    out["train"]["split"] = timer.split(skip=1)
    return out


def phase_parallel(dev, cam0, poses0, smi):
    """[parallel:infer] and [parallel:train]: make_infer_step at the
    384x512 operating point (5 views, 48/32/8, 384 hypotheses, seeded
    weights, depth_shards 2) of AdaMVS (K1, K2, K3) and CasMVSNet (K2v,
    CostRegNet3D) on a dp x sp mesh (parallel_layout) against the
    one-process forward of the same batch on cuda:0 (depth within
    TOL_DEPTH_FRAC of the range, confidence within TOL_CONF; exact equality
    reported: under cudnn.deterministic a rank repeats the one-process
    arithmetic of its blocks); each rank's launches against the rule (K1
    once a map, K3 half a map's, K2 and K2v a launch a chunk of the rank's
    block), seconds a map beside one card's, the gathers' ms. Then one
    sharded AdaMVS train step through the kernels' autograd Functions
    against the one-process step on the same global batch ([train:step]'s
    limits on the loss, the gradients and the parameters after the
    update), every rank's parameters equal bit for bit; ms a step and of
    its all-reduce. Returns the first rank's launches a map by model."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.parallel.launch import spawn
    from deep3d_aerial_tpu_torch.parallel.train_step import make_infer_step
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer
    from deep3d_aerial_tpu_torch.train.step import make_train_step
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    backend, dp, sp, note = parallel_layout()
    ranks = dp * sp
    where = f"{ranks} ranks dp {dp} x sp {sp}, {note}; {smi}"
    samples = [sample(cam0, poses0, dev, ref=r) for r in range(dp)]
    batch = {"imgs": np.stack([s[0].cpu().numpy() for s in samples]),
             "rel_projs": np.stack([s[1].cpu().numpy() for s in samples]),
             "depth_min": np.array([s[2] for s in samples], np.float32),
             "depth_max": np.array([s[3] for s in samples], np.float32),
             "depth_gt": np.stack([s[4].cpu().numpy() for s in samples]),
             "mask": np.stack([(s[4] > 0).float().cpu().numpy() for s in samples])}
    weights = {n: init_random_weights(build_model(n, depth_shards=2), seed=0).state_dict()
               for n in PARALLEL_MODELS}
    weights["train"] = train_model("adamvs", depth_shards=2).state_dict()
    args = [batch[k] for k in ("imgs", "rel_projs", "depth_min", "depth_max")]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = {}
        for name in PARALLEL_MODELS:
            model = build_model(name, depth_shards=2).to(dev).eval()
            model.load_state_dict(weights[name])
            infer = make_infer_step(model)
            before = rank_launches()
            res = infer(*args)
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in rank_launches().items()}
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                infer(*args)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            one[name] = {"out": {k: v.cpu() for k, v in res.items()}, "launches": launches,
                         "secs": float(np.median(secs))}
            del model, infer, res
        model = build_model("adamvs", depth_shards=2).to(dev)
        model.load_state_dict(weights["train"])
        opt = make_optimizer(model.named_parameters(), TRAIN_LR)
        grads = {}
        update = opt.step
        opt.step = lambda g: grads.update({n: t.detach().cpu().clone()
                                           for n, t in g.items()}) or update(g)
        logs1 = make_train_step(model, opt, pair_weight=1.0)(batch)
        params1 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        # the gradient's conditioning, as [train:step:*] measures it: the
        # same step on images scaled by (1 + 2^-22)
        model.load_state_dict(weights["train"])
        opt = make_optimizer(model.named_parameters(), TRAIN_LR)
        nudged = {}
        update = opt.step
        opt.step = lambda g: nudged.update({n: t.detach().cpu().clone()
                                            for n, t in g.items()}) or update(g)
        make_train_step(model, opt, pair_weight=1.0)(
            dict(batch, imgs=batch["imgs"] * np.float32(1 + 2.0 ** -22)))
        del model, opt
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "parallel.pt")
        torch.save({"batch": batch, "weights": weights}, path)
        t0 = time.perf_counter()
        recs = spawn(parallel_rank, ranks, path, dp, sp, device="cuda", backend=backend)
        spawn_s = time.perf_counter() - t0

    per_rank = {}
    for name in PARALLEL_MODELS:
        full = one[name]["launches"]
        maps_a_rank = len(samples) // dp
        want = {k: v * maps_a_rank for k, v in sharded_launches(name).items()}
        exact, dd, dc = True, 0.0, 0.0
        for rec in recs:
            got = rec[name]
            if got["launches"] != want:
                raise AssertionError(f"[parallel:infer:{name}] rank {rec['rank']} launched "
                                     f"{got['launches']}, expected {want}")
            for b, s in enumerate(samples):
                dtol = TOL_DEPTH_FRAC * (s[3] - s[2])
                a, r = got["out"]["depth"][b], one[name]["out"]["depth"][b]
                ca, cr = (got["out"]["photometric_confidence"][b],
                          one[name]["out"]["photometric_confidence"][b])
                exact = exact and torch.equal(a, r) and torch.equal(ca, cr)
                dd, dc = max(dd, float((a - r).abs().max())), max(dc, float((ca - cr).abs().max()))
                if not (torch.isfinite(a).all() and dd <= dtol and dc <= TOL_CONF):
                    raise AssertionError(f"[parallel:infer:{name}] rank {rec['rank']} map {b}: "
                                         f"depth {dd} (tol {dtol}), conf {dc}")
        r0 = recs[0][name]
        per_rank[name] = {k: v // maps_a_rank for k, v in r0["launches"].items() if v}
        log(f"[parallel:infer:{name}] {where}: {len(samples)} map(s) at {H0}x{W0}, "
            f"{VIEWS} views, ndepths {NDEPTHS}, depth_shards 2: every rank holds the "
            f"batch's depth and confidence, against one process on cuda:0 depth max |diff| "
            f"{dd:.3e} m, confidence {dc:.3e} ({'bit-equal' if exact else 'not bit-equal'} "
            f"under cudnn.deterministic); launches a map on each rank "
            f"{json.dumps(per_rank[name])} against one process's "
            f"{json.dumps({k: v // len(samples) for k, v in full.items() if v})} (half the "
            f"planes a rank); seconds a map: sharded {r0['secs'] / maps_a_rank:.4f} "
            f"(rank 0, host clock through a sync, median of 3) against one card's "
            f"{one[name]['secs'] / len(samples):.4f}; {r0['gathers']} gathers a call, "
            f"{r0['gather_ms']:.3f} ms of gathers a call (each shape timed alone, "
            f"median of 5)")

    scale = max(float(g.abs().max()) for g in grads.values())
    tr = recs[0]["train"]
    loss_err = max(abs(tr["logs"][k] - logs1[k]) / max(abs(logs1[k]), 1e-30) for k in logs1)

    def rel(a):
        return {n: float((a[n] - g).abs().max()) / (float(g.abs().max()) + 1e-3 * scale)
                for n, g in grads.items()}
    rk, ru = rel(tr["grads"]), rel(nudged)
    worst = max(rk, key=rk.get)
    allowed = max(TOL_STEP_GRAD, STEP_COND * max(ru.values()))

    def u(x):
        return x / torch.sqrt(0.1 * x * x + 1e-8)
    param_err = 0.0
    for n, g in grads.items():
        d = allowed * (float(g.abs().max()) + 1e-3 * scale)
        atol = TRAIN_LR * (u(g + d) - u(g - d)) + 1e-6
        param_err = max(param_err, float(((tr["params"][n] - params1[n]).abs() / atol).max()))
    same = all(torch.equal(rec["train"]["params"][n], p) for rec in recs[1:]
               for n, p in tr["params"].items())
    split = tr["split"]
    log(f"[parallel:train] {where}: one AdaMVS step (depth_shards 2, {len(samples)} map(s) "
        f"a global batch) at {H0}x{W0} through the kernels' autograd Functions: loss "
        f"{tr['logs']['total']:.6f} against one process's {logs1['total']:.6f} (largest "
        f"log rel err {loss_err:.2e}, tol {TOL_STEP_LOSS:g}); gradient error {rk[worst]:.3e} "
        f"({worst}); one process on images scaled by 1 + 2^-22: {max(ru.values()):.3e}; "
        f"allowed {allowed:.3e}; params after the update at {param_err:.3f} of "
        f"their tolerance; parameters {'equal' if same else 'NOT equal'} on every rank; "
        f"ms a step {split['step']:.2f} = forward {split['forward']:.2f} + backward "
        f"{split['backward']:.2f} + all-reduce {split['all_reduce']:.2f} + optimizer "
        f"{split['optimizer']:.2f} (rank 0, CUDA events, median of steps 2..{PARALLEL_STEPS}); "
        f"the ranks' processes {spawn_s:.1f} s from spawn to exit")
    if not (np.isfinite(tr["logs"]["total"]) and loss_err <= TOL_STEP_LOSS
            and rk[worst] <= allowed and param_err <= 1.0 and same):
        raise AssertionError(f"[parallel:train] loss {loss_err}, grad {rk[worst]} ({worst}), "
                             f"params {param_err}, equal across ranks {same}")
    return per_rank


def phase_multihost(dev, cam0, poses0, smi):
    """[multihost]: parallel.multihost_driver.launch_local with 2 hosts on
    the 384x512 3x2 survey in three column blocks (AdaMVS, seeded random
    weights, fusion on, mesh and DSM off, cudnn.deterministic in the
    hosts), host h on cuda:(h mod the cards); against a one-host
    dense_match and block-by-block fusion of a copy of the workspace in
    this process: ownership disjoint, every map written once and
    byte-equal to the one host's, every block fused (byte-equal), a fetch
    across hosts; the aggregate maps/s and the overlap seconds."""
    from deep3d_aerial_tpu_torch.parallel.multihost_driver import launch_local
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    cfg = PipelineConfig(
        image_w=W0, image_h=H0, image_scale=1.0, view_num=VIEWS,
        allow_random_weights=True, run_view_selection=False,
        fusion_num=2, geo_consist_num=2, photomatric_threshold=0.0,
        position_threshold=2.0, depth_threshold=0.05, normal_threshold=180.0,
        run_create_mesh=False, run_create_dsm=False)
    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_workspace(tmp / "src", cam0, poses0, dev, columns=3)
        for tag in ("hosts", "one"):
            shutil.copytree(tmp / "src", tmp / tag)
        cfg.to_yaml(tmp / "cfg.yaml")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        agg = launch_local(str(tmp / "hosts"), str(tmp / "cfg.yaml"), 2, device="cuda",
                           deterministic=True)
        wall = time.perf_counter() - t0
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            pipe = AerialPipeline(str(tmp / "one"), cfg, device=dev)
            pipe.dense_match()
            torch.cuda.synchronize()
            n_blocks = len(pipe.fusion_session().blocks)
            for bi in range(n_blocks):
                pipe.fuse_depth_map(block_indices=[bi])
        finally:
            torch.backends.cudnn.deterministic = deterministic
        recs = agg["hosts"]
        owned = [set(r["owned_views"]) for r in recs]
        mvs = tmp / "hosts" / "dense" / "MVS"
        produced = sorted(p.name for p in mvs.glob("*_init.pfm"))
        if owned[0] & owned[1] or len(produced) != len(owned[0] | owned[1]) \
                or len(produced) != len(poses0):
            raise AssertionError(f"[multihost] owned {owned}, maps {produced}")
        maps, differ = same_files(tmp / "hosts", tmp / "one", "dense/MVS")
        fused, fdiffer = same_files(tmp / "hosts", tmp / "one", "dense/fusion", "*.ply")
        covered = sorted(b for r in recs for b in r["blocks"])
        if differ or fdiffer or covered != list(range(n_blocks)) \
                or len(fused) != n_blocks or not any(r["fetched_views"] for r in recs):
            raise AssertionError(f"[multihost] maps differing {differ}, fused {fused} "
                                 f"(differing {fdiffer}), blocks {covered} of {n_blocks}, "
                                 f"fetches {[r['fetched_views'] for r in recs]}")
    log(f"[multihost] 2 hosts on {min(2, n_cards)} card(s) ({smi}): {len(produced)} maps "
        f"at {H0}x{W0} in {n_blocks} blocks, owned {[sorted(o) for o in owned]}, "
        f"fetched {[r['fetched_views'] for r in recs]}; every map byte-equal to one host's "
        f"({len(maps)} files of dense/MVS) and every block fused, byte-equal ({len(fused)} "
        f"PLYs); aggregate {agg['agg_maps_per_s']:.3f} maps/s over the hosts' "
        f"{agg['wall_seconds']:.2f} s (from each host's pipeline start: the model's build "
        f"included, the process's start and imports not), overlap seconds "
        f"{[round(r['overlap_seconds'], 3) for r in recs]}, per host "
        + json.dumps([{k: round(r[k], 3) for k in ('mvs_seconds', 'fuse_seconds',
                                                   'total_seconds')} | {"device": r["device"]}
                      for r in recs]) + f"; launch_local {wall:.1f} s")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's kernels and phases on one CUDA card.")
    ap.add_argument("--phases", default="all", choices=("all", "widths"),
                    help="'all' (the default): every phase; 'widths': the kernel "
                         "builds and [widths] alone")
    args = ap.parse_args(argv)
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
    from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3
    from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2
    from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4
    from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost, sweep_var

    dev = torch.device("cuda")
    # float32 throughout: no TF32 in cuDNN convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from deep3d_aerial_tpu_torch.utils import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # g++ beside the nvccs
        native_build = pool.submit(native.build)
        took = cuda_build.build()
        native_s = native_build.result()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall "
        + json.dumps({k: round(v, 1) for k, v in took.items()}))
    log(f"[build] native {native_s:.1f} s (g++ of native/dsm_reduce.cc and "
        f"native/delaunay_mesh.cc into {native.library_path().name}, beside the CUDA builds)")
    for name in cuda_build.SOURCES:
        for line in cuda_build.library_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    cam0, poses0 = survey(W0, H0)
    camF, posesF = survey(FULL_W, FULL_H)
    if args.phases == "widths":
        return report(phase_widths(dev, cam0, poses0), smi)
    # AdaMVS: K1, K2, K3
    t = time.perf_counter()
    records, red2_yard = phase_kernels(dev, cam0, poses0, camF, posesF)
    log(f"[phase] kernels {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches, _, _ = phase_main_path(
        dev, cam0, poses0, (sweep_corr, sweep_cost, red_step2),
        {"sweep_corr": 1,
         "sweep_cost": sum(d // CHUNK for d in NDEPTHS),
         "red_step2": sum(NDEPTHS)},
        after=lambda pipe, ws: phase_refine_pipeline(dev, pipe, ws))
    log(f"[phase] main path (refine of its mesh included) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_refine_plane(dev)
    log(f"[phase] refine plane {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_host_red_step2(dev, cam0, poses0)
    log(f"[phase] host red_step2 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_end_to_end(dev, cam0, poses0)
    log(f"[phase] end to end {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_production_frame(dev, camF, posesF)
    log(f"[phase] production frame {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_fullres_pipeline(dev, camF, posesF)
    log(f"[phase] main:fullres {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    pipelined_launches = phase_pipelined(
        dev, (sweep_corr, sweep_cost, red_step2),
        {"sweep_corr": 1, "sweep_cost": sum(d // CHUNK for d in NDEPTHS),
         "red_step2": sum(NDEPTHS)})
    log(f"[phase] main:pipelined {time.perf_counter() - t:.1f} s")

    # MSREDNet: K2v, K4, K5
    t = time.perf_counter()
    msred_records, k5 = phase_kernels_msrednet(dev, cam0, poses0, camF, posesF)
    records += msred_records
    log(f"[phase] kernels:msrednet {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    msred_launches, _, _ = phase_main_path(
        dev, cam0, poses0, (sweep_var, red_step4, cf_conv3x3),
        {"sweep_var": sum(d // CHUNK for d in NDEPTHS),
         "red_step4": sum(NDEPTHS),
         "cf_conv3x3": RED4_CONVS * sum(NDEPTHS)}, model_type="msrednet",
        eager_updates=sum(NDEPTHS))
    launches.update(msred_launches)
    log(f"[phase] main path:msrednet {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_host_per_plane(dev, cam0, poses0)
    log(f"[phase] host per plane:msrednet {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_end_to_end_msrednet(dev, cam0, poses0)
    log(f"[phase] end to end:msrednet {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_production_frame(dev, camF, posesF, model_type="msrednet")
    log(f"[phase] production frame:msrednet {time.perf_counter() - t:.1f} s")

    # CasMVSNet and UCSNet: the variance volumes (K2v) and CostRegNet3D
    volume_launches = {}
    for model_type, ndepths, colmap in (("casmvsnet", NDEPTHS, True),
                                        ("ucsnet", UCS_NDEPTHS, False)):
        t = time.perf_counter()
        got, _, _ = phase_main_path(
            dev, cam0, poses0, (sweep_var,),
            {"sweep_var": sum(d // CHUNK for d in ndepths)},
            model_type=model_type, colmap=colmap)
        volume_launches[model_type] = got["sweep_var"]
        log(f"[phase] main path:{model_type} {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_end_to_end_volume(dev, cam0, poses0, model_type)
        log(f"[phase] end to end:{model_type} {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_production_frame(dev, camF, posesF, model_type=model_type)
        log(f"[phase] production frame:{model_type} {time.perf_counter() - t:.1f} s")

    # the bfloat16 operating point: every kernel's bfloat16 mode
    bf16_kernels = phase_bf16(dev, cam0, poses0, camF, posesF)

    # the compensated warp and depth shards
    comp_kernels = phase_compensated(dev, cam0, poses0, camF, posesF)
    for model_type in SHARD_COUNTERS:
        t = time.perf_counter()
        phase_shards(dev, cam0, poses0, model_type)
        log(f"[phase] shards:{model_type} {time.perf_counter() - t:.1f} s")
    # every channel count: the kernels at base widths other than 8
    width_kernels = phase_widths(dev, cam0, poses0)

    # multi-card: dp x sp and the multi-host driver
    t = time.perf_counter()
    parallel_launches = phase_parallel(dev, cam0, poses0, smi)
    log(f"[phase] parallel {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_multihost(dev, cam0, poses0, smi)
    log(f"[phase] multihost {time.perf_counter() - t:.1f} s")

    # training: each kernel's autograd Function, one step kernel vs plain
    # per model, the trainer at its CLI's defaults, three steps per model
    t = time.perf_counter()
    grads = phase_train_grad(dev, cam0, poses0)
    log(f"[phase] train:grad {time.perf_counter() - t:.1f} s")
    for model_type in MODEL_NDEPTHS:
        t = time.perf_counter()
        phase_train_step_parity(dev, cam0, poses0, model_type)
        log(f"[phase] train:step:{model_type} {time.perf_counter() - t:.1f} s")
    train = {}
    t = time.perf_counter()
    train["adamvs"] = phase_train_adamvs(dev)
    log(f"[phase] train:adamvs {time.perf_counter() - t:.1f} s")
    for model_type in ("msrednet", "casmvsnet", "ucsnet"):
        t = time.perf_counter()
        train[model_type] = phase_train_steps(dev, cam0, poses0, model_type)
        log(f"[phase] train:{model_type} {time.perf_counter() - t:.1f} s")
    log("[train] per model: " + json.dumps({m: {
        "step_ms": {k: round(v, 3) for k, v in r["step_ms"].items()},
        "peak_gib": round(r["peak_gib"], 3), "idle": round(r["idle"], 4)}
        for m, r in train.items()}))

    adamvs, msred = f"AdaMVS {H0}x{W0} map", f"MSREDNet {H0}x{W0} map"
    src = {"sweep_corr": ("sweep.cu", "pallas_sweep.py:235", adamvs),
           "sweep_cost": ("sweep.cu", "pallas_sweep.py:520", adamvs),
           "red_step2": ("red_step2.cu", "pallas_red.py:250", adamvs),
           "sweep_var": ("sweep.cu", "pallas_sweep.py:520", msred),
           "red_step4": ("red_step4.cu", "pallas_red4.py:138", msred)}
    kernels = []
    for name, (source, replaces, path) in src.items():
        rs = [r for r in records if r["name"] == name]
        main = [r for r in rs if not r["shape"].startswith("full-res")]

        def per_map(key):
            return sum(r[key] * r["per_map"] for r in main)

        bms = per_map("bound_ms")
        # per-map bound: say which side bounds the stage that dominates it
        by = max(main, key=lambda r: r["bound_ms"] * r["per_map"])["bound_by"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deep3d_aerial_tpu_torch/csrc/{source}",
            "replaces": f"deep3d_aerial_tpu/ops/{replaces}",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": per_map("ms"), "plain_ms": per_map("plain_ms"),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "per_map_of": path,
        })
        kernels[-1].update({
            "bwd_ms": grads[name]["bwd_ms"], "grad_err": grads[name]["grad_err"],
            "backward": "plain VJP (ops/autograd.py KernelFn)",
            "train_launches_per_step": {m: r["launches"][name] for m, r in train.items()
                                        if name in r["launches"]}})
        by_model = "casmvsnet" if name == "sweep_var" else "adamvs"
        if name in parallel_launches[by_model]:
            kernels[-1]["sharded_launches_per_rank_map"] = {
                by_model: parallel_launches[by_model][name],
                "layout": "sp 2, depth_shards 2 ([parallel:infer])"}
        if name == "red_step2":  # not a library call: the convs alone
            kernels[-1]["convs_cudnn_ms"] = red2_yard
        if name == "sweep_var":  # every main path it runs on, in its own run
            kernels[-1]["launches_by_path"] = {"msrednet": launches[name],
                                               **volume_launches}
        elif name in pipelined_launches:  # and AdaMVS's pipelined full-res run
            kernels[-1]["launches_by_path"] = {"adamvs": launches[name],
                                               "pipelined": pipelined_launches[name]}
    kernels.append({
        "name": "cf_conv3x3", "route": "cuda",
        "source": "deep3d_aerial_tpu_torch/csrc/red_step4.cu",
        "replaces": "deep3d_aerial_tpu/ops/pallas_cf_conv.py:150",
        "launches": launches["cf_conv3x3"], "max_abs_err": k5["max_abs_err"],
        "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
        "per_map_of": msred + f" (inside red_step4, {RED4_CONVS} per step)",
        "bwd_ms": None, "grad_err": grads["cf_conv3x3"]["grad_err"],
        "backward": "inside red_step4's Function (its plain VJP); grad_err of its "
                    "own Function at one conv shape",
        "train_launches_per_step": {"msrednet": train["msrednet"]["launches"]["cf_conv3x3"]},
    })
    kernels += bf16_kernels + comp_kernels + width_kernels
    return report(kernels, smi)


def report(kernels, smi) -> int:
    """The last three lines of standard output: the kernels line, the
    card's name and power limit, the result line."""
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
