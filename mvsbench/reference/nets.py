"""Plain PyTorch references of AdaMVS and MSREDNet, float32, functional.

A frozen copy of the mathematics of the port's plain paths (see README.md
for where each piece comes from), written against a parameter dict whose
keys are the models' state_dict names, so that the benchmark hands both
sides the same seeded weights. It imports nothing of the program and
calls no kernel: convolutions are F.conv2d / F.conv_transpose2d, the
plane sweep is an explicit projection and bilinear gather, every
recurrent regulariser step is its convolutions in order, and the depth
is an online soft-argmax over the planes.

Conventions, all the JAX package's:
  * 'SAME' padding TensorFlow's way (a strided conv pads (total//2, rest));
    stride-2 transposed convs are PyTorch's at stride 2, cropped to 2n
    (the weights are stored flipped);
  * the feature nets' GroupNorm takes its statistics per image row (groups
    of 8 channels, eps 1e-6, variance E[x^2] - E[x]^2); RedStep4's
    NormGRU takes one group over the whole map;
  * bilinear sampling with zero padding, half-pixel-centre integer
    upsampling with edge clamp.
Work happens in plane chunks of 8 (the sweep's own chunking), so the
reference runs at the full frame on one card.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
CHUNK = 8


# ---------------------------------------------------------------- layers
def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, b=None, stride=1):
    """'SAME' 2-D convolution of [N, C, H, W] with OIHW weights."""
    pads = []
    for n, k in zip(reversed(x.shape[-2:]), reversed(w.shape[-2:])):
        pads += _same_pads(n, k, stride)
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w, b, stride=stride)


def conv_t(x, w, b=None):
    """Stride-2 'SAME' 3x3 transposed convolution (weights [in, out, 3, 3],
    flipped): exactly 2x."""
    H, W = x.shape[-2:]
    return F.conv_transpose2d(x, w, b, stride=2)[..., :2 * H, :2 * W]


def group_norm_rows(x, w, b, eps=1e-6):
    """GroupNorm of [N, C, H, W] with max(1, C // 8) groups, statistics per
    image row over (W, the group's channels)."""
    N, C, H, W = x.shape
    G = max(1, C // 8)
    g = x.reshape(N, G, C // G, H, W)
    mean = g.mean(dim=(2, 4), keepdim=True)
    var = ((g * g).mean(dim=(2, 4), keepdim=True) - mean * mean).clamp_min(0)
    mul = torch.rsqrt(var + eps) * w.reshape(1, G, C // G, 1, 1)
    return ((g - mean) * mul).reshape(N, C, H, W) + b.reshape(C, 1, 1)


def group_norm_map(x, w, b, eps=1e-6):
    """GroupNorm with one group over a whole [C, H, W] map."""
    mean = x.mean()
    var = ((x * x).mean() - mean * mean).clamp_min(0)
    return (x - mean) * (torch.rsqrt(var + eps) * w[:, None, None]) + b[:, None, None]


def block(p: Params, pre: str, x, stride=1, transposed=False, relu=True):
    """Conv (or transposed conv) + the row GroupNorm when the block has one
    (its conv then has no bias) + ReLU."""
    w, b = p[f"{pre}.conv.weight"], p.get(f"{pre}.conv.bias")
    y = conv_t(x, w, b) if transposed else conv(x, w, b, stride)
    if f"{pre}.norm.weight" in p:
        y = group_norm_rows(y, p[f"{pre}.norm.weight"], p[f"{pre}.norm.bias"])
    return torch.relu(y) if relu else y


def upsample_axis(x, s: int, axis: int):
    """Bilinear s-x upsampling along one axis, half-pixel centres, edges
    clamped: one lerp per output phase."""
    axis = axis % x.ndim
    n = x.shape[axis]
    xm = x.movedim(axis, -1)
    idx = torch.arange(n, device=x.device)
    phases = []
    for q in range(s):
        src = (q + 0.5) / s - 0.5
        a = math.floor(src)
        f = src - a
        lo = xm if a == 0 else xm[..., (idx + a).clamp(0, n - 1)]
        hi = xm[..., (idx + a + 1).clamp(0, n - 1)]
        phases.append((1.0 - f) * lo + f * hi)
    y = torch.stack(phases, dim=-1).reshape(*xm.shape[:-1], n * s)
    return y.movedim(-1, axis)


def resize(x, shape):
    """Bilinear resize of the last two axes (upsampling only)."""
    H, W = shape
    h, w = x.shape[-2:]
    if (h, w) == (H, W):
        return x
    if H % h == 0 and W % w == 0 and H // h == W // w:
        return upsample_axis(upsample_axis(x, H // h, -2), H // h, -1)
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, h, w), size=(H, W), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, H, W)


# ---------------------------------------------------------- feature nets
def features(p: Params, imgs, arch: str):
    """imgs [V, H, W, 3] -> stage features [V, h, w, C] at 1/4, 1/2, 1/1
    ('branch': AdaMVS, 'unet': MSREDNet)."""
    x = imgs.permute(0, 3, 1, 2)

    def c(i, y, s=1):
        return block(p, f"feature.convs.{i}", y, s)

    conv0 = c(1, c(0, x))
    conv1 = c(4, c(3, c(2, conv0, 2)))
    conv2 = c(7, c(6, c(5, conv1, 2)))

    def head(y, stage):
        out = p[f"feature.out{stage}.weight"]
        if arch == "unet":
            return conv(y, out)
        H, W = y.shape[-2:]
        brs = [resize(block(p, f"feature.branch{stage}_{j}",
                            F.avg_pool2d(y, pool, stride=pool)), (H, W))
               for j, pool in ((1, 4), (2, 8))]
        return conv(torch.cat(brs + [y], 1), out)

    def fuse(pre, skip, y):
        y = block(p, f"{pre}.deconvs.0", y, transposed=True)
        return block(p, f"{pre}.convs.0", torch.cat([y, skip], 1))

    s1 = head(conv2, 1)
    intra = fuse("feature.deconv1", conv1, conv2)
    s2 = head(intra, 2)
    intra = fuse("feature.deconv2", conv0, intra)
    s3 = head(intra, 3)
    return [f.permute(0, 2, 3, 1).contiguous() for f in (s1, s2, s3)]


def cost_reg_2d(p: Params, pre: str, x):
    """The pair hourglass: [N, D, H, W] -> [N, D, H, W] scores."""
    def cv(i, y, s=1):
        return block(p, f"{pre}.convs.{i}", y, s)

    def up(i, y, like):
        y = block(p, f"{pre}.deconvs.{i}", y, transposed=True)
        return like + y[..., :like.shape[-2], :like.shape[-1]]

    c0 = cv(0, x)
    c2 = cv(1, cv(2, c0, 2))
    c4 = cv(3, cv(4, c2, 2))
    y = cv(5, cv(6, c4, 2))
    y = up(2, up(1, up(0, y, c4), c2), c0)
    return conv(y, p[f"{pre}.prob.weight"], p[f"{pre}.prob.bias"])


# ---------------------------------------------------------------- sweep
def coordinates(rel, depths, H: int, W: int):
    """Source pixel coordinates (x, y) [K, H, W] of every ref pixel at the
    depths [K, H, W] through rel = src_P @ inv(ref_P); points behind the
    source camera land far outside."""
    R, t = rel[:3, :3], rel[:3, 3]
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depths.device),
                            torch.arange(W, dtype=torch.float32, device=depths.device),
                            indexing="ij")
    p = [(R[a, 0] * gx + R[a, 1] * gy + R[a, 2])[None] * depths + t[a] for a in range(3)]
    z = p[2]
    safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    far = torch.full_like(z, -1e9)
    return (torch.where(z > 1e-6, p[0] / safe, far),
            torch.where(z > 1e-6, p[1] / safe, far))


def sample(src, x, y):
    """Bilinear sample of src [H, W, C] at (x, y) [...], zero padding."""
    H, W, C = src.shape
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    flat = src.reshape(H * W, C)
    out = 0
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, C)
        out = out + vals * torch.where(ok, w, torch.zeros_like(w))[..., None]
    return out


def pair_volumes(ref, srcs, rels, depths):
    """[V-1, D, H, W]: mean over channels of ref * warped source, per view
    and plane (uniform planes depths [D])."""
    H, W, _ = ref.shape
    D = depths.shape[0]
    out = []
    for v in range(srcs.shape[0]):
        planes = []
        for i in range(0, D, CHUNK):
            d = depths[i:i + CHUNK, None, None].expand(-1, H, W)
            x, y = coordinates(rels[v], d, H, W)
            planes.append((sample(srcs[v], x, y) * ref[None]).mean(-1))
        out.append(torch.cat(planes))
    return torch.stack(out)


def corr_cost(ref, srcs, rels, depths, weights):
    """[K, C, H, W]: per plane sum_v w_v * ref * warp_v / (sum_v w_v + 1e-5)."""
    H, W, _ = ref.shape
    acc = 0
    for v in range(srcs.shape[0]):
        x, y = coordinates(rels[v], depths, H, W)
        acc = acc + sample(srcs[v], x, y) * ref[None] * weights[v, :, :, None]
    cost = acc / (weights.sum(0) + 1e-5)[None, :, :, None]
    return cost.permute(0, 3, 1, 2)


def var_cost(ref, srcs, rels, depths):
    """[K, C, H, W]: per plane E[f^2] - E[f]^2 over ref and the warps."""
    H, W, _ = ref.shape
    s = q = 0
    for v in range(srcs.shape[0]):
        x, y = coordinates(rels[v], depths, H, W)
        w = sample(srcs[v], x, y)
        s, q = s + w, q + w * w
    n = srcs.shape[0] + 1
    mean = (ref[None] + s) / n
    return (((ref * ref)[None] + q) / n - mean * mean).permute(0, 3, 1, 2)


# ---------------------------------------------------------- regularisers
def _gru(p, pre, x, h):
    hid = h.shape[0]
    g = conv(torch.cat([x, h])[None], p[f"{pre}.gates.weight"], p[f"{pre}.gates.bias"])[0]
    r, u = torch.sigmoid(g[:hid]), torch.sigmoid(g[hid:])
    c = torch.tanh(conv(torch.cat([x, r * h])[None], p[f"{pre}.cand.weight"],
                        p[f"{pre}.cand.bias"])[0])
    return u * h + (1.0 - u) * c


def red_step2(p: Params, pre: str, up: bool, cost, h1, h2):
    """One plane of the 2-level ConvGRU regulariser (AdaMVS): cost [Cin, H,
    W] -> (score [2H, 2W] if up else [H, W], h1', h2')."""
    H, W = cost.shape[-2:]
    x1 = torch.relu(conv(cost[None], p[f"{pre}.conv1.conv.weight"],
                         p[f"{pre}.conv1.conv.bias"])[0])
    r1 = _gru(p, f"{pre}.gru1", x1, h1)
    x2 = torch.relu(conv(r1[None], p[f"{pre}.conv2.conv.weight"],
                         p[f"{pre}.conv2.conv.bias"], stride=2)[0])
    r2 = _gru(p, f"{pre}.gru2", x2, h2)
    up1 = conv_t(r2[None], p[f"{pre}.upconv1.weight"], p[f"{pre}.upconv1.bias"])[0]
    fused = torch.relu(up1[:, :H, :W] + r1)
    if up:
        score = conv_t(fused[None], p[f"{pre}.upconv2d.weight"], p[f"{pre}.upconv2d.bias"])
    else:
        score = conv(fused[None], p[f"{pre}.out2d.weight"], p[f"{pre}.out2d.bias"])
    return score[0, 0], r1, r2


def _norm_gru(p, pre, x, h):
    hid = h.shape[0]
    g = conv(torch.cat([x, h])[None], p[f"{pre}.gates.weight"], p[f"{pre}.gates.bias"])[0]
    r = torch.sigmoid(group_norm_map(g[:hid], p[f"{pre}.rn.weight"], p[f"{pre}.rn.bias"]))
    u = torch.sigmoid(group_norm_map(g[hid:], p[f"{pre}.un.weight"], p[f"{pre}.un.bias"]))
    o = conv(torch.cat([x, r * h])[None], p[f"{pre}.cand.weight"], p[f"{pre}.cand.bias"])[0]
    o = torch.tanh(group_norm_map(o, p[f"{pre}.on.weight"], p[f"{pre}.on.bias"]))
    return u * h + (1.0 - u) * o


def red_step4(p: Params, pre: str, cost, h1, h2, h3, h4):
    """One plane of the 4-level NormGRU encoder-decoder (MSREDNet): the
    negated variance cost [Cin, H, W] -> (score [H, W], h1'..h4')."""
    def down(x, name):
        return torch.relu(conv(x[None], p[f"{pre}.{name}.conv.weight"],
                               p[f"{pre}.{name}.conv.bias"], stride=2)[0])

    def up(x, name):
        return torch.relu(conv_t(x[None], p[f"{pre}.{name}.conv.weight"],
                                 p[f"{pre}.{name}.conv.bias"])[0])

    neg = -cost
    d1 = down(neg, "conv1")
    d2 = down(d1, "conv2")
    d3 = down(d2, "conv3")
    r4 = _norm_gru(p, f"{pre}.gru4", d3, h4)
    r3 = _norm_gru(p, f"{pre}.gru3", d2, h3)
    u2 = up(up(r4, "upconv3") + r3, "upconv2")
    r2 = _norm_gru(p, f"{pre}.gru2", d1, h2)
    u1 = up(u2 + r2, "upconv1")
    r1 = _norm_gru(p, f"{pre}.gru1", neg, h1)
    score = conv((u1 + r1)[None], p[f"{pre}.out2d.weight"], p[f"{pre}.out2d.bias"])[0, 0]
    return score, r1, r2, r3, r4


# ---------------------------------------------------------------- cascade
def uniform_planes(dmin, dmax, n: int, dev):
    """[n] inclusive float32 linspace over [dmin, dmax], the last exactly
    dmax."""
    lo = torch.tensor(dmin, dtype=torch.float32, device=dev)
    hi = torch.tensor(dmax, dtype=torch.float32, device=dev)
    s = torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def window_planes(center, n: int, interval):
    """[n, H, W]: n planes spanning n * interval around center [H, W]."""
    lo = center - n / 2.0 * interval
    hi = center + n / 2.0 * interval
    step = (hi - lo) / (n - 1)
    k = torch.arange(n, dtype=torch.float32, device=center.device)[:, None, None]
    return lo[None] + k * step[None]


def sweep_stage(cost_fn, step_fn, states, depths, up: bool):
    """Depth and confidence of one stage: the cost in chunks of planes, each
    plane through the recurrent step, the scores into an online softmax
    over the planes (at 2x with `up`, the plane depths upsampled too)."""
    D, H, W = depths.shape
    shape = (2 * H, 2 * W) if up else (H, W)
    dev = depths.device
    m = torch.full(shape, -torch.inf, device=dev)
    s = torch.zeros(shape, device=dev)
    acc = torch.zeros(shape, device=dev)
    pmax = torch.zeros(shape, device=dev)
    K = max(k for k in range(1, min(CHUNK, D) + 1) if D % k == 0)
    for start in range(0, D, K):
        chunk = depths[start:start + K]
        costs = cost_fn(chunk)
        dvs = upsample_axis(upsample_axis(chunk, 2, -2), 2, -1) if up else chunk
        for k in range(K):
            score, *states = step_fn(costs[k], *states)
            m_new = torch.maximum(m, score)
            scale = torch.exp(m - m_new)
            e = torch.exp(score - m_new)
            s = s * scale + e
            acc = acc * scale + e * dvs[k]
            pmax = torch.maximum(pmax * scale, e)
            m = m_new
    s = s + 1e-10
    return acc / s, pmax / s


def adamvs(p: Params, imgs, rel, dmin: float, dmax: float, cfg: Dict) -> Dict:
    """AdaMVS: imgs [V, H, W, 3], rel [3, V-1, 4, 4] -> {'stage1'..'stage3':
    {'depth', 'photometric_confidence'}, stage1 also 'pair_results'}."""
    nds, ratios = cfg["ndepths"], cfg["depth_interval_ratios"]
    feats = features(p, imgs, "branch")
    dev = imgs.device
    interval = (torch.tensor(dmax, device=dev) - torch.tensor(dmin, device=dev)) \
        / cfg["num_depth"]
    depths1 = uniform_planes(dmin, dmax, nds[0], dev)
    f1 = feats[0]
    prob = torch.softmax(cost_reg_2d(p, "pair_reg.reg",
                                     pair_volumes(f1[0], f1[1:], rel[0], depths1)), dim=1)
    view_w = prob.max(dim=1).values
    pair_depth = (prob * depths1[None, :, None, None]).sum(dim=1)
    out, depth = {}, None
    for s, nd in enumerate(nds):
        f = feats[s]
        H, W = f.shape[1:3]
        up = s < len(nds) - 1
        if depth is None:
            depths = depths1[:, None, None].expand(nd, H, W)
        else:
            depths = window_planes(resize(depth, (H, W)), nd, ratios[s] * interval)
        w = resize(view_w, (H, W))
        pre = f"red{s}"
        states = (torch.zeros((8, H, W), device=dev),
                  torch.zeros((16, (H + 1) // 2, (W + 1) // 2), device=dev))
        depth, conf = sweep_stage(
            lambda d, f=f, w=w, s=s: corr_cost(f[0], f[1:], rel[s], d, w),
            lambda c, a, b, pre=pre, up=up: red_step2(p, pre, up, c, a, b),
            states, depths, up)
        out[f"stage{s + 1}"] = {"depth": depth, "photometric_confidence": conf}
    out["stage1"]["pair_results"] = pair_depth
    return out


def msrednet(p: Params, imgs, rel, dmin: float, dmax: float, cfg: Dict) -> Dict:
    """MSREDNet: as adamvs, with the variance cost and RedStep4."""
    nds, ratios = cfg["ndepths"], cfg["depth_interval_ratios"]
    feats = features(p, imgs, "unet")
    dev = imgs.device
    interval = (torch.tensor(dmax, device=dev) - torch.tensor(dmin, device=dev)) \
        / cfg["num_depth"]
    out, depth = {}, None
    for s, nd in enumerate(nds):
        f = feats[s]
        H, W = f.shape[1:3]
        if depth is None:
            depths = uniform_planes(dmin, dmax, nd, dev)[:, None, None].expand(nd, H, W)
        else:
            depths = window_planes(resize(depth, (H, W)), nd, ratios[s] * interval)
        pre = f"red{s}"
        states = tuple(torch.zeros((8 << l, H >> l, W >> l), device=dev) for l in range(4))
        depth, conf = sweep_stage(
            lambda d, f=f, s=s: var_cost(f[0], f[1:], rel[s], d),
            lambda c, *h, pre=pre: red_step4(p, pre, c, *h),
            states, depths, False)
        out[f"stage{s + 1}"] = {"depth": depth, "photometric_confidence": conf}
    return out


MODELS = {"adamvs": adamvs, "msrednet": msrednet}


def forward(model_type: str, p: Params, imgs, rel, dmin: float, dmax: float,
            cfg: Dict) -> Dict:
    """The reference forward of `model_type` on one reference view."""
    return MODELS[model_type](p, imgs, rel, dmin, dmax, cfg)


def precision(tf32: bool) -> None:
    """Float32 (TF32 off for cuDNN and matmul), or the TF32 control."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def final(out: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last stage's (depth, confidence)."""
    last = out[f"stage{len([k for k in out if k.startswith('stage')])}"]
    return last["depth"], last["photometric_confidence"]
