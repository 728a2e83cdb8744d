"""One RedStep2 recurrent-regularizer step: CUDA kernel K3 and its plain
PyTorch version.

Replaces deep3d_aerial_tpu/ops/pallas_red.py:_red_kernel (entries
red_step2_fused / red_step2_tiled), and the online-softmax update that the
JAX package's sweep fuses after it. Channel-first tensors: cost [Cin, H, W]
(any Cin: the kernel stages it 32 channels at a time and pads a Cin that
is not a multiple of 8 with zero planes; the sweep_cost output planes,
read as they are), states
s1 [8, H, W] and s2 [16, ceil(H/2), ceil(W/2)] -> (score, s1', s2') with
score [2H, 2W] when `up` else [H, W]. `params` maps the names of
models.cost_reg.RedStep2's parameters (conv1.conv.weight, gru1.gates.weight,
..., upconv2d.weight or out2d.weight) to tensors; transposed-conv weights
are in PyTorch's [in, out, 3, 3] layout, flipped (ops/conv.py).

Given the streaming sweep's online-softmax state (m, s, acc, pmax) at the
score's shape and the plane's depth, the step folds the score into it in
place (`online_softmax_update`'s arithmetic) and returns (None, s1', s2'):
on the card the score never reaches device memory.

The kernel source, with its design, launches per step and bound, is
csrc/red_step2.cu (3 launches a step); its weights are packed once into
TF32 hi/lo fragments (`pack_params`), or into bfloat16 fragments for the
bfloat16 mode.

bfloat16 mode (cost and states in bfloat16, the JAX package's
`dtype=jnp.bfloat16` with its Pallas kernel's precision='bf16'): every
product takes bfloat16 operands and sums in float32, the intermediates stay
float32, and values round to bfloat16 where `_red_kernel` rounds them: the
operands of each product (`_mm`, `_sel`: the activations and the weights),
the transposed conv's output (its phases go through `_sel`), the new
states and the score (stores to buffers of the compute dtype). The skip
sum f = relu(up1 + s1') takes s1' before its rounding, as the TPU kernel
reads it from its float32 scratch; the kernel keeps a float32 copy of s1'
for it. `red_step2_plain` does the same in float32 arithmetic on the
rounded operands, in one body with the float32 mode (whose rounding is
the identity); the softmax fold stays float32 on the rounded score.

`red_step2` launches the kernel for CUDA tensors and raises if the launch
fails; it takes the plain version only for CPU tensors. It counts one call
(one step) in `red_step2.launches`, and those of the bfloat16 entry also
in `red_step2.launches_bf16`; `red_step2.launches_by_width` (a Counter)
counts the steps by the cost's channel count Cin.

Where autograd needs a gradient, the score entry goes through
ops/autograd.py's KernelFn (the JAX package's `_fused_fn` custom VJP): K3
forward, red_step2_plain's VJP backward, with gradients to cost, s1, s2 and
every parameter. The fold writes into the softmax state in place, which
autograd cannot follow, so it runs only where no gradient is needed (the
streaming sweep folds under no_grad and inference_mode only) and raises
otherwise.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from .autograd import needs_grad, through_kernel
from .cf_conv import bf16_round, pack_frags, pack_frags_bf16, rounding
from .conv import conv2d_same, conv_transpose2d_same

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def online_softmax_update(state: State, score: torch.Tensor,
                          depth_value: torch.Tensor) -> State:
    """One plane of the online softmax over depth planes: the running max
    m, the scaled exp sum s, the scaled depth sum acc and the scaled max
    probability pmax (models.cascade.OnlineSoftmaxState)."""
    m, s, acc, pmax = state
    score = score.float()
    m_new = torch.maximum(m, score)
    scale = torch.exp(m - m_new)
    e = torch.exp(score - m_new)
    return (m_new, s * scale + e, acc * scale + e * depth_value,
            torch.maximum(pmax * scale, e))


def _gru_plain(p: Params, name: str, x: torch.Tensor, h: torch.Tensor, r):
    hid = h.shape[0]
    x = r(x)
    g = conv2d_same(torch.cat([x, h])[None], p[f"{name}.gates.weight"],
                    p[f"{name}.gates.bias"])[0]
    rg, u = torch.sigmoid(g[:hid]), torch.sigmoid(g[hid:])
    c = torch.tanh(conv2d_same(torch.cat([x, r(rg * h)])[None],
                               p[f"{name}.cand.weight"],
                               p[f"{name}.cand.bias"])[0])
    return u * h + (1.0 - u) * c


def red_step2_plain(params: Params, cost: torch.Tensor, s1: torch.Tensor,
                    s2: torch.Tensor, *, up: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 (F.conv2d / F.conv_transpose2d). In bfloat16
    (cost in bfloat16) the kernel's bfloat16 mode: float32 arithmetic on
    operands rounded where it rounds them, with (score, s1', s2') in
    bfloat16; in float32 the rounding is the identity."""
    dt = cost.dtype
    r = rounding(dt)
    p = {k: r(v) if k.endswith("weight") else v.float() for k, v in params.items()}
    H, W = cost.shape[-2:]
    cost, h1, h2 = cost.float(), s1.float(), s2.float()
    x1 = torch.relu(conv2d_same(cost[None], p["conv1.conv.weight"],
                                p["conv1.conv.bias"])[0])
    r1 = _gru_plain(p, "gru1", x1, h1, r)
    x2 = torch.relu(conv2d_same(r(r1)[None], p["conv2.conv.weight"],
                                p["conv2.conv.bias"], stride=2)[0])
    r2 = _gru_plain(p, "gru2", x2, h2, r)
    up1 = r(conv_transpose2d_same(r(r2)[None], p["upconv1.weight"],
                                  p["upconv1.bias"])[0][:, :H, :W])
    fused = r(torch.relu(up1 + r1))
    if up:
        score = conv_transpose2d_same(fused[None], p["upconv2d.weight"],
                                      p["upconv2d.bias"])[0, 0]
    else:
        score = conv2d_same(fused[None], p["out2d.weight"], p["out2d.bias"])[0, 0]
    return score.to(dt), r1.to(dt), r2.to(dt)


# the tensor-core layers in the kernel's order (transposed: upconv1), each
# packed as TF32 hi/lo fragments (ops/cf_conv.py:pack_frags) then its bias:
# level 1 (conv1, gru1), level 2 (conv2, gru2), level 3 (upconv1)
_LAYERS = ("conv1.conv", "gru1.gates", "gru1.cand", "conv2.conv",
           "gru2.gates", "gru2.cand", "upconv1")


def pack_params(params: Params, up: bool,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3's weights, one flat float32 buffer: the 7 tensor-core layers in
    `_LAYERS` order, each as pack_frags(w) of w [Ci, 3, 3, Co] (a conv's
    OIHW permuted, a transposed conv's [in, out, 3, 3] permuted) followed
    by its bias; then the score conv (upconv2d if `up`, else out2d) as
    [8][3][3] and its bias padded to 8 floats. Every section is a multiple
    of 4 floats, so each starts 16-byte aligned. For the bfloat16 mode
    (`dtype` bfloat16) the layers are pack_frags_bf16's fragments and the
    score conv's weights are rounded to bfloat16 (kept as float32 values);
    the biases stay float32."""
    bf16 = dtype == torch.bfloat16
    frags = pack_frags_bf16 if bf16 else pack_frags
    out = []
    for name in _LAYERS:
        w = params[f"{name}.weight"].detach().float()
        wp = w.permute(0, 2, 3, 1) if name == "upconv1" else w.permute(1, 2, 3, 0)
        out += [frags(wp), params[f"{name}.bias"].detach().float()]
    score = "upconv2d" if up else "out2d"
    w = params[f"{score}.weight"].detach().float()
    if bf16:
        w = bf16_round(w)
    out.append((w[:, 0] if up else w[0]).reshape(-1))
    b = params[f"{score}.bias"].detach().float()
    out.append(torch.nn.functional.pad(b, (0, 8 - b.numel())))
    return torch.cat(out).contiguous()


def red_step2(params: Params, cost: torch.Tensor, s1: torch.Tensor,
              s2: torch.Tensor, *, up: bool,
              packed: Optional[torch.Tensor] = None,
              osm: Optional[State] = None,
              dv: Optional[torch.Tensor] = None
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors (`packed` = pack_params(params, up), to skip
    repacking per plane); red_step2_plain on CPU tensors. With `osm` (the
    online-softmax state, four float32 tensors at the score's shape) and
    `dv` (the plane's depth at that shape) the score is folded into `osm`
    in place and (None, s1', s2') is returned."""
    if (osm is None) != (dv is None):
        raise ValueError("red_step2: give both osm and dv, or neither")
    if not cost.is_cuda:
        score, r1, r2 = red_step2_plain(params, cost, s1, s2, up=up)
        if osm is None:
            return score, r1, r2
        for t, new in zip(osm, online_softmax_update(osm, score, dv)):
            t.copy_(new)
        return None, r1, r2
    if osm is None:
        return through_kernel(
            lambda p, c, a, b: _launch(p, c, a, b, up, packed, None, None),
            lambda p, c, a, b: red_step2_plain(p, c, a, b, up=up),
            (cost, s1, s2), params)
    if needs_grad(cost, s1, s2, dv, *osm, *params.values()):
        raise ValueError("red_step2: the softmax fold updates its state in place "
                         "and has no gradient; fold under no_grad, or take the "
                         "score (osm=None) where autograd needs one")
    return _launch(params, cost, s1, s2, up, packed, osm, dv)


def _launch(params: Params, cost: torch.Tensor, s1: torch.Tensor,
            s2: torch.Tensor, up: bool, packed: Optional[torch.Tensor],
            osm: Optional[State], dv: Optional[torch.Tensor]):
    from .cuda_build import check, load

    Cin, H, W = cost.shape
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    if tuple(s1.shape) != (8, H, W) or tuple(s2.shape) != (16, H2, W2):
        raise ValueError(f"red_step2: states {tuple(s1.shape)}, "
                         f"{tuple(s2.shape)} do not fit cost {tuple(cost.shape)}")
    tensors = [cost, s1, s2]
    dt = cost.dtype
    if (dt not in (torch.float32, torch.bfloat16)
            or any(t.dtype != dt or not t.is_cuda for t in tensors)):
        raise ValueError("red_step2: cost and states must be CUDA tensors, all "
                         "float32 or all bfloat16")
    bf16 = dt == torch.bfloat16
    cost, s1, s2 = (t.contiguous() for t in tensors)
    if packed is None:
        packed = pack_params(params, up, dt)
    lib = load("red_step2")
    want = lib.red_step2_param_floats(Cin, int(bf16))
    if (packed.numel() != want or not packed.is_cuda
            or packed.dtype != torch.float32 or packed.data_ptr() % 16):
        raise ValueError(f"red_step2: packed weights of {packed.numel()} "
                         f"floats for Cin {Cin} (want {want} float32 on the "
                         "card, 16-byte aligned)")
    dev = cost.device
    shape = (2 * H, 2 * W) if up else (H, W)
    if osm is None:
        score = torch.empty(shape, device=dev, dtype=dt)
        state = (None,) * 4
    else:
        score = None
        dv = dv.contiguous()
        for t in (*osm, dv):
            if (tuple(t.shape) != shape or t.dtype != torch.float32
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"red_step2: softmax state and depth must be "
                                 f"contiguous float32 {shape} on {dev}")
        state = tuple(t.data_ptr() for t in osm)
    s1n = torch.empty_like(s1)
    s2n = torch.empty_like(s2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (None if score is None else score.data_ptr(), *state,
            None if dv is None else dv.data_ptr(), H, W, int(up))
    with torch.cuda.device(dev):
        if bf16:  # s1' in float32 too, for the skip sum (see the docstring)
            s1f = torch.empty(s1.shape, device=dev)
            rc = lib.red_step2_bf16(cost.data_ptr(), Cin, s1.data_ptr(),
                                    s2.data_ptr(), packed.data_ptr(),
                                    s1n.data_ptr(), s2n.data_ptr(),
                                    s1f.data_ptr(), *args, stream)
        else:
            rc = lib.red_step2_f32(cost.data_ptr(), Cin, s1.data_ptr(),
                                   s2.data_ptr(), packed.data_ptr(),
                                   s1n.data_ptr(), s2n.data_ptr(), *args,
                                   stream)
    check(lib, rc, "red_step2")
    red_step2.launches += 1
    red_step2.launches_by_width[Cin] += 1
    if bf16:
        red_step2.launches_bf16 += 1
    return score, s1n, s2n


red_step2.launches = 0
red_step2.launches_bf16 = 0
red_step2.launches_by_width = collections.Counter()
