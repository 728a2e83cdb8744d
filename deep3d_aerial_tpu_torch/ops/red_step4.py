"""One RedStep4 recurrent-regularizer step: CUDA kernel K4 and its plain
PyTorch version.

Replaces deep3d_aerial_tpu/ops/pallas_red4.py:_red4_kernel (entries
red_step4_fused / red_step4_tiled; oracle red_step4_reference).
Channel-first tensors: cost [Cin, H, W] (a sweep_var output plane, read as
it is), states s1 [8, H, W], s2 [16, H/2, W/2], s3 [32, H/4, W/4],
s4 [64, H/8, W/8], H and W multiples of 8 -> (score [H, W], s1', s2', s3',
s4'). `params` maps the names of models.cost_reg.RedStep4's parameters
(conv1.conv.weight, gru1.gates.weight, gru1.rn.weight, upconv3.conv.weight,
out2d.weight, ...) to tensors; transposed-conv weights are in PyTorch's
[in, out, 3, 3] layout, flipped (ops/conv.py).

The kernel source, with its design, launches per step and bound, is
csrc/red_step4.cu; its convolutions are the K5 template (ops/cf_conv.py).
`red_step4` launches it for CUDA tensors and raises if the launch fails; it
takes the plain version only for CPU tensors. It counts one launch per step
in `red_step4.launches` and adds the step's conv-template launches to
`cf_conv3x3.launches`; the bfloat16 entry's count the same in
`red_step4.launches_bf16` and `cf_conv3x3.launches_bf16`;
`red_step4.launches_by_width` (a Counter) counts the steps by the cost's
channel count Cin.

bfloat16 mode (cost and states in bfloat16: the JAX package's
`dtype=jnp.bfloat16` with precision='bf16'): the conv template's bfloat16
instance (ops/cf_conv.py), float32 sums, every buffer of the step in
bfloat16 as `_red4_kernel`'s scratch is: a value rounds to bfloat16 where
the TPU kernel stores it (d1-d3, the gates' and candidates'
pre-activations, r*h, the new states, the decoder's outputs, the score)
and where it feeds a product (the skip sums u + h). The GroupNorm
statistics stay float32, taken from the pre-activations before they
round. `red_step4_plain` does the same in float32 arithmetic on the
rounded values: one body for both modes, whose rounding is the identity
in float32.

Where autograd needs a gradient, the step goes through ops/autograd.py's
KernelFn (the JAX package's custom VJPs around red_step4_fused and
red_step4_tiled): K4 forward, red_step4_plain's VJP backward, with
gradients to cost, the four states and every parameter. The K5 launches
inside the step are covered by it.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional, Tuple

import torch

from .autograd import through_kernel
from .cf_conv import (cf_conv3x3, no_round, pack_frags, pack_frags_bf16,
                      rounding)
from .conv import conv2d_same, conv_transpose2d_same

Params = Dict[str, torch.Tensor]
HIDDEN = (8, 16, 32, 64)
GN_EPS = 1e-6


def group_norm_global(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = GN_EPS,
                      r=no_round) -> torch.Tensor:
    """GroupNorm with one group over the whole [C, H, W] map, as the JAX
    package's NormGRUCell applies it (num_groups=1, reduction over (H, W,
    C)): variance E[x^2] - E[x]^2 clamped at 0, the scale folded into the
    inverse deviation. The statistics are x's; they are applied to r(x)
    (K4's bfloat16 mode takes them before the value rounds)."""
    mean = x.mean()
    var = ((x * x).mean() - mean * mean).clamp_min(0)
    mul = torch.rsqrt(var + eps) * weight[:, None, None]
    return (r(x) - mean) * mul + bias[:, None, None]


def norm_gru_plain(p: Params, x: torch.Tensor, h: torch.Tensor,
                   r=no_round) -> torch.Tensor:
    """NormGRUCell on [C, H, W] maps; p holds gates.*, cand.*, rn.*, un.*,
    on.* (weight and bias each). `r` rounds where K4's bfloat16 mode
    stores: the pre-activations, r*h and the new state."""
    hid = h.shape[0]
    g = conv2d_same(torch.cat([x, h])[None], p["gates.weight"],
                    p["gates.bias"])[0]
    rg = torch.sigmoid(group_norm_global(g[:hid], p["rn.weight"], p["rn.bias"], r=r))
    u = torch.sigmoid(group_norm_global(g[hid:], p["un.weight"], p["un.bias"], r=r))
    o = conv2d_same(torch.cat([x, r(rg * h)])[None], p["cand.weight"],
                    p["cand.bias"])[0]
    o = torch.tanh(group_norm_global(o, p["on.weight"], p["on.bias"], r=r))
    return r(u * h + (1.0 - u) * o)


def _sub(p: Params, name: str) -> Params:
    n = len(name) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(name + ".")}


# the products' weights, which K4's bfloat16 mode rounds
_WEIGHTS = ("conv.weight", "gates.weight", "cand.weight", "out2d.weight")


def red_step4_plain(params: Params, cost: torch.Tensor, s1: torch.Tensor,
                    s2: torch.Tensor, s3: torch.Tensor, s4: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K4 (F.conv2d / F.conv_transpose2d), the JAX
    package's RedStep4 body on channel-first maps. In bfloat16 (cost in
    bfloat16) the kernel's bfloat16 mode: float32 arithmetic that rounds
    where it rounds (the products' weights, d1-d3, the pre-activations,
    r*h, the new states, the decoder's outputs and skip sums), with the
    score and the states in bfloat16."""
    r = rounding(cost.dtype)
    p = {k: r(v) if k.endswith(_WEIGHTS) else v.float() for k, v in params.items()}

    def down(x, name):
        return r(torch.relu(conv2d_same(x[None], p[f"{name}.conv.weight"],
                                        p[f"{name}.conv.bias"], stride=2)[0]))

    def up(x, name):
        return r(torch.relu(conv_transpose2d_same(
            x[None], p[f"{name}.conv.weight"], p[f"{name}.conv.bias"])[0]))

    neg = -cost.float()
    h1, h2, h3, h4 = (s.float() for s in (s1, s2, s3, s4))
    d1 = down(neg, "conv1")
    d2 = down(d1, "conv2")
    d3 = down(d2, "conv3")
    r4 = norm_gru_plain(_sub(p, "gru4"), d3, h4, r)
    u3 = up(r4, "upconv3")
    r3 = norm_gru_plain(_sub(p, "gru3"), d2, h3, r)
    u2 = up(r(u3 + r3), "upconv2")
    r2 = norm_gru_plain(_sub(p, "gru2"), d1, h2, r)
    u1 = up(r(u2 + r2), "upconv1")
    r1 = norm_gru_plain(_sub(p, "gru1"), neg, h1, r)
    score = conv2d_same(r(u1 + r1)[None], p["out2d.weight"], p["out2d.bias"])[0, 0]
    return tuple(t.to(cost.dtype) for t in (score, r1, r2, r3, r4))


# the C entry's layer order; each packed as K5's fragments + padded bias
_LAYERS = ("conv1.conv", "conv2.conv", "conv3.conv",
           "gru1.gates", "gru1.cand", "gru2.gates", "gru2.cand",
           "gru3.gates", "gru3.cand", "gru4.gates", "gru4.cand",
           "upconv3.conv", "upconv2.conv", "upconv1.conv", "out2d")
# the cost's consumers: the negation folds into their first `cin` inputs
_NEG = ("conv1.conv", "gru1.gates", "gru1.cand")


@torch.no_grad()
def pack_params(params: Params, cin: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4's one packed parameter buffer: the 15 layers in _LAYERS order,
    each as K5's TF32 hi/lo fragments (ops/cf_conv.py:pack_frags of convs
    OIHW -> [I, 3, 3, O], transposed convs [I, O, 3, 3] -> [I, 3, 3, O]),
    or its bfloat16 fragments (pack_frags_bf16) for `dtype` bfloat16,
    followed by its bias zero-padded to a multiple of 8, neg = -cost folded
    into the cost's input channels of conv1 and of gru1's gates and
    candidate; then per level the GroupNorm vectors rn, un, on (weight,
    bias), float32."""
    frags = pack_frags_bf16 if dtype == torch.bfloat16 else pack_frags
    out = []
    for name in _LAYERS:
        w = params[f"{name}.weight"].float()
        if name in _NEG:
            w = torch.cat([-w[:, :cin], w[:, cin:]], dim=1)
        wp = w.permute(0, 2, 3, 1) if name.startswith("upconv") else w.permute(1, 2, 3, 0)
        b = params[f"{name}.bias"].float()
        out += [frags(wp), torch.nn.functional.pad(b, (0, -len(b) % 8))]
    for l in range(4):
        for gn in ("rn", "un", "on"):
            out += [params[f"gru{l + 1}.{gn}.weight"].float(),
                    params[f"gru{l + 1}.{gn}.bias"].float()]
    return torch.cat(out).contiguous()


def check_shapes(cost: torch.Tensor, states) -> None:
    """Raise ValueError unless cost is [Cin, H, W] with H and W multiples
    of 8 and the states are the pyramid [8|16|32|64, H>>l, W>>l]."""
    if cost.ndim != 3:
        raise ValueError(f"red_step4: cost {tuple(cost.shape)} is not [Cin, H, W]")
    _, H, W = cost.shape
    if H % 8 or W % 8 or H == 0 or W == 0:
        raise ValueError(f"red_step4: H x W = {H} x {W}; the step needs "
                         "multiples of 8 (three stride-2 levels)")
    want = [(c, H >> l, W >> l) for l, c in enumerate(HIDDEN)]
    got = [tuple(s.shape) for s in states]
    if got != want:
        raise ValueError(f"red_step4: states {got} do not fit cost "
                         f"{tuple(cost.shape)} (want {want})")


def red_step4(params: Params, cost: torch.Tensor, s1: torch.Tensor,
              s2: torch.Tensor, s3: torch.Tensor, s4: torch.Tensor, *,
              packed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """K4 on CUDA tensors (`packed` = pack_params(params, Cin), to skip
    repacking per plane); red_step4_plain on CPU tensors."""
    if not cost.is_cuda:
        return red_step4_plain(params, cost, s1, s2, s3, s4)
    return through_kernel(
        lambda p, *xs: _launch(p, *xs, packed=packed), red_step4_plain,
        (cost, s1, s2, s3, s4), params)


def _launch(params: Params, cost: torch.Tensor, s1: torch.Tensor,
            s2: torch.Tensor, s3: torch.Tensor, s4: torch.Tensor, *,
            packed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    from .cuda_build import check, load, tickets

    states = (s1, s2, s3, s4)
    check_shapes(cost, states)
    tensors = (cost,) + states
    dt = cost.dtype
    if (dt not in (torch.float32, torch.bfloat16)
            or any(t.dtype != dt or not t.is_cuda for t in tensors)):
        raise ValueError("red_step4: cost and states must be CUDA tensors, all "
                         "float32 or all bfloat16")
    bf16 = int(dt == torch.bfloat16)
    cost, s1, s2, s3, s4 = (t.contiguous() for t in tensors)
    Cin, H, W = cost.shape
    lib = load("red_step4")
    if packed is None:
        packed = pack_params(params, Cin, dt)
    if (not packed.is_cuda or packed.dtype != torch.float32
            or packed.numel() != lib.red_step4_param_floats(Cin, bf16)
            or packed.data_ptr() % 16):
        raise ValueError(f"red_step4: packed parameters ({packed.numel()} "
                         f"floats) do not fit Cin {Cin} in {dt}")
    dev = cost.device
    score = torch.empty((H, W), device=dev, dtype=dt)
    outs = [torch.empty_like(s) for s in (s1, s2, s3, s4)]
    scratch = torch.empty(lib.red_step4_scratch_floats(Cin, H, W, bf16), device=dev)
    tick = tickets(dev, lib.red_step4_tickets(Cin, H, W, bf16))
    convs = ctypes.c_int(0)
    entry = lib.red_step4_bf16 if bf16 else lib.red_step4_f32
    with torch.cuda.device(dev):
        rc = entry(cost.data_ptr(), Cin, s1.data_ptr(), s2.data_ptr(),
                   s3.data_ptr(), s4.data_ptr(), packed.data_ptr(),
                   score.data_ptr(), *(o.data_ptr() for o in outs),
                   scratch.data_ptr(), tick.data_ptr(), H, W,
                   ctypes.byref(convs), torch.cuda.current_stream(dev).cuda_stream)
    check(lib, rc, "red_step4")
    red_step4.launches += 1
    red_step4.launches_by_width[Cin] += 1
    cf_conv3x3.launches += convs.value
    if bf16:
        red_step4.launches_bf16 += 1
        cf_conv3x3.launches_bf16 += convs.value
    return (score, *outs)


red_step4.launches = 0
red_step4.launches_bf16 = 0
red_step4.launches_by_width = collections.Counter()
