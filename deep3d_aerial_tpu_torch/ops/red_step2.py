"""One RedStep2 recurrent-regularizer step: CUDA kernel K3 and its plain
PyTorch version.

Replaces deep3d_aerial_tpu/ops/pallas_red.py:_red_kernel (entries
red_step2_fused / red_step2_tiled). Channel-first tensors: cost [Cin, H, W]
(Cin in 8, 16, 32; the sweep_cost output planes, read as they are), states
s1 [8, H, W] and s2 [16, ceil(H/2), ceil(W/2)] -> (score, s1', s2') with
score [2H, 2W] when `up` else [H, W]. `params` maps the names of
models.cost_reg.RedStep2's parameters (conv1.conv.weight, gru1.gates.weight,
..., upconv2d.weight or out2d.weight) to tensors; transposed-conv weights
are in PyTorch's [in, out, 3, 3] layout, flipped (ops/conv.py).

The kernel source, with its design, launches per step and bound, is
csrc/red_step2.cu. `red_step2` launches it for CUDA tensors and raises if the
launch fails; it takes the plain version only for CPU tensors. It counts one
launch per step in `red_step2.launches`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .conv import conv2d_same, conv_transpose2d_same

Params = Dict[str, torch.Tensor]


def _gru_plain(p: Params, name: str, x: torch.Tensor, h: torch.Tensor):
    hid = h.shape[0]
    g = conv2d_same(torch.cat([x, h])[None], p[f"{name}.gates.weight"],
                    p[f"{name}.gates.bias"])[0]
    r, u = torch.sigmoid(g[:hid]), torch.sigmoid(g[hid:])
    c = torch.tanh(conv2d_same(torch.cat([x, r * h])[None],
                               p[f"{name}.cand.weight"],
                               p[f"{name}.cand.bias"])[0])
    return u * h + (1.0 - u) * c


def red_step2_plain(params: Params, cost: torch.Tensor, s1: torch.Tensor,
                    s2: torch.Tensor, *, up: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 (F.conv2d / F.conv_transpose2d)."""
    p = params
    H, W = cost.shape[-2:]
    x1 = torch.relu(conv2d_same(cost[None], p["conv1.conv.weight"],
                                p["conv1.conv.bias"])[0])
    r1 = _gru_plain(p, "gru1", x1, s1)
    x2 = torch.relu(conv2d_same(r1[None], p["conv2.conv.weight"],
                                p["conv2.conv.bias"], stride=2)[0])
    r2 = _gru_plain(p, "gru2", x2, s2)
    up1 = conv_transpose2d_same(r2[None], p["upconv1.weight"],
                                p["upconv1.bias"])[0][:, :H, :W]
    fused = torch.relu(up1 + r1)
    if up:
        score = conv_transpose2d_same(fused[None], p["upconv2d.weight"],
                                      p["upconv2d.bias"])[0, 0]
    else:
        score = conv2d_same(fused[None], p["out2d.weight"], p["out2d.bias"])[0, 0]
    return score, r1, r2


# kernel weight order of the C entry, each packed [ci][ky][kx][co] + bias
_LAYERS = ("conv1.conv", "gru1.gates", "gru1.cand", "conv2.conv",
           "gru2.gates", "gru2.cand", "upconv1")


def pack_params(params: Params, up: bool) -> List[torch.Tensor]:
    """The 8 packed weight buffers K3 reads: convs OIHW -> [I, 3, 3, O],
    transposed convs [I, O, 3, 3] -> [I, 3, 3, O], each followed by its
    bias."""
    score = "upconv2d" if up else "out2d"
    out = []
    for name in _LAYERS + (score,):
        w = params[f"{name}.weight"].float()
        transposed = name.startswith("upconv")
        wp = w.permute(0, 2, 3, 1) if transposed else w.permute(1, 2, 3, 0)
        out.append(torch.cat([wp.reshape(-1),
                              params[f"{name}.bias"].float()]).contiguous())
    return out


def red_step2(params: Params, cost: torch.Tensor, s1: torch.Tensor,
              s2: torch.Tensor, *, up: bool,
              packed: Optional[List[torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors (`packed` = pack_params(params, up), to skip
    repacking per plane); red_step2_plain on CPU tensors."""
    if not cost.is_cuda:
        return red_step2_plain(params, cost, s1, s2, up=up)
    from .cuda_build import check, load

    Cin, H, W = cost.shape
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    if tuple(s1.shape) != (8, H, W) or tuple(s2.shape) != (16, H2, W2):
        raise ValueError(f"red_step2: states {tuple(s1.shape)}, "
                         f"{tuple(s2.shape)} do not fit cost {tuple(cost.shape)}")
    tensors = [cost, s1, s2]
    if any(t.dtype != torch.float32 or not t.is_cuda for t in tensors):
        raise ValueError("red_step2: cost and states must be float32 CUDA tensors")
    cost, s1, s2 = (t.contiguous() for t in tensors)
    if packed is None:
        packed = pack_params(params, up)
    dev = cost.device
    score = torch.empty((2 * H, 2 * W) if up else (H, W), device=dev)
    s1n = torch.empty_like(s1)
    s2n = torch.empty_like(s2)
    scratch = torch.empty(32 * H * W + 48 * H2 * W2, device=dev)
    lib = load("red_step2")
    rc = lib.red_step2_f32(cost.data_ptr(), Cin, s1.data_ptr(), s2.data_ptr(),
                           *(w.data_ptr() for w in packed),
                           score.data_ptr(), s1n.data_ptr(), s2n.data_ptr(),
                           scratch.data_ptr(), H, W, int(up),
                           torch.cuda.current_stream(dev).cuda_stream)
    check(lib, rc, "red_step2")
    red_step2.launches += 1
    return score, s1n, s2n


red_step2.launches = 0
