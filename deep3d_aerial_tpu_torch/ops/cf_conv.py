"""Channel-first 3x3 convolution: CUDA kernel K5 and its plain PyTorch
version.

Replaces deep3d_aerial_tpu/ops/pallas_cf_conv.py:_k_same, _k_down and _k_up
(entry cf_conv3x3), the convs that the JAX package's tiled RedStep4
composes. x [Ci, H, W] ->
  'same'  [Co, H, W]                    3x3 stride 1, 'SAME'
  'down'  [Co, ceil(H/2), ceil(W/2)]    3x3 stride 2, 'SAME' (low-side pad)
  'up'    [Co, 2H, 2W]                  3x3 stride-2 'SAME' transposed conv
+ bias, then ReLU when `relu`. Weights are in the port's layouts: OIHW for
'same'/'down', [in, out, 3, 3] flipped for 'up' (ops/conv.py). Exact shapes:
none of the TPU kernel's row padding, row masks or column slabs.

The kernel is the conv template of csrc/red_step4.cu, an implicit GEMM on
the tensor cores in 3xTF32 (its design and bound are described there); its
weights are packed once into TF32 hi/lo fragments (`pack_weight`).

bfloat16 mode (x in bfloat16; the TPU kernel's precision='bf16'): the
template's bfloat16 instance, one mma.sync m16n8k16 bf16 product a tap
and 16 input channels, float32 sums, the weights packed once into bfloat16
fragments (`pack_weight(w, mode, torch.bfloat16)`), the output rounded to
bfloat16 after bias and ReLU. `cf_conv3x3_plain` computes the same in
float32 arithmetic on the rounded operands. The
RedStep4 step (ops/red_step4.py) launches it from C. `cf_conv3x3` launches
it for CUDA tensors, with the scratch its input-channel splits need, and
raises if the launch fails; it takes the plain version only for CPU
tensors. It counts its launches in `cf_conv3x3.launches`, those of the
bfloat16 entry also in `cf_conv3x3.launches_bf16`, and red_step4 adds the
launches its step makes. Where autograd needs a gradient, the
launch goes through ops/autograd.py's KernelFn (kernel forward,
cf_conv3x3_plain's VJP backward); inside a RedStep4 step K4's Function
covers it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .autograd import through_kernel
from .conv import conv2d_same, conv_transpose2d_same

MODES = ("same", "down", "up")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even), as float32."""
    return x.to(torch.bfloat16).float()


def no_round(x: torch.Tensor) -> torch.Tensor:
    """The float32 modes' rounding: none."""
    return x


def rounding(dtype: torch.dtype):
    """The rounding of a kernel's mode for values of `dtype`: bf16_round for
    bfloat16, else no_round (one plain body serves both modes)."""
    return bf16_round if dtype == torch.bfloat16 else no_round


def cf_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     mode: str = "same", relu: bool = True) -> torch.Tensor:
    """Plain version of K5 (F.pad + F.conv2d, or conv_transpose2d_same);
    for x in bfloat16, its bfloat16 mode: float32 arithmetic on x and the
    rounded weight, the output rounded to bfloat16."""
    if x.dtype == torch.bfloat16:
        y = cf_conv3x3_plain(x.float(), bf16_round(w), b.float(), mode=mode,
                             relu=relu)
        return y.to(torch.bfloat16)
    if mode == "up":
        y = conv_transpose2d_same(x[None], w, b)[0]
    elif mode in ("same", "down"):
        y = conv2d_same(x[None], w, b, stride=1 if mode == "same" else 2)[0]
    else:
        raise ValueError(f"cf_conv3x3 mode {mode!r} ({', '.join(MODES)})")
    return torch.relu(y) if relu else y


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 w = hi + lo exactly: hi rounded to TF32 (10 mantissa bits,
    nearest, ties away from zero, as the kernel's cvt.rna.tf32.f32), lo
    the rest, which the tensor core reads to its top 10 bits (3xTF32)."""
    bits = w.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w.float() - hi


def frag_floats(ci: int, co: int, bf16: bool = False) -> int:
    """Floats of one packed layer (channels rounded up to 8; the bfloat16
    fragments' input channels up to 16, two to a float)."""
    if bf16:
        return -(-ci // 16) * 16 * (-(-co // 8) * 8) * 9 // 2
    return -(-ci // 8) * 8 * (-(-co // 8) * 8) * 18


def pack_frags(w: torch.Tensor) -> torch.Tensor:
    """[Ci, 3, 3, Co] -> the kernel's B fragments, flat: per chunk of 8
    input channels, tap (ky * 3 + kx) and n8 fragment of output channels,
    32 lanes (g = lane // 4 the output channel, t = lane % 4) of
    (b0 hi, b1 hi, b0 lo, b1 lo), b0 the input channel t and b1 t + 4 of
    the chunk: mma.m16n8k8's TF32 B layout, one 16-byte load a lane.
    Channels are zero-padded to multiples of 8."""
    ci, co = w.shape[0], w.shape[3]
    ci8, co8 = -(-ci // 8) * 8, -(-co // 8) * 8
    w = torch.nn.functional.pad(w.float().reshape(ci, 9, co),
                                (0, co8 - co, 0, 0, 0, ci8 - ci))

    def frag(t):  # [ci8, 9, co8] -> [chunk, tap, nf, g, t, half]
        t = t.reshape(ci8 // 8, 2, 4, 9, co8 // 8, 8)  # chunk, half, t, tap, nf, g
        return t.permute(0, 3, 4, 5, 2, 1)

    hi, lo = split_tf32(w)
    return torch.stack([frag(hi), frag(lo)], dim=-2).reshape(-1).contiguous()


def pack_frags_bf16(w: torch.Tensor) -> torch.Tensor:
    """[Ci, 3, 3, Co] -> the B fragments of mma.m16n8k16 bf16, as a flat
    float32 tensor holding two bfloat16 values a float: per chunk of 16
    input channels, tap (ky * 3 + kx) and n8 fragment of output channels,
    32 lanes (g = lane // 4 the output channel, t = lane % 4) of the
    rounded weights of input channels (2t, 2t+1, 2t+8, 2t+9) of the chunk:
    the lane's two B registers, one 8-byte load. Input channels are
    zero-padded to a multiple of 16, output channels to one of 8."""
    ci, co = w.shape[0], w.shape[3]
    ci16, co8 = -(-ci // 16) * 16, -(-co // 8) * 8
    w = torch.nn.functional.pad(w.float().reshape(ci, 9, co),
                                (0, co8 - co, 0, 0, 0, ci16 - ci))
    # input channel 16 * chunk + 8 * h + 2 * t + p
    t = w.reshape(ci16 // 16, 2, 4, 2, 9, co8 // 8, 8)  # chunk, h, t, p, tap, nf, g
    t = t.permute(0, 4, 5, 6, 2, 1, 3)                  # chunk, tap, nf, g, t, h, p
    return t.to(torch.bfloat16).reshape(-1).view(torch.float32).contiguous()


def pack_weight(w: torch.Tensor, mode: str,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's packed weight (pack_frags) of a conv (OIHW) or of a
    transposed conv ([in, out, 3, 3], flipped), split into TF32 hi + lo
    once here rather than at every launch; for `dtype` bfloat16 the
    bfloat16 fragments (pack_frags_bf16)."""
    wp = w.permute(0, 2, 3, 1) if mode == "up" else w.permute(1, 2, 3, 0)
    return pack_frags_bf16(wp) if dtype == torch.bfloat16 else pack_frags(wp)


def cf_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               mode: str = "same", relu: bool = True,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 on CUDA tensors (`packed` = pack_weight(w, mode), to skip
    repacking per call); cf_conv3x3_plain on CPU tensors."""
    if not x.is_cuda:
        return cf_conv3x3_plain(x, w, b, mode=mode, relu=relu)
    return through_kernel(
        lambda x, w, b: _launch(x, w, b, mode, relu, packed),
        lambda x, w, b: cf_conv3x3_plain(x, w, b, mode=mode, relu=relu),
        (x, w, b))


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str,
            relu: bool, packed: Optional[torch.Tensor]) -> torch.Tensor:
    from .cuda_build import check, load, tickets

    if mode not in MODES:
        raise ValueError(f"cf_conv3x3 mode {mode!r} ({', '.join(MODES)})")
    Ci, H, W = x.shape
    Co = w.shape[1] if mode == "up" else w.shape[0]
    wi = w.shape[0] if mode == "up" else w.shape[1]
    if wi != Ci or tuple(w.shape[2:]) != (3, 3) or tuple(b.shape) != (Co,):
        raise ValueError(f"cf_conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} do not fit mode {mode!r}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cf_conv3x3: x must be float32 or bfloat16, got {x.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if packed is None:
        packed = pack_weight(w, mode, x.dtype)
    x, b = x.contiguous(), b.contiguous()
    for name, t in (("x", x), ("w", packed), ("b", b)):
        if not t.is_cuda or t.dtype != (x.dtype if name == "x" else torch.float32):
            raise ValueError(f"cf_conv3x3: {name} must be a CUDA tensor of "
                             "float32 (x: float32 or bfloat16), got "
                             f"{t.dtype} on {t.device}")
    want = frag_floats(Ci, Co, bf16)
    if packed.numel() != want or packed.data_ptr() % 16:
        raise ValueError(f"cf_conv3x3: packed weight of {packed.numel()} "
                         f"floats for Ci {Ci}, Co {Co} (want {want}, 16-byte "
                         "aligned)")
    shape = {"same": (Co, H, W), "down": (Co, (H + 1) // 2, (W + 1) // 2),
             "up": (Co, 2 * H, 2 * W)}[mode]
    out = torch.empty(shape, device=x.device, dtype=x.dtype)
    lib = load("red_step4")
    m = MODES.index(mode)
    scratch = torch.empty(lib.cf_conv3x3_scratch_floats(Ci, Co, H, W, m, int(bf16)),
                          device=x.device)
    tick = tickets(x.device, lib.cf_conv3x3_tickets(Ci, Co, H, W, m, int(bf16)))
    entry = lib.cf_conv3x3_bf16 if bf16 else lib.cf_conv3x3_f32
    with torch.cuda.device(x.device):
        rc = entry(x.data_ptr(), packed.data_ptr(), b.data_ptr(), Ci, Co, H, W,
                   m, int(relu), out.data_ptr(), scratch.data_ptr(),
                   tick.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, rc, "cf_conv3x3")
    cf_conv3x3.launches += 1
    if bf16:
        cf_conv3x3.launches_bf16 += 1
    return out


cf_conv3x3.launches = 0
cf_conv3x3.launches_bf16 = 0
