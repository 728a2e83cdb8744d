"""Cost-volume regularizers (counterpart of
deep3d_aerial_tpu/models/cost_reg.py):

  * CostRegNet2D -- 2D hourglass treating the D score planes as channels
                    (AdaMVS pair branch)
  * RedStep2     -- one depth plane of the 2-level ConvGRU regularizer
                    (AdaMVS); its step is kernel K3 (ops/red_step2.py) on CUDA
  * NormGRUCell  -- ConvGRU with one-group GroupNorms on gates and candidate
  * RedStep4     -- one depth plane of the 4-level NormGRU encoder-decoder
                    (MSREDNet); its step is kernel K4 (ops/red_step4.py) on
                    CUDA, built from the conv template K5 (ops/cf_conv.py)

  * CostRegNet3D -- 3-D hourglass over the whole [C, D, H, W] variance
                    volume (CasMVSNet, UCSNet): plain PyTorch 3-D convs
                    (cuDNN on CUDA); the JAX package computes it in XLA,
                    outside any Pallas kernel
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch
import torch.nn as nn

from ..ops import red_step4 as rs4
from ..ops.red_step2 import pack_params, red_step2, red_step2_plain
from .blocks import Conv2d, Conv3d, ConvBlock, ConvGRUCell, ConvTranspose2d, DeconvBlock


def _crop_like(x, ref):
    """Crop a decoder output to the skip tensor's spatial shape (transposed
    convs overshoot by one on odd input sizes)."""
    return x[(...,) + tuple(slice(0, s) for s in ref.shape[2:])]


class _PackedCache:
    """A kernel's packed weights, per compute dtype (the float32 parameters
    packed as 3xTF32 or bfloat16 fragments), rebuilt only when a parameter
    changed."""

    def __init__(self, pack):
        self._pack = pack
        self._key = None
        self._packed = {}

    def get(self, module: nn.Module, dtype: torch.dtype = torch.float32):
        key = tuple((p.data_ptr(), p._version) for p in module.parameters())
        if key != self._key:
            self._packed = {}
            self._key = key
        if dtype not in self._packed:
            self._packed[dtype] = self._pack(dict(module.named_parameters()), dtype)
        return self._packed[dtype]


class CostRegNet2D(nn.Module):
    """[N, D, H, W] -> [N, D, H, W] scores.

    The JAX module writes `ConvBlock(c)(ConvBlock(c, stride=2)(x))`, which
    constructs (and so numbers) the outer, stride-1 block first: the
    stride-2 blocks are ConvBlock_2, _4 and _6."""

    def __init__(self, channels: int, norm: str = "group"):
        super().__init__()
        c = channels
        self.convs = nn.ModuleList(
            [ConvBlock(c, c, stride=s, norm=norm) for s in (1, 1, 2, 1, 2, 1, 2)])
        self.deconvs = nn.ModuleList([DeconvBlock(c, c, norm=norm) for _ in range(3)])
        self.prob = Conv2d(c, c)

    def forward(self, x):
        cv = self.convs
        c0 = cv[0](x)
        c2 = cv[1](cv[2](c0))
        c4 = cv[3](cv[4](c2))
        x = cv[5](cv[6](c4))
        x = c4 + _crop_like(self.deconvs[0](x), c4)
        x = c2 + _crop_like(self.deconvs[1](x), c2)
        x = c0 + _crop_like(self.deconvs[2](x), c0)
        return self.prob(x)


class CostRegNet3D(nn.Module):
    """Hourglass over a [1, Cin, D, H, W] volume -> [1, 1, D, H, W] scores
    (D, H, W multiples of 8): 7 ConvBlocks (stride 2 at 1, 3 and 5), 3
    DeconvBlocks summed into the skips, and a biased 3x3x3 `prob` conv.
    GroupNorm statistics are per depth plane (models/blocks.py). On a card,
    run it with TF32 off (as the pipeline's dense_match does), or its convs
    are not float32."""

    def __init__(self, cin: int, base: int = 8, norm: str = "group"):
        super().__init__()
        b = base
        specs = [(cin, b, 1), (b, 2 * b, 2), (2 * b, 2 * b, 1),
                 (2 * b, 4 * b, 2), (4 * b, 4 * b, 1),
                 (4 * b, 8 * b, 2), (8 * b, 8 * b, 1)]
        self.convs = nn.ModuleList(
            [ConvBlock(ci, co, stride=s, norm=norm, ndim=3) for ci, co, s in specs])
        self.deconvs = nn.ModuleList(
            [DeconvBlock(ci, co, norm=norm, ndim=3)
             for ci, co in ((8 * b, 4 * b), (4 * b, 2 * b), (2 * b, b))])
        self.prob = Conv3d(b, 1)

    def forward(self, vol):
        cv, dc = self.convs, self.deconvs
        c0 = cv[0](vol)
        c2 = cv[2](cv[1](c0))
        c4 = cv[4](cv[3](c2))
        x = cv[6](cv[5](c4))
        x = c4 + _crop_like(dc[0](x), c4)
        x = c2 + _crop_like(dc[1](x), c2)
        x = c0 + _crop_like(dc[2](x), c0)
        return self.prob(x)


class RedStep2(nn.Module):
    """One recurrent-regularization step (2-level GRU), AdaMVS flavour.

    cost [Cin, H, W], states s1 [b, H, W], s2 [2b, H/2, W/2] for the base
    width b (channel-first, the layout K3 reads and writes) -> (score
    [2H, 2W] if `up` else [H, W], s1', s2'). impl 'kernel' runs K3 on CUDA
    tensors (its plain version on CPU tensors); 'plain' always runs the
    plain version. K3 is built for the published base width 8 (its GRU
    widths 8 and 16 are the kernel's layer shapes); at any other base the
    step runs its plain body on every device, decided here, once, from
    `base` (`self.kernel`), as the JAX package's RedStep2 takes its Pallas
    kernel only when `self.base == 8` (models/cost_reg.py:169).
    """

    def __init__(self, cin: int, up: bool = True, base: int = 8,
                 impl: str = "kernel"):
        super().__init__()
        if impl not in ("kernel", "plain"):
            raise ValueError(f"RedStep2 impl {impl!r} (kernel, plain)")
        b = base
        self.up = up
        self.base = b
        self.kernel = impl == "kernel" and base == 8
        self.conv1 = ConvBlock(cin, b, norm="none")
        self.gru1 = ConvGRUCell(b, b)
        self.conv2 = ConvBlock(b, 2 * b, stride=2, norm="none")
        self.gru2 = ConvGRUCell(2 * b, 2 * b)
        self.upconv1 = ConvTranspose2d(2 * b, b)
        if up:
            self.upconv2d = ConvTranspose2d(b, 1)
        else:
            self.out2d = Conv2d(b, 1)
        self._packed = _PackedCache(lambda p, dt: pack_params(p, up, dt))

    def _packed_params(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """K3's packed weights for `dtype`, rebuilt only when a parameter
        changed."""
        return self._packed.get(self, dtype)

    def plane_step(self, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> Callable:
        """The step as a function of (cost, s1, s2) on `device`, its
        parameters (and K3's packed weights for the compute `dtype`)
        gathered once: the streaming sweep calls it for every plane. On
        CUDA with impl 'kernel' the step also folds the score into the
        sweep's online-softmax state, step(cost, s1, s2, osm=state,
        dv=depth) -> (None, s1', s2') with `state` updated in place, and
        carries `folds_softmax`."""
        params = dict(self.named_parameters())
        if not self.kernel:
            return functools.partial(red_step2_plain, params, up=self.up)
        if device.type != "cuda":
            return functools.partial(red_step2, params, up=self.up)
        step = functools.partial(red_step2, params, up=self.up,
                                 packed=self._packed_params(dtype))
        step.folds_softmax = True
        return step

    def forward(self, cost, s1, s2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.plane_step(cost.device, cost.dtype)(cost, s1, s2)

    def init_states(self, H: int, W: int, device=None, dtype=torch.float32):
        b = self.base
        return (torch.zeros((b, H, W), device=device, dtype=dtype),
                torch.zeros((2 * b, (H + 1) // 2, (W + 1) // 2), device=device,
                            dtype=dtype))


class GroupNorm1(nn.Module):
    """GroupNorm with ONE group over the whole [C, H, W] map (the JAX
    NormGRUCell's nn.GroupNorm(num_groups=1, reduction_axes=(-3, -2, -1))),
    eps 1e-6. Not the per-row blocks.GroupNorm of the feature net."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return rs4.group_norm_global(x, self.weight, self.bias)


class NormGRUCell(nn.Module):
    """ConvGRU with GroupNorm1 on r, u and the candidate, on [C, H, W]
    maps: r, u = sigmoid(GN(conv([x, h]))), o = tanh(GN(conv([x, r*h]))),
    h' = u*h + (1-u)*o (the JAX package's NormGRUCell)."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.gates = Conv2d(cin + hidden, 2 * hidden)
        self.cand = Conv2d(cin + hidden, hidden)
        self.rn = GroupNorm1(hidden)
        self.un = GroupNorm1(hidden)
        self.on = GroupNorm1(hidden)

    def forward(self, x, h):
        return rs4.norm_gru_plain(dict(self.named_parameters()), x, h)


class RedStep4(nn.Module):
    """One 4-level recurrent encoder-decoder step, MSREDNet flavour.

    cost [Cin, H, W] (the variance cost; the step negates it), states
    s1 [b, H, W], s2 [2b, H/2, W/2], s3 [4b, H/4, W/4], s4 [8b, H/8, W/8]
    for the base width b (channel-first, the layout K4 reads and writes),
    H and W multiples of 8 -> (score [H, W], s1', s2', s3', s4'). impl
    'kernel' runs K4 on CUDA tensors (its plain version on CPU tensors);
    'plain' always runs the plain version. K4 is built for the published
    base width 8 (MSREDNet builds every RedStep4 so); at any other base the
    step runs its plain body on every device, decided here, once, from
    `base` (`self.kernel`), as the JAX package's RedStep4 takes its Pallas
    kernel only when `self.base == 8` (models/cost_reg.py:313).
    """

    def __init__(self, cin: int, base: int = 8, impl: str = "kernel"):
        super().__init__()
        if impl not in ("kernel", "plain"):
            raise ValueError(f"RedStep4 impl {impl!r} (kernel, plain)")
        b = base
        self.base = b
        self.kernel = impl == "kernel" and base == 8
        self.conv1 = ConvBlock(cin, 2 * b, stride=2, norm="none")
        self.conv2 = ConvBlock(2 * b, 4 * b, stride=2, norm="none")
        self.conv3 = ConvBlock(4 * b, 8 * b, stride=2, norm="none")
        self.gru1 = NormGRUCell(cin, b)
        self.gru2 = NormGRUCell(2 * b, 2 * b)
        self.gru3 = NormGRUCell(4 * b, 4 * b)
        self.gru4 = NormGRUCell(8 * b, 8 * b)
        self.upconv3 = DeconvBlock(8 * b, 4 * b, norm="none")
        self.upconv2 = DeconvBlock(4 * b, 2 * b, norm="none")
        self.upconv1 = DeconvBlock(2 * b, b, norm="none")
        self.out2d = Conv2d(b, 1)
        self._packed = _PackedCache(lambda p, dt: rs4.pack_params(p, cin, dt))

    def plane_step(self, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> Callable:
        """The step as a function of (cost, s1, s2, s3, s4) on `device`, its
        parameters (and K4's packed weights for the compute `dtype`)
        gathered once: the streaming sweep calls it for every plane."""
        params = dict(self.named_parameters())
        if not self.kernel:
            return functools.partial(rs4.red_step4_plain, params)
        packed = self._packed.get(self, dtype) if device.type == "cuda" else None
        return functools.partial(rs4.red_step4, params, packed=packed)

    def forward(self, cost, s1, s2, s3, s4) -> Tuple[torch.Tensor, ...]:
        return self.plane_step(cost.device, cost.dtype)(cost, s1, s2, s3, s4)

    def init_states(self, H: int, W: int, device=None, dtype=torch.float32):
        if H % 8 or W % 8:
            raise ValueError(f"RedStep4 needs H and W multiples of 8, got "
                             f"{H} x {W}")
        return tuple(torch.zeros((self.base << l, H >> l, W >> l), device=device,
                                 dtype=dtype) for l in range(4))
