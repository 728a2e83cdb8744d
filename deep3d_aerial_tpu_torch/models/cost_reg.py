"""Cost-volume regularizers of AdaMVS (counterpart of
deep3d_aerial_tpu/models/cost_reg.py):

  * CostRegNet2D -- 2D hourglass treating the D score planes as channels
  * RedStep2     -- one depth plane of the 2-level ConvGRU regularizer; its
                    step is kernel K3 (ops/red_step2.py) on CUDA

CostRegNet3D and RedStep4 (CasMVSNet, UCSNet, MSREDNet) are not ported yet
(ROADMAP, section A).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.red_step2 import pack_params, red_step2, red_step2_plain
from .blocks import Conv2d, ConvBlock, ConvGRUCell, ConvTranspose2d, DeconvBlock


def _crop_like(x, ref):
    """Crop a decoder output to the skip tensor's spatial shape (transposed
    convs overshoot by one on odd input sizes)."""
    return x[..., :ref.shape[-2], :ref.shape[-1]]


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


class RedStep2(nn.Module):
    """One recurrent-regularization step (2-level GRU), AdaMVS flavour.

    cost [Cin, H, W], states s1 [8, H, W], s2 [16, H/2, W/2] (channel-first,
    the layout K3 reads and writes) -> (score [2H, 2W] if `up` else [H, W],
    s1', s2'). impl 'kernel' runs K3 on CUDA tensors (its plain version on
    CPU tensors); 'plain' always runs the plain version.
    """

    def __init__(self, cin: int, up: bool = True, base: int = 8,
                 impl: str = "kernel"):
        super().__init__()
        if base != 8:
            raise NotImplementedError("RedStep2 is ported at base 8 only")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"RedStep2 impl {impl!r} (kernel, plain)")
        b = base
        self.up = up
        self.impl = impl
        self.conv1 = ConvBlock(cin, b, norm="none")
        self.gru1 = ConvGRUCell(b, b)
        self.conv2 = ConvBlock(b, 2 * b, stride=2, norm="none")
        self.gru2 = ConvGRUCell(2 * b, 2 * b)
        self.upconv1 = ConvTranspose2d(2 * b, b)
        if up:
            self.upconv2d = ConvTranspose2d(b, 1)
        else:
            self.out2d = Conv2d(b, 1)
        self._packed: Optional[List[torch.Tensor]] = None
        self._packed_key = None

    def _params(self):
        return dict(self.named_parameters())

    def _packed_params(self) -> List[torch.Tensor]:
        """K3's packed weights, rebuilt only when a parameter changed."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._packed_key:
            self._packed = pack_params(self._params(), self.up)
            self._packed_key = key
        return self._packed

    def forward(self, cost, s1, s2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.impl == "plain":
            return red_step2_plain(self._params(), cost, s1, s2, up=self.up)
        packed = self._packed_params() if cost.is_cuda else None
        return red_step2(self._params(), cost, s1, s2, up=self.up, packed=packed)

    def init_states(self, H: int, W: int, device=None):
        return (torch.zeros((8, H, W), device=device),
                torch.zeros((16, (H + 1) // 2, (W + 1) // 2), device=device))
