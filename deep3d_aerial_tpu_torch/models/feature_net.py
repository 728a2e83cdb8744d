"""AdaMVS feature pyramid, arch 'branch' (counterpart of
deep3d_aerial_tpu/models/feature_net.py): UNet decoder plus two avg-pool
context branches per stage. Stages at 1/4, 1/2 and 1/1 resolution with
[4b, 2b, b] channels, NCHW. The 'fpn' and 'unet' archs are not ported yet
(ROADMAP, section A).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .blocks import Conv2d, ConvBlock, DeconvFuse, avgpool_branch


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, arch: str = "branch",
                 norm: str = "group"):
        super().__init__()
        if arch != "branch":
            raise NotImplementedError(
                f"FeatureNet arch {arch!r} is not ported (ROADMAP A: "
                "CasMVSNet/UCSNet)")
        b = base_channels
        self.base_channels = b
        specs = [(3, b, 3, 1), (b, b, 3, 1),
                 (b, 2 * b, 5, 2), (2 * b, 2 * b, 3, 1), (2 * b, 2 * b, 3, 1),
                 (2 * b, 4 * b, 5, 2), (4 * b, 4 * b, 3, 1), (4 * b, 4 * b, 3, 1)]
        self.convs = nn.ModuleList(
            [ConvBlock(ci, co, k, s, norm=norm) for ci, co, k, s in specs])
        for stage, (cin, cbr) in enumerate(((4 * b, 2 * b), (2 * b, b),
                                            (b, b // 2)), start=1):
            for j in (1, 2):
                self.add_module(f"branch{stage}_{j}",
                                ConvBlock(cin, cbr, kernel=1, norm=norm))
        self.out1 = Conv2d(8 * b, 4 * b, 1, bias=False)
        self.deconv1 = DeconvFuse(4 * b, 2 * b, 2 * b, norm=norm)
        self.out2 = Conv2d(4 * b, 2 * b, 1, bias=False)
        self.deconv2 = DeconvFuse(2 * b, b, b, norm=norm)
        self.out3 = Conv2d(2 * b, b, 1, bias=False)

    @property
    def out_channels(self) -> Tuple[int, int, int]:
        b = self.base_channels
        return (4 * b, 2 * b, b)

    def _head(self, x, stage: int, out: Conv2d):
        br1 = avgpool_branch(x, 4, getattr(self, f"branch{stage}_1"))
        br2 = avgpool_branch(x, 8, getattr(self, f"branch{stage}_2"))
        return out(torch.cat([br1, br2, x], dim=1))

    def forward(self, x):
        """x [N, 3, H, W] -> (s1 [N,4b,H/4,W/4], s2 [N,2b,H/2,W/2],
        s3 [N,b,H,W])."""
        c = self.convs
        conv0 = c[1](c[0](x))
        conv1 = c[4](c[3](c[2](conv0)))
        conv2 = c[7](c[6](c[5](conv1)))
        s1 = self._head(conv2, 1, self.out1)
        intra = self.deconv1(conv1, conv2)
        s2 = self._head(intra, 2, self.out2)
        intra = self.deconv2(conv0, intra)
        s3 = self._head(intra, 3, self.out3)
        return s1, s2, s3


def multi_view_features(feature: FeatureNet, imgs: torch.Tensor):
    """imgs [V, H, W, 3] (the dataset's layout) -> the 3 stage tensors,
    each [V, C, h, w]: one batch over views with shared weights. Each view
    is normalized on its own (GroupNorm statistics are per image row)."""
    return feature(imgs.permute(0, 3, 1, 2))
