"""Feature pyramids (counterpart of deep3d_aerial_tpu/models/feature_net.py):

  * 'fpn'    -- FPN top-down merge: nearest 2x upsampling plus 1x1 lateral
                convs, 3x3 output convs (CasMVSNet)
  * 'unet'   -- deconv-fuse decoder (MSREDNet, UCSNet)
  * 'branch' -- the UNet decoder plus two avg-pool context branches per
                stage (AdaMVS)

Stages at 1/4, 1/2 and 1/1 resolution with [4b, 2b, b] channels, NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .blocks import Conv2d, ConvBlock, DeconvFuse, avgpool_branch, upsample_nearest2x


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, arch: str = "branch",
                 norm: str = "group"):
        super().__init__()
        if arch not in ("fpn", "branch", "unet"):
            raise ValueError(f"unknown feature arch {arch!r}")
        if arch == "branch" and base_channels < 2:
            # stage 3's branches would have b // 2 = 0 channels; the JAX
            # initializer divides by their fan and raises ZeroDivisionError
            raise ValueError(f"the 'branch' feature net needs a base width of 2 or "
                             f"more, got {base_channels}")
        b = base_channels
        self.base_channels = b
        self.arch = arch
        specs = [(3, b, 3, 1), (b, b, 3, 1),
                 (b, 2 * b, 5, 2), (2 * b, 2 * b, 3, 1), (2 * b, 2 * b, 3, 1),
                 (2 * b, 4 * b, 5, 2), (4 * b, 4 * b, 3, 1), (4 * b, 4 * b, 3, 1)]
        self.convs = nn.ModuleList(
            [ConvBlock(ci, co, k, s, norm=norm) for ci, co, k, s in specs])
        if arch == "fpn":
            self.out1 = Conv2d(4 * b, 4 * b, 1, bias=False)
            self.inner1 = Conv2d(2 * b, 4 * b, 1)
            self.out2 = Conv2d(4 * b, 2 * b, 3, bias=False)
            self.inner2 = Conv2d(b, 4 * b, 1)
            self.out3 = Conv2d(4 * b, b, 3, bias=False)
            return
        # 'branch' heads see [ctx1, ctx2, x]: the stage's channels and two
        # branches of half as many (b // 2 at stage 3: 2b - 1 in all at an
        # odd base width, as the JAX heads infer from their input)
        heads = [4 * b, 2 * b, b]
        if arch == "branch":
            for stage, (cin, cbr) in enumerate(((4 * b, 2 * b), (2 * b, b),
                                                (b, b // 2)), start=1):
                heads[stage - 1] += 2 * cbr
                for j in (1, 2):
                    self.add_module(f"branch{stage}_{j}",
                                    ConvBlock(cin, cbr, kernel=1, norm=norm))
        self.out1 = Conv2d(heads[0], 4 * b, 1, bias=False)
        self.deconv1 = DeconvFuse(4 * b, 2 * b, 2 * b, norm=norm)
        self.out2 = Conv2d(heads[1], 2 * b, 1, bias=False)
        self.deconv2 = DeconvFuse(2 * b, b, b, norm=norm)
        self.out3 = Conv2d(heads[2], b, 1, bias=False)

    @property
    def out_channels(self) -> Tuple[int, int, int]:
        b = self.base_channels
        return (4 * b, 2 * b, b)

    def _head(self, x, stage: int, out: Conv2d):
        if self.arch == "unet":
            return out(x)
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
        if self.arch == "fpn":
            s1 = self.out1(conv2)
            intra = upsample_nearest2x(conv2) + self.inner1(conv1)
            s2 = self.out2(intra)
            intra = upsample_nearest2x(intra) + self.inner2(conv0)
            return s1, s2, self.out3(intra)
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
