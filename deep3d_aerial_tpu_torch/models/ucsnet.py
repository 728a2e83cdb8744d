"""UCSNet, the uncertainty-aware cascade network (counterpart of
deep3d_aerial_tpu/models/ucsnet.py): CasMVSNet's volume stages
(models/casmvsnet.py) on a 'unet' feature pyramid, where every stage also
gives the probability-weighted standard deviation of its depth,
sigma = sqrt(max(sum_d prob_d (d - depth)^2, 1e-10)), and the next stage
samples center +- lamb * sigma after resizing both bilinearly. dtype,
warp_precision and depth_shards as CasMVSNet's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.depth_samplers import (
    resize_bilinear,
    uniform_depth_samples,
    variance_depth_samples,
)
from .cascade import (
    blocked_volume_scores,
    masked_softmax_depth_head,
    soft_argmax_depth,
    window_confidence,
)
from .blocks import compensated_warp, compute_dtype
from .casmvsnet import check_volume_settings, stage_features
from .cost_reg import CostRegNet3D
from .feature_net import FeatureNet


class UCSNet(nn.Module):
    def __init__(self, ndepths: Tuple[int, ...] = (64, 32, 8), lamb: float = 1.5,
                 num_depth: int = 384, base_channels: int = 8,
                 arch: str = "unet", norm: str = "group",
                 warp_impl: str = "kernel", depth_shards: int = 1,
                 warp_precision: str = "float32", dtype=torch.float32):
        super().__init__()
        check_volume_settings(warp_impl)
        self.dtype = compute_dtype(dtype)
        self.compensated = compensated_warp(warp_precision)
        self.depth_shards = int(depth_shards)
        self.ndepths = tuple(int(d) for d in ndepths)
        self.lamb = float(lamb)
        self.num_depth = num_depth
        self.warp_impl = warp_impl
        self.feature = FeatureNet(base_channels, arch=arch, norm=norm)
        for s, c in enumerate(self.feature.out_channels[:len(self.ndepths)]):
            self.add_module(f"cost_reg{s}", CostRegNet3D(c, norm=norm))

    def forward(self, imgs: torch.Tensor, rel_projs: torch.Tensor,
                depth_min, depth_max,
                mark: Optional[Callable[[str], None]] = None) -> Dict:
        """As CasMVSNet.forward; each stage's dict also holds `variance`,
        the depth's standard deviation sigma [h, w]."""
        mark = mark or (lambda label: None)
        dev = imgs.device
        feats = stage_features(self.feature, imgs, self.dtype)
        mark("features")
        depth_min = torch.as_tensor(depth_min, dtype=torch.float32, device=dev)
        depth_max = torch.as_tensor(depth_max, dtype=torch.float32, device=dev)

        depth = sigma = conf = None
        outputs: Dict = {}
        for s, nd in enumerate(self.ndepths):
            f = feats[s]
            H, W = f.shape[1:3]
            if depth is None:
                depths = uniform_depth_samples(depth_min, depth_max, nd)
            else:
                depths = variance_depth_samples(
                    resize_bilinear(depth, (H, W)), resize_bilinear(sigma, (H, W)),
                    nd, self.lamb)
            tag = f"stage{s + 1}"
            scores = blocked_volume_scores(
                getattr(self, f"cost_reg{s}"), f, rel_projs[s].float(), depths,
                warp_impl=self.warp_impl,
                mark=lambda label: mark(f"{tag}.{label}"),
                depth_shards=self.depth_shards, compensated=self.compensated)
            prob, depth, _ = masked_softmax_depth_head(scores.float(), depths)
            conf = window_confidence(prob)
            d = depths if depths.ndim == 3 else depths[:, None, None]
            sigma = torch.sqrt(torch.clamp_min(
                soft_argmax_depth(prob, (d - depth[None]) ** 2), 1e-10))
            outputs[tag] = {"depth": depth, "photometric_confidence": conf,
                            "variance": sigma}
            mark(tag)
        outputs["depth"] = depth
        outputs["photometric_confidence"] = conf
        return outputs
