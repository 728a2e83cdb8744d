"""MSREDNet, the cascade recurrent encoder-decoder MVS network of the
RED-Net family (counterpart of deep3d_aerial_tpu/models/msrednet.py):

  * 'unet' feature pyramid (FeatureNet)
  * every stage: the streaming sweep (models/cascade.py) with the variance
    cost (kernel K2v on CUDA), a RedStep4 regularizer (kernel K4 on CUDA,
    built from the conv template K5) and an online soft-argmax
  * every stage gives depth at its own resolution; stage 3 at full
    resolution. Stage sizes must be multiples of 8 (RedStep4's three
    stride-2 levels), so the frame's must be multiples of 32.

base_channels sets the feature widths (4b, 2b, b), so the cost widths; every
RedStep4 keeps its published base 8 whatever base_channels is, as the JAX
package builds it (deep3d_aerial_tpu/models/msrednet.py:67), so K4 and K5
run at Cin = 4b, 2b and b.

warp_impl / red_impl: 'kernel' runs the CUDA kernels on CUDA tensors (their
plain versions on CPU tensors); 'plain' runs the plain versions everywhere.
dtype: float32 or bfloat16 (features, cost chunks and states; the softmax
state stays float32). warp_precision and depth_shards as AdaMVS's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.depth_samplers import (
    resize_bilinear,
    uniform_depth_samples,
    window_depth_samples,
)
from .cascade import streaming_sweep
from .blocks import compensated_warp, compute_dtype
from .cost_reg import RedStep4
from .feature_net import FeatureNet, multi_view_features


class MSREDNet(nn.Module):
    def __init__(self, ndepths: Tuple[int, ...] = (48, 32, 8),
                 depth_interval_ratios: Tuple[float, ...] = (4.0, 2.0, 1.0),
                 num_depth: int = 384, base_channels: int = 8,
                 arch: str = "unet", norm: str = "group", plane_chunk: int = 8,
                 warp_impl: str = "kernel", red_impl: str = "kernel",
                 depth_shards: int = 1, warp_precision: str = "float32",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.compensated = compensated_warp(warp_precision)
        self.depth_shards = int(depth_shards)
        if warp_impl not in ("kernel", "plain"):
            raise ValueError(f"warp_impl {warp_impl!r} (kernel, plain)")
        self.ndepths = tuple(int(d) for d in ndepths)
        self.depth_interval_ratios = tuple(float(r) for r in depth_interval_ratios)
        self.num_depth = num_depth
        self.plane_chunk = plane_chunk
        self.warp_impl = warp_impl
        self.feature = FeatureNet(base_channels, arch=arch, norm=norm)
        for s, c in enumerate(self.feature.out_channels[:len(self.ndepths)]):
            self.add_module(f"red{s}", RedStep4(c, impl=red_impl))

    def forward(self, imgs: torch.Tensor, rel_projs: torch.Tensor,
                depth_min, depth_max,
                mark: Optional[Callable[[str], None]] = None) -> Dict:
        """imgs [V, H, W, 3]; rel_projs [3, V-1, 4, 4] per-stage
        src-vs-ref transforms; scalar depth range. Returns the JAX model's
        dict: per stage depth and photometric_confidence, and the last
        stage's at the top level.

        `mark(label)`, when given, is called as each phase has been
        enqueued ('features', 'stage1', 'stage2', 'stage3'), so a caller
        can time the phases (chip_smoke.py records CUDA events)."""
        mark = mark or (lambda label: None)
        dev = imgs.device
        feats = [f.permute(0, 2, 3, 1).contiguous()      # -> [V, h, w, C]
                 for f in multi_view_features(self.feature, imgs.to(self.dtype))]
        mark("features")
        depth_min = torch.as_tensor(depth_min, dtype=torch.float32, device=dev)
        depth_max = torch.as_tensor(depth_max, dtype=torch.float32, device=dev)
        interval = (depth_max - depth_min) / self.num_depth
        rel_projs = rel_projs.float()

        depth = conf = None
        outputs: Dict = {}
        for s, nd in enumerate(self.ndepths):
            f = feats[s]
            H, W = f.shape[1:3]
            if depth is None:
                depths = uniform_depth_samples(depth_min, depth_max, nd)
            else:
                depths = window_depth_samples(
                    resize_bilinear(depth, (H, W)), nd,
                    self.depth_interval_ratios[s] * interval)
            depth, conf = streaming_sweep(
                getattr(self, f"red{s}"), False, depths, f[0], f[1:],
                rel_projs[s], None, plane_chunk=self.plane_chunk,
                warp_impl=self.warp_impl, cost_mode="variance",
                depth_shards=self.depth_shards, compensated=self.compensated)
            outputs[f"stage{s + 1}"] = {"depth": depth,
                                        "photometric_confidence": conf}
            mark(f"stage{s + 1}")
        outputs["depth"] = depth
        outputs["photometric_confidence"] = conf
        return outputs
