"""CasMVSNet, the feedforward coarse-to-fine plane-sweep network
(counterpart of deep3d_aerial_tpu/models/casmvsnet.py):

  * 'fpn' feature pyramid (FeatureNet)
  * every stage: the whole variance cost volume (models/cascade.py; one
    K2v launch per chunk of 8 planes on CUDA), a CostRegNet3D hourglass
    (plain 3-D convs), a softmax over the planes, soft-argmax depth and the
    4-plane window confidence
  * stage 1 samples the depth range uniformly; later stages sample a window
    of ndepth x ratio x interval around the bilinear-resized previous depth

warp_impl 'kernel' runs K2v on CUDA tensors (its plain version on CPU
tensors); 'plain' runs the plain version everywhere. dtype float32 or
bfloat16: features, the volume and CostRegNet3D (cuDNN bfloat16 3-D convs)
in it; the head takes the scores in float32. warp_precision
'compensated' builds every volume with the double-single projection;
depth_shards = n > 1 regularizes each stage's volume as n independent
blocks of planes (models/cascade.py:blocked_volume_scores).
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
from .cascade import blocked_volume_scores, masked_softmax_depth_head, window_confidence
from .blocks import compensated_warp, compute_dtype
from .cost_reg import CostRegNet3D
from .feature_net import FeatureNet, multi_view_features


def check_volume_settings(warp_impl: str) -> None:
    """Refuse a warp_impl the volume models do not run (ValueError)."""
    if warp_impl not in ("kernel", "plain"):
        raise ValueError(f"warp_impl {warp_impl!r} (kernel, plain)")


def stage_features(feature: FeatureNet, imgs: torch.Tensor,
                   dtype: torch.dtype = torch.float32):
    """The three stages' features in `dtype`, each [V, h, w, C]
    (channels-last, the sweep kernels' layout)."""
    return [f.permute(0, 2, 3, 1).contiguous()
            for f in multi_view_features(feature, imgs.to(dtype))]


class CasMVSNet(nn.Module):
    def __init__(self, ndepths: Tuple[int, ...] = (48, 32, 8),
                 depth_interval_ratios: Tuple[float, ...] = (4.0, 2.0, 1.0),
                 num_depth: int = 384, base_channels: int = 8,
                 arch: str = "fpn", norm: str = "group",
                 warp_impl: str = "kernel", depth_shards: int = 1,
                 warp_precision: str = "float32", dtype=torch.float32):
        super().__init__()
        check_volume_settings(warp_impl)
        self.dtype = compute_dtype(dtype)
        self.compensated = compensated_warp(warp_precision)
        self.depth_shards = int(depth_shards)
        self.ndepths = tuple(int(d) for d in ndepths)
        self.depth_interval_ratios = tuple(float(r) for r in depth_interval_ratios)
        self.num_depth = num_depth
        self.warp_impl = warp_impl
        self.feature = FeatureNet(base_channels, arch=arch, norm=norm)
        for s, c in enumerate(self.feature.out_channels[:len(self.ndepths)]):
            self.add_module(f"cost_reg{s}", CostRegNet3D(c, norm=norm))

    def forward(self, imgs: torch.Tensor, rel_projs: torch.Tensor,
                depth_min, depth_max,
                mark: Optional[Callable[[str], None]] = None) -> Dict:
        """imgs [V, H, W, 3]; rel_projs [3, V-1, 4, 4] per-stage src-vs-ref
        transforms; scalar depth range. Returns the JAX model's dict: per
        stage depth and photometric_confidence, and the last stage's at the
        top level.

        `mark(label)`, when given, is called as each phase has been
        enqueued: 'features', then per stage s 'stage<s>.volume' (K2v),
        'stage<s>.cost_reg' (CostRegNet3D) and 'stage<s>' (the head)."""
        mark = mark or (lambda label: None)
        dev = imgs.device
        feats = stage_features(self.feature, imgs, self.dtype)
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
            tag = f"stage{s + 1}"
            scores = blocked_volume_scores(
                getattr(self, f"cost_reg{s}"), f, rel_projs[s], depths,
                warp_impl=self.warp_impl,
                mark=lambda label: mark(f"{tag}.{label}"),
                depth_shards=self.depth_shards, compensated=self.compensated)
            prob, depth, _ = masked_softmax_depth_head(scores.float(), depths)
            conf = window_confidence(prob)
            outputs[tag] = {"depth": depth, "photometric_confidence": conf}
            mark(tag)
        outputs["depth"] = depth
        outputs["photometric_confidence"] = conf
        return outputs
