"""AdaMVS, the pipeline's default model (counterpart of
deep3d_aerial_tpu/models/adamvs.py):

  * 'branch' feature pyramid (FeatureNet)
  * stage 1: one product-correlation volume per source view (kernel K1 on
    CUDA), a shared 2D hourglass (CostRegNet2D) over the V-1 volumes as a
    batch -> per-view depth and confidence; the confidences are the view
    weights of every stage
  * every stage: the streaming sweep (models/cascade.py; kernels K2 and K3
    on CUDA) with a RedStep2 regularizer and an online soft-argmax
  * stages 1-2 give depth at twice their feature resolution, stage 3 at
    full resolution.

warp_impl / red_impl: 'kernel' runs the CUDA kernels on CUDA tensors (their
plain versions on CPU tensors); 'plain' runs the plain versions everywhere.
dtype: float32, or bfloat16 (the JAX package's dtype=jnp.bfloat16): the
images are cast to it, and features, pair volumes, cost chunks and states
follow; the pair branch's softmax, the view weights and the sweeps' outputs
stay float32.
warp_precision: 'float32', or 'compensated' (the double-single projection
in every sweep, the pair volumes' included; the JAX package's
set_high_precision_warp(True)). depth_shards: each stage's planes swept as
that many independent blocks merged exactly (models/cascade.py); the pair
branch is not blocked.
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
from ..ops.sweep import sweep_corr, sweep_corr_plain
from .cascade import streaming_sweep
from .blocks import compensated_warp, compute_dtype
from .cost_reg import CostRegNet2D, RedStep2
from .feature_net import FeatureNet, multi_view_features


def pair_corr_volumes(f1: torch.Tensor, rel1: torch.Tensor,
                      depths1: torch.Tensor, warp_impl: str = "kernel",
                      compensated: bool = False) -> torch.Tensor:
    """Per-source-view correlation volumes [V-1, D, H1, W1] from stage-1
    features f1 [V, H1, W1, C] (channels-last), rel1 [V-1, 4, 4] and the
    uniform planes depths1 [D]: one K1 launch writes them all."""
    H1, W1 = f1.shape[1:3]
    D = depths1.shape[0]
    d_hw = depths1[:, None, None].expand(D, H1, W1).contiguous()
    corr_fn = sweep_corr if warp_impl == "kernel" else sweep_corr_plain
    return corr_fn(f1[0], f1[1:], rel1, d_hw, compensated)


class PairBranch(nn.Module):
    """Per-source-view matching head: CostRegNet2D over the correlation
    volumes -> (confidence, pair depth) at stage-1 resolution."""

    def __init__(self, ndepth: int, norm: str = "group"):
        super().__init__()
        self.reg = CostRegNet2D(ndepth, norm=norm)

    def forward(self, corr, depths1):
        prob = torch.softmax(self.reg(corr).float(), dim=1)  # [V-1, D, H, W]
        conf = prob.max(dim=1).values
        pair_depth = (prob * depths1[None, :, None, None]).sum(dim=1)
        return conf, pair_depth


class AdaMVS(nn.Module):
    def __init__(self, ndepths: Tuple[int, ...] = (48, 32, 8),
                 depth_interval_ratios: Tuple[float, ...] = (4.0, 2.0, 1.0),
                 num_depth: int = 384, base_channels: int = 8,
                 norm: str = "group", plane_chunk: int = 8,
                 warp_impl: str = "kernel", red_impl: str = "kernel",
                 depth_shards: int = 1, warp_precision: str = "float32",
                 dtype=torch.float32):
        super().__init__()
        for name, impl in (("warp_impl", warp_impl), ("red_impl", red_impl)):
            if impl not in ("kernel", "plain"):
                raise ValueError(f"{name} {impl!r} (kernel, plain)")
        self.dtype = compute_dtype(dtype)
        self.compensated = compensated_warp(warp_precision)
        self.depth_shards = int(depth_shards)
        self.ndepths = tuple(int(d) for d in ndepths)
        self.depth_interval_ratios = tuple(float(r) for r in depth_interval_ratios)
        self.num_depth = num_depth
        self.plane_chunk = plane_chunk
        self.warp_impl = warp_impl
        self.feature = FeatureNet(base_channels, arch="branch", norm=norm)
        self.pair_reg = PairBranch(self.ndepths[0], norm=norm)
        chans = self.feature.out_channels
        n = len(self.ndepths)
        for s in range(n):
            self.add_module(f"red{s}", RedStep2(chans[s], up=s < n - 1,
                                                impl=red_impl))

    def forward(self, imgs: torch.Tensor, rel_projs: torch.Tensor,
                depth_min, depth_max,
                mark: Optional[Callable[[str], None]] = None) -> Dict:
        """imgs [V, H, W, 3]; rel_projs [3, V-1, 4, 4] per-stage
        src-vs-ref transforms; scalar depth range. Returns the JAX model's
        dict: per stage depth and photometric_confidence (stage1 also
        pair_results [V-1, H1, W1] and pair_confidence), and the last
        stage's depth and photometric_confidence at the top level.

        `mark(label)`, when given, is called as each phase has been
        enqueued ('features', 'pair', 'stage1', 'stage2', 'stage3'), so a
        caller can time the phases (chip_smoke.py records CUDA events)."""
        mark = mark or (lambda label: None)
        dev = imgs.device
        feats = [f.permute(0, 2, 3, 1).contiguous()      # -> [V, h, w, C]
                 for f in multi_view_features(self.feature, imgs.to(self.dtype))]
        mark("features")
        depth_min = torch.as_tensor(depth_min, dtype=torch.float32, device=dev)
        depth_max = torch.as_tensor(depth_max, dtype=torch.float32, device=dev)
        interval = (depth_max - depth_min) / self.num_depth
        rel_projs = rel_projs.float()

        # stage 1: per-view matching -> view weights
        depths1 = uniform_depth_samples(depth_min, depth_max, self.ndepths[0])
        pair_corrs = pair_corr_volumes(feats[0], rel_projs[0], depths1,
                                       self.warp_impl, self.compensated)
        view_weights, pair_depths = self.pair_reg(pair_corrs, depths1)
        mark("pair")

        depth = conf = None
        outputs: Dict = {}
        for s, nd in enumerate(self.ndepths):
            f = feats[s]
            H, W = f.shape[1:3]
            up = s < len(self.ndepths) - 1
            if depth is None:
                depths = uniform_depth_samples(depth_min, depth_max, nd)
            else:
                depths = window_depth_samples(
                    resize_bilinear(depth, (H, W)), nd,
                    self.depth_interval_ratios[s] * interval)
            weights = resize_bilinear(view_weights, (H, W))
            depth, conf = streaming_sweep(
                getattr(self, f"red{s}"), up, depths, f[0], f[1:],
                rel_projs[s], weights, plane_chunk=self.plane_chunk,
                warp_impl=self.warp_impl, depth_shards=self.depth_shards,
                compensated=self.compensated)
            outputs[f"stage{s + 1}"] = {"depth": depth,
                                        "photometric_confidence": conf}
            if s == 0:
                outputs["stage1"]["pair_results"] = pair_depths
                outputs["stage1"]["pair_confidence"] = view_weights
            mark(f"stage{s + 1}")
        outputs["depth"] = depth
        outputs["photometric_confidence"] = conf
        return outputs
