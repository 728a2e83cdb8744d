"""Streaming cascade sweep of AdaMVS (counterpart of
deep3d_aerial_tpu/models/cascade.py): confidence-weighted correlation cost
built `plane_chunk` planes at a time (kernel K2 on CUDA), each plane folded
through the RedStep2 regularizer (kernel K3 on CUDA) into an online
softmax, so no [D, H, W, C] volume ever exists.

Ported here: correlation mode with one depth block. The variance mode
(CasMVSNet, UCSNet), RedStep4 (MSREDNet) and depth shards are not ported
yet (ROADMAP, section A).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.resize import upsample_axis_lerp
from ..ops.sweep import sweep_cost, sweep_cost_plain
from ..ops.warp import plane_sweep_warp_single

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def correlation_cost_plane(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                           rel_projs: torch.Tensor, depth_plane,
                           weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Product-correlation cost at one plane -> [H, W, C]: weighted by
    weights [V-1, H, W] (AdaMVS view weights), or the plain mean over
    views when None."""
    H, W = ref_feat.shape[:2]
    warped = torch.stack([plane_sweep_warp_single(f, r, depth_plane, (H, W))
                          for f, r in zip(src_feats, rel_projs)])
    corr = warped * ref_feat[None]
    if weights is None:
        return corr.mean(0)
    w = weights[..., None]
    return (corr * w).sum(0) / (w.sum(0) + 1e-5)


class OnlineSoftmaxState:
    """Numerically stable online softmax over depth planes:
        depth = sum_d exp(s_d) * depth_d / sum_d exp(s_d)
        conf  = max_d exp(s_d) / sum_d exp(s_d)
    carried as (running max, scaled exp sum, scaled depth sum, scaled max
    prob)."""

    @staticmethod
    def init(shape, device=None) -> State:
        return (torch.full(shape, -torch.inf, device=device),
                torch.zeros(shape, device=device),
                torch.zeros(shape, device=device),
                torch.zeros(shape, device=device))

    @staticmethod
    def update(state: State, score: torch.Tensor,
               depth_value: torch.Tensor) -> State:
        m, s, acc, pmax = state
        m_new = torch.maximum(m, score)
        scale = torch.exp(m - m_new)
        e = torch.exp(score - m_new)
        return (m_new, s * scale + e, acc * scale + e * depth_value,
                torch.maximum(pmax * scale, e))

    @staticmethod
    def finalize(state: State) -> Tuple[torch.Tensor, torch.Tensor]:
        _, s, acc, pmax = state
        s = s + 1e-10
        return acc / s, pmax / s


def streaming_sweep(reg, up: bool, depths: torch.Tensor,
                    ref_feat: torch.Tensor, src_feats: torch.Tensor,
                    rel_projs: torch.Tensor, weights: Optional[torch.Tensor],
                    plane_chunk: int = 8, warp_impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan over depth planes with O(H*W) state -> (depth, conf).

    ref_feat [H, W, C], src_feats [V-1, H, W, C] (channels-last, the sweep
    kernel's layout), rel_projs [V-1, 4, 4], depths [D] or [D, H, W],
    weights [V-1, H, W] or None (uniform). `reg` is a RedStep2; with `up`
    its scores and the plane depths are at 2H x 2W. warp_impl 'kernel'
    builds each chunk's cost with K2 on CUDA tensors, 'plain' always with
    its plain version.
    """
    H, W = ref_feat.shape[:2]
    dev = ref_feat.device
    D = depths.shape[0]
    if depths.ndim == 1:
        depths = depths[:, None, None].expand(D, H, W)
    if weights is None:
        weights = torch.ones((src_feats.shape[0], H, W), device=dev)
    cost_fn = sweep_cost if warp_impl == "kernel" else sweep_cost_plain

    out_shape = (2 * H, 2 * W) if up else (H, W)
    osm = OnlineSoftmaxState.init(out_shape, device=dev)
    s1, s2 = reg.init_states(H, W, device=dev)
    # largest divisor of D not exceeding plane_chunk
    K = max(1, min(int(plane_chunk), D))
    while D % K:
        K -= 1
    for start in range(0, D, K):
        chunk = depths[start:start + K].contiguous()
        costs = cost_fn(ref_feat, src_feats, rel_projs, chunk, weights)
        # plane depths at the score resolution: integer 2x lerp
        dvs = upsample_axis_lerp(upsample_axis_lerp(chunk, 2, -2), 2, -1) \
            if up else chunk
        for k in range(K):
            score, s1, s2 = reg(costs[k], s1, s2)
            osm = OnlineSoftmaxState.update(osm, score, dvs[k])
    return OnlineSoftmaxState.finalize(osm)
