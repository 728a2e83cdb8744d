"""Streaming cascade sweep (counterpart of
deep3d_aerial_tpu/models/cascade.py): the cost built `plane_chunk` planes at
a time, each plane folded through a recurrent regularizer into an online
softmax, so no [D, H, W, C] volume ever exists.

  * 'correlation' -- confidence-weighted correlation (AdaMVS; kernel K2 on
                     CUDA), regularized by RedStep2 (kernel K3)
  * 'variance'    -- variance over the views (MSREDNet; kernel K2v on
                     CUDA), regularized by RedStep4 (kernel K4)

Ported here: one depth block. Depth shards are not ported yet (ROADMAP,
section A).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.red_step2 import online_softmax_update
from ..ops.resize import upsample_axis_lerp
from ..ops.sweep import sweep_cost, sweep_cost_plain, sweep_var, sweep_var_plain
from ..ops.warp import plane_sweep_warp_single

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def variance_cost_plane(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                        rel_projs: torch.Tensor, depth_plane) -> torch.Tensor:
    """Variance cost at one plane ([H, W] or scalar) -> [H, W, C]:
    E[f^2] - E[f]^2 over the ref feature and the V-1 warped source
    features (K2v's plain version at one plane)."""
    H, W = ref_feat.shape[:2]
    d = torch.as_tensor(depth_plane, dtype=torch.float32, device=ref_feat.device)
    d = torch.broadcast_to(d, (H, W))[None]
    return sweep_var_plain(ref_feat, src_feats, rel_projs, d)[0].permute(1, 2, 0)


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
        return online_softmax_update(state, score, depth_value)

    @staticmethod
    def finalize(state: State) -> Tuple[torch.Tensor, torch.Tensor]:
        _, s, acc, pmax = state
        s = s + 1e-10
        return acc / s, pmax / s


def streaming_sweep(reg, up: bool, depths: torch.Tensor,
                    ref_feat: torch.Tensor, src_feats: torch.Tensor,
                    rel_projs: torch.Tensor, weights: Optional[torch.Tensor],
                    plane_chunk: int = 8, warp_impl: str = "kernel",
                    cost_mode: str = "correlation"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan over depth planes with O(H*W) state -> (depth, conf).

    ref_feat [H, W, C], src_feats [V-1, H, W, C] (channels-last, the sweep
    kernels' layout), rel_projs [V-1, 4, 4], depths [D] or [D, H, W].
    cost_mode 'correlation' weighs the views by weights [V-1, H, W] (None:
    uniform); 'variance' takes no weights. `reg` is a recurrent regularizer
    (RedStep2, RedStep4): reg.plane_step(device) gives its step,
    step(cost [C, H, W], *states) -> (score, *states), with the parameters
    gathered once for the sweep; its states come from reg.init_states(H, W);
    with `up` its scores and the plane depths are at 2H x 2W. A step that
    carries `folds_softmax` (RedStep2's on CUDA: kernel K3) takes the
    online-softmax state and the plane's depth and updates the state in
    place, so no score and no eager update leave the step.
    warp_impl 'kernel' builds each chunk's
    cost with the CUDA kernel (K2, K2v) on CUDA tensors, 'plain' always with
    its plain version.
    """
    H, W = ref_feat.shape[:2]
    dev = ref_feat.device
    D = depths.shape[0]
    if depths.ndim == 1:
        depths = depths[:, None, None].expand(D, H, W)
    if cost_mode == "variance":
        if weights is not None:
            raise ValueError("streaming_sweep: the variance cost takes no weights")
        var_fn = sweep_var if warp_impl == "kernel" else sweep_var_plain

        def cost_fn(chunk):
            return var_fn(ref_feat, src_feats, rel_projs, chunk)
    elif cost_mode == "correlation":
        if weights is None:
            weights = torch.ones((src_feats.shape[0], H, W), device=dev)
        corr_fn = sweep_cost if warp_impl == "kernel" else sweep_cost_plain

        def cost_fn(chunk):
            return corr_fn(ref_feat, src_feats, rel_projs, chunk, weights)
    else:
        raise ValueError(f"cost_mode {cost_mode!r} (correlation, variance)")

    out_shape = (2 * H, 2 * W) if up else (H, W)
    osm = OnlineSoftmaxState.init(out_shape, device=dev)
    states = reg.init_states(H, W, device=dev)
    step = reg.plane_step(dev)
    fold = getattr(step, "folds_softmax", False)
    # largest divisor of D not exceeding plane_chunk
    K = max(1, min(int(plane_chunk), D))
    while D % K:
        K -= 1
    for start in range(0, D, K):
        chunk = depths[start:start + K].contiguous()
        costs = cost_fn(chunk)
        # plane depths at the score resolution: integer 2x lerp
        dvs = upsample_axis_lerp(upsample_axis_lerp(chunk, 2, -2), 2, -1) \
            if up else chunk
        for k in range(K):
            if fold:
                _, *states = step(costs[k], *states, osm=osm, dv=dvs[k])
            else:
                score, *states = step(costs[k], *states)
                osm = OnlineSoftmaxState.update(osm, score, dvs[k])
    return OnlineSoftmaxState.finalize(osm)
