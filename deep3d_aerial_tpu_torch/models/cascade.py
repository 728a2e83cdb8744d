"""Cascade machinery (counterpart of deep3d_aerial_tpu/models/cascade.py).

The streaming sweep: the cost built `plane_chunk` planes at a time, each
plane folded through a recurrent regularizer into an online softmax, so no
[D, H, W, C] volume ever exists.

  * 'correlation' -- confidence-weighted correlation (AdaMVS; kernel K2 on
                     CUDA), regularized by RedStep2 (kernel K3)
  * 'variance'    -- variance over the views (MSREDNet; kernel K2v on
                     CUDA), regularized by RedStep4 (kernel K4)

The volume path (CasMVSNet, UCSNet): the whole variance volume, built in
chunks of planes (kernel K2v on CUDA), regularized by a 3-D hourglass into
one score per plane and pixel, then a softmax head over the planes.

Features in bfloat16 (the models' dtype=torch.bfloat16, the JAX package's
dtype=jnp.bfloat16) give cost chunks, volumes and regularizer states in
bfloat16; the geometry, the view weights, the online-softmax state and the
heads stay float32 (the scores are upcast before the softmax).

`compensated` (the models' warp_precision 'compensated') projects every
sweep with the double-single chain (ops/warp.py; the sweep kernels'
compensated mode on CUDA).

Depth shards (`depth_shards` = n > 1, the JAX package's 'sp' blocks): D is
split into n contiguous blocks (`split_depth_blocks`, n the largest divisor
of D up to depth_shards), each swept or regularized on its own with the
same parameters, the recurrent states restarting at each block, and the
streaming sweep merges the blocks' online-softmax states exactly
(`OnlineSoftmaxState.merge_axis0`). It is part of the model, not of the
layout: in one process the blocks run one after another on one device,
through the same kernels and the same launches as one block. Under a mesh
whose 'sp' axis shards them (parallel/context.py: use_mesh), a rank
computes only its own blocks (`shard_range`) and gathers every block's
result from the others (`constrain`) before the merge, which then runs as
in one process.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.red_step2 import online_softmax_update
from ..ops.resize import upsample_axis_lerp
from ..ops.sweep import sweep_cost, sweep_cost_plain, sweep_var, sweep_var_plain
from ..ops.warp import plane_sweep_warp_single
from ..parallel.context import constrain, shard_range

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def variance_cost_plane(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                        rel_projs: torch.Tensor, depth_plane,
                        compensated: bool = False) -> torch.Tensor:
    """Variance cost at one plane ([H, W] or scalar) -> [H, W, C]:
    E[f^2] - E[f]^2 over the ref feature and the V-1 warped source
    features (K2v's plain version at one plane)."""
    H, W = ref_feat.shape[:2]
    d = torch.as_tensor(depth_plane, dtype=torch.float32, device=ref_feat.device)
    d = torch.broadcast_to(d, (H, W))[None]
    return sweep_var_plain(ref_feat, src_feats, rel_projs, d,
                           compensated)[0].permute(1, 2, 0)


def correlation_cost_plane(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                           rel_projs: torch.Tensor, depth_plane,
                           weights: Optional[torch.Tensor] = None,
                           compensated: bool = False) -> torch.Tensor:
    """Product-correlation cost at one plane -> [H, W, C]: weighted by
    weights [V-1, H, W] (AdaMVS view weights), or the plain mean over
    views when None."""
    H, W = ref_feat.shape[:2]
    warped = torch.stack([plane_sweep_warp_single(f, r, depth_plane, (H, W),
                                                  compensated)
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
    def merge_axis0(states: State) -> State:
        """Exact merge of per-depth-block states stacked on axis 0: the
        algebra of `update`, across blocks, out of place. A block that saw
        no plane (m = -inf) contributes nothing."""
        m, s, acc, pmax = states
        m_g = m.amax(dim=0)
        scale = torch.exp(m - m_g[None])
        scale = torch.where(torch.isfinite(m), scale, torch.zeros_like(scale))
        return (m_g, (s * scale).sum(0), (acc * scale).sum(0),
                (pmax * scale).amax(dim=0))

    @staticmethod
    def finalize(state: State) -> Tuple[torch.Tensor, torch.Tensor]:
        _, s, acc, pmax = state
        s = s + 1e-10
        return acc / s, pmax / s


def split_depth_blocks(depths: torch.Tensor, depth_shards: int):
    """-> (n, depths or [n, D/n, ...] blocks); n = the largest divisor of
    D not exceeding depth_shards."""
    D = depths.shape[0]
    n = largest_divisor(D, depth_shards)
    if n == 1:
        return 1, depths
    return n, depths.reshape(n, D // n, *depths.shape[1:])


def streaming_sweep(reg, up: bool, depths: torch.Tensor,
                    ref_feat: torch.Tensor, src_feats: torch.Tensor,
                    rel_projs: torch.Tensor, weights: Optional[torch.Tensor],
                    plane_chunk: int = 8, warp_impl: str = "kernel",
                    cost_mode: str = "correlation", depth_shards: int = 1,
                    compensated: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan over depth planes with O(H*W) state -> (depth, conf).

    ref_feat [H, W, C], src_feats [V-1, H, W, C] (channels-last, the sweep
    kernels' layout), rel_projs [V-1, 4, 4], depths [D] or [D, H, W].
    cost_mode 'correlation' weighs the views by weights [V-1, H, W] (None:
    uniform); 'variance' takes no weights. `reg` is a recurrent regularizer
    (RedStep2, RedStep4): reg.plane_step(device, dtype) gives its step,
    step(cost [C, H, W], *states) -> (score, *states), with the parameters
    gathered once for the sweep; its states come from reg.init_states(H, W),
    in the features' dtype (float32 or bfloat16, as are the cost chunks);
    with `up` its scores and the plane depths are at 2H x 2W. A step that
    carries `folds_softmax` (RedStep2's on CUDA: kernel K3) takes the
    online-softmax state and the plane's depth and updates the state in
    place, so no score and no eager update leave the step; it does so only
    with grad disabled (no_grad, inference_mode), since autograd cannot
    follow the in-place update.
    warp_impl 'kernel' builds each chunk's
    cost with the CUDA kernel (K2, K2v) on CUDA tensors, 'plain' always with
    its plain version; `compensated` takes the double-single projection.

    depth_shards = n > 1 (n from split_depth_blocks) sweeps n contiguous
    blocks of D/n planes one after another, each from fresh regularizer
    states (reg.init_states) and its own softmax state (a folding step folds
    into its block's), then merges the n states exactly (merge_axis0). The
    chunks are the one-block sweep's (K the largest divisor of D up to
    plane_chunk; a chunk may span two blocks), so the cost launches and
    the steps are the same as with one block. Under a mesh that shards the
    blocks over s ranks, a rank sweeps only its n/s blocks (shard_range), in
    chunks inside each block (K the largest divisor of D/n up to
    plane_chunk), so it launches its share of the cost chunks and steps;
    the blocks' states are gathered (constrain, one gather of the four
    stacked) and merged as in one process.
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
            return var_fn(ref_feat, src_feats, rel_projs, chunk, compensated)
    elif cost_mode == "correlation":
        if weights is None:
            weights = torch.ones((src_feats.shape[0], H, W), device=dev)
        corr_fn = sweep_cost if warp_impl == "kernel" else sweep_cost_plain

        def cost_fn(chunk):
            return corr_fn(ref_feat, src_feats, rel_projs, chunk, weights, compensated)
    else:
        raise ValueError(f"cost_mode {cost_mode!r} (correlation, variance)")

    out_shape = (2 * H, 2 * W) if up else (H, W)
    n, _ = split_depth_blocks(depths, depth_shards)
    block = D // n
    own = shard_range(n)
    step = reg.plane_step(dev, ref_feat.dtype)
    # the fold updates the softmax state in place, which autograd cannot
    # follow: with grad enabled the step returns its score (through K3's
    # KernelFn on CUDA) and the update is the out-of-place one
    fold = getattr(step, "folds_softmax", False) and not torch.is_grad_enabled()
    # largest divisor of the planes (a sharded rank's: of a block's) not
    # exceeding plane_chunk
    K = largest_divisor(D if len(own) == n else block, plane_chunk)
    blocks = []  # the softmax state of each of this rank's blocks
    for start in range(own.start * block, own.stop * block, K):
        chunk = depths[start:start + K].contiguous()
        costs = cost_fn(chunk)
        # plane depths at the score resolution: integer 2x lerp
        dvs = upsample_axis_lerp(upsample_axis_lerp(chunk, 2, -2), 2, -1) \
            if up else chunk
        for k in range(K):
            if (start + k) % block == 0:  # a block starts: fresh states
                osm = OnlineSoftmaxState.init(out_shape, device=dev)
                blocks.append(osm)
                states = reg.init_states(H, W, device=dev, dtype=ref_feat.dtype)
            if fold:
                _, *states = step(costs[k], *states, osm=osm, dv=dvs[k])
            else:
                score, *states = step(costs[k], *states)
                osm = OnlineSoftmaxState.update(osm, score, dvs[k])
                blocks[-1] = osm
    if n == 1:
        return OnlineSoftmaxState.finalize(blocks[0])
    # [blocks, 4, ...] -> every block's, from the ranks that swept them
    stacked = constrain(torch.stack([torch.stack(b) for b in blocks]))
    return OnlineSoftmaxState.finalize(OnlineSoftmaxState.merge_axis0(
        tuple(stacked.unbind(1))))


def largest_divisor(n: int, cap: int) -> int:
    """The largest divisor of n not exceeding cap (at least 1)."""
    k = max(1, min(int(cap), n))
    while n % k:
        k -= 1
    return k


# planes per K2v launch of the volume path, at most (the JAX package's
# _variance_volume_pallas chunk)
VOLUME_CHUNK = 8


def variance_cost_volume(feats: torch.Tensor, rel: torch.Tensor,
                         depths: torch.Tensor, warp_impl: str = "kernel",
                         compensated: bool = False) -> torch.Tensor:
    """The whole variance cost volume for the 3-D regularizer.

    feats [V, H, W, C] (channels-last, ref first), rel [V-1, 4, 4], depths
    [D] or [D, H, W] -> [1, C, D, H, W] in the features' dtype (float32 or
    bfloat16): E[f^2] - E[f]^2 over the ref and
    the V-1 warped source features. Built in chunks of K planes, K the
    largest divisor of D up to VOLUME_CHUNK; each chunk is one sweep_var
    call (one K2v launch on CUDA tensors with warp_impl 'kernel'; its plain
    version on CPU tensors or with 'plain') and one copy into the volume;
    `compensated` takes the double-single projection.
    """
    if warp_impl not in ("kernel", "plain"):
        raise ValueError(f"warp_impl {warp_impl!r} (kernel, plain)")
    ref, srcs = feats[0], feats[1:]
    H, W, C = ref.shape
    D = depths.shape[0]
    if depths.ndim == 1:
        depths = depths[:, None, None].expand(D, H, W)
    var_fn = sweep_var if warp_impl == "kernel" else sweep_var_plain
    K = largest_divisor(D, VOLUME_CHUNK)
    vol = torch.empty((1, C, D, H, W), device=ref.device, dtype=ref.dtype)
    for start in range(0, D, K):
        chunk = var_fn(ref, srcs, rel, depths[start:start + K].contiguous(),
                       compensated)
        vol[0, :, start:start + K].copy_(chunk.transpose(0, 1))
    return vol


def blocked_volume_scores(reg: Callable[[torch.Tensor], torch.Tensor],
                          feats: torch.Tensor, rel: torch.Tensor,
                          depths: torch.Tensor, warp_impl: str = "kernel",
                          mark: Optional[Callable[[str], None]] = None,
                          depth_shards: int = 1, compensated: bool = False
                          ) -> torch.Tensor:
    """Variance cost volume + 3-D regularizer -> scores [D, H, W].

    With depth_shards = n > 1 (n from split_depth_blocks) the volume is
    regularized as n independent blocks of D/n planes with the same
    parameters: the JAX package's blocked path, whose regularizer mixes
    nothing across block boundaries. The volume of every plane does not
    depend on the blocks, so it is built once, in the one-block chunks (the
    same K2v launches); its blocks then go through the regularizer one at a
    time, each as a batch of one: the 3-D convolutions round by batch size
    (oneDNN on the CPU, cuDNN's choice of algorithm on the card), and a
    block must come out the same wherever it is regularized. Block depths
    that are not multiples of 8 pad and crop as the JAX 'SAME' convs do.
    Under a mesh that shards the blocks over s ranks, a rank builds the
    planes of its n/s blocks only (shard_range), each block's volume in
    chunks of the largest divisor of D/n up to VOLUME_CHUNK, regularizes
    them, and gathers every block's scores (constrain). `mark(label)`,
    when given, is called once the volume ('volume') and the regularizer
    ('cost_reg') have been enqueued."""
    mark = mark or (lambda label: None)
    n, _ = split_depth_blocks(depths, depth_shards)
    D = depths.shape[0]
    own = shard_range(n)
    if len(own) == n:
        vol = variance_cost_volume(feats, rel, depths, warp_impl=warp_impl,
                                   compensated=compensated)[0]
        blocks = vol.reshape(vol.shape[0], n, D // n, *vol.shape[2:]).unbind(1)
    else:
        b = D // n
        blocks = [variance_cost_volume(feats, rel, depths[i * b:(i + 1) * b],
                                       warp_impl=warp_impl, compensated=compensated)[0]
                  for i in own]
    mark("volume")
    scores = torch.cat([reg(blk[None])[:, 0] for blk in blocks])
    if len(own) < n:
        scores = constrain(scores)
    scores = scores.reshape(D, *scores.shape[-2:])
    mark("cost_reg")
    return scores


def soft_argmax_depth(prob: torch.Tensor, depths: torch.Tensor) -> torch.Tensor:
    """Expected depth under prob [D, H, W]; depths [D] or [D, H, W]."""
    if depths.ndim == 1:
        depths = depths[:, None, None]
    return torch.sum(prob * depths, dim=0)


def window_confidence(prob: torch.Tensor, window: int = 4) -> torch.Tensor:
    """Sum of `window` consecutive probabilities around the expected index:
    prob [D, H, W] padded (1 front, 2 back) in D, a 4-tap sliding sum, and
    the sum gathered at the expected index TRUNCATED toward zero (the JAX
    code's astype(int32); its docstring says rounded), clipped to [0, D-1].
    A NaN index gathers at 0, as XLA converts NaN to 0."""
    D = prob.shape[0]
    padded = torch.nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
    summed = padded[0:D]
    for k in range(1, window):
        summed = summed + padded[k:k + D]
    ks = torch.arange(D, dtype=prob.dtype, device=prob.device)[:, None, None]
    idx = torch.sum(prob * ks, dim=0)
    # clamping before the cast truncates as the cast of the unclamped value
    # would, then clips; it keeps the cast defined for NaN and inf
    idx = torch.nan_to_num(idx, nan=0.0).clamp(0, D - 1).to(torch.int64)
    return torch.gather(summed, 0, idx[None])[0]


def masked_softmax_depth_head(scores: torch.Tensor, depths: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """softmax over D -> (prob [D, H, W], depth [H, W], maxprob [H, W])."""
    prob = torch.softmax(scores, dim=0)
    depth = soft_argmax_depth(prob, depths)
    return prob, depth, prob.amax(dim=0)
