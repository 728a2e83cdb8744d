"""Fused plane-sweep correlation: CUDA kernels K1 (pair) and K2 (cost),
with their plain PyTorch versions.

  sweep_corr  (K1)  one source view, K planes -> [K, H, W]
                    mean_c(ref * warp(src))                  (AdaMVS pair branch)
  sweep_cost  (K2)  all V source views, K planes -> [K, C, H, W]
                    sum_v w_v * ref * warp(src_v) / (sum_v w_v + 1e-5)
                                                             (every cascade stage)

They replace deep3d_aerial_tpu/ops/pallas_sweep.py:_sweep_corr_kernel and
:_sweep_cost_kernel (mode='corr'). Features are channels-last ([H, W, C]),
depths per pixel ([K, H, W]), rel the [4, 4] (or [3, 4]) src_P @ inv(ref_P).
The kernel source, with its design and bound, is csrc/sweep.cu.

A wrapper launches the kernel for CUDA tensors and raises if the launch
fails; it takes the plain version only for CPU tensors. Each wrapper counts
its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from .warp import bilinear_sample, sweep_coordinates


def sweep_corr_plain(ref: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
                     depths: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: [K, H, W] pair correlation."""
    H, W, _ = ref.shape
    x, y, _ = sweep_coordinates(rel, depths, (H, W))
    return (bilinear_sample(src, x, y) * ref[None]).mean(-1)


def sweep_cost_plain(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
                     depths: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: [K, C, H, W] confidence-weighted correlation."""
    H, W, _ = ref.shape
    acc = None
    for v in range(srcs.shape[0]):
        x, y, _ = sweep_coordinates(rels[v], depths, (H, W))
        corr = (bilinear_sample(srcs[v], x, y) * ref[None]) * weights[v, :, :, None]
        acc = corr if acc is None else acc + corr
    cost = acc / (weights.sum(0) + 1e-5)[None, :, :, None]
    return cost.permute(0, 3, 1, 2).contiguous()


def _rel12(rel: torch.Tensor) -> torch.Tensor:
    """Rows 0-2 of the relative projection(s), flattened: [..., 12]."""
    return rel[..., :3, :4].float().reshape(*rel.shape[:-2], 12).contiguous()


def _check_cuda(name: str, **tensors) -> None:
    for k, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"{name}: {k} must be a float32 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")


def sweep_corr(ref: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
               depths: torch.Tensor) -> torch.Tensor:
    """K1: ref/src [H, W, C] (C in 8, 16, 32), rel [4, 4], depths [K, H, W]
    -> [K, H, W]."""
    if not ref.is_cuda:
        return sweep_corr_plain(ref, src, rel, depths)
    from .cuda_build import check, load

    H, W, C = ref.shape
    K = depths.shape[0]
    if src.shape != ref.shape or tuple(depths.shape) != (K, H, W):
        raise ValueError(f"sweep_corr: shapes ref {tuple(ref.shape)}, src "
                         f"{tuple(src.shape)}, depths {tuple(depths.shape)}")
    ref, src, depths = ref.contiguous(), src.contiguous(), depths.contiguous()
    rel = _rel12(rel).to(ref.device)
    _check_cuda("sweep_corr", ref=ref, src=src, depths=depths)
    out = torch.empty((K, H, W), device=ref.device, dtype=torch.float32)
    lib = load("sweep")
    rc = lib.sweep_corr_f32(ref.data_ptr(), src.data_ptr(), rel.data_ptr(),
                            depths.data_ptr(), out.data_ptr(), K, H, W, C,
                            torch.cuda.current_stream(ref.device).cuda_stream)
    check(lib, rc, "sweep_corr")
    sweep_corr.launches += 1
    return out


sweep_corr.launches = 0


def sweep_cost(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
               depths: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K2: ref [H, W, C] (C in 8, 16, 32), srcs [V, H, W, C], rels
    [V, 4, 4], depths [K, H, W], weights [V, H, W] -> [K, C, H, W]."""
    if not ref.is_cuda:
        return sweep_cost_plain(ref, srcs, rels, depths, weights)
    from .cuda_build import check, load

    H, W, C = ref.shape
    V, K = srcs.shape[0], depths.shape[0]
    if (tuple(srcs.shape) != (V, H, W, C) or tuple(depths.shape) != (K, H, W)
            or tuple(weights.shape) != (V, H, W) or rels.shape[0] != V):
        raise ValueError(f"sweep_cost: shapes ref {tuple(ref.shape)}, srcs "
                         f"{tuple(srcs.shape)}, rels {tuple(rels.shape)}, "
                         f"depths {tuple(depths.shape)}, weights "
                         f"{tuple(weights.shape)}")
    ref, srcs = ref.contiguous(), srcs.contiguous()
    depths, weights = depths.contiguous(), weights.contiguous()
    rels = _rel12(rels).to(ref.device)
    _check_cuda("sweep_cost", ref=ref, srcs=srcs, depths=depths,
                weights=weights)
    out = torch.empty((K, C, H, W), device=ref.device, dtype=torch.float32)
    lib = load("sweep")
    rc = lib.sweep_cost_f32(ref.data_ptr(), srcs.data_ptr(), rels.data_ptr(),
                            depths.data_ptr(), weights.data_ptr(),
                            out.data_ptr(), V, K, H, W, C,
                            torch.cuda.current_stream(ref.device).cuda_stream)
    check(lib, rc, "sweep_cost")
    sweep_cost.launches += 1
    return out


sweep_cost.launches = 0
