"""Fused plane sweep: CUDA kernels K1 (pair), K2 (cost) and K2v
(variance), with their plain PyTorch versions.

  sweep_corr  (K1)  all V source views, D planes -> [V, D, H, W]
                    mean_c(ref * warp(src_v)), every view's volume in one
                    launch                                   (AdaMVS pair branch)
  sweep_cost  (K2)  all V source views, K planes -> [K, C, H, W]
                    sum_v w_v * ref * warp(src_v) / (sum_v w_v + 1e-5)
                                                             (AdaMVS stages)
  sweep_var   (K2v) all V source views, K planes -> [K, C, H, W]
                    E[f^2] - E[f]^2 over {ref} and the V warps (MSREDNet stages)

They replace deep3d_aerial_tpu/ops/pallas_sweep.py:_sweep_corr_kernel and
:_sweep_cost_kernel (mode='corr' and mode='variance'). Features are
channels-last ([H, W, C]), depths per pixel ([K, H, W]), rels the [V, 4, 4]
src_P @ inv(ref_P) (the plain versions also take [V, 3, 4]; the kernels
read rows 0-2 of the [4, 4] matrices in place). Any channel count C: the
kernels have instances for C = 4, 8, 16, 32 and 64 and a runtime-C path
for every other C (csrc/sweep.cu). The kernel source, with its design and
bound, is csrc/sweep.cu.

Features come in float32 or bfloat16 (ref and srcs alike); the output has
their dtype. In bfloat16 every mode reads the features as they are, 2 bytes
a channel, does its taps, products, weights and variance in float32, and
rounds the output once to bfloat16: what the JAX package's Pallas sweep
computes after prepare_sweep_operands upcasts the features, with its cost
chunk cast to the feature dtype (models/cascade.py, models/adamvs.py).
Projections, depths and weights stay float32.

A wrapper launches the kernel for CUDA tensors, on their device (made the
current one for the launch, since the C entries size their grids for the
current device), and raises if the launch fails; it takes the plain
version only for CPU tensors. Each wrapper counts
its launches in `<wrapper>.launches`, and those of its bfloat16 entry also
in `<wrapper>.launches_bf16`; `<wrapper>.launches_by_width` (a Counter)
counts every launch by its channel count C. Where autograd needs a gradient, the
launch goes through ops/autograd.py's KernelFn: the kernel forward, the
plain version's VJP backward (the JAX package's custom VJPs), with
gradients to ref, srcs, weights and depths (and rels when they need one).

`compensated=True` (DENSEMATCH.warp_precision 'compensated') projects with
the double-single chain of ops/warp.py: the plain versions call
sweep_coordinates(..., compensated=True), the kernels take their
compensated entries (`*_f32_comp`, `*_bf16_comp`: the same kernels with the
chain in their projection, csrc/sweep.cu), in float32 and bfloat16 alike.
Everything after the coordinates is as in the float32 projection. Each
wrapper counts the compensated launches apart in
`<wrapper>.launches_compensated` (and in `.launches`, as every launch).
"""

from __future__ import annotations

import collections
import functools

import torch

from .autograd import through_kernel
from .warp import bilinear_sample, sweep_coordinates

# planes per step of sweep_corr_plain: bounds its [planes, H, W, C] warps
PLAIN_CHUNK = 8


def _f32_math(plain):
    """The plain version for features of any dtype: float32 arithmetic on
    the upcast features, the output rounded once to their dtype."""
    def run(ref, srcs, *rest, **kw):
        if ref.dtype == torch.float32:
            return plain(ref, srcs, *rest, **kw)
        return plain(ref.float(), srcs.float(), *rest, **kw).to(ref.dtype)
    run.__name__, run.__doc__ = plain.__name__, plain.__doc__
    return run


@_f32_math
def sweep_corr_plain(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
                     depths: torch.Tensor, compensated: bool = False) -> torch.Tensor:
    """Plain version of K1: [V, D, H, W] pair correlation of each source
    view (the JAX package's pair_corr_volumes)."""
    H, W, _ = ref.shape
    V, D = srcs.shape[0], depths.shape[0]
    out = ref.new_empty((V, D, H, W))
    for v in range(V):
        for i in range(0, D, PLAIN_CHUNK):
            x, y, _ = sweep_coordinates(rels[v], depths[i:i + PLAIN_CHUNK], (H, W),
                                        compensated)
            out[v, i:i + PLAIN_CHUNK] = (bilinear_sample(srcs[v], x, y)
                                         * ref[None]).mean(-1)
    return out


@_f32_math
def sweep_cost_plain(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
                     depths: torch.Tensor, weights: torch.Tensor,
                     compensated: bool = False) -> torch.Tensor:
    """Plain version of K2: [K, C, H, W] confidence-weighted correlation."""
    H, W, _ = ref.shape
    acc = None
    for v in range(srcs.shape[0]):
        x, y, _ = sweep_coordinates(rels[v], depths, (H, W), compensated)
        corr = (bilinear_sample(srcs[v], x, y) * ref[None]) * weights[v, :, :, None]
        acc = corr if acc is None else acc + corr
    cost = acc / (weights.sum(0) + 1e-5)[None, :, :, None]
    return cost.permute(0, 3, 1, 2).contiguous()


@_f32_math
def sweep_var_plain(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
                    depths: torch.Tensor, compensated: bool = False) -> torch.Tensor:
    """Plain version of K2v: [K, C, H, W] variance over {ref} and the V
    warped source views (the JAX package's variance_cost_plane per plane)."""
    H, W, _ = ref.shape
    s, q = None, None
    for v in range(srcs.shape[0]):
        x, y, _ = sweep_coordinates(rels[v], depths, (H, W), compensated)
        w = bilinear_sample(srcs[v], x, y)
        s = w if s is None else s + w
        q = w * w if q is None else q + w * w
    n = srcs.shape[0] + 1
    mean = (ref[None] + s) / n
    cost = (ref * ref)[None] + q
    return (cost / n - mean * mean).permute(0, 3, 1, 2).contiguous()


_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _entry(mode: str, suffix: str, compensated: bool) -> str:
    """The C entry of a mode (corr, cost, var) for a feature dtype's
    suffix, in the compensated projection or the float32 one."""
    return f"sweep_{mode}_{suffix}" + ("_comp" if compensated else "")


def _check_cuda(name: str, ref: torch.Tensor, srcs: torch.Tensor,
                **tensors) -> str:
    """Raise unless every tensor lies on the card, ref and srcs in float32
    or bfloat16 alike and the rest in float32; the C entry's suffix."""
    if ref.dtype not in _ENTRY or srcs.dtype != ref.dtype:
        raise ValueError(f"{name}: ref and srcs must both be float32 or both "
                         f"bfloat16, got {ref.dtype} and {srcs.dtype}")
    for k, t in {"ref": ref, "srcs": srcs, **tensors}.items():
        if not t.is_cuda or (k not in ("ref", "srcs") and t.dtype != torch.float32):
            raise ValueError(f"{name}: {k} must be a float32 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
    return _ENTRY[ref.dtype]


def _rels(name: str, rels: torch.Tensor, V: int, device) -> torch.Tensor:
    """The [V, 4, 4] projections as the kernels read them: float32,
    contiguous, on the features' device (no copy when they already are)."""
    if tuple(rels.shape) != (V, 4, 4):
        raise ValueError(f"{name}: rels must be [{V}, 4, 4], got {tuple(rels.shape)}")
    rels = rels.to(device=device, dtype=torch.float32).contiguous()
    if rels.data_ptr() % 16:  # the kernels read each row as one float4
        rels = rels.clone()
    return rels


def _mode(fn, compensated: bool):
    """`fn` (a launch or a plain version) in the given projection mode."""
    return functools.partial(fn, compensated=True) if compensated else fn


def _count(wrapper, suffix: str, compensated: bool, C: int) -> None:
    wrapper.launches += 1
    wrapper.launches_by_width[C] += 1
    if suffix == "bf16":
        wrapper.launches_bf16 += 1
    if compensated:
        wrapper.launches_compensated += 1


def sweep_corr(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
               depths: torch.Tensor, compensated: bool = False) -> torch.Tensor:
    """K1: ref [H, W, C] (any C), srcs [V, H, W, C], rels
    [V, 4, 4], depths [D, H, W] -> [V, D, H, W], in one launch."""
    if not ref.is_cuda:
        return sweep_corr_plain(ref, srcs, rels, depths, compensated)
    return through_kernel(_mode(_launch_corr, compensated),
                          _mode(sweep_corr_plain, compensated), (ref, srcs, rels, depths))


def _launch_corr(ref, srcs, rels, depths, compensated=False):
    from .cuda_build import check, load

    H, W, C = ref.shape
    V, D = srcs.shape[0], depths.shape[0]
    if tuple(srcs.shape) != (V, H, W, C) or tuple(depths.shape) != (D, H, W):
        raise ValueError(f"sweep_corr: shapes ref {tuple(ref.shape)}, srcs "
                         f"{tuple(srcs.shape)}, depths {tuple(depths.shape)}")
    ref, srcs, depths = ref.contiguous(), srcs.contiguous(), depths.contiguous()
    rels = _rels("sweep_corr", rels, V, ref.device)
    suffix = _check_cuda("sweep_corr", ref, srcs, rels=rels, depths=depths)
    out = torch.empty((V, D, H, W), device=ref.device, dtype=ref.dtype)
    lib = load("sweep")
    with torch.cuda.device(ref.device):
        rc = getattr(lib, _entry("corr", suffix, compensated))(
            ref.data_ptr(), srcs.data_ptr(), rels.data_ptr(), depths.data_ptr(),
            out.data_ptr(), V, D, H, W, C,
            torch.cuda.current_stream(ref.device).cuda_stream)
    check(lib, rc, "sweep_corr")
    _count(sweep_corr, suffix, compensated, C)
    return out


sweep_corr.launches = 0
sweep_corr.launches_bf16 = 0
sweep_corr.launches_compensated = 0
sweep_corr.launches_by_width = collections.Counter()


def sweep_cost(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
               depths: torch.Tensor, weights: torch.Tensor,
               compensated: bool = False) -> torch.Tensor:
    """K2: ref [H, W, C] (any C), srcs [V, H, W, C], rels
    [V, 4, 4], depths [K, H, W], weights [V, H, W] -> [K, C, H, W]."""
    if not ref.is_cuda:
        return sweep_cost_plain(ref, srcs, rels, depths, weights, compensated)
    return through_kernel(_mode(_launch_cost, compensated),
                          _mode(sweep_cost_plain, compensated),
                          (ref, srcs, rels, depths, weights))


def _launch_cost(ref, srcs, rels, depths, weights, compensated=False):
    from .cuda_build import check, load

    H, W, C = ref.shape
    V, K = srcs.shape[0], depths.shape[0]
    if (tuple(srcs.shape) != (V, H, W, C) or tuple(depths.shape) != (K, H, W)
            or tuple(weights.shape) != (V, H, W)):
        raise ValueError(f"sweep_cost: shapes ref {tuple(ref.shape)}, srcs "
                         f"{tuple(srcs.shape)}, depths {tuple(depths.shape)}, "
                         f"weights {tuple(weights.shape)}")
    ref, srcs = ref.contiguous(), srcs.contiguous()
    depths, weights = depths.contiguous(), weights.contiguous()
    rels = _rels("sweep_cost", rels, V, ref.device)
    suffix = _check_cuda("sweep_cost", ref, srcs, rels=rels, depths=depths, weights=weights)
    out = torch.empty((K, C, H, W), device=ref.device, dtype=ref.dtype)
    lib = load("sweep")
    with torch.cuda.device(ref.device):
        rc = getattr(lib, _entry("cost", suffix, compensated))(
            ref.data_ptr(), srcs.data_ptr(), rels.data_ptr(), depths.data_ptr(),
            weights.data_ptr(), out.data_ptr(), V, K, H, W, C,
            torch.cuda.current_stream(ref.device).cuda_stream)
    check(lib, rc, "sweep_cost")
    _count(sweep_cost, suffix, compensated, C)
    return out


sweep_cost.launches = 0
sweep_cost.launches_bf16 = 0
sweep_cost.launches_compensated = 0
sweep_cost.launches_by_width = collections.Counter()


def sweep_var(ref: torch.Tensor, srcs: torch.Tensor, rels: torch.Tensor,
              depths: torch.Tensor, compensated: bool = False) -> torch.Tensor:
    """K2v: ref [H, W, C] (any C), srcs [V, H, W, C], rels
    [V, 4, 4], depths [K, H, W] -> [K, C, H, W]."""
    if not ref.is_cuda:
        return sweep_var_plain(ref, srcs, rels, depths, compensated)
    return through_kernel(_mode(_launch_var, compensated),
                          _mode(sweep_var_plain, compensated), (ref, srcs, rels, depths))


def _launch_var(ref, srcs, rels, depths, compensated=False):
    from .cuda_build import check, load

    H, W, C = ref.shape
    V, K = srcs.shape[0], depths.shape[0]
    if tuple(srcs.shape) != (V, H, W, C) or tuple(depths.shape) != (K, H, W):
        raise ValueError(f"sweep_var: shapes ref {tuple(ref.shape)}, srcs "
                         f"{tuple(srcs.shape)}, depths {tuple(depths.shape)}")
    ref, srcs, depths = ref.contiguous(), srcs.contiguous(), depths.contiguous()
    rels = _rels("sweep_var", rels, V, ref.device)
    suffix = _check_cuda("sweep_var", ref, srcs, rels=rels, depths=depths)
    out = torch.empty((K, C, H, W), device=ref.device, dtype=ref.dtype)
    lib = load("sweep")
    with torch.cuda.device(ref.device):
        rc = getattr(lib, _entry("var", suffix, compensated))(
            ref.data_ptr(), srcs.data_ptr(), rels.data_ptr(), depths.data_ptr(),
            out.data_ptr(), V, K, H, W, C,
            torch.cuda.current_stream(ref.device).cuda_stream)
    check(lib, rc, "sweep_var")
    _count(sweep_var, suffix, compensated, C)
    return out


sweep_var.launches = 0
sweep_var.launches_bf16 = 0
sweep_var.launches_compensated = 0
sweep_var.launches_by_width = collections.Counter()
