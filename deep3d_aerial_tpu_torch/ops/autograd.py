"""Kernel forward, plain-VJP backward: the gradient contract of every
kernel of the port.

Each kernel entry of the JAX package is a `jax.custom_vjp` whose forward
runs the Pallas kernel and whose backward is `jax.vjp` of the plain
reference (its `_fwd` saves the inputs, its `_bwd` recomputes the reference
and pulls the cotangents back through it). The JAX package has no backward
kernel. `KernelFn` is the same contract for the port's CUDA kernels, which
are ctypes launches that autograd cannot see into:

  forward   `launch(inputs, params)` under no_grad, the inputs and
            parameters saved
  backward  `plain(inputs, params)` recomputed on detached copies under
            enable_grad, then torch.autograd.grad of its outputs with
            respect to every tensor whose gradient is needed

Training has no compute dtype in the JAX package (its train/ has no dtype
knob), so bfloat16 is inference only: a KernelFn given a bfloat16 tensor
raises NotImplementedError, on no JAX entry point (ROADMAP.md). Without
grad the wrappers launch their bfloat16 kernel as it is.

`launch` and `plain` are plain callables of (input tensors, parameter
tensors); non-tensor arguments (`up`, packed weights, shapes, the sweeps'
`compensated` projection) reach them through closures, never through
`apply`: a compensated launch's backward is the compensated plain
version's VJP. `through_kernel` is what the
wrappers call: the launch as it is when autograd needs nothing, the
Function otherwise.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch


class KernelFn(torch.autograd.Function):
    """KernelFn.apply(launch, plain, n_params, *tensors): `tensors` are the
    inputs followed by the `n_params` parameter tensors."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, n_params: int,
                *tensors: torch.Tensor):
        if any(t.dtype == torch.bfloat16 for t in tensors):
            raise NotImplementedError(
                "a kernel's gradient in bfloat16: the JAX package trains in "
                "float32 only (no compute dtype in its train/), so the port "
                "runs bfloat16 for inference, under no_grad (ROADMAP A.7)")
        ctx.plain = plain
        ctx.n_inputs = len(tensors) - n_params
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        k = ctx.n_inputs
        with torch.no_grad():
            return launch(tensors[:k], tensors[k:])

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        k = ctx.n_inputs
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
            outs = ctx.plain(tuple(xs[:k]), tuple(xs[k:]))
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, need) if n]
        result = [None] * len(xs)
        if pairs and wrt:
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True))
            result = [next(got) if n else None for n in need]
        return (None, None, None, *result)


def through_kernel(launch: Callable, plain: Callable,
                   inputs: Sequence[torch.Tensor],
                   params: Optional[Mapping[str, torch.Tensor]] = None):
    """Run `launch` on `inputs` (after the parameter dict, when the kernel
    has one: launch(params, *inputs)), through KernelFn with `plain` (the
    same signature) as its backward whenever autograd needs a gradient of
    any input or parameter. The parameters travel as tensors in the dict's
    order and are rebuilt into a dict of the same names for each call."""
    names = list(params) if params is not None else []
    ps = [params[n] for n in names]
    if not needs_grad(*inputs, *ps):
        return launch(*inputs) if params is None else launch(params, *inputs)

    def bind(fn):
        if params is None:
            return lambda xs, _: fn(*xs)
        return lambda xs, qs: fn(dict(zip(names, qs)), *xs)
    return KernelFn.apply(bind(launch), bind(plain), len(ps), *inputs, *ps)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on `tensors` now."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
