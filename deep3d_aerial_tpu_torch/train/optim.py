"""Optimizers with optax's numerics (counterpart of the JAX package's
parallel/train_step.py `make_optimizer`, which builds optax 0.2.6
transforms).

torch.optim's defaults are other functions, so the updates are written out
here, in optax's float32 steps:

  rmsprop  nu = 0.1 g^2 + 0.9 nu (nu from 0); u = g * rsqrt(nu + 1e-8), eps
           inside the root (torch.optim.RMSprop: alpha 0.99, eps outside)
  adam     mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 + 0.999 nu; bias-corrected by
           1 - b^count after the increment; u = mu^ / (sqrt(nu^) + 1e-8)
  adamw    adam's u + 1e-4 p (optax's weight_decay default; torch's is 1e-2),
           added before the learning rate
  then     p = p + (-lr(count)) * u

The learning rate is optax's `piecewise_constant_schedule` (scaled by gamma
at count >= each milestone, `count` the updates already applied) times, with
`warmup_steps` > 0, `linear_schedule(0, 1, warmup_steps)`: the first update
has lr 0. `clip_norm` > 0 first clips the gradients by their global norm as
`clip_by_global_norm`: unchanged below the norm, else (g / |g|) * clip
(not torch.nn.utils.clip_grad_norm_, which adds 1e-6).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

KINDS = ("rmsprop", "adam", "adamw")
RMS_DECAY, RMS_EPS = 0.9, 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAMW_DECAY = 1e-4


def _f32(x) -> np.float32:
    return np.float32(x)


def schedule(lr: float, boundaries: Dict[int, float],
             warmup_steps: int = 0):
    """count -> the learning rate of the update at `count` (float32), as
    optax's piecewise_constant_schedule(lr, boundaries), times
    linear_schedule(0, 1, warmup_steps) when warmup_steps > 0."""

    def base(count: int) -> np.float32:
        v = _f32(lr)
        for threshold, scale in sorted(boundaries.items()):
            indicator = _f32(max(0.0, np.sign(threshold - count)))
            v = v * indicator + (_f32(1) - indicator) * _f32(scale) * v
        return _f32(v)

    if warmup_steps <= 0:
        return base

    def ramped(count: int) -> np.float32:
        c = min(max(count, 0), warmup_steps)
        frac = _f32(1) - _f32(c) / _f32(warmup_steps)
        return _f32(base(count) * (_f32(-1.0) * frac + _f32(1.0)))
    return ramped


class Optimizer:
    """One optax-style gradient transformation over named parameters,
    updating them in place (each update bumps the parameters' versions, so
    the kernels' packed-weight caches, keyed on them, repack). State: the
    update count and the moments, float32 tensors beside the parameters."""

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]],
                 kind: str = "rmsprop", lr_fn=None, clip_norm: float = 0.0):
        if kind not in KINDS:
            raise ValueError(f"unknown optimizer {kind!r}")
        self.params = dict(params)
        self.kind = kind
        self.lr_fn = lr_fn
        self.clip_norm = float(clip_norm)
        self.count = 0
        self.mu = {}
        self.nu = {}
        self.reset()

    def reset(self) -> None:
        """The state of a fresh transformation (optax `init`)."""
        self.count = 0
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.mu = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                   if self.kind != "rmsprop" else {})

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """Apply one update from `grads` (name -> gradient; a name missing
        or None counts as a zero gradient)."""
        g = {n: (grads.get(n) if grads.get(n) is not None else torch.zeros_like(p))
             for n, p in self.params.items()}
        if self.clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
            if not bool(norm < self.clip_norm):
                g = {n: (t / norm) * self.clip_norm for n, t in g.items()}
        step_size = _f32(-1) * self.lr_fn(self.count)
        self.count += 1
        if self.kind != "rmsprop":
            bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** self.count
            bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** self.count
        for n, p in self.params.items():
            gn = g[n]
            if self.kind == "rmsprop":
                nu = (1 - RMS_DECAY) * (gn ** 2) + RMS_DECAY * self.nu[n]
                u = torch.rsqrt(nu + RMS_EPS) * gn
            else:
                mu = (1 - ADAM_B1) * gn + ADAM_B1 * self.mu[n]
                nu = (1 - ADAM_B2) * (gn ** 2) + ADAM_B2 * self.nu[n]
                u = (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device))
                                               + ADAM_EPS)
                if self.kind == "adamw":
                    u = u + ADAMW_DECAY * p
                self.mu[n] = mu
            self.nu[n] = nu
            p.add_(float(step_size) * u)

    def state_dict(self) -> Dict:
        return {"kind": self.kind, "count": self.count,
                "mu": {n: t.clone() for n, t in self.mu.items()},
                "nu": {n: t.clone() for n, t in self.nu.items()}}

    def load_state_dict(self, state: Dict) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']!r}, not {self.kind!r}")
        for key in ("mu", "nu"):
            if set(state[key]) != set(getattr(self, key)):
                raise ValueError(f"optimizer state {key} does not fit the parameters")
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            setattr(self, key, {n: t.to(self.params[n].device).clone()
                                for n, t in state[key].items()})


def make_optimizer(params: Iterable[Tuple[str, torch.Tensor]],
                   lr: float = 0.001, milestones: Sequence[int] = (),
                   gamma: float = 0.5, kind: str = "rmsprop",
                   clip_norm: float = 0.0, warmup_steps: int = 0) -> Optimizer:
    """RMSprop (or adam, adamw) + multi-step LR decay, the JAX package's
    make_optimizer: `milestones` in updates, `clip_norm` > 0 global-norm
    clipping, `warmup_steps` > 0 a linear ramp from 0."""
    boundaries = {int(m): gamma for m in milestones}
    return Optimizer(params, kind, schedule(lr, boundaries, warmup_steps),
                     clip_norm)
