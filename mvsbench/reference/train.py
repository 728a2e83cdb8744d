"""Plain PyTorch reference of the training step: the reference forward
(nets.py) with autograd, the cascade depth loss (per stage a masked
smooth-L1 against the ground truth, weighted 0.5 / 1.0 / 2.0, plus the
AdaMVS pair depths' mean smooth-L1 at stage 1) and RMSprop as optax
computes it (nu = 0.1 g^2 + 0.9 nu, u = g / sqrt(nu + 1e-8), p -= lr u).
Float32; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import nets

STAGE_WEIGHTS = (0.5, 1.0, 2.0)


def smooth_l1(pred, target):
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def cascade_loss(out: Dict, gt, mask, pair_weight: float,
                 stage_weights: Sequence[float] = STAGE_WEIGHTS):
    """The total loss of one sample (every stage against the full-size
    ground truth, the stage depths upsampled to it)."""
    m = mask > 0.5
    total = 0.0
    for s, w in enumerate(stage_weights):
        stage = out[f"stage{s + 1}"]
        loss = masked_mean(smooth_l1(nets.resize(stage["depth"], gt.shape), gt), m)
        pair = 0.0
        if pair_weight and "pair_results" in stage:
            pairs = nets.resize(stage["pair_results"], gt.shape)
            pair = torch.stack([masked_mean(smooth_l1(q, gt), m) for q in pairs]).mean()
        total = total + w * (loss + pair_weight * pair)
    return total


def rmsprop(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
            nu: Dict[str, torch.Tensor], lr: float) -> None:
    """One RMSprop update in place, as optax's rmsprop(lr, decay 0.9, eps
    1e-8) in float32."""
    step = float(np.float32(-1) * np.float32(lr))
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n]
            nu[n] = (1 - 0.9) * (g ** 2) + 0.9 * nu[n]
            p.add_(step * (torch.rsqrt(nu[n] + 1e-8) * g))


def follow(model_type: str, params: Dict[str, torch.Tensor], samples: List[Dict],
           cfg: Dict, lr: float, pair_weight: float, device) -> Dict:
    """The reference's steps from `params` (not changed), one a sample
    (inputs.train_inputs): {'losses': [...], 'grad1': {leaf: the first step's gradient
    norm}, 'change': {leaf: the norm of the parameters' change after the
    steps}}."""
    p = {n: t.detach().clone().to(device).requires_grad_(True) for n, t in params.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grad1 = [], None
    for b in samples:
        for t in p.values():
            t.grad = None
        imgs = torch.as_tensor(b["imgs"], device=device)
        rel = torch.as_tensor(b["rel_projs"], device=device)
        out = nets.forward(model_type, p, imgs, rel, float(np.float32(b["depth_min"])),
                           float(np.float32(b["depth_max"])), cfg)
        gt = torch.as_tensor(b["depth_gt"], device=device)
        mask = torch.as_tensor(b["mask"], device=device)
        loss = cascade_loss(out, gt, mask, pair_weight)
        loss.backward()
        value = float(loss.detach())
        grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for n, t in p.items()}
        if not np.isfinite(value):
            grads = {n: torch.zeros_like(g) for n, g in grads.items()}
        if grad1 is None:
            grad1 = {n: float(g.norm()) for n, g in grads.items()}
        rmsprop(p, grads, nu, lr)
        losses.append(value)
        del out, loss, grads
    change = {n: float((t.detach() - params[n].to(device)).norm()) for n, t in p.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
