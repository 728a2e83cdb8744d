"""Depth & normal evaluation metrics (counterpart of the JAX package's
train/metrics.py), with the reference's definitions (its mvs_cas/utils.py):

  * Thres_metrics (:301): fraction of masked pixels with |err| > thres
    (reported as the complementary accuracy, fraction WITHIN)
  * Inter_metrics (:311): fraction within k * depth_interval
  * AbsDepthError_metrics (:323): mean |err| over masked pixels with
    |err| < 100 * interval (outlier-capped) -- the number encoded in the
    checkpoint names
  * Normal_angles (:331): mean angular error in degrees.
"""

from __future__ import annotations

import torch


def _masked(x, mask):
    m = mask.to(x.dtype)
    return x * m, torch.clamp_min(m.sum(), 1.0)


def abs_depth_error(est: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    interval: float = 0.1,
                    outlier_cap: float = 100.0) -> torch.Tensor:
    err = torch.abs(est - gt)
    keep = mask & (err < outlier_cap * interval)
    v, n = _masked(err, keep)
    return v.sum() / n


def threshold_accuracy(est, gt, mask, thres: float) -> torch.Tensor:
    err = torch.abs(est - gt)
    v, n = _masked((err < thres).to(torch.float32), mask)
    return v.sum() / n


def interval_accuracy(est, gt, mask, k: float, interval: float = 0.1):
    """Fraction of masked pixels with |err| < k * interval (the <1/<3/<6
    interval metrics of the reference's train_whu.py:343-345)."""
    return threshold_accuracy(est, gt, mask, k * interval)


def normal_angle_error(n_est, n_gt, mask) -> torch.Tensor:
    """Mean angle (degrees) between unit normal maps [H, W, 3]."""
    cos = torch.clamp(torch.sum(n_est * n_gt, -1), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cos))
    v, n = _masked(ang, mask)
    return v.sum() / n
