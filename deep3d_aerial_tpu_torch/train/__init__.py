"""Training (counterpart of the JAX package's train/): losses, metrics,
the WHU-OMVS / BlendedMVS datasets, the event writer, optimizers with
optax's numerics, the single-device train step, checkpoints, the Trainer
and the `python -m deep3d_aerial_tpu_torch.train` CLI."""

from .losses import cascade_depth_loss, smooth_l1
from .metrics import (
    abs_depth_error,
    interval_accuracy,
    normal_angle_error,
    threshold_accuracy,
)

__all__ = [
    "cascade_depth_loss",
    "smooth_l1",
    "abs_depth_error",
    "interval_accuracy",
    "normal_angle_error",
    "threshold_accuracy",
]
