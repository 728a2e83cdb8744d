"""forward_ms.train: CUDA-event ms from a step's start to its 'forward'
mark (forward and loss), averaged over the window's steps."""

from mvsbench.metrics._common import span_mean


def read(rec):
    return span_mean(rec, None, "forward") if rec["loop"] == "train" else None
