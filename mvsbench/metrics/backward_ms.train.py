"""backward_ms.train: CUDA-event ms from a step's 'forward' mark to its
'backward' mark, averaged over the window's steps."""

from mvsbench.metrics._common import span_mean


def read(rec):
    return span_mean(rec, "forward", "backward") if rec["loop"] == "train" else None
