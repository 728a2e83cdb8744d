"""mfu_pct.infer: the benchmark's operation count of one map
(work/network.py) x maps completed / (window seconds x the peak: 165
TFLOP/s, 3xTF32, for float32)."""

from mvsbench.metrics._common import mfu_pct, network


def read(rec):
    if rec["loop"] != "infer" or not rec.get("geo"):
        return None
    return mfu_pct(rec, network.forward_flops(rec["geo"]))
