"""mfu_pct.train: 3 x the forward's operation count (work/network.py) x
samples completed / (window seconds x the peak: 165 TFLOP/s, 3xTF32, for
float32)."""

from mvsbench.metrics._common import mfu_pct, network


def read(rec):
    if rec["loop"] != "train" or not rec.get("geo"):
        return None
    return mfu_pct(rec, 3 * network.forward_flops(rec["geo"]))
