"""sweep_roofline: the least time of a map's sweep launches (K1, K2 or
K2v; work/sweep.py, operations at the 67 TFLOP/s of float32 CUDA cores or
bytes at 3.35 TB/s) x the maps traced over the device time of the sweep_*
kernels, whichever kernel does the work."""

from mvsbench.metrics._common import network, peaks, roofline_pct


def read(rec):
    geo = rec.get("geo")
    if not rec.get("trace") or geo.get("train"):
        return None
    return roofline_pct(rec, network.sweep_launches(geo), peaks.FP32,
                        r"\bsweep_\w+_kernel\b")
