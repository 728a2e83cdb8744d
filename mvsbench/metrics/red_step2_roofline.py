"""red_step2_roofline: the least time of a map's K3 steps (operations
at 3xTF32's 165 TFLOP/s or bytes at 3.35 TB/s, work/red_step2.py, the
softmax folded) x the maps traced over the device time of the
red2_level* kernels."""

from mvsbench.metrics._common import network, peaks, roofline_pct


def read(rec):
    geo = rec.get("geo")
    if not rec.get("trace") or geo["model"] != "adamvs" or geo.get("train"):
        return None
    return roofline_pct(rec, network.reg_steps(geo, fold=True), peaks.TF32X3,
                        r"\bred2_level\d_kernel")
