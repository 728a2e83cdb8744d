"""red_step4_roofline: the least time of a map's K4 steps with their K5
convolutions (work/red_step4.py, operations at 3xTF32's 165 TFLOP/s or
bytes at 3.35 TB/s) x the maps traced over the device time of the gru_*
and conv_mma kernels."""

from mvsbench.metrics._common import network, peaks, roofline_pct


def read(rec):
    geo = rec.get("geo")
    if not rec.get("trace") or geo["model"] != "msrednet" or geo.get("train"):
        return None
    return roofline_pct(rec, network.reg_steps(geo), peaks.TF32X3,
                        r"\b(gru_(reset|update)_kernel|conv_mma_kernel)\b")
