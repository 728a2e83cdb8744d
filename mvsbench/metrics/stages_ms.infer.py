"""stages_ms.infer: CUDA-event ms from the last mark before the cascade
stages ('pair' for AdaMVS, 'features' for MSREDNet) to 'stage3' (sweeps,
regularisers, soft-argmax), averaged over the window's maps."""

from mvsbench.metrics._common import span_mean


def read(rec):
    if rec["loop"] != "infer" or not rec.get("spans"):
        return None
    start = "pair" if "pair" in rec["spans"][0] else "features"
    return span_mean(rec, start, "stage3")
