"""features_ms.infer: CUDA-event ms from a map's start to the 'features'
mark (AdaMVS: to 'pair', the pair branch with it), averaged over the
window's maps."""

from mvsbench.metrics._common import span_mean


def read(rec):
    if rec["loop"] != "infer" or not rec.get("spans"):
        return None
    end = "pair" if "pair" in rec["spans"][0] else "features"
    return span_mean(rec, None, end)
