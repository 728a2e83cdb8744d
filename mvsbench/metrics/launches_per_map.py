"""launches_per_map: device kernel events (copies and fills left out) of
the traced segment per map."""

from mvsbench.metrics._common import trace


def read(rec):
    t = rec.get("trace")
    if not t or rec["loop"] != "infer":
        return None
    return sum(1 for n, _, _ in t["device"] if trace.is_kernel(n)) / rec["traced"]
