"""idle_pct.infer: 100 x (1 - the union of the device events' intervals
over the traced segment's wall), maps."""

from mvsbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec["loop"] == "infer" else None
