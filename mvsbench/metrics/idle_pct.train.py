"""idle_pct.train: 100 x (1 - the union of the device events' intervals
over the traced segment's wall), train steps."""

from mvsbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec["loop"] == "train" else None
