"""map_p90_s: the 90th percentile of the host seconds from _infer_batch's
call to its return, over every map of the window (statistics.quantiles,
inclusive)."""

import statistics


def read(rec):
    if rec["loop"] != "infer" or len(rec["latencies"]) < 2:
        return None
    return statistics.quantiles(rec["latencies"], n=10, method="inclusive")[8]
