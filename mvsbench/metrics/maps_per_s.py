"""maps_per_s: maps completed (depth and confidence on the host) over the
window's seconds."""


def read(rec):
    if rec["loop"] != "infer":
        return None
    return rec["samples"] / rec["window_s"]
