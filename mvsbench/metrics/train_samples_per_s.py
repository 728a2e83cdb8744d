"""train_samples_per_s: samples of the steps completed (logs on the host)
over the window's seconds."""


def read(rec):
    if rec["loop"] != "train":
        return None
    return rec["samples"] / rec["window_s"]
