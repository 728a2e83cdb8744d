"""setup_s: from the harness's first line to the window's start: imports,
the CUDA context, the kernels' load (their build on a checkout's first
run), the survey, the port's samples, the weights and the warm-up."""


def read(rec):
    return rec["setup_s"]
