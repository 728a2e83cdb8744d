"""Logging + timing utilities (reference tools/log.py + per-stage timers;
copy of deep3d_aerial_tpu/utils/logging.py)."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from datetime import datetime


class _Tee:
    def __init__(self, stream, fh):
        self.stream = stream
        self.fh = fh

    def write(self, data):
        self.stream.write(data)
        self.fh.write(data)

    def flush(self):
        self.stream.flush()
        self.fh.flush()


def tee_logs(log_dir: str) -> str:
    """Mirror stdout+stderr into logs/log-<timestamp>.log
    (reference tools/log.py:25-32)."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    path = os.path.join(log_dir, f"log-{stamp}.log")
    fh = open(path, "a")
    sys.stdout = _Tee(sys.__stdout__, fh)
    sys.stderr = _Tee(sys.__stderr__, fh)
    return path


class StageTimer:
    """Accumulates named wall-clock spans; prints a summary table."""

    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        lines = [f"{name:30s} {sec:10.2f}s" for name, sec in self.spans.items()]
        return "\n".join(lines)
