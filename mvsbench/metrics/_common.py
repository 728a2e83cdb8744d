"""Shared arithmetic of the metric readers (not a metric: no entry of
BENCHMARK.json names it)."""

from __future__ import annotations

import re
import statistics
from typing import Dict, List, Optional

from mvsbench import trace
from mvsbench.work import network, peaks


def span_mean(rec: Dict, a: Optional[str], b: str) -> Optional[float]:
    """Mean ms from mark a ('start' when None) to mark b over the window's
    maps or steps, from their CUDA events; None when untraced or absent."""
    spans = rec.get("spans")
    if not spans or any(b not in s or (a and a not in s) for s in spans):
        return None
    return statistics.fmean(s[b] - (s[a] if a else 0.0) for s in spans)


def kernel_ms(rec: Dict, pattern: str) -> Optional[float]:
    """Device ms of the traced segment's kernels whose names match."""
    t = rec.get("trace")
    if not t:
        return None
    rx = re.compile(pattern)
    return sum(e - s for n, s, e in t["device"] if rx.search(n)) / 1e3


def roofline_pct(rec: Dict, launches: List, peak: float, pattern: str) -> Optional[float]:
    """100 x the least time of a map's launches x the maps traced over the
    matching kernels' device time; None where no such kernel ran."""
    ms = kernel_ms(rec, pattern)
    if not ms:
        return None
    return 100.0 * network.least_ms(launches, peak) * rec["traced"] / ms


def idle_pct(rec: Dict) -> Optional[float]:
    t = rec.get("trace")
    if not t:
        return None
    return 100.0 * (1.0 - trace.busy_us(t["device"], t["window"])
                    / (t["window"][1] - t["window"][0]))


def mfu_pct(rec: Dict, flops_per_sample: float) -> Optional[float]:
    if not rec.get("window_s"):
        return None
    return 100.0 * flops_per_sample * rec["samples"] / (rec["window_s"] * rec["peak_flops"])
