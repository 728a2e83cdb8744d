"""Spans and the device trace of a run.

* `Marks`: CUDA events at the program's own `mark(label)` points (the
  models' phases, the train step's), per map or step, and, inside a
  profiled segment, host ranges (`record_function`) named after the phase
  the host is issuing, so that an idle gap on the device can be named by
  what the host was doing.
* `profiled(fn)`: one torch.profiler session (CUPTI) around fn, with
  sentinel kernels before and after it. The profiler on an H100 now and
  then drops the records of a session's first launches and of its last
  two, so the session is accepted only when a leading and a trailing
  sentinel both show, and measured again (with twice the leading
  sentinels) otherwise. Events are read from the session's raw results
  (a frozen copy of deep3d_aerial_tpu_torch/utils/profiling.py's
  session_events, which is ~10x faster than prof.events()).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

LEADING = 64
TRAILING = 4
SESSIONS = 4
SENTINEL = "spin_kernel"
PREFIX = "mvsbench:"

Event = Tuple[str, float, float]  # name, start us, end us (session clock)


class Marks:
    """mark(label) as the program calls it. `begin()` opens a map or step
    (its 'start' event); with `ranges` each phase is also a host range
    named by the phase being issued (the labels come from the first
    map or step)."""

    def __init__(self, events: bool = True):
        self.events = events
        self.ranges = False
        self.labels: List[str] = []
        self.per: List[List[Tuple[str, torch.cuda.Event]]] = []
        self._range = None
        self._i = 0

    def _record(self, label: str) -> None:
        if self.events:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.per[-1].append((label, e))

    def _open(self, name: str) -> None:
        self.close()
        if self.ranges:
            self._range = torch.profiler.record_function(PREFIX + name)
            self._range.__enter__()

    def close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def begin(self) -> None:
        self.per.append([])
        self._i = 0
        self._record("start")
        self._open(self.labels[0] if self.labels else "forward")

    def __call__(self, label: str) -> None:
        self._record(label)
        if self._i == len(self.labels):  # the first map or step names them
            self.labels.append(label)
        self._i += 1
        nxt = self.labels[self._i] if self._i < len(self.labels) else "after"
        self._open(nxt)

    def ms(self) -> List[Dict[str, float]]:
        """Per map or step: ms from 'start' to each label (synchronises)."""
        torch.cuda.synchronize()
        return [{label: marks[0][1].elapsed_time(e) for label, e in marks[1:]}
                for marks in self.per]


def _events(result, device_type) -> List[Event]:
    t0 = result.trace_start_ns()
    out = []
    for e in result.events():
        if e.device_type() != device_type or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        out.append((torch._C._demangle(name) if len(name) > 1 else name,
                    (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3))
    out.sort(key=lambda e: e[1])
    return out


def profiled(fn) -> Dict:
    """{'device': device events of fn's work, 'host': the benchmark's host
    ranges, 'window': (start, end) us of the traced window} of one accepted
    session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(LEADING << attempt):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.1)
            with torch.profiler.record_function(PREFIX + "window"):
                fn()
                torch.cuda.synchronize()
            for _ in range(TRAILING):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        res = prof.profiler.kineto_results
        # the device side lists the host ranges too (as GPU annotations):
        # they are no device work
        dev = [e for e in _events(res, DeviceType.CUDA) if not e[0].startswith(PREFIX)]
        host = [e for e in _events(res, DeviceType.CPU) if e[0].startswith(PREFIX)]
        window = next(((s, t) for n, s, t in host if n == PREFIX + "window"), None)
        if window is not None:
            lead = any(SENTINEL in n and t <= window[0] for n, s, t in dev)
            trail = any(SENTINEL in n and s >= window[1] for n, s, t in dev)
            if lead and trail:
                return {"device": [e for e in dev if SENTINEL not in e[0]
                                   and e[1] >= window[0] and e[2] <= window[1]],
                        "host": [(n[len(PREFIX):], s, t) for n, s, t in host
                                 if n != PREFIX + "window"],
                        "window": window}
        print(f"[trace] session {attempt + 1} lost its edge records; profiling again",
              flush=True)
    raise RuntimeError(f"{SESSIONS} profiler sessions in a row lost their edge records")


def busy_us(events: List[Event], window: Tuple[float, float]) -> float:
    """The union of the events' intervals inside the window, in us."""
    busy, cur = 0.0, None
    for s, e in sorted((max(s, window[0]), min(e, window[1])) for _, s, e in events
                       if e > window[0] and s < window[1]):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def gaps(events: List[Event], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the window."""
    out, t = [], window[0]
    for _, s, e in sorted(events, key=lambda e: e[1]):
        if s > t:
            out.append((t, min(s, window[1])))
        t = max(t, e)
    if t < window[1]:
        out.append((t, window[1]))
    return [(a, b) for a, b in out if b > a]


def is_kernel(name: str) -> bool:
    return "Memcpy" not in name and "Memset" not in name


def breakdown(trace: Dict, top: int = 10) -> Dict:
    """The device operations that took most time (seconds summed by name)
    and the idle seconds by what the host was doing then (the benchmark's
    host range around each gap's middle; 'harness' outside them)."""
    by_op: Dict[str, float] = {}
    for n, s, e in trace["device"]:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    idle: Dict[str, float] = {}
    host = sorted(trace["host"], key=lambda h: h[1])
    for a, b in gaps(trace["device"], trace["window"]):
        mid = (a + b) / 2
        name = next((n for n, s, t in host if s <= mid <= t), "harness")
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6

    def ranked(d: Dict[str, float]) -> List[list]:
        return [[n[:160], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}


def window_s(trace: Dict) -> float:
    """The traced window's seconds."""
    return (trace["window"][1] - trace["window"][0]) / 1e6
