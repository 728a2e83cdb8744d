"""The device events of a function's launches, from torch.profiler (CUPTI).

On an H100 with torch 2.11 a profiler session now and then lists no kernel
record for its first launches (1 to 36 of them, after a synchronize and a
0.1 s wait too) or for its last 2. Once a phase of a process shows it,
every session of the phase may. A device sum from such a session reads low
and a launch count reads short. `device_events` runs sentinel kernels
before and after the measured work, so that the records lost are theirs,
and measures again, with more sentinels, while the caller's check of the
events (a launch count it knows) fails.

The events are read from the session's raw results, not from
`prof.events()`, which builds a Python tree of every CPU op and device
event: on an H100 80GB HBM3 at 700 W with torch 2.11 that took 15.4 s
for a session of 32.5k device events (12 calls of the plain K1 sweep at
96x128) and 43.3 s for one MSREDNet train step (94.5k), against 1.2 and
3.6 s for the same events from the raw results
(scripts/profiler_parse_probe.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

# sentinel kernels before the measured work, doubled on each session the
# caller's check refuses
LEADING = 64
# sentinel kernels after it
TRAILING = 4
# host seconds a session waits before the measured work
WARMUP_S = 0.1
# sessions tried before giving up
SESSIONS = 5
_SENTINEL = "spin_kernel"


@dataclass(frozen=True)
class Span:
    """An event's start and end, in microseconds from its session's start."""

    start: float
    end: float

    def elapsed_us(self) -> float:
        return self.end - self.start


@dataclass(frozen=True)
class DeviceEvent:
    """One device event: its demangled name (as `prof.events()` gives it)
    and its span."""

    name: str
    time_range: Span


def session_events(result, device_type):
    """The events of `device_type` in a profiler session's raw results
    (`prof.profiler.kineto_results`), in start order, filtered and named as
    torch's own parse (`torch.autograd.profiler.profile._parse_kineto_results`)
    filters and names them."""
    import torch

    t0 = result.trace_start_ns()
    evs = []
    for e in result.events():
        if e.device_type() != device_type or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        evs.append(DeviceEvent(torch._C._demangle(name) if len(name) > 1 else name,
                               Span((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)))
    evs.sort(key=lambda e: e.time_range.start)
    return evs


def device_events(fn, expect):
    """The device events (kernels, copies, fills) of one call of `fn` and a
    synchronize, in start order. A session runs LEADING sentinel kernels
    (torch.cuda._sleep's spin_kernel), synchronizes and waits WARMUP_S on
    the host, runs `fn`, synchronizes, and runs TRAILING sentinels; the
    sentinels are left out. While `expect(events)` is false the session is
    run again with twice the leading sentinels; raises, with the events
    listed, after SESSIONS of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(LEADING << attempt):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(WARMUP_S)
            fn()
            torch.cuda.synchronize()
            for _ in range(TRAILING):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = [e for e in session_events(prof.profiler.kineto_results, DeviceType.CUDA)
               if _SENTINEL not in e.name]
        if expect(evs):
            return evs
        print(f"[profile] the check refused a session of {len(evs)} device events; "
              "profiling again", flush=True)
    raise AssertionError(f"{SESSIONS} profiler sessions in a row failed the check; the "
                         f"last listed {len(evs)} device events: "
                         + ", ".join(e.name[:40] for e in evs[:60]))
