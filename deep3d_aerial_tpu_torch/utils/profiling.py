"""The device events of a function's launches, from torch.profiler (CUPTI).

On an H100 with torch 2.11 a profiler session now and then lists no kernel
record for its first launches (1 to 36 of them, after a synchronize and a
0.1 s wait too) or for its last 2. Once a phase of a process shows it,
every session of the phase may. A device sum from such a session reads low
and a launch count reads short. `device_events` runs sentinel kernels
before and after the measured work, so that the records lost are theirs,
and measures again, with more sentinels, while the caller's check of the
events (a launch count it knows) fails.
"""

from __future__ import annotations

import time

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
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and _SENTINEL not in e.name), key=lambda e: e.time_range.start)
        if expect(evs):
            return evs
        print(f"[profile] the check refused a session of {len(evs)} device events; "
              "profiling again", flush=True)
    raise AssertionError(f"{SESSIONS} profiler sessions in a row failed the check; the "
                         f"last listed {len(evs)} device events: "
                         + ", ".join(e.name[:40] for e in evs[:60]))
