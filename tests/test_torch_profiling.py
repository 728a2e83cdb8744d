"""utils/profiling.session_events: the events of one device type read from
a profiler session's raw results carry the names and spans that torch's
own parse (`prof.events()`) gives them. Held here on CPU events, exactly
(names equal, spans within 1e-6 us); the card's kernels take the same path
in `device_events`."""

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep3d_aerial_tpu_torch.utils.profiling import session_events


def test_session_events_equal_the_parsed_events():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 48, generator=g)
    w = torch.randn(48, 32, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = torch.relu(x @ w) * 2.0
        y.exp()
    raw = session_events(prof.profiler.kineto_results, DeviceType.CPU)
    parsed = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    assert raw and [e.name for e in raw] == [e.name for e in parsed]
    for a, b in zip(raw, parsed):
        assert abs(a.time_range.start - b.time_range.start) <= 1e-6
        assert abs(a.time_range.end - b.time_range.end) <= 1e-6
        assert abs(a.time_range.elapsed_us() - b.time_range.elapsed_us()) <= 1e-6
