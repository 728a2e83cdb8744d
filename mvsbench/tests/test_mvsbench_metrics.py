"""Each metric reader on a hand-made record."""

import statistics

import pytest

from mvsbench import core, trace
from mvsbench.work import network, peaks

GEO = dict(model="adamvs", base=8, views=3, H=64, W=96, ndepths=[8, 8, 4], chunk=8,
           reg_weights=[10, 10, 10])


def rec(**kw):
    r = {"loop": "infer", "samples": 10, "count": 10, "window_s": 4.0,
         "latencies": [0.1 * (i + 1) for i in range(10)], "setup_s": 12.5,
         "peak_bytes": 3 * 2 ** 30, "spans": None, "trace": None, "traced": 2,
         "geo": dict(GEO), "peak_flops": peaks.TF32X3, "attempted": 10, "failed": 0}
    r.update(kw)
    return r


def read(name, r):
    return core.reader(name)(r)


def test_end_to_end_readers():
    r = rec()
    assert read("maps_per_s", r) == 2.5
    assert read("peak_mem_gib", r) == 3.0
    assert read("setup_s", r) == 12.5
    assert read("train_samples_per_s", r) is None
    t = rec(loop="train", samples=6)
    assert read("train_samples_per_s", t) == 1.5 and read("maps_per_s", t) is None


def test_map_p90_on_a_known_list():
    r = rec(latencies=[float(i) for i in range(1, 12)])  # 1..11
    assert read("map_p90_s", r) == pytest.approx(10.0)
    assert read("map_p90_s", r) == statistics.quantiles(r["latencies"], n=10,
                                                       method="inclusive")[8]


def test_span_readers():
    spans = [{"features": 10.0, "pair": 14.0, "stage1": 20.0, "stage2": 30.0, "stage3": 34.0},
             {"features": 12.0, "pair": 16.0, "stage1": 22.0, "stage2": 30.0, "stage3": 38.0}]
    r = rec(spans=spans)
    assert read("features_ms.infer", r) == 15.0          # start -> pair
    assert read("stages_ms.infer", r) == 21.0            # pair -> stage3
    assert read("features_ms.infer", rec()) is None      # untraced
    t = rec(loop="train", spans=[{"forward": 5.0, "backward": 45.0, "optimizer": 46.0}])
    assert read("forward_ms.train", t) == 5.0 and read("backward_ms.train", t) == 40.0
    m = rec(spans=[{"features": 7.0, "stage1": 9.0, "stage2": 11.0, "stage3": 19.0}])
    assert read("features_ms.infer", m) == 7.0 and read("stages_ms.infer", m) == 12.0


def test_idle_on_overlapping_intervals():
    # busy [10, 30] u [20, 40] u [60, 70] = 40 us of a 100 us window
    evs = [("a", 10.0, 30.0), ("b", 20.0, 40.0), ("c", 60.0, 70.0)]
    t = {"device": evs, "host": [("stage1", 0.0, 45.0)], "window": (0.0, 100.0)}
    assert trace.busy_us(evs, t["window"]) == 40.0
    assert read("idle_pct.infer", rec(trace=t)) == pytest.approx(60.0)
    assert read("idle_pct.train", rec(trace=t)) is None
    assert read("idle_pct.train", rec(loop="train", trace=t)) == pytest.approx(60.0)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["a", 20e-6]
    assert dict((n, v) for n, v in b["idle_gaps"]) == pytest.approx(
        {"stage1": 10e-6, "harness": 50e-6})


def test_kernel_readers_find_their_kernels_or_nothing():
    least = network.least_ms(network.reg_steps(GEO, fold=True), peaks.TF32X3)
    # two maps' K3 kernels took 4 x their least time
    us = least * 1e3 * 2 * 4
    evs = [("red2_level1_kernel(float*)", 0.0, us / 2), ("red2_level3_kernel(float*)", us / 2, us),
           ("sweep_cost_kernel<8>(...)", us, us + 10.0), ("Memcpy HtoD", us + 10, us + 20)]
    t = {"device": evs, "host": [], "window": (0.0, us + 30)}
    r = rec(trace=t)
    assert read("red_step2_roofline", r) == pytest.approx(25.0)
    assert read("red_step4_roofline", r) is None       # no K4 here
    assert read("sweep_roofline", r) > 0
    assert read("launches_per_map", r) == 1.5           # 3 kernels, 2 maps
    assert read("red_step2_roofline", rec()) is None


def test_mfu():
    r = rec()
    want = 100 * network.forward_flops(GEO) * 10 / (4.0 * peaks.TF32X3)
    assert read("mfu_pct.infer", r) == pytest.approx(want)
    t = rec(loop="train", samples=2)
    assert read("mfu_pct.train", t) == pytest.approx(
        100 * 3 * network.forward_flops(GEO) * 2 / (4.0 * peaks.TF32X3))
