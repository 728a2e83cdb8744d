"""The frozen work functions against hand counts at small shapes."""

from mvsbench.work import conv, network, peaks, red_step2, red_step4, sweep


def test_conv_counts():
    assert conv.flops(3, 8, 3, 4, 6) == 2 * 3 * 8 * 9 * 24
    # stride 2 over 5 x 7: 3 x 4 outputs
    assert conv.flops(2, 4, 5, 5, 7, stride=2) == 2 * 2 * 4 * 25 * 12
    # a transposed conv counts its taps per input pixel
    assert conv.flops(4, 2, 3, 3, 3, transposed=True) == 2 * 4 * 2 * 9 * 9
    nbytes, f = conv.conv3x3_work(2, 3, 4, 4, "down")
    assert f == 2 * 2 * 3 * 9 * 4 and nbytes == 4 * (2 * 16 + 3 * 4 + 2 * 9 * 3) + 4 * 3


def test_sweep_counts():
    V, K, H, W, C = 2, 3, 4, 5, 8
    nb, f = sweep.corr(V, K, H, W, C)
    assert f == V * K * H * W * (30 + 10 * C)
    assert nb == 4 * ((V + 1) * H * W * C + V * K * H * W) + 4 * (K * H * W + 12 * V)
    nb, f = sweep.cost(V, K, H, W, C)
    assert f == K * H * W * (V * (30 + 11 * C + 1) + C)
    nb, f = sweep.var(V, K, H, W, C)
    assert f == K * H * W * (V * (30 + 11 * C) + 5 * C)


def test_recurrent_steps():
    # K3 at Cin 8, 4 x 4, no up: level 1 (conv1 8->8, gates 16->16, cand
    # 16->8), level 2 at 2 x 2 (conv2 8->16 there, gates 32->32, cand
    # 32->16, upconv 16->8 per input pixel), the score conv 8->1
    nb, f = red_step2.step(8, 4, 4, False, 100)
    macs = 16 * 9 * (64 + 256 + 128) + 4 * 9 * (128 + 1024 + 512 + 128) + 16 * 9 * 8
    assert f == 2 * macs
    assert nb == 4 * (8 * 16 + 2 * 8 * 16 + 2 * 16 * 4 + 100) + 4 * 16
    _, f4 = red_step4.step(8, 8, 8, 0)
    assert f4 == sum(conv.conv3x3_work(*c[1:])[1] for c in red_step4.convs(8, 8, 8))
    assert len(red_step4.convs(8, 8, 8)) == 15


def test_network_phases_add_up():
    geo = dict(model="adamvs", base=8, views=3, H=64, W=96, ndepths=[8, 8, 4],
               chunk=8, reg_weights=[10, 10, 10])
    ph = network.phase_flops(geo)
    assert set(ph) == {"features", "pair", "stage1", "stage2", "stage3"}
    assert network.forward_flops(geo) == sum(ph.values())
    # stage 1: one cost launch of 8 planes at 16 x 24, 8 steps
    want = sweep.cost(2, 8, 16, 24, 32)[1] + 8 * red_step2.step(32, 16, 24, True, 10, True)[1]
    assert ph["stage1"] == want
    geo["model"] = "msrednet"
    assert "pair" not in network.phase_flops(geo)
    assert [n for n, _ in network.sweep_launches(geo)] == [1, 1, 1]


def test_least_ms_takes_the_slower_bound():
    assert peaks.least_ms(peaks.BYTES, 0) == 1e3
    assert peaks.least_ms(0, peaks.FP32) == 1e3
    assert peaks.least_ms(peaks.BYTES, 2 * peaks.FP32) == 2e3
