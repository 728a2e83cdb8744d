"""The CUDA kernels against their plain versions on the card (marker
`cuda`; skipped where torch sees no CUDA device). Run on a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance 1e-4 absolute on unit-scale data, as in chip_smoke.py: the
projection rounds as the plain chain does, the products and sums do not
(FMA contraction, summation order, cuDNN's own order in the plain convs).
"""

import numpy as np
import pytest
import torch

from deep3d_aerial_tpu_torch.models import adamvs
from deep3d_aerial_tpu_torch.models.cascade import OnlineSoftmaxState
from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
from deep3d_aerial_tpu_torch.ops import cf_conv as cc
from deep3d_aerial_tpu_torch.ops import red_step2 as rs
from deep3d_aerial_tpu_torch.ops import red_step4 as rs4
from deep3d_aerial_tpu_torch.ops import sweep as sw
from deep3d_aerial_tpu_torch.weights import init_random_weights

pytestmark = pytest.mark.cuda
TOL = 1e-4
# one K3 step: the full-res GRU level, the half-res GRU level, the decoder
# with the score and the softmax fold
RED2_LAUNCHES_PER_STEP = 3
# one K4 step: conv1-3, gates (grouped), reset, candidates (grouped),
# update, upconv3-1, score; 9 of them the conv template K5
LAUNCHES_PER_STEP = 11
CONV_LAUNCHES_PER_STEP = 9


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_names(run, per_call, calls=3):
    """Names of the kernels that `calls` runs of `run()` launch (memsets
    and copies left out), from a profiler session (`device_events`) that
    lists calls x per_call of them: a session that lists another count (a
    lost event) is measured again, and five in a row fail. Also returns the
    number of sessions made."""
    from deep3d_aerial_tpu_torch.utils.profiling import device_events

    made = [0]

    def runs():
        made[0] += 1
        for _ in range(calls):
            run()

    def kernels(evs):
        return [e.name for e in evs if "Memset" not in e.name and "Memcpy" not in e.name]

    evs = device_events(runs, lambda evs: len(kernels(evs)) == calls * per_call)
    return kernels(evs), made[0]


def _rels(rng, V):
    rel = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    rel[:, :3, :3] += rng.normal(scale=0.01, size=(V, 3, 3)).astype(np.float32)
    rel[:, :2, 3] = rng.normal(scale=400.0, size=(V, 2)).astype(np.float32)
    # one view sees part of the planes from behind (z <= 1e-6)
    rel[-1, 2, :3] = [0.002, 0.0, -1.0]
    rel[-1, 2, 3] = 100.0
    return rel


def _sweep_inputs(dev, rng, C, H, W, V, K):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return (t(rng.normal(size=(H, W, C))), t(rng.normal(size=(V, H, W, C))),
            t(_rels(rng, V)), t(rng.uniform(90, 110, size=(K, H, W))),
            t(rng.uniform(0.1, 1.0, size=(V, H, W))))


@pytest.mark.parametrize("C,H,W", [(8, 13, 21), (16, 40, 33), (32, 96, 128)])
def test_sweep_kernels_match_plain(dev, C, H, W):
    """K1 (every view's volume in one launch) and K2 at odd sizes; the last
    view sees part of the planes from behind."""
    rng = np.random.default_rng(C + H)
    V, K = 4, 8
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, C, H, W, V, K)
    n1, n2 = sw.sweep_corr.launches, sw.sweep_cost.launches
    k = sw.sweep_corr(ref, srcs, rels, depths)
    p = sw.sweep_corr_plain(ref, srcs, rels, depths)
    assert k.shape == (V, K, H, W)
    torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    k = sw.sweep_cost(ref, srcs, rels, depths, wts)
    p = sw.sweep_cost_plain(ref, srcs, rels, depths, wts)
    torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    assert sw.sweep_corr.launches == n1 + 1 and sw.sweep_cost.launches == n2 + 1


# plane counts off the blocks' plane groups: 8 a one-thread-per-pixel block
# at 384x512 C8; 8 a lane-per-quad pair or cost block, 4 a variance block
# (40x33 C16, 24x40 C32)
@pytest.mark.parametrize("C,H,W,K", [(8, 384, 512, 13), (16, 40, 33, 5), (32, 24, 40, 48)])
def test_sweep_kernels_match_plain_odd_plane_counts(dev, C, H, W, K):
    rng = np.random.default_rng(K)
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, C, H, W, 4, K)
    for k, p in ((sw.sweep_corr(ref, srcs, rels, depths),
                  sw.sweep_corr_plain(ref, srcs, rels, depths)),
                 (sw.sweep_cost(ref, srcs, rels, depths, wts),
                  sw.sweep_cost_plain(ref, srcs, rels, depths, wts)),
                 (sw.sweep_var(ref, srcs, rels, depths),
                  sw.sweep_var_plain(ref, srcs, rels, depths))):
        torch.testing.assert_close(k, p, rtol=0, atol=TOL)


@pytest.mark.parametrize("C,H,W", [(8, 1856, 2752), (32, 464, 688), (16, 928, 1376)])
@pytest.mark.parametrize("mode", ["cost", "var"])
def test_sweep_kernels_match_plain_full_res(dev, mode, C, H, W):
    """K2 and K2v at the 1856x2752 production frame's three stage shapes
    (V4, K8): 64-bit offsets, a ragged last tile of each row (2752 = 21.5 x
    128), the lane-per-quad kernels' largest grids."""
    rng = np.random.default_rng(11)
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, C, H, W, 4, 8)
    if mode == "cost":
        kernel, plain, args = sw.sweep_cost, sw.sweep_cost_plain, (ref, srcs, rels, depths, wts)
    else:
        kernel, plain, args = sw.sweep_var, sw.sweep_var_plain, (ref, srcs, rels, depths)
    n = kernel.launches
    torch.testing.assert_close(kernel(*args), plain(*args), rtol=0, atol=TOL)
    assert kernel.launches == n + 1


@pytest.mark.parametrize("C,H,W", [(32, 96, 128), (8, 384, 512)])
def test_sweep_same_bits_every_run(dev, C, H, W):
    """Each mode twice on the same inputs gives identical bits: every sum
    runs in a fixed order, no atomics."""
    rng = np.random.default_rng(3)
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, C, H, W, 4, 8)
    for fn in (lambda: sw.sweep_corr(ref, srcs, rels, depths),
               lambda: sw.sweep_cost(ref, srcs, rels, depths, wts),
               lambda: sw.sweep_var(ref, srcs, rels, depths)):
        first = fn()
        for _ in range(2):
            torch.testing.assert_close(fn(), first, rtol=0, atol=0)


def test_pair_corr_volumes_launch_k1_once(dev):
    """The AdaMVS pair branch builds all four views' 48-plane volumes in one
    K1 launch, equal to the plain path's."""
    rng = np.random.default_rng(5)
    f1 = torch.from_numpy(rng.normal(size=(5, 24, 40, 32)).astype(np.float32)).to(dev)
    rel1 = torch.from_numpy(_rels(rng, 4)).to(dev)
    depths1 = torch.linspace(90.0, 110.0, 48, device=dev)
    n = sw.sweep_corr.launches
    k = adamvs.pair_corr_volumes(f1, rel1, depths1)
    assert sw.sweep_corr.launches == n + 1
    p = adamvs.pair_corr_volumes(f1, rel1, depths1, warp_impl="plain")
    assert sw.sweep_corr.launches == n + 1
    assert k.shape == (4, 48, 24, 40)
    torch.testing.assert_close(k, p, rtol=0, atol=TOL)


def _red2_inputs(dev, cin, H, W, up, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mod = init_random_weights(RedStep2(cin, up=up), seed=seed).to(dev)
    cost = torch.randn((cin, H, W), generator=g, device=dev)
    s1 = torch.randn((8, H, W), generator=g, device=dev) * 0.5
    s2 = torch.randn((16, (H + 1) // 2, (W + 1) // 2), generator=g, device=dev) * 0.5
    return mod, cost, s1, s2


# odd and mixed sizes, then the main path's stage 1 and stage 3 shapes
@pytest.mark.parametrize("cin,H,W,up", [(8, 11, 15, True), (16, 24, 40, False),
                                        (32, 17, 64, True), (32, 96, 128, True),
                                        (8, 384, 512, False)])
def test_red_step2_kernel_matches_plain(dev, cin, H, W, up):
    mod, cost, s1, s2 = _red2_inputs(dev, cin, H, W, up, cin)
    params = dict(mod.named_parameters())
    n = rs.red_step2.launches
    with torch.no_grad():
        for _ in range(3):  # chained: states carried across planes
            k = rs.red_step2(params, cost, s1, s2, up=up)
            p = rs.red_step2_plain(params, cost, s1, s2, up=up)
            for a, b in zip(k, p):
                torch.testing.assert_close(a, b, rtol=0, atol=TOL)
            _, s1, s2 = p
    assert rs.red_step2.launches == n + 3


@pytest.mark.parametrize("cin,H,W,up", [(16, 13, 22, True), (32, 96, 128, True),
                                        (8, 97, 130, False)])
def test_red_step2_folds_the_online_softmax(dev, cin, H, W, up):
    """The step given the sweep's softmax state, over 3 chained planes from
    OnlineSoftmaxState.init (the first plane sees m = -inf), against
    red_step2_plain followed by OnlineSoftmaxState.update. acc sums
    e * depth, so its tolerance is TOL x the depth (~100 m): the score's
    ~1e-6 difference times the depth."""
    mod, _, s1, s2 = _red2_inputs(dev, cin, H, W, up, cin + 1)
    step = mod.plane_step(dev)
    assert step.folds_softmax
    params = dict(mod.named_parameters())
    g = torch.Generator(device=dev).manual_seed(H)
    shape = (2 * H, 2 * W) if up else (H, W)
    osm_k = OnlineSoftmaxState.init(shape, device=dev)
    osm_p = OnlineSoftmaxState.init(shape, device=dev)
    k1, k2, p1, p2 = s1, s2, s1, s2
    with torch.no_grad():
        for d in (95.0, 100.0, 105.0):
            cost = torch.randn((cin, H, W), generator=g, device=dev)
            dv = d + torch.rand(shape, generator=g, device=dev)
            score, k1, k2 = step(cost, k1, k2, osm=osm_k, dv=dv)
            assert score is None
            sp, p1, p2 = rs.red_step2_plain(params, cost, p1, p2, up=up)
            osm_p = OnlineSoftmaxState.update(osm_p, sp, dv)
            for a, b, scale in zip((*osm_k, k1, k2), (*osm_p, p1, p2),
                                   (1, 1, float(dv.max()), 1, 1, 1)):
                torch.testing.assert_close(a, b, rtol=0, atol=TOL * scale)
    depth, conf = OnlineSoftmaxState.finalize(osm_k)
    assert bool(torch.isfinite(depth).all()) and bool(torch.isfinite(conf).all())


@pytest.mark.parametrize("cin,H,W,up", [(32, 96, 128, True), (8, 384, 512, False)])
def test_red_step2_same_bits_every_run(dev, cin, H, W, up):
    """The same step twice gives identical bits, the score-writing entry and
    the softmax fold alike: every sum runs in a fixed order, no atomics."""
    mod, cost, s1, s2 = _red2_inputs(dev, cin, H, W, up, 3)
    step = mod.plane_step(dev)
    shape = (2 * H, 2 * W) if up else (H, W)
    dv = torch.full(shape, 100.0, device=dev)
    with torch.no_grad():
        first = [t.clone() for t in step(cost, s1, s2)]
        osm0 = OnlineSoftmaxState.update(OnlineSoftmaxState.init(shape, device=dev),
                                         first[0] * 0.5, dv)
        osm1 = tuple(t.clone() for t in osm0)
        _, a1, a2 = step(cost, s1, s2, osm=osm0, dv=dv)
        again = step(cost, s1, s2)
        _, b1, b2 = step(cost, s1, s2, osm=osm1, dv=dv)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip((*osm0, a1, a2), (*osm1, b1, b2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_red_step2_launches_per_step(dev):
    """One step is 3 device launches (the three levels), as the profiler
    sees them, with and without the softmax fold; the counter counts
    steps."""
    mod, cost, s1, s2 = _red2_inputs(dev, 32, 96, 128, True, 4)
    step = mod.plane_step(dev)
    osm = OnlineSoftmaxState.init((192, 256), device=dev)
    dv = torch.full((192, 256), 100.0, device=dev)
    n = rs.red_step2.launches

    def run():
        step(cost, s1, s2)
        step(cost, s1, s2, osm=osm, dv=dv)

    with torch.no_grad():
        step(cost, s1, s2, osm=osm, dv=dv)
        torch.cuda.synchronize()
        kernels, sessions = _kernel_names(run, 2 * RED2_LAUNCHES_PER_STEP)
    assert len(kernels) == 3 * 2 * RED2_LAUNCHES_PER_STEP, kernels
    assert all("red2_level" in k for k in kernels), kernels
    assert rs.red_step2.launches == n + 1 + 3 * 2 * sessions


def test_red_step2_wrapper_refuses(dev):
    from deep3d_aerial_tpu_torch.ops.cuda_build import load

    mod, cost, s1, s2 = _red2_inputs(dev, 16, 12, 18, True, 5)
    params = dict(mod.named_parameters())
    osm = OnlineSoftmaxState.init((24, 36), device=dev)
    with pytest.raises(ValueError, match="both"):
        rs.red_step2(params, cost, s1, s2, up=True, osm=osm)
    with pytest.raises(ValueError, match="softmax"):
        rs.red_step2(params, cost, s1, s2, up=True, osm=osm[:3] + (osm[3][:12],),
                     dv=torch.zeros((24, 36), device=dev))
    with pytest.raises(ValueError, match="packed"):
        rs.red_step2(params, cost, s1, s2, up=True,
                     packed=rs.pack_params(params, True)[:-4])
    # any Cin runs; the packed weights must fit it (12 channels pack as 16)
    n12 = load("red_step2").red_step2_param_floats(12, 0)
    assert n12 == load("red_step2").red_step2_param_floats(16, 0)
    with pytest.raises(ValueError, match="packed"):
        rs.red_step2(params, torch.zeros((12, 12, 18), device=dev), s1, s2, up=True,
                     packed=torch.zeros(n12 - 4, device=dev))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 4, 12), device=dev)  # any C runs (12: the runtime-C path)
    d = torch.full((2, 4, 4), 100.0, device=dev)
    rel = torch.eye(4, device=dev)[None]
    with pytest.raises(RuntimeError, match="size"):  # a 1-row image: no 2x2 tap block
        sw.sweep_corr(x[:1], x[None, :1], rel, d[:, :1])
    with pytest.raises(ValueError):
        sw.sweep_corr(x.double(), x[None].double(), rel, d)
    with pytest.raises(ValueError, match="rels"):  # the kernels read [V, 4, 4]
        sw.sweep_corr(x, x[None], rel[:, :3], d)


@pytest.mark.parametrize("C,H,W", [(8, 13, 21), (16, 40, 33), (32, 24, 40)])
def test_sweep_var_kernel_matches_plain(dev, C, H, W):
    """K2v at odd sizes; the last view sees part of the planes from behind."""
    rng = np.random.default_rng(C + W)
    V, K = 4, 8

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ref, srcs = t(rng.normal(size=(H, W, C))), t(rng.normal(size=(V, H, W, C)))
    rels = t(_rels(rng, V))
    depths = t(rng.uniform(90, 110, size=(K, H, W)))
    n = sw.sweep_var.launches
    k = sw.sweep_var(ref, srcs, rels, depths)
    p = sw.sweep_var_plain(ref, srcs, rels, depths)
    torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    assert sw.sweep_var.launches == n + 1


@pytest.mark.parametrize("mode", ["same", "down", "up"])
@pytest.mark.parametrize("ci,co,H,W", [
    (16, 16, 37, 50), (8, 1, 20, 33), (24, 40, 9, 7),
    # the deep levels, where the warps split the input channels
    (128, 128, 12, 16), (128, 64, 12, 16), (128, 128, 6, 8), (128, 64, 6, 8),
    # input channels off the 8-channel stage, odd sizes
    (40, 24, 23, 31), (20, 12, 17, 9), (3, 5, 11, 13),
    # a grid of many blocks (no split)
    (32, 32, 96, 128)])
def test_cf_conv3x3_kernel_matches_plain(dev, mode, ci, co, H, W):
    g = torch.Generator(device=dev).manual_seed(ci + co)
    x = torch.randn((ci, H, W), generator=g, device=dev)
    shape = (ci, co, 3, 3) if mode == "up" else (co, ci, 3, 3)
    w = torch.randn(shape, generator=g, device=dev) / (9 * ci) ** 0.5
    b = torch.randn((co,), generator=g, device=dev) * 0.1
    n = cc.cf_conv3x3.launches
    for relu in (False, True):
        k = cc.cf_conv3x3(x, w, b, mode=mode, relu=relu)
        p = cc.cf_conv3x3_plain(x, w, b, mode=mode, relu=relu)
        torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    assert cc.cf_conv3x3.launches == n + 2


@pytest.mark.parametrize("cin,H,W", [(8, 16, 24), (16, 40, 64), (32, 96, 128),
                                     (16, 192, 256)])
def test_red_step4_kernel_matches_plain(dev, cin, H, W):
    """Three planes chained, states carried across them."""
    g = torch.Generator(device=dev).manual_seed(cin)
    mod = init_random_weights(RedStep4(cin), seed=cin).to(dev)
    params = dict(mod.named_parameters())
    states = [torch.randn((c, H >> l, W >> l), generator=g, device=dev) * 0.5
              for l, c in enumerate(rs4.HIDDEN)]
    n, nc = rs4.red_step4.launches, cc.cf_conv3x3.launches
    with torch.no_grad():
        for _ in range(3):
            cost = torch.randn((cin, H, W), generator=g, device=dev)
            k = rs4.red_step4(params, cost, *states)
            p = rs4.red_step4_plain(params, cost, *states)
            for a, b in zip(k, p):
                torch.testing.assert_close(a, b, rtol=0, atol=TOL)
            states = list(p[1:])
    assert rs4.red_step4.launches == n + 3
    assert cc.cf_conv3x3.launches == nc + 3 * CONV_LAUNCHES_PER_STEP


def _red4_inputs(dev, cin, H, W, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mod = init_random_weights(RedStep4(cin), seed=cin).to(dev)
    cost = torch.randn((cin, H, W), generator=g, device=dev)
    states = [torch.randn((c, H >> l, W >> l), generator=g, device=dev) * 0.5
              for l, c in enumerate(rs4.HIDDEN)]
    return mod, cost, states


@pytest.mark.parametrize("cin,H,W", [(32, 96, 128), (8, 384, 512)])
def test_red_step4_same_bits_every_run(dev, cin, H, W):
    """The same step twice gives identical bits: every sum (the warps'
    split-K partials, the GroupNorm block partials) runs in a fixed order,
    with no atomics."""
    mod, cost, states = _red4_inputs(dev, cin, H, W, 7)
    step = mod.plane_step(dev)
    with torch.no_grad():
        first = [t.clone() for t in step(cost, *states)]
        for _ in range(2):
            again = step(cost, *states)
            for a, b in zip(first, again):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_red_step4_launches_per_step(dev):
    """One step is 11 device launches (9 of them the conv template), as
    the profiler sees them, and the counters agree."""
    mod, cost, states = _red4_inputs(dev, 32, 96, 128, 8)
    step = mod.plane_step(dev)
    n, nc = rs4.red_step4.launches, cc.cf_conv3x3.launches
    with torch.no_grad():
        step(cost, *states)
        torch.cuda.synchronize()
        kernels, sessions = _kernel_names(lambda: step(cost, *states), LAUNCHES_PER_STEP)
    assert rs4.red_step4.launches == n + 1 + 3 * sessions
    assert cc.cf_conv3x3.launches == nc + (1 + 3 * sessions) * CONV_LAUNCHES_PER_STEP
    # three steps: 33 launches, 27 of them the conv template
    assert len(kernels) == 3 * LAUNCHES_PER_STEP, kernels
    assert sum("conv_mma_kernel" in k for k in kernels) == 3 * CONV_LAUNCHES_PER_STEP, kernels


def test_red_step4_plane_step_launches_the_kernel(dev):
    """The step the streaming sweep takes once (packed weights gathered
    once) launches K4 and gives the module's forward bit for bit."""
    g = torch.Generator(device=dev).manual_seed(5)
    mod = init_random_weights(RedStep4(16), seed=16).to(dev)
    cost = torch.randn((16, 24, 32), generator=g, device=dev)
    states = mod.init_states(24, 32, device=dev)
    n = rs4.red_step4.launches
    with torch.no_grad():
        k = mod.plane_step(dev)(cost, *states)
        f = mod(cost, *states)
    for a, b in zip(k, f):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rs4.red_step4.launches == n + 2


def test_red_step4_wrapper_refuses(dev):
    mod = init_random_weights(RedStep4(8), seed=0).to(dev)
    params = dict(mod.named_parameters())
    with pytest.raises(ValueError, match="multiples of 8"):
        rs4.red_step4(params, torch.zeros((8, 12, 16), device=dev),
                      *(torch.zeros((c, 12 >> l, 16 >> l), device=dev)
                        for l, c in enumerate(rs4.HIDDEN)))
    states = mod.init_states(16, 16, device=dev)
    with pytest.raises(ValueError, match="float32"):
        rs4.red_step4(params, torch.zeros((8, 16, 16), device=dev).double(),
                      *states)
    with pytest.raises(ValueError):
        sw.sweep_var(torch.zeros((4, 4, 8), device=dev, dtype=torch.float64),
                     torch.zeros((2, 4, 4, 8), device=dev),
                     torch.eye(4, device=dev).repeat(2, 1, 1),
                     torch.full((2, 4, 4), 100.0, device=dev))
    with pytest.raises(ValueError):
        cc.cf_conv3x3(torch.zeros((8, 4, 4), device=dev).double(),
                      torch.zeros((8, 8, 3, 3), device=dev),
                      torch.zeros(8, device=dev))


def test_variance_cost_volume_from_k2v_chunks(dev):
    """The volume path's whole [1, C, D, H, W] volume, built from one K2v
    launch per chunk of 8 planes (6 for CasMVSNet's stage 1 at 384x512),
    equals its plain build."""
    from deep3d_aerial_tpu_torch.models.cascade import variance_cost_volume

    rng = np.random.default_rng(41)
    ref, srcs, rels, depths, _ = _sweep_inputs(dev, rng, 32, 96, 128, 4, 48)
    feats = torch.cat([ref[None], srcs])
    n = sw.sweep_var.launches
    k = variance_cost_volume(feats, rels, depths)
    assert sw.sweep_var.launches == n + 6
    p = variance_cost_volume(feats, rels, depths, warp_impl="plain")
    assert k.shape == (1, 32, 48, 96, 128)
    torch.testing.assert_close(k, p, rtol=0, atol=TOL)


@pytest.mark.parametrize("name,launches", [("casmvsnet", 6 + 4 + 1), ("ucsnet", 8 + 4 + 1)])
def test_volume_model_forward_kernel_vs_plain(dev, name, launches):
    """One CasMVSNet / UCSNet forward at 128x160 (5 views, default
    ndepths, seeded random weights) with K2v against the same forward with
    its plain version: depth (and UCSNet's sigma) within 1e-3 x the depth
    range, confidence within 1e-4; one K2v launch per chunk."""
    from deep3d_aerial_tpu_torch.models import build_model

    rng = np.random.default_rng(42)
    V, H, W = 5, 128, 160
    imgs = torch.from_numpy(rng.normal(size=(V, H, W, 3)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(np.stack([_rels(rng, V - 1)] * 3)).to(dev)
    mk = init_random_weights(build_model(name), seed=3).to(dev).eval()
    mp = build_model(name, warp_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    n = sw.sweep_var.launches
    with torch.no_grad():
        ok = mk(imgs, rel, 90.0, 110.0)
        assert sw.sweep_var.launches == n + launches
        op = mp(imgs, rel, 90.0, 110.0)
    assert sw.sweep_var.launches == n + launches
    for s in ("stage1", "stage2", "stage3"):
        for key, tol in (("depth", 1e-3 * 20.0), ("photometric_confidence", 1e-4),
                         ("variance", 1e-3 * 20.0)):
            if key in op[s]:
                assert torch.isfinite(ok[s][key]).all()
                torch.testing.assert_close(ok[s][key], op[s][key], rtol=0, atol=tol)


def test_kernels_launch_on_the_tensors_device():
    """Every kernel on tensors of the second card, with the first card
    current: the wrappers make the tensors' device current for the launch
    (the C entries size their grids and shared memory for the current
    device), and the current device is the first again after."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(43)
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, 16, 40, 64, 4, 8)
    pairs = [(sw.sweep_corr(ref, srcs, rels, depths),
              sw.sweep_corr_plain(ref, srcs, rels, depths)),
             (sw.sweep_cost(ref, srcs, rels, depths, wts),
              sw.sweep_cost_plain(ref, srcs, rels, depths, wts)),
             (sw.sweep_var(ref, srcs, rels, depths),
              sw.sweep_var_plain(ref, srcs, rels, depths))]
    mod, cost, s1, s2 = _red2_inputs(dev, 16, 40, 64, True, 5)
    params = dict(mod.named_parameters())
    with torch.no_grad():
        pairs += list(zip(rs.red_step2(params, cost, s1, s2, up=True),
                          rs.red_step2_plain(params, cost, s1, s2, up=True)))
        mod4, cost4, states = _red4_inputs(dev, 16, 40, 64, 6)
        params4 = dict(mod4.named_parameters())
        pairs += list(zip(rs4.red_step4(params4, cost4, *states),
                          rs4.red_step4_plain(params4, cost4, *states)))
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((32, 40, 64), generator=g, device=dev)
    w = torch.randn((16, 32, 3, 3), generator=g, device=dev) / 17.0
    b = torch.randn((16,), generator=g, device=dev) * 0.1
    pairs.append((cc.cf_conv3x3(x, w, b, mode="down"),
                  cc.cf_conv3x3_plain(x, w, b, mode="down")))
    torch.cuda.synchronize(dev)
    for k, p in pairs:
        assert k.device == dev
        torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    assert torch.cuda.current_device() == 0



@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_sharded_infer_and_train_steps_on_the_card(dev, backend, tmp_path, monkeypatch):
    """parallel/ on the card: 2 ranks of a {'dp': 1, 'sp': 2} mesh, NCCL one
    rank a card (needs two cards) or gloo (any card; the ranks share a card
    where there is one), AdaMVS (K1, K2, K3) and CasMVSNet (K2v) at
    depth_shards 2 and 64x96, cuDNN deterministic everywhere (C.11): the
    sharded forwards against the one-process forward on cuda:0 (depth
    within 1e-3 x the depth range, confidence within 1e-4), each rank
    launching K2 and K3 half as often as one process, K1 as often, and K2v
    once a chunk of its own block (want()); then one sharded AdaMVS train
    step through the kernels' autograd Functions against the one-process
    step (loss 1e-4 relative; gradients within chip_smoke.py's
    [train:step] limit: 1e-3 of a leaf's largest entry plus 1e-3 of the
    model's largest, or 3x what one process's gradient moves by on images
    scaled by 1 + 2^-22), every rank ending with the same parameters bit
    for bit."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.models.cascade import VOLUME_CHUNK, largest_divisor
    from deep3d_aerial_tpu_torch.parallel.launch import spawn
    from deep3d_aerial_tpu_torch.parallel.train_step import make_infer_step
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer
    from deep3d_aerial_tpu_torch.train.step import make_train_step
    from deep3d_aerial_tpu_torch.weights import load_jax_weights, state_dict_to_tree
    import torch_parallel_workers as workers

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL takes one rank a card: needs two CUDA devices")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(12)
    B, V, H, W = 2, 3, 64, 96
    batch = {"imgs": rng.normal(size=(B, V, H, W, 3)).astype(np.float32),
             "rel_projs": np.stack([np.stack([_rels(rng, V - 1)] * 3)
                                    for _ in range(B)]).astype(np.float32),
             "depth_min": np.full((B,), 90.0, np.float32),
             "depth_max": np.full((B,), 110.0, np.float32),
             "depth_gt": rng.uniform(92, 108, (B, H, W)).astype(np.float32),
             "mask": np.ones((B, H, W), np.float32)}
    axes = {"dp": 1, "sp": 2}
    models = {"adamvs": dict(ndepths=(16, 8, 8), num_depth=32, plane_chunk=4,
                             depth_shards=2),
              "casmvsnet": dict(ndepths=(16, 8, 8), num_depth=32, depth_shards=2)}

    def want(name, kw, full):
        """A rank's launches: K1 as one process; K2 and K3 half; K2v one
        launch a chunk of its block, the largest divisor of D/2 up to 8
        planes (cascade.VOLUME_CHUNK), for each of the B maps."""
        if name == "adamvs":
            return {k: (n if k == "sweep_corr" else n // 2) for k, n in full.items()}
        chunks = sum(d // 2 // largest_divisor(d // 2, VOLUME_CHUNK) for d in kw["ndepths"])
        return dict(full, sweep_var=B * chunks)

    for name, kw in models.items():
        flat = state_dict_to_tree(init_random_weights(build_model(name, **kw), seed=4))
        path = tmp_path / f"{name}.npz"
        workers.save(path, flat, batch)
        recs = spawn(workers.infer_case, 2, str(path), name, kw, axes,
                     device="cuda", backend=backend)
        model = load_jax_weights(build_model(name, **kw), flat).to(dev).eval()
        before = workers.launches()
        one = make_infer_step(model)(batch["imgs"], batch["rel_projs"],
                                     batch["depth_min"], batch["depth_max"])
        torch.cuda.synchronize()
        full = {k: v - before[k] for k, v in workers.launches().items()}
        for rec in recs:
            for key, tol in (("depth", 1e-3 * 20.0), ("photometric_confidence", 1e-4)):
                got = rec["out"][key]
                assert torch.isfinite(got).all()
                torch.testing.assert_close(got, one[key].cpu(), rtol=0, atol=tol)
            assert rec["launches"] == want(name, kw, full), (name, rec["launches"], full)
        assert sum(full.values()) > 0

    name, kw = "adamvs", models["adamvs"]
    flat = state_dict_to_tree(init_random_weights(build_model(name, **kw), seed=5))
    path = tmp_path / "train.npz"
    workers.save(path, flat, batch)
    recs = spawn(workers.train_case, 2, str(path), name, kw, axes, {"pair_weight": 1.0},
                 device="cuda", backend=backend)

    def one_step(imgs):
        model = load_jax_weights(build_model(name, **kw), flat).to(dev)
        opt = make_optimizer(model.named_parameters(), 1e-3)
        grads = {}
        update = opt.step
        opt.step = lambda g: grads.update({n: t.detach().cpu().clone()
                                           for n, t in g.items()}) or update(g)
        return make_train_step(model, opt, pair_weight=1.0)(dict(batch, imgs=imgs)), grads
    logs, grads = one_step(batch["imgs"])
    _, nudged = one_step(batch["imgs"] * np.float32(1 + 2.0 ** -22))
    scale = max(float(g.abs().max()) for g in grads.values())

    def worst(other):
        return max(float((other[n] - g).abs().max()) / (float(g.abs().max()) + 1e-3 * scale)
                   for n, g in grads.items())
    allowed = max(1e-3, 3.0 * worst(nudged))
    for rec in recs:
        assert abs(rec["logs"]["total"] - logs["total"]) <= 1e-4 * abs(logs["total"])
        assert worst(rec["grads"]) <= allowed, (worst(rec["grads"]), allowed)
        for n, p in recs[0]["params"].items():
            assert torch.equal(rec["params"][n], p), n


def _refine_grid(n, seed):
    """An n x n vertex grid 10 m wide at z = 10 (plus 2 cm of noise), and
    three nadir views of a smooth texture on it that disagree a little."""
    xs, ys = np.meshgrid(np.linspace(-5, 5, n, dtype=np.float32),
                         np.linspace(-5, 5, n, dtype=np.float32))
    z = 10.0 + np.random.default_rng(seed).normal(0, 0.02, n * n)
    verts = np.stack([xs.ravel(), ys.ravel(), z], -1).astype(np.float32)
    i = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None]).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + n], -1),
                            np.stack([i + 1, i + n + 1, i + n], -1)]).astype(np.int32)
    K = np.array([[20.0, 0, 32], [0, 20.0, 24], [0, 0, 1]], np.float32)
    ys, xs = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    views = []
    for k, tx in enumerate((-2.0, 0.0, 2.0)):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = tx
        X = (xs - 32) / 2.0 - tx + 0.3 * k
        Y = (ys - 24) / 2.0
        img = 0.5 + 0.3 * np.sin(1.3 * X) * np.cos(0.9 * Y) + 0.2 * np.sin(0.4 * X + 1.7 * Y)
        views.append((img.astype(np.float32), K, T))
    return verts, faces, views


@pytest.mark.parametrize("energy", ["zncc", "variance"])
@pytest.mark.parametrize("n", [9, 64, 200])
def test_photometric_refine_on_the_card_matches_the_cpu(dev, energy, n):
    """Each step of the refine on the card against the same step on the CPU
    from the same vertices, within 1e-4 x the mesh's mean edge: the
    scatter-adds (index_add, atomic on the card) and the sums reduce in
    another order, a few ulps a step. Whole runs are not compared: the
    refinement is chaotic at float32 resolution (a bilinear tap's gradient
    jumps at pixel borders, and the step is normalised by the largest
    normal gradient), so ulps grow to a fraction of a step within 20 steps
    (chip_smoke.py, TOL_REFINE_EDGE)."""
    from deep3d_aerial_tpu_torch.mesh import refine

    verts, faces, views = _refine_grid(n, seed=n)
    cfg = refine.PhotoRefineConfig(energy=energy, scales=2, iterations=10)
    card, v, mean_edge = refine.refine_setup(verts, faces, views, cfg, dev)
    host, _, _ = refine.refine_setup(verts, faces, views, cfg, "cpu")
    for s in range(cfg.scales):
        for _ in range(cfg.iterations):
            step = cfg.gradient_step * mean_edge * 0.5 ** s
            got = refine.refine_update(card, v, step)
            want = refine.refine_update(host, v.cpu(), step)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * mean_edge)
            v = got
    out = refine.photometric_refine(verts, faces, views, cfg, device=dev)
    assert np.isfinite(out).all() and np.abs(out - verts).max() > 1e-3


def _grad_inputs(dev, rng, kind):
    """(Function call, plain call, tensors that take a gradient) of one
    kernel at a small shape, every input and parameter requiring grad."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)

    C, H, W, V, K = 16, 24, 40, 3, 4
    ref, srcs = t(rng.normal(size=(H, W, C))), t(rng.normal(size=(V, H, W, C)))
    rels = torch.tensor(_rels(rng, V), device=dev)
    depths = t(np.sort(rng.uniform(90, 110, size=(K, H, W)), 0))
    wts = t(rng.uniform(0.1, 1.0, size=(V, H, W)))
    if kind == "sweep_corr":
        return (lambda: sw.sweep_corr(ref, srcs, rels, depths),
                lambda: sw.sweep_corr_plain(ref, srcs, rels, depths), [ref, srcs, depths])
    if kind == "sweep_cost":
        return (lambda: sw.sweep_cost(ref, srcs, rels, depths, wts),
                lambda: sw.sweep_cost_plain(ref, srcs, rels, depths, wts),
                [ref, srcs, depths, wts])
    if kind == "sweep_var":
        return (lambda: sw.sweep_var(ref, srcs, rels, depths),
                lambda: sw.sweep_var_plain(ref, srcs, rels, depths), [ref, srcs, depths])
    cost = t(rng.normal(size=(C, H, W)))
    if kind == "red_step2":
        mod = init_random_weights(RedStep2(C, up=True), seed=4).to(dev)
        p = dict(mod.named_parameters())
        s1, s2 = t(rng.normal(size=(8, H, W))), t(rng.normal(size=(16, H // 2, W // 2)))
        return (lambda: rs.red_step2(p, cost, s1, s2, up=True, packed=mod._packed_params()),
                lambda: rs.red_step2_plain(p, cost, s1, s2, up=True),
                [cost, s1, s2, *p.values()])
    mod = init_random_weights(RedStep4(C), seed=4).to(dev)
    p = dict(mod.named_parameters())
    states = [t(rng.normal(scale=0.5, size=(c, H >> l, W >> l)))
              for l, c in enumerate(rs4.HIDDEN)]
    return (lambda: rs4.red_step4(p, cost, *states),
            lambda: rs4.red_step4_plain(p, cost, *states), [cost, *states, *p.values()])


@pytest.mark.parametrize("kind", ["sweep_corr", "sweep_cost", "sweep_var", "red_step2",
                                  "red_step4"])
def test_kernel_function_gradients_match_plain_autograd(dev, kind):
    """The kernel's autograd Function (kernel forward, plain VJP backward)
    against plain autograd on the card, for every input, depths and
    parameters included: the same plain code differentiates both, so they
    agree to the gathers' atomic summation order (1e-5 of the largest
    entry, as chip_smoke.py's [train:grad])."""
    rng = np.random.default_rng(len(kind))
    fn, plain, leaves = _grad_inputs(dev, rng, kind)
    outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all("KernelFn" in type(o.grad_fn).__name__ for o in outs)
    proj = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, leaves, proj)
    ref = plain()
    want = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,), leaves, proj)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_adamvs_trains_two_steps_on_the_card(dev):
    """Two train steps of AdaMVS through the kernels (K1, K2 and K3 each
    launched a forward's worth a step): finite losses, every parameter
    moved or with a zero gradient, the packed K3 weights repacked after
    each update."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.train.optim import make_optimizer
    from deep3d_aerial_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(2)
    V, H, W = 3, 64, 96
    nd = (8, 8, 4)
    model = init_random_weights(build_model("adamvs", ndepths=nd, num_depth=32,
                                            plane_chunk=4), seed=2).to(dev)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_train_step(model, opt)
    rel = np.stack([_rels(rng, V - 1)] * 3)
    batch = {"imgs": rng.normal(size=(1, V, H, W, 3)).astype(np.float32),
             "rel_projs": rel[None].astype(np.float32),
             "depth_min": np.array([90.0], np.float32),
             "depth_max": np.array([110.0], np.float32),
             "depth_gt": rng.uniform(92, 108, (1, H, W)).astype(np.float32),
             "mask": np.ones((1, H, W), np.float32)}
    counts = (sw.sweep_corr.launches, sw.sweep_cost.launches, rs.red_step2.launches)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    packed = model.red0._packed_params()
    losses = [step(batch)["total"] for _ in range(2)]
    assert all(np.isfinite(losses))
    assert (sw.sweep_corr.launches - counts[0], sw.sweep_cost.launches - counts[1],
            rs.red_step2.launches - counts[2]) == (2, 2 * sum(d // 4 for d in nd), 2 * sum(nd))
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) >= len(before) - 3
    assert not torch.equal(model.red0._packed_params(), packed)


def test_batched_inference_is_bit_equal_through_the_kernels(dev, tmp_path, monkeypatch):
    """dense_match with infer_batch_size 2 against 1 on the card, AdaMVS
    with seeded random weights on chip_smoke.py's survey at 128x192 (six
    maps, three blocks): the same kernels on the same inputs, so the same
    depth, confidence and normal bytes; K1, K2 and K3 launched a map's
    worth per map either way. Under cuDNN's deterministic algorithms: its
    default ones for the transposed convolutions vary from run to run."""
    import shutil

    import chip_smoke as cs
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    cam, poses = cs.survey(192, 128)
    cs.write_workspace(tmp_path / "src", cam, poses, dev, columns=3)
    model, files = None, {}
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for batch in (1, 2):
        ws = tmp_path / f"b{batch}"
        shutil.copytree(tmp_path / "src" / "export", ws / "export")
        pipe = AerialPipeline(str(ws), PipelineConfig(
            image_w=192, image_h=128, image_scale=1.0, view_num=5,
            allow_random_weights=True, run_view_selection=False, save_normals=True,
            infer_batch_size=batch), device=dev)
        model = model or pipe.build_model()
        counts = (sw.sweep_corr.launches, sw.sweep_cost.launches, rs.red_step2.launches)
        pipe.dense_match(model=model)
        nd = model.ndepths
        assert (sw.sweep_corr.launches - counts[0], sw.sweep_cost.launches - counts[1],
                rs.red_step2.launches - counts[2]) == (6, 6 * sum(d // 8 for d in nd),
                                                       6 * sum(nd))
        assert [len(b) for b in pipe.map_batches] == [batch] * (6 // batch)
        files[batch] = {p.name: p.read_bytes()
                        for p in (ws / "dense" / "MVS").glob("*.pfm")}
    assert len(files[1]) == 18 and files[1] == files[2]


# ---------------------------------------------------------------------------
# the bfloat16 modes (chip_smoke.py's TOL_BF16_ULPS_*: in bfloat16 ulps of
# each output's largest magnitude; a value near a rounding boundary can
# round the other way after sums in another order)
# ---------------------------------------------------------------------------

BF = torch.bfloat16
# the 384x512 point's stages: (channels, H, W)
BF16_STAGES = [(32, 96, 128), (16, 192, 256), (8, 384, 512)]


def _ulps(got, want):
    """Largest |got - want| over each output, in bfloat16 ulps of that
    output's largest magnitude."""
    worst = 0.0
    for g, w in zip(got, want):
        top = float(w.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 2.0 ** -133
        worst = max(worst, float((g.float() - w.float()).abs().max()) / ulp)
    return worst


@pytest.mark.parametrize("C,H,W", BF16_STAGES)
def test_sweep_kernels_bf16_match_plain(dev, C, H, W):
    rng = np.random.default_rng(900 + C)
    ref, srcs, rel, d, wts = _sweep_inputs(dev, rng, C, H, W, 4, 8)
    ref, srcs = ref.to(BF), srcs.to(BF)
    for kern, plain, args in ((sw.sweep_cost, sw.sweep_cost_plain, (d, wts)),
                              (sw.sweep_var, sw.sweep_var_plain, (d,)),
                              (sw.sweep_corr, sw.sweep_corr_plain, (d,))):
        n = kern.launches_bf16
        got, want = kern(ref, srcs, rel, *args), plain(ref, srcs, rel, *args)
        assert kern.launches_bf16 == n + 1, kern.__name__  # the bfloat16 entry ran
        assert got.dtype == want.dtype == BF
        assert _ulps((got,), (want,)) <= 2, kern.__name__


@pytest.mark.parametrize("C,H,W", BF16_STAGES)
def test_red_step2_kernel_bf16_matches_plain(dev, C, H, W):
    """One step by the score entry, then three planes folded into the
    online softmax, against the plain bfloat16 version and the float32
    update on its rounded score."""
    up = C != 8
    mod = init_random_weights(RedStep2(C, up=up), seed=C).to(dev)
    params, packed = dict(mod.named_parameters()), mod._packed_params(BF)
    g = torch.Generator(device=dev).manual_seed(C)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(BF)  # noqa: E731
    cost, s1, s2 = rnd(C, H, W), rnd(8, H, W) * 0.5, rnd(16, H // 2, W // 2) * 0.5
    with torch.no_grad():
        got = rs.red_step2(params, cost, s1, s2, up=up, packed=packed)
        want = rs.red_step2_plain(params, cost, s1, s2, up=up)
        assert all(t.dtype == BF for t in got + want)
        assert _ulps(got, want) <= 8
        shape = (2 * H, 2 * W) if up else (H, W)
        osm_k = OnlineSoftmaxState.init(shape, device=dev)
        osm_p = OnlineSoftmaxState.init(shape, device=dev)
        a, b, pa, pb = s1, s2, s1, s2
        for k in range(3):
            c, dv = rnd(C, H, W), torch.full(shape, 100.0 + k, device=dev)
            _, a, b = rs.red_step2(params, c, a, b, up=up, packed=packed, osm=osm_k, dv=dv)
            sc, pa, pb = rs.red_step2_plain(params, c, pa, pb, up=up)
            osm_p = OnlineSoftmaxState.update(osm_p, sc, dv)
    assert _ulps(tuple(osm_k) + (a, b), tuple(osm_p) + (pa, pb)) <= 8


@pytest.mark.parametrize("C,H,W", BF16_STAGES)
def test_red_step4_kernel_bf16_matches_plain(dev, C, H, W):
    mod = init_random_weights(RedStep4(C), seed=C).to(dev)
    params, packed = dict(mod.named_parameters()), mod._packed.get(mod, BF)
    g = torch.Generator(device=dev).manual_seed(C)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(BF)  # noqa: E731
    sk = sp = [rnd(c, H >> l, W >> l) * 0.5 for l, c in enumerate((8, 16, 32, 64))]
    n, nc = rs4.red_step4.launches_bf16, cc.cf_conv3x3.launches_bf16
    with torch.no_grad():
        for _ in range(3):
            c = rnd(C, H, W)
            got = rs4.red_step4(params, c, *sk, packed=packed)
            want = rs4.red_step4_plain(params, c, *sp)
            sk, sp = list(got[1:]), list(want[1:])
    # the bfloat16 entries ran: K4's, and its conv template's
    assert rs4.red_step4.launches_bf16 == n + 3
    assert cc.cf_conv3x3.launches_bf16 == nc + 3 * CONV_LAUNCHES_PER_STEP
    assert all(t.dtype == BF for t in got + want)
    assert _ulps(got, want) <= 8


@pytest.mark.parametrize("mode,ci,co,H,W", [("same", 16, 16, 384, 512),
                                            ("down", 8, 16, 384, 512),
                                            ("up", 16, 8, 192, 256),
                                            ("same", 128, 128, 48, 64)])
def test_cf_conv3x3_kernel_bf16_matches_plain(dev, mode, ci, co, H, W):
    g = torch.Generator(device=dev).manual_seed(ci + co)
    x = torch.randn((ci, H, W), generator=g, device=dev).to(BF)
    w = torch.randn(((ci, co, 3, 3) if mode == "up" else (co, ci, 3, 3)), generator=g,
                    device=dev) * (9 * ci) ** -0.5
    b = torch.randn((co,), generator=g, device=dev) * 0.1
    for relu in (False, True):
        got = cc.cf_conv3x3(x, w, b, mode=mode, relu=relu)
        want = cc.cf_conv3x3_plain(x, w, b, mode=mode, relu=relu)
        assert got.dtype == want.dtype == BF
        assert _ulps((got,), (want,)) <= 2


@pytest.mark.parametrize("name", ["adamvs", "msrednet", "casmvsnet", "ucsnet"])
def test_bf16_forward_kernel_vs_plain(dev, name):
    """One bfloat16 forward at 128x160 through the kernels and through the
    plain versions (same weights): within 2x the plain bfloat16 vs plain
    float32 distance, or the float32 tolerances where larger
    (chip_smoke.py's [e2e:bf16])."""
    from deep3d_aerial_tpu_torch.models import build_model

    rng = np.random.default_rng(7)
    V, H, W = 3, 128, 160
    imgs = torch.from_numpy(rng.normal(size=(V, H, W, 3)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(np.stack([_rels(rng, V - 1)] * 3)).to(dev)
    plain = {"warp_impl": "plain"}
    if name in ("adamvs", "msrednet"):
        plain["red_impl"] = "plain"
    nd = (16, 8, 8)
    mk = init_random_weights(build_model(name, ndepths=nd, dtype=BF), seed=0).to(dev).eval()
    outs = [mk]
    for dt in (BF, torch.float32):
        m = build_model(name, ndepths=nd, dtype=dt, **plain).to(dev).eval()
        m.load_state_dict(mk.state_dict())
        outs.append(m)
    with torch.no_grad():
        ok, op, o32 = (m(imgs, rel, 90.0, 110.0) for m in outs)
    for s in ("stage1", "stage2", "stage3"):
        for key, floor in (("depth", 2e-2), ("photometric_confidence", TOL)):
            k, p, p32 = ok[s][key], op[s][key], o32[s][key]
            assert k.dtype == torch.float32 and torch.isfinite(k).all()
            gap = float((p - p32).abs().max())
            assert float((k - p).abs().max()) <= max(2 * gap, floor), (s, key)


# ---------------------------------------------------------------------------
# the compensated projection (the *_comp entries) and depth shards
# ---------------------------------------------------------------------------

# the deep scene of tests/test_warp.py (|ray| ~ 4e4, depths ~5e4, a
# translation that cancels ray * d back into the image), for two views
DEEP_REL = np.array([[1.0002, 3e-4, -40000.0, 2.1735e9],
                     [-2.1e-4, 0.9998, -35000.0, 1.9020e9],
                     [1.5e-6, -2.5e-6, 1.0001, 12.5],
                     [0, 0, 0, 1.0]], np.float32)


def _check_compensated(kern, plain, ref, srcs, rel, args, ulps=None):
    n, nc = kern.launches, kern.launches_compensated
    got = kern(ref, srcs, rel, *args, compensated=True)
    want = plain(ref, srcs, rel, *args, compensated=True)
    assert kern.launches == n + 1 and kern.launches_compensated == nc + 1, kern.__name__
    if ulps is None:
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    else:
        assert _ulps((got,), (want,)) <= ulps, kern.__name__
    return got


@pytest.mark.parametrize("C,H,W,K", [(8, 13, 21, 8), (16, 40, 33, 5), (32, 96, 128, 8),
                                     (8, 384, 512, 13), (4, 19, 27, 8), (12, 37, 45, 13),
                                     (64, 48, 64, 8), (3, 13, 21, 5)])
def test_sweep_kernels_compensated_match_plain(dev, C, H, W, K):
    """K1, K2 and K2v in the compensated projection against their plain
    versions in it (float32: 1e-4; the bfloat16 entries: 2 bfloat16 ulps),
    each a compensated launch; the last view sees planes from behind."""
    rng = np.random.default_rng(500 + C + K)
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, C, H, W, 4, K)
    for r, s, ulps in ((ref, srcs, None), (ref.to(BF), srcs.to(BF), 2)):
        for kern, plain, args in ((sw.sweep_corr, sw.sweep_corr_plain, (depths,)),
                                  (sw.sweep_cost, sw.sweep_cost_plain, (depths, wts)),
                                  (sw.sweep_var, sw.sweep_var_plain, (depths,))):
            _check_compensated(kern, plain, r, s, rels, args, ulps)


@pytest.mark.parametrize("C", [8, 32])
def test_sweep_kernels_compensated_at_a_deep_scene(dev, C):
    """At the deep scene the compensated kernels agree with their plain
    versions and sample elsewhere than the float32 projection."""
    rng = np.random.default_rng(C)
    H, W, V = 16, 128, 2
    rel = np.stack([DEEP_REL, DEEP_REL * np.float32(1 + 1e-6)])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    ref, srcs = t(rng.normal(size=(H, W, C))), t(rng.normal(size=(V, H, W, C)))
    depths = t(54321.75 + rng.uniform(-1, 1, size=(8, H, W)))
    wts = t(rng.uniform(0.1, 1.0, size=(V, H, W)))
    for kern, plain, args in ((sw.sweep_corr, sw.sweep_corr_plain, (depths,)),
                              (sw.sweep_cost, sw.sweep_cost_plain, (depths, wts)),
                              (sw.sweep_var, sw.sweep_var_plain, (depths,))):
        got = _check_compensated(kern, plain, ref, srcs, t(rel), args)
        assert float((got - kern(ref, srcs, t(rel), *args)).abs().max()) > 1e-4


def test_compensated_function_gradient_matches_plain_autograd(dev):
    """K2's autograd Function in the compensated projection: its backward
    is the compensated plain version's VJP (1e-5 of the largest entry, as
    the float32 Functions)."""
    rng = np.random.default_rng(77)
    _, _, leaves = _grad_inputs(dev, rng, "sweep_cost")
    ref, srcs, depths, wts = leaves
    rels = torch.tensor(_rels(rng, srcs.shape[0]), device=dev)
    nc = sw.sweep_cost.launches_compensated
    out = sw.sweep_cost(ref, srcs, rels, depths, wts, compensated=True)
    assert "KernelFn" in type(out.grad_fn).__name__
    assert sw.sweep_cost.launches_compensated == nc + 1
    proj = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, proj)
    want = torch.autograd.grad(
        sw.sweep_cost_plain(ref, srcs, rels, depths, wts, compensated=True), leaves, proj)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("name", ["adamvs", "msrednet"])
def test_depth_shards_forward_kernel_vs_plain(dev, name):
    """A forward at depth_shards = 2 (128x160, 3 views, ndepths 16/8/8)
    through the kernels against the plain versions (the float32 forward
    tolerances), with the kernels launched as often as at depth_shards = 1."""
    from deep3d_aerial_tpu_torch.models import build_model

    rng = np.random.default_rng(8)
    V, H, W = 3, 128, 160
    imgs = torch.from_numpy(rng.normal(size=(V, H, W, 3)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(np.stack([_rels(rng, V - 1)] * 3)).to(dev)
    nd = (16, 8, 8)
    counters = ((sw.sweep_corr, sw.sweep_cost, rs.red_step2) if name == "adamvs"
                else (sw.sweep_var, rs4.red_step4, cc.cf_conv3x3))
    launches = {}
    outs = {}
    for shards in (1, 2):
        mk = init_random_weights(build_model(name, ndepths=nd, depth_shards=shards),
                                 seed=0).to(dev).eval()
        before = [c.launches for c in counters]
        with torch.no_grad():
            outs[shards] = mk(imgs, rel, 90.0, 110.0)
        launches[shards] = [c.launches - b for c, b in zip(counters, before)]
    assert launches[2] == launches[1] and all(launches[2])
    mp = build_model(name, ndepths=nd, depth_shards=2, warp_impl="plain",
                     red_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    with torch.no_grad():
        op = mp(imgs, rel, 90.0, 110.0)
    for s in ("stage1", "stage2", "stage3"):
        for key, tol in (("depth", 1e-3 * 20.0), ("photometric_confidence", TOL)):
            assert torch.isfinite(outs[2][s][key]).all()
            torch.testing.assert_close(outs[2][s][key], op[s][key], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# every channel count: the sweeps at C = 4 and 64 (instances) and at any
# other C (the runtime-C kernels), K3 at any Cin, K4 at MSREDNet's base-16
# cost widths, the models at base width 16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [4, 12, 64, 3, 20])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_sweep_kernels_at_every_width(dev, C, dtype):
    """K1, K2 and K2v at the new widths and odd ones, odd sizes and plane
    counts; float32 within TOL, bfloat16 within 2 ulps."""
    rng = np.random.default_rng(1300 + C)
    ref, srcs, rels, depths, wts = _sweep_inputs(dev, rng, C, 37, 45, 4, 13)
    ref, srcs = ref.to(dtype), srcs.to(dtype)
    for kern, plain, args in ((sw.sweep_corr, sw.sweep_corr_plain, (depths,)),
                              (sw.sweep_cost, sw.sweep_cost_plain, (depths, wts)),
                              (sw.sweep_var, sw.sweep_var_plain, (depths,))):
        n = kern.launches
        got, want = kern(ref, srcs, rels, *args), plain(ref, srcs, rels, *args)
        assert kern.launches == n + 1 and got.dtype == dtype
        if dtype == BF:
            assert _ulps((got,), (want,)) <= 2, kern.__name__
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("cin,H,W,up", [(4, 24, 40, True), (12, 17, 30, False),
                                        (64, 96, 128, True), (40, 33, 20, False),
                                        (64, 192, 256, False)])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_red_step2_kernel_at_every_width(dev, cin, H, W, up, dtype):
    """K3 at cost widths other than 8, 16 and 32 (zero planes past a Cin
    that is not a multiple of 8; conv1 in chunks of 32 channels above 32):
    the score entry, then three planes folded into the online softmax."""
    mod, cost, s1, s2 = _red2_inputs(dev, cin, H, W, up, cin + H)
    params, packed = dict(mod.named_parameters()), mod._packed_params(dtype)
    g = torch.Generator(device=dev).manual_seed(cin)
    shape = (2 * H, 2 * W) if up else (H, W)
    cost, s1, s2 = cost.to(dtype), s1.to(dtype), s2.to(dtype)

    def close(got, want, scales=(1,) * 3):
        """bfloat16: 8 ulps; float32: TOL x scale (the softmax's acc sums
        e * depth: TOL x the depth, as test_red_step2_folds_the_online_softmax)."""
        if dtype == BF:
            assert _ulps(got, want) <= 8
        else:
            for a, b, scale in zip(got, want, scales):
                torch.testing.assert_close(a, b, rtol=0, atol=TOL * scale)

    with torch.no_grad():
        close(rs.red_step2(params, cost, s1, s2, up=up, packed=packed),
              rs.red_step2_plain(params, cost, s1, s2, up=up))
        osm_k = OnlineSoftmaxState.init(shape, device=dev)
        osm_p = OnlineSoftmaxState.init(shape, device=dev)
        a, b, pa, pb = s1, s2, s1, s2
        for k in range(3):
            c = torch.randn((cin, H, W), generator=g, device=dev).to(dtype)
            dv = torch.full(shape, 100.0 + k, device=dev)
            _, a, b = rs.red_step2(params, c, a, b, up=up, packed=packed, osm=osm_k, dv=dv)
            sc, pa, pb = rs.red_step2_plain(params, c, pa, pb, up=up)
            osm_p = OnlineSoftmaxState.update(osm_p, sc, dv)
    close(tuple(osm_k) + (a, b), tuple(osm_p) + (pa, pb), (1, 1, 102.0, 1, 1, 1))


@pytest.mark.parametrize("cin,H,W", [(64, 96, 128), (32, 192, 256), (16, 384, 512),
                                     (12, 96, 128), (3, 384, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_red_step4_kernel_at_every_width(dev, cin, H, W, dtype):
    """K4 (and the conv template K5 inside it, at ci = Cin + 8 for gru1)
    at cost widths other than 8, 16 and 32 (MSREDNet at base 16, 64/32/16,
    and at base 3, 12/6/3), three planes."""
    mod = init_random_weights(RedStep4(cin), seed=cin).to(dev)
    params, packed = dict(mod.named_parameters()), mod._packed.get(mod, dtype)
    g = torch.Generator(device=dev).manual_seed(cin)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    sk = sp = [rnd(c, H >> l, W >> l) * 0.5 for l, c in enumerate(rs4.HIDDEN)]
    n, nc = rs4.red_step4.launches, cc.cf_conv3x3.launches
    with torch.no_grad():
        for _ in range(3):
            c = rnd(cin, H, W)
            got = rs4.red_step4(params, c, *sk, packed=packed)
            want = rs4.red_step4_plain(params, c, *sp)
            sk, sp = list(got[1:]), list(want[1:])
    assert rs4.red_step4.launches == n + 3
    assert cc.cf_conv3x3.launches == nc + 3 * CONV_LAUNCHES_PER_STEP
    if dtype == BF:
        assert _ulps(got, want) <= 8
    else:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["adamvs", "msrednet"])
def test_base_16_forward_kernel_vs_plain(dev, name):
    """A base-16 forward (128x160, 3 views, ndepths 16/8/8) through the
    kernels against the plain versions: depth within 1e-3 x the depth
    range, confidence within 1e-4; every kernel of the path launched (K1
    at C 64, K2 and K3 at 64/32/16; K2v and K4 with K5 at 64/32/16)."""
    from deep3d_aerial_tpu_torch.models import build_model

    rng = np.random.default_rng(16)
    V, H, W = 3, 128, 160
    imgs = torch.from_numpy(rng.normal(size=(V, H, W, 3)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(np.stack([_rels(rng, V - 1)] * 3)).to(dev)
    nd = (16, 8, 8)
    counters = ((sw.sweep_corr, sw.sweep_cost, rs.red_step2) if name == "adamvs"
                else (sw.sweep_var, rs4.red_step4, cc.cf_conv3x3))
    mk = init_random_weights(build_model(name, ndepths=nd, base_channels=16),
                             seed=0).to(dev).eval()
    before = [c.launches for c in counters]
    with torch.no_grad():
        ok = mk(imgs, rel, 90.0, 110.0)
    assert all(c.launches > b for c, b in zip(counters, before))
    mp = build_model(name, ndepths=nd, base_channels=16, warp_impl="plain",
                     red_impl="plain").to(dev).eval()
    mp.load_state_dict(mk.state_dict())
    with torch.no_grad():
        op = mp(imgs, rel, 90.0, 110.0)
    for s in ("stage1", "stage2", "stage3"):
        for key, tol in (("depth", 1e-3 * 20.0), ("photometric_confidence", TOL)):
            assert torch.isfinite(ok[s][key]).all()
            torch.testing.assert_close(ok[s][key], op[s][key], rtol=0, atol=tol)
