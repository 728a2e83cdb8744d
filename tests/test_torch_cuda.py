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

from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2
from deep3d_aerial_tpu_torch.ops import red_step2 as rs
from deep3d_aerial_tpu_torch.ops import sweep as sw
from deep3d_aerial_tpu_torch.weights import init_random_weights

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rels(rng, V):
    rel = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    rel[:, :3, :3] += rng.normal(scale=0.01, size=(V, 3, 3)).astype(np.float32)
    rel[:, :2, 3] = rng.normal(scale=400.0, size=(V, 2)).astype(np.float32)
    # one view sees part of the planes from behind (z <= 1e-6)
    rel[-1, 2, :3] = [0.002, 0.0, -1.0]
    rel[-1, 2, 3] = 100.0
    return rel


@pytest.mark.parametrize("C,H,W", [(8, 13, 21), (16, 40, 33), (32, 96, 128)])
def test_sweep_kernels_match_plain(dev, C, H, W):
    rng = np.random.default_rng(C + H)
    V, K = 4, 8

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ref, srcs = t(rng.normal(size=(H, W, C))), t(rng.normal(size=(V, H, W, C)))
    rels = t(_rels(rng, V))
    depths = t(rng.uniform(90, 110, size=(K, H, W)))
    wts = t(rng.uniform(0.1, 1.0, size=(V, H, W)))
    n1, n2 = sw.sweep_corr.launches, sw.sweep_cost.launches
    for v in range(V):
        k = sw.sweep_corr(ref, srcs[v], rels[v], depths)
        p = sw.sweep_corr_plain(ref, srcs[v], rels[v], depths)
        torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    k = sw.sweep_cost(ref, srcs, rels, depths, wts)
    p = sw.sweep_cost_plain(ref, srcs, rels, depths, wts)
    torch.testing.assert_close(k, p, rtol=0, atol=TOL)
    assert sw.sweep_corr.launches == n1 + V and sw.sweep_cost.launches == n2 + 1


@pytest.mark.parametrize("cin,H,W,up", [(8, 11, 15, True), (16, 24, 40, False),
                                        (32, 17, 64, True)])
def test_red_step2_kernel_matches_plain(dev, cin, H, W, up):
    g = torch.Generator(device=dev).manual_seed(cin)
    mod = init_random_weights(RedStep2(cin, up=up), seed=cin).to(dev)
    params = dict(mod.named_parameters())
    cost = torch.randn((cin, H, W), generator=g, device=dev)
    s1 = torch.randn((8, H, W), generator=g, device=dev) * 0.5
    s2 = torch.randn((16, (H + 1) // 2, (W + 1) // 2), generator=g, device=dev) * 0.5
    n = rs.red_step2.launches
    with torch.no_grad():
        for _ in range(3):  # chained: states carried across planes
            k = rs.red_step2(params, cost, s1, s2, up=up)
            p = rs.red_step2_plain(params, cost, s1, s2, up=up)
            for a, b in zip(k, p):
                torch.testing.assert_close(a, b, rtol=0, atol=TOL)
            _, s1, s2 = p
    assert rs.red_step2.launches == n + 3


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 4, 12), device=dev)  # 12 channels: no instance
    d = torch.full((2, 4, 4), 100.0, device=dev)
    with pytest.raises(RuntimeError, match="channel"):
        sw.sweep_corr(x, x, torch.eye(4, device=dev), d)
    with pytest.raises(ValueError):
        sw.sweep_corr(x.double(), x.double(), torch.eye(4, device=dev), d)
