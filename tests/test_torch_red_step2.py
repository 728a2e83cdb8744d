"""Plain version of kernel K3 (one RedStep2 step) against the JAX package's
oracle `pallas_red.red_step2_reference` (the flax RedStep2 body on the
kernel's channel-first calling convention), on the CPU, with the same
random flax parameters mapped through the port's weight bridge.

Tolerance 1e-5 absolute on unit-scale states and scores: the same fp32
convolutions, summed in another order (XLA vs oneDNN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.models.cost_reg import RedStep2 as JRedStep2
from deep3d_aerial_tpu.ops.pallas_red import red_step2_reference
from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2
from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2, red_step2_plain
from deep3d_aerial_tpu_torch.weights import load_jax_weights

torch.set_num_threads(1)


def flat_tree(params, rng):
    """keystr-flat flax tree with every leaf perturbed (non-zero biases)."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(leaf, np.float32)
        flat[jax.tree_util.keystr(path)] = (
            a + rng.normal(scale=0.1, size=a.shape).astype(np.float32))
    return flat


def _setup(rng, cin, H, W, up):
    cost = rng.normal(size=(H, W, cin)).astype(np.float32)
    s1 = rng.normal(scale=0.5, size=(H, W, 8)).astype(np.float32)
    s2 = rng.normal(scale=0.5, size=(-(-H // 2), -(-W // 2), 16)).astype(np.float32)
    jmod = JRedStep2(up=up)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(cost),
                       jnp.asarray(s1), jnp.asarray(s2))
    flat = flat_tree(params, rng)
    tmod = load_jax_weights(RedStep2(cin, up=up), flat)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), list(flat.values()))
    return cost, s1, s2, jmod, jparams, tmod


@pytest.mark.parametrize("up", [True, False])
@pytest.mark.parametrize("cin", [8, 16, 32])
def test_red_step2_plain_matches_reference(cin, up):
    rng = np.random.default_rng(31 + cin)
    H, W = 12, 18
    cost, s1, s2, _, jparams, tmod = _setup(rng, cin, H, W, up)
    js, j1, j2 = red_step2_reference(
        jparams["params"], jnp.asarray(cost),
        jnp.asarray(np.transpose(s1, (2, 0, 1))),
        jnp.asarray(np.transpose(s2, (2, 0, 1))), up=up, dtype=jnp.float32)
    params = dict(tmod.named_parameters())
    args = (torch.from_numpy(np.transpose(cost, (2, 0, 1)).copy()),
            torch.from_numpy(np.transpose(s1, (2, 0, 1)).copy()),
            torch.from_numpy(np.transpose(s2, (2, 0, 1)).copy()))
    with torch.no_grad():
        ts, t1, t2 = red_step2_plain(params, *args, up=up)
        ws = red_step2(params, *args, up=up)
    assert ts.shape == ((2 * H, 2 * W) if up else (H, W))
    for t, j in ((ts, js), (t1, j1), (t2, j2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(ws, (ts, t1, t2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_red_step2_odd_size_matches_flax_body():
    """Odd H and W: the stride-2 'SAME' conv pads (1, 1) and the
    transposed conv's overshoot is cropped, as in flax."""
    rng = np.random.default_rng(38)
    H, W = 11, 15
    cost, s1, s2, jmod, jparams, tmod = _setup(rng, 16, H, W, True)
    js, j1, j2 = jmod.apply(jparams, jnp.asarray(cost), jnp.asarray(s1),
                            jnp.asarray(s2))
    with torch.no_grad():
        ts, t1, t2 = tmod(*(torch.from_numpy(np.transpose(a, (2, 0, 1)).copy())
                            for a in (cost, s1, s2)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t1.numpy(), np.transpose(np.asarray(j1), (2, 0, 1)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.transpose(np.asarray(j2), (2, 0, 1)),
                               rtol=0, atol=1e-5)


def test_red_step2_chained_over_four_planes():
    """States carried across 4 planes, as the streaming sweep does."""
    rng = np.random.default_rng(39)
    H, W, cin = 10, 14, 32
    cost, s1, s2, _, jparams, tmod = _setup(rng, cin, H, W, True)
    costs = rng.normal(size=(4, H, W, cin)).astype(np.float32)
    j1 = jnp.asarray(np.transpose(s1, (2, 0, 1)))
    j2 = jnp.asarray(np.transpose(s2, (2, 0, 1)))
    t1, t2 = torch.from_numpy(np.array(j1)), torch.from_numpy(np.array(j2))
    with torch.no_grad():
        for k in range(4):
            js, j1, j2 = red_step2_reference(jparams["params"],
                                             jnp.asarray(costs[k]), j1, j2,
                                             up=True, dtype=jnp.float32)
            ts, t1, t2 = tmod(torch.from_numpy(
                np.transpose(costs[k], (2, 0, 1)).copy()), t1, t2)
            # 2e-5 by the 4th plane: each step's 1e-5 feeds the next
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                       atol=2e-5)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=0, atol=2e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=0, atol=2e-5)


def test_red_step2_softmax_fold_plain_route_matches_jax():
    """The step with the sweep's online-softmax state (the fold K3 makes on
    the card) takes, on CPU tensors, red_step2_plain and then the update in
    place: held against the JAX package's RedStep2 followed by its
    OnlineSoftmaxState.update over 3 chained planes from init (the first
    plane sees m = -inf), at an odd size. States and unit-scale softmax
    sums within 2e-5 by the third plane (each step's 1e-5 feeds the next);
    acc sums e * depth, so it is held at 2e-5 x the depth."""
    from deep3d_aerial_tpu.models.cascade import OnlineSoftmaxState as JOSM
    from deep3d_aerial_tpu_torch.models.cascade import OnlineSoftmaxState

    rng = np.random.default_rng(40)
    H, W, cin = 11, 15, 16
    cost, s1, s2, jmod, jparams, tmod = _setup(rng, cin, H, W, True)
    costs = rng.normal(size=(3, H, W, cin)).astype(np.float32)
    dvs = rng.uniform(90.0, 110.0, size=(3, 2 * H, 2 * W)).astype(np.float32)

    @jax.jit
    def jstep(c, a, b, osm, dv):
        score, a, b = jmod.apply(jparams, c, a, b)
        return JOSM.update(osm, score, dv), a, b

    josm, ja, jb = JOSM.init((2 * H, 2 * W)), jnp.asarray(s1), jnp.asarray(s2)
    osm = OnlineSoftmaxState.init((2 * H, 2 * W))
    ta, tb = (torch.from_numpy(np.transpose(a, (2, 0, 1)).copy()) for a in (s1, s2))
    step = tmod.plane_step(torch.device("cpu"))
    with torch.no_grad():
        for k in range(3):
            josm, ja, jb = jstep(jnp.asarray(costs[k]), ja, jb, josm, jnp.asarray(dvs[k]))
            score, ta, tb = step(torch.from_numpy(np.transpose(costs[k], (2, 0, 1)).copy()),
                                 ta, tb, osm=osm, dv=torch.from_numpy(dvs[k]))
            assert score is None
    for t, j, scale in zip(osm, josm, (1.0, 1.0, 110.0, 1.0)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(ta.numpy(), np.transpose(np.asarray(ja), (2, 0, 1)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tb.numpy(), np.transpose(np.asarray(jb), (2, 0, 1)),
                               rtol=0, atol=2e-5)
    depth, conf = OnlineSoftmaxState.finalize(osm)
    jdepth, jconf = JOSM.finalize(josm)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=0, atol=1e-3)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0, atol=1e-4)


def _unpack_frags(packed, ci, co):
    """Packed TF32 fragments (ops/cf_conv.py:pack_frags) -> ([ci, 3, 3, co]
    as hi + lo, hi): per (8-channel chunk, tap, n8 fragment) 32 lanes of
    (b0 hi, b1 hi, b0 lo, b1 lo), lane = 4 g + t, b0 the chunk's input
    channel t and b1 t + 4, g the fragment's output channel."""
    t = np.asarray(packed, np.float32).reshape(ci // 8, 9, co // 8, 8, 4, 2, 2)
    out = []
    for x in (t[..., 0, :] + t[..., 1, :], t[..., 0, :]):
        # chunk, tap, nf, g, t, half -> (chunk, half, t), tap, (nf, g)
        out.append(x.transpose(0, 5, 4, 1, 2, 3).reshape(ci, 3, 3, co))
    return out


@pytest.mark.parametrize("cin,up", [(8, False), (32, True)])
def test_pack_params_layout(cin, up):
    """K3's packed buffer (the C entry's layout): the seven tensor-core
    layers in order, each as TF32 hi/lo fragments (hi with TF32's 10
    mantissa bits, hi + lo the weight exactly) then its bias; convs OIHW
    as [I, 3, 3, O], upconv1 [in, out, 3, 3] as [in, 3, 3, out]; then the
    score conv as [8][3][3] and its bias padded to 8. Every section starts
    16-byte aligned."""
    from deep3d_aerial_tpu_torch.ops.red_step2 import pack_params
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    mod = init_random_weights(RedStep2(cin, up=up), seed=cin)
    p = {k: v.detach() for k, v in mod.named_parameters()}
    packed = pack_params(p, up).numpy()
    layers = [("conv1.conv", cin, 8), ("gru1.gates", 16, 16), ("gru1.cand", 16, 8),
              ("conv2.conv", 8, 16), ("gru2.gates", 32, 32), ("gru2.cand", 32, 16),
              ("upconv1", 16, 8)]
    off = 0
    for name, ci, co in layers:
        assert off % 4 == 0
        n = ci * co * 18
        whole, hi = _unpack_frags(packed[off:off + n], ci, co)
        w = p[f"{name}.weight"]
        want = w.permute(0, 2, 3, 1) if name == "upconv1" else w.permute(1, 2, 3, 0)
        np.testing.assert_array_equal(whole, want.numpy())
        assert not (hi.view(np.int32) & 0x1FFF).any()
        assert np.abs(whole - hi).max() <= np.abs(whole).max() * 2.0 ** -11
        np.testing.assert_array_equal(packed[off + n:off + n + co],
                                      p[f"{name}.bias"].numpy())
        off += n + co
    assert packed.size - off == 80  # the score section
    score = "upconv2d" if up else "out2d"
    ws = p[f"{score}.weight"]
    np.testing.assert_array_equal(packed[off:off + 72],
                                  (ws[:, 0] if up else ws[0]).reshape(-1).numpy())
    np.testing.assert_array_equal(packed[off + 72:],
                                  np.r_[p[f"{score}.bias"].numpy(), np.zeros(7, np.float32)])
