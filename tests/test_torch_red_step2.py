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
