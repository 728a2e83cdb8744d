"""Plain versions of kernels K5 (channel-first 3x3 conv) and K4 (one
RedStep4 step), and the NormGRUCell they regularize with, against the JAX
package on the CPU, with the same random flax parameters mapped through the
port's weight bridge.

Oracles: the JAX `nn.Conv` / `nn.ConvTranspose` 'SAME' semantics that
tests/test_pallas_cf_conv.py checks (lax.conv_general_dilated /
lax.conv_transpose on HWIO kernels), the flax NormGRUCell, and
`pallas_red4.red_step4_reference` (the flax RedStep4 body on the kernel's
channel-first calling convention). Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from deep3d_aerial_tpu.models.cost_reg import NormGRUCell as JNormGRUCell
from deep3d_aerial_tpu.models.cost_reg import RedStep4 as JRedStep4
from deep3d_aerial_tpu.ops.pallas_red4 import red_step4_reference
from deep3d_aerial_tpu_torch.models.cost_reg import NormGRUCell, RedStep4
from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3, cf_conv3x3_plain
from deep3d_aerial_tpu_torch.ops.red_step4 import (
    pack_params,
    red_step4,
    red_step4_plain,
)
from deep3d_aerial_tpu_torch.weights import load_jax_weights

torch.set_num_threads(1)


def flat_tree(params, rng, scale=0.1):
    """keystr-flat flax tree with every leaf perturbed (non-zero biases,
    norm scales away from 1)."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(leaf, np.float32)
        flat[jax.tree_util.keystr(path)] = (
            a + rng.normal(scale=scale, size=a.shape).astype(np.float32))
    return flat


def unflatten(params, flat):
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                        list(flat.values()))


def cf(a):
    """[H, W, C] numpy -> [C, H, W] torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


# ---------------------------------------------------------------------------
# K5: cf_conv3x3_plain
# ---------------------------------------------------------------------------


def _lax_conv(x_hwc, K, b, mode):
    dn = ("NHWC", "HWIO", "NHWC")
    xh = jnp.asarray(x_hwc)[None]
    if mode == "up":
        o = jax.lax.conv_transpose(xh, K, (2, 2), "SAME", dimension_numbers=dn)
    else:
        s = 1 if mode == "same" else 2
        o = jax.lax.conv_general_dilated(xh, K, (s, s), "SAME",
                                         dimension_numbers=dn)
    return np.asarray(o[0] + b)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", ["same", "down", "up"])
@pytest.mark.parametrize("ci,co,H,W", [(8, 16, 13, 20), (16, 1, 12, 9),
                                       (128, 128, 6, 8)])
def test_cf_conv3x3_plain_matches_jax(mode, relu, ci, co, H, W):
    """1e-5 absolute: the same fp32 3x3 convolution on unit-scale inputs,
    summed in another order. Odd sizes exercise the stride-2 'SAME' low-side
    padding; the transposed kernel goes through the bridge's flip."""
    rng = np.random.default_rng(ci + co + H)
    x = rng.normal(size=(H, W, ci)).astype(np.float32)
    K = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    b = rng.normal(scale=0.1, size=co).astype(np.float32)
    want = _lax_conv(x, K, b, mode)
    if relu:
        want = np.maximum(want, 0.0)
    if mode == "up":   # HWIO -> [in, out, 3, 3], flipped (weights.py)
        w = K.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    else:              # HWIO -> OIHW
        w = K.transpose(3, 2, 0, 1)
    w = torch.from_numpy(np.ascontiguousarray(w))
    got = cf_conv3x3_plain(cf(x), w, torch.from_numpy(b), mode=mode, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 0),
                               rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        cf_conv3x3(cf(x), w, torch.from_numpy(b), mode=mode, relu=relu).numpy(),
        got.numpy())


# ---------------------------------------------------------------------------
# NormGRUCell
# ---------------------------------------------------------------------------


def test_norm_gru_cell_global_statistics():
    """1e-4 absolute on unit-scale states. The input's rows have different
    means, so a GroupNorm with per-row statistics (the feature net's
    blocks.GroupNorm) would miss by far more than that."""
    rng = np.random.default_rng(51)
    H, W, cin, hid = 12, 16, 16, 8
    rows = np.linspace(-2.0, 3.0, H)[:, None, None]
    x = (rng.normal(size=(H, W, cin)) + rows).astype(np.float32)
    h = (0.5 * rng.normal(size=(H, W, hid)) + 0.3 * rows).astype(np.float32)
    jmod = JNormGRUCell(hidden=hid)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(h))
    flat = flat_tree(params, rng)
    want = np.asarray(jmod.apply(unflatten(params, flat), jnp.asarray(x),
                                 jnp.asarray(h)))
    holder = tnn.Module()
    holder.cell = NormGRUCell(cin, hid)
    load_jax_weights(holder, {k.replace("['params']", "['params']['cell']", 1): v
                              for k, v in flat.items()})
    with torch.no_grad():
        got = holder.cell(cf(x), cf(h))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 0),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# K4: red_step4_plain
# ---------------------------------------------------------------------------


def _red4_setup(rng, cin, H, W):
    cost = rng.normal(size=(H, W, cin)).astype(np.float32)
    jmod = JRedStep4()
    params = jmod.init(jax.random.PRNGKey(cin), jnp.asarray(cost),
                       *jmod.init_states(H, W))
    flat = flat_tree(params, rng)
    tmod = load_jax_weights(RedStep4(cin), flat)
    states = [(0.5 * rng.normal(size=(c, H >> l, W >> l))).astype(np.float32)
              for l, c in enumerate((8, 16, 32, 64))]
    return unflatten(params, flat)["params"], tmod, states


@pytest.mark.parametrize("cin,H,W", [(8, 16, 24), (16, 24, 16), (32, 16, 32)])
def test_red_step4_plain_chained_matches_reference(cin, H, W):
    """Three planes with the states carried across them, as the streaming
    sweep does; 1e-4 absolute on unit-scale scores and states (fp32
    convolutions and one-group GroupNorm sums in another order, compounded
    over the planes)."""
    rng = np.random.default_rng(60 + cin)
    jparams, tmod, states = _red4_setup(rng, cin, H, W)
    costs = rng.normal(size=(3, H, W, cin)).astype(np.float32)
    js = [jnp.asarray(s) for s in states]
    ts = [torch.from_numpy(s) for s in states]
    params = dict(tmod.named_parameters())
    with torch.no_grad():
        for k in range(3):
            jout = red_step4_reference(jparams, jnp.asarray(costs[k]), *js,
                                       dtype=jnp.float32)
            tout = red_step4_plain(params, cf(costs[k]), *ts)
            assert tout[0].shape == (H, W)
            for name, t, j in zip(("score", "s1", "s2", "s3", "s4"), tout, jout):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                           atol=1e-4, err_msg=f"plane {k} {name}")
            # the wrapper and the module take the plain version for CPU tensors
            for a, b in zip(red_step4(params, cf(costs[k]), *ts), tout):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            for a, b in zip(tmod(cf(costs[k]), *ts), tout):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            js, ts = list(jout[1:]), list(tout[1:])


def test_pack_params_layout_and_negation():
    """K4's packed buffer: 15 layers [ci][ky][kx][co] + bias in the C
    entry's order, the cost's input channels of conv1 and gru1 negated,
    then the GroupNorm vectors; the states and shapes it refuses."""
    rng = np.random.default_rng(70)
    cin = 16
    _, tmod, _ = _red4_setup(rng, cin, 16, 16)
    p = dict(tmod.named_parameters())
    packed = pack_params(p, cin)
    shapes = [(cin, 16), (16, 32), (32, 64), (cin + 8, 16), (cin + 8, 8),
              (32, 32), (32, 16), (64, 64), (64, 32), (128, 128), (128, 64),
              (64, 32), (32, 16), (16, 8), (8, 1)]
    n = sum(ci * 9 * co + co for ci, co in shapes) + 6 * (8 + 16 + 32 + 64)
    assert packed.numel() == n
    w1 = p["conv1.conv.weight"]                       # OIHW [16, cin, 3, 3]
    np.testing.assert_array_equal(
        packed[:cin * 9 * 16].reshape(cin, 3, 3, 16).numpy(),
        -w1.permute(1, 2, 3, 0).detach().numpy())
    off = sum(ci * 9 * co + co for ci, co in shapes[:3])
    g1 = packed[off:off + (cin + 8) * 9 * 16].reshape(cin + 8, 3, 3, 16)
    wg = p["gru1.gates.weight"].permute(1, 2, 3, 0).detach()
    np.testing.assert_array_equal(g1[:cin].numpy(), -wg[:cin].numpy())
    np.testing.assert_array_equal(g1[cin:].numpy(), wg[cin:].numpy())
    np.testing.assert_array_equal(packed[-64:].numpy(),
                                  p["gru4.on.bias"].detach().numpy())
    with pytest.raises(ValueError, match="multiples of 8"):
        tmod.init_states(12, 16)
