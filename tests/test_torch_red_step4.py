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
from deep3d_aerial_tpu_torch.ops.cf_conv import (
    cf_conv3x3,
    cf_conv3x3_plain,
    frag_floats,
    pack_weight,
)
from deep3d_aerial_tpu_torch.ops.red_step4 import (
    pack_params,
    red_step4,
    red_step4_plain,
)
from deep3d_aerial_tpu_torch.weights import load_jax_weights

torch.set_num_threads(1)
# the JAX oracle compiled once per shape (eager flax dispatches op by op)
_reference = jax.jit(red_step4_reference, static_argnames=("dtype",))


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
    params = jax.jit(jmod.init)(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(h))
    flat = flat_tree(params, rng)
    want = np.asarray(jax.jit(jmod.apply)(unflatten(params, flat), jnp.asarray(x),
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
    params = jax.jit(jmod.init)(jax.random.PRNGKey(cin), jnp.asarray(cost),
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
            jout = _reference(jparams, jnp.asarray(costs[k]), *js,
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


def unpack_frags(packed, ci, co):
    """K5's packed fragments (ops/cf_conv.py:pack_frags) -> ([ci, 3, 3, co]
    as hi + lo, hi): per (8-channel chunk, tap, n8 fragment) 32 lanes of
    (b0 hi, b1 hi, b0 lo, b1 lo), lane = 4 g + t, b0 the chunk's input
    channel t and b1 t + 4, g the fragment's output channel."""
    ci8, co8 = -(-ci // 8) * 8, -(-co // 8) * 8
    t = np.asarray(packed, np.float32).reshape(ci8 // 8, 9, co8 // 8, 8, 4, 2, 2)
    out = []
    for x in (t[..., 0, :] + t[..., 1, :], t[..., 0, :]):
        # chunk, tap, nf, g, t, half -> (chunk, half, t), tap, (nf, g)
        x = x.transpose(0, 5, 4, 1, 2, 3).reshape(ci8, 9, co8)
        out.append(x[:ci, :, :co].reshape(ci, 3, 3, co))
    return out


@pytest.mark.parametrize("ci,co", [(16, 16), (3, 5), (40, 24)])
def test_pack_weight_splits_into_tf32_fragments(ci, co):
    """K5's weights: hi has TF32's 10 mantissa bits (the low 13 bits 0),
    hi + lo is the weight exactly, the padded channels are 0, and the
    transposed conv packs [in, out, 3, 3] as [in, 3, 3, out]."""
    rng = np.random.default_rng(ci + co)
    w = torch.from_numpy(rng.normal(size=(co, ci, 3, 3)).astype(np.float32))
    packed = pack_weight(w, "same")
    assert packed.numel() == frag_floats(ci, co)
    whole, hi = unpack_frags(packed.numpy(), ci, co)
    np.testing.assert_array_equal(whole, w.permute(1, 2, 3, 0).numpy())
    assert not (hi.view(np.int32) & 0x1FFF).any()
    assert np.abs(whole - hi).max() <= np.abs(whole).max() * 2.0 ** -11
    t = packed.numpy().reshape(-(-ci // 8), 9, -(-co // 8), 8, 4, 2, 2)
    # nonzero input channels (chunk, half, t) and output channels (nf, g)
    assert (np.abs(t).sum(axis=(1, 2, 3, 5)) > 0).sum() == ci
    assert (np.abs(t).sum(axis=(0, 1, 4, 5, 6)) > 0).sum() == co
    wt = torch.from_numpy(rng.normal(size=(ci, co, 3, 3)).astype(np.float32))
    np.testing.assert_array_equal(unpack_frags(pack_weight(wt, "up").numpy(), ci, co)[0],
                                  wt.permute(0, 2, 3, 1).numpy())


def test_pack_params_layout_and_negation():
    """K4's packed buffer: 15 layers in the C entry's order, each as K5's
    TF32 fragments then its bias padded to 8, the cost's input channels of
    conv1 and gru1 negated, then the GroupNorm vectors; the states and
    shapes it refuses."""
    rng = np.random.default_rng(70)
    cin = 16
    _, tmod, _ = _red4_setup(rng, cin, 16, 16)
    p = dict(tmod.named_parameters())
    packed = pack_params(p, cin).numpy()
    shapes = [(cin, 16), (16, 32), (32, 64), (cin + 8, 16), (cin + 8, 8),
              (32, 32), (32, 16), (64, 64), (64, 32), (128, 128), (128, 64),
              (64, 32), (32, 16), (16, 8), (8, 1)]

    def size(ci, co):
        return frag_floats(ci, co) + -(-co // 8) * 8

    assert packed.size == sum(size(*s) for s in shapes) + 6 * (8 + 16 + 32 + 64)
    w1 = p["conv1.conv.weight"].detach()               # OIHW [16, cin, 3, 3]
    n1 = frag_floats(cin, 16)
    np.testing.assert_array_equal(unpack_frags(packed[:n1], cin, 16)[0],
                                  -w1.permute(1, 2, 3, 0).numpy())
    np.testing.assert_array_equal(packed[n1:n1 + 16],
                                  p["conv1.conv.bias"].detach().numpy())
    off = sum(size(*s) for s in shapes[:3])
    g1 = unpack_frags(packed[off:off + frag_floats(cin + 8, 16)], cin + 8, 16)[0]
    wg = p["gru1.gates.weight"].permute(1, 2, 3, 0).detach().numpy()
    np.testing.assert_array_equal(g1[:cin], -wg[:cin])
    np.testing.assert_array_equal(g1[cin:], wg[cin:])
    off = sum(size(*s) for s in shapes[:14])           # out2d: bias padded to 8
    tail = packed[off + frag_floats(8, 1):off + size(8, 1)]
    np.testing.assert_array_equal(tail, np.r_[p["out2d.bias"].detach().numpy(),
                                              np.zeros(7, np.float32)])
    np.testing.assert_array_equal(packed[-64:], p["gru4.on.bias"].detach().numpy())
    with pytest.raises(ValueError, match="multiples of 8"):
        tmod.init_states(12, 16)
