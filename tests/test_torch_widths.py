"""The last JAX modules in the port, against the JAX package's, on the CPU:
`depth_gradient_weights` and `depth_from_normal`, ConvLSTMCell,
DeformConv2d, the 'layer' and 'batch' norms through ConvBlock, DeconvBlock
and CostRegNet3D (float32 and bfloat16), RedStep2 and RedStep4 at base
width 16, and the weight bridge's `batch_stats` collection.

The JAX oracle is the package's plain path (flax modules, warp_impl 'xla',
red_impl 'flax') on the same seeded numpy inputs and the same weights:
JAX's init perturbed (`perturbed`), or the port's seeded initializer
handed to JAX through weights.state_dict_to_tree (`seeded`). Tolerances:
1e-5 for depth_from_normal and the edge weights (relative to the value:
the same elementwise ops, the divisions in another fusion), 1e-5 absolute
for ConvLSTMCell and DeformConv2d (one small conv each, unit-scale data,
sums in another order), 1e-4 absolute for the blocks, CostRegNet3D and
the recurrent steps (as tests/test_torch_casmvsnet.py), and in bfloat16
the rule of tests/test_torch_bf16_blocks.py: 2x the JAX package's own
bfloat16-vs-float32 distance plus 2 bfloat16 ulps of its largest value.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.models import blocks as jblocks
from deep3d_aerial_tpu.models.cost_reg import CostRegNet3D as JCostRegNet3D
from deep3d_aerial_tpu.models.cost_reg import RedStep2 as JRedStep2
from deep3d_aerial_tpu.models.cost_reg import RedStep4 as JRedStep4
from deep3d_aerial_tpu.ops import normals as jnormals
from deep3d_aerial_tpu_torch.models.blocks import (
    BatchNorm,
    ConvBlock,
    ConvLSTMCell,
    DeconvBlock,
    DeformConv2d,
    LayerNorm,
)
from deep3d_aerial_tpu_torch.models.cost_reg import CostRegNet3D, RedStep2, RedStep4
from deep3d_aerial_tpu_torch.ops import normals
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
    tree_to_state_dict,
)
from tests.test_torch_bf16_blocks import check_bf16, ncdhw, seeded
from tests.test_torch_models import nchw, perturbed
from tests.test_torch_train_step import nest

torch.set_num_threads(1)
BF = torch.bfloat16
NORMS = ("layer", "batch")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def hwc(x):
    """[C, H, W] (torch) -> [H, W, C] (numpy)."""
    return np.moveaxis(x.float().numpy(), 0, -1)


# ---------------------------------------------------------------- normals


def _normal_inputs(seed, H=12, W=16):
    """Depth, unit normals facing the camera, intrinsics and a luminance
    with an edge; three pixels' normals are set so that a neighbour's
    plane denominator is exactly 0 (-> +1e-3), exactly -5e-4 (-> -1e-3)
    and exactly +5e-4 (-> +1e-3), one of them on the border."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(80, 120, size=(H, W)).astype(np.float32)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[3, 5] = 0.0               # ray . n = 0 exactly
    n[7, 9] = [0, 0, -5e-4]     # ray . n = -5e-4
    n[0, 4] = [0, 0, 5e-4]      # on the top border
    K = np.array([[1.1 * W, 0, W / 2 + 0.3], [0, 1.1 * W, H / 2 - 0.2], [0, 0, 1]],
                 np.float32)
    gray = rng.uniform(0, 1, size=(H, W)).astype(np.float32)
    gray[:, W // 2:] += 2.0
    return depth, n.astype(np.float32), K, gray


def test_depth_gradient_weights_match_jax():
    _, _, _, gray = _normal_inputs(1)
    want = np.asarray(jnormals.depth_gradient_weights(jnp.asarray(gray), beta=3.0))
    got = normals.depth_gradient_weights(t(gray), beta=3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_depth_from_normal_matches_jax():
    """Every pixel, the border (own depth at weight 1e-6 for the missing
    neighbours) and the clamped denominators included; relative to the
    ~100 m depths."""
    depth, n, K, gray = _normal_inputs(2)
    want = np.asarray(jax.jit(jnormals.depth_from_normal)(
        jnp.asarray(depth), jnp.asarray(n), jnp.asarray(K), jnp.asarray(gray)))
    got = normals.depth_from_normal(t(depth), t(n), t(K), t(gray)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- cells


def test_conv_lstm_cell_two_steps():
    rng = np.random.default_rng(3)
    H, W, cin, hid = 10, 14, 5, 6
    xs = rng.normal(size=(2, H, W, cin)).astype(np.float32)
    h = rng.normal(size=(H, W, hid)).astype(np.float32) * 0.5
    c = rng.normal(size=(H, W, hid)).astype(np.float32) * 0.5
    jmod = jblocks.ConvLSTMCell(hid)
    flat, jp = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(3), xs[0], h, c), rng, 0.1)
    tmod = load_jax_weights(ConvLSTMCell(cin, hid), flat)
    apply = jax.jit(jmod.apply)
    jh, jc, th, tc = jnp.asarray(h), jnp.asarray(c), nchw(h[None]), nchw(c[None])
    with torch.no_grad():
        for x in xs:  # the states carried from step to step
            jh, jc, jo = apply(jp, jnp.asarray(x), jh, jc)
            th, tc, to = tmod(nchw(x[None]), th, tc)
            for a, b in ((th, jh), (tc, jc), (to, jo)):
                np.testing.assert_allclose(hwc(a[0]), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("modulation", [True, False])
def test_deform_conv2d_random_offsets(modulation):
    """Offsets of a few pixels and masks away from 0.5 (p_conv and m_conv
    given random kernels), so taps land at fractional positions and many
    clip at the border; the zero-offset case alone would check nothing."""
    rng = np.random.default_rng(4 + modulation)
    H, W, cin, cout = 9, 13, 4, 6
    x = rng.normal(size=(1, H, W, cin)).astype(np.float32)
    jmod = jblocks.DeformConv2d(cout, modulation=modulation)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(4), x)
    assert all(not np.asarray(v).any() for k, v in
               flax.traverse_util.flatten_dict(params["params"]).items()
               if k[0] in ("p_conv", "m_conv") and k[1] == "kernel")
    flat, jp = perturbed(params, rng, 0.05)
    for k in flat:
        if "['p_conv']" in k or "['m_conv']" in k:
            flat[k] = rng.normal(scale=0.6, size=flat[k].shape).astype(np.float32)
    jp = nest(flat)
    tmod = load_jax_weights(DeformConv2d(cin, cout, modulation=modulation), flat)
    with torch.no_grad():
        off = tmod.p_conv(nchw(x))
        got = tmod(nchw(x))[0]
    assert float(off.abs().max()) > 2.0   # taps several pixels away: some clip
    assert float((off - off.round()).abs().max()) > 0.25  # fractional positions
    want = np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(x)))[0]
    np.testing.assert_allclose(hwc(got), want, rtol=0, atol=1e-5)


def test_deform_conv2d_initializer_zeroes_the_offset_convs():
    m = init_random_weights(DeformConv2d(3, 5), seed=1)
    assert not m.p_conv.weight.any() and not m.m_conv.weight.any()
    assert m.w.weight.abs().sum() > 0
    tree = state_dict_to_tree(m)
    assert "['params']['w']['kernel']" in tree
    assert tree["['params']['w']['kernel']"].shape == (1, 1, 27, 5)


# ---------------------------------------------------------------- norms


def _stats(tmod, rng):
    """Non-trivial BatchNorm statistics in every BatchNorm of `tmod`."""
    with torch.no_grad():
        for m in tmod.modules():
            if isinstance(m, BatchNorm):
                m.mean.copy_(t(rng.normal(scale=0.5, size=m.mean.shape).astype(np.float32)))
                m.var.copy_(t(rng.uniform(0.3, 2.0, size=m.var.shape).astype(np.float32)))
    return nest(state_dict_to_tree(tmod))


def _block_case(kind, norm, ndim, rng):
    """(jax module maker, port module, input in the JAX layout, to-port
    layout, from-port layout)."""
    shape = (7, 10, 12, 6) if ndim == 3 else (10, 12, 6)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "conv":
        jmk = lambda dt: jblocks.ConvBlock(8, norm=norm, ndim=ndim, dtype=dt)
        tmod = ConvBlock(6, 8, norm=norm, ndim=ndim)
    else:
        jmk = lambda dt: jblocks.DeconvBlock(8, norm=norm, ndim=ndim, dtype=dt)
        tmod = DeconvBlock(6, 8, norm=norm, ndim=ndim)
    to_t = ncdhw if ndim == 3 else (lambda a: nchw(a[None]))
    return jmk, tmod, x, to_t, (lambda y: np.moveaxis(y[0].float().numpy(), 0, -1))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", ["conv", "deconv"])
@pytest.mark.parametrize("norm", NORMS)
def test_blocks_with_layer_and_batch_norm(norm, kind, ndim):
    """float32 at 1e-4; bfloat16 against JAX's bfloat16 by the module
    docstring's rule; the norm's parameters (and BatchNorm's statistics)
    named as the JAX tree names them."""
    rng = np.random.default_rng(10 + 2 * ndim + (kind == "conv") + 5 * (norm == "batch"))
    jmk, tmod, x, to_t, back = _block_case(kind, norm, ndim, rng)
    seeded(tmod, rng)
    jp = _stats(tmod, rng)
    if norm == "batch":
        assert set(jp) == {"params", "batch_stats"}
        assert set(jp["batch_stats"]["BatchNorm_0"]) == {"mean", "var"}
    else:
        assert set(jp["params"]) == {"Conv_0" if kind == "conv" else "ConvTranspose_0",
                                     "LayerNorm_0"}
    j32 = np.asarray(jax.jit(jmk(jnp.float32).apply)(jp, jnp.asarray(x)))
    jbf = np.asarray(jax.jit(jmk(jnp.bfloat16).apply)(jp, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got32 = back(tmod(to_t(x)))
        gotbf = tmod(to_t(x).to(BF))
    assert gotbf.dtype == BF
    np.testing.assert_allclose(got32, j32, rtol=0, atol=1e-4)
    check_bf16(back(gotbf), jbf, j32, f"{kind}{ndim}d {norm}")


@pytest.mark.parametrize("norm", NORMS)
def test_cost_reg_net_3d_layer_and_batch_norm(norm):
    rng = np.random.default_rng(20 + (norm == "batch"))
    C = 8
    vol = rng.normal(size=(8, 16, 16, C)).astype(np.float32)
    tmod = CostRegNet3D(C, norm=norm)
    seeded(tmod, rng)
    jp = _stats(tmod, rng)
    want32 = np.asarray(jax.jit(JCostRegNet3D(norm=norm).apply)(jp, jnp.asarray(vol)))
    wantbf = np.asarray(jax.jit(JCostRegNet3D(norm=norm, dtype=jnp.bfloat16).apply)(
        jp, jnp.asarray(vol)), np.float32)
    with torch.no_grad():
        got32 = tmod(ncdhw(vol))[0, 0].numpy()
        gotbf = tmod(ncdhw(vol).to(BF))[0, 0]
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-4)
    check_bf16(gotbf.float().numpy(), wantbf, want32, f"CostRegNet3D {norm}")


def test_layer_norm_is_per_position_over_channels():
    """Not nn.LayerNorm([C, H, W]): every pixel's channels have mean 0 and
    (at unit scale) variance 1 on their own."""
    x = torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(0)) * 3 + 1
    y = LayerNorm(6)(x)
    torch.testing.assert_close(y.mean(1), torch.zeros(2, 5, 7), rtol=0, atol=1e-5)
    torch.testing.assert_close(y.var(1, unbiased=False), torch.ones(2, 5, 7),
                               rtol=0, atol=1e-4)


def test_batch_norm_gradients_match_jax_with_fixed_statistics():
    """The gradients of a ConvBlock with BatchNorm to its input and
    parameters match JAX's (the statistics held fixed on both sides); the
    statistics are buffers of the port, which no optimizer sees."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(6, 8, 5)).astype(np.float32)
    jmod = jblocks.ConvBlock(4, norm="batch")
    tmod = ConvBlock(5, 4, norm="batch")
    seeded(tmod, rng)
    jp = _stats(tmod, rng)
    loss = lambda p, xx: (jmod.apply({"params": p, "batch_stats": jp["batch_stats"]},
                                     xx) ** 2).sum()
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp["params"], jnp.asarray(x))
    tx = nchw(x[None]).requires_grad_(True)
    (tmod(tx) ** 2).sum().backward()
    assert {n for n, _ in tmod.named_buffers()} == {"norm.mean", "norm.var"}
    assert not any(n.endswith(("mean", "var")) for n, _ in tmod.named_parameters())
    np.testing.assert_allclose(hwc(tx.grad[0]), np.asarray(jgx), rtol=0, atol=1e-4)
    for leaf, got in (("scale", tmod.norm.weight.grad), ("bias", tmod.norm.bias.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jgp["BatchNorm_0"][leaf]),
                                   rtol=1e-5, atol=1e-4)


def test_batch_norm_needs_its_statistics_as_the_jax_apply_does():
    """A tree with `params` only: the JAX apply raises
    ScopeCollectionNotFound, the port's weight bridge ValueError; with the
    `batch_stats` collection both load whole, and the bridge round-trips
    it."""
    rng = np.random.default_rng(32)
    x = rng.normal(size=(6, 8, 5)).astype(np.float32)
    tmod = ConvBlock(5, 4, norm="batch")
    seeded(tmod, rng)
    jp = _stats(tmod, rng)
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        jblocks.ConvBlock(4, norm="batch").apply({"params": jp["params"]}, jnp.asarray(x))
    tree = state_dict_to_tree(tmod)
    params_only = {k: v for k, v in tree.items() if k.startswith("['params']")}
    assert len(params_only) == len(tree) - 2
    with pytest.raises(ValueError, match="batch_stats"):
        tree_to_state_dict(ConvBlock(5, 4, norm="batch"), params_only)
    back = tree_to_state_dict(ConvBlock(5, 4, norm="batch"), tree)
    for k, v in tmod.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["instance", "Group"])
def test_unknown_norm_raises_as_in_jax(norm):
    x = jnp.zeros((4, 4, 3))
    with pytest.raises(ValueError, match="unknown norm"):
        jblocks.ConvBlock(4, norm=norm).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="unknown norm"):
        ConvBlock(3, 4, norm=norm)


# ---------------------------------------------------------------- base widths


@pytest.mark.parametrize("up", [True, False])
def test_red_step2_base_16(up):
    """The 2-level ConvGRU at base 16 (hidden 16 and 32): its plain body on
    every device, no K3 launch; one step against the flax body."""
    rng = np.random.default_rng(40 + up)
    cin, H, W, b = 24, 10, 14, 16
    cost = rng.normal(size=(H, W, cin)).astype(np.float32)
    s1 = rng.normal(size=(H, W, b)).astype(np.float32) * 0.5
    s2 = rng.normal(size=(H // 2, W // 2, 2 * b)).astype(np.float32) * 0.5
    tmod = RedStep2(cin, up=up, base=b)
    assert not tmod.kernel
    assert [tuple(s.shape) for s in tmod.init_states(H, W)] == [(b, H, W), (2 * b, H // 2, W // 2)]
    jp = seeded(tmod, rng)
    jout = jax.jit(JRedStep2(up=up, base=b).apply)(
        {"params": jp["params"]}, *map(jnp.asarray, (cost, s1, s2)))
    with torch.no_grad():
        tout = tmod(*(t(np.moveaxis(a, -1, 0)) for a in (cost, s1, s2)))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-4)
    for a, b_ in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(hwc(a), np.asarray(b_), rtol=0, atol=1e-4)


def test_red_step4_base_16():
    """The 4-level NormGRU encoder-decoder at base 16 (hidden 16, 32, 64,
    128): its plain body on every device, no K4 launch."""
    rng = np.random.default_rng(42)
    cin, H, W, b = 12, 16, 24, 16
    cost = rng.normal(size=(H, W, cin)).astype(np.float32)
    states = [rng.normal(size=(H >> l, W >> l, b << l)).astype(np.float32) * 0.5
              for l in range(4)]
    tmod = RedStep4(cin, base=b)
    assert not tmod.kernel
    assert [tuple(s.shape) for s in tmod.init_states(H, W)] == [
        (b << l, H >> l, W >> l) for l in range(4)]
    jp = seeded(tmod, rng)
    jout = jax.jit(JRedStep4(base=b).apply)(
        {"params": jp["params"]}, *map(jnp.asarray, (cost, *states)))
    with torch.no_grad():
        tout = tmod(*(t(np.moveaxis(a, -1, 0)) for a in (cost, *states)))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-4)
    for a, b_ in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(hwc(a), np.asarray(b_), rtol=0, atol=1e-4)


def test_kernel_route_is_chosen_from_base_at_construction():
    """At base 8 the steps take their kernels (K3, K4) on the card; at any
    other base their plain bodies, on every device (the JAX package's
    `self.base == 8`). impl 'plain' is plain at every base."""
    assert RedStep2(8).kernel and RedStep4(8).kernel
    assert not RedStep2(8, base=4).kernel and not RedStep4(8, base=32).kernel
    assert not RedStep2(8, impl="plain").kernel
    step = RedStep4(8, base=4).plane_step(torch.device("cuda"))
    assert step.func.__name__ == "red_step4_plain"
    step = RedStep2(8, base=16).plane_step(torch.device("cuda"))
    assert step.func.__name__ == "red_step2_plain"
    assert not getattr(step, "folds_softmax", False)


def test_branch_feature_net_below_base_2_raises_as_in_jax():
    """Stage 3's branches of a 'branch' FeatureNet have b // 2 channels: at
    base 1 none, and the JAX initializer raises ZeroDivisionError; the
    port refuses the width when it builds the net."""
    from deep3d_aerial_tpu.models.feature_net import FeatureNet as JFeatureNet
    from deep3d_aerial_tpu_torch.models.feature_net import FeatureNet

    x = jnp.zeros((16, 16, 3))
    with pytest.raises(ZeroDivisionError):
        JFeatureNet(base_channels=1, arch="branch").init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="base width"):
        FeatureNet(base_channels=1, arch="branch")
    FeatureNet(base_channels=1, arch="unet")  # no branch: base 1 builds
