"""The port's CasMVSNet and UCSNet modules against the JAX package's, on the
CPU, with the same seeded, perturbed flax parameters mapped through the
weight bridge (the repository holds no trained checkpoint of either).

The JAX oracle is the package's plain path, warp_impl 'xla'. Tolerances:
1e-5 absolute for the ops (3-D 'SAME' convs, samplers, the variance volume,
the heads), 1e-4 for the blocks and CostRegNet3D (fp32 convolutions and
GroupNorms summed in another order), and for the whole forwards, per stage,
depth and UCSNet's sigma within 1e-3 x the depth range, confidence within
1e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models import blocks as jblocks
from deep3d_aerial_tpu.models import cascade as jcascade
from deep3d_aerial_tpu.models.casmvsnet import CasMVSNet as JCasMVSNet
from deep3d_aerial_tpu.models.cost_reg import CostRegNet3D as JCostRegNet3D
from deep3d_aerial_tpu.models.feature_net import FeatureNet as JFeatureNet
from deep3d_aerial_tpu.models.ucsnet import UCSNet as JUCSNet
from deep3d_aerial_tpu.ops.depth_samplers import (
    variance_depth_samples as jvariance_depth_samples,
)
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models import cascade
from deep3d_aerial_tpu_torch.models.blocks import (
    Conv3d,
    ConvBlock,
    ConvTranspose3d,
    DeconvBlock,
    GroupNorm,
)
from deep3d_aerial_tpu_torch.models.casmvsnet import CasMVSNet
from deep3d_aerial_tpu_torch.models.cost_reg import CostRegNet3D
from deep3d_aerial_tpu_torch.models.feature_net import FeatureNet
from deep3d_aerial_tpu_torch.models.ucsnet import UCSNet
from deep3d_aerial_tpu_torch.ops.depth_samplers import variance_depth_samples
from deep3d_aerial_tpu_torch.weights import load_jax_weights, tree_to_state_dict
from tests.conftest import random_pose, toy_camera
from tests.test_torch_models import nchw, perturbed

torch.set_num_threads(1)

DMIN, DMAX = 80.0, 120.0
NDEPTHS = (8, 8, 8)


def ncdhw(a):
    """[D, H, W, C] -> [1, C, D, H, W]."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))[None]


def _init(jmod, x, rng, seed, scale=0.05):
    return perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x)),
                     rng, scale)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("stride,shape", [
    (1, (8, 6, 10)), (2, (8, 6, 10)), (2, (5, 7, 6)), (1, (3, 5, 4))])
def test_conv3d_same(stride, shape):
    """3x3x3 'SAME' conv, stride 1 and 2 (pads (0, 1) on even D, H, W; odd
    sides too), against flax nn.Conv."""
    rng = np.random.default_rng(100 + stride)
    x = rng.normal(size=(*shape, 5)).astype(np.float32)
    jmod = fnn.Conv(7, (3, 3, 3), strides=(stride,) * 3, padding="SAME")
    flat, jp = _init(jmod, x, rng, 1)
    tmod = load_jax_weights(Conv3d(5, 7, stride=stride), flat)
    with torch.no_grad():
        got = tmod(ncdhw(x))[0].numpy()
    want = np.moveaxis(np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(x))), -1, 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 3, 5), (2, 4, 4)])
def test_conv_transpose3d_same(shape):
    """Exact-2x 3x3x3 transposed conv, unflipped on the JAX side: cropped
    to 2n on D, H and W."""
    rng = np.random.default_rng(110)
    x = rng.normal(size=(*shape, 6)).astype(np.float32)
    jmod = fnn.ConvTranspose(4, (3, 3, 3), strides=(2, 2, 2), padding="SAME")
    flat, jp = _init(jmod, x, rng, 2)
    tmod = load_jax_weights(ConvTranspose3d(6, 4), flat)
    with torch.no_grad():
        got = tmod(ncdhw(x))[0].numpy()
    want = np.moveaxis(np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(x))), -1, 0)
    assert got.shape == (4,) + tuple(2 * n for n in shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_variance_depth_samples():
    rng = np.random.default_rng(120)
    center = rng.uniform(90, 110, size=(6, 9)).astype(np.float32)
    sigma = rng.uniform(0.1, 3.0, size=(6, 9)).astype(np.float32)
    want = np.asarray(jvariance_depth_samples(jnp.asarray(center),
                                              jnp.asarray(sigma), 8, 1.5))
    got = variance_depth_samples(torch.from_numpy(center),
                                 torch.from_numpy(sigma), 8, 1.5).numpy()
    assert got.shape == (8, 6, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("D,per_pixel", [(16, False), (12, True), (5, True)])
def test_variance_cost_volume(D, per_pixel):
    """The whole volume in chunks of the largest divisor of D up to 8 (8,
    6 and 5 planes), uniform or per-pixel planes, against the JAX
    package's gather build."""
    rng = np.random.default_rng(130 + D)
    H, W, C, V = 12, 16, 8, 3
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 1)[0].astype(np.float32)
    feats = rng.normal(size=(V, H, W, C)).astype(np.float32)
    if per_pixel:
        depths = np.sort(rng.uniform(85, 115, size=(D, H, W)), 0).astype(np.float32)
    else:
        depths = np.linspace(85, 115, D).astype(np.float32)
    want = np.asarray(jax.jit(jcascade.variance_cost_volume)(
        jnp.asarray(feats), jnp.asarray(rel), jnp.asarray(depths)))
    got = cascade.variance_cost_volume(torch.from_numpy(feats), torch.from_numpy(rel),
                                       torch.from_numpy(depths))
    assert got.shape == (1, C, D, H, W)
    np.testing.assert_allclose(np.moveaxis(got[0].numpy(), 0, -1), want,
                               rtol=0, atol=1e-5)
    plain = cascade.variance_cost_volume(torch.from_numpy(feats), torch.from_numpy(rel),
                                         torch.from_numpy(depths), warp_impl="plain")
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("per_pixel", [False, True])
def test_softmax_head_and_soft_argmax(per_pixel):
    rng = np.random.default_rng(140)
    D, H, W = 8, 6, 7
    scores = rng.normal(scale=2.0, size=(D, H, W)).astype(np.float32)
    depths = (np.sort(rng.uniform(85, 115, size=(D, H, W)), 0) if per_pixel
              else np.linspace(85, 115, D)).astype(np.float32)
    want = jcascade.masked_softmax_depth_head(jnp.asarray(scores), jnp.asarray(depths))
    got = cascade.masked_softmax_depth_head(torch.from_numpy(scores),
                                            torch.from_numpy(depths))
    for g, w, tol in zip(got, want, (1e-5, 1e-5 * DMAX, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


def test_window_confidence():
    """Truncated expected index (not rounded), clipped, 4 taps over the
    (1, 2)-padded planes; a pixel whose probabilities are all NaN gathers
    at index 0 on both sides (XLA converts NaN to 0) and stays NaN."""
    rng = np.random.default_rng(150)
    D, H, W = 8, 5, 6
    e = np.exp(rng.normal(scale=2.0, size=(D, H, W)))
    prob = (e / e.sum(0)).astype(np.float32)
    prob[:, 0, 0] = 0.0
    prob[-1, 0, 0] = 1.0          # index D-1: the window runs past the end
    prob[:, 0, 1] = 0.0
    prob[0, 0, 1] = 1.0           # index 0: the window starts before it
    prob[:, 0, 2] = 1.0 / D       # index 3.5: truncated to 3
    prob[:, 4, 5] = np.nan
    want = np.asarray(jcascade.window_confidence(jnp.asarray(prob)))
    got = cascade.window_confidence(torch.from_numpy(prob)).numpy()
    assert np.isnan(want[4, 5]) and np.isnan(got[4, 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[0, 2] == pytest.approx(4.0 / D)


# ---------------------------------------------------------------- blocks


def test_group_norm_per_depth_plane():
    """Linen reads axis 0 of an unbatched [D, H, W, C] volume as the batch:
    the statistics are per depth plane. Each plane here has its own offset,
    so a GroupNorm pooling the volume would be far off."""
    rng = np.random.default_rng(160)
    D, H, W, C = 6, 5, 7, 16
    x = (rng.normal(size=(D, H, W, C))
         + np.arange(D)[:, None, None, None]).astype(np.float32)
    jmod = fnn.GroupNorm(num_groups=C // 8)
    flat, jp = _init(jmod, x, rng, 3, scale=0.3)
    tmod = load_jax_weights(GroupNorm(C), flat)
    with torch.no_grad():
        got = tmod(ncdhw(x))[0].numpy()
        pooled = torch.nn.functional.group_norm(
            ncdhw(x), C // 8, tmod.weight, tmod.bias, eps=1e-6)[0].numpy()
    want = np.moveaxis(np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(x))), -1, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(pooled - want).max() > 0.1


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_block_3d(stride):
    rng = np.random.default_rng(170 + stride)
    x = rng.normal(size=(8, 6, 10, 8)).astype(np.float32)
    jmod = jblocks.ConvBlock(16, ndim=3, stride=stride)
    flat, jp = _init(jmod, x, rng, 4)
    tmod = load_jax_weights(ConvBlock(8, 16, stride=stride, ndim=3), flat)
    with torch.no_grad():
        got = tmod(ncdhw(x))[0].numpy()
    want = np.moveaxis(np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(x))), -1, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_deconv_block_3d():
    rng = np.random.default_rng(180)
    x = rng.normal(size=(4, 3, 5, 16)).astype(np.float32)
    jmod = jblocks.DeconvBlock(8, ndim=3)
    flat, jp = _init(jmod, x, rng, 5)
    tmod = load_jax_weights(DeconvBlock(16, 8, ndim=3), flat)
    with torch.no_grad():
        got = tmod(ncdhw(x))[0].numpy()
    want = np.moveaxis(np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(x))), -1, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("C", [8, 32])
def test_cost_reg_net_3d(C):
    rng = np.random.default_rng(190 + C)
    vol = rng.normal(size=(8, 16, 24, C)).astype(np.float32)
    jmod = JCostRegNet3D()
    flat, jp = _init(jmod, vol, rng, 6)
    tmod = load_jax_weights(CostRegNet3D(C), flat)
    assert len(flat) == len(tree_to_state_dict(tmod, flat))
    with torch.no_grad():
        got = tmod(ncdhw(vol))
    want = np.asarray(jax.jit(jmod.apply)(jp, jnp.asarray(vol)))
    assert got.shape == (1, 1, 8, 16, 24)
    np.testing.assert_allclose(got[0, 0].numpy(), want, rtol=0, atol=1e-4)


def test_feature_net_fpn():
    rng = np.random.default_rng(200)
    H, W = 32, 48
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    jmod = JFeatureNet(arch="fpn")
    flat, jparams = _init(jmod, imgs[0], rng, 7)
    tmod = load_jax_weights(FeatureNet(arch="fpn"), flat)
    assert not hasattr(tmod, "deconv1") and not hasattr(tmod, "deconv2")
    with torch.no_grad():
        touts = tmod(nchw(imgs))
    apply = jax.jit(jmod.apply)
    for v in range(2):
        for j, t in zip(apply(jparams, jnp.asarray(imgs[v])), touts):
            np.testing.assert_allclose(t[v].numpy(), np.moveaxis(np.asarray(j), -1, 0),
                                       rtol=0, atol=1e-4)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("name,jcls,arch,ndepths", [
    ("casmvsnet", JCasMVSNet, "fpn", (48, 32, 8)),
    ("ucsnet", JUCSNet, "unet", (64, 32, 8)),
])
def test_build_model_published_widths(name, jcls, arch, ndepths):
    """build_model(name) is the JAX model's default network: every leaf of
    its parameter tree (shapes from jax.eval_shape) maps onto the port's."""
    model = build_model(name)
    assert model.ndepths == ndepths and model.num_depth == 384
    assert model.feature.arch == arch and model.feature.out_channels == (32, 16, 8)
    shapes = jax.eval_shape(jcls().init, jax.random.PRNGKey(0),
                            jnp.zeros((3, 32, 32, 3)), jnp.zeros((3, 2, 4, 4)),
                            80.0, 120.0)
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    flat = {jax.tree_util.keystr(p): np.zeros(s.shape, np.float32) for p, s in paths}
    assert len(tree_to_state_dict(model, flat)) == len(flat)


@pytest.mark.parametrize("cls", [CasMVSNet, UCSNet])
@pytest.mark.parametrize("kw,error", [
    ({"warp_precision": "float64"}, ValueError),
    ({"warp_impl": "xla"}, ValueError),
    ({"arch": "resnet"}, ValueError),
])
def test_volume_model_settings_refused(cls, kw, error):
    with pytest.raises(error):
        cls(**kw)


def test_ucsnet_takes_no_interval_ratios():
    with pytest.raises(TypeError):
        build_model("ucsnet", depth_interval_ratios=(4.0, 2.0, 1.0))


def _jax_forward(jcls, seed):
    """One JAX forward at 64x96, ndepths (8, 8, 8), 3 views, on seeded
    perturbed parameters: (flat tree, inputs, outputs)."""
    rng = np.random.default_rng(seed)
    V, H, W = 3, 64, 96
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    jmod = jcls(ndepths=NDEPTHS, num_depth=64, warp_impl="xla")
    inputs = (jnp.asarray(imgs), jnp.asarray(rel), DMIN, DMAX)
    flat, jparams = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(seed), *inputs),
                              rng)
    jout = jax.jit(jmod.apply)(jparams, *inputs)
    return flat, (imgs, rel), jax.tree_util.tree_map(np.asarray, jout)


@pytest.fixture(scope="module")
def cas_forward():
    return _jax_forward(JCasMVSNet, 210)


@pytest.fixture(scope="module")
def ucs_forward():
    return _jax_forward(JUCSNet, 220)


def _check_forward(tmod, fwd, keys):
    flat, (imgs, rel), jout = fwd
    load_jax_weights(tmod, flat).eval()
    assert len(flat) == len(tree_to_state_dict(tmod, flat))
    with torch.no_grad():
        tout = tmod(torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    tols = {"depth": 1e-3 * (DMAX - DMIN), "variance": 1e-3 * (DMAX - DMIN),
            "photometric_confidence": 1e-4}
    for s in ("stage1", "stage2", "stage3"):
        assert set(tout[s]) == set(keys)
        for k in keys:
            np.testing.assert_allclose(tout[s][k].numpy(), jout[s][k], rtol=0,
                                       atol=tols[k], err_msg=f"{s} {k}")
    assert tout["depth"].shape == (64, 96)
    assert set(tout) == set(jout)
    return tout


def test_casmvsnet_forward(cas_forward):
    _check_forward(CasMVSNet(ndepths=NDEPTHS, num_depth=64), cas_forward,
                   ("depth", "photometric_confidence"))


def test_ucsnet_forward(ucs_forward):
    tout = _check_forward(UCSNet(ndepths=NDEPTHS, num_depth=64), ucs_forward,
                          ("depth", "photometric_confidence", "variance"))
    assert (tout["stage1"]["variance"] > 0).all()


@pytest.mark.parametrize("name", ["casmvsnet", "ucsnet"])
def test_plain_impl_and_registry(name, request):
    """build_model(name) is the same network; warp_impl 'plain' gives the
    same numbers on the CPU, where 'kernel' runs the plain version too."""
    flat, (imgs, rel), _ = request.getfixturevalue(
        "cas_forward" if name == "casmvsnet" else "ucs_forward")
    mk = load_jax_weights(build_model(name, ndepths=NDEPTHS, num_depth=64), flat).eval()
    mp = load_jax_weights(build_model(name, ndepths=NDEPTHS, num_depth=64,
                                      warp_impl="plain"), flat).eval()
    args = (torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    marks = []
    with torch.no_grad():
        ok = mk(*args, mark=marks.append)
        op = mp(*args)
    for key in ("depth", "photometric_confidence"):
        np.testing.assert_array_equal(ok[key].numpy(), op[key].numpy())
    assert marks == ["features"] + [f"stage{s}{p}" for s in (1, 2, 3)
                                    for p in (".volume", ".cost_reg", "")]
