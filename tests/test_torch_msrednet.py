"""The port's MSREDNet modules against the JAX package's, on the CPU, with
the same seeded, perturbed flax parameters mapped through the weight bridge
(the repository holds no trained MSREDNet checkpoint).

The JAX oracle is the package's plain path: warp_impl 'xla' and red_impl
'flax'. Tolerances: 1e-4 absolute for the feature net (fp32 convolutions
and GroupNorms summed in another order, on unit-scale activations); for the
streaming sweep and the whole forward, depth within 1e-3 x the depth range
and confidence within 1e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models.cascade import streaming_sweep as jstreaming_sweep
from deep3d_aerial_tpu.models.cost_reg import RedStep4 as JRedStep4
from deep3d_aerial_tpu.models.feature_net import FeatureNet as JFeatureNet
from deep3d_aerial_tpu.models.msrednet import MSREDNet as JMSREDNet
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models.cascade import streaming_sweep
from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
from deep3d_aerial_tpu_torch.models.feature_net import FeatureNet
from deep3d_aerial_tpu_torch.models.msrednet import MSREDNet
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    tree_to_state_dict,
)
from tests.conftest import random_pose, toy_camera
from tests.test_torch_models import nchw, perturbed

torch.set_num_threads(1)

DMIN, DMAX = 80.0, 120.0
NDEPTHS = (8, 8, 4)
# planes per chunk of the forward's sweeps: 2 scan steps or more per stage,
# and JAX traces a RedStep4 body per plane of a chunk
CHUNK = 2


def test_feature_net_unet():
    rng = np.random.default_rng(81)
    H, W = 32, 48
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    jmod = JFeatureNet(arch="unet")
    flat, jparams = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(8),
                                                 jnp.asarray(imgs[0])), rng)
    tmod = load_jax_weights(FeatureNet(arch="unet"), flat)
    assert tmod.out_channels == (32, 16, 8)
    with torch.no_grad():
        touts = tmod(nchw(imgs))
    apply = jax.jit(jmod.apply)
    for v in range(2):
        jouts = apply(jparams, jnp.asarray(imgs[v]))
        for j, t in zip(jouts, touts):
            np.testing.assert_allclose(t[v].numpy(),
                                       np.moveaxis(np.asarray(j), -1, 0),
                                       rtol=0, atol=1e-4)


class _JSweep(fnn.Module):
    @fnn.compact
    def __call__(self, depths, ref, srcs, rels):
        return jstreaming_sweep(
            reg=JRedStep4(name="red0"), cost_mode="variance", up=False,
            depths=depths, ref_feat=ref, src_feats=srcs, rel_projs=rels,
            weights=None, plane_chunk=2)


def test_streaming_sweep_variance_red_step4():
    """Four chunks of 2 planes with per-pixel depths through the variance
    cost and RedStep4 (the states carried across chunks); depth within
    1e-3 x the 30 m hypothesis spread, confidence within 1e-4."""
    rng = np.random.default_rng(82)
    H, W, C, V = 16, 24, 16, 3
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V + 1)])
    rels = stage_relative_projections(projs, 1)[0].astype(np.float32)
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    srcs = rng.normal(size=(V, H, W, C)).astype(np.float32)
    depths = np.sort(rng.uniform(85, 115, size=(8, H, W)), 0).astype(np.float32)
    args = (depths, ref, srcs, rels)
    jmod = _JSweep()
    flat, jparams = perturbed(
        jax.jit(jmod.init)(jax.random.PRNGKey(9), *map(jnp.asarray, args)), rng, 0.1)
    jd, jc = jax.jit(jmod.apply)(jparams, *map(jnp.asarray, args))

    holder = tnn.Module()
    holder.red0 = RedStep4(C)
    load_jax_weights(holder, flat)
    with torch.no_grad():
        td, tc = streaming_sweep(holder.red0, False,
                                 *(torch.from_numpy(a) for a in args), None,
                                 plane_chunk=2, cost_mode="variance")
    assert td.shape == (H, W)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=3e-2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)


class _PerPlane:
    """A regularizer whose step is the module's whole forward, so every
    plane gathers the parameters again."""

    def __init__(self, module):
        self.module = module

    def init_states(self, *args, **kw):
        return self.module.init_states(*args, **kw)

    def plane_step(self, device, dtype=torch.float32):
        return self.module


@pytest.mark.parametrize("cost_mode", ["correlation", "variance"])
def test_streaming_sweep_gathers_the_step_once(cost_mode, monkeypatch):
    """The sweep asks the regularizer for its step (parameters gathered,
    packed weights looked up) once, not once per plane, and gets exactly
    the numbers of calling the module per plane: the same ops in the same
    order on the CPU."""
    rng = np.random.default_rng(84)
    H, W, C, V = 16, 24, 8, 2
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V + 1)])
    rels = torch.from_numpy(stage_relative_projections(projs, 1)[0].astype(np.float32))
    ref = torch.from_numpy(rng.normal(size=(H, W, C)).astype(np.float32))
    srcs = torch.from_numpy(rng.normal(size=(V, H, W, C)).astype(np.float32))
    depths = torch.linspace(85.0, 115.0, 8)
    reg = RedStep4(C) if cost_mode == "variance" else RedStep2(C, up=False)
    reg = init_random_weights(reg, seed=4)
    calls = []
    step = reg.plane_step
    monkeypatch.setattr(reg, "plane_step",
                        lambda dev, dtype: calls.append(dev) or step(dev, dtype))
    with torch.no_grad():
        got = streaming_sweep(reg, False, depths, ref, srcs, rels, None,
                              plane_chunk=4, cost_mode=cost_mode)
        assert calls == [torch.device("cpu")]
        want = streaming_sweep(_PerPlane(reg), False, depths, ref, srcs, rels,
                               None, plane_chunk=4, cost_mode=cost_mode)
    assert len(calls) == 1 + len(depths)    # the module's forward, per plane
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.fixture(scope="module")
def jax_forward():
    """One JAX MSREDNet forward at 64x96, ndepths (8, 8, 4) in chunks of
    2 planes, 3 views, on seeded perturbed parameters: (flat tree, inputs,
    outputs)."""
    rng = np.random.default_rng(83)
    V, H, W = 3, 64, 96
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    jmod = JMSREDNet(ndepths=NDEPTHS, num_depth=64, warp_impl="xla",
                     red_impl="flax", plane_chunk=CHUNK)
    inputs = (jnp.asarray(imgs), jnp.asarray(rel), DMIN, DMAX)
    flat, jparams = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(10),
                                                 *inputs), rng)
    jout = jax.jit(jmod.apply)(jparams, *inputs)
    return flat, (imgs, rel), jax.tree_util.tree_map(np.asarray, jout)


def test_msrednet_forward(jax_forward):
    flat, (imgs, rel), jout = jax_forward
    tmod = load_jax_weights(MSREDNet(ndepths=NDEPTHS, num_depth=64,
                                     plane_chunk=CHUNK), flat).eval()
    assert len(flat) == len(tree_to_state_dict(tmod, flat))
    with torch.no_grad():
        tout = tmod(torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    depth_tol = 1e-3 * (DMAX - DMIN)
    for s in ("stage1", "stage2", "stage3"):
        np.testing.assert_allclose(tout[s]["depth"].numpy(), jout[s]["depth"],
                                   rtol=0, atol=depth_tol, err_msg=s)
        np.testing.assert_allclose(tout[s]["photometric_confidence"].numpy(),
                                   jout[s]["photometric_confidence"],
                                   rtol=0, atol=1e-4, err_msg=s)
    assert tout["depth"].shape == (64, 96)
    assert set(tout) == set(jout)


def test_msrednet_plain_impls_and_registry(jax_forward):
    """build_model('msrednet') is the same network; the plain switches give
    the same numbers on the CPU (where the kernel switches run the plain
    versions too)."""
    flat, (imgs, rel), _ = jax_forward
    mk = load_jax_weights(build_model("msrednet", ndepths=NDEPTHS, num_depth=64,
                                      plane_chunk=CHUNK), flat).eval()
    mp = load_jax_weights(MSREDNet(ndepths=NDEPTHS, num_depth=64, plane_chunk=CHUNK,
                                   warp_impl="plain", red_impl="plain"),
                          flat).eval()
    args = (torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    with torch.no_grad():
        ok, op = mk(*args), mp(*args)
    for key in ("depth", "photometric_confidence"):
        np.testing.assert_array_equal(ok[key].numpy(), op[key].numpy())


@pytest.mark.parametrize("kw,error", [
    ({"warp_precision": "float64"}, ValueError),
    ({"norm": "instance"}, ValueError),
    ({"warp_impl": "xla"}, ValueError),
    ({"red_impl": "flax"}, ValueError),
])
def test_msrednet_settings_not_ported_raise(kw, error):
    with pytest.raises(error):
        MSREDNet(**kw)
