"""The port's AdaMVS modules against the JAX package's, on the CPU, with the
same parameters mapped through the weight bridge (models/..., weights.py).

The JAX oracle is the package's plain path: warp_impl 'xla' and red_impl
'flax' (on the CPU its 'pallas' defaults route there too). Tolerances:
1e-4 absolute for blocks (fp32 convolutions and GroupNorms summed in
another order, on unit-scale activations); for the whole forward, depth
within 1e-3 x (depth_max - depth_min) and confidence within 1e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models.adamvs import AdaMVS as JAdaMVS
from deep3d_aerial_tpu.models.cascade import streaming_sweep as jstreaming_sweep
from deep3d_aerial_tpu.models.cost_reg import CostRegNet2D as JCostRegNet2D
from deep3d_aerial_tpu.models.cost_reg import RedStep2 as JRedStep2
from deep3d_aerial_tpu.models.feature_net import FeatureNet as JFeatureNet
from deep3d_aerial_tpu.train.checkpoint import export_params_npz, restore_params
from deep3d_aerial_tpu_torch.models.adamvs import AdaMVS
from deep3d_aerial_tpu_torch.models.cascade import streaming_sweep
from deep3d_aerial_tpu_torch.models.cost_reg import CostRegNet2D, RedStep2
from deep3d_aerial_tpu_torch.models.feature_net import FeatureNet
from deep3d_aerial_tpu_torch.weights import tree_to_state_dict, load_jax_weights
from tests.conftest import random_pose, toy_camera

torch.set_num_threads(1)

CKPT = "checkpoints/synthetic_adamvs/model_000021_1.1435"
DMIN, DMAX = 80.0, 120.0


def perturbed(params, rng, scale=0.05):
    """(keystr-flat tree, the same tree as a pytree), every leaf perturbed
    so that biases and norm offsets are non-zero."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    flat = {}
    for path, leaf in paths:
        a = np.asarray(leaf, np.float32)
        flat[jax.tree_util.keystr(path)] = a + rng.normal(
            scale=scale, size=a.shape).astype(np.float32)
    return flat, jax.tree_util.tree_unflatten(treedef, list(flat.values()))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def test_feature_net_branch():
    rng = np.random.default_rng(41)
    H, W = 32, 48
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    jmod = JFeatureNet(arch="branch")
    flat, jparams = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                                 jnp.asarray(imgs[0])), rng)
    tmod = load_jax_weights(FeatureNet(arch="branch"), flat)
    with torch.no_grad():
        touts = tmod(nchw(imgs))
    apply = jax.jit(jmod.apply)
    for v in range(2):
        jouts = apply(jparams, jnp.asarray(imgs[v]))
        for j, t in zip(jouts, touts):
            np.testing.assert_allclose(t[v].numpy(),
                                       np.moveaxis(np.asarray(j), -1, 0),
                                       rtol=0, atol=1e-4)


def test_cost_reg_net_2d():
    rng = np.random.default_rng(42)
    H, W, D = 12, 20, 16
    x = rng.normal(size=(3, H, W, D)).astype(np.float32)
    jmod = JCostRegNet2D()
    flat, jparams = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(2),
                                                 jnp.asarray(x[0])), rng)
    tmod = load_jax_weights(CostRegNet2D(D), flat)
    with torch.no_grad():
        t = tmod(nchw(x)).numpy()
    apply = jax.jit(jmod.apply)
    for v in range(3):
        j = np.asarray(apply(jparams, jnp.asarray(x[v])))
        np.testing.assert_allclose(t[v], np.moveaxis(j, -1, 0), rtol=0, atol=1e-4)


class _JSweep(fnn.Module):
    up: bool

    @fnn.compact
    def __call__(self, depths, ref, srcs, rels, weights):
        return jstreaming_sweep(
            reg=JRedStep2(up=self.up, name="red0"), cost_mode="correlation",
            up=self.up, depths=depths, ref_feat=ref, src_feats=srcs,
            rel_projs=rels, weights=weights, plane_chunk=4)


@pytest.mark.parametrize("up", [True, False])
def test_streaming_sweep(up):
    """Two chunks of 4 planes, per-pixel depths, non-uniform weights."""
    rng = np.random.default_rng(43 + up)
    H, W, C, V = 12, 16, 16, 3
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V + 1)])
    rels = stage_relative_projections(projs, 1)[0].astype(np.float32)
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    srcs = rng.normal(size=(V, H, W, C)).astype(np.float32)
    depths = np.sort(rng.uniform(85, 115, size=(8, H, W)), 0).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(V, H, W)).astype(np.float32)
    args = (depths, ref, srcs, rels, weights)
    jmod = _JSweep(up=up)
    flat, jparams = perturbed(
        jax.jit(jmod.init)(jax.random.PRNGKey(3), *map(jnp.asarray, args)), rng, 0.2)
    jd, jc = jax.jit(jmod.apply)(jparams, *map(jnp.asarray, args))

    holder = tnn.Module()
    holder.red0 = RedStep2(C, up=up)
    load_jax_weights(holder, flat)
    with torch.no_grad():
        td, tc = streaming_sweep(holder.red0, up,
                                 *(torch.from_numpy(a) for a in args),
                                 plane_chunk=4)
    assert td.shape == ((2 * H, 2 * W) if up else (H, W))
    # depth: 1e-3 x the 30 m hypothesis spread; confidence 1e-4
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=3e-2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the in-repo trained checkpoint: bridge and whole forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_npz(tmp_path_factory):
    params = restore_params(CKPT)
    return export_params_npz(params, str(tmp_path_factory.mktemp("w") / "w.npz"))


def _trained_model(**kw):
    return AdaMVS(ndepths=(16, 8, 8), num_depth=64, **kw)


def test_bridge_loads_every_leaf(ckpt_npz):
    model = _trained_model()
    with np.load(ckpt_npz) as data:
        flat = {k: data[k] for k in data.files}
    sd = tree_to_state_dict(model, flat)
    own = dict(model.named_parameters())
    assert len(flat) == len(own) == len(sd)
    assert all(tuple(sd[k].shape) == tuple(p.shape) for k, p in own.items())

    k0 = next(iter(flat))
    with pytest.raises(ValueError, match="missing"):
        tree_to_state_dict(model, {k: v for k, v in flat.items() if k != k0})
    with pytest.raises(ValueError, match="left over"):
        tree_to_state_dict(model, {**flat, "['params']['extra']['kernel']":
                                   np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        tree_to_state_dict(model, {**flat, k0: np.zeros((1, 2), np.float32)})
    with pytest.raises(ValueError, match="export_params_npz"):
        load_jax_weights(model, CKPT)


def test_adamvs_forward_trained_checkpoint(ckpt_npz):
    rng = np.random.default_rng(44)
    V, H, W = 3, 48, 64
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)

    params = restore_params(ckpt_npz)
    jmod = JAdaMVS(ndepths=(16, 8, 8), num_depth=64, warp_impl="xla",
                   red_impl="flax")
    jout = jax.jit(jmod.apply)(params, jnp.asarray(imgs), jnp.asarray(rel),
                               DMIN, DMAX)
    tmod = load_jax_weights(_trained_model(), ckpt_npz).eval()
    with torch.no_grad():
        tout = tmod(torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)

    depth_tol = 1e-3 * (DMAX - DMIN)
    for s in ("stage1", "stage2", "stage3"):
        np.testing.assert_allclose(tout[s]["depth"].numpy(),
                                   np.asarray(jout[s]["depth"]),
                                   rtol=0, atol=depth_tol)
        np.testing.assert_allclose(tout[s]["photometric_confidence"].numpy(),
                                   np.asarray(jout[s]["photometric_confidence"]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout["stage1"]["pair_results"].numpy(),
                               np.asarray(jout["stage1"]["pair_results"]),
                               rtol=0, atol=depth_tol)
    np.testing.assert_allclose(tout["stage1"]["pair_confidence"].numpy(),
                               np.asarray(jout["stage1"]["pair_confidence"]),
                               rtol=0, atol=1e-4)
    assert tout["depth"].shape == (H, W)
    assert set(tout) == set(jout)
