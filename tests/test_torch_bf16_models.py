"""The whole bfloat16 forward of each model against the JAX package's, on
the CPU: AdaMVS on the in-repo trained checkpoint (48x64, 3 views, ndepths
16/8/8, the inputs of test_torch_models.py's trained-checkpoint test),
MSREDNet, CasMVSNet and UCSNet on seeded, perturbed weights (64x64, 3
views, 8 planes a stage). JAX's recurrent sweeps run one plane a scan step
(plane_chunk 1: the same planes in the same order, and the fewest
operations to trace and compile).

The JAX oracle: the models with dtype=jnp.bfloat16, warp_impl 'xla' and
red_impl 'flax' (the seeded weights are the port's initializer's, handed
to JAX through weights.state_dict_to_tree and perturbed). Tolerance, per
stage: with P the port's bfloat16 output and J and F the JAX package's
bfloat16 and float32 outputs on the same inputs and weights,
max|P - J| <= 2 x max|J - F| for depth, and the same plus 2 bfloat16 ulps
of max|J| for the confidence (a sum of bfloat16 probabilities; one ulp of
M: 2^(floor(log2 M) - 7)): the two bfloat16 results are no further apart
than twice what bfloat16 moves the JAX package's own float32 result. The
port's own bfloat16-vs-float32 distance is in no bound. Readings on the
CPU (the largest max|P - J| over its bound, of the six outputs): AdaMVS
0.50 (stage 3 depth), MSREDNet 0.54 (stage 1 depth), CasMVSNet 0.55
(stage 2 depth), UCSNet 0.56 (stage 3 confidence); without the
confidence's 2 ulps AdaMVS's stage 2 confidence reads 0.63. Depth and
confidence come out float32 on both sides; the port's float32 forward is
held to JAX's at 1e-3 x the depth range in tests/test_torch_models.py and
the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models.adamvs import AdaMVS as JAdaMVS
from deep3d_aerial_tpu.models.casmvsnet import CasMVSNet as JCasMVSNet
from deep3d_aerial_tpu.models.msrednet import MSREDNet as JMSREDNet
from deep3d_aerial_tpu.models.ucsnet import UCSNet as JUCSNet
from deep3d_aerial_tpu.train.checkpoint import restore_params
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
)
from tests.conftest import random_pose, toy_camera
from tests.test_torch_bf16_blocks import bf16_ulps
from tests.test_torch_models import CKPT, DMAX, DMIN
from tests.test_torch_train_step import nest

torch.set_num_threads(1)


def _inputs(seed, V, H, W):
    rng = np.random.default_rng(seed)
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    return rng, imgs, rel


def _check(tout, j16, j32, H, W):
    for s in ("stage1", "stage2", "stage3"):
        for key in ("depth", "photometric_confidence"):
            p = tout[s][key]
            assert p.dtype == torch.float32 and torch.isfinite(p).all(), (s, key)
            jb, jf = np.asarray(j16[s][key], np.float32), np.asarray(j32[s][key])
            gap = float(np.abs(jb - jf).max())
            floor = bf16_ulps(float(np.abs(jb).max())) if key != "depth" else 0.0
            diff = float(np.abs(p.numpy() - jb).max())
            assert diff <= 2 * gap + floor, (
                f"{s} {key}: port vs JAX bf16 {diff:.4g} > 2 x JAX's own bf16-vs-f32 "
                f"gap {gap:.4g} + {floor:.4g}")
    assert tout["depth"].shape == (H, W)


def _port(name, flat, imgs, rel, **kw):
    """The port's bfloat16 forward on `flat`'s weights (float32 parameters)."""
    m = load_jax_weights(build_model(name, dtype=torch.bfloat16, **kw), flat).eval()
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        return m(torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)


def test_adamvs_bf16_forward_trained_checkpoint():
    _, imgs, rel = _inputs(44, 3, 48, 64)
    params = restore_params(CKPT)
    args = (jnp.asarray(imgs), jnp.asarray(rel), DMIN, DMAX)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jmod = JAdaMVS(ndepths=(16, 8, 8), num_depth=64, dtype=dt,
                       warp_impl="xla", red_impl="flax", plane_chunk=1)
        outs[dt] = jax.jit(jmod.apply)(params, *args)
    flat = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    t16 = _port("adamvs", flat, imgs, rel, ndepths=(16, 8, 8), num_depth=64)
    _check(t16, outs[jnp.bfloat16], outs[jnp.float32], 48, 64)


@pytest.mark.parametrize("name,jcls", [("msrednet", JMSREDNet),
                                       ("casmvsnet", JCasMVSNet),
                                       ("ucsnet", JUCSNet)])
def test_bf16_forward_seeded_weights(name, jcls):
    H = W = 64
    rng, imgs, rel = _inputs(300 + len(name), 3, H, W)
    nd = (8, 8, 8)
    # plane_chunk 1: the scan body is one recurrent step, not 8
    extra = {"red_impl": "flax", "plane_chunk": 1} if name == "msrednet" else {}
    args = (jnp.asarray(imgs), jnp.asarray(rel), DMIN, DMAX)
    tree = state_dict_to_tree(init_random_weights(
        build_model(name, ndepths=nd, num_depth=64), seed=5))
    flat = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}
    jp = nest(flat)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jmod = jcls(ndepths=nd, num_depth=64, warp_impl="xla", dtype=dt, **extra)
        outs[dt] = jax.jit(jmod.apply)({"params": jp["params"]}, *args)
    t16 = _port(name, flat, imgs, rel, ndepths=nd, num_depth=64)
    _check(t16, outs[jnp.bfloat16], outs[jnp.float32], H, W)
