"""Plain versions of the sweep kernels K1 (pair correlation volumes), K2
(weighted correlation cost) and K2v (variance cost) against the JAX
package's gather oracles, on the CPU, with real camera geometry from the
JAX package's own helpers.

Tolerance 1e-5 absolute: the same fp32 elementwise coordinate chain and
bilinear taps on both sides; features are unit-scale, so the remaining
difference is the summation order over channels and views.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models.adamvs import pair_corr_volumes
from deep3d_aerial_tpu.models.cascade import (
    correlation_cost_plane,
    variance_cost_plane,
)
from deep3d_aerial_tpu.ops.pallas_sweep import sweep_corr_chunk_reference
from deep3d_aerial_tpu_torch.models import adamvs, cascade
from deep3d_aerial_tpu_torch.ops.sweep import (
    sweep_corr,
    sweep_cost,
    sweep_cost_plain,
    sweep_corr_plain,
    sweep_var,
    sweep_var_plain,
)
from tests.conftest import random_pose, toy_camera

torch.set_num_threads(1)


def _geometry(rng, V, H, W):
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng, dist=100.0))
                      for _ in range(V)])
    return stage_relative_projections(projs, 1)[0].astype(np.float32)  # [V-1,4,4]


@pytest.mark.parametrize("C,H,W", [(32, 16, 20), (8, 13, 19)])
def test_sweep_corr_plain_matches_reference(C, H, W):
    rng = np.random.default_rng(21)
    rel = _geometry(rng, 2, H, W)[0]
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    src = rng.normal(size=(H, W, C)).astype(np.float32)
    depths = rng.uniform(85, 115, size=(8, H, W)).astype(np.float32)
    j = sweep_corr_chunk_reference(jnp.asarray(ref), jnp.asarray(src),
                                   jnp.asarray(rel), jnp.asarray(depths))
    args = [torch.from_numpy(a) for a in (ref, src[None], rel[None], depths)]
    t = sweep_corr_plain(*args)
    assert t.shape == (1, 8, H, W)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(sweep_corr(*args).numpy(), t.numpy())


@pytest.mark.parametrize("V1", [2, 4])
@pytest.mark.parametrize("C,H,W", [(8, 13, 19), (32, 15, 17)])
def test_sweep_corr_plain_matches_pair_corr_volumes(V1, C, H, W):
    """All source views' volumes at once against the JAX pair branch's
    volume build (its XLA gather formulation), with D = 7 uniform planes
    (not a multiple of the 8-plane steps of either side)."""
    rng = np.random.default_rng(24 + V1 + C)
    rels = _geometry(rng, V1 + 1, H, W)
    f1 = rng.normal(size=(V1 + 1, H, W, C)).astype(np.float32)
    depths1 = np.linspace(85, 115, 7).astype(np.float32)
    j = pair_corr_volumes(jnp.asarray(f1), jnp.asarray(rels),
                          jnp.asarray(depths1), warp_impl="xla")
    t = adamvs.pair_corr_volumes(torch.from_numpy(f1), torch.from_numpy(rels),
                                 torch.from_numpy(depths1))
    assert t.shape == (V1, 7, H, W)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("C,H,W,V", [(16, 15, 22, 4), (8, 12, 17, 3)])
def test_sweep_cost_plain_matches_correlation_cost_plane(C, H, W, V):
    """Per-pixel depth planes, non-uniform view weights, H and W that are
    not multiples of any tile."""
    rng = np.random.default_rng(22)
    rels = _geometry(rng, V + 1, H, W)
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    srcs = rng.normal(size=(V, H, W, C)).astype(np.float32)
    depths = rng.uniform(85, 115, size=(6, H, W)).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, size=(V, H, W)).astype(np.float32)
    j = jax.vmap(lambda d: correlation_cost_plane(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(rels), d,
        jnp.asarray(weights)))(jnp.asarray(depths))  # [K, H, W, C]
    args = [torch.from_numpy(a) for a in (ref, srcs, rels, depths, weights)]
    t = sweep_cost_plain(*args)
    assert t.shape == (6, C, H, W)
    np.testing.assert_allclose(t.numpy(), np.transpose(np.asarray(j), (0, 3, 1, 2)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(sweep_cost(*args).numpy(), t.numpy())


@pytest.mark.parametrize("C,H,W,V", [(32, 12, 20, 4), (8, 13, 19, 2)])
def test_sweep_var_plain_matches_variance_cost_plane(C, H, W, V):
    """Per-pixel depth planes; one source view sees part of the planes from
    behind its camera (those taps sample nothing)."""
    rng = np.random.default_rng(23)
    rels = _geometry(rng, V + 1, H, W)
    rels[-1, 2, :3] = [0.002, 0.0, -1.0]
    rels[-1, 2, 3] = 100.0
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    srcs = rng.normal(size=(V, H, W, C)).astype(np.float32)
    depths = rng.uniform(85, 115, size=(5, H, W)).astype(np.float32)
    j = jax.vmap(lambda d: variance_cost_plane(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(rels), d))(
        jnp.asarray(depths))  # [K, H, W, C]
    args = [torch.from_numpy(a) for a in (ref, srcs, rels, depths)]
    t = sweep_var_plain(*args)
    assert t.shape == (5, C, H, W)
    np.testing.assert_allclose(t.numpy(), np.transpose(np.asarray(j), (0, 3, 1, 2)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(sweep_var(*args).numpy(), t.numpy())
    # the cascade's one-plane form
    np.testing.assert_array_equal(
        cascade.variance_cost_plane(*args[:3], args[3][2]).numpy(),
        t[2].permute(1, 2, 0).numpy())
