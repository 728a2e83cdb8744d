"""Plain versions of the sweep kernels K1 (pair correlation) and K2
(weighted correlation cost) against the JAX package's gather oracles, on
the CPU, with real camera geometry from the JAX package's own helpers.

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
from deep3d_aerial_tpu.models.cascade import correlation_cost_plane
from deep3d_aerial_tpu.ops.pallas_sweep import sweep_corr_chunk_reference
from deep3d_aerial_tpu_torch.ops.sweep import (
    sweep_corr,
    sweep_cost,
    sweep_cost_plain,
    sweep_corr_plain,
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
    t = sweep_corr_plain(*(torch.from_numpy(a) for a in (ref, src, rel, depths)))
    assert t.shape == (8, H, W)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    w = sweep_corr(*(torch.from_numpy(a) for a in (ref, src, rel, depths)))
    np.testing.assert_array_equal(w.numpy(), t.numpy())


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
