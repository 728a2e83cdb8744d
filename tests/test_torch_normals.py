"""The port's normals path against the JAX package's, on the CPU: the op
(`ops/normals.py:normals_from_depth` against `deep3d_aerial_tpu.ops.normals`)
and the pipeline's clean-up of a depth map before its normals are taken
(`pipeline/orchestrator.py:zero_non_finite`), held against the JAX
pipeline's order: non-finite depth (and its confidence) zeroed with
np.where, then the JAX normals_from_depth. Tolerance 1e-5 on unit normals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.ops.normals import normals_from_depth as jnormals_from_depth
from deep3d_aerial_tpu_torch.ops.normals import normals_from_depth
from deep3d_aerial_tpu_torch.pipeline.orchestrator import zero_non_finite

K = np.array([[70.0, 0.0, 26.5], [0.0, 72.0, 18.0], [0.0, 0.0, 1.0]])
K_INV = np.linalg.inv(K).astype(np.float32)


def _depth(rng, H=37, W=53):
    """A tilted, wavy surface at ~100 m with a few invalid (0) pixels."""
    y, x = np.mgrid[0:H, 0:W]
    d = 100.0 + 0.2 * x - 0.1 * y + np.sin(0.3 * x) * np.cos(0.2 * y)
    d = d + rng.normal(scale=0.05, size=d.shape)
    d[rng.random(d.shape) < 0.03] = 0.0
    return d.astype(np.float32)


def test_normals_from_depth_matches_the_jax_package():
    depth = _depth(np.random.default_rng(300))
    want = np.asarray(jnormals_from_depth(jnp.asarray(depth), jnp.asarray(K_INV)))
    got = normals_from_depth(torch.from_numpy(depth), torch.from_numpy(K_INV)).numpy()
    assert got.shape == (37, 53, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[depth == 0], [[0.0, 0.0, -1.0]] * int((depth == 0).sum()))


def _jax_order(depth, conf):
    """deep3d_aerial_tpu/pipeline/orchestrator.py: zero the non-finite
    depth pixels (and their confidence, and every non-finite confidence),
    then take the normals."""
    if not np.isfinite(depth).all():
        bad = ~np.isfinite(depth)
        depth = np.where(bad, 0.0, depth)
        conf = np.where(bad | ~np.isfinite(conf), 0.0, conf)
    normals = np.asarray(jnormals_from_depth(jnp.asarray(depth, jnp.float32),
                                             jnp.asarray(K_INV)))
    return depth, conf, normals


@pytest.mark.parametrize("bad", [
    {(3, 4): np.inf, (5, 2): np.nan, (0, 7): -np.inf},
    {},
])
def test_non_finite_depth_is_zeroed_before_the_normals(bad):
    """An 8x8 map with a +inf, a NaN and a -inf pixel (or none): the port's
    depth, confidence and normals equal the JAX order's. A NaN confidence
    is zeroed only where the map has a non-finite depth, as in the JAX
    pipeline."""
    rng = np.random.default_rng(310)
    depth = (100.0 + rng.normal(scale=0.3, size=(8, 8))).astype(np.float32)
    conf = rng.random((8, 8)).astype(np.float32)
    conf[6, 6] = np.nan
    for px, v in bad.items():
        depth[px] = v
    jd, jc, jn = _jax_order(depth, conf)
    td, tc, n_bad = zero_non_finite(torch.from_numpy(depth), torch.from_numpy(conf))
    tn = normals_from_depth(td, torch.from_numpy(K_INV)).numpy()
    assert n_bad == len(bad)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5)
    assert np.isfinite(tn).all()
    if bad:
        # what the port did before: nan_to_num makes +inf a huge valid
        # depth, which turns the normals of its neighbours
        old = normals_from_depth(torch.nan_to_num(torch.from_numpy(depth), nan=0.0),
                                 torch.from_numpy(K_INV)).numpy()
        assert not np.allclose(old[2:5, 3:6], jn[2:5, 3:6], atol=1e-2)
