"""The port's plain ops against the JAX package's, on the CPU.

Inputs come from numpy.random.default_rng and go to both sides as the same
arrays. Tolerances: the geometry chain is the same fp32 elementwise sequence
on both sides, so coordinates agree to a few ulp of their magnitude (~1e-5
relative); sampled features and resizes are fp32 lerps (1e-5 absolute on
unit-scale data).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.ops import depth_samplers as jds
from deep3d_aerial_tpu.ops import resize as jresize
from deep3d_aerial_tpu.ops import warp as jwarp
from deep3d_aerial_tpu_torch.ops import depth_samplers as tds
from deep3d_aerial_tpu_torch.ops import resize as tresize
from deep3d_aerial_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)


def _rel(rng, behind=False):
    """A plausible src_P @ inv(ref_P): near-identity rotation, pixel-scale
    translation. `behind` flips the z row so that some points land behind
    the source camera."""
    rel = np.eye(4, dtype=np.float32)
    rel[:3, :3] += rng.normal(scale=0.02, size=(3, 3)).astype(np.float32)
    rel[:3, 3] = rng.normal(scale=[300.0, 300.0, 0.5]).astype(np.float32)
    if behind:
        rel[2, :3] = [0.001, 0.0, -1.0]
        rel[2, 3] = 100.0
    return rel


@pytest.mark.parametrize("behind", [False, True])
def test_sweep_coordinates(behind):
    rng = np.random.default_rng(11)
    H, W = 13, 21
    rel = _rel(rng, behind)
    depths = rng.uniform(80, 120, size=(3, H, W)).astype(np.float32)
    jx, jy, jz = jwarp.sweep_coordinates(jnp.asarray(rel), jnp.asarray(depths),
                                         (H, W), highp=False)
    tx, ty, tz = twarp.sweep_coordinates(torch.from_numpy(rel),
                                         torch.from_numpy(depths), (H, W))
    if behind:
        assert (np.asarray(jz) <= 1e-6).any() and (np.asarray(jz) > 1e-6).any()
    for j, t in ((jx, tx), (jy, ty), (jz, tz)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-3)


def test_sweep_coordinates_shared_planes():
    rng = np.random.default_rng(12)
    rel = _rel(rng)
    depths = np.linspace(80, 120, 5, dtype=np.float32)
    j = jwarp.sweep_coordinates(jnp.asarray(rel), jnp.asarray(depths), (7, 9),
                                highp=False)
    t = twarp.sweep_coordinates(torch.from_numpy(rel),
                                torch.from_numpy(depths), (7, 9))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-3)


def test_bilinear_sample_out_of_bounds_and_behind():
    rng = np.random.default_rng(13)
    H, W, C = 9, 14, 8
    src = rng.normal(size=(H, W, C)).astype(np.float32)
    # in-image, straddling every border, far outside, and the -1e9
    # behind-camera sentinel
    x = rng.uniform(-2.5, W + 1.5, size=(40,)).astype(np.float32)
    y = rng.uniform(-2.5, H + 1.5, size=(40,)).astype(np.float32)
    x[:4] = [-1e9, -0.5, W - 0.5, 3e7]
    y[:4] = [-1e9, H - 0.5, -0.5, 2.0]
    j = jwarp.bilinear_sample(jnp.asarray(src), jnp.asarray(x), jnp.asarray(y))
    t = twarp.bilinear_sample(torch.from_numpy(src), torch.from_numpy(x),
                              torch.from_numpy(y))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    assert np.all(t.numpy()[0] == 0) and np.all(t.numpy()[3] == 0)


def test_plane_sweep_warp_single():
    rng = np.random.default_rng(14)
    H, W, C = 12, 17, 16
    src = rng.normal(size=(H, W, C)).astype(np.float32)
    rel = np.eye(4, dtype=np.float32)
    rel[:3, :3] += rng.normal(scale=0.01, size=(3, 3)).astype(np.float32)
    rel[:2, 3] = [60.0, -40.0]
    d = rng.uniform(90, 110, size=(H, W)).astype(np.float32)
    j = jwarp.plane_sweep_warp_single(jnp.asarray(src), jnp.asarray(rel),
                                      jnp.asarray(d), highp=False)
    t = twarp.plane_sweep_warp_single(torch.from_numpy(src),
                                      torch.from_numpy(rel), torch.from_numpy(d))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("nd", [1, 8, 48])
def test_uniform_depth_samples(nd):
    j = jds.uniform_depth_samples(425.3, 612.9, nd)
    t = tds.uniform_depth_samples(425.3, 612.9, nd)
    # fp32 linspace: same formula, bit-for-bit is the target; 1 ulp allowed
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-7, atol=0)


def test_window_depth_samples():
    rng = np.random.default_rng(15)
    center = rng.uniform(90, 110, size=(6, 10)).astype(np.float32)
    j = jds.window_depth_samples(jnp.asarray(center), 8, 0.53)
    t = tds.window_depth_samples(torch.from_numpy(center), 8, 0.53)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((6, 10), (6, 10)), ((6, 10), (12, 20)), ((6, 10), (24, 40)),
    ((5, 7), (12, 17)),
])
def test_resize_bilinear(src_hw, dst_hw):
    rng = np.random.default_rng(16)
    x = rng.normal(size=(3, *src_hw)).astype(np.float32)
    j = jds.resize_bilinear(jnp.asarray(x), dst_hw)
    t = tds.resize_bilinear(torch.from_numpy(x), dst_hw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("p,axis", [(2, 0), (2, -1), (4, 1), (8, -2)])
def test_upsample_axis_lerp(p, axis):
    rng = np.random.default_rng(17)
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    j = jresize.upsample_axis_lerp(jnp.asarray(x), p, axis)
    t = tresize.upsample_axis_lerp(torch.from_numpy(x), p, axis)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
