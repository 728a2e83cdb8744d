"""The port's photometric refine (PyTorch autograd, device="cpu") against
the JAX package's `photometric_refine` (jax.grad under jit, CPU).

Tolerance: 1e-5 x the mesh's mean edge on every vertex after the run.
Both sides take the same float32 steps; what differs is the order of the
scatter-adds and sums (segment_sum vs index_add, vmap vs a batched view
axis), a few ulps a step, which the step's normalisation by the largest
normal gradient keeps from growing.

The JAX function pads its mesh to jit buckets of 64, 128, 192, 320, ...
vertices and points the padding edges at vertex n-1. When the real count
is itself a bucket size, n-1 is a real vertex, which then takes every
padding edge into its Laplacian. So the JAX side is held against only
where it is right: at counts that are not bucket sizes, and at a bucket
size through one inert extra vertex (in no face, outside every view),
which moves the mesh into the next bucket without changing the normalised
step. `test_jax_refine_is_wrong_at_a_bucket_size` records the fault.
"""

import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.mesh.refine import PhotoRefineConfig as JPhotoRefineConfig
from deep3d_aerial_tpu.mesh.refine import photometric_refine as jrefine
from deep3d_aerial_tpu_torch.mesh.refine import PhotoRefineConfig, photometric_refine

torch.set_num_threads(1)
TOL = 1e-5  # x mean edge


def grid_mesh(n, spacing=1.0, z=10.0, noise=0.0, seed=0):
    """An n x n vertex grid in the plane z (plus noise), two triangles a cell."""
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32) * spacing,
                         np.arange(n, dtype=np.float32) * spacing)
    verts = np.stack([xs.ravel() - (n - 1) * spacing / 2,
                      ys.ravel() - (n - 1) * spacing / 2,
                      np.full(n * n, z, np.float32)], -1)
    verts[:, 2] += np.random.default_rng(seed).normal(0, noise, n * n).astype(np.float32)
    i = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None]).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + n], -1),
                            np.stack([i + 1, i + n + 1, i + n], -1)]).astype(np.int32)
    return verts, faces


def views_of(shifts, f=12.0, H=48, W=64, drift=0.0):
    """Nadir cameras at the origin (plus x shifts) looking down +z at a
    smooth texture on the plane z = 10: [(grey image, K, T_cw)]. With
    `drift`, view i sees the texture moved by i x drift metres (views that
    disagree, so a flat mesh has a photo gradient)."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out = []
    for i, tx in enumerate(shifts):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = tx
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        X = (xs - K[0, 2]) / f * 10.0 - tx + i * drift
        Y = (ys - K[1, 2]) / f * 10.0
        img = (0.5 + 0.3 * np.sin(1.3 * X) * np.cos(0.9 * Y)
               + 0.2 * np.sin(0.4 * X + 1.7 * Y)).astype(np.float32)
        out.append((img, K, T))
    return out


def mean_edge(verts, faces):
    return float(np.linalg.norm(verts[faces[:, 0]] - verts[faces[:, 1]], axis=1).mean())


def both(verts, faces, views, **kw):
    t = photometric_refine(verts, faces, views, PhotoRefineConfig(**kw), device="cpu")
    j = np.asarray(jrefine(verts, faces, views, JPhotoRefineConfig(**kw)))
    return t, j


@pytest.mark.parametrize("energy", ["zncc", "variance"])
def test_refine_matches_jax_at_a_count_that_is_not_a_bucket(energy):
    verts, faces = grid_mesh(9, noise=0.1, seed=1)  # 81 vertices (bucket 128)
    views = views_of((-1.0, 0.0, 1.0))
    t, j = both(verts, faces, views, energy=energy, scales=2, iterations=3)
    assert t.shape == verts.shape and np.isfinite(t).all()
    assert np.abs(t - verts).max() > 1e-3  # it moved
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL * mean_edge(verts, faces))


@pytest.mark.parametrize("energy", ["zncc", "variance"])
def test_refine_matches_jax_at_a_bucket_size_through_an_inert_vertex(energy):
    """64 vertices: the JAX call gets the mesh plus one vertex in no face,
    far outside every view (65 real vertices, bucket 128)."""
    verts, faces = grid_mesh(8, noise=0.1, seed=2)
    views = views_of((-1.0, 0.0, 1.0))
    kw = dict(energy=energy, scales=2, iterations=3)
    t = photometric_refine(verts, faces, views, PhotoRefineConfig(**kw), device="cpu")
    extra = np.concatenate([verts, [[1e4, 1e4, -1e4]]]).astype(np.float32)
    j = np.asarray(jrefine(extra, faces, views, JPhotoRefineConfig(**kw)))
    np.testing.assert_array_equal(j[64], extra[64])
    np.testing.assert_allclose(t, j[:64], rtol=0, atol=TOL * mean_edge(verts, faces))


def test_jax_refine_is_wrong_at_a_bucket_size():
    """The fault the port does not repeat: at exactly 64 vertices the JAX
    padding edges land on vertex 63, whose Laplacian then dominates the
    step's normalisation, so vertex 63 runs off while the rest barely
    move."""
    verts, faces = grid_mesh(8, noise=0.1, seed=2)
    views = views_of((-1.0, 0.0, 1.0))
    t, j = both(verts, faces, views, scales=1, iterations=3)
    tol = TOL * mean_edge(verts, faces)
    err = np.abs(t - j).max(1)
    assert err[63] > 1e4 * tol, err[63]
    assert np.abs(j[:63] - verts[:63]).max() < 1e-2 * np.abs(t[:63] - verts[:63]).max()


@pytest.mark.parametrize("energy", ["zncc", "variance"])
def test_refine_matches_jax_where_taps_land_on_integer_pixels(energy):
    """Every vertex projects onto integer pixel coordinates in every view:
    x, y and the camera shifts are integers and each vertex's height is 5,
    10 or 20 m under a 20 px focal length. There the sampler's fraction
    clip sits on its lower bound; jnp.clip passes gradient 0.5 and so must
    the port. With torch.clamp (gradient 1) this step differs from the JAX
    one by 8.9e-3 (zncc) and 5.2e-3 (variance), against a tolerance of
    7.1e-5 (scripts/mesh_probe.py clip): the photo gradient of the vertices on ties doubles against the
    Laplacian's and against the zncc taps off the integers. One step,
    before the vertices leave the integers."""
    verts, faces = grid_mesh(9)
    verts[:, 2] = np.random.default_rng(0).choice(
        np.array([5.0, 10.0, 20.0], np.float32), len(verts))
    views = views_of((-2.0, 0.0, 2.0), f=20.0, drift=0.3)
    t, j = both(verts, faces, views, energy=energy, scales=1, iterations=1)
    assert np.abs(t - verts).max() > 0.1
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL * mean_edge(verts, faces))


def test_refine_needs_a_cuda_device_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces = grid_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        photometric_refine(verts, faces, views_of((0.0,)))
