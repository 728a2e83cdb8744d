"""The compensated warp (DENSEMATCH.warp_precision 'compensated'): the
port's double-single projection chain (ops/warp.py) and every plain sweep
and model forward that takes it, against the JAX package's
`sweep_coordinates(highp=True)` path, on the CPU.

The JAX side turns its chain on through its process-global
`set_high_precision_warp(True)`, which a jitted function reads when it is
traced: the `highp` fixture sets it, clears JAX's caches on the way in and
out, and always restores False (pytest-xdist runs other files in the same
worker process).

Tolerances. The coordinates: 1e-5 px of the JAX chain (both are the same
float32 operations, each rounded once; they read equal here), and within
2e-3 px of a float64 oracle on the chain's own float32 inputs and at least
10x closer than the float32 chain, as tests/test_warp.py holds the JAX
chain. The plain sweeps: 1e-5 absolute, as tests/test_torch_sweep.py
holds their float32 projection. The whole forwards: depth within 1e-3 x
the depth range and confidence within 1e-4, as the float32 forwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models.adamvs import AdaMVS as JAdaMVS
from deep3d_aerial_tpu.models.adamvs import pair_corr_volumes
from deep3d_aerial_tpu.models.cascade import correlation_cost_plane, variance_cost_plane
from deep3d_aerial_tpu.models.casmvsnet import CasMVSNet as JCasMVSNet
from deep3d_aerial_tpu.ops import warp as jwarp
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models import adamvs, cascade
from deep3d_aerial_tpu_torch.ops import sweep
from deep3d_aerial_tpu_torch.ops.warp import sweep_coordinates
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
)
from tests.conftest import random_pose, toy_camera
from tests.test_torch_train_step import nest

torch.set_num_threads(1)

DMIN, DMAX = 80.0, 120.0

# tests/test_warp.py's deep scene: |ray| ~ 4e4, large depths, and a
# translation that cancels ray * d back into the image
EXTREME_REL = np.float32(np.array([
    [1.0002, 3e-4, -40000.0, 2.1735e9],
    [-2.1e-4, 0.9998, -35000.0, 1.9020e9],
    [1.5e-6, -2.5e-6, 1.0001, 12.5],
    [0, 0, 0, 1.0],
]))


@pytest.fixture
def highp():
    """The JAX package's compensated chain on, for this test only."""
    jax.clear_caches()
    jwarp.set_high_precision_warp(True)
    try:
        yield
    finally:
        jwarp.set_high_precision_warp(False)
        jax.clear_caches()


def _geometry(rng, V, H, W):
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng, dist=100.0))
                      for _ in range(V)])
    return stage_relative_projections(projs, 1)[0].astype(np.float32)  # [V-1,4,4]


def _extreme():
    H, W = 16, 128
    return EXTREME_REL, np.full((1, H, W), 54321.75, np.float32), (H, W)


def _bench():
    """A bench-like view pair: per-pixel planes around 100 m."""
    rng = np.random.default_rng(31)
    H, W = 24, 40
    rel = _geometry(rng, 2, H, W)[0]
    return rel, rng.uniform(85, 115, size=(5, H, W)).astype(np.float32), (H, W)


@pytest.mark.parametrize("geometry", [_extreme, _bench], ids=["extreme", "bench"])
def test_chain_matches_jax_highp(geometry):
    rel, depths, hw = geometry()
    for comp in (True, False):
        jx = jwarp.sweep_coordinates(jnp.asarray(rel), jnp.asarray(depths), hw,
                                     highp=comp)
        tx = sweep_coordinates(torch.from_numpy(rel), torch.from_numpy(depths), hw,
                               compensated=comp)
        for a, b in zip(tx, jx):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_chain_against_float64():
    """Within 2e-3 px of float64 at the deep scene, and at least 10x closer
    than the float32 chain (which drifts ~4e-3 px there)."""
    rel, depths, (H, W) = _extreme()
    r64 = rel.astype(np.float64)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    ray = np.stack([gx, gy, np.ones_like(gx)], -1) @ r64[:3, :3].T
    p = ray * depths[0][..., None] + r64[:3, 3]
    x64, y64 = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    errs = {}
    for comp in (False, True):
        x, y, _ = sweep_coordinates(torch.from_numpy(rel), torch.from_numpy(depths),
                                    (H, W), compensated=comp)
        errs[comp] = max(np.abs(x[0].numpy() - x64).max(), np.abs(y[0].numpy() - y64).max())
    assert errs[True] < 2e-3, errs
    assert errs[True] < errs[False] / 10, errs


def test_compensated_guards_behind_and_degenerate_z():
    """A point behind the source camera samples nothing (-1e9), and z = 0
    takes the safe divisor, as in the JAX chain."""
    rel = np.eye(4, dtype=np.float32)
    rel[2, :3] = [0.0, 0.0, -1.0]  # z = -d: behind
    rel[2, 3] = 0.0
    d = np.array([1.0, 0.0], np.float32)
    for comp in (False, True):
        t = sweep_coordinates(torch.from_numpy(rel), torch.from_numpy(d), (2, 3), comp)
        j = jwarp.sweep_coordinates(jnp.asarray(rel), jnp.asarray(d), (2, 3), highp=comp)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (t[0] == -1e9).all()


@pytest.mark.parametrize("C,H,W,V1", [(32, 13, 19, 2), (8, 12, 17, 3)])
def test_plain_sweeps_compensated_match_jax(highp, C, H, W, V1):
    """K1, K2 and K2v's plain versions in the compensated projection against
    the JAX gather oracles (pair_corr_volumes, correlation_cost_plane,
    variance_cost_plane) under the JAX chain; the CPU wrappers take the same
    plain versions."""
    rng = np.random.default_rng(40 + C)
    rels = _geometry(rng, V1 + 1, H, W)
    f = rng.normal(size=(V1 + 1, H, W, C)).astype(np.float32)
    ref, srcs = f[0], f[1:]
    depths = rng.uniform(85, 115, size=(5, H, W)).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, size=(V1, H, W)).astype(np.float32)
    d1 = np.linspace(85, 115, 7).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(f=f, ref=ref, srcs=srcs, rels=rels, d=depths, w=weights, d1=d1).items()}

    j1 = pair_corr_volumes(jnp.asarray(f), jnp.asarray(rels), jnp.asarray(d1),
                           warp_impl="xla")
    p1 = adamvs.pair_corr_volumes(t["f"], t["rels"], t["d1"], compensated=True)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=0, atol=1e-5)

    j2 = jax.vmap(lambda d: correlation_cost_plane(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(rels), d,
        jnp.asarray(weights)))(jnp.asarray(depths))
    p2 = sweep.sweep_cost_plain(t["ref"], t["srcs"], t["rels"], t["d"], t["w"],
                                compensated=True)
    np.testing.assert_allclose(p2.numpy(), np.transpose(np.asarray(j2), (0, 3, 1, 2)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        sweep.sweep_cost(t["ref"], t["srcs"], t["rels"], t["d"], t["w"],
                         compensated=True).numpy(), p2.numpy())

    j3 = jax.vmap(lambda d: variance_cost_plane(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(rels), d))(jnp.asarray(depths))
    p3 = sweep.sweep_var_plain(t["ref"], t["srcs"], t["rels"], t["d"], compensated=True)
    np.testing.assert_allclose(p3.numpy(), np.transpose(np.asarray(j3), (0, 3, 1, 2)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        sweep.sweep_var(t["ref"], t["srcs"], t["rels"], t["d"], compensated=True).numpy(),
        p3.numpy())
    np.testing.assert_array_equal(
        cascade.variance_cost_plane(t["ref"], t["srcs"], t["rels"], t["d"][2],
                                    compensated=True).numpy(),
        p3[2].permute(1, 2, 0).numpy())


def test_compensated_sweep_at_the_deep_scene_differs_from_float32():
    """At the deep scene the two projections sample different positions:
    the mode reaches the sweeps' output."""
    rel, depths, (H, W) = _extreme()
    rng = np.random.default_rng(3)
    ref = torch.from_numpy(rng.normal(size=(H, W, 8)).astype(np.float32))
    src = torch.from_numpy(rng.normal(size=(1, H, W, 8)).astype(np.float32))
    rels, d = torch.from_numpy(rel)[None], torch.from_numpy(depths)
    a = sweep.sweep_var_plain(ref, src, rels, d)
    b = sweep.sweep_var_plain(ref, src, rels, d, compensated=True)
    assert float((a - b).abs().max()) > 1e-4


def _inputs(seed, V, H, W):
    rng = np.random.default_rng(seed)
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    return rng, imgs, rel


@pytest.mark.parametrize("name,jcls,kw,jkw", [
    ("adamvs", JAdaMVS, dict(ndepths=(8, 8, 4), num_depth=32, plane_chunk=2),
     dict(red_impl="flax", plane_chunk=2)),
    ("casmvsnet", JCasMVSNet, dict(ndepths=(8, 8, 8), num_depth=32), {}),
])
def test_forward_compensated_matches_jax(highp, name, jcls, kw, jkw):
    """The whole forward with warp_precision 'compensated' against the JAX
    forward under its chain (seeded weights from the port's initializer,
    perturbed), 32x64, 3 views."""
    H, W = 32, 64
    rng, imgs, rel = _inputs(61 + len(name), 3, H, W)
    tree = state_dict_to_tree(init_random_weights(build_model(name, **kw), seed=7))
    flat = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}
    jkw = {k: v for k, v in kw.items() if k != "plane_chunk"} | jkw
    jmod = jcls(warp_impl="xla", **jkw)
    jout = jax.jit(jmod.apply)({"params": nest(flat)["params"]}, jnp.asarray(imgs),
                               jnp.asarray(rel), DMIN, DMAX)
    args = (torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    outs = {}
    for prec in ("compensated", "float32"):
        m = load_jax_weights(build_model(name, warp_precision=prec, **kw), flat).eval()
        with torch.no_grad():
            outs[prec] = m(*args)
    tout = outs["compensated"]
    for s in ("stage1", "stage2", "stage3"):
        for key, tol in (("depth", 1e-3 * (DMAX - DMIN)), ("photometric_confidence", 1e-4)):
            diff = float(np.abs(tout[s][key].numpy() - np.asarray(jout[s][key])).max())
            assert diff <= tol, (name, s, key, diff)
    if name == "adamvs":
        np.testing.assert_allclose(tout["stage1"]["pair_results"].numpy(),
                                   np.asarray(jout["stage1"]["pair_results"]),
                                   rtol=0, atol=1e-3 * (DMAX - DMIN))
    # the argument reaches the sweeps: the two projections round apart
    assert any(not torch.equal(tout[s]["depth"], outs["float32"][s]["depth"])
               for s in ("stage1", "stage2", "stage3"))


def test_unknown_warp_precision_raises():
    for name in ("adamvs", "msrednet", "casmvsnet", "ucsnet"):
        with pytest.raises(ValueError, match="compensated"):
            build_model(name, warp_precision="float64")


def test_compensated_cuda_tensor_goes_to_the_compensated_launch(monkeypatch):
    """A CUDA tensor with compensated=True reaches the compensated C entry
    of its dtype (never the plain version); the entry is refused here, so
    no launch is counted."""
    import contextlib

    from deep3d_aerial_tpu_torch.ops import cuda_build

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    asked = []

    class Lib:
        def __getattr__(self, name):
            asked.append(name)
            raise RuntimeError(f"entry {name}")

    monkeypatch.setattr(cuda_build, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())

    def fake(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype).as_subclass(FakeCuda)

    d, rel, w = fake(2, 4, 4), fake(1, 4, 4) + torch.eye(4), fake(1, 4, 4) + 1
    for fn, extra in ((sweep.sweep_corr, ()), (sweep.sweep_cost, (w,)),
                      (sweep.sweep_var, ())):
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(RuntimeError, match="entry"):
                fn(fake(4, 4, 8, dtype=dt), fake(1, 4, 4, 8, dtype=dt), rel, d, *extra,
                   compensated=True)
    assert asked == ["sweep_corr_f32_comp", "sweep_corr_bf16_comp",
                     "sweep_cost_f32_comp", "sweep_cost_bf16_comp",
                     "sweep_var_f32_comp", "sweep_var_bf16_comp"]
    for fn in (sweep.sweep_corr, sweep.sweep_cost, sweep.sweep_var):
        assert fn.launches == fn.launches_compensated == 0


def test_pipeline_builds_the_model_with_its_warp_precision(tmp_path):
    """The pipeline's model takes the config's warp_precision (the refusal
    of 'compensated' is gone)."""
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    for prec in ("compensated", "float32"):
        cfg = PipelineConfig(warp_precision=prec, allow_random_weights=True,
                             ndepths=[8, 8, 4], num_depth=32)
        model = AerialPipeline(str(tmp_path), cfg, device="cpu").build_model()
        assert model.compensated == (prec == "compensated")
