"""Depth shards (`depth_shards` = n > 1, the JAX package's 'sp' blocks) on
one device, against the JAX package on the CPU: the divisor rule, the
exact online-softmax block merge, the streaming sweep in blocks (chunks
that span two blocks included), each model's forward at depth_shards = 2
and one CasMVSNet train step.

The JAX oracles run their plain paths (warp_impl 'xla', red_impl 'flax')
at the same depth_shards, on the port's seeded initial weights (perturbed)
handed over through weights.state_dict_to_tree. Tolerances: the merge
1e-6 relative (the same algebra in another order), the sweeps and the
forwards as their one-block tests (depth within 1e-3 x the depth range,
confidence within 1e-4), the train step as tests/test_torch_train_step.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models import build_model as jbuild_model
from deep3d_aerial_tpu.models.cascade import OnlineSoftmaxState as JOnlineSoftmaxState
from deep3d_aerial_tpu.models.cascade import split_depth_blocks as jsplit_depth_blocks
from deep3d_aerial_tpu.models.cascade import streaming_sweep as jstreaming_sweep
from deep3d_aerial_tpu.models.cost_reg import RedStep2 as JRedStep2
from deep3d_aerial_tpu.models.cost_reg import RedStep4 as JRedStep4
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models.cascade import (
    OnlineSoftmaxState,
    split_depth_blocks,
    streaming_sweep,
)
from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
from deep3d_aerial_tpu_torch.train import step as tstep
from deep3d_aerial_tpu_torch.train.optim import make_optimizer
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
    tree_to_state_dict,
)
from tests.conftest import random_pose, toy_camera
from tests.test_torch_bf16_blocks import seeded, t
from tests.test_torch_train_step import FAST_COMPILE, _batch, _grad_capture, flatten, nest

torch.set_num_threads(1)

DMIN, DMAX = 80.0, 120.0


@pytest.mark.parametrize("D,shards,n", [(12, 5, 4), (8, 2, 2), (7, 4, 1), (16, 1, 1),
                                        (6, 0, 1)])
def test_split_depth_blocks_divisor_rule(D, shards, n):
    """n is the largest divisor of D not above depth_shards, as in JAX."""
    d = np.arange(D * 2, dtype=np.float32).reshape(D, 2)
    got_n, blocks = split_depth_blocks(torch.from_numpy(d), shards)
    want_n, jblocks = jsplit_depth_blocks(jnp.asarray(d), shards)
    assert got_n == want_n == n
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))


def test_merge_axis0_equals_the_sequential_update():
    """Two blocks updated on their own and merged give the one-block
    sweep's softmax (and the JAX merge's), an empty block (m = -inf)
    included."""
    rng = np.random.default_rng(5)
    D, H, W = 16, 4, 5
    scores = torch.from_numpy(rng.normal(size=(D, H, W)).astype(np.float32))
    dv = torch.linspace(80, 120, D)[:, None, None].expand(D, H, W)
    seq = OnlineSoftmaxState.init((H, W))
    for d in range(D):
        seq = OnlineSoftmaxState.update(seq, scores[d], dv[d])
    blocks = []
    for rng_ in (range(0, 8), range(8, 16), range(0)):
        s = OnlineSoftmaxState.init((H, W))
        for d in rng_:
            s = OnlineSoftmaxState.update(s, scores[d], dv[d])
        blocks.append(s)
    stacked = tuple(torch.stack(parts) for parts in zip(*blocks))
    merged = OnlineSoftmaxState.merge_axis0(stacked)
    for a, b in zip(OnlineSoftmaxState.finalize(seq), OnlineSoftmaxState.finalize(merged)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-5)
    jmerged = JOnlineSoftmaxState.merge_axis0(tuple(jnp.asarray(x.numpy()) for x in stacked))
    for a, b in zip(merged, jmerged):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_merge_axis0_is_differentiable():
    """Out of place: autograd follows the merge (training through shards)."""
    m = torch.randn(2, 3, 3, requires_grad=True)
    s = torch.rand(2, 3, 3) + 0.5
    merged = OnlineSoftmaxState.merge_axis0((m, s, s * 100, s / 2))
    torch.autograd.grad(OnlineSoftmaxState.finalize(merged)[0].sum(), m)


class _JSweep(fnn.Module):
    mode: str
    up: bool
    shards: int
    chunk: int

    @fnn.compact
    def __call__(self, depths, ref, srcs, rels, weights):
        if self.mode == "variance":
            reg, weights = JRedStep4(name="red0"), None
        else:
            reg = JRedStep2(up=self.up, name="red0")
        return jstreaming_sweep(
            reg=reg, cost_mode=self.mode, up=self.up, depths=depths, ref_feat=ref,
            src_feats=srcs, rel_projs=rels, weights=weights, plane_chunk=self.chunk,
            depth_shards=self.shards)


@pytest.mark.parametrize("mode,up,D,shards,chunk", [
    ("correlation", True, 12, 5, 6),   # n = 4 blocks of 3, chunks of 6 span two
    ("variance", False, 8, 2, 4),      # tests/test_pallas_red4.py's blocked sweep
])
def test_streaming_sweep_in_blocks(mode, up, D, shards, chunk):
    rng = np.random.default_rng(71 + D)
    H, W, V = 16, 16, 3
    C = 16 if mode == "correlation" else 8
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V + 1)])
    rels = stage_relative_projections(projs, 1)[0].astype(np.float32)
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    srcs = rng.normal(size=(V, H, W, C)).astype(np.float32)
    depths = np.sort(rng.uniform(85, 115, size=(D, H, W)), 0).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(V, H, W)).astype(np.float32)
    args = (depths, ref, srcs, rels, weights)
    holder = tnn.Module()
    holder.red0 = RedStep2(C, up=up) if mode == "correlation" else RedStep4(C)
    jp = seeded(holder, rng, 0.2)
    jd, jc = jax.jit(_JSweep(mode=mode, up=up, shards=shards, chunk=chunk).apply)(
        jp, *map(jnp.asarray, args))
    w = t(weights) if mode == "correlation" else None
    with torch.no_grad():
        td, tc = streaming_sweep(holder.red0, up, t(depths), t(ref), t(srcs), t(rels), w,
                                 plane_chunk=chunk, cost_mode=mode, depth_shards=shards)
        one, _ = streaming_sweep(holder.red0, up, t(depths), t(ref), t(srcs), t(rels), w,
                                 plane_chunk=chunk, cost_mode=mode)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=3e-2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)
    # the blocks restart their recurrence: not the one-block sweep
    assert float((td - one).abs().max()) > 1e-3


def _inputs(seed, V, H, W):
    rng = np.random.default_rng(seed)
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    return rng, imgs, rel


@pytest.mark.parametrize("name,kw,jkw", [
    ("adamvs", dict(ndepths=(16, 8, 8), num_depth=64), dict(red_impl="flax")),
    ("casmvsnet", dict(ndepths=(8,), num_depth=32), {}),
    ("msrednet", dict(ndepths=(8, 8, 8), num_depth=64, plane_chunk=4),
     dict(red_impl="flax")),
    ("ucsnet", dict(ndepths=(16, 8, 8), num_depth=64), {}),
])
def test_forward_depth_shards_matches_jax(name, kw, jkw):
    """The whole forward at depth_shards = 2 against JAX's at 2 (32x64, 3
    views; the shard shapes of the JAX package's own tests: AdaMVS
    (16, 8, 8)/64 as tests/test_pallas_red.py, CasMVSNet (8,)/32 as
    tests/test_parallel.py, MSREDNet's 8 planes in chunks of 4 as
    tests/test_pallas_red4.py)."""
    H, W = 32, 64
    rng, imgs, rel = _inputs(83 + len(name), 3, H, W)
    tree = state_dict_to_tree(init_random_weights(build_model(name, **kw), seed=9))
    flat = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}
    jmod = jbuild_model(name, warp_impl="xla", depth_shards=2, **kw, **jkw)
    jout = jax.jit(jmod.apply)({"params": nest(flat)["params"]}, jnp.asarray(imgs),
                               jnp.asarray(rel), DMIN, DMAX)
    args = (torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    model = load_jax_weights(build_model(name, depth_shards=2, **kw), flat).eval()
    with torch.no_grad():
        tout = model(*args)
    stages = [f"stage{s + 1}" for s in range(len(kw["ndepths"]))]
    for s in stages:
        for key, tol in (("depth", 1e-3 * (DMAX - DMIN)), ("photometric_confidence", 1e-4)):
            diff = float(np.abs(tout[s][key].numpy() - np.asarray(jout[s][key])).max())
            assert diff <= tol, (name, s, key, diff)


def test_casmvsnet_train_step_depth_shards_matches_jax():
    """One step of a one-stage CasMVSNet (8,)/32 at depth_shards = 2, the
    JAX package's sharded-step model (tests/test_parallel.py), against its
    single-device make_train_step on the same parameters and batch: loss
    1e-4 relative, gradients 1e-4 of a leaf's largest entry plus 1e-5 of
    the largest."""
    from deep3d_aerial_tpu.parallel.train_step import make_train_step as jmake_train_step

    kw = dict(ndepths=(8,), num_depth=32)
    rng = np.random.default_rng(97)
    batch = _batch(rng)
    tree = state_dict_to_tree(init_random_weights(build_model("casmvsnet", **kw), 97))
    flat = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}
    jparams = nest(flat)
    jmod = jbuild_model("casmvsnet", warp_impl="xla", depth_shards=2, **kw)
    cap = _grad_capture()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jparams, cap.init(jparams), jb)
    step = jmake_train_step(jmod, cap, num_stages=1, pair_weight=0.0)
    _, jgrads, jlogs = step.lower(*args).compile(FAST_COMPILE)(*args)

    model = load_jax_weights(build_model("casmvsnet", depth_shards=2, **kw), flat)
    opt = make_optimizer(model.named_parameters(), 1e-3, kind="rmsprop")
    grads = {}
    update = opt.step
    opt.step = lambda g: grads.update(g) or update(g)
    logs = tstep.make_train_step(model, opt, num_stages=1, pair_weight=0.0)(batch)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(logs[k], float(jlogs[k]), rtol=1e-4, err_msg=k)
    want = tree_to_state_dict(model, flatten(jgrads))
    scale = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        err = float((grads[n] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-5 * scale, (n, err)
