"""The port's parallel/ (dp x sp over torch.distributed) on the CPU, in
gloo ranks spawned by parallel.launch.spawn (at most 4 a case, 32 x 32,
3 views, 8 planes a stage), against the JAX package and against the
port's one-process path.

The rank functions live in tests/torch_parallel_workers.py, which imports
no JAX: the JAX oracles run here and reach the ranks as .npz files, with
the port's seeded initial weights (perturbed) carried to JAX by
weights.state_dict_to_tree.

Tolerances. The mesh layout and the gather: exact (the gather adds only
zeros; its backward sums the ranks' gradients, in rank order, of values
that are exact in float32 here). Forwards under dp 2 x sp 2 against the
JAX make_infer_step (mesh None, the same depth_shards 2 model): depth
within 1e-3 x the depth range, confidence within 1e-4, as the one-process
forward tests; against the port's one-process forward at depth_shards 2:
1e-6 relative to the largest value (a rank repeats the one-process
arithmetic of its blocks: the sweep's planes, and the 3-D regularizer one
block at a time, as in one process: measured equal). The dp 2 x sp 2 train step of a one-stage CasMVSNet against the
JAX single-device step on the whole batch: tests/test_torch_train_step.py's
limits (loss 1e-4 relative; a gradient leaf 1e-4 of its largest entry
plus 1e-5 of the model's largest; the parameters after one rmsprop update
1e-4 where the gradient's sign is settled, else twice lr * sqrt(10)). The
three-stage AdaMVS step, sharded against the port's one-process step on
the same batch: every gradient within 1e-5 of the largest (sums in another
order: the gradients of 2 samples a rank all-reduced, against the 4
samples' backward in one process), and every rank's parameters equal bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models import build_model as jbuild_model
from deep3d_aerial_tpu.parallel import make_mesh as jmake_mesh
from deep3d_aerial_tpu.parallel.train_step import make_infer_step as jmake_infer_step
from deep3d_aerial_tpu.parallel.train_step import make_optimizer as jmake_optimizer
from deep3d_aerial_tpu.parallel.train_step import make_train_step as jmake_train_step
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.parallel.dryrun import dryrun_multichip
from deep3d_aerial_tpu_torch.parallel.launch import spawn
from deep3d_aerial_tpu_torch.parallel.sharding import layout
from deep3d_aerial_tpu_torch.parallel.train_step import make_infer_step
from deep3d_aerial_tpu_torch.train.optim import make_optimizer
from deep3d_aerial_tpu_torch.train.step import make_train_step
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
    tree_to_state_dict,
)
import torch_parallel_workers as workers
from tests.conftest import random_pose, toy_camera
from tests.test_torch_train_step import FAST_COMPILE, _grad_capture, flatten, nest

torch.set_num_threads(1)

B, V, H, W = 4, 3, 32, 32
DMIN, DMAX = 80.0, 120.0
DPSP = {"dp": 2, "sp": 2}
LR = 1e-3
MODELS = {
    "adamvs": (dict(ndepths=(8, 8, 8), num_depth=32, plane_chunk=4),
               dict(red_impl="flax")),
    "casmvsnet": (dict(ndepths=(8, 8, 8), num_depth=32), {}),
}


def make_batch(seed):
    """B samples (tests/test_parallel.py's shapes): random poses ~100 m up,
    normal images, a depth target in the range and a sparse mask."""
    rng = np.random.default_rng(seed)
    cam = toy_camera(width=W, height=H, f=60.0)
    rels, imgs = [], []
    for _ in range(B):
        projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
        rels.append(stage_relative_projections(projs, 3))
        imgs.append(rng.normal(size=(V, H, W, 3)))
    return rng, {
        "imgs": np.stack(imgs).astype(np.float32),
        "rel_projs": np.stack(rels).astype(np.float32),
        "depth_min": np.full((B,), DMIN, np.float32),
        "depth_max": np.full((B,), DMAX, np.float32),
        "depth_gt": rng.uniform(85, 115, size=(B, H, W)).astype(np.float32),
        "mask": (rng.uniform(size=(B, H, W)) > 0.2).astype(np.float32),
    }


def seeded_weights(rng, name, kw, seed):
    tree = state_dict_to_tree(init_random_weights(build_model(name, **kw), seed))
    return {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2}, {"dp": 2, "sp": 4}])
def test_mesh_layout_matches_jax(axes):
    """The ranks of make_mesh's layout are the device ids of the JAX
    make_mesh (8 CPU devices); more than the world raises, as there."""
    jdev = jmake_mesh(axes).devices
    ids = np.vectorize(lambda d: d.id)(jdev)
    np.testing.assert_array_equal(layout(axes, 8), ids)
    with pytest.raises(ValueError, match="mesh wants"):
        layout(axes, int(np.prod(list(axes.values()))) - 1)
    with pytest.raises(ValueError):
        jmake_mesh({"dp": 128})


def test_mesh_groups_on_four_ranks():
    """On 4 gloo ranks, {'dp': 2, 'sp': 2}: each rank's coordinates, its sp
    group (its dp row) and its dp group (its sp column); a mesh wider than
    the world raises."""
    recs = spawn(workers.mesh_case, 4, DPSP)
    for r, rec in enumerate(recs):
        assert rec["rank"] == r
        assert rec["devices"] == [[0, 1], [2, 3]]
        assert rec["coords"] == {"dp": r // 2, "sp": r % 2}
        assert rec["groups"]["sp"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert rec["groups"]["dp"] == [r % 2, r % 2 + 2]
        assert "mesh wants 8 devices, only 4 present" in rec["wider"]


def test_gather_forward_and_backward_on_two_ranks():
    """gather_rows (through constrain) on 2 ranks: the forward is torch.cat
    of the ranks' rows in rank order; the backward of sum(out * w_r) gives
    each rank the sum over ranks of w_r at its rows; shard_range splits 4
    blocks 2 + 2, raises for 3, leaves 1 unsharded; replicated gives rank
    0's weights to both."""
    recs = spawn(workers.gather_case, 2)
    cat = torch.cat([r["rows"] for r in recs])
    wsum = sum(r["w"] for r in recs)
    for r, rec in enumerate(recs):
        assert torch.equal(rec["out"], cat)
        assert torch.equal(rec["grad"], wsum[2 * r:2 * r + 2])
        assert rec["own"] == [2 * r, 2 * r + 1]
        assert rec["uneven"] and "do not split over 2" in rec["uneven"]
        assert rec["one"] == [0]
        assert torch.equal(rec["lin"], torch.zeros(2, 3))
        assert rec["gathered"] == {("sp", (2, 3), torch.float32): 1}


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_forward_matches_jax_and_one_process(name, tmp_path):
    """dp 2 x sp 2 forward (depth_shards 2) of the whole batch on every
    rank, against the JAX forward and the port's one-process forward."""
    kw, jkw = MODELS[name]
    rng, batch = make_batch(31 + len(name))
    flat = seeded_weights(rng, name, kw, seed=5)
    path = tmp_path / "case.npz"
    workers.save(path, flat, batch)
    recs = spawn(workers.infer_case, 4, str(path), name, dict(kw, depth_shards=2), DPSP)

    jmod = jbuild_model(name, warp_impl="xla", depth_shards=2, **kw, **jkw)
    jargs = ({"params": nest(flat)["params"]},
             *(jnp.asarray(batch[k]) for k in ("imgs", "rel_projs", "depth_min",
                                               "depth_max")))
    jinfer = jmake_infer_step(jmod).lower(*jargs).compile(FAST_COMPILE)
    jout = {k: np.asarray(v) for k, v in jinfer(*jargs).items()}
    model = load_jax_weights(build_model(name, depth_shards=2, **kw), flat).eval()
    one = make_infer_step(model)(batch["imgs"], batch["rel_projs"],
                                 batch["depth_min"], batch["depth_max"])
    for rec in recs:
        for key, tol in (("depth", 1e-3 * (DMAX - DMIN)), ("photometric_confidence", 1e-4)):
            got = rec["out"][key]
            assert got.shape == (B, H, W)
            assert float(np.abs(got.numpy() - jout[key]).max()) <= tol, (name, key)
            assert float((got - one[key]).abs().max()) <= 1e-6 * float(one[key].abs().max()), \
                (name, key, float((got - one[key]).abs().max()))
        # one gather of each stage's blocks a sample (2 samples a rank)
        # and one of the batch's depth and confidence over dp
        assert sum(rec["gathered"].values()) == 3 * 2 + 2


def _jax_step(name, kw, flat, batch, step_kw):
    """JAX single-device step on the whole batch: (logs, flat grads, flat
    params after rmsprop at LR)."""
    jmod = jbuild_model(name, warp_impl="xla", **kw)
    jparams = nest(flat)
    cap = _grad_capture()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jparams, cap.init(jparams), jb)
    step = jmake_train_step(jmod, cap, **step_kw).lower(*args).compile(FAST_COMPILE)
    _, jgrads, jlogs = step(*args)
    tx = jmake_optimizer(LR, kind="rmsprop")
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    new = optax.apply_updates(jparams, updates)
    return ({k: float(v) for k, v in jlogs.items()}, flatten(jgrads), flatten(new))


def test_sharded_casmvsnet_step_matches_the_jax_single_device_step(tmp_path):
    """tests/test_parallel.py's one-stage CasMVSNet ((8,)/32, depth_shards
    2), one step under dp 2 x sp 2 against the JAX make_train_step on one
    device and the whole batch."""
    kw = dict(ndepths=(8,), num_depth=32, depth_shards=2)
    step_kw = dict(num_stages=1, pair_weight=0.0)
    rng, batch = make_batch(41)
    flat = seeded_weights(rng, "casmvsnet", kw, seed=41)
    path = tmp_path / "case.npz"
    workers.save(path, flat, batch)
    recs = spawn(workers.train_case, 4, str(path), "casmvsnet", kw, DPSP, step_kw)
    jlogs, jgrads, jnew = _jax_step("casmvsnet", kw, flat, batch, step_kw)

    model = build_model("casmvsnet", **kw)
    want = tree_to_state_dict(model, jgrads)
    new = tree_to_state_dict(model, jnew)
    scale = max(float(w.abs().max()) for w in want.values())
    rec = recs[0]
    assert set(rec["logs"]) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(rec["logs"][k], jlogs[k], rtol=1e-4, err_msg=k)
    for n, w in want.items():
        tol = 1e-4 * float(w.abs().max()) + 1e-5 * scale
        err = float((rec["grads"][n] - w).abs().max())
        assert err <= tol, (n, err, tol)
        settled = w.abs() > 10 * tol
        atol = torch.where(settled, 1e-4, 2 * LR * 10 ** 0.5 + 1e-6)
        assert bool(((rec["params"][n] - new[n]).abs() <= atol).all()), n
    for other in recs[1:]:
        assert other["logs"] == rec["logs"]
        for n, p in rec["params"].items():
            assert torch.equal(other["params"][n], p), n


def test_sharded_adamvs_step_matches_the_one_process_step(tmp_path):
    """Three-stage AdaMVS (8, 8, 8)/32, plane_chunk 4, depth_shards 2: one
    step under dp 2 x sp 2 against the port's one-process step on the
    whole batch; every rank ends with the same parameters."""
    kw = dict(MODELS["adamvs"][0], depth_shards=2)
    step_kw = dict(pair_weight=1.0)
    rng, batch = make_batch(43)
    flat = seeded_weights(rng, "adamvs", kw, seed=43)
    path = tmp_path / "case.npz"
    workers.save(path, flat, batch)
    recs = spawn(workers.train_case, 4, str(path), "adamvs", kw, DPSP, step_kw)

    model = load_jax_weights(build_model("adamvs", **kw), flat)
    opt = make_optimizer(model.named_parameters(), LR, kind="rmsprop")
    grads = {}
    update = opt.step
    opt.step = lambda g: grads.update({n: t.clone() for n, t in g.items()}) or update(g)
    logs = make_train_step(model, opt, **step_kw)(batch)
    scale = max(float(g.abs().max()) for g in grads.values())
    rec = recs[0]
    for k in logs:
        np.testing.assert_allclose(rec["logs"][k], logs[k], rtol=1e-5, err_msg=k)
    worst = max(float((rec["grads"][n] - g).abs().max()) for n, g in grads.items())
    assert worst <= 1e-5 * scale, (worst, scale)
    for other in recs[1:]:
        for n, p in rec["params"].items():
            assert torch.equal(other["params"][n], p), n


def test_dryrun_multichip_on_four_cpu_ranks():
    """parallel.dryrun: dp 2 x sp 2, one AdaMVS train step, the sharded
    forward equal to the one-process forward within 1e-4 relative."""
    recs = dryrun_multichip(4, device="cpu")
    assert [r["coords"] for r in recs] == [{"dp": 0, "sp": 0}, {"dp": 0, "sp": 1},
                                           {"dp": 1, "sp": 0}, {"dp": 1, "sp": 1}]
    assert len({r["loss"] for r in recs}) == 1 and np.isfinite(recs[0]["loss"])
    assert all(r["forward_rel_err"] <= 1e-4 for r in recs)
