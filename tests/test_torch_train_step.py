"""One training step of the port against the JAX package's
`make_train_step`, on the CPU, for each model the trainer offers: the same
seeded, perturbed parameters (made by the port's initializer and handed to
JAX through weights.state_dict_to_tree, which the JAX models then read), the
same seeded batch, the JAX oracle on its plain path (warp_impl 'xla',
red_impl 'flax'). The JAX gradients are carried back by the same bridge
(a permutation and a flip of each leaf: linear, so it carries gradients
too). Then one `Trainer.fit` epoch and a resume through the CLI with
--device cpu.

Tolerances. The loss and each stage log: 1e-4 relative (the forwards sum
fp32 convolutions and reductions in other orders: ~1e-6). A gradient leaf:
TOL_GRAD of its largest entry plus 1e-5 of the model's largest gradient
(the floor is for leaves whose gradient is ~0 by symmetry, as a score bias
under a softmax over planes, where any rounding is all there is);
AdaMVS, MSREDNet and CasMVSNet agree to ~1e-5 relative. UCSNet's
gradient is ill-conditioned at float32: its later stages sample
center +- 1.5 sigma, so every hypothesis and its bilinear taps move with
sigma, and a tap that crosses a pixel border changes the gradient by a
step; JAX's own gradient moves by 6.1e-3 of a leaf's largest entry when
the images are scaled by (1 + 2^-22) (one ulp), so UCSNet is held to
2e-2. The parameters after one rmsprop update (lr 1e-3): 1e-4 absolute
where |g| is above 10x its leaf's tolerance, so that its sign is settled;
elsewhere an update moves a parameter by at most lr * sqrt(10) (g /
sqrt(0.1 g^2 + 1e-8)), and the two are held to twice that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models import build_model as jbuild_model
from deep3d_aerial_tpu.parallel.train_step import make_optimizer as jmake_optimizer
from deep3d_aerial_tpu.parallel.train_step import make_train_step as jmake_train_step
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.train import step as tstep
from deep3d_aerial_tpu_torch.train.optim import make_optimizer
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
    tree_to_state_dict,
)
from tests.conftest import random_pose, toy_camera
from tests.test_dataset_whu import whu_root, write_cam  # noqa: F401  (fixture)

torch.set_num_threads(1)

V, H, W = 3, 32, 64
DMIN, DMAX = 80.0, 120.0
LR = 1e-3
TOL_LOSS = 1e-4
TOL_PARAM = 1e-4
# the JAX oracle compiles fast, not well: it runs once
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

# (model, constructor kwargs of both sides, pair weight, seed, gradient
# tol); tests/test_torch_train_step_volume.py takes the other two
MODELS = {
    "adamvs": (dict(ndepths=(8, 8, 4), num_depth=32, plane_chunk=2), 1.0, 91, 1e-4),
    "msrednet": (dict(ndepths=(4, 4, 4), num_depth=32, plane_chunk=2), 0.0, 92, 1e-4),
    "casmvsnet": (dict(ndepths=(8, 8, 8), num_depth=32), 0.0, 93, 1e-4),
    "ucsnet": (dict(ndepths=(8, 8, 8), num_depth=32), 0.0, 94, 2e-2),
}


def _batch(rng):
    cam = toy_camera(width=W, height=H, f=1.25 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V)])
    rel = stage_relative_projections(projs, 3).astype(np.float32)
    return {
        "imgs": rng.normal(size=(1, V, H, W, 3)).astype(np.float32),
        "rel_projs": rel[None],
        "depth_min": np.array([DMIN], np.float32),
        "depth_max": np.array([DMAX], np.float32),
        "depth_gt": rng.uniform(85, 115, size=(1, H, W)).astype(np.float32),
        "mask": (rng.uniform(size=(1, H, W)) > 0.2).astype(np.float32),
    }


def nest(flat):
    """A flat keystr tree as the nested dict a flax module applies."""
    import re

    out = {}
    for key, leaf in flat.items():
        parts = re.findall(r"\['([^']+)'\]", key)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(leaf)
    return out


def flatten(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_capture():
    """An optax transformation whose state is the last gradients and whose
    update is zero: make_train_step then hands back its own gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def run_jax_step(name):
    """(model name, flat params, batch, JAX logs, JAX grads as a flat
    tree, JAX params after one rmsprop update as a flat tree)."""
    kw, pair_w, seed, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    batch = _batch(rng)
    tree = state_dict_to_tree(init_random_weights(build_model(name, **kw), seed))
    flat = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}
    jparams = nest(flat)
    jmod = jbuild_model(name, warp_impl="xla",
                        **({"red_impl": "flax"} if name in ("adamvs", "msrednet") else {}),
                        **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cap = _grad_capture()
    args = (jparams, cap.init(jparams), jb)
    step = jmake_train_step(jmod, cap, pair_weight=pair_w).lower(*args).compile(FAST_COMPILE)
    _, jgrads, logs = step(*args)
    # the rest of the JAX step: its NaN guard (a finite loss here) and the
    # rmsprop update of make_optimizer's default
    assert np.isfinite(float(logs["total"]))
    tx = jmake_optimizer(LR, kind="rmsprop")
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    new = optax.apply_updates(jparams, updates)
    return (name, flat, batch, {k: float(v) for k, v in logs.items()},
            flatten(jgrads), flatten(new))


def check_train_step(name, flat, batch, jlogs, jgrads, jnew):
    kw, pair_w, _, tol_grad = MODELS[name]
    model = load_jax_weights(build_model(name, **kw), flat)
    opt = make_optimizer(model.named_parameters(), LR, kind="rmsprop")
    grads = {}
    update = opt.step
    opt.step = lambda g: grads.update(g) or update(g)
    logs = tstep.make_train_step(model, opt, pair_weight=pair_w)(batch)

    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(logs[k], jlogs[k], rtol=TOL_LOSS, err_msg=k)

    want = tree_to_state_dict(model, jgrads)
    assert set(want) == set(grads)
    scale = max(float(w.abs().max()) for w in want.values())
    new = tree_to_state_dict(model, jnew)
    for n, p in model.named_parameters():
        w = want[n]
        tol = tol_grad * float(w.abs().max()) + 1e-5 * scale
        err = float((grads[n] - w).abs().max())
        assert err <= tol, f"{name} grad {n}: {err} > {tol}"
        settled = w.abs() > 10 * tol
        atol = torch.where(settled, TOL_PARAM, 2 * LR * 10 ** 0.5 + 1e-6)
        diff = (p.detach() - new[n]).abs()
        assert bool((diff <= atol).all()), f"{name} param {n}: {float(diff.max())}"


@pytest.mark.parametrize("name", ["adamvs", "ucsnet"])
def test_train_step_matches_jax(name):
    check_train_step(*run_jax_step(name))


def test_trainer_fit_and_cli_resume_on_the_cpu(whu_root, tmp_path):  # noqa: F811
    """One epoch through the CLI with --device cpu, then --resume for a
    second: the resumed run starts from the first's parameters and
    optimizer state and writes model_000001; --mode test evaluates it."""
    from deep3d_aerial_tpu_torch.train import checkpoint as ckpt
    from deep3d_aerial_tpu_torch.train.__main__ import main

    logdir = tmp_path / "ckpt"
    common = ["--data_folder", str(whu_root), "--gt_format", "pfm", "--view_num", "3",
              "--numdepth", "64", "--max_h", "64", "--max_w", "96",
              "--logdir", str(logdir), "--device", "cpu", "--model", "casmvsnet"]
    t1, _ = main(common + ["--epochs", "1"])
    assert sorted(p.name for p in logdir.iterdir() if p.name.startswith("model_")) \
        == ["model_000000"]
    assert t1.optimizer.count == 2 and t1.global_step == 2
    state1 = {n: p.detach().clone() for n, p in t1.model.named_parameters()}
    nu1 = {n: t.clone() for n, t in t1.optimizer.nu.items()}

    from deep3d_aerial_tpu_torch.train.__main__ import build, parse_args

    t2, _, _ = build(parse_args(common + ["--epochs", "2"]))
    assert t2.resume() and t2.epoch == 1
    for n, p in t2.model.named_parameters():
        assert torch.equal(p.detach(), state1[n]), n
    for n, t in t2.optimizer.nu.items():
        assert torch.equal(t, nu1[n]), n
    assert t2.optimizer.count == 2

    t3, _ = main(common + ["--epochs", "2", "--resume"])
    assert t3.optimizer.count == 4
    assert ckpt.latest_checkpoint(str(logdir)).endswith("model_000001")
    assert (logdir / "train_record.txt").read_text().count("epoch") == 2
    assert list((logdir / "tb").glob("events.out.tfevents.*"))
    _, metrics = main(common + ["--resume", "--mode", "test"])
    assert set(metrics) == {"abs_error", "acc_1", "acc_3", "acc_6"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_train_cli_dp_2_on_the_cpu_ends_with_the_one_process_parameters(
        whu_root, tmp_path):  # noqa: F811
    """`python -m deep3d_aerial_tpu_torch.train --dp 2 --device cpu` (two
    gloo ranks it spawns itself, one sample of each global batch of 2 a
    rank, with --augment) trains one epoch and ends with the parameters and
    optimizer state of a one-process run on the same global batches, bit
    for bit: each sample's forward and backward are the same computation
    in both (one intra-op thread everywhere: the CLI's ranks share its 2),
    the augmentation draws of the sample a rank skips are skipped
    (dataset_whu batches(shard=)), and (g0 + g1) / 2 over two ranks equals
    the one-process 0.5 g0 + 0.5 g1 exactly (halving is exact, a sum of
    two terms commutes)."""
    import os
    import subprocess
    import sys

    from deep3d_aerial_tpu_torch.train import checkpoint as ckpt
    from deep3d_aerial_tpu_torch.train.__main__ import main

    common = ["--data_folder", str(whu_root), "--gt_format", "pfm", "--view_num", "3",
              "--numdepth", "64", "--max_h", "64", "--max_w", "96", "--device", "cpu",
              "--model", "casmvsnet", "--batch_size", "2", "--augment", "--epochs", "1"]
    res = subprocess.run(
        [sys.executable, "-m", "deep3d_aerial_tpu_torch.train", *common,
         "--logdir", str(tmp_path / "dp"), "--dp", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("[train] epoch 0 step 0") == 1  # rank 0 alone prints
    one, _ = main(common + ["--logdir", str(tmp_path / "one")])
    dp = build_model("casmvsnet", num_depth=64)
    opt = make_optimizer(dp.named_parameters(), LR)
    ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path / "dp")), dp, opt)
    assert opt.count == one.optimizer.count == 1
    for n, p in one.model.named_parameters():
        assert torch.equal(dict(dp.named_parameters())[n].detach(), p.detach()), n
        assert torch.equal(opt.nu[n], one.optimizer.nu[n]), n
    assert (tmp_path / "dp" / "train_record.txt").read_text() == \
        (tmp_path / "one" / "train_record.txt").read_text()
