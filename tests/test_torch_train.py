"""The port's training modules against the JAX package's, on the CPU:
losses and metrics, the optimizers against optax (through the JAX
package's make_optimizer), the train step's NaN guard, the event writer's
bytes, augmentation and the WHU / BlendedMVS datasets, and checkpoints
(names, latest/best, partial warm start, the params.npz that the JAX
package reads).

Tolerances: losses and metrics 1e-6 relative (the same float32
operations, sums in another order); the losses' gradients 1e-5 of their
largest entry (the upsampling is a lerp here and a weight-matrix product
in JAX, so its transpose sums the same terms in another order); the
optimizers 1e-6 relative over 6 updates (optax's operations in its order,
the global norm summed over the leaves in another order); the writer's
bytes, the augmentation, the datasets and checkpoints exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.io.pfm import write_pfm
from deep3d_aerial_tpu.parallel.train_step import make_optimizer as jmake_optimizer
from deep3d_aerial_tpu.train import losses as jlosses
from deep3d_aerial_tpu.train import metrics as jmetrics
from deep3d_aerial_tpu_torch.pipeline import augment
from deep3d_aerial_tpu_torch.train import checkpoint as ckpt
from deep3d_aerial_tpu_torch.train import losses, metrics
from deep3d_aerial_tpu_torch.train import tb_writer
from deep3d_aerial_tpu_torch.train.dataset_whu import (
    BlendedMVSDataset,
    WHUOMVSDataset,
    read_rgb,
)
from deep3d_aerial_tpu_torch.train.optim import make_optimizer
from deep3d_aerial_tpu_torch.train.step import make_train_step, resize_nearest
from deep3d_aerial_tpu_torch.train.trainer import parse_lr_epochs
from tests.conftest import random_pose
from tests.test_dataset_whu import whu_root, write_cam  # noqa: F401  (fixture)

torch.set_num_threads(1)
TOL = 1e-6


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _loss_inputs(rng, H=16, W=24):
    """Stage depths at H/4 (pair results), H/2, H and H: the AdaMVS
    layout; GT at full res or (pyramid) at H/4, H/2, H."""
    d = {"stage1": rng.uniform(85, 115, (H // 2, W // 2)),
         "stage2": rng.uniform(85, 115, (H, W)),
         "stage3": rng.uniform(85, 115, (H, W)),
         "pairs": rng.uniform(85, 115, (2, H // 4, W // 4))}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    gt = rng.uniform(85, 115, (H, W)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    return d, gt, mask, normal, np.linalg.inv(K).astype(np.float32)


@pytest.mark.parametrize("pyramid", [False, True])
def test_cascade_depth_loss_and_its_gradient(pyramid):
    rng = np.random.default_rng(1 + pyramid)
    d, gt, mask, normal, K_inv = _loss_inputs(rng)
    H, W = gt.shape
    if pyramid:   # nearest, as make_train_step's gt_pyramid: /4, /2, x1
        shapes = [(H // 4, W // 4), (H // 2, W // 2), (H, W)]
        jg = [np.asarray(jax.image.resize(gt, s, "nearest")) for s in shapes]
        jm = [np.asarray(jax.image.resize(mask, s, "nearest")) for s in shapes]
        for a, b in zip(jg + jm, [resize_nearest(_t(gt), s) for s in shapes]
                        + [resize_nearest(_t(mask), s) for s in shapes]):
            assert np.array_equal(a, b.numpy())
    else:
        jg, jm = [gt] * 3, [mask] * 3
    kw = dict(stage_weights=(0.5, 1.0, 2.0), pair_weight=1.0, normal_weight=0.3)
    names = ("stage1", "stage2", "stage3", "pairs")

    def jloss(*depths):
        out = {s: {"depth": x} for s, x in zip(names[:3], depths[:3])}
        out["stage1"]["pair_results"] = depths[3]
        return jlosses.cascade_depth_loss(
            out, [jnp.asarray(g) for g in jg], [jnp.asarray(m) for m in jm],
            normal_gt=jnp.asarray(normal), K_inv=jnp.asarray(K_inv), **kw)

    jlogs = jax.jit(jloss)(*(jnp.asarray(d[n]) for n in names))
    jgrads = jax.jit(jax.grad(lambda *x: jloss(*x)["total"], argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(d[n]) for n in names))
    xs = [_t(d[n], grad=True) for n in names]
    out = {s: {"depth": x} for s, x in zip(names[:3], xs[:3])}
    out["stage1"]["pair_results"] = xs[3]
    logs = losses.cascade_depth_loss(out, [_t(g) for g in jg], [_t(m) for m in jm],
                                     normal_gt=_t(normal), K_inv=_t(K_inv), **kw)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]), rtol=TOL,
                                   err_msg=k)
    grads = torch.autograd.grad(logs["total"], xs)
    for n, a, b in zip(names, grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()), err_msg=n)


def test_smooth_l1_and_metrics():
    rng = np.random.default_rng(3)
    est = rng.uniform(90, 110, (20, 30)).astype(np.float32)
    gt = (est + rng.normal(scale=0.4, size=est.shape) * (rng.uniform(size=est.shape) > 0.1)
          + 50 * (rng.uniform(size=est.shape) > 0.95)).astype(np.float32)
    mask = rng.uniform(size=est.shape) > 0.2
    np.testing.assert_allclose(losses.smooth_l1(_t(est), _t(gt)).numpy(),
                               np.asarray(jlosses.smooth_l1(est, gt)), rtol=TOL)
    e, g, m = _t(est), _t(gt), torch.from_numpy(mask)
    pairs = [(metrics.abs_depth_error(e, g, m, 0.1), jmetrics.abs_depth_error(est, gt, mask, 0.1))]
    for k in (1.0, 3.0, 6.0):
        pairs.append((metrics.interval_accuracy(e, g, m, k, 0.1),
                      jmetrics.interval_accuracy(est, gt, mask, k, 0.1)))
    pairs.append((metrics.threshold_accuracy(e, g, m, 0.25),
                  jmetrics.threshold_accuracy(est, gt, mask, 0.25)))
    n1 = rng.normal(size=(20, 30, 3)).astype(np.float32)
    n2 = n1 + rng.normal(scale=0.2, size=n1.shape).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=-1, keepdims=True)
    pairs.append((metrics.normal_angle_error(_t(n1), _t(n2), m),
                  jmetrics.normal_angle_error(n1, n2, mask)))
    for a, b in pairs:
        np.testing.assert_allclose(float(a), float(b), rtol=TOL)
    assert parse_lr_epochs("10,12,14:2") == ((10, 12, 14), 0.5)


@pytest.mark.parametrize("kind,clip,warmup,milestones", [
    ("rmsprop", 0.0, 0, ()),
    ("rmsprop", 1.5, 2, (2, 4)),
    ("adam", 1.5, 2, (3,)),
    ("adamw", 0.0, 3, (2, 5)),
])
def test_optimizers_match_optax(kind, clip, warmup, milestones):
    """6 updates on seeded gradients, some large enough to clip."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (3.0 if i % 2 else 0.2)).astype(np.float32)
              for k, s in shapes.items()} for i in range(6)]
    tx = jmake_optimizer(0.01, milestones=milestones, gamma=0.5, kind=kind,
                         clip_norm=clip, warmup_steps=warmup)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = {k: _t(v) for k, v in p0.items()}
    opt = make_optimizer(params.items(), 0.01, milestones=milestones, gamma=0.5,
                         kind=kind, clip_norm=clip, warmup_steps=warmup)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        opt.step({k: _t(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), rtol=TOL,
                                       atol=TOL * 1e-3, err_msg=f"{kind} update {i} {k}")
    assert opt.count == 6
    if warmup:   # the first update has lr 0
        assert float(opt.lr_fn(0)) == 0.0


class _Toy(torch.nn.Module):
    """A 'model' whose three stage depths are a parameter plus the image
    mean: enough for the train step's loss, backward and update."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4, 6), 100.0))

    def forward(self, imgs, rel, dmin, dmax):
        d = self.w + imgs.mean()
        return {f"stage{s}": {"depth": d} for s in (1, 2, 3)}


def _toy_batch(gt):
    return {"imgs": np.zeros((1, 2, 4, 6, 3), np.float32),
            "rel_projs": np.zeros((1, 3, 1, 4, 4), np.float32),
            "depth_min": np.ones(1, np.float32), "depth_max": np.ones(1, np.float32),
            "depth_gt": np.full((1, 4, 6), gt, np.float32),
            "mask": np.ones((1, 4, 6), np.float32)}


def test_nan_guard_zeroes_the_gradients_and_still_updates():
    """As the JAX step: a non-finite loss zeroes every gradient and the
    update is applied all the same -- rmsprop's nu decays by 0.9, the count
    advances, the parameters (a zero update) stay."""
    model = _Toy()
    opt = make_optimizer(model.named_parameters(), 0.01, kind="rmsprop")
    step = make_train_step(model, opt, pair_weight=0.0)
    step(_toy_batch(101.0))
    nu = opt.nu["w"].clone()
    w = model.w.detach().clone()
    assert opt.count == 1 and float(nu.abs().max()) > 0
    logs = step(_toy_batch(np.nan))
    assert not np.isfinite(logs["total"])
    assert opt.count == 2
    assert torch.equal(model.w.detach(), w)
    assert torch.equal(opt.nu["w"], 0.9 * nu)


def test_tb_writer_bytes_equal_the_jax_writer(tmp_path, monkeypatch):
    from deep3d_aerial_tpu.train import tb_writer as jtb

    class Clock:
        @staticmethod
        def time():
            return 1700000000.25

    for mod in (jtb, tb_writer):
        monkeypatch.setattr(mod, "time", Clock)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    img = np.random.default_rng(0).uniform(size=(6, 8)).astype(np.float32)
    for mod, d in ((jtb, tmp_path / "j"), (tb_writer, tmp_path / "t")):
        w = mod.EventWriter(str(d))
        mod.save_scalars(w, "train", {"loss": 1.25, "stage": [0.5, 2.0]}, 3)
        mod.save_images(w, "test", {"depth": img}, 4)
        w.close()
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    assert tb_writer.crc32c(b"123456789") == jtb.crc32c(b"123456789")
    lines = (tmp_path / "t" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(l)["tag"] for l in lines] == ["train/loss", "train/stage_0",
                                                     "train/stage_1"]


def test_augment_equals_the_jax_augment():
    from deep3d_aerial_tpu.pipeline import augment as jaug

    img = np.random.default_rng(1).integers(0, 255, (16, 20, 3)).astype(np.uint8)
    for fn in ("random_photometric", "random_gaussian_noise"):
        for seed in range(4):
            a = getattr(augment, fn)(img, np.random.default_rng(seed))
            b = getattr(jaug, fn)(img, np.random.default_rng(seed))
            assert a.dtype == np.uint8 and np.array_equal(a, b)


def _batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kw", [
    dict(view_num=3),
    dict(view_num=3, max_h=48, max_w=64, augment=True, seed=4),
])
def test_whu_dataset_equals_the_jax_dataset(whu_root, kw):  # noqa: F811
    from deep3d_aerial_tpu.train.dataset_whu import WHUOMVSDataset as JWHU

    ours = WHUOMVSDataset(str(whu_root), gt_format="pfm", **kw)
    theirs = JWHU(str(whu_root), gt_format="pfm", **kw)
    assert ours.samples == theirs.samples
    _batches_equal(ours.batches(2, shuffle=True), theirs.batches(2, shuffle=True))
    _batches_equal(ours.batches(1, shuffle=False), theirs.batches(1, shuffle=False))


@pytest.fixture
def bmvs_root(tmp_path, rng):
    import cv2

    H, W = 48, 64
    root = tmp_path / "bmvs"
    scan = root / "scan1"
    for sub in ["blended_images", "cams", "rendered_depth_maps"]:
        (scan / sub).mkdir(parents=True)
    (root / "index.txt").write_text("scan1\n")
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    for i in range(3):
        cv2.imwrite(str(scan / "blended_images" / f"{i:08d}.jpg"),
                    rng.integers(0, 255, (H, W, 3)).astype(np.uint8))
        T = random_pose(rng).T_cw
        with open(scan / "cams" / f"{i:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(str(T[r, c]) for c in range(4)) + "\n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(str(K[r, c]) for c in range(3)) + "\n")
            f.write("\n80.0 0.5 80 120.0\n")
        write_pfm(scan / "rendered_depth_maps" / f"{i:08d}.pfm",
                  rng.uniform(80, 120, (H, W)).astype(np.float32))
    with open(scan / "cams" / "pair.txt", "w") as f:
        f.write("2\n0\n2 1 100 2 80\n1\n2 0 90 2 70\n")
    return root


def test_blendedmvs_dataset_equals_the_jax_dataset(bmvs_root):
    from deep3d_aerial_tpu.train.dataset_whu import BlendedMVSDataset as JBMVS

    for kw in (dict(view_num=3), dict(view_num=3, max_h=32, max_w=48)):
        _batches_equal(BlendedMVSDataset(str(bmvs_root), **kw).batches(1, shuffle=False),
                       JBMVS(str(bmvs_root), **kw).batches(1, shuffle=False))


def test_pil_reads_the_arrays_cv2_reads(whu_root, bmvs_root):  # noqa: F811
    """The one deviation from the JAX module: PIL instead of cv2 for the
    views, the same uint8 RGB arrays on the fixtures' PNGs and JPGs."""
    import cv2

    paths = sorted((whu_root / "scene_a" / "images").glob("*.png")) \
        + sorted((bmvs_root / "scan1" / "blended_images").glob("*.jpg"))
    assert len(paths) == 7
    for p in paths:
        want = cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
        got = read_rgb(p)
        assert got.dtype == np.uint8 and np.array_equal(got, want), p.name


def _small_model():
    from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2
    from deep3d_aerial_tpu_torch.weights import init_random_weights

    holder = torch.nn.Module()
    holder.red0 = init_random_weights(RedStep2(8, up=True), seed=1)
    return holder


def test_checkpoints_names_latest_best_and_restore(tmp_path):
    model = _small_model()
    opt = make_optimizer(model.named_parameters(), 0.01, kind="adam")
    opt.step({n: torch.ones_like(p) for n, p in model.named_parameters()})
    d = tmp_path / "ck"
    d.mkdir()
    assert ckpt.latest_checkpoint(str(d)) is None
    p0 = ckpt.save_checkpoint(str(d), 0, model, opt, 1.23456)
    ckpt.save_checkpoint(str(d), 1, model, opt, 0.5)
    p2 = ckpt.save_checkpoint(str(d), 2, model, opt)
    assert os.path.basename(p0) == "model_000000_1.2346"
    assert sorted(os.listdir(d)) == ["model_000000_1.2346", "model_000001_0.5000",
                                     "model_000002"]
    assert sorted(os.listdir(p2)) == ["params.npz", "state.pt"]
    assert ckpt.latest_checkpoint(str(d)).endswith("model_000002")
    assert ckpt.best_checkpoint(str(d)).endswith("model_000001_0.5000")

    fresh = _small_model()
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    opt2 = make_optimizer(fresh.named_parameters(), 0.01, kind="adam")
    state = ckpt.restore_checkpoint(p2, fresh, opt2)
    assert state["epoch"] == 2 and opt2.count == 1
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n, t in getattr(opt, key).items():
            assert torch.equal(getattr(opt2, key)[n], t)

    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="export_params_npz"):
        ckpt.restore_checkpoint(str(orbax), fresh)


def test_params_npz_is_what_the_jax_package_reads(tmp_path):
    from deep3d_aerial_tpu.train.checkpoint import restore_params as jrestore
    from deep3d_aerial_tpu_torch.weights import state_dict_to_tree

    model = _small_model()
    path = ckpt.save_checkpoint(str(tmp_path), 0, model)
    tree = jrestore(os.path.join(path, "params.npz"))
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = state_dict_to_tree(model)
    assert set(flat) == set(want)
    for k in want:
        assert np.array_equal(flat[k], want[k]), k


def test_merge_matching_params_equals_the_jax_merge():
    from deep3d_aerial_tpu.train.checkpoint import merge_matching_params as jmerge

    init = {"feat": {"kernel": np.zeros((3, 3, 8, 8), np.float32)},
            "reg": {"kernel": np.zeros((3, 3, 48, 48), np.float32)},
            "new_head": {"bias": np.zeros((4,), np.float32)},
            "step": {"count": np.zeros((), np.int32)}}
    warm = {"feat": {"kernel": np.ones((3, 3, 8, 8), np.float64)},
            "reg": {"kernel": np.ones((3, 3, 16, 16), np.float32)},
            "old_head": {"bias": np.ones((2,), np.float32)},
            "step": {"count": np.ones((), np.float32)}}

    def flat(t):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    jm, jn, js, jskip = jmerge(init, warm)
    m, n, s, skip = ckpt.merge_matching_params(flat(init), flat(warm))
    assert (n, s, sorted(skip)) == (jn, js, sorted(jskip))
    for k, v in flat(jm).items():
        assert m[k].dtype == v.dtype and np.array_equal(m[k], v), k


def test_jax_trainer_resume_drops_the_optimizer_state(tmp_path):
    """A fault of the reference, recorded (ROADMAP C.8; the JAX package
    stays as it is): the JAX Trainer restores `opt_state` only when one is
    already initialised, and its CLI resumes before anything is, so a
    resumed JAX run has no optimizer state and its next step raises. The
    port's resume restores both (test_torch_train_step.py's CLI test)."""
    import flax.linen as fnn

    from deep3d_aerial_tpu.train.trainer import Trainer as JTrainer
    from deep3d_aerial_tpu.train.trainer import TrainerConfig as JConfig

    class Toy(fnn.Module):
        @fnn.compact
        def __call__(self, imgs, rel, dmin, dmax):
            w = self.param("w", fnn.initializers.constant(100.0), (4, 6))
            return {f"stage{s}": {"depth": w + imgs.mean()} for s in (1, 2, 3)}

    def batches():
        yield _toy_batch(101.0)

    kw = dict(ckpt_dir=str(tmp_path / "ck"), tb_logdir=None, pair_weight=0.0)
    JTrainer(Toy(), JConfig(epochs=1, **kw), steps_per_epoch=1).fit(batches)
    resumed = JTrainer(Toy(), JConfig(epochs=2, **kw), steps_per_epoch=1)
    assert resumed.resume() and resumed.params is not None
    assert resumed.opt_state is None
    with pytest.raises(TypeError):
        resumed.fit(batches)


@pytest.mark.parametrize("name", ["adamvs", "msrednet", "casmvsnet", "ucsnet"])
def test_state_dict_to_tree_round_trip_is_exact(name):
    """weights.state_dict_to_tree inverts tree_to_state_dict bit for bit
    (the train-step tests show that the JAX models read its keys and
    layouts)."""
    from deep3d_aerial_tpu_torch.models import build_model
    from deep3d_aerial_tpu_torch.weights import (
        init_random_weights,
        state_dict_to_tree,
        tree_to_state_dict,
    )

    model = init_random_weights(build_model(name, ndepths=(8, 8, 8), num_depth=32), seed=3)
    tree = state_dict_to_tree(model)
    assert all(k.startswith("['params']") for k in tree)
    back = tree_to_state_dict(model, tree)
    assert set(back) == set(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        assert torch.equal(back[n], p.detach()), n
    model.load_state_dict(back)
    again = state_dict_to_tree(model)
    for k, v in tree.items():
        assert np.array_equal(again[k], v), k
