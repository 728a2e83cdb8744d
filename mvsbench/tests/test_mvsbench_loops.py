"""The inference and training loops end to end on the CPU at a tiny shape,
with the port's plain paths standing in for the kernels; and each fault
the cells can have, planted under the timed path, turns `correct` false."""

import pytest
import torch

from mvsbench import core, run

SEED = 2 ** 31 + 12345
TINY_INFER = {"config": {"image_w": 96, "image_h": 64}, "model": {"ndepths": [8, 8, 4]},
              "traffic": {"pool": 3, "check_maps": 2, "warm": 1}}
TINY_TRAIN = {"model": {"ndepths": [8, 8, 4]}, "traffic": {"frame": [64, 96]}}


def cpu_run(cell, overrides, seconds=1.0):
    return core.run(cell, SEED, seconds, False, device="cpu", overrides=overrides)


@pytest.mark.parametrize("cell", ["adamvs.fullres", "msrednet.fullres"])
def test_an_inference_cell_runs_and_is_correct(cell):
    res, readings = cpu_run(cell, TINY_INFER)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"maps_per_s", "map_p90_s", "setup_s"}  # no card: no peak
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(core.load("limits", cell))
    assert readings["depth_gap"] < 1e-6 and readings["conf_gap"] < 1e-6


def test_the_training_cell_runs_and_is_correct():
    res, readings = cpu_run("adamvs.train_whu", TINY_TRAIN)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert readings["loss_gap"] < 1e-5


def test_the_same_seed_gives_the_same_inputs():
    from mvsbench import survey
    from mvsbench.weights import seeded

    def frames(seed):
        sv = survey.survey(96, 64, 3, 2, seed)
        return sv, [survey.render(sv, v, "cpu")[0] for v in range(6)]
    (a, fa), (b, fb), (c, fc) = frames(SEED), frames(SEED), frames(SEED + 1)
    assert (a.centers == b.centers).all() and all((x == y).all() for x, y in zip(fa, fb))
    assert not all((x == y).all() for x, y in zip(fa, fc))
    shapes = {"w.conv.weight": (4, 3, 3, 3), "w.norm.weight": (4,), "w.conv.bias": (4,)}
    wa, wb = seeded(shapes, SEED, "cpu"), seeded(shapes, SEED, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in shapes)
    assert not torch.equal(wa["w.conv.weight"], seeded(shapes, SEED + 1, "cpu")["w.conv.weight"])


@pytest.mark.parametrize("cell", ["adamvs.fullres", "msrednet.fullres"])
def test_an_answer_altered_where_it_is_produced_fails(cell, monkeypatch):
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    infer = AerialPipeline._infer_batch

    def altered(self, model, samples):
        depth, conf, normals, n_bad = infer(self, model, samples)
        depth[:, 5, 7] += 0.5
        return depth, conf, normals, n_bad
    monkeypatch.setattr(AerialPipeline, "_infer_batch", altered)
    res, readings = cpu_run(cell, TINY_INFER)
    assert not res["correct"] and readings["depth_gap"] > 0.01


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from deep3d_aerial_tpu_torch.train.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, grads: None)
    res, readings = cpu_run("adamvs.train_whu", TINY_TRAIN)
    assert not res["correct"] and readings["change_gap"] == pytest.approx(1.0)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for machines without one")
    assert run.main(["--workload", "adamvs.fullres", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
