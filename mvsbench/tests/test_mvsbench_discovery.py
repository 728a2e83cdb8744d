"""The harness finds configurations, traffic, limits and metric readers by
the names in BENCHMARK.json, and a new file is found without an edit."""

import json

from mvsbench import core


def test_every_name_of_the_benchmark_has_its_files():
    bench = core.benchmark()
    for cfg in bench["configs"]:
        assert core.load("configs", cfg["name"])["model_type"]
    for wl in bench["workloads"]:
        assert core.load("traffic", wl["traffic"])["loop"] in core.LOOPS
        assert core.load("limits", wl["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(core.reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_cell_metrics_follow_the_workloads_keys():
    bench = core.benchmark()
    e2e = {m["name"] for m in core.cell_metrics(bench, "adamvs.train_whu", False)}
    assert e2e == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    per = {m["name"] for m in core.cell_metrics(bench, "msrednet.fullres", True)}
    assert "red_step4_roofline" in per and "red_step2_roofline" not in per


def test_a_new_file_is_found(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "newnet.json").write_text(json.dumps({"model_type": "adamvs"}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"loop": "infer"}))
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(rec):\n    return rec['window_s'] * 2\n")
    monkeypatch.setattr(core, "ROOT", tmp_path)
    assert core.load("configs", "newnet")["model_type"] == "adamvs"
    assert core.load("traffic", "burst")["loop"] == "infer"
    assert core.reader("new_metric.x")({"window_s": 3.0}) == 6.0
    bench = {"end_to_end": [], "per_layer": [{"name": "new_metric.x", "workloads": ["newnet.burst"]}]}
    assert [m["name"] for m in core.cell_metrics(bench, "newnet.burst", True)] == ["new_metric.x"]
    assert core.cell_metrics(bench, "adamvs.fullres", True) == []
