"""The pipeline's run modes and outputs beyond the default run, on the CPU
(device="cpu"), on the synthetic workspace and trained AdaMVS checkpoint of
tests/test_torch_pipeline.py, held against the JAX package:

- dense_match's multi-host arguments (view_filter, view_order,
  on_view_done), with `.dmap` and depth previews on: against the JAX
  dense_match with the same arguments, both driving a stub model that
  returns the same fixed maps, so that every file can be compared: the
  files written, their bytes (previews: decoded pixels), the callback order;
- batched inference (infer_batch_size 2): bit-equal to one map at a time,
  for AdaMVS and CasMVSNet; the `.dmap` byte-equal to what the JAX
  write_dmap writes from the JAX dataset's view with the same maps;
- the pipelined run (`run_dense_pipelined`, the CLI's `--pipelined`):
  every product byte-equal to run_dense's, and its fused point count within
  1% of the JAX fuse_depth_map's on the same maps (the rule of
  test_fused_point_count); the JAX pipelined run's duplicated points
  (ROADMAP C.9) and the JAX session's sticky missing views, each shown;
  a failure of either thread fails the run;
- the standalone fusion CLI, PLY and LAS, against the JAX CLI on the same
  depth maps: point counts within 1%, LAS within its 0.001 m scale of the
  PLY, the borders equal.

The JAX side runs no model forward here: the port's maps of one run_dense
are the input of every fusion comparison.
"""

import os
import runpy
import shutil
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import deep3d_aerial_tpu.models as jmodels
from deep3d_aerial_tpu.fusion.__main__ import main as jfusion_main
from deep3d_aerial_tpu.io import dmap as jdmap
from deep3d_aerial_tpu.io.ply import read_ply
from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.dataset import EvalDataset as JEvalDataset
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu.train.checkpoint import export_params_npz, restore_params
from deep3d_aerial_tpu_torch.fusion.__main__ import main as fusion_main
from deep3d_aerial_tpu_torch.io import dmap as tdmap
from deep3d_aerial_tpu_torch.io import text_formats as tf
from deep3d_aerial_tpu_torch.io.las import read_las
from deep3d_aerial_tpu_torch.io.pfm import read_pfm
from deep3d_aerial_tpu_torch.pipeline import orchestrator as orch
from deep3d_aerial_tpu_torch.pipeline.__main__ import main as port_main
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from tests.test_pipeline import build_synthetic_workspace
from tests.test_torch_pipeline import CFG, CKPT

torch.set_num_threads(1)

MVS = Path("dense") / "MVS"
FUSION = Path("dense") / "fusion"
# the fusion settings of CFG as the fusion CLIs take them
FUSION_ARGS = ["--fusion_num", "4", "--min_geo_consist_num", "2",
               "--photomatric_threshold", "0.0", "--position_threshold", "2.0",
               "--depth_threshold", "0.05", "--normal_threshold", "180.0"]


def _copy(src: Path, dst: Path, dirs=("export",)) -> Path:
    for d in dirs:
        shutil.copytree(src / d, dst / d)
    return dst


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """base: the synthetic workspace with the JAX view selection's export/;
    npz: the trained checkpoint as the port reads it; seq: the port's
    run_dense on a copy (one map at a time, normals saved)."""
    root = tmp_path_factory.mktemp("modes")
    base = build_synthetic_workspace(root / "base")
    JPipeline(str(base), JConfig(**CFG)).select_view()
    npz = export_params_npz(restore_params(CKPT), str(root / "w.npz"))
    seq = _copy(base, root / "seq")
    AerialPipeline(str(seq), PipelineConfig(**CFG, pretrain_weight=npz,
                                            save_normals=True),
                   device="cpu").run_dense()
    return SimpleNamespace(root=root, base=base, npz=npz, seq=seq)


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _assert_same_files(a: Path, b: Path, skip=()):
    fa, fb = _files(a), _files(b)
    assert fa == fb and fa, (a, sorted(set(fa) ^ set(fb)))
    for f in fa:
        if not f.endswith(skip):
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


# ---------------------------------------------------------------------------
# dense_match's arguments, .dmap and previews, against the JAX dense_match
# ---------------------------------------------------------------------------


def _stub_maps(H, W):
    rng = np.random.default_rng(21)
    depth = rng.uniform(95, 125, (H, W)).astype(np.float32)
    depth[5, 7] = np.nan  # zeroed by both pipelines, confidence with it
    conf = rng.uniform(0, 1, (H, W)).astype(np.float32)
    return depth, conf


class _JaxStub:
    """A model for the JAX dense_match: fixed depth and confidence maps."""

    def __init__(self, depth, conf):
        self.depth, self.conf = depth, conf

    def init(self, *args):
        return {}

    def apply(self, params, imgs, rel, dmin, dmax):
        import jax.numpy as jnp

        return {"depth": jnp.asarray(self.depth),
                "photometric_confidence": jnp.asarray(self.conf)}


class _TorchStub(torch.nn.Module):
    """The same maps for the port's dense_match; counts its calls."""

    def __init__(self, depth, conf, hook=None):
        super().__init__()
        self.depth, self.conf, self.hook, self.calls = depth, conf, hook, 0

    def forward(self, imgs, rel, dmin, dmax):
        self.calls += 1
        if self.hook is not None:
            self.hook(self.calls)
        return {"depth": torch.from_numpy(self.depth.copy()),
                "photometric_confidence": torch.from_numpy(self.conf.copy())}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("view_filter,view_order", [
    (None, None), ({3, 1, 7}, None), (None, [5, 2, 99]),
    ({2, 4, 6, 8}, [8, 99, 2]), ({42}, None),
])
def test_dense_match_arguments_dmap_and_previews_as_the_jax_package(
        ws, tmp_path, monkeypatch, batch, view_filter, view_order):
    # the JAX dense_match sizes its TPU sweep window from the survey unless
    # one is set, and sets the strict-coverage switch: restored afterwards
    monkeypatch.setenv("SWEEP_WIN", "32,256")
    monkeypatch.setenv("SWEEP_NR", "4")
    monkeypatch.setenv("SWEEP_STRICT", "0")
    depth, conf = _stub_maps(CFG["image_h"], CFG["image_w"])
    empty = view_filter == {42}

    def no_model(*a, **k):
        raise AssertionError("a model was built for an empty selection")

    monkeypatch.setattr(jmodels, "build_model",
                        no_model if empty else (lambda *a, **k: _JaxStub(depth, conf)))
    monkeypatch.setattr(AerialPipeline, "build_model", no_model)
    settings = dict(CFG, allow_random_weights=True, save_dmap=True,
                    display_depth=True, infer_batch_size=batch)
    jws, tws = _copy(ws.base, tmp_path / "j"), _copy(ws.base, tmp_path / "t")
    jdone, tdone = [], []
    JPipeline(str(jws), JConfig(**settings)).dense_match(
        view_filter=view_filter, on_view_done=jdone.append, view_order=view_order)
    tpipe = AerialPipeline(str(tws), PipelineConfig(**settings), device="cpu")
    stub = None if empty else _TorchStub(depth, conf)
    tpipe.dense_match(model=stub, view_filter=view_filter,
                      on_view_done=tdone.append, view_order=view_order)
    assert tdone == jdone
    if empty:
        assert tdone == [] and _files(tws / MVS) == [] and tpipe.map_seconds == []
        return
    want = [r for r, _ in tf.read_view_pairs(ws.base / "export" / "viewpair.txt")
            if view_filter is None or r in view_filter]
    if view_order is not None:
        rank = {v: i for i, v in enumerate(view_order)}
        want.sort(key=lambda r: rank.get(r, 1 << 30))
    assert tdone == want and stub.calls == len(want)  # no padding forward
    assert [len(b) for b in tpipe.map_batches] == \
        [min(batch, len(want) - i) for i in range(0, len(want), batch)]
    assert len(tpipe.map_seconds) == len(tpipe.map_batches)
    _assert_same_files(tws / MVS, jws / MVS, skip=(".png",))
    for f in _files(tws / MVS):
        if f.endswith(".png"):
            got = Image.open(tws / MVS / f)
            assert got.mode == "RGBA" and got.size == (CFG["image_w"], CFG["image_h"])
            assert np.array_equal(np.asarray(got),
                                  np.asarray(Image.open(jws / MVS / f).convert("RGBA"))), f


# ---------------------------------------------------------------------------
# batched inference
# ---------------------------------------------------------------------------


def test_batched_adamvs_is_bit_equal_and_its_dmap_is_the_jax_writers(ws, tmp_path):
    """infer_batch_size 2 against run_dense's one map at a time (ws.seq):
    the same PFM bytes; each .dmap is what the JAX write_dmap writes from the
    JAX dataset's view with these maps and the raw normals, which lie within
    a rounding of the stored [0, 1] ones."""
    tws = _copy(ws.base, tmp_path / "b2")
    pipe = AerialPipeline(str(tws), PipelineConfig(
        **CFG, pretrain_weight=ws.npz, save_normals=True, save_dmap=True,
        infer_batch_size=2), device="cpu")
    pipe.dense_match()
    names = sorted(f[:-len("_init.pfm")] for f in os.listdir(tws / MVS)
                   if f.endswith("_init.pfm"))
    assert len(names) == 9 and [len(b) for b in pipe.map_batches] == [2, 2, 2, 2, 1]
    for n in names:
        for suffix in ("_init.pfm", "_prob.pfm", "_normal.pfm", ".txt"):
            assert (tws / MVS / f"{n}{suffix}").read_bytes() == \
                (ws.seq / MVS / f"{n}{suffix}").read_bytes(), n + suffix
    jds = JEvalDataset(str(ws.base / "export"), view_num=CFG["view_num"],
                       num_depth=CFG["num_depth"])
    for i in range(len(jds)):
        s = jds.build(i)
        got = tdmap.read_dmap(tws / MVS / f"{s.ref_name}.dmap")
        depth = read_pfm(tws / MVS / f"{s.ref_name}_init.pfm")[0]
        conf = read_pfm(tws / MVS / f"{s.ref_name}_prob.pfm")[0]
        stored = read_pfm(tws / MVS / f"{s.ref_name}_normal.pfm")[0]
        assert np.array_equal(got.depth, depth) and np.array_equal(got.confidence, conf)
        assert np.abs(got.normal).max() <= 1.0
        np.testing.assert_allclose(got.normal, stored * 2.0 - 1.0, rtol=0, atol=1e-6)
        cam = s.ref_cam
        R = cam.T_cw[:3, :3]
        jdmap.write_dmap(tmp_path / "j.dmap", jdmap.DepthDataRaw(
            image_file_name=s.ref_image_path, neighbor_ids=list(s.src_ids),
            image_size=(cam.height, cam.width), K=cam.K, R=R,
            C=-R.T @ cam.T_cw[:3, 3], d_min=float(s.depth_min),
            d_max=float(s.depth_max), depth=depth, normal=got.normal,
            confidence=conf))
        assert (tmp_path / "j.dmap").read_bytes() == \
            (tws / MVS / f"{s.ref_name}.dmap").read_bytes(), s.ref_name
    # without save_normals the .dmap carries no normals (type flags 1 | 4)
    pipe.cfg.save_normals = False
    pipe.dense_match(view_filter={1})
    raw = (tws / MVS / "im_01.dmap").read_bytes()
    assert raw[2] == 5 and tdmap.read_dmap(tws / MVS / "im_01.dmap").normal is None


def test_batched_casmvsnet_is_bit_equal(ws, tmp_path):
    """A volume model (seeded random CasMVSNet weights): three maps at
    infer_batch_size 2 and at 1, through the multi-host view filter."""
    settings = dict(CFG, model_type="casmvsnet", ndepths=[8, 8, 8],
                    allow_random_weights=True, save_normals=True)
    runs = {}
    model = None
    for batch in (1, 2):
        tws = _copy(ws.base, tmp_path / f"b{batch}")
        pipe = AerialPipeline(str(tws), PipelineConfig(**settings, infer_batch_size=batch),
                              device="cpu")
        model = model or pipe.build_model()
        pipe.dense_match(model=model, view_filter={2, 5, 8})
        runs[batch] = tws
        assert [len(b) for b in pipe.map_batches] == ([1, 1, 1] if batch == 1 else [2, 1])
    _assert_same_files(runs[1] / MVS, runs[2] / MVS)
    assert len(_files(runs[1] / MVS)) == 3 * 4


# ---------------------------------------------------------------------------
# the pipelined run
# ---------------------------------------------------------------------------


def _three_blocks(export: Path):
    """Rewrite blocks.txt as three overlapping blocks whose refs share
    views, so that block 0 can be fused (fusion_num 2) before the last
    maps are written, while its .mvs lists every view."""
    (b0, _), (b1, _) = tf.read_blocks(export / "blocks.txt")
    whole = [min(b0[0], b1[0]), max(b0[1], b1[1])] + list(b0[2:])
    tf.write_blocks(export / "blocks.txt", [(b0, [1, 2, 4, 5]), (b1, [2, 3, 5, 6]),
                                            (whole, [4, 5, 6, 7, 8, 9])])


def test_pipelined_run_writes_what_run_dense_writes(ws, tmp_path, monkeypatch):
    """Three blocks sharing views, maps in batches of 2, .dmap, previews,
    mesh and DSM on. The last forward waits until the worker has started
    fusing block 0, so fusion overlaps dense matching; every file of every
    stage is byte-equal to run_dense's (one map at a time) on the same
    export (previews and .dmap aside, which run_dense does not write)."""
    settings = dict(CFG, pretrain_weight=ws.npz, fusion_num=2, save_normals=True,
                    run_create_mesh=True, run_create_dsm=True,
                    recons_decimate_ratio=0.2)
    seq, pip = _copy(ws.base, tmp_path / "seq"), _copy(ws.base, tmp_path / "pip")
    _three_blocks(seq / "export")
    _three_blocks(pip / "export")
    AerialPipeline(str(seq), PipelineConfig(**settings), device="cpu").run_dense()

    started = threading.Event()
    fuse = orch.FusionSession.fuse_block_index

    def fuse_block_index(self, bi):
        started.set()
        return fuse(self, bi)

    monkeypatch.setattr(orch.FusionSession, "fuse_block_index", fuse_block_index)
    pipe = AerialPipeline(str(pip), PipelineConfig(
        **settings, infer_batch_size=2, save_dmap=True, display_depth=True),
        device="cpu")
    model = pipe.build_model()
    calls = [0]

    class Gated(torch.nn.Module):
        def forward(self, *args):
            calls[0] += 1
            if calls[0] == 9:
                assert started.wait(120), "the worker did not start fusing"
            return model(*args)

    pipe.run_dense_pipelined(model=Gated())
    t = pipe.timeline
    assert t["first_block"] < t["last_map"] <= t["dense_done"] <= t["fusion_done"]
    assert set(pipe.stage_seconds) >= {"dense matching", "depth fusion", "mesh",
                                       "dsm", "wall"}
    extra = {f for f in _files(pip) if f.endswith((".dmap", ".png"))
             and not f.startswith("mesh")}
    assert len([f for f in extra if f.endswith(".dmap")]) == 9
    assert len([f for f in extra if f.endswith(".png")]) == 18
    for f in extra:
        (pip / f).unlink()
    (pip / MVS / "color").rmdir()
    assert any(f.endswith("_texture.ply") for f in _files(seq / "mesh"))
    assert len(_files(seq / FUSION)) == 9  # 3 blocks x (.ply, .txt, .mvs)
    _assert_same_files(seq, pip)


def test_pipelined_cli_point_count_within_one_percent_of_jax_fusion(ws, tmp_path,
                                                                    monkeypatch):
    """`python -m deep3d_aerial_tpu_torch --pipelined --device cpu` (the
    top-level alias) on a copy of the workspace: the fused PLYs are
    run_dense's (ws.seq), and their point count is within 1% of the JAX
    fuse_depth_map's on the same maps."""
    tws = _copy(ws.base, tmp_path / "cli")
    cfg = tmp_path / "cfg.yaml"
    PipelineConfig(**CFG, pretrain_weight=ws.npz, save_normals=True).to_yaml(cfg)
    monkeypatch.setattr(sys, "argv", ["deep3d_aerial_tpu_torch", "--workspace",
                                      str(tws), "--config", str(cfg),
                                      "--device", "cpu", "--pipelined"])
    ran = runpy.run_module("deep3d_aerial_tpu_torch", run_name="__main__")
    assert ran["main"] is port_main
    _assert_same_files(tws / FUSION, ws.seq / FUSION)
    jws = _copy(ws.seq, tmp_path / "jax", dirs=("export", "dense"))
    shutil.rmtree(jws / FUSION)
    JPipeline(str(jws), JConfig(**CFG)).fuse_depth_map()
    jn = sum(read_ply(p)[0].shape[0] for p in (jws / FUSION).glob("scene_*.ply"))
    tn = sum(read_ply(p)[0].shape[0] for p in (tws / FUSION).glob("scene_*.ply"))
    assert jn > 100 and abs(tn - jn) <= 0.01 * jn, (tn, jn)


def test_jax_pipelined_run_duplicates_points_across_blocks(ws, tmp_path):
    """ROADMAP C.9, a fault of the JAX package (not repaired there): its
    pipelined worker fuses each block in a fusion session of its own, so a
    later block re-emits what an earlier one consumed; on the same maps its
    clouds are not those of its own fuse_depth_map (one session)."""
    kw = dict(CFG, run_mvs=False)
    seq = _copy(ws.seq, tmp_path / "seq", dirs=("export", "dense"))
    pip = _copy(ws.seq, tmp_path / "pip", dirs=("export", "dense"))
    for d in (seq, pip):
        shutil.rmtree(d / FUSION)
    JPipeline(str(seq), JConfig(**kw)).fuse_depth_map()
    JPipeline(str(pip), JConfig(**kw)).run_dense_pipelined()
    blocks = tf.read_blocks(ws.base / "export" / "blocks.txt")
    assert len(blocks) == 2 and set(blocks[0][1]) & set(blocks[1][1])
    n = {d: [read_ply(d / FUSION / f"scene_{i}.ply")[0].shape[0] for i in range(2)]
         for d in (seq, pip)}
    # block 0 is fused alike; block 1 re-emits what block 0 consumed
    assert (seq / FUSION / "scene_0.ply").read_bytes() == \
        (pip / FUSION / "scene_0.ply").read_bytes()
    assert n[pip][1] > n[seq][1], n
    # the port's pipelined run on the same maps is the one-session result
    port = _copy(ws.seq, tmp_path / "port", dirs=("export", "dense"))
    shutil.rmtree(port / FUSION)
    AerialPipeline(str(port), PipelineConfig(**kw), device="cpu").run_dense_pipelined()
    _assert_same_files(port / FUSION, ws.seq / FUSION)


def test_a_view_written_after_a_blocks_probe_is_fused_as_a_later_blocks_ref(
        ws, tmp_path):
    """Block 0 is fused while im_05's map is not written yet; then it lands
    and block 1, whose ref it is, is fused. The port's session probes it
    again and fuses it as a ref; the JAX session remembers it as missing
    and skips it (its `_missing` is kept across blocks)."""
    refs = {}
    for side in ("port", "jax"):
        d = _copy(ws.seq, tmp_path / side, dirs=("export", "dense"))
        aside = tmp_path / f"{side}_aside"
        aside.mkdir()
        for f in (d / MVS).glob("im_05*"):
            shutil.move(f, aside / f.name)
        if side == "port":
            session = AerialPipeline(str(d), PipelineConfig(**CFG),
                                     device="cpu").fusion_session()
        else:
            session = JPipeline(str(d), JConfig(**CFG)).fusion_session()
        seen = refs[side] = []
        fuse_block = session.fusion.fuse_block

        def record(views, view_list, scene_range=None, fuse_block=fuse_block,
                   seen=seen):
            seen.append([r for r, _ in view_list])
            return fuse_block(views, view_list, scene_range=scene_range)

        session.fusion.fuse_block = record
        session.fuse_block_index(0)
        for f in aside.iterdir():
            shutil.move(f, d / MVS / f.name)
        session.fuse_block_index(1)
    assert "im_05" not in refs["port"][0] and "im_05" in refs["port"][1]
    assert "im_05" not in refs["jax"][0] and "im_05" not in refs["jax"][1]


def test_pipelined_run_under_thread_switches_at_every_bytecode(ws, tmp_path):
    """The worker and dense matching share the written-view set and the
    events that wake the worker: with the interpreter switching threads
    every microsecond and a stub model (maps written as fast as the files
    go), three pipelined runs in batches of 1, 2 and 3 each end within
    their time and fuse what run_dense fuses from the same maps."""
    depth, conf = _stub_maps(CFG["image_h"], CFG["image_w"])
    settings = dict(CFG, fusion_num=2, allow_random_weights=True)
    seq = _copy(ws.base, tmp_path / "seq")
    _three_blocks(seq / "export")
    AerialPipeline(str(seq), PipelineConfig(**settings), device="cpu").run_dense(
        model=_TorchStub(depth, conf))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for batch in (1, 2, 3):
            pip = _copy(ws.base, tmp_path / f"pip{batch}")
            _three_blocks(pip / "export")
            pipe = AerialPipeline(str(pip), PipelineConfig(
                **settings, infer_batch_size=batch), device="cpu")
            errors = []

            def run():
                try:
                    pipe.run_dense_pipelined(model=_TorchStub(depth, conf))
                except BaseException as e:  # reported below
                    errors.append(e)

            runner = threading.Thread(target=run)
            runner.start()
            runner.join(timeout=120)
            assert not runner.is_alive() and not errors, errors
            _assert_same_files(seq / FUSION, pip / FUSION)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("where", ["worker", "dense matching"])
def test_a_failure_of_either_thread_fails_the_pipelined_run(ws, tmp_path,
                                                            monkeypatch, where):
    tws = _copy(ws.base, tmp_path / "fail")
    _three_blocks(tws / "export")
    depth, conf = _stub_maps(CFG["image_h"], CFG["image_w"])
    if where == "worker":
        def boom(self, bi):
            raise RuntimeError("fusion failed")

        monkeypatch.setattr(orch.FusionSession, "fuse_block_index", boom)
        model = _TorchStub(depth, conf)
    else:
        def hook(calls):
            if calls == 4:
                raise RuntimeError("forward failed")

        model = _TorchStub(depth, conf, hook)
    pipe = AerialPipeline(str(tws), PipelineConfig(**dict(
        CFG, fusion_num=2, allow_random_weights=True)), device="cpu")
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="fusion failed|forward failed"):
        pipe.run_dense_pipelined(model=model)
    assert threading.active_count() == before  # the worker was joined
    assert not list((tws / "production").rglob("*.ply"))


# ---------------------------------------------------------------------------
# the standalone fusion CLI
# ---------------------------------------------------------------------------


def test_fusion_cli_ply_and_las_against_the_jax_cli(ws, tmp_path, monkeypatch):
    args = ["--project_folder", str(ws.base / "export"), "--mvs_path",
            str(ws.seq / MVS)] + FUSION_ARGS
    out = {}
    for fmt in ("ply", "las"):
        out["t", fmt] = tmp_path / f"t_{fmt}"
        out["j", fmt] = tmp_path / f"j_{fmt}"
        fusion_main(args + ["--output_path", str(out["t", fmt]), "--pc_format", fmt,
                            "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["fusion"] + args + [
            "--output_path", str(out["j", fmt]), "--pc_format", fmt])
        jfusion_main()
    names = [f"scene_{i}" for i in range(2)]
    total = 0
    for side in ("t", "j"):
        for fmt in ("ply", "las"):
            assert _files(out[side, fmt]) == sorted(
                f"{n}.{e}" for n in names for e in (fmt, "txt"))
    for n in names:
        tp = read_ply(out["t", "ply"] / f"{n}.ply")[0]
        jp = read_ply(out["j", "ply"] / f"{n}.ply")[0]
        tl, tc, _ = read_las(out["t", "las"] / f"{n}.las")
        assert abs(len(tp) - len(jp)) <= 0.01 * len(jp), (n, len(tp), len(jp))
        total += len(jp)
        assert len(tl) == len(tp) and tc is not None
        # mm storage: the rounding of (x - offset) / 0.001, plus float32's
        assert np.all(np.abs(tl - tp) <= 0.0005 + 1e-6 * np.abs(tp))
        assert len(read_las(out["j", "las"] / f"{n}.las")[0]) == len(jp)
        for fmt in ("ply", "las"):
            assert (out["t", fmt] / f"{n}.txt").read_bytes() == \
                (out["j", "ply"] / f"{n}.txt").read_bytes()
    # block 1's refs are all block 0's, whose points it consumed
    assert total > 100
