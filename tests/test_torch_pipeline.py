"""The port's pipeline (dense matching + fusion, device="cpu") against the
JAX package's on one synthetic workspace, with the in-repo trained AdaMVS
checkpoint on both sides (ndepths 16/8/8, num_depth 64, as it requires).

Tolerances: depth maps within 1e-3 x (depth_max - depth_min) of each
view's range and confidence within 1e-4, as for the model forward; the
fused point count within 1%, since a pixel whose depth moved by that much
can cross a consistency threshold.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.io.pfm import read_pfm
from deep3d_aerial_tpu.io.ply import read_ply
from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu.train.checkpoint import export_params_npz, restore_params
from deep3d_aerial_tpu_torch.io import text_formats as tf
from deep3d_aerial_tpu_torch.pipeline.__main__ import main as port_main
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from tests.test_pipeline import build_synthetic_workspace

torch.set_num_threads(1)

CKPT = "checkpoints/synthetic_adamvs/model_000021_1.1435"

CFG = dict(
    image_w=96, image_h=64, image_scale=1.0,
    scene_block_size=[40.0, 40.0, 120.0], block_overlap=2.0,
    view_num=3, num_depth=64, ndepths=[16, 8, 8], model_type="adamvs",
    fusion_num=4, geo_consist_num=2, photomatric_threshold=0.0,
    position_threshold=2.0, depth_threshold=0.05, normal_threshold=180.0,
    run_view_selection=False, run_create_mesh=False, run_create_dsm=False,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX workspace, port workspace, port pipeline): view selection by
    the JAX package, then dense matching + fusion by each side on its own
    copy of the workspace."""
    root = tmp_path_factory.mktemp("ports")
    jws = build_synthetic_workspace(root / "jax")
    JPipeline(str(jws), JConfig(**CFG)).select_view()
    tws = root / "torch"
    shutil.copytree(jws, tws)

    npz = export_params_npz(restore_params(CKPT), str(root / "w.npz"))
    jpipe = JPipeline(str(jws), JConfig(**CFG, pretrain_weight=CKPT))
    jpipe.dense_match()
    jpipe.fuse_depth_map()
    tpipe = AerialPipeline(str(tws), PipelineConfig(**CFG, pretrain_weight=npz),
                           device="cpu")
    tpipe.run_dense()
    return jws, tws, tpipe


def _names(ws):
    mvs = ws / "dense" / "MVS"
    return sorted(f[:-len("_init.pfm")] for f in os.listdir(mvs)
                  if f.endswith("_init.pfm"))


def test_depth_and_confidence_maps(runs):
    jws, tws, _ = runs
    names = _names(jws)
    assert len(names) >= 4 and _names(tws) == names
    for n in names:
        cam = tf.read_mvs_cam(tws / "dense" / "MVS" / f"{n}.txt")
        tol = 1e-3 * (cam.depth_max - cam.depth_min)
        jd = read_pfm(jws / "dense" / "MVS" / f"{n}_init.pfm")[0]
        td = read_pfm(tws / "dense" / "MVS" / f"{n}_init.pfm")[0]
        assert td.shape == (64, 96) and np.isfinite(td).all()
        np.testing.assert_allclose(td, jd, rtol=0, atol=tol)
        jp = read_pfm(jws / "dense" / "MVS" / f"{n}_prob.pfm")[0]
        tp = read_pfm(tws / "dense" / "MVS" / f"{n}_prob.pfm")[0]
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)


def test_fused_point_count(runs):
    jws, tws, _ = runs
    jply = sorted((jws / "dense" / "fusion").glob("scene_*.ply"))
    tply = sorted((tws / "dense" / "fusion").glob("scene_*.ply"))
    assert [p.name for p in tply] == [p.name for p in jply] and jply
    jn = sum(read_ply(p)[0].shape[0] for p in jply)
    tn = sum(read_ply(p)[0].shape[0] for p in tply)
    assert jn > 100
    assert abs(tn - jn) <= 0.01 * jn, (tn, jn)
    assert any((tws / "production" / "Point_Cloud").iterdir())


def test_cli_on_the_cpu(runs, tmp_path):
    """python -m deep3d_aerial_tpu_torch.pipeline --device cpu, in-process,
    on a fresh copy of the port's workspace; same depth maps."""
    _, tws, tpipe = runs
    ws = tmp_path / "cli"
    shutil.copytree(tws / "export", ws / "export")
    cfg_path = tmp_path / "cfg.yaml"
    tpipe.cfg.to_yaml(cfg_path)
    port_main(["--workspace", str(ws), "--config", str(cfg_path),
               "--device", "cpu"])
    n = _names(tws)[0]
    np.testing.assert_array_equal(
        read_pfm(ws / "dense" / "MVS" / f"{n}_init.pfm")[0],
        read_pfm(tws / "dense" / "MVS" / f"{n}_init.pfm")[0])
    assert list((ws / "dense" / "fusion").glob("scene_*.ply"))


def test_config_copy_parses_like_the_jax_package(tmp_path):
    path = tmp_path / "cfg.yaml"
    JConfig(**CFG).to_yaml(path)
    assert dataclasses.asdict(PipelineConfig.from_yaml(path)) == \
        dataclasses.asdict(JConfig.from_yaml(path))


@pytest.mark.parametrize("switch,method", [
    ("run_view_selection", "select_view"),
    ("run_create_mesh", "create_mesh"),
    ("run_create_dsm", "create_dsm"),
])
def test_unported_stage_raises(tmp_path, switch, method):
    pipe = AerialPipeline(str(tmp_path), PipelineConfig(**{**CFG, switch: True}),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(pipe, method)()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.run_dense()


@pytest.mark.parametrize("setting,error", [
    ({"display_depth": True}, NotImplementedError),
    ({"infer_batch_size": 8}, NotImplementedError),
    ({"save_dmap": True}, NotImplementedError),
    ({"compute_dtype": "bfloat16"}, NotImplementedError),
    ({"warp_precision": "compensated"}, NotImplementedError),
    ({"warp_impl": "xla"}, ValueError),
    ({"red_impl": "flax"}, ValueError),
    ({"strict_coverage": True}, ValueError),
])
def test_dense_setting_the_port_does_not_run_raises(tmp_path, setting, error):
    """Refused before any work (the workspace's export/ is empty); an
    unported setting names its ROADMAP item."""
    pipe = AerialPipeline(str(tmp_path), PipelineConfig(**{**CFG, **setting}),
                          device="cpu")
    match = "ROADMAP" if error is NotImplementedError else None
    with pytest.raises(error, match=match):
        pipe.dense_match()
    with pytest.raises(error, match=match):
        pipe.build_model()
