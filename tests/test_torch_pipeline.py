"""The port's pipeline (dense matching + fusion, device="cpu") against the
JAX package's on one synthetic workspace, with the in-repo trained AdaMVS
checkpoint on both sides (ndepths 16/8/8, num_depth 64, as it requires).

Tolerances: depth maps within 1e-3 x (depth_max - depth_min) of each
view's range and confidence within 1e-4, as for the model forward; the
fused point count within 1%, since a pixel whose depth moved by that much
can cross a consistency threshold. With compute_dtype bfloat16, each
view's depth map within 2x the JAX pipeline's own bfloat16-vs-float32
distance (per map, on the same workspace and checkpoint) of the JAX
pipeline's bfloat16 map, and each confidence map within the same plus 2
bfloat16 ulps of its largest value: the rule of
tests/test_torch_bf16_models.py.
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
from tests.test_torch_bf16_blocks import bf16_ulps

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


def test_dense_match_in_bfloat16_against_the_jax_pipeline(runs, tmp_path):
    """compute_dtype bfloat16: the JAX pipeline's dense_match and the
    port's (device cpu, then fusion) on copies of the workspace; every
    view's PFMs within 2x the JAX pipeline's own bfloat16-vs-float32
    distance (its float32 maps from `runs`) of the JAX bfloat16 maps, the
    confidence (prob) maps plus 2 bfloat16 ulps of their largest value, as
    in test_torch_bf16_models.py. Readings on the CPU (max|P - J| over its
    bound): depth up to 0.60 (im_01), confidence up to 0.69 (im_07; 0.98
    without the 2 ulps)."""
    jws, tws, tpipe = runs
    jb, tb = tmp_path / "jax_bf16", tmp_path / "port_bf16"
    shutil.copytree(jws / "export", jb / "export")
    shutil.copytree(tws / "export", tb / "export")
    JPipeline(str(jb), JConfig(**CFG, pretrain_weight=CKPT,
                               compute_dtype="bfloat16")).dense_match()
    pipe = AerialPipeline(str(tb), PipelineConfig(
        **CFG, pretrain_weight=tpipe.cfg.pretrain_weight, compute_dtype="bfloat16"),
        device="cpu")
    pipe.dense_match()
    pipe.fuse_depth_map()
    assert list((tb / "dense" / "fusion").glob("scene_*.ply"))
    names = _names(jws)
    assert _names(jb) == _names(tb) == names
    for n in names:
        for kind in ("init", "prob"):
            f = f"{n}_{kind}.pfm"
            p, j = (read_pfm(w / "dense" / "MVS" / f)[0] for w in (tb, jb))
            j32 = read_pfm(jws / "dense" / "MVS" / f)[0]
            assert p.dtype == np.float32 and np.isfinite(p).all()
            gap = np.abs(j - j32).max()
            floor = bf16_ulps(np.abs(j).max()) if kind == "prob" else 0.0
            assert np.abs(p - j).max() <= 2 * gap + floor, (f, np.abs(p - j).max(), gap, floor)


def test_config_copy_parses_like_the_jax_package(tmp_path):
    path = tmp_path / "cfg.yaml"
    JConfig(**CFG).to_yaml(path)
    assert dataclasses.asdict(PipelineConfig.from_yaml(path)) == \
        dataclasses.asdict(JConfig.from_yaml(path))


# a value other than the default for every field from_yaml reads
NON_DEFAULT = dict(
    fext=".jpg", cams_ori="XrightYdown", rotation_ori="Rcw", translation_ori="tcw",
    image_w=640, image_h=480, image_scale=0.25,
    run_view_selection=False, view_selection_mode="sparse_points",
    scene_block_size=[10.0, 20.0, 30.0], block_overlap=1.5,
    bbx_border_scene=[0.0, 1.0, 2.0, 3.0],
    run_mvs=False, view_num=3, num_depth=128, min_interval=0.5,
    model_type="msrednet", ndepths=[16, 8, 4], depth_ratios=[4.0, 8.0, 3.0],
    pretrain_weight="w.npz", allow_random_weights=True, display_depth=True,
    warp_precision="compensated", save_normals=True, save_dmap=True,
    warp_impl="xla", red_impl="flax", compute_dtype="bfloat16",
    infer_batch_size=2, strict_coverage=True,
    run_depth_fusion=False, fusion_num=5, geo_consist_num=3,
    photomatric_threshold=0.3, position_threshold=2.0, depth_threshold=0.02,
    normal_threshold=45.0, pc_format="las",
    run_create_mesh=False, mesh_method="2.5d", recons_insert_distance=2.5,
    recons_decimate_ratio=0.5, refine_decimate_ratio=0.5,
    texture_decimate_ratio=0.5, refine_scale_times=2, refine_photometric=True,
    texture_atlas=False, mesh_config="mesh.yaml",
    run_create_dsm=False, dsm_source="pointcloud", pc_select_method="Robust_Min",
    pc_interpolation_method="idw", dsm_uint=[0.5, 0.5], dsm_size=[100, 200],
    bbx_border_dsm=[4.0, 5.0, 6.0, 7.0],
)


def test_config_round_trips_every_field(tmp_path):
    """to_yaml writes every field from_yaml reads (DENSEMATCH's
    depth_ratios, warp_impl, red_impl, infer_batch_size and
    strict_coverage included), so a config comes back equal."""
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    assert set(NON_DEFAULT) == fields
    default = PipelineConfig()
    for name, value in NON_DEFAULT.items():
        assert getattr(default, name) != value, name
    cfg = PipelineConfig(**NON_DEFAULT)
    cfg.to_yaml(tmp_path / "cfg.yaml")
    assert dataclasses.asdict(PipelineConfig.from_yaml(tmp_path / "cfg.yaml")) == \
        dataclasses.asdict(cfg)


@pytest.mark.parametrize("setting,error", [
    ({"compute_dtype": "float16"}, ValueError),
    ({"warp_precision": "float64"}, ValueError),
    ({"warp_impl": "xla"}, ValueError),
    ({"red_impl": "flax"}, ValueError),
    ({"strict_coverage": True}, ValueError),
    ({"model_type": "mvsnet"}, ValueError),
])
def test_dense_setting_the_port_does_not_run_raises(tmp_path, setting, error):
    """Refused before any work (the workspace's export/ is empty)."""
    pipe = AerialPipeline(str(tmp_path), PipelineConfig(**{**CFG, **setting}),
                          device="cpu")
    with pytest.raises(error):
        pipe.dense_match()
    with pytest.raises(error):
        pipe.build_model()
