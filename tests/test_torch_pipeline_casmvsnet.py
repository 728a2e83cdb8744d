"""The port's pipeline with `model_type: casmvsnet` and the default
`run_view_selection: True` (view selection from the COLMAP model, with
image paths from `--data_folder`, then dense matching + fusion on
device="cpu") against the JAX package's on one synthetic workspace, both
with the same seeded, perturbed CasMVSNet parameters (the repository holds
no trained CasMVSNet checkpoint), exported as the JAX package's `.npz`.
Normals are saved and fusion checks them (`normal_threshold` below 180).

Tolerances, as for AdaMVS (tests/test_torch_pipeline.py): depth maps within
1e-3 x (depth_max - depth_min) of each view's range, confidence within
1e-4, the fused point count within 1%. A normal map is within 1e-5 of the
JAX normals_from_depth of the port's own depth map, and within 1e-4 of the
JAX pipeline's normal map, whose depth map differs by a few ulps.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.io.pfm import read_pfm
from deep3d_aerial_tpu.io.ply import read_ply
from deep3d_aerial_tpu.models.casmvsnet import CasMVSNet as JCasMVSNet
from deep3d_aerial_tpu.ops.normals import normals_from_depth as jnormals_from_depth
from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu.train.checkpoint import export_params_npz
from deep3d_aerial_tpu_torch.io import text_formats as tf
from deep3d_aerial_tpu_torch.pipeline.__main__ import main as port_main
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from tests.test_pipeline import build_synthetic_workspace
from tests.test_torch_models import perturbed
from tests.test_torch_pipeline import CFG, _names

torch.set_num_threads(1)

CCFG = {**CFG, "model_type": "casmvsnet", "ndepths": [8, 8, 8],
        "run_view_selection": True, "save_normals": True,
        "normal_threshold": 60.0}
EXPORT_FILES = ("cameras.txt", "images.txt", "image_path.txt", "viewpair.txt",
                "blocks.txt", "scene_border.txt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX workspace, port workspace): each side selects the views from its
    copy of the COLMAP model, matches and fuses; the port through its CLI."""
    root = tmp_path_factory.mktemp("cas")
    src = build_synthetic_workspace(root / "src")
    images = str(src / "images")
    jws, tws = root / "jax", root / "torch"
    for ws in (jws, tws):
        shutil.copytree(src / "sparse", ws / "sparse")

    V, H, W = CCFG["view_num"], CCFG["image_h"], CCFG["image_w"]
    jmod = JCasMVSNet(ndepths=tuple(CCFG["ndepths"]), num_depth=CCFG["num_depth"])
    params = jax.jit(jmod.init)(
        jax.random.PRNGKey(12), jnp.zeros((V, H, W, 3)),
        jnp.tile(jnp.eye(4), (3, V - 1, 1, 1)), 80.0, 120.0)
    _, params = perturbed(params, np.random.default_rng(92))
    npz = export_params_npz(params, str(root / "cas.npz"))
    jpipe = JPipeline(str(jws), JConfig(**CCFG, pretrain_weight=npz),
                      data_folder=images)
    jpipe.select_view()
    jpipe.dense_match()
    jpipe.fuse_depth_map()
    cfg_path = root / "cfg.yaml"
    PipelineConfig(**CCFG, pretrain_weight=npz).to_yaml(cfg_path)
    port_main(["--workspace", str(tws), "--config", str(cfg_path),
               "--data_folder", images, "--device", "cpu"])
    return jws, tws


def test_casmvsnet_view_selection_export(runs):
    jws, tws = runs
    for n in EXPORT_FILES:
        assert (tws / "export" / n).read_bytes() == (jws / "export" / n).read_bytes(), n


def test_casmvsnet_depth_confidence_and_normal_maps(runs):
    """Every selected reference view has a depth map, equal to the JAX
    pipeline's, and so do its confidence and normal maps."""
    jws, tws = runs
    refs = [r for r, _ in tf.read_view_pairs(tws / "export" / "viewpair.txt")]
    names = _names(jws)
    assert len(names) == len(refs) >= 4 and _names(tws) == names
    for n in names:
        cam = tf.read_mvs_cam(tws / "dense" / "MVS" / f"{n}.txt")
        tol = 1e-3 * (cam.depth_max - cam.depth_min)
        mvs = {side: ws / "dense" / "MVS" for side, ws in (("j", jws), ("t", tws))}
        td = read_pfm(mvs["t"] / f"{n}_init.pfm")[0]
        assert td.shape == (64, 96) and np.isfinite(td).all()
        np.testing.assert_allclose(td, read_pfm(mvs["j"] / f"{n}_init.pfm")[0],
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(read_pfm(mvs["t"] / f"{n}_prob.pfm")[0],
                                   read_pfm(mvs["j"] / f"{n}_prob.pfm")[0],
                                   rtol=0, atol=1e-4)
        tn = read_pfm(mvs["t"] / f"{n}_normal.pfm")[0]
        assert tn.shape == (64, 96, 3)
        # the port's normal file is the JAX function of the port's depth map
        want = (np.asarray(jnormals_from_depth(
            jnp.asarray(td), jnp.asarray(np.linalg.inv(cam.K).astype(np.float32))))
            + 1.0) * 0.5
        np.testing.assert_allclose(tn, want, rtol=0, atol=1e-5)
        # and near the JAX pipeline's: the two depth maps differ by a few
        # ulps (6.1e-5 m at most on this workspace), which the normals'
        # central differences over ~1 m pixels turn into up to 2.5e-5
        np.testing.assert_allclose(tn, read_pfm(mvs["j"] / f"{n}_normal.pfm")[0],
                                   rtol=0, atol=1e-4)


def test_casmvsnet_fused_point_count(runs):
    jws, tws = runs
    jply = sorted((jws / "dense" / "fusion").glob("scene_*.ply"))
    tply = sorted((tws / "dense" / "fusion").glob("scene_*.ply"))
    assert [p.name for p in tply] == [p.name for p in jply] and jply
    jn = sum(read_ply(p)[0].shape[0] for p in jply)
    tn = sum(read_ply(p)[0].shape[0] for p in tply)
    assert jn > 100
    assert abs(tn - jn) <= 0.01 * jn, (tn, jn)
    assert any((tws / "production" / "Point_Cloud").iterdir())
