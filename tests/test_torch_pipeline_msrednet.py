"""The port's pipeline with `model_type: msrednet` (dense matching + fusion,
device="cpu") against the JAX package's on one synthetic workspace, both
with the same seeded, perturbed MSREDNet parameters (the repository holds no
trained MSREDNet checkpoint), exported as the JAX package's `.npz`.

Tolerances, as for AdaMVS (tests/test_torch_pipeline.py): depth maps within
1e-3 x (depth_max - depth_min) of each view's range, confidence within
1e-4, the fused point count within 1%.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.io.pfm import read_pfm
from deep3d_aerial_tpu.io.ply import read_ply
from deep3d_aerial_tpu.models.msrednet import MSREDNet as JMSREDNet
from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu.train.checkpoint import export_params_npz
from deep3d_aerial_tpu_torch.io import text_formats as tf
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from tests.test_pipeline import build_synthetic_workspace
from tests.test_torch_models import perturbed
from tests.test_torch_pipeline import CFG, _names

torch.set_num_threads(1)

MCFG = {**CFG, "model_type": "msrednet", "ndepths": [4, 4, 4]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX workspace, port workspace): view selection by the JAX package,
    then dense matching + fusion by each side on its own copy."""
    root = tmp_path_factory.mktemp("msred")
    jws = build_synthetic_workspace(root / "jax")
    JPipeline(str(jws), JConfig(**MCFG)).select_view()
    tws = root / "torch"
    shutil.copytree(jws, tws)

    V, H, W = MCFG["view_num"], MCFG["image_h"], MCFG["image_w"]
    jmod = JMSREDNet(ndepths=tuple(MCFG["ndepths"]), num_depth=MCFG["num_depth"])
    params = jax.jit(jmod.init)(
        jax.random.PRNGKey(11), jnp.zeros((V, H, W, 3)),
        jnp.tile(jnp.eye(4), (3, V - 1, 1, 1)), 80.0, 120.0)
    _, params = perturbed(params, np.random.default_rng(91))
    npz = export_params_npz(params, str(root / "msred.npz"))
    jpipe = JPipeline(str(jws), JConfig(**MCFG, pretrain_weight=npz))
    jpipe.dense_match()
    jpipe.fuse_depth_map()
    AerialPipeline(str(tws), PipelineConfig(**MCFG, pretrain_weight=npz),
                   device="cpu").run_dense()
    return jws, tws


def test_msrednet_depth_and_confidence_maps(runs):
    jws, tws = runs
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


def test_msrednet_fused_point_count(runs):
    jws, tws = runs
    jply = sorted((jws / "dense" / "fusion").glob("scene_*.ply"))
    tply = sorted((tws / "dense" / "fusion").glob("scene_*.ply"))
    assert [p.name for p in tply] == [p.name for p in jply] and jply
    jn = sum(read_ply(p)[0].shape[0] for p in jply)
    tn = sum(read_ply(p)[0].shape[0] for p in tply)
    assert jn > 100
    assert abs(tn - jn) <= 0.01 * jn, (tn, jn)
