"""The port's pipeline with `model_type: casmvsnet` and the default
`run_view_selection: True` (view selection from the COLMAP model, with
image paths from `--data_folder`, then dense matching + fusion on
device="cpu") against the JAX package's on one synthetic workspace, both
with the same seeded, perturbed CasMVSNet parameters (the repository holds
no trained CasMVSNet checkpoint), exported as the JAX package's `.npz`.
Normals are saved and fusion checks them (`normal_threshold` below 180).
Both pipelines then run the default mesh and DSM stages (graph-cut mesh
from the fused block's `.mvs` scene, Taubin refine, atlas texture, DSM from
the meshes), the JAX one with the port's native library set into its
bridge (tests/test_torch_mesh.py), so both run the same C++.

Tolerances, as for AdaMVS (tests/test_torch_pipeline.py): depth maps within
1e-3 x (depth_max - depth_min) of each view's range, confidence within
1e-4, the fused point count within 1%. A normal map is within 1e-5 of the
JAX normals_from_depth of the port's own depth map, and within 1e-4 of the
JAX pipeline's normal map, whose depth map differs by a few ulps.
The port's `.mvs` scene is byte-equal to what the JAX writer writes for
the port's own fused block; on the JAX workspace's dense/ and export/, the
port's mesh and DSM stages write the JAX files byte for byte. The port's
own end-to-end DSM (from its own fused points) is held against the JAX one
by the tolerance that `test_casmvsnet_end_to_end_dsm` derives.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.io.geotiff import read_geotiff
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
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from deep3d_aerial_tpu_torch.utils import native
from tests.test_pipeline import build_synthetic_workspace
from tests.test_torch_models import perturbed
from tests.test_torch_pipeline import CFG, _names

torch.set_num_threads(1)

CCFG = {**CFG, "model_type": "casmvsnet", "ndepths": [8, 8, 8],
        "run_view_selection": True, "save_normals": True,
        "normal_threshold": 60.0, "run_create_mesh": True, "run_create_dsm": True}
EXPORT_FILES = ("cameras.txt", "images.txt", "image_path.txt", "viewpair.txt",
                "blocks.txt", "scene_border.txt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX workspace, port workspace): each side selects the views from its
    copy of the COLMAP model, matches, fuses, meshes and rasterises the DSM;
    the port through its CLI. Each `.mvs` scene the port writes is also
    written by the JAX writer, from the same views and fused block, under
    `<root>/jax_mvs/`."""
    from deep3d_aerial_tpu.utils import native as jnative

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
    cfg_path = root / "cfg.yaml"
    PipelineConfig(**CCFG, pretrain_weight=npz).to_yaml(cfg_path)
    (root / "jax_mvs").mkdir()
    port_writer = AerialPipeline._write_mvs_scene

    def both_writers(path, views, fused):
        port_writer(path, views, fused)
        JPipeline._write_mvs_scene(root / "jax_mvs" / Path(path).name, views, fused)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", native.load_native())
        mp.setattr(jnative, "_TRIED", True)
        jpipe.run_dense()
        mp.setattr(AerialPipeline, "_write_mvs_scene", staticmethod(both_writers))
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


def _tree(ws, *dirs):
    return {str(p.relative_to(ws)): p.read_bytes() for d in dirs
            for p in sorted((ws / d).glob("*")) if p.is_file()}


def test_casmvsnet_mvs_scene_equals_the_jax_writers(runs):
    """scene_i.mvs of the port's fusion, byte for byte the JAX
    `_write_mvs_scene` of the port's own views and fused block; and it
    reads back with one vertex per fused point."""
    from deep3d_aerial_tpu_torch.io.mvs_interface import read_mvs

    _, tws = runs
    got = sorted((tws / "dense" / "fusion").glob("scene_*.mvs"))
    assert got and [p.name for p in got] == sorted(
        p.name for p in (tws.parent / "jax_mvs").iterdir())
    for p in got:
        assert p.read_bytes() == (tws.parent / "jax_mvs" / p.name).read_bytes()
        n = read_ply(p.with_suffix(".ply"))[0].shape[0]
        assert read_mvs(p).vertices.shape == (n, 3)


def test_casmvsnet_mesh_and_dsm_stages_on_the_jax_inputs(runs, tmp_path):
    """The port's create_mesh, create_dsm and move_production on a copy of
    the JAX workspace's dense/ and export/ write the JAX mesh/, dsm/ and
    production/ files byte for byte (graph-cut mesh, refine, atlas PNG,
    GeoTIFF, TFW)."""
    jws, _ = runs
    ws = tmp_path / "ws"
    for d in ("dense", "export"):
        shutil.copytree(jws / d, ws / d)
    pipe = AerialPipeline(str(ws), PipelineConfig(**CCFG), device="cpu")
    pipe.create_mesh()
    pipe.create_dsm()
    pipe.move_production()
    dirs = ("mesh", "dsm", "production/Mesh", "production/DSM")
    want = _tree(jws, *dirs)
    assert "dsm/dsm.tif" in want and "production/DSM/dsm.tfw" in want
    assert any(k.endswith("_mesh_refine_texture.png") for k in want)
    got = _tree(ws, *dirs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_casmvsnet_end_to_end_dsm(runs):
    """The port's own run, COLMAP model to production/DSM/dsm.tif through the
    CLI on the CPU, against the JAX run. The fused clouds agree in size
    within 1% (held above) and their points to a few ulps of the depth
    maps. The graph cut is not continuous in its input: on these
    near-coplanar terrain points such differences flip tetrahedra, and the
    two surfaces keep different faces, so a DSM cell under a flipped facet
    takes another facet's height. Every height of a DSM is
    interpolated between the vertices of its meshes, so it lies in their
    z-range, and two DSMs differ in a cell by at most the z-range of both
    sides' mesh vertices. So: the valid share within 1% of the cells; on
    cells valid on both sides every difference within that range, and the
    median difference within 5% of it (no offset of the whole surface)."""
    from deep3d_aerial_tpu.mesh.trimesh_io import read_mesh_ply

    jws, tws = runs
    for sub in ("Mesh", "DSM", "Point_Cloud"):
        assert list((tws / "production" / sub).iterdir()), sub
    t, origin, cell, nodata = read_geotiff(tws / "production" / "DSM" / "dsm.tif")
    j, jorigin, jcell, jnodata = read_geotiff(jws / "production" / "DSM" / "dsm.tif")
    assert t.shape == j.shape and (origin, cell, nodata) == (jorigin, jcell, jnodata)
    tv, jv = t != nodata, j != nodata
    assert jv.mean() > 0.3
    assert abs(tv.mean() - jv.mean()) <= 0.01, (tv.mean(), jv.mean())
    z = {side: np.concatenate([read_mesh_ply(p)[0][:, 2]
                               for p in (ws / "production" / "Mesh").glob("*.ply")])
         for side, ws in (("t", tws), ("j", jws))}
    assert z["t"].min() <= t[tv].min() and t[tv].max() <= z["t"].max()
    z_range = float(max(z["t"].max(), z["j"].max()) - min(z["t"].min(), z["j"].min()))
    dz = np.abs(t[tv & jv] - j[tv & jv])
    assert dz.max() <= z_range, (dz.max(), z_range)
    assert np.median(dz) <= 0.05 * z_range, (np.median(dz), z_range)
