"""The port's COLMAP ingest and view selection (`deep3d_aerial_tpu_torch.sparse`,
copies of the JAX package's host numpy modules, and the pipeline's
`select_view`) against the JAX package's, on the synthetic models of
tests/test_sparse.py and tests/test_pipeline.py: the same files byte for
byte, the same selections exactly."""

import sqlite3

import numpy as np
import pytest

from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu.sparse import colmap as jcolmap
from deep3d_aerial_tpu.sparse import view_selection as jview_selection
from deep3d_aerial_tpu.sparse.export import export_predef as jexport_predef
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from deep3d_aerial_tpu_torch.sparse import colmap, view_selection
from deep3d_aerial_tpu_torch.sparse.export import export_predef
from tests.test_pipeline import build_synthetic_workspace
from tests.test_sparse import synthetic_model
from tests.test_torch_pipeline import CFG

EXPORT_FILES = ("cameras.txt", "images.txt", "image_path.txt", "viewpair.txt",
                "blocks.txt", "scene_border.txt")


def _same_model(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert set(ca) == set(cb) and set(ia) == set(ib) and set(pa) == set(pb)
    for k in ca:
        assert (ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].name, ia[k].camera_id) == (ib[k].name, ib[k].camera_id)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f), getattr(ib[k], f))
    for k in pa:
        for f in ("xyz", "rgb", "error", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(pa[k], f), getattr(pb[k], f))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_binary_round_trip_read_by_both(tmp_path, rng, writer):
    """A model written by one package reads back the same through both."""
    model = synthetic_model(rng)
    (colmap if writer == "port" else jcolmap).write_model(*model, tmp_path)
    ours, theirs = colmap.read_model(str(tmp_path)), jcolmap.read_model(str(tmp_path))
    _same_model(ours, model)
    _same_model(ours, theirs)


def _database(path, images, rng):
    """A COLMAP database.db with a matches table: random match counts for
    each image pair (one pair empty)."""
    ids = sorted(images)
    with sqlite3.connect(path) as conn:
        conn.execute("CREATE TABLE matches (pair_id INTEGER PRIMARY KEY, "
                     "rows INTEGER, cols INTEGER, data BLOB)")
        for a in ids:
            for b in ids:
                if a >= b:
                    continue
                n = 0 if (a, b) == (ids[0], ids[1]) else int(rng.integers(5, 200))
                data = rng.integers(0, 1000, size=(n, 2)).astype(np.uint32)
                conn.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                             (colmap.image_ids_to_pair_id(a, b), n, 2,
                              data.tobytes()))


@pytest.mark.parametrize("mode", ["triangulated_points", "tie_points"])
def test_export_and_view_selection_equal_the_jax_package(tmp_path, rng, mode):
    model = synthetic_model(rng, n_images=10, n_points=800)
    jcolmap.write_model(*model, tmp_path)
    db = tmp_path / "database.db"
    _database(db, model[1], rng)

    cams, predef = export_predef(str(tmp_path), str(tmp_path / "port"))
    jcams, jpredef = jexport_predef(str(tmp_path), str(tmp_path / "jax"))
    for name in ("cameras.txt", "images.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert sorted(predef) == sorted(jpredef)
    for iid in predef:
        assert (predef[iid].depth_min, predef[iid].depth_max) == \
            (jpredef[iid].depth_min, jpredef[iid].depth_max)

    xyz = np.stack([p.xyz for p in model[2].values()])
    blocks, border = view_selection.compute_scene_blocks(
        xyz, block_size=[40, 40], overlap=2.0)
    jblocks, jborder = jview_selection.compute_scene_blocks(
        xyz, block_size=[40, 40], overlap=2.0)
    assert blocks == jblocks and list(border) == list(jborder)
    got = view_selection.select_views(str(tmp_path), blocks, mode=mode,
                                      database_path=str(db))
    want = jview_selection.select_views(str(tmp_path), blocks, mode=mode,
                                        database_path=str(db))
    assert got == want
    assert got[1]  # some reference view was selected


def test_select_view_writes_the_jax_pipelines_export(tmp_path):
    """The port's AerialPipeline.select_view, from the COLMAP model and the
    image folder (image_path.txt built from `data_folder`), writes export/
    files equal to the JAX pipeline's on the same model."""
    src = build_synthetic_workspace(tmp_path / "src")
    out = {}
    for side, pipe_cls, cfg_cls, kw in (
            ("jax", JPipeline, JConfig, {}),
            ("port", AerialPipeline, PipelineConfig, {"device": "cpu"})):
        ws = tmp_path / side
        (ws / "sparse").mkdir(parents=True)
        for f in (src / "sparse").iterdir():
            (ws / "sparse" / f.name).write_bytes(f.read_bytes())
        pipe_cls(str(ws), cfg_cls(**CFG), data_folder=str(src / "images"),
                 **kw).select_view()
        out[side] = {n: (ws / "export" / n).read_bytes() for n in EXPORT_FILES}
    assert out["port"] == out["jax"]
    assert out["port"]["viewpair.txt"].strip() and out["port"]["blocks.txt"].strip()
    assert str(src / "images").encode() in out["port"]["image_path.txt"]


def test_select_view_keeps_an_existing_image_path_file(tmp_path):
    """An image_path.txt that is already there is not rewritten from the
    data folder."""
    src = build_synthetic_workspace(tmp_path / "src")
    (src / "export").mkdir(exist_ok=True)
    (src / "export" / "image_path.txt").write_text("kept\n")
    AerialPipeline(str(src), PipelineConfig(**CFG), device="cpu",
                   data_folder=str(src / "images")).select_view()
    assert (src / "export" / "image_path.txt").read_text() == "kept\n"
    assert (src / "export" / "viewpair.txt").exists()
