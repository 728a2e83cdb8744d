"""The port's copies of the JAX package's host I/O and evaluation modules
(`io/dmap.py`, `io/las.py`, `io/tiles.py`, `fusion/evaluate.py`,
`utils/logging.py`) and its matplotlib-free depth previews
(`pipeline/colormaps.py`, `AerialPipeline._save_depth_preview`), held
against the JAX package on the same seeded numpy inputs: written files
byte-equal, read-backs and metrics exactly equal, preview PNGs equal in
their decoded pixels (matplotlib writes chunks of its own)."""

import json

import numpy as np
import pytest
from PIL import Image

from deep3d_aerial_tpu.fusion import evaluate as jev
from deep3d_aerial_tpu.io import dmap as jdmap
from deep3d_aerial_tpu.io import las as jlas
from deep3d_aerial_tpu.io import tiles as jtiles
from deep3d_aerial_tpu.io.ply import write_ply
from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu_torch.fusion import evaluate as tev
from deep3d_aerial_tpu_torch.io import dmap as tdmap
from deep3d_aerial_tpu_torch.io import las as tlas
from deep3d_aerial_tpu_torch.io import tiles as ttiles
from deep3d_aerial_tpu_torch.pipeline import colormaps
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from deep3d_aerial_tpu_torch.utils import logging as tlogging


def _depth_data(mod, rng, normal, confidence, h=12, w=17):
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return mod.DepthDataRaw(
        image_file_name="images/im_03.png", neighbor_ids=[4, 1, 7],
        image_size=(2 * h, 2 * w),
        K=np.array([[110.0, 0, 8.5], [0, 110.0, 6.0], [0, 0, 1]]), R=R,
        C=rng.normal(size=3) * 50, d_min=91.25, d_max=118.5,
        depth=rng.uniform(90, 120, (h, w)).astype(np.float32),
        normal=(rng.normal(size=(h, w, 3)).astype(np.float32) if normal else None),
        confidence=(rng.uniform(0, 1, (h, w)).astype(np.float32)
                    if confidence else None))


@pytest.mark.parametrize("normal", [False, True])
@pytest.mark.parametrize("confidence", [False, True])
def test_dmap_bytes_and_read_back(tmp_path, normal, confidence):
    data = _depth_data(tdmap, np.random.default_rng(3), normal, confidence)
    jdata = jdmap.DepthDataRaw(**vars(data))
    tdmap.write_dmap(tmp_path / "t.dmap", data)
    jdmap.write_dmap(tmp_path / "j.dmap", jdata)
    raw = (tmp_path / "t.dmap").read_bytes()
    assert raw == (tmp_path / "j.dmap").read_bytes()
    assert raw[2] == 1 | (2 if normal else 0) | (4 if confidence else 0)
    t, j = tdmap.read_dmap(tmp_path / "j.dmap"), jdmap.read_dmap(tmp_path / "t.dmap")
    for key, want in vars(j).items():
        got = getattr(t, key)
        if want is None:
            assert got is None, key
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        else:
            assert got == want, key
    # a header the port reads as the JAX package does, its magic refused
    bad = tmp_path / "bad.dmap"
    bad.write_bytes(b"\x00\x00" + raw[2:])
    with pytest.raises(ValueError, match="magic"):
        tdmap.read_dmap(bad)


def test_read_colmap_array(tmp_path):
    rng = np.random.default_rng(5)
    for shape, header in (((10, 6), b"6&10&1&"), ((7, 9, 3), b"9&7&3&")):
        arr = rng.normal(size=shape).astype(np.float32)
        p = tmp_path / f"a{len(shape)}.bin"
        with open(p, "wb") as f:
            f.write(header)
            # (w, h, c) in column-major order: the transpose of [h, w, c]
            np.transpose(arr.reshape(shape[0], shape[1], -1), (1, 0, 2)).astype(
                "<f4").ravel(order="F").tofile(f)
        got, want = tdmap.read_colmap_array(p), jdmap.read_colmap_array(p)
        assert np.array_equal(got, want) and np.array_equal(got, arr)
    trunc = tmp_path / "trunc.bin"
    trunc.write_bytes(b"6&10")
    with pytest.raises(ValueError, match="truncated"):
        tdmap.read_colmap_array(trunc)


@pytest.mark.parametrize("colors", [False, True])
def test_las_bytes_read_back_and_bbox(tmp_path, colors):
    rng = np.random.default_rng(7 + colors)
    pts = rng.uniform(-150, 150, (400, 3)) + np.array([5e5, 4.2e6, 30.0])
    col = rng.integers(0, 256, (400, 3)).astype(np.uint8) if colors else None
    tlas.write_las(tmp_path / "t.las", pts, col)
    jlas.write_las(tmp_path / "j.las", pts, col)
    assert (tmp_path / "t.las").read_bytes() == (tmp_path / "j.las").read_bytes()
    tp, tc, th = tlas.read_las(tmp_path / "j.las")
    jp, jc, jh = jlas.read_las(tmp_path / "t.las")
    assert np.array_equal(tp, jp) and np.abs(tp - pts).max() <= 0.0005 + 1e-9
    assert (tc is None and jc is None) if not colors else np.array_equal(tc, jc)
    assert json.dumps(th, default=str) == json.dumps(jh, default=str)
    assert th["point_format"] == (2 if colors else 0)
    assert np.array_equal(tlas.las_bbox(tmp_path / "t.las"),
                          jlas.las_bbox(tmp_path / "t.las"))
    # an empty cloud, and the 16-bit colour path
    tlas.write_las(tmp_path / "e.las", np.zeros((0, 3)))
    jlas.write_las(tmp_path / "je.las", np.zeros((0, 3)))
    assert (tmp_path / "e.las").read_bytes() == (tmp_path / "je.las").read_bytes()
    c16 = rng.integers(0, 65536, (400, 3)).astype(np.uint16)
    tlas.write_las(tmp_path / "c.las", pts, c16)
    jlas.write_las(tmp_path / "jc.las", pts, c16)
    assert (tmp_path / "c.las").read_bytes() == (tmp_path / "jc.las").read_bytes()


def test_tile_border_cache_and_tiled_queries(tmp_path):
    rng = np.random.default_rng(9)
    a = np.stack([rng.uniform(0, 10, 200), rng.uniform(0, 10, 200),
                  rng.uniform(0, 1, 200)], -1)
    b = np.stack([rng.uniform(100, 110, 300), rng.uniform(0, 10, 300),
                  rng.uniform(0, 1, 300)], -1)
    c = np.stack([rng.uniform(5, 105, 100), rng.uniform(5, 8, 100),
                  rng.uniform(0, 1, 100)], -1).astype(np.float32)
    col = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    for sub in ("t", "j"):
        d = tmp_path / sub
        d.mkdir()
        tlas.write_las(d / "a.las", a)
        tlas.write_las(d / "b.las", b, col)
        write_ply(d / "c.ply", c, colors=col[:100])
        (d / "notes.txt").write_text("not a tile")
    # the border and its sidecar cache
    for name in ("a.las", "b.las", "c.ply"):
        tb = ttiles.tile_border(str(tmp_path / "t" / name))
        jb = jtiles.tile_border(str(tmp_path / "j" / name))
        assert np.array_equal(tb, jb)
        assert ((tmp_path / "t" / f"{name}.bbox.json").read_bytes()
                == (tmp_path / "j" / f"{name}.bbox.json").read_bytes())
        # a cached border is read back, not recomputed
        (tmp_path / "t" / f"{name}.bbox.json").write_text(json.dumps([1, 2, 3, 4, 5, 6]))
        assert list(ttiles.tile_border(str(tmp_path / "t" / name))) == [1, 2, 3, 4, 5, 6]
        assert np.array_equal(ttiles.tile_border(str(tmp_path / "t" / name),
                                                 use_cache=False), jb)
        (tmp_path / "t" / f"{name}.bbox.json").unlink()
    for q in ([0, 1, 0, 1], [2, 3, 0, 1], [-1, 0, -1, 0], [200, 300, 0, 1]):
        for p in ([0, 2, 0, 2], [1, 3, 1, 3]):
            assert ttiles.bbox_intersects(q, p) == jtiles.bbox_intersects(q, p)
    tt = ttiles.TiledPointCloud(str(tmp_path / "t"))
    jt = jtiles.TiledPointCloud(str(tmp_path / "j"))
    assert [p.rsplit("/", 1)[1] for p in tt.paths] == ["a.las", "b.las", "c.ply"]
    for block in ([-1, 11, -1, 11], [95, 115, -5, 15], [6, 104, 6, 7],
                  [500, 600, 0, 1]):
        assert ([p.rsplit("/", 1)[1] for p in tt.tiles_in(block)]
                == [p.rsplit("/", 1)[1] for p in jt.tiles_in(block)])
        for with_colors in (False, True):
            tp, tc = tt.load_block(block, with_colors=with_colors)
            jp, jc = jt.load_block(block, with_colors=with_colors)
            assert np.array_equal(tp, jp)
            assert (tc is None) == (jc is None)
            if tc is not None:
                assert np.array_equal(tc, jc)


def test_evaluation_metrics_exactly_as_the_jax_package():
    rng = np.random.default_rng(13)
    a = rng.uniform(50, 150, (40, 60))
    b = a * (1 + rng.normal(scale=0.01, size=a.shape))
    b[rng.uniform(size=a.shape) < 0.1] = 0.0
    mask = rng.uniform(size=a.shape) < 0.7
    for kw in ({}, {"rel_threshold": 0.005}, {"mask": mask}):
        assert tev.depth_agreement(a, b, **kw) == jev.depth_agreement(a, b, **kw)
    assert tev.depth_agreement(a * 0, b) == jev.depth_agreement(a * 0, b) == 0.0
    cloud = rng.uniform(0, 20, (3000, 3))
    other = np.concatenate([cloud[:2000] + rng.normal(scale=0.05, size=(2000, 3)),
                            rng.uniform(30, 40, (500, 3))])
    for kw in ({"dist_threshold": 0.1}, {"dist_threshold": 0.3, "sample": 800},
               {"dist_threshold": 0.2, "sample": 1000, "seed": 4}):
        assert tev.cloud_agreement(cloud, other, **kw) == \
            jev.cloud_agreement(cloud, other, **kw)
    # an empty cloud: (0.0, nan) on both sides
    np.testing.assert_equal(tev.cloud_agreement(cloud, np.zeros((0, 3)), 0.1),
                            jev.cloud_agreement(cloud, np.zeros((0, 3)), 0.1))

    def z_fn(x, y):
        return np.sin(0.1 * x) * 3 + 0.02 * y

    pts = np.stack([cloud[:, 0], cloud[:, 1],
                    z_fn(cloud[:, 0], cloud[:, 1]) + rng.normal(scale=0.2, size=3000)], -1)
    for q in (0.95, 0.5, 1.0):
        assert tev.surface_rmse(pts, z_fn, q) == jev.surface_rmse(pts, z_fn, q)
    assert tev.surface_rmse(np.zeros((0, 3)), z_fn) == float("inf")


def test_logging_copy(tmp_path, monkeypatch):
    import sys

    timer = tlogging.StageTimer()
    with timer.span("fusion"):
        pass
    with timer.span("fusion"):
        pass
    with pytest.raises(RuntimeError):
        with timer.span("mesh"):
            raise RuntimeError("still timed")
    assert list(timer.spans) == ["fusion", "mesh"]
    assert timer.report().splitlines()[0].startswith("fusion")
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    path = tlogging.tee_logs(str(tmp_path / "logs"))
    print("to the log")
    sys.stdout.flush()
    assert path.startswith(str(tmp_path / "logs" / "log-")) and path.endswith(".log")
    assert "to the log" in open(path).read()


def test_colour_tables_are_matplotlibs():
    mpl = pytest.importorskip("matplotlib")
    from matplotlib import colormaps as mcm

    assert mpl.__version__ == "3.10.8"
    for name in ("viridis", "magma"):
        cm = mcm[name]
        cm._init()
        assert np.array_equal(colormaps.lookup_table(name),
                              (cm._lut[:256] * 255).astype(np.uint8))


def _maps(kind, rng, h=23, w=31):
    depth = rng.uniform(95, 130, (h, w)).astype(np.float32)
    conf = rng.uniform(-0.2, 1.3, (h, w)).astype(np.float32)
    if kind == "constant":
        depth[:] = 104.25
        conf[:] = 0.5
    elif kind == "non-finite":
        depth[3, 4], depth[7, :5], depth[0, 0] = np.nan, np.inf, -np.inf
        conf[1, 1], conf[2, 2] = np.nan, np.inf
    elif kind == "all non-finite":
        depth[:] = np.nan
    elif kind == "wide range":
        depth = (rng.normal(size=(h, w)) * 1e3 + 1e4).astype(np.float32)
    return depth, conf


@pytest.mark.parametrize("kind", ["random", "constant", "non-finite",
                                  "all non-finite", "wide range"])
def test_depth_previews_decode_as_the_jax_packages(tmp_path, kind):
    """The port's PIL previews against the JAX package's plt.imsave ones
    on the same depth and confidence: equal RGBA after decoding."""
    pytest.importorskip("matplotlib")
    depth, conf = _maps(kind, np.random.default_rng(17))
    jp = JPipeline(str(tmp_path / "j"), JConfig())
    tp = AerialPipeline(str(tmp_path / "t"), PipelineConfig(), device="cpu")
    jp._save_depth_preview("im_01", depth, conf)
    tp._save_depth_preview("im_01", depth, conf)
    for suffix in ("init", "prob"):
        got = Image.open(tmp_path / "t" / "dense" / "MVS" / "color" / f"im_01_{suffix}.png")
        want = Image.open(tmp_path / "j" / "dense" / "MVS" / "color" / f"im_01_{suffix}.png")
        assert got.mode == "RGBA" and got.size == (depth.shape[1], depth.shape[0])
        assert np.array_equal(np.asarray(got), np.asarray(want.convert("RGBA"))), suffix
