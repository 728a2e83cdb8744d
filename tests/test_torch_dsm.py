"""The port's DSM rasterisers, GeoTIFF/TFW codec and OpenMVS Interface
(`.mvs`) codec against the JAX package's, on the same inputs.

The native rasterisers run the port's library, built from native/*.cc at
first use; the JAX side gets the same library through monkeypatch
(`native_lib`, tests/test_torch_mesh.py). Every comparison is exact. The
NumPy bodies of the rasterisers are held against the native core on inputs
where both bin every point and cell centre alike: points away from cell
borders, triangle corners on integer coordinates (float32 and float64
barycentrics then agree), and an odd number of points in each cell that
the robust max trims (the native core takes the upper middle deviation as
the MAD of an even cell, NumPy the mean of the two).
"""

import numpy as np
import pytest

from deep3d_aerial_tpu.dsm import rasterize as jras
from deep3d_aerial_tpu.io import geotiff as jgeo
from deep3d_aerial_tpu.io import mvs_interface as jmvs
from deep3d_aerial_tpu_torch.dsm import rasterize as ras
from deep3d_aerial_tpu_torch.dsm import DSMConfig, DSMFromMesh, DSMFromPointCloud
from deep3d_aerial_tpu_torch.io import geotiff, mvs_interface
from tests.test_torch_mesh import native_lib  # noqa: F401  (fixture)

BBX = [-2.0, 10.0, -1.0, 8.0, -5.0, 50.0]


def _points(seed=0):
    """Points away from the borders of the 0.5 m cells of BBX: 1, 3 or 5
    per cell (odd counts), a few cells left empty, and a spike or two."""
    rng = np.random.default_rng(seed)
    cols, rows = 24, 18
    out = []
    for iy in range(rows):
        for ix in range(cols):
            k = rng.choice([0, 1, 3, 5, 5])
            x = BBX[0] + (ix + 0.5) * 0.5 + rng.uniform(-0.2, 0.2, k)
            y = BBX[3] - (iy + 0.5) * 0.5 + rng.uniform(-0.2, 0.2, k)
            z = rng.normal(2.0, 0.05, k) + 0.1 * ix
            if k == 5 and rng.uniform() < 0.2:
                z[0] += 30.0  # a spike the robust max drops
            out.append(np.column_stack([x, y, z]))
    pts = np.concatenate(out).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def _cfg(mod, **kw):
    return mod.DSMConfig(cell_size=(0.5, 0.5), **kw)


@pytest.mark.parametrize("fn", ["rasterize_max", "rasterize_robust_max"])
def test_point_rasterisers_native_equal_jax_native_and_numpy(native_lib, fn):
    pts = _points()
    got = getattr(ras, fn)(pts, BBX, _cfg(ras))
    assert got.shape == (18, 24) and (got != ras.NODATA).mean() > 0.5
    np.testing.assert_array_equal(got, getattr(jras, fn)(pts, BBX, _cfg(jras)))
    np.testing.assert_array_equal(got, getattr(ras, fn + "_numpy")(pts, BBX, _cfg(ras)))
    if fn == "rasterize_robust_max":
        assert got.max() < 10.0 < ras.rasterize_max(pts, BBX, _cfg(ras)).max()


def _mesh(seed=1):
    """A grid mesh with corners on integer x, y and random heights."""
    n = 9
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32) - 1, np.arange(n, dtype=np.float32))
    z = np.random.default_rng(seed).uniform(0, 5, n * n).astype(np.float32)
    verts = np.stack([xs.ravel(), ys.ravel(), z], -1)
    i = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None]).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + n], -1),
                            np.stack([i + 1, i + n + 1, i + n], -1)]).astype(np.int32)
    return verts, faces


def test_mesh_rasteriser_native_equals_jax_native_and_numpy(native_lib):
    verts, faces = _mesh()
    cfg = ras.DSMConfig(cell_size=(0.25, 0.25))
    got = ras.rasterize_mesh(verts, faces, BBX, cfg)
    assert got.shape == (36, 48) and (got != ras.NODATA).mean() > 0.5
    np.testing.assert_array_equal(
        got, jras.rasterize_mesh(verts, faces, BBX, jras.DSMConfig(cell_size=(0.25, 0.25))))
    np.testing.assert_array_equal(got, ras.rasterize_mesh_numpy(verts, faces, BBX, cfg))
    empty = ras.rasterize_mesh(verts, faces[:0], BBX, cfg)
    assert (empty == ras.NODATA).all()


@pytest.mark.parametrize("select,interp", [("Max", None), ("Robust_Max", "MovingAverage")])
def test_dsm_classes_and_moving_average_fill_equal(native_lib, select, interp):
    pts = _points(seed=3)
    kw = dict(select_method=select, interp_method=interp, interp_window=3)
    got = DSMFromPointCloud(_cfg(ras, **kw)).create(pts, BBX)
    np.testing.assert_array_equal(got, jras.DSMFromPointCloud(_cfg(jras, **kw)).create(pts, BBX))
    verts, faces = _mesh()
    got = DSMFromMesh(_cfg(ras, **kw)).create(verts, faces, BBX)
    np.testing.assert_array_equal(got, jras.DSMFromMesh(_cfg(jras, **kw)).create(verts, faces, BBX))
    holes = ras.rasterize_max(pts, BBX, _cfg(ras))
    filled = ras.moving_average_fill(holes, _cfg(ras, interp_window=5))
    assert (filled != ras.NODATA).sum() > (holes != ras.NODATA).sum()
    np.testing.assert_array_equal(
        filled, jras.moving_average_fill(holes, _cfg(jras, interp_window=5)))


def test_geotiff_and_tfw_bytes_equal_and_read_back(tmp_path):
    grid = np.random.default_rng(0).normal(10, 3, (17, 23)).astype(np.float32)
    grid[3:5, 4:9] = ras.NODATA
    args = dict(origin_xy=(431250.5, 5411200.25), cell_size=(0.2, 0.25),
                nodata=ras.NODATA)
    geotiff.write_geotiff(tmp_path / "t.tif", grid, **args)
    jgeo.write_geotiff(tmp_path / "j.tif", grid, **args)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    back, origin, cell, nodata = geotiff.read_geotiff(tmp_path / "t.tif")
    np.testing.assert_array_equal(back, grid)
    assert (origin, cell, nodata) == ((431250.5, 5411200.25), (0.2, 0.25), ras.NODATA)
    assert jgeo.read_geotiff(tmp_path / "t.tif")[1:] == (origin, cell, nodata)
    geotiff.write_tfw(tmp_path / "t.tfw", args["origin_xy"], args["cell_size"])
    jgeo.write_tfw(tmp_path / "j.tfw", args["origin_xy"], args["cell_size"])
    assert (tmp_path / "t.tfw").read_text() == (tmp_path / "j.tfw").read_text()


def _fusion_inputs(seed=0):
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    cams = [SimpleNamespace(K=np.array([[100.0 + i, 0, 48], [0, 101.0, 32], [0, 0, 1]]),
                            width=96, height=64) for i in range(2)]
    images = []
    for i in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        images.append((10 + i, i % 2, f"im_{i:02d}", q, rng.normal(0, 50, 3)))
    pts = rng.normal(0, 20, (300, 3)).astype(np.float32)
    vis = [rng.choice(np.arange(10, 14), rng.integers(1, 4), replace=False).astype(np.int32)
           for _ in range(len(pts))]
    normals = rng.normal(size=(300, 3)).astype(np.float32)
    colors = rng.integers(0, 255, (300, 3)).astype(np.uint8)
    return cams, images, pts, vis, normals, colors


def _scene_equal(a, b):
    assert len(a.platforms) == len(b.platforms) and len(a.images) == len(b.images)
    for pa, pb in zip(a.platforms, b.platforms):
        assert pa.name == pb.name and len(pa.poses) == len(pb.poses)
        for ca, cb in zip(pa.cameras, pb.cameras):
            assert (ca.name, ca.width, ca.height) == (cb.name, cb.width, cb.height)
            np.testing.assert_array_equal(ca.K, cb.K)
        for qa, qb in zip(pa.poses, pb.poses):
            np.testing.assert_array_equal(qa.R, qb.R)
            np.testing.assert_array_equal(qa.C, qb.C)
    for ia, ib in zip(a.images, b.images):
        assert vars(ia) == vars(ib)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    for key in ("normals", "colors"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    va, vb = list(a.vertex_views), list(b.vertex_views)
    assert len(va) == len(vb) == len(a.vertices)
    for x, y in zip(va, vb):
        np.testing.assert_array_equal(x, y)


def test_mvs_scene_from_fusion_bytes_and_read_back(tmp_path):
    cams, images, pts, vis, normals, colors = _fusion_inputs()
    scene = mvs_interface.scene_from_fusion(cams, images, pts, vis, normals, colors)
    jscene = jmvs.scene_from_fusion(cams, images, pts, vis, normals, colors)
    _scene_equal(scene, jscene)
    mvs_interface.write_mvs(tmp_path / "t.mvs", scene)
    jmvs.write_mvs(tmp_path / "j.mvs", jscene)
    assert (tmp_path / "t.mvs").read_bytes() == (tmp_path / "j.mvs").read_bytes()
    back = mvs_interface.read_mvs(tmp_path / "t.mvs")
    _scene_equal(back, jmvs.read_mvs(tmp_path / "j.mvs"))
    _scene_equal(back, scene)
