"""The port's mesh stage (host NumPy and the native C++ core) against the
JAX package's `mesh/`, on the same inputs.

Where the JAX side needs the native library, the `native_lib` fixture builds
the port's library from native/*.cc (g++, at first use, into
build/native/) and sets it into the JAX bridge through monkeypatch: both
sides then run the same C++, and nothing is written into the JAX package.
Every comparison is exact (equal arrays, equal bytes): the two sides run
the same NumPy and C++ code on the same inputs.
"""

import numpy as np
import pytest

from deep3d_aerial_tpu.fusion.consistency import ViewGeometry as JViewGeometry
from deep3d_aerial_tpu.geometry.camera import Pose
from deep3d_aerial_tpu.io import mvs_interface as jmvs
from deep3d_aerial_tpu.mesh import atlas as jatlas
from deep3d_aerial_tpu.mesh import clean as jclean
from deep3d_aerial_tpu.mesh import reconstruct as jrec
from deep3d_aerial_tpu.mesh import refine as jref
from deep3d_aerial_tpu.mesh import texture as jtex
from deep3d_aerial_tpu.mesh import trimesh_io as jtio
from deep3d_aerial_tpu.mesh.openmvs_config import load_openmvs_mesh_config as jload
from deep3d_aerial_tpu_torch.fusion.consistency import ViewGeometry
from deep3d_aerial_tpu_torch.io.ply import write_ply
from deep3d_aerial_tpu_torch.mesh import atlas, clean, reconstruct, refine, texture, trimesh_io
from deep3d_aerial_tpu_torch.mesh.openmvs_config import load_openmvs_mesh_config
from deep3d_aerial_tpu_torch.utils import native
from tests.conftest import toy_camera
from tests.test_mesh import _building_scene, grid_points


@pytest.fixture
def native_lib(monkeypatch):
    """The port's native library, also set into the JAX bridge."""
    from deep3d_aerial_tpu.utils import native as jnative

    lib = native.load_native()
    monkeypatch.setattr(jnative, "_LIB", lib)
    monkeypatch.setattr(jnative, "_TRIED", True)
    return lib


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


def _bumpy(n=14, seed=0):
    rng = np.random.default_rng(seed)
    pts = grid_points(n, 1.0, lambda x, y: np.sin(0.5 * x) * np.cos(0.3 * y))
    pts[:, :2] += rng.normal(0, 0.2, (len(pts), 2)).astype(np.float32)
    cols = rng.integers(0, 255, (len(pts), 3)).astype(np.uint8)
    nrm = np.tile(np.float32([0, 0, 1]), (len(pts), 1))
    return pts, cols, nrm


@pytest.mark.parametrize("colors", [False, True])
def test_mesh_ply_bytes_and_read_back(tmp_path, colors):
    pts, cols, _ = _bumpy()
    faces = np.array([[0, 1, 14], [1, 15, 14], [2, 3, 16]], np.int32)
    c = cols if colors else None
    trimesh_io.write_mesh_ply(tmp_path / "t.ply", pts, faces, c)
    jtio.write_mesh_ply(tmp_path / "j.ply", pts, faces, c)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    _eq(trimesh_io.read_mesh_ply(tmp_path / "t.ply"),
        jtio.read_mesh_ply(tmp_path / "t.ply"))


def test_grid_decimate_native_equals_jax_native_and_numpy(native_lib):
    """The port's grid_decimate (native core) equals the JAX one with the
    same library, and its NumPy body where the two rules agree: per xy
    cell, the point nearest the cell's median height, on cells of 3 points
    well inside their cell. Elsewhere the NumPy body differs: it lists the
    cells in another order, breaks the tie of an even cell another way,
    bins in float32, and merges cells whose hashes collide (cells (-1, -1)
    and (1, 1), for one)."""
    pts, cols, nrm = _bumpy(30, seed=4)
    pts = np.concatenate([pts, pts + np.float32([0.05, 0.05, 0.3])])
    cols, nrm = np.concatenate([cols, cols]), np.concatenate([nrm, nrm])
    got = reconstruct.grid_decimate(pts, 1.5, cols, nrm)
    assert len(got[0]) < len(pts)
    _eq(got, jrec.grid_decimate(pts, 1.5, cols, nrm))

    rng = np.random.default_rng(5)
    cx, cy = np.meshgrid(np.arange(12), np.arange(9))
    centre = (np.stack([cx.ravel(), cy.ravel()], -1) + 0.5) * 1.5
    pts = np.concatenate([
        np.column_stack([centre + rng.uniform(-0.5, 0.5, centre.shape),
                         rng.normal(0, 1, len(centre))])
        for _ in range(3)]).astype(np.float32)
    got = reconstruct.grid_decimate(pts, 1.5)[0]
    plain = reconstruct.grid_decimate_numpy(pts, 1.5)[0]
    assert len(got) == len(centre)
    np.testing.assert_array_equal(got[np.lexsort(got.T)], plain[np.lexsort(plain.T)])


def test_delaunay_mesh_25d_equal(native_lib):
    pts, cols, nrm = _bumpy()
    cfg = reconstruct.MeshConfig(insert_distance=0.9, max_edge_factor=3.0)
    jcfg = jrec.MeshConfig(insert_distance=0.9, max_edge_factor=3.0)
    got = reconstruct.delaunay_mesh_25d(pts, cfg, cols, nrm)
    assert len(got[1]) > 100
    _eq(got, jrec.delaunay_mesh_25d(pts, jcfg, cols, nrm))


def test_clean_mesh_and_its_parts_equal(native_lib):
    pts, cols, _ = _bumpy(16)
    verts, faces, vcols = reconstruct.delaunay_mesh_25d(
        pts, reconstruct.MeshConfig(insert_distance=0.9), cols)
    n0 = len(verts)
    verts = np.concatenate([verts, np.float32([[100, 100, 0], [101, 100, 0],
                                               [100, 101, 0]])])
    vcols = np.concatenate([vcols, np.zeros((3, 3), np.uint8)])
    verts[10, 2] += 50.0  # a spike
    faces = np.concatenate([faces[~(faces == 40).any(1)],  # a hole
                            [[n0, n0 + 1, n0 + 2]]]).astype(np.int32)  # an islet
    np.testing.assert_array_equal(clean.face_components(faces),
                                  jclean.face_components(faces))
    np.testing.assert_array_equal(clean.remove_spurious(faces, 5),
                                  jclean.remove_spurious(faces, 5))
    np.testing.assert_array_equal(clean.remove_spikes(verts, faces),
                                  jclean.remove_spikes(verts, faces))
    _eq(clean.boundary_loops(faces), jclean.boundary_loops(faces))
    np.testing.assert_array_equal(clean.close_holes(verts, faces, 12),
                                  jclean.close_holes(verts, faces, 12))
    _eq(clean.decimate_to_target(verts, faces, vcols, 150),
        jclean.decimate_to_target(verts, faces, vcols, 150))
    kw = dict(remove_spurious_faces=5, spikes=True, holes=20, smooth=2,
              target_faces=200)
    got = clean.clean_mesh(verts, faces, vcols, **kw)
    assert 0 < len(got[1]) < len(faces)
    _eq(got, jclean.clean_mesh(verts, faces, vcols, **kw))


def test_taubin_decimate_and_refine_file_equal(tmp_path, native_lib):
    pts, _, _ = _bumpy()
    verts, faces, _ = reconstruct.delaunay_mesh_25d(
        pts, reconstruct.MeshConfig(insert_distance=0.9))
    verts = verts + np.random.default_rng(1).normal(0, 0.1, verts.shape).astype(np.float32)
    cfg, jcfg = refine.RefineConfig(iterations=4), jref.RefineConfig(iterations=4)
    np.testing.assert_array_equal(refine.taubin_smooth(verts, faces, cfg),
                                  jref.taubin_smooth(verts, faces, jcfg))
    cols = np.random.default_rng(2).integers(0, 255, (len(verts), 3)).astype(np.uint8)
    _eq(refine.decimate_mesh(verts, faces, 0.4, cols),
        jref.decimate_mesh(verts, faces, 0.4, cols))
    trimesh_io.write_mesh_ply(tmp_path / "m.ply", verts, faces)
    kw = dict(iterations=3, decimate_ratio=0.5)
    got = refine.refine_mesh_file(tmp_path / "m.ply", tmp_path / "t.ply",
                                  refine.RefineConfig(**kw))
    _eq(got, jref.refine_mesh_file(tmp_path / "m.ply", tmp_path / "j.ply",
                                   jref.RefineConfig(**kw)))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def _building_mvs(path, n_points=None):
    """The building scene of tests/test_mesh.py as a `.mvs` file, written by
    the JAX writer (cameras on a ring, each looking at the origin), and its
    points as a PLY beside it; `n_points` keeps that many, spread over the
    scene."""
    from types import SimpleNamespace

    pts, _, cams, (vals, counts) = _building_scene(np.random.default_rng(0))
    offs = np.concatenate([[0], np.cumsum(counts)])
    vis = [vals[offs[i]:offs[i + 1]] for i in range(len(pts))]
    if n_points is not None:
        keep = np.linspace(0, len(pts) - 1, n_points).astype(np.int64)
        pts, vis = pts[keep], [vis[i] for i in keep]
    images = []
    for i, c in enumerate(cams):
        fwd = -c / np.linalg.norm(c)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R_cw = np.stack([right, np.cross(fwd, right), fwd])
        images.append((i + 1, 0, f"im_{i:02d}", R_cw, c))
    cam = SimpleNamespace(K=np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]),
                          width=64, height=48)
    colors = np.random.default_rng(1).integers(0, 255, (len(pts), 3)).astype(np.uint8)
    scene = jmvs.scene_from_fusion([cam], images, pts, [v + 1 for v in vis],
                                   colors=colors)
    jmvs.write_mvs(path, scene)
    write_ply(str(path).replace(".mvs", ".ply"), pts.astype(np.float32),
              None, colors)
    return path


def test_graphcut_from_the_jax_writers_mvs_equal(tmp_path, native_lib):
    mvs = _building_mvs(tmp_path / "scene_0.mvs")
    got = reconstruct.reconstruct_graphcut_from_mvs(mvs)
    assert got is not None and len(got[1]) > 200
    _eq(got, jrec.reconstruct_graphcut_from_mvs(mvs))
    # create_mesh_from_scene writes the same file on both sides
    ply = str(mvs).replace(".mvs", ".ply")
    reconstruct.create_mesh_from_scene(ply, tmp_path / "t.ply", mvs_path=mvs)
    jrec.create_mesh_from_scene(ply, tmp_path / "j.ply", mvs_path=mvs)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_graphcut_takes_the_25d_mesh_under_16_points(tmp_path, native_lib):
    """A scene of 12 points has no graph cut (the algorithm's rule): `auto`
    writes the 2.5-D mesh of the PLY, as the JAX function does."""
    mvs = _building_mvs(tmp_path / "scene_0.mvs", n_points=12)
    assert reconstruct.reconstruct_graphcut_from_mvs(mvs) is None
    ply = str(mvs).replace(".mvs", ".ply")
    cfg = reconstruct.MeshConfig(insert_distance=0.5, max_edge_factor=40.0)
    jcfg = jrec.MeshConfig(insert_distance=0.5, max_edge_factor=40.0)
    got = reconstruct.create_mesh_from_scene(ply, tmp_path / "t.ply", cfg, mvs_path=mvs)
    _eq(got, reconstruct.create_mesh_from_ply(ply, tmp_path / "p.ply", cfg))
    _eq(got, jrec.create_mesh_from_scene(ply, tmp_path / "j.ply", jcfg, mvs_path=mvs))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    with pytest.raises(RuntimeError, match="no surface"):
        reconstruct.create_mesh_from_scene(ply, tmp_path / "g.ply", cfg,
                                           mvs_path=mvs, method="graphcut3d")


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No library and a compiler that fails: every native entry raises, and
    neither the NumPy body nor the 2.5-D mesh answers in its place."""
    from deep3d_aerial_tpu_torch.dsm import rasterize

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "false")
    pts, _, _ = _bumpy()
    mvs = _building_mvs(tmp_path / "scene_0.mvs")
    ply = str(mvs).replace(".mvs", ".ply")
    cfg = rasterize.DSMConfig(cell_size=(1.0, 1.0))
    bbx = [-1.0, 15.0, -1.0, 15.0, -5.0, 5.0]
    calls = [
        lambda: reconstruct.grid_decimate(pts, 1.5),
        lambda: reconstruct.delaunay_mesh_25d(pts),
        lambda: reconstruct.create_mesh_from_scene(ply, tmp_path / "m.ply", mvs_path=mvs),
        lambda: rasterize.rasterize_max(pts, bbx, cfg),
        lambda: rasterize.rasterize_robust_max(pts, bbx, cfg),
        lambda: rasterize.rasterize_mesh(pts, np.int32([[0, 1, 14]]), bbx, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="native library build failed"):
            call()
    assert not (tmp_path / "m.ply").exists()
    assert not list((tmp_path / "build").glob("*.so"))


def _views(side, cam, grays_at):
    """Solid-grey nadir views at 30 m over the given (x, y) centres."""
    VG = ViewGeometry if side == "t" else JViewGeometry
    TV = texture.TextureView if side == "t" else jtex.TextureView
    R_down = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    out = []
    for gray, cx, cy in grays_at:
        pose = Pose(R_down, -R_down @ np.array([cx, cy, 30.0]))
        yy, xx = np.mgrid[0:48, 0:64]
        img = np.stack([(gray + 3 * xx) % 256, (gray + 5 * yy) % 256,
                        np.full_like(xx, gray)], -1).astype(np.uint8)
        out.append(TV(geom=VG.create(cam.K, pose.T_cw), image=img))
    return out


@pytest.mark.parametrize("kw", [{}, {"seam_level": True, "outlier_threshold": 0.06},
                                {"global_seam_level": True, "size_multiple": 100,
                                 "packing_heuristic": 1}])
def test_texture_vertices_and_atlas_equal(tmp_path, native_lib, kw):
    pts, _, _ = _bumpy(14)
    pts[:, :2] *= 2.0
    verts, faces, _ = reconstruct.delaunay_mesh_25d(
        pts, reconstruct.MeshConfig(insert_distance=1.8))
    cam = toy_camera(width=64, height=48, f=40.0)
    at = [(90, 6.0, 9.0), (140, 14.0, 13.0), (200, 22.0, 17.0)]
    tv, jv = _views("t", cam, at), _views("j", cam, at)
    np.testing.assert_array_equal(texture.texture_vertices(verts, faces, tv),
                                  jtex.texture_vertices(verts, faces, jv))
    got = atlas.build_texture_atlas(verts, faces, tv, **kw)
    want = jatlas.build_texture_atlas(verts, faces, jv, **kw)
    assert (got.labels >= 0).any()
    for key in ("labels", "uv", "image"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    trimesh_io.write_mesh_ply(tmp_path / "m.ply", verts, faces)
    for side, mod, views in (("t", atlas, tv), ("j", jatlas, jv)):
        (tmp_path / side).mkdir()
        mod.texture_atlas_mesh_file(tmp_path / "m.ply", tmp_path / side / "tex.ply",
                                    views, **kw)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "tex.ply" in names and any(n.endswith(".png") for n in names)
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    texture.texture_mesh_file(tmp_path / "m.ply", tmp_path / "tv.ply", tv)
    jtex.texture_mesh_file(tmp_path / "m.ply", tmp_path / "jv.ply", jv)
    assert (tmp_path / "tv.ply").read_bytes() == (tmp_path / "jv.ply").read_bytes()


def test_openmvs_mesh_config_equal(tmp_path):
    path = tmp_path / "mesh.yaml"
    path.write_text(
        "RECONSTRUCTMESH:\n  fDistInsert: 2.5\n  fDecimateMesh: 0.5\n"
        "  fRemoveSpurious: 30\n  bRemoveSpikes: false\n  nCloseHoles: 12\n"
        "  nSmoothMesh: 3\n  bUseFreeSpaceSupport: true\n"
        "REFINEMESH:\n  nScales: 3\n  nMaxViews: 5\n  fRegularityWeight: 0.3\n"
        "  fGradientStep: 25.05\n"
        "TEXTUREMESH:\n  nColEmpty: 16711935\n  fOutlierThreshold: 0.1\n"
        "  bLocalSeamLeveling: true\n  nTextureSizeMultiple: 64\n")
    got, want = load_openmvs_mesh_config(path), jload(path)
    for g, w in zip(got[:3], want[:3]):
        assert vars(g) == vars(w)
    assert got[3] == want[3] and got[3]["ignored"]
