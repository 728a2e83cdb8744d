"""Host-side measurements of the port's mesh stage, on the CPU:

    python3 scripts/mesh_probe.py graphcut [--points 20000 60000]
    python3 scripts/mesh_probe.py chaos
    python3 scripts/mesh_probe.py clip

graphcut: seconds of the native graph cut (native/delaunay_mesh.cc, built
by utils/native.py) on a synthetic terrain of N points, each seen by its 3
nearest of 6 cameras at 100 m: how its cost grows with its input.

chaos: how far the photometric refine (device cpu, 20 steps, both
energies) moves when the input mesh moves by one ulp, against how far one
step moves: the mesh is the AdaMVS pipeline's `_mesh_refine.ply` of the
chip_smoke.py survey at 256x192 (random weights, 16/8/8 planes), with its
texture views.

clip: the integer-pixel case of tests/test_torch_refine.py with the
sampler's clips as torch.clamp instead of torch.minimum/maximum: how far
one step lands from the JAX package's, against the test's tolerance (needs
the JAX package).
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def graphcut(points):
    from deep3d_aerial_tpu_torch.utils import native

    native.load_native()
    rng = np.random.default_rng(0)
    cams = np.array([[x, y, 100.0] for x in (-33, 0, 33) for y in (-12, 12)])
    for n in points:
        x, y = rng.uniform(-70, 70, n), rng.uniform(-50, 50, n)
        z = (3 * np.sin(0.08 * x) * np.cos(0.06 * y) + 1.5 * np.sin(0.021 * x + 0.033 * y)
             + rng.normal(0, 0.02, n))
        pts = np.stack([x, y, z], -1)
        d = np.linalg.norm(cams[None, :, :2] - pts[:, None, :2], axis=-1)
        vis = np.argsort(d, 1)[:, :3].astype(np.int32)
        offs = np.arange(0, 3 * n + 1, 3, dtype=np.int64)
        t0 = time.perf_counter()
        tris = native.reconstruct_mesh_native(pts, vis.ravel(), offs, cams)
        print(f"[graphcut] {n} points: {time.perf_counter() - t0:.2f} s, "
              f"{0 if tris is None else len(tris)} faces", flush=True)


def chaos():
    import chip_smoke as cs
    from deep3d_aerial_tpu_torch.mesh import refine
    from deep3d_aerial_tpu_torch.mesh.trimesh_io import read_mesh_ply
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    W, H = 256, 192
    cam, poses = cs.survey(W, H)
    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp) / "ws"
        cs.write_workspace(ws, cam, poses, torch.device("cpu"))
        cfg = PipelineConfig(
            image_w=W, image_h=H, image_scale=1.0, view_num=cs.VIEWS,
            allow_random_weights=True, run_view_selection=False, fusion_num=4,
            geo_consist_num=2, photomatric_threshold=0.0, position_threshold=2.0,
            depth_threshold=0.05, normal_threshold=180.0, ndepths=[16, 8, 8],
            num_depth=32, run_create_dsm=False)
        pipe = AerialPipeline(str(ws), cfg, device="cpu")
        cs.cap_graphcut_input(pipe)
        pipe.run_dense()
        verts, faces = read_mesh_ply(sorted((ws / "mesh").glob("*_mesh_refine.ply"))[0])
        views = [(v.image, v.geom.K, v.geom.T_cw) for v in pipe._texture_views()]
    up = np.nextafter(verts, np.float32(np.inf))
    for energy in ("zncc", "variance"):
        pc = refine.PhotoRefineConfig(scales=1, energy=energy)
        a = refine.photometric_refine(verts, faces, views, pc, device="cpu")
        b = refine.photometric_refine(up, faces, views, pc, device="cpu")
        m, v, edge = refine.refine_setup(verts, faces, views, pc, "cpu")
        step = pc.gradient_step * edge
        one = refine.refine_update(m, v, step) - refine.refine_update(m, torch.from_numpy(up), step)
        print(f"[chaos] {energy}: {len(faces)} faces, mean edge {edge:.4f} m; 1-ulp input: "
              f"20 steps {np.abs(a - b).max() / edge:.3e} mean edges apart, one step "
              f"{float(one.abs().max()) / edge:.3e}; the run moved "
              f"{np.abs(a - verts).max() / edge:.3e}", flush=True)


def clip():
    from deep3d_aerial_tpu_torch.mesh import refine
    from tests.test_torch_refine import TOL, both, grid_mesh, mean_edge, views_of

    verts, faces = grid_mesh(9)
    verts[:, 2] = np.random.default_rng(0).choice(
        np.array([5.0, 10.0, 20.0], np.float32), len(verts))
    views = views_of((-2.0, 0.0, 2.0), f=20.0, drift=0.3)
    tol = TOL * mean_edge(verts, faces)
    good = refine._clip
    for energy in ("zncc", "variance"):
        t, j = both(verts, faces, views, energy=energy, scales=1, iterations=1)
        refine._clip = lambda x, lo, hi: torch.clamp(x, lo, hi)
        try:
            c, _ = both(verts, faces, views, energy=energy, scales=1, iterations=1)
        finally:
            refine._clip = good
        print(f"[clip] {energy}: one step vs JAX {np.abs(t - j).max():.3e} with "
              f"minimum/maximum, {np.abs(c - j).max():.3e} with clamp; tolerance "
              f"{tol:.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("graphcut", "chaos", "clip"))
    ap.add_argument("--points", type=int, nargs="+", default=[20000, 60000])
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.what == "graphcut":
        graphcut(args.points)
    elif args.what == "chaos":
        chaos()
    else:
        import tests.conftest  # noqa: F401  (JAX on the CPU)
        clip()


if __name__ == "__main__":
    main()
