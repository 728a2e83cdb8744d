"""Standalone fusion CLI (counterpart of deep3d_aerial_tpu/fusion/__main__.py,
itself the reference's fuse/fusion_3d_normal.py argparse entry, :30-52):
fuse already-produced depth maps of a workspace without the other stages.

    python -m deep3d_aerial_tpu_torch.fusion --project_folder WS/export \\
        --mvs_path WS/dense/MVS --output_path OUT [--pc_format ply|las] \\
        [--device cuda|cpu]

Views are loaded as the JAX CLI loads them, not as the pipeline's fusion
session does: every view of image_path.txt whose `_init.pfm` and `.txt`
exist, with its confidence but no normals and no image, and each block's
sources from the whole view-pair list. Writes `scene_<i>.ply` (or `.las`)
and `scene_<i>.txt` (the block's border) per block with fused points.
`--device` defaults to cuda and raises when there is no CUDA device.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fuse depth maps to point clouds")
    ap.add_argument("--project_folder", required=True,
                    help="export dir with viewpair/blocks/image_path.txt")
    ap.add_argument("--mvs_path", required=True, help="dir with *_init.pfm etc")
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--fusion_num", type=int, default=10)
    ap.add_argument("--min_geo_consist_num", type=int, default=4)
    ap.add_argument("--photomatric_threshold", type=float, default=0.2)
    ap.add_argument("--position_threshold", type=float, default=1.0)
    ap.add_argument("--depth_threshold", type=float, default=0.01)
    ap.add_argument("--normal_threshold", type=float, default=90.0)
    ap.add_argument("--pc_format", default="ply", choices=["ply", "las"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    import os

    import torch

    from ..io import text_formats as tf
    from ..io.pfm import read_pfm
    from ..io.ply import write_ply
    from ..pipeline.orchestrator import resolve_device
    from . import DepthFusion, FusionConfig, ViewGeometry
    from .fuse import ViewData

    device = resolve_device(args.device)
    os.makedirs(args.output_path, exist_ok=True)
    _, names = tf.read_image_paths(
        os.path.join(args.project_folder, "image_path.txt"))
    pairs = tf.read_view_pairs(os.path.join(args.project_folder, "viewpair.txt"))
    blocks = tf.read_blocks(os.path.join(args.project_folder, "blocks.txt"))
    name_of = {i: os.path.splitext(n)[0] for i, n in names.items()}

    views = {}
    for vid, name in name_of.items():
        dpath = os.path.join(args.mvs_path, f"{name}_init.pfm")
        cpath = os.path.join(args.mvs_path, f"{name}.txt")
        if not (os.path.exists(dpath) and os.path.exists(cpath)):
            continue
        cam = tf.read_mvs_cam(cpath)
        depth = read_pfm(dpath)[0]
        ppath = os.path.join(args.mvs_path, f"{name}_prob.pfm")
        prob = read_pfm(ppath)[0] if os.path.exists(ppath) else None
        views[name] = ViewData(
            name=name, image_id=cam.image_id,
            geom=ViewGeometry.create(cam.K, cam.T_cw),
            depth=depth, prob=prob,
        )

    fusion = DepthFusion(FusionConfig(
        fusion_num=args.fusion_num,
        min_geo_consist=args.min_geo_consist_num,
        photometric_threshold=args.photomatric_threshold,
        position_threshold=args.position_threshold,
        depth_threshold=args.depth_threshold,
        normal_threshold_deg=args.normal_threshold,
        pc_format=args.pc_format,
    ), device=device)
    pair_of = {r: [s for s, _ in p] for r, p in pairs}

    for bi, (bbx, refs) in enumerate(blocks):
        view_list = [
            (name_of[r], [name_of[s] for s in pair_of.get(r, []) if s in name_of])
            for r in refs if r in name_of and name_of[r] in views
        ]
        if not view_list:
            continue
        with torch.no_grad():
            fused = fusion.fuse_block(views, view_list, scene_range=bbx)
        scene = f"scene_{bi}"
        if args.pc_format == "las":
            from ..io.las import write_las

            out = os.path.join(args.output_path, f"{scene}.las")
            write_las(out, fused.xyz, fused.colors)
        else:
            out = os.path.join(args.output_path, f"{scene}.ply")
            write_ply(out, fused.xyz, fused.normals, fused.colors)
        tf.write_border(os.path.join(args.output_path, f"{scene}.txt"), bbx)
        print(f"[fusion] {scene}: {fused.xyz.shape[0]} points -> {out}")


if __name__ == "__main__":
    main()
