"""CLI: python -m deep3d_aerial_tpu_torch.pipeline --workspace WS --config cfg.yaml
[--data_folder IMAGES] [--pipelined] [--device cuda|cpu]
(`python -m deep3d_aerial_tpu_torch` is the same CLI)

Runs the config's stages: view selection from the COLMAP model in
WS/sparse, dense matching, fusion (PLY + OpenMVS .mvs), the mesh and the
DSM, then copies the products into WS/production (Point_Cloud, Mesh, DSM).
`--data_folder` is the image root that builds
export/image_path.txt when it is absent. `--device` defaults to cuda and
raises when there is no CUDA device; `--device cpu` runs the plain PyTorch
path on the CPU. `--pipelined` fuses and meshes each scene block on a
host thread while dense matching runs (AerialPipeline.run_dense_pipelined),
with the same products as the sequential run.
"""

import argparse

from .config import PipelineConfig
from .orchestrator import AerialPipeline


def main(argv=None):
    ap = argparse.ArgumentParser(description="aerial MVS pipeline (PyTorch/CUDA)")
    ap.add_argument("--workspace_folder", "--workspace", required=True)
    ap.add_argument("--config", required=True, help="pipeline YAML config")
    ap.add_argument("--data_folder", default=None,
                    help="image root (builds export/image_path.txt if absent)")
    ap.add_argument("--pipelined", action="store_true",
                    help="overlap host fusion with device inference")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    cfg = PipelineConfig.from_yaml(args.config)
    pipe = AerialPipeline(args.workspace_folder, cfg, device=args.device,
                          data_folder=args.data_folder)
    if args.pipelined:
        pipe.run_dense_pipelined()
    else:
        pipe.run_dense()


if __name__ == "__main__":
    main()
