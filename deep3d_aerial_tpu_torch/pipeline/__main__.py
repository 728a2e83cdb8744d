"""CLI: python -m deep3d_aerial_tpu_torch.pipeline --workspace WS --config cfg.yaml

Runs the ported stages (dense matching, fusion) on a workspace whose
export/ already holds the view selection. `--device` defaults to cuda and
raises when there is no CUDA device; `--device cpu` runs the plain PyTorch
path on the CPU.
"""

import argparse

from .config import PipelineConfig
from .orchestrator import AerialPipeline


def main(argv=None):
    ap = argparse.ArgumentParser(description="aerial MVS pipeline (PyTorch/CUDA)")
    ap.add_argument("--workspace_folder", "--workspace", required=True)
    ap.add_argument("--config", required=True, help="pipeline YAML config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    cfg = PipelineConfig.from_yaml(args.config)
    AerialPipeline(args.workspace_folder, cfg, device=args.device).run_dense()


if __name__ == "__main__":
    main()
