"""python -m deep3d_aerial_tpu_torch.train: the training CLI (train/cli.py)."""

from .cli import build, main, parse_args, run

__all__ = ["build", "main", "parse_args", "run"]

if __name__ == "__main__":
    main()
