"""Top-level CLI alias: python -m deep3d_aerial_tpu_torch is the pipeline's
CLI (`python -m deep3d_aerial_tpu_torch.pipeline`, same flags)."""

from .pipeline.__main__ import main

if __name__ == "__main__":
    main()
