"""compute_dtype bfloat16 through the port's pipeline entry points on the
CPU (device="cpu": the kernels' plain bfloat16 versions), for each model
on seeded random weights: run_dense and run_dense_pipelined (dense
matching and fusion; view selection by the JAX package, as in
tests/test_torch_pipeline_modes.py), batched inference, and the
top-level CLI. The written maps are float32 PFMs, finite, and the same
bytes from every entry point: the same plain versions on the same inputs.
Agreement with the JAX package's bfloat16 is held in
tests/test_torch_bf16_models.py and tests/test_torch_pipeline.py.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.pipeline.config import PipelineConfig as JConfig
from deep3d_aerial_tpu.pipeline.orchestrator import AerialPipeline as JPipeline
from deep3d_aerial_tpu_torch.__main__ import main as port_main
from deep3d_aerial_tpu_torch.io.pfm import read_pfm
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from tests.test_pipeline import build_synthetic_workspace
from tests.test_torch_pipeline import CFG

torch.set_num_threads(1)

MVS = Path("dense") / "MVS"
# 8 planes a stage, seeded random weights, bfloat16
SETTINGS = dict(CFG, ndepths=[8, 8, 8], allow_random_weights=True,
                compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The synthetic workspace (a 2x2 grid of views) with the JAX view
    selection's export/."""
    root = tmp_path_factory.mktemp("bf16")
    ws = build_synthetic_workspace(root / "base", n_grid=2)
    JPipeline(str(ws), JConfig(**CFG)).select_view()
    return ws


def _copy(base: Path, dst: Path) -> Path:
    shutil.copytree(base / "export", dst / "export")
    return dst


def _maps(ws: Path):
    return {p.name: p.read_bytes() for p in sorted((ws / MVS).glob("*.pfm"))}


@pytest.mark.parametrize("model_type", ["adamvs", "msrednet", "casmvsnet", "ucsnet"])
def test_run_dense_and_pipelined_in_bfloat16(base, tmp_path, model_type):
    settings = dict(SETTINGS, model_type=model_type)
    seq = _copy(base, tmp_path / "seq")
    pipe = AerialPipeline(str(seq), PipelineConfig(**settings), device="cpu")
    model = pipe.build_model()
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    pipe.run_dense(model=model)
    maps = _maps(seq)
    assert len(maps) >= 4 * 2  # _init and _prob of every view
    for name in maps:
        d = read_pfm(seq / MVS / name)[0]
        assert d.dtype == np.float32 and d.shape == (64, 96) and np.isfinite(d).all()
    assert list((seq / "dense" / "fusion").glob("scene_*.ply"))

    pip = _copy(base, tmp_path / "pip")
    AerialPipeline(str(pip), PipelineConfig(**settings), device="cpu") \
        .run_dense_pipelined(model=model)
    assert _maps(pip) == maps
    assert list((pip / "dense" / "fusion").glob("scene_*.ply"))


def test_batched_inference_and_cli_in_bfloat16(base, tmp_path):
    """infer_batch_size 2 writes the bytes B = 1 writes; `python -m
    deep3d_aerial_tpu_torch --device cpu` with compute_dtype bfloat16 in
    the YAML writes them too (CasMVSNet)."""
    settings = dict(SETTINGS, model_type="casmvsnet")
    runs = {}
    for batch in (1, 2):
        ws = _copy(base, tmp_path / f"b{batch}")
        pipe = AerialPipeline(str(ws), PipelineConfig(**settings, infer_batch_size=batch),
                              device="cpu")
        pipe.dense_match()
        runs[batch] = _maps(ws)
    assert runs[1] == runs[2] and runs[1]
    cli = _copy(base, tmp_path / "cli")
    cfg = tmp_path / "cfg.yaml"
    PipelineConfig(**settings).to_yaml(cfg)
    assert PipelineConfig.from_yaml(cfg).compute_dtype == "bfloat16"
    port_main(["--workspace", str(cli), "--config", str(cfg), "--device", "cpu"])
    assert _maps(cli) == runs[1]
