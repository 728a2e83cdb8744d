"""The port's boundary: it imports neither JAX nor the JAX package, runs on
the GPU unless the caller asks for the CPU, and builds or loads no CUDA
code when its modules are imported."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import deep3d_aerial_tpu_torch

ROOT = Path(deep3d_aerial_tpu_torch.__file__).resolve().parent
REPO = ROOT.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(ROOT)], prefix="deep3d_aerial_tpu_torch."))


def test_importing_every_module_pulls_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    mods = _modules()
    assert "deep3d_aerial_tpu_torch.ops.sweep" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deep3d_aerial_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "import deep3d_aerial_tpu_torch.ops.cuda_build as cb\n"
        "assert not cb._libs, 'a CUDA library was loaded at import'\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_source_names_jax():
    pat = re.compile(r"^\s*(import jax|from jax)|flax|deep3d_aerial_tpu\.",
                     re.MULTILINE)
    hits = [str(p.relative_to(REPO)) for p in ROOT.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh") and pat.search(p.read_text())]
    assert not hits, hits


def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    import torch

    from deep3d_aerial_tpu_torch.pipeline.__main__ import main
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AerialPipeline(str(tmp_path / "ws"), PipelineConfig())
    cfg = tmp_path / "cfg.yaml"
    PipelineConfig().to_yaml(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--workspace", str(tmp_path / "ws"), "--config", str(cfg)])
    # asked for explicitly, the CPU is fine
    AerialPipeline(str(tmp_path / "ws"), PipelineConfig(), device="cpu")


def test_cuda_wrappers_never_take_the_plain_path_for_a_cuda_tensor(monkeypatch):
    """A tensor that says it is on CUDA goes to the kernel launcher, which
    on this machine fails to build: no quiet plain fallback."""
    import torch

    from deep3d_aerial_tpu_torch.ops import cuda_build, red_step2, sweep

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def no_build(name):
        raise RuntimeError(f"build {name}")

    monkeypatch.setattr(cuda_build, "load", no_build)
    t = torch.zeros(4, 4, 8).as_subclass(FakeCuda)
    d = torch.zeros(2, 4, 4).as_subclass(FakeCuda)
    rel = torch.eye(4)
    with pytest.raises((RuntimeError, ValueError)):
        sweep.sweep_corr(t, t, rel, d)
    with pytest.raises((RuntimeError, ValueError)):
        sweep.sweep_cost(t, t[None], rel[None], d, d[:1])
    with pytest.raises((RuntimeError, ValueError)):
        red_step2.red_step2({}, torch.zeros(8, 4, 4).as_subclass(FakeCuda),
                            torch.zeros(8, 4, 4), torch.zeros(16, 2, 2), up=True)
    assert sweep.sweep_corr.launches == sweep.sweep_cost.launches == 0
    assert red_step2.red_step2.launches == 0
