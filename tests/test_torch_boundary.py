"""The port's boundary: it imports neither JAX nor the JAX package, runs on
the GPU unless the caller asks for the CPU, builds or loads no CUDA code
and no native library when its modules are imported, and builds its native
library from native/ itself (never the JAX package's `_native/`)."""

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
    for m in ("ops.sweep", "ops.cf_conv", "ops.red_step4", "models.msrednet",
              "models.casmvsnet", "models.ucsnet", "sparse.colmap",
              "sparse.view_selection", "mesh.reconstruct", "mesh.refine",
              "mesh.clean", "mesh.atlas", "mesh.texture", "mesh.trimesh_io",
              "mesh.openmvs_config", "dsm.rasterize", "io.mvs_interface",
              "io.geotiff", "utils.native", "ops.autograd", "pipeline.augment",
              "train", "train.__main__", "train.losses", "train.metrics",
              "train.optim", "train.step", "train.checkpoint", "train.trainer",
              "train.dataset_whu", "train.tb_writer", "__main__", "io.dmap",
              "io.las", "io.tiles", "fusion.__main__", "fusion.evaluate",
              "utils.logging", "pipeline.colormaps"):
        assert f"deep3d_aerial_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deep3d_aerial_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "import deep3d_aerial_tpu_torch.ops.cuda_build as cb\n"
        "assert not cb._libs, 'a CUDA library was loaded at import'\n"
        "import deep3d_aerial_tpu_torch.utils.native as nat\n"
        "assert nat._LIB is None, 'the native library was loaded at import'\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_every_module_imports_first():
    """Each module of the port imports as the first of the port's modules
    a program loads (no import cycle that only some orders survive): in a
    fresh interpreter, the port's modules are dropped from sys.modules
    before each import, so that each import runs the package's own from
    scratch (torch and numpy stay loaded, to keep it quick)."""
    mods = _modules()
    assert "deep3d_aerial_tpu_torch.parallel.context" in mods
    code = (
        "import importlib, sys, traceback\n"
        "import numpy, torch\n"
        "bad = []\n"
        f"for m in {mods!r}:\n"
        "    for k in [k for k in sys.modules if k.split('.')[0] == "
        "'deep3d_aerial_tpu_torch']:\n"
        "        del sys.modules[k]\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except Exception:\n"
        "        bad.append((m, traceback.format_exc(limit=-3)))\n"
        "assert not bad, bad\n"
        "import deep3d_aerial_tpu_torch.parallel as par\n"
        "from deep3d_aerial_tpu_torch.train.step import make_train_step\n"
        "assert par.make_train_step is make_train_step\n"
        "print('ok')\n"
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


def test_native_library_builds_from_native_into_build():
    """No port file names the JAX package's `_native/` directory; the
    library is built from native/*.cc into build/native/, which .gitignore
    lists."""
    from deep3d_aerial_tpu_torch.utils import native

    pat = re.compile(r"[\\/\"']_native\b")
    hits = [str(p.relative_to(REPO)) for p in ROOT.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh") and pat.search(p.read_text())]
    assert not hits, hits
    assert native._NATIVE == REPO / "native"
    assert all((native._NATIVE / s).is_file() for s in native.SOURCES)
    assert native.library_path().parent == REPO / "build" / "native"
    assert "build/" in (REPO / ".gitignore").read_text().split()


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
    # the pipelined run, through its CLI flag and the top-level alias
    from deep3d_aerial_tpu_torch.__main__ import main as alias_main

    for cli in (main, alias_main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(["--workspace", str(tmp_path / "ws"), "--config", str(cfg),
                 "--pipelined"])
    # the standalone fusion CLI, before it reads anything
    from deep3d_aerial_tpu_torch.fusion.__main__ import main as fusion_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        fusion_main(["--project_folder", str(tmp_path / "none"), "--mvs_path",
                     str(tmp_path / "none"), "--output_path", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    # asked for explicitly, the CPU is fine
    AerialPipeline(str(tmp_path / "ws"), PipelineConfig(), device="cpu")

    # training: the Trainer and the train CLI
    from deep3d_aerial_tpu_torch.train.__main__ import main as train_main
    from deep3d_aerial_tpu_torch.train.trainer import Trainer, TrainerConfig

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(torch.nn.Linear(1, 1), TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--data_folder", str(tmp_path / "data")])
    Trainer(torch.nn.Linear(1, 1), TrainerConfig(), device="cpu")


def test_cuda_wrappers_never_take_the_plain_path_for_a_cuda_tensor(monkeypatch):
    """A tensor that says it is on CUDA goes to the kernel launcher, which
    on this machine fails to build: no quiet plain fallback."""
    import torch

    from deep3d_aerial_tpu_torch.ops import cf_conv, cuda_build, red_step2, red_step4, sweep

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
        sweep.sweep_corr(t, t[None], rel[None], d)
    with pytest.raises((RuntimeError, ValueError)):
        sweep.sweep_cost(t, t[None], rel[None], d, d[:1])
    with pytest.raises((RuntimeError, ValueError)):
        red_step2.red_step2({}, torch.zeros(8, 4, 4).as_subclass(FakeCuda),
                            torch.zeros(8, 4, 4), torch.zeros(16, 2, 2), up=True)
    with pytest.raises((RuntimeError, ValueError)):
        sweep.sweep_var(t, t[None], rel[None], d)
    with pytest.raises((RuntimeError, ValueError)):
        cf_conv.cf_conv3x3(torch.zeros(8, 4, 4).as_subclass(FakeCuda),
                           torch.zeros(8, 8, 3, 3), torch.zeros(8))
    states = [torch.zeros(c, 8 >> l, 8 >> l) for l, c in enumerate((8, 16, 32, 64))]
    with pytest.raises((RuntimeError, ValueError)):
        red_step4.red_step4({}, torch.zeros(8, 8, 8).as_subclass(FakeCuda),
                            *states)
    assert sweep.sweep_corr.launches == sweep.sweep_cost.launches == 0
    assert sweep.sweep_var.launches == 0
    assert red_step2.red_step2.launches == red_step4.red_step4.launches == 0
    assert cf_conv.cf_conv3x3.launches == 0


def test_cuda_wrappers_never_take_the_plain_path_for_a_cuda_bf16_tensor(monkeypatch):
    """bfloat16 raises or launches: a bfloat16 tensor that says it is on
    CUDA goes to the launcher of the kernel's bfloat16 mode, which on this
    machine fails to build, never to the plain version or an upcast to the
    float32 kernel."""
    import torch

    from deep3d_aerial_tpu_torch.ops import cf_conv, cuda_build, red_step2, red_step4, sweep

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    built = []

    def no_build(name):
        built.append(name)
        raise RuntimeError(f"build {name}")

    monkeypatch.setattr(cuda_build, "load", no_build)
    bf = torch.bfloat16

    def fake(*shape):
        return torch.zeros(*shape, dtype=bf).as_subclass(FakeCuda)

    t, d = fake(4, 4, 8), torch.zeros(2, 4, 4).as_subclass(FakeCuda)
    rel = torch.eye(4).as_subclass(FakeCuda)[None]
    with pytest.raises(RuntimeError, match="build sweep"):
        sweep.sweep_corr(t, t[None], rel, d)
    with pytest.raises(RuntimeError, match="build sweep"):
        sweep.sweep_cost(t, t[None], rel, d, torch.ones(1, 4, 4).as_subclass(FakeCuda))
    with pytest.raises(RuntimeError, match="build sweep"):
        sweep.sweep_var(t, t[None], rel, d)
    with pytest.raises((RuntimeError, ValueError)):
        red_step2.red_step2({}, fake(8, 4, 4), fake(8, 4, 4), fake(16, 2, 2), up=True,
                            packed=torch.zeros(4).as_subclass(FakeCuda))
    with pytest.raises((RuntimeError, ValueError)):
        cf_conv.cf_conv3x3(fake(8, 4, 4), torch.zeros(8, 8, 3, 3), torch.zeros(8),
                           packed=torch.zeros(4).as_subclass(FakeCuda))
    with pytest.raises((RuntimeError, ValueError)):
        red_step4.red_step4({}, fake(8, 8, 8),
                            *[fake(c, 8 >> l, 8 >> l) for l, c in enumerate((8, 16, 32, 64))],
                            packed=torch.zeros(4).as_subclass(FakeCuda))
    assert built[:3] == ["sweep"] * 3
    assert sweep.sweep_corr.launches == sweep.sweep_cost.launches == 0
    assert sweep.sweep_var.launches == 0
    assert red_step2.red_step2.launches == red_step4.red_step4.launches == 0
    assert cf_conv.cf_conv3x3.launches == 0
    for fn in (sweep.sweep_corr, sweep.sweep_cost, sweep.sweep_var, red_step2.red_step2,
               red_step4.red_step4, cf_conv.cf_conv3x3):
        assert fn.launches_bf16 == 0
