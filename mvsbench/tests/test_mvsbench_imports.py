"""Nothing under mvsbench/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deep3d_aerial_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): sorted(set(imported(p)) & FORBIDDEN)
             for p in ROOT.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    found = {str(p.relative_to(ROOT)): sorted(n for n in imported(p)
                                              if n.startswith("deep3d_aerial_tpu"))
             for p in (ROOT / "reference").rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's and is allowed
    assert "deep3d_aerial_tpu_torch" not in FORBIDDEN
    from mvsbench import run
    assert set(run.FORBIDDEN) >= FORBIDDEN
    import sys
    sys.modules.setdefault("deep3d_aerial_tpu_torch_probe", sys)
    try:
        assert "deep3d_aerial_tpu_torch_probe" not in run.loaded_forbidden()
    finally:
        del sys.modules["deep3d_aerial_tpu_torch_probe"]
