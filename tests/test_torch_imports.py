"""Import boundary of the PyTorch port: no file under src/repro_torch/,
and not chip_smoke.py, imports jax or any module of the JAX package
`repro` — the machine with the card has no JAX, and the port keeps its
own copies of the host code it needs."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: Path) -> set:
    """Top-level names of every module the file imports, at any depth
    (function bodies included)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (REPO / "src" / "repro_torch" / "kernels" / "registry.py") \
        .is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_repro_imports(path):
    bad = imported_modules(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scanner_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from repro.core import ops\n"
                     "    import jax.numpy as jnp\n"
                     "import importlib\nimportlib.import_module('jax')\n")
    assert imported_modules(probe) >= {"repro", "jax"}
