"""No module of the port imports jax, or the JAX package: every import
statement of ``sgracex1_tpu_torch`` read with ``ast``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "sgracex1_tpu_torch"
MODULES = sorted(ROOT.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sgracex1_tpu")]
    assert not bad, f"{path}: imports {bad}"


def test_every_port_package_is_walked():
    names = {str(p.relative_to(ROOT)) for p in MODULES}
    assert {"utils/roofline.py", "utils/power.py", "graft_entry.py", "examples/ppi_gat.py",
            "ops/dispatch.py"} <= names
