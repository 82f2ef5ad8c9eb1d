"""tpurt_torch and chip_smoke.py never import JAX or the JAX package.

An AST scan rather than sys.modules: the test process imports jax anyway.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpurt"}
FILES = sorted((ROOT / "src" / "tpurt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/tpurt_torch/kernels/traverse8.py" in names
    assert {"src/tpurt_torch/kernels/packet.py", "src/tpurt_torch/accel/wavefront.py"} <= names
    assert "torch" in _imported_roots(ROOT / "src/tpurt_torch/kernels/traverse8.py")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_tpurt_import(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
