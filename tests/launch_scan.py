"""The AST scan that holds a kernel wrapper module's launches to its
tensors' card: every call of a lib.tpurt_* entry point sits inside a
`with _build.on_device(...)` (tests/test_torch_closest_design.py and
tests/test_torch_segsum.py use it)."""

import ast
import pathlib


def launches_outside_on_device(path: pathlib.Path) -> list:
    """Calls of a lib.tpurt_* entry point (the error-string lookup aside)
    that no `with _build.on_device(...)` encloses."""
    tree = ast.parse(path.read_text(), filename=str(path))
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                isinstance(i.context_expr, ast.Call)
                and ast.unparse(i.context_expr.func) == "_build.on_device" for i in node.items):
            inside.update(id(n) for n in ast.walk(node))
    return [ast.unparse(n.func) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr.startswith("tpurt_") and n.func.attr != "tpurt_error_string"
            and id(n) not in inside]
