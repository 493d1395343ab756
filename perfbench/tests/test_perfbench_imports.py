"""No module under perfbench/ imports the JAX stack or the JAX package,
and the references import nothing of the program. Top-level module names
(the part before the first dot) are compared whole: asm_tpu_torch starts
with asm_tpu but is another name."""

from __future__ import annotations

import ast
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "asm_tpu"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def modules(folder=PKG):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    for path in modules():
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"
        seen += 1
    assert seen > 20


def test_references_import_nothing_of_the_program():
    for path in modules(os.path.join(PKG, "reference")):
        names = top_level_imports(path)
        assert "asm_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "torch", "perfbench"}, (
            path, names)


def test_the_checker_tells_the_names_apart(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import asm_tpu_torch.kernels\nfrom asm_tpu_torch import x\n")
    assert top_level_imports(str(p)) & FORBIDDEN == set()
    p.write_text("from asm_tpu.kernels import nw\n")
    assert top_level_imports(str(p)) & FORBIDDEN == {"asm_tpu"}
