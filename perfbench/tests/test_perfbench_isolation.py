"""Nothing under perfbench/ imports jax, jaxlib, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the references import nothing of ``repro_torch``."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

from conftest import ROOT
from perfbench import harness

BENCH = ROOT / "perfbench"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = top_level_imports(f) & set(harness.FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_references_import_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = top_level_imports(f)
        assert "repro_torch" not in names, f
        assert names <= {"__future__", "math", "numpy", "typing", "torch"}, \
                (f, names)


def test_the_comparison_is_by_whole_top_level_name():
    assert top_level_imports(BENCH / "entries" / "kv.py") >= {"repro_torch"}
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_extra.x"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["repro.core"] = sys
        assert harness.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
