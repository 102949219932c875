"""Nothing under portbench imports JAX, Flax or the JAX package: each
module's top-level name compared whole (the port's own name begins with the
JAX package's), in the sources and in ``sys.modules`` after a run."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

PKG = Path(run.__file__).resolve().parent


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_source_imports_a_forbidden_top_level_name():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    found = {(f.name, top) for f in files for top in _imported_tops(f) if top in run.FORBIDDEN}
    assert found == set()
    # a whole-name comparison: the port is allowed though its name begins with one
    assert "roaringbitmap_tpu_torch" not in run.FORBIDDEN
    assert any(top == "roaringbitmap_tpu_torch" for f in files for top in _imported_tops(f))


def test_a_run_leaves_no_forbidden_module_loaded():
    code = (
        "import sys, torch\n"
        "from portbench.tests.helpers import CELLS, tiny_run\n"
        "for cell in CELLS:\n"
        "    res, _ = tiny_run(cell, seconds=0.5)\n"
        "    assert res['correct'], cell\n"
        "from portbench import run\n"
        "print('LOADED', run.forbidden_modules())\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "LOADED []" in p.stdout
