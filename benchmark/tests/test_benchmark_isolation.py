"""Nothing a cell runs loads JAX or the JAX package, compared by whole
top-level module names (the program's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT

BANNED = {"jax", "jaxlib", "flax", "graphmine_tpu"}
PROBE = """
import json, sys, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import small_cell
from benchmark import harness
harness.run_cell(small_cell({cell!r}), 3, 0.1, bool({trace}), torch.device("cpu"))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_levels(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_run_loads_neither_jax_nor_the_jax_package(cell):
    tops = _top_levels(PROBE.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"),
                                    cell=cell, trace=cell.endswith("lof")))
    assert "graphmine_tpu_torch" in tops
    assert not tops & BANNED


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.cdlp, benchmark.reference.wcc\n"
            "import benchmark.reference.lof, benchmark.reference.features\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))" % str(ROOT))
    tops = _top_levels(code)
    assert not tops & (BANNED | {"graphmine_tpu_torch"})


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_benchmark_source_names_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & BANNED, path
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "graphmine_tpu_torch" not in _imports(path), path
