"""The PyTorch port stands alone: no JAX, nothing of graphmine_tpu.

Every module of ``graphmine_tpu_torch`` imports in a process where
``import jax`` fails, and an AST scan of the port's files and of
``chip_smoke.py`` finds no import of ``jax`` or ``graphmine_tpu``
(comments and docstrings may still name the JAX counterparts).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "graphmine_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "graphmine_tpu")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['graphmine_tpu'] = None\n"
        "import graphmine_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'graphmine_tpu_torch.')\n"
        "        if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


_BLOCKED = "import sys\nsys.modules['jax'] = None\nsys.modules['graphmine_tpu'] = None\n"


@pytest.mark.parametrize("module", ["graphmine_tpu_torch.io.native", "graphmine_tpu_torch.ops.ann",
                                    "graphmine_tpu_torch.io.edges", "graphmine_tpu_torch.ops.lof",
                                    "graphmine_tpu_torch.io.factorize", "graphmine_tpu_torch.ops.cc",
                                    "graphmine_tpu_torch.pipeline.checkpoint",
                                    "graphmine_tpu_torch.pipeline.resilience",
                                    "graphmine_tpu_torch.serve.snapshot",
                                    "graphmine_tpu_torch.serve.tenancy",
                                    "graphmine_tpu_torch.obs.histogram",
                                    "graphmine_tpu_torch.obs.sketch",
                                    "graphmine_tpu_torch.obs.quality",
                                    "graphmine_tpu_torch.kernels.knn_cuda",
                                    "graphmine_tpu_torch.obs.spans",
                                    "graphmine_tpu_torch.obs.registry",
                                    "graphmine_tpu_torch.obs.schema",
                                    "graphmine_tpu_torch.obs.heartbeat",
                                    "graphmine_tpu_torch.obs.costmodel",
                                    "graphmine_tpu_torch.obs.memmodel",
                                    "graphmine_tpu_torch.pipeline.metrics",
                                    "graphmine_tpu_torch.pipeline.planner",
                                    "graphmine_tpu_torch.pipeline.config",
                                    "graphmine_tpu_torch.pipeline.driver",
                                    "graphmine_tpu_torch.testing.faults"])
def test_slice_modules_import_without_jax(module):
    code = _BLOCKED + f"import importlib\nimportlib.import_module({module!r})\nprint('ok')\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_parser_is_the_ports_own_library(tmp_path):
    # the port loads its own build of csrc/graph_builder.cpp, never the
    # JAX package's native/libgraphbuild.so
    path = tmp_path / "e.txt"
    path.write_text("a b 1.5\nb c 2\n")
    code = _BLOCKED + (
        "from graphmine_tpu_torch.io.edges import load_edge_list\n"
        f"et = load_edge_list({str(path)!r}, weight_col=2)\n"
        "assert et.names.tolist() == ['a', 'b', 'c'], et.names\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('libgraphbuild' in maps, 'libgraph_builder_' in maps)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]
