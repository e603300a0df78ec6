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
                                    "graphmine_tpu_torch.testing.faults",
                                    "graphmine_tpu_torch.ops.streaming_lof",
                                    "graphmine_tpu_torch.obs.alerts",
                                    "graphmine_tpu_torch.serve",
                                    "graphmine_tpu_torch.serve.admission",
                                    "graphmine_tpu_torch.serve.delta",
                                    "graphmine_tpu_torch.serve.query",
                                    "graphmine_tpu_torch.serve.server",
                                    "graphmine_tpu_torch.serve.__main__",
                                    "graphmine_tpu_torch.serve.wal",
                                    "graphmine_tpu_torch.serve.shardplane",
                                    "graphmine_tpu_torch.serve.fleet",
                                    "graphmine_tpu_torch.serve.fleet_cli",
                                    "graphmine_tpu_torch.ops.louvain",
                                    "graphmine_tpu_torch.ops.modularity",
                                    "graphmine_tpu_torch.ops.segment",
                                    "graphmine_tpu_torch.ops.degrees",
                                    "graphmine_tpu_torch.ops.paths",
                                    "graphmine_tpu_torch.ops.scc",
                                    "graphmine_tpu_torch.ops.kcore",
                                    "graphmine_tpu_torch.ops.aggregate",
                                    "graphmine_tpu_torch.ops.motifs",
                                    "graphmine_tpu_torch.ops.stats",
                                    "graphmine_tpu_torch.ops.cluster_metrics",
                                    "graphmine_tpu_torch.parallel"])
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


def test_package_exports_the_graph_ops_without_jax():
    # the package-level names resolve to the port's own functions
    code = _BLOCKED + (
        "import graphmine_tpu_torch as p\n"
        "names = [n for n in p.__all__ if n != 'resolve_device']\n"
        "mods = {getattr(p, n).__module__ for n in names}\n"
        "assert all(m.startswith('graphmine_tpu_torch.') for m in mods), mods\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


FRAMES_SLICE = ("ops._threefry", "ops.pagerank", "ops.centrality", "ops.mis", "ops.ktruss",
                "ops.linkpred", "ops.embedding", "ops.svdpp", "oracle", "table", "frames",
                "compat", "pipeline.backends")


def test_frames_slice_modules_import_without_jax():
    # each module alone, in one process: a fresh import of every one
    code = _BLOCKED + (
        "import importlib\n"
        f"for name in {FRAMES_SLICE!r}:\n"
        "    for m in [m for m in sys.modules if m.startswith('graphmine_tpu_torch')]:\n"
        "        del sys.modules[m]\n"
        "    importlib.import_module('graphmine_tpu_torch.' + name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_package_exports_the_frames_surface_under_the_jax_names():
    # every name the JAX package exports for the front ends and the ops
    # behind them resolves in the port, to the port's own object
    code = _BLOCKED + (
        "import graphmine_tpu_torch as p\n"
        "names = ['GraphFrame', 'Table', 'read_parquet', 'pagerank',\n"
        "         'parallel_personalized_pagerank', 'hits', 'eigenvector_centrality',\n"
        "         'katz_centrality', 'closeness_centrality', 'betweenness_centrality',\n"
        "         'maximal_independent_set', 'greedy_color', 'k_truss', 'link_prediction',\n"
        "         'spectral_embedding', 'svd_plus_plus', 'svdpp_predict',\n"
        "         'graphx_label_propagation']\n"
        "assert set(names) <= set(p.__all__), set(names) - set(p.__all__)\n"
        "mods = {getattr(p, n).__module__ for n in names}\n"
        "assert all(m.startswith('graphmine_tpu_torch.') for m in mods), mods\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "18"


def test_compat_runner_takes_a_device_flag_without_jax(tmp_path):
    script = tmp_path / "s.py"
    script.write_text("import pyspark, sys\n"
                      "assert 'graphmine_tpu_torch compat shim' in pyspark.__doc__\n"
                      "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
                      "print('ran')\n")
    code = _BLOCKED + (
        "from graphmine_tpu_torch import compat\n"
        f"compat.main(['--device', 'cpu', {str(script)!r}])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ran"


def test_blocked_family_exported_under_the_jax_names_without_jax():
    # the blocked slice's names at the package level and under ops, each
    # the port's own object, in a process where JAX cannot be imported
    code = _BLOCKED + (
        "import graphmine_tpu_torch as p, graphmine_tpu_torch.ops as o\n"
        "names = ['BlockedPlan', 'blocked_inflow', 'build_graph_and_blocked_plan',\n"
        "         'cc_superstep_blocked', 'lpa_superstep_blocked', 'select_superstep_family']\n"
        "for mod in (p, o):\n"
        "    assert set(names) <= set(mod.__all__), set(names) - set(mod.__all__)\n"
        "    objs = [getattr(mod, n) for n in names]\n"
        "    assert {x.__module__ for x in objs} == {'graphmine_tpu_torch.ops.blocking'}\n"
        "from graphmine_tpu_torch.datasets import LADDER, LadderRung, load, snap_path\n"
        "from graphmine_tpu_torch.ops.bucketed_mode import bucketed_mode\n"
        "from graphmine_tpu_torch.ops.census import intra_community_edge_mask\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "6"


def test_parallel_exported_under_the_jax_names_without_jax():
    # graphmine_tpu_torch.parallel exports the JAX package's names, each
    # the port's own object, in a process where JAX cannot be imported
    import graphmine_tpu.parallel as jpar

    names = sorted(jpar.__all__)
    code = _BLOCKED + (
        "import graphmine_tpu_torch as p, graphmine_tpu_torch.parallel as par\n"
        f"names = {names!r}\n"
        "assert set(names) == set(par.__all__), set(names) ^ set(par.__all__)\n"
        "mods = {getattr(par, n).__module__ for n in names}\n"
        "assert all(m.startswith('graphmine_tpu_torch.parallel') for m in mods), mods\n"
        "for n in ('recursive_lpa_outliers_sharded', 'sharded_superstep_cost',\n"
        "          'sharded_superstep_footprint'):\n"
        "    assert getattr(p, n).__module__.startswith('graphmine_tpu_torch.'), n\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(len(names))
