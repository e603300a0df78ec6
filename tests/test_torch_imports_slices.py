"""The port's modules one by one, each in a process of its own where
``import jax`` and ``import graphmine_tpu`` fail (children forked from one
subprocess that has imported torch, so this list lives in a file of its
own beside ``tests/test_torch_imports.py``, which scans the port's source
and checks its package exports the same way).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_BLOCKED = "import sys\nsys.modules['jax'] = None\nsys.modules['graphmine_tpu'] = None\n"


MODULES = ["graphmine_tpu_torch.io.native", "graphmine_tpu_torch.ops.ann",
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
           "graphmine_tpu_torch.parallel",
           "graphmine_tpu_torch.parallel.ppr"]

# torch and numpy are imported once, with JAX blocked; each module is then
# imported in a child forked from there, so it meets none of the others
_FORKED = _BLOCKED + """
import importlib, json, os, traceback
import numpy, torch
seen = {}
for module in %r:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(module)
            msg = "ok"
        except BaseException:
            msg = traceback.format_exc()
        with os.fdopen(w, "w") as f:
            f.write(msg)
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        msg = f.read()
    _, status = os.waitpid(pid, 0)
    seen[module] = msg if status == 0 else "the child exited with status %%d" %% status
print(json.dumps(seen))
""" % (MODULES,)


@pytest.fixture(scope="module")
def imported():
    out = subprocess.run([sys.executable, "-c", _FORKED], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_slice_modules_import_without_jax(imported, module):
    assert imported[module] == "ok", imported[module]
