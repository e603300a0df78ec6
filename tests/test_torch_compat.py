"""Port parity: the pyspark/graphframes shim against the JAX package's.

(1) Every case of the JAX package's ``tests/test_compat.py`` runs through
both shims, one after the other in one test: the JAX shim installed, the
case, the shim removed; then the port's shim (``device="cpu"``), the same
case (its source with the imports pointed at the port), removed again.
Each shim refuses the other's modules (a foreign ``pyspark``), so the
first is always uninstalled before the second goes in. (2) A pyspark
script with the reference's idioms (the chip smoke's) prints the same
through ``python -m graphmine_tpu.compat`` and ``python -m
graphmine_tpu_torch.compat --device cpu``.
"""

import inspect
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from graphmine_tpu import compat as jcompat
from graphmine_tpu_torch import compat as tcompat
from _torch_threads import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
_PORT_FRAMES = ('__import__("functools").partial(__import__("graphmine_tpu_torch.frames", '
                'fromlist=["GraphFrame"]).GraphFrame, device="cpu")(')


def _load(port: bool) -> types.ModuleType:
    path = TESTS / "test_compat.py"
    src = path.read_text()
    if port:
        src = src.replace("from graphmine_tpu import compat", "from graphmine_tpu_torch import compat")
        src = src.replace('__import__("graphmine_tpu.frames", fromlist=["GraphFrame"]).GraphFrame(',
                          _PORT_FRAMES)
        for mod in ("table", "frames", "io.edges"):
            src = src.replace(f"graphmine_tpu.{mod}", f"graphmine_tpu_torch.{mod}")
        src = src.replace("compat.install()", 'compat.install(device="cpu")')
        src = src.replace("compat.install(force=True)", 'compat.install(force=True, device="cpu")')
    module = types.ModuleType(f"_{'port' if port else 'jax'}_test_compat")
    module.__file__ = str(path)
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module


_MODULES: dict = {}


def _cases():
    src = (TESTS / "test_compat.py").read_text()
    return [line.split("(")[0][4:] for line in src.splitlines() if line.startswith("def test_")]


def _remove(mods) -> None:
    for name in list(sys.modules):
        if name.split(".", 1)[0] in ("pyspark", "graphframes"):
            del sys.modules[name]


def _run(module, comp, install_kw, fn_name, request, tmp_path_factory):
    fn = getattr(module, fn_name)
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipped in the JAX file"))
    mods = comp.install(**install_kw)
    monkeypatch = pytest.MonkeyPatch()
    try:
        kwargs = {}
        for p in inspect.signature(fn).parameters:
            if p == "shim":
                kwargs[p] = mods
            elif p == "tmp_path":
                kwargs[p] = tmp_path_factory.mktemp(fn_name)
            elif p == "monkeypatch":
                kwargs[p] = monkeypatch
            else:
                kwargs[p] = request.getfixturevalue(p)
                if p == "capsys":
                    kwargs[p].readouterr()
        fn(**kwargs)
    finally:
        monkeypatch.undo()
        _remove(mods)


@pytest.mark.parametrize("fn_name", _cases())
def test_jax_compat_case_through_both_shims(fn_name, request, tmp_path_factory):
    for port in (False, True):
        if port not in _MODULES:
            _MODULES[port] = _load(port)
    _run(_MODULES[False], jcompat, {}, fn_name, request, tmp_path_factory)
    assert "pyspark" not in sys.modules
    _run(_MODULES[True], tcompat, {"device": "cpu"}, fn_name, request, tmp_path_factory)
    assert "pyspark" not in sys.modules


def test_each_shim_refuses_the_others_modules():
    jmods = jcompat.install()
    try:
        with pytest.raises(RuntimeError, match="real pyspark"):
            tcompat.install(device="cpu")
    finally:
        _remove(jmods)
    tmods = tcompat.install(device="cpu")
    try:
        assert "graphmine_tpu_torch compat shim" in sys.modules["pyspark"].__doc__
        with pytest.raises(RuntimeError, match="real pyspark"):
            jcompat.install()
        tcompat.install(device="cpu")  # its own modules: reinstalled
    finally:
        _remove(tmods)


def test_install_resolves_the_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcompat.install()
    assert "pyspark" not in sys.modules


def test_shim_graphs_run_on_the_installed_device():
    mods = tcompat.install(device="cpu")
    try:
        from graphframes import GraphFrame
        from graphmine_tpu_torch.table import Table

        v = tcompat.DataFrame(Table(id=np.array(["a", "b", "c"], dtype=object)))
        e = tcompat.DataFrame(Table(src=np.array(["a", "b"], dtype=object),
                                    dst=np.array(["b", "c"], dtype=object)))
        g = GraphFrame(v, e)
        assert g._gf.device.type == "cpu"
        assert [r["label"] for r in g.labelPropagation(maxIter=1).collect()] == [1, 0, 1]
    finally:
        _remove(mods)


def test_script_prints_the_same_through_both_runners(tmp_path):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from graphmine_tpu_torch import datasets

    src, dst, _, _ = datasets.planted_anomaly_graph(600, 6_000, seed=9)
    chip_smoke.write_outlinks(tmp_path / "data" / "outlinks_pq" / "part-00000.parquet", src, dst,
                              600, null_rows=16)
    script = tmp_path / "script.py"
    script.write_text(chip_smoke.SHIM_SCRIPT)
    outs = []
    for module, extra in (("graphmine_tpu.compat", []),
                          ("graphmine_tpu_torch.compat", ["--device", "cpu"])):
        out = subprocess.run([sys.executable, "-m", module, *extra, "--cwd", str(tmp_path),
                              str(script)], cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append(out.stdout)
    assert outs[0] == outs[1]
    lines = outs[1].splitlines()
    assert int(lines[0]) == len(src) and int(lines[1]) == len(src) - 16
    assert "Communities in the Dataset." in lines[3]
