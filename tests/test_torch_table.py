"""Port parity: the relational ``Table`` against the JAX package's.

Two parts. (1) Every test of the JAX package's ``tests/test_table.py``
and ``tests/test_table_relational.py`` runs again with the port's
``Table`` in place of the JAX one (the module's source, its imports
pointed at the port): the port gives the results those tests pin. (2)
Seeded tables go through the same operations on both ``Table`` classes
and the results are compared column by column (host NumPy on both sides:
equal values, dtypes and null cells).
"""

import inspect
import os
import types
from pathlib import Path

import numpy as np
import pytest

from graphmine_tpu import table as jtable
from graphmine_tpu_torch import table as ttable
from _torch_threads import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
JAX_FILES = ("test_table.py", "test_table_relational.py")


def _port_module(name: str) -> types.ModuleType:
    """The JAX test module ``name`` with ``graphmine_tpu.table`` (and the
    edge-table bridge) read from the port."""
    path = TESTS / name
    src = path.read_text()
    for mod in ("table", "io.edges"):
        src = src.replace(f"graphmine_tpu.{mod}", f"graphmine_tpu_torch.{mod}")
    module = types.ModuleType(f"_port_{path.stem}")
    module.__file__ = str(path)
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module


def _cases():
    out = []
    for name in JAX_FILES:
        src = (TESTS / name).read_text()
        out += [(name, line.split("(")[0][4:]) for line in src.splitlines()
                if line.startswith("def test_")]
    return out


_MODULES: dict = {}


def _skip_reason(fn):
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            return mark.kwargs.get("reason", "skipped in the JAX file")
    return None


@pytest.mark.parametrize("case", _cases(), ids=lambda c: f"{c[0][:-3]}::{c[1]}")
def test_jax_table_tests_pass_on_the_port(case, request):
    name, fn_name = case
    if name not in _MODULES:
        _MODULES[name] = _port_module(name)
    module = _MODULES[name]
    assert module.Table is ttable.Table
    fn = getattr(module, fn_name)
    reason = _skip_reason(fn)
    if reason:
        pytest.skip(reason)
    kwargs = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    fn(**kwargs)


# ---- the same operations on both Tables ------------------------------------


def _frame(seed: int, n: int = 400) -> dict:
    rng = np.random.default_rng(seed)
    keys = np.array([f"k{i}" for i in rng.integers(0, 12, n)], dtype=object)
    keys[rng.random(n) < 0.1] = None
    names = np.array([f"d{i}.com" for i in rng.integers(0, 40, n)], dtype=object)
    names[rng.random(n) < 0.05] = None
    return {"key": keys, "name": names, "x": rng.integers(-50, 50, n),
            "y": rng.normal(size=n).round(3), "z": rng.integers(0, 3, n)}


def _same(a, b):
    da, db = a.to_dict(), b.to_dict()
    assert list(da) == list(db)
    for col in da:
        ca, cb = np.asarray(da[col]), np.asarray(db[col])
        assert ca.dtype == cb.dtype and ca.shape == cb.shape, col
        if ca.dtype == object:
            assert [x if x == x else "nan" for x in ca] == [x if x == x else "nan" for x in cb]
        else:
            np.testing.assert_array_equal(ca, cb)


OPS = {
    "filter_sql": lambda T, d: T(d).filter("key is not null and x > 3 and name like 'd1%'"),
    "filter_or": lambda T, d: T(d).filter("z = 1 or y < -0.5"),
    "select_rename": lambda T, d: T(d).select("name", "x").with_column_renamed("x", "w"),
    "distinct": lambda T, d: T(d).select("key", "z").distinct(),
    "sort": lambda T, d: T(d).sort("key", "x"),
    "group_agg": lambda T, d: T(d).group_by("key").agg(n=("x", "count"), s=("x", "sum"),
                                                      m=("y", "mean"), lo=("name", "min")),
    "group_count": lambda T, d: T(d).group_by("z", "key").count(),
    "join_inner": lambda T, d: T(d).join(T(_frame(9)).select("key", "y"), on="key"),
    "join_left": lambda T, d: T(d).join(T(_frame(9)).select("key", "z"), on="key", how="left"),
    "join_anti": lambda T, d: T(d).join(T(_frame(8)).select("name"), on="name", how="anti"),
    "dropna_fillna": lambda T, d: T(d).dropna().union(T(d).fillna("none")),
    "limit_subtract": lambda T, d: T(d).limit(50).subtract(T(d).limit(10)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", sorted(OPS))
def test_operations_agree(op, seed):
    data = _frame(seed)
    try:
        want = OPS[op](jtable.Table, data)
    except Exception as e:  # the port must refuse what the JAX package refuses
        with pytest.raises(type(e)):
            OPS[op](ttable.Table, data)
        return
    _same(want, OPS[op](ttable.Table, data))


def test_flat_map_distinct_and_edge_table_bridge():
    data = _frame(3)
    j, t = jtable.Table(data), ttable.Table(data)
    assert np.array_equal(j.flat_map_distinct("key", "name"), t.flat_map_distinct("key", "name"))
    je, te = j.to_edge_table("key", "name"), t.to_edge_table("key", "name")
    for f in ("src", "dst", "names"):
        assert np.array_equal(getattr(je, f), getattr(te, f)), f
    assert je.num_rows_raw == te.num_rows_raw and je.num_vertices == te.num_vertices


def test_parquet_round_trip_between_packages(tmp_path):
    data = _frame(4)
    jtable.Table(data).write_parquet(str(tmp_path / "a.parquet"))
    back = ttable.read_parquet(str(tmp_path / "a.parquet"))
    _same(jtable.read_parquet(str(tmp_path / "a.parquet")), back)
    assert os.path.getsize(tmp_path / "a.parquet") > 0
