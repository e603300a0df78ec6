"""Port parity: the backend boundary (``pipeline/backends.py``) and
``PipelineConfig.backend`` against the JAX package: the same names,
default, validation and refusals. No pyspark is installed here, so
``backend="graphframes"`` raises ``GraphFramesUnavailable`` in both."""

import sys

import numpy as np
import pytest

from graphmine_tpu.pipeline import backends as jbackends
from graphmine_tpu.pipeline.config import PipelineConfig as JConfig
from graphmine_tpu.pipeline.config import parse_args as jparse_args

from graphmine_tpu_torch.io.edges import from_arrays
from graphmine_tpu_torch.pipeline import PipelineConfig, backends, run_pipeline
from graphmine_tpu_torch.pipeline.config import parse_args
from _torch_threads import one_torch_thread  # noqa: F401


def _real_pyspark_absent():
    import importlib.util

    return "pyspark" not in sys.modules and importlib.util.find_spec("pyspark") is None


def test_names_and_default_match():
    assert PipelineConfig().backend == JConfig().backend == "jax"
    assert backends.MAX_BRIDGE_EDGES == jbackends.MAX_BRIDGE_EDGES
    assert issubclass(backends.GraphFramesUnavailable, RuntimeError)


@pytest.mark.parametrize("kw,match", [
    ({"backend": "spark"}, "unknown backend"),
    ({"backend": "graphframes", "community_method": "louvain"}, "only provides labelPropagation"),
    ({"backend": "graphframes", "data_format": "edgelist", "edge_weight_col": 2},
     "unweighted labelPropagation"),
])
def test_validation_matches(kw, match):
    with pytest.raises(ValueError, match=match):
        JConfig(**kw).validate()
    with pytest.raises(ValueError, match=match):
        PipelineConfig(**kw).validate()


def test_cli_flag():
    assert parse_args(["--backend", "graphframes"]).backend == "graphframes"
    assert jparse_args(["--backend", "graphframes"]).backend == "graphframes"
    with pytest.raises(ValueError, match="unknown backend"):
        parse_args(["--backend", "nope"])


def test_bridge_refuses_past_its_cap():
    n = backends.MAX_BRIDGE_EDGES + 1
    et = from_arrays(np.zeros(n, np.int32), np.ones(n, np.int32), names=np.array(["a", "b"]))
    with pytest.raises(ValueError, match="capped"):
        backends.lpa_graphframes(et, 5)


def test_bridge_without_pyspark_raises_unavailable():
    if not _real_pyspark_absent():
        pytest.skip("a pyspark is importable here")
    et = from_arrays(np.array([0, 1], np.int32), np.array([1, 2], np.int32))
    with pytest.raises(jbackends.GraphFramesUnavailable):
        jbackends.lpa_graphframes(et, 5)
    with pytest.raises(backends.GraphFramesUnavailable, match="pyspark"):
        backends.lpa_graphframes(et, 5)


def test_pipeline_dispatches_to_the_bridge(tmp_path):
    if not _real_pyspark_absent():
        pytest.skip("a pyspark is importable here")
    path = tmp_path / "e.txt"
    path.write_text("a b\nb c\nc a\n")
    with pytest.raises(backends.GraphFramesUnavailable):
        run_pipeline(PipelineConfig(data_path=str(path), data_format="edgelist",
                                    backend="graphframes", device="cpu"))
    res = run_pipeline(PipelineConfig(data_path=str(path), data_format="edgelist",
                                      outlier_method="none", device="cpu"))
    assert res.num_communities >= 1


def test_bridge_runs_through_an_installed_graphframes(monkeypatch):
    # a stand-in pyspark/graphframes pair shows what the bridge asks of them
    import types

    rows = {}

    class _DF:
        def __init__(self, data, cols):
            self.data, self.cols = data, cols

        def select(self, *cols):
            return self

        def collect(self):
            return [{"id": i, "label": i % 2} for i, _ in self.data]

    class _Session:
        def createDataFrame(self, data, cols):
            rows[tuple(cols)] = data
            return _DF(data, cols)

        def stop(self):
            rows["stopped"] = True

    builder = types.SimpleNamespace(appName=lambda n: types.SimpleNamespace(
        getOrCreate=lambda: _Session()))
    sql = types.ModuleType("pyspark.sql")
    sql.SparkSession = types.SimpleNamespace(builder=builder)
    pyspark = types.ModuleType("pyspark")
    pyspark.sql = sql
    gf_mod = types.ModuleType("graphframes")

    class _GF:
        def __init__(self, v, e):
            self.v = v

        def labelPropagation(self, maxIter):
            rows["maxIter"] = maxIter
            return self.v

    gf_mod.GraphFrame = _GF
    for name, mod in (("pyspark", pyspark), ("pyspark.sql", sql), ("graphframes", gf_mod)):
        monkeypatch.setitem(sys.modules, name, mod)
    et = from_arrays(np.array([0, 1, 2], np.int32), np.array([1, 2, 3], np.int32),
                     names=np.array(["a", "b", "c", "d"]))
    labels = backends.lpa_graphframes(et, 7)
    assert labels.tolist() == [0, 1, 0, 1] and rows["maxIter"] == 7 and rows["stopped"]
    assert rows[("src", "dst")] == [(0, 1), (1, 2), (2, 3)]
