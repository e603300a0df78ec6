"""Port parity: the query engine over a published snapshot (CPU).

One store, published from seeded arrays with the port's
``SnapshotStore``, is read by the JAX ``QueryEngine`` and by the port's,
with its gather table on a device (``device="cpu"``) and as the host twin
(``device=False``). Every method answers the same: membership, component,
score, size, decile, neighbours (the JAX host CSR's order), explain,
top-k, the batched gather, the stage keys, memory accounting and the
quality state.
"""

import numpy as np
import pytest

from graphmine_tpu.serve.query import QueryEngine as JQueryEngine
from graphmine_tpu.serve.query import _as_int_ids as j_as_int_ids
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.serve.query import QueryEngine, _as_int_ids
from graphmine_tpu_torch.serve.snapshot import SnapshotStore
from _torch_threads import one_torch_thread  # noqa: F401

V = 300


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("query")
    src, dst, _, comm = datasets.planted_anomaly_graph(V, 2400, seed=12)
    rng = np.random.default_rng(12)
    labels = np.asarray(comm, np.int32)
    labels[rng.integers(0, V, 20)] = 7  # uneven sizes for the deciles
    lof = rng.gamma(4.0, 0.3, V).astype(np.float32)
    lof[5] = lof[9]  # a tie inside the (label, LOF) order
    arrays = {"src": src.astype(np.int32), "dst": dst.astype(np.int32), "labels": labels,
              "cc_labels": np.zeros(V, np.int32), "lof": lof}
    SnapshotStore(str(root / "s")).publish(arrays, fingerprint=graph_fingerprint(src, dst))
    return root / "s", labels


@pytest.fixture(scope="module", params=["cpu", False], ids=["device_cpu", "host_twin"])
def engines(stores, request):
    path, labels = stores
    jeng = JQueryEngine(JSnapshotStore(str(path)).load(), device=request.param is not False)
    peng = QueryEngine(SnapshotStore(str(path)).load(), device=request.param)
    return jeng, peng, labels


def test_single_lookups_match(engines):
    jeng, peng, _ = engines
    for v in range(V):
        assert peng.membership(v) == jeng.membership(v)
        assert peng.component(v) == jeng.component(v)
        assert peng.score(v) == jeng.score(v)
        assert peng.community_size(v) == jeng.community_size(v)
        assert peng.community_decile(v) == jeng.community_decile(v)


def test_neighbors_in_the_jax_host_csr_order(engines):
    jeng, peng, _ = engines
    for v in range(0, V, 7):
        np.testing.assert_array_equal(peng.neighbors(v), jeng.neighbors(v))
    np.testing.assert_array_equal(peng._nbr_ptr, jeng._nbr_ptr)
    assert peng._nbr.dtype == jeng._nbr.dtype and peng._nbr_ptr.dtype == jeng._nbr_ptr.dtype


def test_explain_and_top_outliers_match(engines):
    jeng, peng, labels = engines
    for v in (0, 5, 9, 77, V - 1):
        a, b = peng.explain(v, max_neighbors=6), jeng.explain(v, max_neighbors=6)
        np.testing.assert_array_equal(a.pop("neighbors"), b.pop("neighbors"))
        assert a == b
    for c in np.unique(labels):
        assert peng.top_outliers(int(c), 4) == jeng.top_outliers(int(c), 4)


def test_query_batch_matches(engines):
    jeng, peng, _ = engines
    ids = np.random.default_rng(3).integers(0, V, 257)
    for n in (1, 3, 257):
        a, b = peng.query_batch(ids[:n]), jeng.query_batch(ids[:n])
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
    assert peng.query_batch([3.0])["label"][0] == jeng.query_batch([3.0])["label"][0]
    stages = peng.stage_snapshot()
    assert set(stages) == set(jeng.stage_snapshot()) == {
        "batches", "ids", "pad_seconds", "gather_seconds", "host_seconds"}
    assert stages["batches"] == 4 and stages["ids"] == 262


@pytest.mark.parametrize("bad,err", [([0, V + 7], KeyError), ([-1], KeyError),
                                     ([1.5], ValueError), ([1, None], ValueError)],
                         ids=["past_v", "negative", "fractional", "null"])
def test_query_batch_refusals_match(engines, bad, err):
    jeng, peng, _ = engines
    with pytest.raises(err):
        jeng.query_batch(bad)
    with pytest.raises(err):
        peng.query_batch(bad)


def test_lookup_refusals_match(engines):
    jeng, peng, _ = engines
    for eng in (jeng, peng):
        with pytest.raises(KeyError):
            eng.membership(V + 1)
        with pytest.raises(KeyError):
            eng.top_outliers(10 ** 6, 3)


def test_memory_and_quality_state_match(engines):
    jeng, peng, _ = engines
    assert peng.memory_bytes() == jeng.memory_bytes()
    assert peng.quality_state(build=False) is None
    assert peng.quality_state().payload() == jeng.quality_state().payload()
    assert peng.lof_stale == jeng.lof_stale is False
    assert peng.version == jeng.version == 1


@pytest.mark.parametrize("values", [[1, 2], [4.0, 5.0], [], np.arange(3, dtype=np.int16)])
def test_as_int_ids_matches(values):
    np.testing.assert_array_equal(_as_int_ids(values, "v"), j_as_int_ids(values, "v"))
    assert _as_int_ids(values, "v").dtype == np.int64


@pytest.mark.parametrize("values", [[1.5], [np.inf], ["a"], [[1], [2, 3]]])
def test_as_int_ids_refusals_match(values):
    with pytest.raises(ValueError):
        j_as_int_ids(values, "v")
    with pytest.raises(ValueError):
        _as_int_ids(values, "v")


def test_engine_defaults_to_cuda(stores):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine(SnapshotStore(str(stores[0])).load())
