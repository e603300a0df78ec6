"""Port parity: Louvain and Leiden against the JAX package (CPU).

The inputs are ``tests/test_louvain.py``'s (two cliques, the ring of
cliques, the same-parity singletons, its SBM and R-MAT seeds, the SBM of
``tests/test_cluster_metrics.py``) and one graph with weights in quarters.
On all of them every weight sum is exact in float32, so the labels must be
bit-equal to the JAX package's. Q is a float32 sum of squares in both
packages, reduced in another order: it must agree within Q_TOL (1.5e-8
measured). On weights that are not exact in float32 the run sums are
order-dependent: Q within Q_TOL and the partitions agree (NMI >= 0.99).

The pipeline with ``community_method`` set runs against the JAX driver
with ``num_devices=1``: labels, census, recursive-LPA flags and the record
phases equal (apart from the port-only phases), LOF within rtol 1e-4, and
a store published from a Louvain run loads in both packages.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.io import native as jnative
from graphmine_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.io.edges import load_edge_list
from graphmine_tpu_torch.obs.schema import PORT_PHASES
from graphmine_tpu_torch.ops.cluster_metrics import normalized_mutual_info
from graphmine_tpu_torch.ops.modularity import message_weights, modularity, modularity_weighted
from graphmine_tpu_torch.pipeline import PipelineConfig, driver, run_pipeline
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.pipeline.config import parse_args
from graphmine_tpu_torch.serve.snapshot import SnapshotStore

jlouvain = importlib.import_module("graphmine_tpu.ops.louvain")
jmodularity = importlib.import_module("graphmine_tpu.ops.modularity")
plouvain = importlib.import_module("graphmine_tpu_torch.ops.louvain")

Q_TOL = 1e-6


def _cliques(sizes_edges):
    src, dst = np.array(sizes_edges, np.int32).T
    return src, dst


def _two_cliques():
    edges = [(b + i, b + j) for b in (0, 4) for i in range(4) for j in range(i + 1, 4)]
    return (*_cliques(edges + [(0, 4)]), 8, None)


def _ring_of_cliques():
    s, r = 5, 8
    edges = []
    for c in range(r):
        base = c * s
        edges += [(base + i, base + j) for i in range(s) for j in range(i + 1, s)]
        edges.append((base, ((c + 1) % r) * s))
    return (*_cliques(edges), s * r, None)


def _sbm(sizes, p_in, p_out, seed):
    src, dst, blocks = datasets.sbm(sizes, p_in, p_out, seed=seed)
    return src, dst, len(blocks), None


def _rmat(seed):
    src, dst = datasets.rmat(10, 8, seed=seed)
    return src, dst, 1 << 10, None


def _quarters():
    src, dst, v, _ = _sbm([100] * 4, 0.1, 0.01, 4)
    w = np.random.default_rng(1).integers(1, 16, len(src)) / 4
    return src, dst, v, w


CASES = {
    "two_cliques": _two_cliques,
    "ring_of_cliques": _ring_of_cliques,
    "same_parity_pair": lambda: (np.array([0], np.int32), np.array([2], np.int32), 3, None),
    "even_path": lambda: (np.array([0, 2, 4], np.int32), np.array([2, 4, 6], np.int32), 7, None),
    "sbm_seed2": lambda: _sbm([150] * 4, 0.06, 0.004, 2),
    "rmat_seed3": lambda: _rmat(3),
    "rmat_seed7": lambda: _rmat(7),
    "sbm_seed9": lambda: _sbm([120] * 5, 0.08, 0.003, 9),
    "sbm_seed5": lambda: _sbm([150] * 3, 0.15, 0.002, 5),
    "quarter_weights": _quarters,
}


def _graphs(src, dst, v, w):
    return (jbuild_graph(src, dst, num_vertices=v, edge_weights=w),
            build_graph(src, dst, num_vertices=v, edge_weights=w, device="cpu"))


@pytest.mark.parametrize("method", ["louvain", "leiden"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_bit_equal_to_the_jax_package(case, method):
    jg, g = _graphs(*CASES[case]())
    jlabels, jq = getattr(jlouvain, method)(jg)
    labels, q = getattr(plouvain, method)(g)
    assert labels.dtype == torch.int32 and labels.device == g.device
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert abs(q - jq) <= Q_TOL


@pytest.mark.parametrize("gamma", [0.5, 2.0])
@pytest.mark.parametrize("method", ["louvain", "leiden"])
def test_resolution_gamma(method, gamma):
    jg, g = _graphs(*_rmat(3))
    jlabels, jq = getattr(jlouvain, method)(jg, gamma=gamma)
    labels, q = getattr(plouvain, method)(g, gamma=gamma)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert abs(q - jq) <= Q_TOL


@pytest.mark.parametrize("method", ["louvain", "leiden"])
def test_inexact_weights_agree_within_tolerance(method):
    src, dst, v, _ = _sbm([100] * 4, 0.1, 0.01, 4)
    w = (np.random.default_rng(3).random(len(src)) + 0.1).astype(np.float32)
    jg, g = _graphs(src, dst, v, w)
    jlabels, jq = getattr(jlouvain, method)(jg)
    labels, q = getattr(plouvain, method)(g)
    assert abs(q - jq) <= Q_TOL
    assert normalized_mutual_info(labels, np.asarray(jlabels)) >= 0.99


def test_level_arrays_equal_the_jax_packages():
    jg, g = _graphs(*_quarters())
    jlevel, level = jlouvain._level_from_graph(jg), plouvain._level_from_graph(g)
    for name in ("recv", "send", "weight", "self_weight"):
        np.testing.assert_array_equal(getattr(level, name), getattr(jlevel, name))
    assert level.num_vertices == jlevel.num_vertices
    comm = np.asarray(jlouvain._local_moves(
        jlevel.recv, jlevel.send, jlevel.weight, jlevel.self_weight,
        num_vertices=len(jlevel.self_weight), gamma=1.0, max_sweeps=32))
    got = plouvain._local_moves(level.recv, level.send, level.weight, level.self_weight,
                                num_vertices=len(level.self_weight), gamma=1.0,
                                max_sweeps=32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), comm)
    jnew, jdense = jlouvain._contract(jlevel, comm)
    new, dense = plouvain._contract(level, comm)
    np.testing.assert_array_equal(dense, jdense)
    for name in ("recv", "send", "weight", "self_weight"):
        np.testing.assert_array_equal(getattr(new, name), getattr(jnew, name))


@pytest.mark.parametrize("case", ["two_cliques", "quarter_weights", "self_loops"])
def test_message_weights_and_modularity_weighted(case):
    if case == "self_loops":
        src = np.array([0, 1, 1, 2, 3, 3], np.int32)
        dst = np.array([1, 1, 2, 0, 3, 0], np.int32)
        args = (src, dst, 4, np.array([1.0, 0.5, 2.0, 1.25, 3.0, 0.75]))
    else:
        args = CASES[case]()
    jg, g = _graphs(*args)
    jw, jself = jmodularity.message_weights(jg)
    w, self_w = message_weights(g)
    assert w.dtype == self_w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(self_w.numpy(), np.asarray(jself))
    labels = np.random.default_rng(0).integers(0, 3, g.num_vertices).astype(np.int32)
    for gamma in (1.0, 0.7):
        want = float(jmodularity.modularity_weighted(
            labels, jg.msg_recv, jg.msg_send, jw, jself, jg.num_vertices, gamma))
        got = modularity_weighted(torch.from_numpy(labels), g.msg_recv, g.msg_send,
                                  w, self_w, g.num_vertices, gamma)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= Q_TOL
        # the census's float64 modularity agrees too
        assert abs(modularity(torch.from_numpy(labels), g, gamma) - want) <= Q_TOL


def test_louvain_needs_the_symmetric_graph():
    g = build_graph([0, 1], [1, 2], num_vertices=3, symmetric=False, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        plouvain.louvain(g)


# ---- the pipeline with community_method ----------------------------------

LOF_K = 16


@pytest.fixture(scope="module")
def edge_path(tmp_path_factory):
    src, dst, _, _ = datasets.planted_anomaly_graph(1024, 12_000, seed=9)
    path = tmp_path_factory.mktemp("louvain") / "edges.txt"
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")
    return str(path)


@pytest.fixture(scope="module")
def runs(edge_path, tmp_path_factory):
    root = tmp_path_factory.mktemp("louvain_runs")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
        mp.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
        mp.setattr(driver, "load_edge_list", functools.partial(load_edge_list, use_native=False))
        for method in ("louvain", "leiden"):
            common = dict(data_path=edge_path, data_format="edgelist", community_method=method,
                          outlier_method="both", lof_k=LOF_K)
            ref = jrun_pipeline(JPipelineConfig(
                **common, num_devices=1, lof_impl="xla",
                snapshot_out=str(root / f"jax_{method}")))
            port = run_pipeline(PipelineConfig(
                **common, lof_impl="exact", device="cpu",
                snapshot_out=str(root / f"port_{method}")))
            out[method] = (ref, port, root)
    return out


@pytest.mark.parametrize("method", ["louvain", "leiden"])
def test_pipeline_labels_census_and_flags_equal(runs, method):
    ref, port, _ = runs[method]
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    assert port.num_communities == ref.num_communities > 1
    for got, want in zip(port.community_table, ref.community_table):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(port.outliers.outlier_vertices,
                                  ref.outliers.outlier_vertices)
    np.testing.assert_allclose(port.lof, np.asarray(ref.lof), rtol=1e-4, atol=0)


@pytest.mark.parametrize("method", ["louvain", "leiden"])
def test_pipeline_records_match_the_jax_driver(runs, method):
    ref, port, _ = runs[method]
    port_only = set(PORT_PHASES)
    phases = [r["phase"] for r in port.metrics.records
              if r["phase"] not in port_only and r.get("name") not in port_only]
    assert phases == [r["phase"] for r in ref.metrics.records]
    for name in ("plan", "plan_build", "lpa", "lpa_iter"):
        assert not port.metrics.of_phase(name)
    (rec,) = port.metrics.of_phase(method)
    assert rec["gamma"] == 1.0 and rec["seconds"] >= 0
    (start,) = port.metrics.of_phase("run_start")
    assert start["community_method"] == method
    (jcomm,) = [r for r in ref.metrics.records if r["phase"] == "communities"]
    (comm,) = port.metrics.of_phase("communities")
    assert (comm["count"], comm["largest"]) == (jcomm["count"], jcomm["largest"])
    assert abs(comm["modularity"] - jcomm["modularity"]) <= 2e-6


@pytest.mark.parametrize("method", ["louvain", "leiden"])
def test_published_store_loads_in_both_packages(runs, method):
    ref, port, root = runs[method]
    fp = graph_fingerprint(port.edge_table.src, port.edge_table.dst)
    for store in (root / f"port_{method}", root / f"jax_{method}"):
        snap, jsnap = SnapshotStore(str(store)).load(fingerprint=fp), \
            JSnapshotStore(str(store)).load(fingerprint=fp)
        np.testing.assert_array_equal(snap["labels"], port.labels)
        np.testing.assert_array_equal(jsnap["labels"], port.labels)
        np.testing.assert_array_equal(snap["cc_labels"], jsnap["cc_labels"])


def test_checkpoint_dir_warns_and_writes_nothing(edge_path, tmp_path, monkeypatch):
    monkeypatch.setattr(driver, "load_edge_list", functools.partial(load_edge_list,
                                                                    use_native=False))
    ck = tmp_path / "ck"
    res = run_pipeline(PipelineConfig(data_path=edge_path, data_format="edgelist",
                                      community_method="louvain", outlier_method="none",
                                      checkpoint_dir=str(ck), device="cpu"))
    (warn,) = res.metrics.of_phase("warning")
    assert "not checkpointed" in warn["message"]
    assert not ck.exists() or not list(ck.iterdir())


def test_config_fields_flags_and_validation(edge_path, capsys, monkeypatch):
    assert (PipelineConfig().community_method, PipelineConfig().gamma) == (
        JPipelineConfig().community_method, JPipelineConfig().gamma)
    cfg = parse_args(["--data-path", edge_path, "--community-method", "leiden",
                      "--gamma", "1.0", "--device", "cpu"])
    assert cfg.community_method == "leiden" and cfg.gamma == 1.0
    with pytest.raises(ValueError, match="community_method"):
        PipelineConfig(community_method="walktrap").validate()
    monkeypatch.setattr(driver, "load_edge_list", functools.partial(load_edge_list,
                                                                    use_native=False))
    driver.main(["--data-path", edge_path, "--data-format", "edgelist",
                 "--community-method", "leiden", "--gamma", "1.0", "--device", "cpu",
                 "--outlier-method", "recursive_lpa"])
    assert "Communities in the Dataset" in capsys.readouterr().out
