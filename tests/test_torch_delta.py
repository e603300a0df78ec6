"""Port parity: incremental delta ingest and warm repair (CPU).

The same stores and deltas go through the JAX package's
``serve/delta.py`` and the port's: validation, splice and the frontier
budget are bit-equal; the repair cases of the JAX ``test_serve.py``
(insert-only, delete-only, mixed, weighted, injected corruption → the
cold fallback) give bit-equal labels, CC labels, repair method,
iterations and sampled-check counts; ``DeltaIngestor`` chains give
bit-equal labels, CC labels, methods, iterations and versions, with LOF
within the port's stated tolerance (rtol 1e-4 on 99.9% of vertices, 1e-2
on all); and a store crosses packages: a JAX publish, port deltas, then a
JAX ``QueryEngine`` on the port's store answering as the port's engine.
"""

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.obs.schema import validate_records as jvalidate_records
from graphmine_tpu.pipeline.checkpoint import graph_fingerprint as jgraph_fingerprint
from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink
from graphmine_tpu.serve import delta as jd
from graphmine_tpu.serve.query import QueryEngine as JQueryEngine
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.obs.schema import PORT_PHASES
from graphmine_tpu_torch.obs.schema import validate_records
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.serve import delta as pd
from graphmine_tpu_torch.serve.query import QueryEngine
from graphmine_tpu_torch.serve.snapshot import SnapshotStore
from graphmine_tpu_torch.testing import faults
from _torch_threads import one_torch_thread  # noqa: F401


def _lof_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nz = want != 0
    np.testing.assert_array_equal(got[~nz], want[~nz])
    rel = np.abs(got[nz] - want[nz]) / np.abs(want[nz])
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, rel.max()


def _clique(lo, hi):
    ids = np.arange(lo, hi)
    s, d = np.meshgrid(ids, ids)
    m = s.ravel() < d.ravel()
    return s.ravel()[m], d.ravel()[m]


def _community_graph(extra=()):
    """The JAX serve suite's three cliques (LPA reaches one fixpoint from
    any init) plus optional extra edges."""
    parts = [_clique(0, 12), _clique(12, 26), _clique(26, 40)]
    src = np.concatenate([p[0] for p in parts] + [np.asarray([e[0] for e in extra], np.int64)])
    dst = np.concatenate([p[1] for p in parts] + [np.asarray([e[1] for e in extra], np.int64)])
    return src.astype(np.int32), dst.astype(np.int32), 40


def _both(src, dst, v, weights=None):
    return (jbuild_graph(src, dst, num_vertices=v, edge_weights=weights),
            build_graph(src, dst, num_vertices=v, edge_weights=weights, device="cpu"))


def _same_result(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.cc_labels, b.cc_labels)
    assert (a.method, a.iterations, a.fallback_reason, a.checked_samples, a.budget) == (
        b.method, b.iterations, b.fallback_reason, b.checked_samples, b.budget)


# ---- validate, splice, budget ---------------------------------------------


@pytest.mark.parametrize("insert,delete", [
    ([(1, 2), (-1, 3), (5, 40 + (1 << 20)), (40, 41)], [(0, 1), (7, 99), (-2, 1)]),
    ([(3, 4), (3, 4)], [(3, 4), (3, 4), (3, 4)]),
    ([], [(0, 1), (0, 2), (26, 27)]),
], ids=["quarantine", "multiset", "delete_only"])
def test_validate_and_splice_bit_equal(insert, delete):
    src, dst, v = _community_graph(extra=[(3, 4), (3, 4)])
    a, qa = jd.validate_delta(jd.EdgeDelta.from_pairs(insert, delete), v)
    b, qb = pd.validate_delta(pd.EdgeDelta.from_pairs(insert, delete), v)
    assert qa == qb
    for name in ("insert_src", "insert_dst", "delete_src", "delete_dst"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    ja, pa = jd.splice_edges(src, dst, v, a), pd.splice_edges(src, dst, v, b)
    for x, y in zip(ja[:3], pa[:3]):
        np.testing.assert_array_equal(x, y)
    assert ja[3] == pa[3]
    np.testing.assert_array_equal(jd.affected_vertices(a), pd.affected_vertices(b))


def test_weighted_splice_bit_equal():
    src, dst, v = _community_graph()
    w = np.random.default_rng(2).random(len(src)).astype(np.float32)
    ins, dele = [(40, 12, 2.5), (40, 13, 0.5)], [(0, 1), (12, 13)]
    a = jd.splice_edges(src, dst, v, jd.EdgeDelta.from_pairs(ins, dele), weights=w)
    b = pd.splice_edges(src, dst, v, pd.EdgeDelta.from_pairs(ins, dele), weights=w)
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)
    assert a[4] == b[4]
    with pytest.raises(ValueError):
        pd.splice_edges(src, dst, v, pd.EdgeDelta.from_pairs(ins, dele))


@pytest.mark.parametrize("insert,delete", [
    (None, []), ([[1, 2]], None), ([[1.9, 2.7]], []), ([[1, 2, 0.5], [3, 4]], []),
    ([[1, 2, -1.0]], []), ([1, 2], []), ([["a", 2]], []),
], ids=["null_insert", "null_delete", "fractional", "mixed_widths", "negative_weight",
        "flat", "string"])
def test_from_pairs_refusals_match(insert, delete):
    with pytest.raises(ValueError):
        jd.EdgeDelta.from_pairs(insert, delete)
    with pytest.raises(ValueError):
        pd.EdgeDelta.from_pairs(insert, delete)


@pytest.mark.parametrize("v,a", [(2, 2), (40, 3), (262_144, 2), (262_144, 262_144), (1 << 30, 9)])
def test_frontier_budget_matches(v, a):
    assert pd.frontier_budget(v, a) == jd.frontier_budget(v, a)


def test_cc_repair_init_matches():
    rng = np.random.default_rng(3)
    prev = np.minimum(rng.integers(0, 50, 60), np.arange(60)).astype(np.int32)
    delta = pd.EdgeDelta.from_pairs([(60, 2), (61, 3)], [(4, 5), (10, 11)])
    jdelta = jd.EdgeDelta.from_pairs([(60, 2), (61, 3)], [(4, 5), (10, 11)])
    np.testing.assert_array_equal(pd.cc_repair_init(prev, 62, delta),
                                  jd.cc_repair_init(prev, 62, jdelta))


# ---- repair ----------------------------------------------------------------


@pytest.mark.parametrize("insert,delete", [
    ([(40, 12), (40, 13), (40, 14), (0, 5)], []),
    ([], [(0, 1), (0, 2), (26, 27)]),
    ([(40, 26), (40, 27), (40, 28)], [(12, 13), (12, 14)]),
], ids=["insert_only", "delete_only", "mixed"])
def test_repair_bit_equal_to_jax_and_cold(insert, delete):
    src, dst, v = _community_graph()
    jg, g = _both(src, dst, v)
    labels, cc, it = pd.cold_recompute(g)
    jl, jc, jit_ = jd.cold_recompute(jg)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(cc, jc)
    assert it == jit_
    delta, _ = pd.validate_delta(pd.EdgeDelta.from_pairs(insert, delete), v)
    jdelta, _ = jd.validate_delta(jd.EdgeDelta.from_pairs(insert, delete), v)
    src2, dst2, v2, _ = pd.splice_edges(src, dst, v, delta)
    jg2, g2 = _both(src2, dst2, v2)
    res = pd.repair_labels(g2, labels, cc, delta)
    _same_result(res, jd.repair_labels(jg2, labels, cc, jdelta))
    assert res.method == "warm"
    cold_l, cold_c, _ = pd.cold_recompute(g2)
    np.testing.assert_array_equal(res.labels, cold_l)
    np.testing.assert_array_equal(res.cc_labels, cold_c)


@pytest.mark.parametrize("seed", [3, 4])
def test_cc_repair_exact_on_a_random_graph(seed):
    rng = np.random.default_rng(seed)
    v, e = 300, 500
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    _, g = _both(src, dst, v)
    _, cc, _ = pd.cold_recompute(g)
    delta, _ = pd.validate_delta(pd.EdgeDelta.from_pairs(
        insert=list(zip(rng.integers(0, v, 20).tolist(), rng.integers(0, v, 20).tolist())),
        delete=list(zip(src[:25].tolist(), dst[:25].tolist()))), v)
    src2, dst2, v2, _ = pd.splice_edges(src, dst, v, delta)
    jg2, g2 = _both(src2, dst2, v2)
    init = pd.cc_repair_init(cc, v2, delta)
    got = pd._warm_cc(g2, init, pd.frontier_budget(v2, v2))
    want = jd._warm_cc(jg2, init, jd.frontier_budget(v2, v2))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1:] == want[1:] and got[2]
    from graphmine_tpu_torch.ops.cc import connected_components

    np.testing.assert_array_equal(got[0], connected_components(g2).numpy())


def test_warm_lpa_period_two_exit_matches():
    """A bipartite star livelocks synchronous LPA: both packages stop on
    the period-2 cycle at the same superstep with the same labels."""
    src = np.zeros(8, np.int32)
    dst = np.arange(1, 9, dtype=np.int32)
    jg, g = _both(src, dst, 9)
    init = np.arange(9, dtype=np.int32)
    got, want = pd._warm_lpa(g, init, 40), jd._warm_lpa(jg, init, 40)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] is False


@pytest.mark.parametrize("kind", ["lpa", "cc"])
def test_sampled_exact_check_matches(kind):
    src, dst, v = _community_graph()
    jg, g = _both(src, dst, v)
    labels, cc, _ = pd.cold_recompute(g)
    lbl = labels if kind == "lpa" else cc
    bad = lbl.copy()
    bad[[3, 20]] = bad[[20, 3]]
    for case in (lbl, bad, np.full(v, -7, np.int32)):
        assert pd.sampled_exact_check(g, case, np.arange(v), kind) == \
            jd.sampled_exact_check(jg, case, np.arange(v), kind)


def _publish(root, src, dst, v, weights=None, lof=None, pkg="jax"):
    jg = jbuild_graph(src, dst, num_vertices=v, edge_weights=weights)
    labels, cc, _ = jd.cold_recompute(jg)
    arrays = {"src": src, "dst": dst, "labels": labels, "cc_labels": cc,
              "lof": np.linspace(0.5, 2.5, v).astype(np.float32) if lof is None else lof}
    if weights is not None:
        arrays["weights"] = weights
    fp = jgraph_fingerprint(src, dst, weights)
    for name in ("j", "p"):
        store = JSnapshotStore(str(root / name)) if pkg == "jax" else SnapshotStore(str(root / name))
        store.publish(arrays, fingerprint=fp)
    return JSnapshotStore(str(root / "j")), SnapshotStore(str(root / "p"))


def test_injected_corruption_falls_back_like_jax(tmp_path):
    src, dst, v = _community_graph()
    jstore, store = _publish(tmp_path, src, dst, v)
    js, ps = JMetricsSink(), MetricsSink()
    jing = jd.DeltaIngestor(jstore, sink=js, lof_k=4, check_samples=16)
    ing = pd.DeltaIngestor(store, sink=ps, lof_k=4, check_samples=16, device="cpu")
    jinj = jfaults.FaultInjector().add("delta_repair", jfaults.poison_labels(0, 1))
    inj = faults.FaultInjector().add("delta_repair", faults.poison_labels(0, 1))
    with jinj.installed():
        a = jing.apply(jd.EdgeDelta.from_pairs(insert=[(40, 12), (40, 13)]))
    with inj.installed():
        b = ing.apply(pd.EdgeDelta.from_pairs(insert=[(40, 12), (40, 13)]))
    assert inj.fired("delta_repair") == 1
    (jfb,), (pfb,) = js.of_phase("repair_fallback"), ps.of_phase("repair_fallback")
    assert pfb["reason"] == jfb["reason"] and "sampled exact check failed" in pfb["reason"]
    assert ps.of_phase("delta_apply")[-1]["method"] == "full_recompute"
    for name in ("labels", "cc_labels", "src", "dst"):
        np.testing.assert_array_equal(b[name], a[name])
    assert validate_records(ps.records) == []


# ---- the ingestor ----------------------------------------------------------


def _delta_chain(rng, src, v, n_ins, n_del, grow=3):
    chain = []
    for _ in range(3):
        ins = [(int(x), int(y)) for x, y in rng.integers(0, v + grow, (n_ins, 2))]
        idx = rng.integers(0, len(src), n_del)
        chain.append((ins, idx))
    return chain


def _run_chain(jing, ing, js, ps, chain, weights=False):
    for ins, idx in chain:
        dele = [(int(a), int(b)) for a, b in zip(jing.src[idx], jing.dst[idx])]
        if weights:
            ins = [(a, b, 0.25 * (1 + (a + b) % 7)) for a, b in ins]
        a = jing.apply(jd.EdgeDelta.from_pairs(ins, dele))
        b = ing.apply(pd.EdgeDelta.from_pairs(ins, dele))
        ra, rb = js.of_phase("delta_apply")[-1], ps.of_phase("delta_apply")[-1]
        for key in ("method", "iterations", "budget", "inserts", "deletes", "quarantine",
                    "affected", "version", "num_vertices", "num_edges", "lof_mode"):
            assert rb[key] == ra[key], key
        assert (b.version, b.parent[:6]) == (a.version, a.parent[:6])
        for name in ("labels", "cc_labels", "src", "dst", "census_present", "census_sizes",
                     "census_edges", "canary_features", "canary_is_anomaly"):
            np.testing.assert_array_equal(b[name], a[name])
        if weights:
            np.testing.assert_array_equal(b["weights"], a["weights"])
        _lof_close(b["lof"], a["lof"])
    return a, b


def test_ingestor_chain_bit_equal_to_jax(tmp_path):
    src, dst, _, _ = datasets.planted_anomaly_graph(400, 3000, seed=3)
    src, dst, v = src.astype(np.int32), dst.astype(np.int32), 400
    jstore, store = _publish(tmp_path, src, dst, v)
    js, ps = JMetricsSink(), MetricsSink()
    jing = jd.DeltaIngestor(jstore, sink=js, lof_k=8, check_samples=32)
    ing = pd.DeltaIngestor(store, sink=ps, lof_k=8, check_samples=32, device="cpu")
    _run_chain(jing, ing, js, ps, _delta_chain(np.random.default_rng(1), src, v, 15, 8))
    np.testing.assert_allclose(ing._centers, np.asarray(jing._centers), atol=1e-5)
    assert ing.debt.snapshot()["applies_warm"] == jing.debt.snapshot()["applies_warm"]
    assert validate_records(ps.records) == []
    for _phase, keys in PORT_PHASES.items():
        from graphmine_tpu.obs.schema import register

        register(_phase, *keys)
    assert jvalidate_records(ps.records) == []


def test_weighted_ingestor_chain_bit_equal_to_jax(tmp_path):
    src, dst, v = _community_graph(extra=[(0, 12), (12, 26)])
    w = np.full(len(src), 2.0, np.float32)
    w[-2:] = 0.25
    jstore, store = _publish(tmp_path, src, dst, v, weights=w, lof=np.zeros(v, np.float32))
    js, ps = JMetricsSink(), MetricsSink()
    jing = jd.DeltaIngestor(jstore, sink=js, lof_k=4, check_samples=8)
    ing = pd.DeltaIngestor(store, sink=ps, lof_k=4, check_samples=8, device="cpu")
    a, b = _run_chain(jing, ing, js, ps, _delta_chain(np.random.default_rng(5), src, v, 4, 2),
                      weights=True)
    assert b.get("weights") is not None


def test_lof_defer_backlog_matches(tmp_path):
    # a graph whose features have no constant column (ROADMAP §3: there
    # the JAX package's standardize returns rounding noise x 1e6)
    src, dst, _, _ = datasets.planted_anomaly_graph(400, 3000, seed=3)
    src, dst, v = src.astype(np.int32), dst.astype(np.int32), 400
    jstore, store = _publish(tmp_path, src, dst, v)
    js, ps = JMetricsSink(), MetricsSink()
    jing = jd.DeltaIngestor(jstore, sink=js, lof_k=6, check_samples=8)
    ing = pd.DeltaIngestor(store, sink=ps, lof_k=6, check_samples=8, device="cpu")
    for mode, ins in (("refresh", [(1, 2)]), ("defer", [(3, 4), (400, 5)]),
                      ("defer", [(6, 7)]), ("refresh", [(8, 9)])):
        a = jing.apply(jd.EdgeDelta.from_pairs(ins), lof_mode=mode)
        b = ing.apply(pd.EdgeDelta.from_pairs(ins), lof_mode=mode)
        assert b.meta.get("lof_stale") == a.meta.get("lof_stale")
        np.testing.assert_array_equal(ing._stale_aff, jing._stale_aff)
        _lof_close(b["lof"], a["lof"])
    with pytest.raises(ValueError):
        ing.apply(pd.EdgeDelta(), lof_mode="later")


def test_published_snapshot_immutable_under_later_deltas(tmp_path):
    src, dst, v = _community_graph()
    _, store = _publish(tmp_path, src, dst, v)
    ing = pd.DeltaIngestor(store, lof_k=4, check_samples=8, device="cpu")
    s1 = ing.apply(pd.EdgeDelta.from_pairs(insert=[(40, 12), (40, 13), (40, 14)]))
    eng = QueryEngine(s1, device=False)
    lof_before, labels_before = eng.lof.copy(), eng.labels.copy()
    ing.apply(pd.EdgeDelta.from_pairs(delete=[(40, 14)]))
    np.testing.assert_array_equal(eng.lof, lof_before)
    np.testing.assert_array_equal(eng.labels, labels_before)
    assert not np.shares_memory(ing.lof, s1["lof"])


def test_tiny_graph_skips_the_lof_refresh(tmp_path):
    _, store = _publish(tmp_path, np.asarray([0], np.int32), np.asarray([1], np.int32), 2)
    ing = pd.DeltaIngestor(store, lof_k=4, check_samples=4, device="cpu")
    snap = ing.apply(pd.EdgeDelta.from_pairs(delete=[(0, 1)]))
    assert snap.version == 2 and len(snap["lof"]) == 2
    snap = ing.apply(pd.EdgeDelta.from_pairs(insert=[(0, 1), (1, 2), (2, 3)]))
    assert len(snap["lof"]) == 4 and np.isfinite(snap["lof"]).all()


def test_check_samples_rotate_with_the_version(tmp_path, monkeypatch):
    seen = []
    real = pd.sampled_exact_check

    def spy(graph, labels, samples, kind="lpa", shards=None):
        if kind == "lpa":
            seen.append(np.asarray(samples).copy())
        return real(graph, labels, samples, kind=kind, shards=shards)

    monkeypatch.setattr(pd, "sampled_exact_check", spy)
    src, dst, v = _community_graph()
    _, store = _publish(tmp_path, src, dst, v)
    ing = pd.DeltaIngestor(store, lof_k=4, check_samples=16, device="cpu")
    ing.apply(pd.EdgeDelta.from_pairs(insert=[(0, 1)]))
    ing.apply(pd.EdgeDelta.from_pairs(delete=[(0, 1)]))
    assert len(seen) == 2 and not np.array_equal(seen[0], seen[1])


def test_cross_package_chain(tmp_path):
    """A JAX publish, port deltas, then the JAX store and query engine on
    the port's publishes: equal answers, the fingerprint honoured."""
    src, dst, _, _ = datasets.planted_anomaly_graph(300, 2400, seed=8)
    src, dst, v = src.astype(np.int32), dst.astype(np.int32), 300
    root = tmp_path / "x"
    JSnapshotStore(str(root)).publish(
        {"src": src, "dst": dst, "labels": jd.cold_recompute(jbuild_graph(src, dst, v))[0],
         "cc_labels": jd.cold_recompute(jbuild_graph(src, dst, v))[1],
         "lof": np.ones(v, np.float32)}, fingerprint=jgraph_fingerprint(src, dst))
    ing = pd.DeltaIngestor(SnapshotStore(str(root)), lof_k=6, check_samples=8, device="cpu")
    ing.apply(pd.EdgeDelta.from_pairs([(1, 2), (300, 4)], [(int(src[0]), int(dst[0]))]))
    snap = ing.apply(pd.EdgeDelta.from_pairs([(5, 6)]))
    jsnap = JSnapshotStore(str(root)).load(
        fingerprint=jgraph_fingerprint(snap["src"], snap["dst"]))
    assert jsnap.version == snap.version == 3
    jeng, peng = JQueryEngine(jsnap, device=False), QueryEngine(snap, device="cpu")
    ids = np.arange(v + 1)
    a, b = jeng.query_batch(ids), peng.query_batch(ids)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    for vtx in (0, 4, 300):
        np.testing.assert_array_equal(jeng.neighbors(vtx), peng.neighbors(vtx))
        assert jeng.top_outliers(jeng.membership(vtx), 3) == peng.top_outliers(
            peng.membership(vtx), 3)
    # and the JAX ingestor continues the port's chain
    jsnap2 = jd.DeltaIngestor(JSnapshotStore(str(root)), lof_k=6, check_samples=8).apply(
        jd.EdgeDelta.from_pairs([(7, 8)]))
    assert jsnap2.version == 4 and jsnap2.parent == snap.snapshot_id


def test_repair_debt_ledger_matches():
    a, b = jd.RepairDebt(), pd.RepairDebt()
    for led in (a, b):
        led.submitted(10, t=1.0)
        led.submitted(5, t=2.0)
        led.applied("warm", 7, 20, batches=1)
        led.submitted(3, t=3.0)
        led.shed(99)
        led.abandoned()
        led.applied("full_recompute", 40, 20, batches=2)
    sa, sb = a.snapshot(), b.snapshot()
    sa.pop("ingest_lag_s"), sb.pop("ingest_lag_s")
    assert sa == sb and a.applies_total == b.applies_total == 2


def test_sharded_repair_is_roadmap_a7(tmp_path, monkeypatch):
    """The sharded repair (ROADMAP A7b) runs: one device holds several
    shards only on a virtual mesh, and without one the ingestor says which
    variable makes it; with one, the sharded cold recompute equals the JAX
    package's and the single-device one."""
    src, dst, v = _community_graph()
    _, store = _publish(tmp_path, src, dst, v)
    monkeypatch.delenv("GRAPHMINE_VIRTUAL_DEVICES", raising=False)
    with pytest.raises(ValueError, match="GRAPHMINE_VIRTUAL_DEVICES=2"):
        pd.DeltaIngestor(store, num_shards=2, device="cpu")
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "2")
    ing = pd.DeltaIngestor(store, num_shards=2, device="cpu")
    assert ing.mesh.virtual and ing.mesh.size == 2 and ing.last_shard_family is None
    jg, g = _both(src, dst, v)
    got = pd.cold_recompute(g, shards=_shards(g, 2))
    want = jd.cold_recompute(jg, shards=_jshards(jg, 2))
    for a, b, c in zip(got, want, pd.cold_recompute(g)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ---- the sharded repair (num_shards > 1) -------------------------------------


def _shards(g, d, plan2d=False):
    from graphmine_tpu_torch.parallel.mesh import make_mesh
    from graphmine_tpu_torch.parallel.sharded import partition_graph, shard_graph_arrays

    m = make_mesh(d, devices=["cpu"] * d)
    return shard_graph_arrays(partition_graph(g, mesh=m, build_plan2d=plan2d), m), m


def _jshards(jg, d, plan2d=False):
    from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh
    from graphmine_tpu.parallel.sharded import partition_graph, shard_graph_arrays

    m = jmake_mesh(d)
    return shard_graph_arrays(partition_graph(jg, mesh=m, build_plan2d=plan2d), m), m


FAMILY_ENV = {"sort": str(1 << 62), "sharded_2d": "1"}


@pytest.fixture
def virtual4(monkeypatch):
    """A 4-shard virtual CPU mesh for the port."""
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")


@pytest.mark.parametrize("family", ["sort", "sharded_2d"])
def test_sharded_ingestor_chain_bit_equal_to_jax(tmp_path, monkeypatch, virtual4, family):
    """Two deltas through ``num_shards=4`` ingestors of both packages, the
    family forced by the 2-D crossover's variable: labels, CC labels,
    methods, iterations, versions, ``last_shard_family``, the
    ``shard_exchange`` records and ``mesh_shape`` equal; the labels equal
    the port's single-shard ingestor's (warm repairs on the cliques) and
    a cold recompute's."""
    monkeypatch.setenv("GRAPHMINE_SHARDED2D_MIN_MESSAGES", FAMILY_ENV[family])
    src, dst, v = _community_graph(extra=[(0, 12)])
    jstore, store = _publish(tmp_path, src, dst, v)
    _publish(tmp_path / "one", src, dst, v, pkg="port")
    js, ps = JMetricsSink(), MetricsSink()
    jing = jd.DeltaIngestor(jstore, sink=js, lof_k=4, check_samples=16, num_shards=4,
                            quality=False)
    ing = pd.DeltaIngestor(store, sink=ps, lof_k=4, check_samples=16, num_shards=4,
                           quality=False, device="cpu")
    one = pd.DeltaIngestor(SnapshotStore(str(tmp_path / "one" / "p")), lof_k=4,
                           check_samples=16, quality=False, device="cpu")
    for ins, dele in (([(40, 12), (40, 13), (40, 14)], [(0, 1)]), ([(41, 26)], [(12, 13)])):
        a = jing.apply(jd.EdgeDelta.from_pairs(ins, dele))
        b = ing.apply(pd.EdgeDelta.from_pairs(ins, dele))
        c = one.apply(pd.EdgeDelta.from_pairs(ins, dele))
        ra, rb = js.of_phase("delta_apply")[-1], ps.of_phase("delta_apply")[-1]
        for key in ("method", "iterations", "budget", "version", "num_vertices", "num_edges"):
            assert rb[key] == ra[key], key
        assert rb["method"] == "warm" and ing.last_shard_family == jing.last_shard_family == family
        for name in ("labels", "cc_labels", "src", "dst"):
            np.testing.assert_array_equal(b[name], a[name])
            np.testing.assert_array_equal(b[name], c[name])
        assert b.meta["mesh_shape"] == a.meta["mesh_shape"] == [4]
        keys = ("op", "family", "devices", "peers", "exchange_bytes", "frontier_bytes",
                "ladder_bytes", "frontier_frac", "boundary_slots", "padded_boundary", "version")
        ea, eb = js.of_phase("shard_exchange")[-1], ps.of_phase("shard_exchange")[-1]
        assert {k: eb[k] for k in keys} == {k: ea[k] for k in keys} and eb["virtual"] is True
    # the warm repairs landed on the cold recompute's labels
    cold_l, cold_c, _ = pd.cold_recompute(build_graph(b["src"], b["dst"],
                                                      num_vertices=len(b["labels"]),
                                                      device="cpu"))
    np.testing.assert_array_equal(b["labels"], cold_l)
    np.testing.assert_array_equal(b["cc_labels"], cold_c)
    assert validate_records(ps.records) == []


def test_sharded_fallback_and_predegrade_match_jax(tmp_path, monkeypatch, virtual4):
    """Injected corruption falls back through the sharded entries (the
    sampled check and the cold recompute on the mesh); a tiny memory
    budget pre-degrades the 2-D pick to the plain partition with a
    ``degrade`` record carrying the 2-D estimate; both as in JAX."""
    monkeypatch.setenv("GRAPHMINE_SHARDED2D_MIN_MESSAGES", "1")
    monkeypatch.setenv("GRAPHMINE_HBM_BYTES", "512")
    src, dst, v = _community_graph()
    jstore, store = _publish(tmp_path, src, dst, v)
    js, ps = JMetricsSink(), MetricsSink()
    jing = jd.DeltaIngestor(jstore, sink=js, lof_k=4, check_samples=16, num_shards=4,
                            quality=False)
    ing = pd.DeltaIngestor(store, sink=ps, lof_k=4, check_samples=16, num_shards=4,
                           quality=False, device="cpu")
    jinj = jfaults.FaultInjector().add("delta_repair", jfaults.poison_labels(0, 1))
    inj = faults.FaultInjector().add("delta_repair", faults.poison_labels(0, 1))
    with jinj.installed():
        a = jing.apply(jd.EdgeDelta.from_pairs(insert=[(40, 12), (40, 13)]))
    with inj.installed():
        b = ing.apply(pd.EdgeDelta.from_pairs(insert=[(40, 12), (40, 13)]))
    (jfb,), (pfb,) = js.of_phase("repair_fallback"), ps.of_phase("repair_fallback")
    assert pfb["reason"] == jfb["reason"] and "sampled exact check failed" in pfb["reason"]
    assert ps.of_phase("delta_apply")[-1]["method"] == "full_recompute"
    assert ps.of_phase("delta_apply")[-1]["iterations"] == \
        js.of_phase("delta_apply")[-1]["iterations"]
    for name in ("labels", "cc_labels"):
        np.testing.assert_array_equal(b[name], a[name])
    assert ing.last_shard_family == jing.last_shard_family == "sort"
    (jdeg,), (pdeg,) = js.of_phase("degrade"), ps.of_phase("degrade")
    for key in ("stage", "to", "depth", "kind"):
        assert pdeg[key] == jdeg[key], key
    assert pdeg["mem"]["family"] == "sharded_2d" and pdeg["mem"]["devices"] == 4
    assert {"exchange_send_tab", "exchange_recv_bufs"} <= set(pdeg["mem"]["inventory"])
    assert ps.of_phase("shard_exchange")[-1]["family"] == "sort"
    assert validate_records(ps.records) == []


@pytest.mark.parametrize("kind", ["lpa", "cc"])
def test_sampled_exact_check_sharded_matches(kind, virtual4):
    src, dst, v = _community_graph()
    jg, g = _both(src, dst, v)
    labels, cc, _ = pd.cold_recompute(g)
    lbl = labels if kind == "lpa" else cc
    bad = lbl.copy()
    bad[[3, 20]] = bad[[20, 3]]
    shards, jshards = _shards(g, 4, plan2d=True), _jshards(jg, 4, plan2d=True)
    for case in (lbl, bad, np.full(v, -7, np.int32)):
        got = pd.sampled_exact_check(g, case, np.arange(v), kind, shards=shards)
        assert got == jd.sampled_exact_check(jg, case, np.arange(v), kind, shards=jshards)
        assert got == pd.sampled_exact_check(g, case, np.arange(v), kind)


@pytest.mark.parametrize("plan2d", [False, True], ids=["sort", "sharded_2d"])
def test_cold_recompute_livelock_parity(plan2d, virtual4):
    """A bipartite star livelocks synchronous LPA: the sharded cold
    recompute's probe finds the 2-cycle and its replay stops where the
    single-device oracle stops, with the JAX package's labels and count."""
    src = np.zeros(8, np.int32)
    dst = np.arange(1, 9, dtype=np.int32)
    jg, g = _both(src, dst, 9)
    got = pd.cold_recompute(g, shards=_shards(g, 4, plan2d))
    want = jd.cold_recompute(jg, shards=_jshards(jg, 4, plan2d))
    single = pd.cold_recompute(g)
    for a, b, c in zip(got[:2], want[:2], single[:2]):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    assert got[2] == want[2] == single[2]
    assert pd._warm_lpa_sharded(_shards(g, 4, plan2d), np.arange(9, dtype=np.int32), 40)[1:] \
        == (single[2], False)
