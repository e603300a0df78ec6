"""The port's planner, memory model and cost model.

``plan_lof`` and ``plan_superstep`` decide as the JAX package's on a grid
below the blocked crossover; ``predegrade_superstep`` walks the same
families under a small and a large budget; ``sharded_2d`` needs a mesh as in
the JAX planner; the memory model's exact counts are
the bytes of the tensors the port builds; and no roofline anchor is a TPU
number.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from graphmine_tpu.obs import memmodel as jmem
from graphmine_tpu.pipeline import planner as jplanner

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.kernels import knn_cuda
from graphmine_tpu_torch.obs import costmodel, memmodel
from graphmine_tpu_torch.ops.bucketed_mode import build_graph_and_plan
from graphmine_tpu_torch.pipeline import planner
from _torch_threads import one_torch_thread  # noqa: F401

GRID_V = (100, 5_000, 1 << 17, 300_000)
GRID_K = (8, 128, 200)


@pytest.mark.parametrize("requested", ["auto", "xla", "pallas", "ivf"])
def test_plan_lof_decides_as_the_jax_planner(requested, monkeypatch):
    for env in (None, "4096"):
        if env is None:
            monkeypatch.delenv("GRAPHMINE_LOF_IVF_MIN_N", raising=False)
        else:
            monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", env)
        for v, k in itertools.product(GRID_V, GRID_K):
            got = planner.plan_lof(v, k, requested=requested)
            want = jplanner.plan_lof(v, k, requested=requested)
            assert (got.impl, got.degrade_to) == (want.impl, want.degrade_to), (v, k)


@pytest.mark.parametrize("requested", ["auto", "bucketed", "sort"])
def test_plan_superstep_decides_as_the_jax_planner(requested, monkeypatch):
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY", raising=False)
    # below the JAX package's blocked crossover (V >= 2^21 and M >= 2^22)
    for v, msgs in itertools.product((10, 4096, 1 << 20), (100, 1 << 16, 1 << 21)):
        got = planner.plan_superstep(v, msgs, requested=requested)
        want = jplanner.plan_superstep(v, msgs, requested=requested)
        assert (got.family, got.degrade_to) == (want.family, want.degrade_to), (v, msgs)
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "sort")
    assert planner.plan_superstep(4096, 1 << 20).family == \
        jplanner.plan_superstep(4096, 1 << 20).family == "sort"


def test_unported_families_and_schedules_raise_plan_errors(monkeypatch):
    """Every family and schedule is ported (``sharded_2d`` since ROADMAP
    A7b): a ``sharded_2d`` request needs a mesh, as in the JAX planner, and
    resolves on one with the JAX rung; the environment's ``sharded_2d``
    does not apply on one device; the multi-device schedules plan as the
    JAX planner's do; the blocked family resolves, requested or by the
    environment, with the JAX planner's rung and ladder."""
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY", raising=False)
    for mod in (planner, jplanner):
        with pytest.raises(ValueError, match="2-device mesh"):
            mod.plan_superstep(1 << 22, 1 << 23, requested="sharded_2d")
    got = planner.plan_superstep(1 << 22, 1 << 23, requested="sharded_2d", num_devices=4)
    want = jplanner.plan_superstep(1 << 22, 1 << 23, requested="sharded_2d", num_devices=4)
    assert (got.family, got.degrade_to) == (want.family, want.degrade_to) == (
        "sharded_2d", "blocked")
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "sharded_2d")
    assert planner.plan_superstep(4096, 1 << 20).family == \
        jplanner.plan_superstep(4096, 1 << 20).family == "bucketed"
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY")
    assert planner.degradation_ladder("single", 1, family="sharded_2d") == \
        jplanner.degradation_ladder("single", 1, family="sharded_2d")
    got = planner.plan_superstep(1 << 22, 1 << 23, requested="blocked")
    want = jplanner.plan_superstep(1 << 22, 1 << 23, requested="blocked")
    assert (got.family, got.degrade_to) == (want.family, want.degrade_to) == (
        "blocked", "bucketed")
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "blocked")
    assert planner.plan_superstep(4096, 1 << 20).family == \
        jplanner.plan_superstep(4096, 1 << 20).family == "blocked"
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY")
    assert planner.degradation_ladder("single", 1, family="blocked") == \
        jplanner.degradation_ladder("single", 1, family="blocked")
    # the multi-device schedules are ported: on one device a request runs
    # "single", on four "auto" takes replicated, as the JAX planner does
    for sched in ("replicated", "ring"):
        assert planner.plan_run(1000, 5000, 1, requested=sched).schedule == \
            jplanner.plan_run(1000, 5000, 1, requested=sched).schedule == "single"
        assert planner.plan_run(1000, 5000, 4, requested=sched).schedule == sched
    assert planner.plan_run(1000, 5000, 4).schedule == \
        jplanner.plan_run(1000, 5000, 4).schedule == "replicated"
    # a superstep family, not a schedule
    with pytest.raises(ValueError, match="unknown schedule 'sharded_2d'"):
        planner.plan_run(1000, 5000, 4, requested="sharded_2d")
    # past the port's blocked walls "auto" takes the blocked family
    thr = planner.crossover_thresholds()
    fam, why = planner.select_superstep_family(thr["blocked_min_vertices"],
                                               thr["blocked_min_messages"])
    assert fam == "blocked" and "10c" in why


def test_ladders():
    assert planner.degradation_ladder("single", 1) == ["single_sort"]
    assert planner.degradation_ladder("single", 1, family="sort") == []


@pytest.mark.parametrize("budget", [1, 1 << 40])
def test_predegrade_walks_the_same_families(budget):
    for v, msgs, weighted in ((4096, 60_000, False), (1 << 18, 50_000_000, True)):
        fam, _, steps = memmodel.predegrade_superstep("bucketed", v, msgs, msgs // 2, weighted,
                                                      budget)
        jfam, _, jsteps = jmem.predegrade_superstep("bucketed", v, msgs, msgs // 2, weighted,
                                                    budget)
        assert fam == jfam
        assert [(a, b) for a, b, _ in steps] == [(a, b) for a, b, _ in jsteps]


def test_budget_precedence(monkeypatch):
    monkeypatch.delenv("GRAPHMINE_HBM_BYTES", raising=False)
    assert planner.device_hbm_bytes("cpu") is None
    assert planner.hbm_bytes_per_device(lambda: None) == 16 << 30
    assert planner.hbm_bytes_per_device(80 << 30) == 80 << 30
    monkeypatch.setenv("GRAPHMINE_HBM_BYTES", "12345")
    asked = []
    assert planner.hbm_bytes_per_device(lambda: asked.append(1)) == 12345 and not asked
    plan = planner.plan_run(1000, 5000, 1, hbm=80 << 30)
    assert plan.schedule == "single" and plan.hbm_bytes == int((80 << 30) * 0.9)
    with pytest.raises(planner.PlanError, match="budget"):
        planner.plan_run(1 << 20, 1 << 28, 1, hbm=1 << 30)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_footprint_counts_the_ports_tensors(weighted):
    src, dst, _, _ = datasets.planted_anomaly_graph(2048, 30_000, seed=5)
    w = np.random.default_rng(1).integers(1, 4, len(src)).astype(np.float32) if weighted else None
    g, plan = build_graph_and_plan(src, dst, edge_weights=w, device="cpu")
    est = memmodel.superstep_footprint("lpa_superstep", "auto", g.num_vertices,
                                       g.num_messages, num_edges=g.num_edges, plan=plan)
    inv = est.inventory
    assert est.exact and est.family == "bucketed" and est.weighted == weighted
    assert inv["edge_endpoints"] == _nbytes(g.src, g.dst)
    assert inv["message_csr"] == _nbytes(g.msg_recv, g.msg_send, g.msg_ptr)
    assert inv.get("msg_weights", 0) == _nbytes(g.msg_weight)
    assert inv["plan_mats"] == _nbytes(*plan.send_idx, plan.hist_send)
    assert inv["plan_vertex_ids"] == _nbytes(*plan.vertex_ids, plan.hist_vertex_ids)
    assert inv.get("weight_mats", 0) == _nbytes(*(plan.weight_mat or ()))
    gathered = max(s.numel() for s in plan.send_idx) * 4
    assert inv["gather_transient"] >= gathered
    # the pre-build seeds bound the exact counts
    seeded = memmodel.superstep_footprint("lpa_superstep", "bucketed", g.num_vertices,
                                          g.num_messages, num_edges=g.num_edges,
                                          weighted=weighted)
    assert seeded.inventory["plan_mats"] >= inv["plan_mats"]


@pytest.mark.parametrize("n,f,k", [(262144, 8, 128), (65536, 8, 256), (4096, 8, 2000)])
def test_exact_lof_footprint_follows_the_kernels_launch_plan(n, f, k):
    inv = memmodel.lof_footprint("exact", n, k, features=f).inventory
    lp = knn_cuda.launch_plan(n, f, k)
    assert inv["knn_outputs"] == 8 * n * k and inv["features"] == 4 * n * f
    if lp["instance"] == "fast":
        assert inv["knn_packed"] == 4 * (-(-n // 512)) * 512 * 9
    assert inv.get("knn_scratch_keys", 0) == 8 * lp["scratch_keys"]


def test_ivf_footprint_models_the_chunk_results():
    est = memmodel.lof_footprint("ivf", 1 << 18, 128)
    # 262,144 queries x 16 probes + half a chunk per cluster, [.., 128]
    # float32 + int32, twice
    assert est.inventory["chunk_results"] == 2 * 8 * 128 * ((1 << 18) * 16 + 512 * 2048)
    assert est.total_bytes > 10 * (1 << 30)


def test_no_anchor_is_a_tpu_number(monkeypatch):
    monkeypatch.delenv("GRAPHMINE_ROOFLINE_FILE", raising=False)
    anchors = costmodel.rooflines()
    assert set(anchors) == {"gather_slots_per_sec", "lof_exact_pairs_per_sec",
                            "lof_ivf_points_per_sec", "binned_slots_per_sec"}
    for name, a in anchors.items():
        assert "H100" in a["src"] and not re.search(r"TPU|v5e|v5 lite|BENCH_r", a["src"]), name
    monkeypatch.setenv("GRAPHMINE_ROOFLINE_GATHER_SLOTS_PER_SEC", "1e9")
    assert costmodel.rooflines()["gather_slots_per_sec"] == {"v": 1e9, "src": "env"}
    assert costmodel.rooflines({"lof_ivf_points_per_sec": 5})["lof_ivf_points_per_sec"]["src"] \
        == "caller"


def test_cost_records_and_window_timer():
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.obs.schema import COST_KEYS, validate_records

    from graphmine_tpu.obs.costmodel import superstep_cost as jcost

    cost = costmodel.superstep_cost("lpa_superstep", "bucketed", 1000, 10_000, 5_000)
    assert set(cost.record()) == COST_KEYS and cost.padded_slots == 11_000
    # the blocked family's pre-build cost counts what the JAX model counts
    blocked = costmodel.superstep_cost("lpa_superstep", "blocked", 1000, 10_000, 5_000)
    want = jcost("lpa_superstep", "blocked", 1000, 10_000, 5_000)
    for key in ("padded_slots", "bytes_gathered", "bytes_scattered", "padding_overhead"):
        assert getattr(blocked, key) == getattr(want, key), key
    assert set(blocked.roofline) == {"gather_slots_per_sec", "binned_slots_per_sec"}
    m = MetricsSink()
    wt = costmodel.WindowTimer()
    assert wt.flush(m, "lpa_superstep", cost, 1, 5_000) is None
    wt.add(0.01)
    wt.add(0.03)
    rec = wt.flush(m, "lpa_superstep", cost, 3, 5_000, variant="single")
    assert rec["window"] == 2 and rec["seconds"] == 0.04 and wt.steps == 0
    assert rec["edges_per_sec_per_chip"] == round(5_000 * 2 / 0.04)
    lof = costmodel.lof_cost("exact", 262144, 128)
    assert lof.predicted_seconds == pytest.approx(0.07045, rel=1e-3)
    assert validate_records(m.records) == []
    out, secs, cold = costmodel.timed_fixpoint(lambda: (torch.ones(3), 2))
    assert out[1] == 2 and secs >= 0 and cold is False



def test_multi_device_ladders_and_schedules_follow_jax(monkeypatch):
    """The memory and elastic ladders and the per-device message model are
    the JAX planner's; "auto" walks replicated -> ring as the budget
    shrinks (the byte seeds are the port's own, so the budgets are read
    off each planner's estimates), and a too-small budget raises."""
    monkeypatch.delenv("GRAPHMINE_HBM_BYTES", raising=False)
    for sched, d in (("single", 1), ("replicated", 4), ("ring", 4), ("replicated", 2)):
        assert planner.degradation_ladder(sched, d) == jplanner.degradation_ladder(sched, d)
        assert planner.elastic_device_ladder(sched, d) == \
            jplanner.elastic_device_ladder(sched, d)
        assert planner.messages_per_device(sched, 12345, d) == \
            jplanner.messages_per_device(sched, 12345, d)
    v, e, d = 1 << 20, 1 << 24, 8
    est = planner.plan_run(v, e, d, hbm=1 << 40).estimates
    assert set(est) == {"replicated", "ring", "single"}
    assert est["ring"] < est["replicated"] < est["single"]
    for want, budget in (("replicated", est["replicated"]), ("ring", est["ring"])):
        plan = planner.plan_run(v, e, d, hbm=int(budget / 0.9) + 1)
        assert plan.schedule == want and plan.lpa_only == (want == "replicated")
    with pytest.raises(planner.PlanError, match="no LPA schedule fits"):
        planner.plan_run(v, e, d, hbm=int(est["ring"] / 0.9) - 1)
    with pytest.raises(planner.PlanError, match="schedule 'replicated' needs"):
        planner.plan_run(v, e, d, requested="replicated", hbm=int(est["ring"] / 0.9) + 1)
    with pytest.raises(planner.PlanError, match="message-index overflow"):
        planner.plan_run(1000, 1 << 31, 1, hbm=1 << 50)
    inv = memmodel.schedule_inventory("ring", v, e, d)
    assert abs(sum(inv.values()) - memmodel.schedule_bytes_per_device("ring", v, e, d)) < 16


def test_sharded_cost_footprint_and_exchange_records():
    """The sharded cost and memory models read a partition's shapes, host or
    placed; the exchange bytes and the ``shard_exchange`` record equal the
    JAX package's (the rates are each package's own)."""
    import numpy as np

    from graphmine_tpu.obs.costmodel import emit_shard_exchange as jemit
    from graphmine_tpu.parallel.sharded import partition_graph as jpartition
    from graphmine_tpu.pipeline.metrics import MetricsSink as JSink

    from graphmine_tpu_torch.parallel.mesh import make_mesh
    from graphmine_tpu_torch.parallel.sharded import partition_graph, shard_graph_arrays
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink

    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    for bucket in (False, True):
        host = partition_graph(src, dst, num_vertices=300, num_shards=4, build_bucket_plan=bucket)
        jhost = jpartition(src, dst, num_vertices=300, num_shards=4, build_bucket_plan=bucket)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")
            placed = shard_graph_arrays(host, make_mesh(4, devices=["cpu"] * 4))
        for sg in (host, placed):
            cost = costmodel.sharded_superstep_cost("lpa_superstep", sg, 2000)
            assert cost.family == ("bucketed" if bucket else "sort") and cost.devices == 4
            assert cost.exchange_bytes == costmodel.allgather_exchange_bytes(jhost)
            assert "not measured" in cost.record()["roofline"]["provenance"]
            est = memmodel.sharded_superstep_footprint("lpa_superstep", sg, schedule="ring")
            assert est.devices == 4 and est.exact and est.total_bytes > 0
        m, jm = MetricsSink(), JSink()
        rec, jrec = costmodel.emit_shard_exchange(m, "lpa", host, virtual=True), \
            jemit(jm, "lpa", jhost)
        for key in ("family", "devices", "peers", "exchange_bytes", "frontier_bytes",
                    "ladder_bytes", "frontier_frac"):
            assert rec[key] == jrec[key], key
        assert rec["virtual"] is True
