"""Port parity: the blocked superstep family against the JAX package (CPU).

The single-device cases of ``tests/test_blocking.py``, each held against
the JAX functions on the same inputs, made from a seed with numpy:
power-law, ring, self-loop, isolated-vertex and duplicate-edge graphs, and
a graph with one hub above the bin budget. Small ``tile_slots`` (64-1,024)
force many bins and one oversized hub bin.

- every plan array (``src_sorted``, ``scatter_pos``, ``row_idx``,
  ``row_vertex``, ``weight_mat``) and ``num_bins``, ``tile_slots``,
  ``tile_alloc`` bit-equal;
- LPA per superstep, weighted LPA and CC (every superstep, the fixpoint
  and its superstep count) bit-equal;
- ``blocked_inflow`` and PageRank on a ``BlockedPlan`` within rtol 1e-5
  (row sums reassociate);
- the refusals, the family policy under the same environment overrides on
  both packages, the planner's ladder, the ``impl_selected`` and
  ``plan_build`` records (apart from seconds and the cost model's anchor
  values), ``run_pipeline`` with ``GRAPHMINE_SUPERSTEP_FAMILY=blocked``
  and its ``single_bucketed`` rung under an injected OOM.

The sharded cases wait for ROADMAP item A7.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.io import native as jnative
from graphmine_tpu.obs import schema as jschema
from graphmine_tpu.ops import blocking as jb
from graphmine_tpu.ops.cc import cc_superstep as jcc_superstep
from graphmine_tpu.ops.cc import connected_components as jcc
from graphmine_tpu.ops.lpa import label_propagation as jlpa
from graphmine_tpu.ops.lpa import lpa_superstep as jlpa_superstep
from graphmine_tpu.ops.pagerank import pagerank as jpagerank
from graphmine_tpu.pipeline import planner as jplanner
from graphmine_tpu.pipeline import resilience as jres
from graphmine_tpu.pipeline.config import PipelineConfig as JConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun
from graphmine_tpu.pipeline.metrics import MetricsSink as JSink
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.io.edges import load_edge_list
from graphmine_tpu_torch.obs import costmodel, memmodel, schema
from graphmine_tpu_torch.ops import blocking as tb
from graphmine_tpu_torch.ops.cc import cc_superstep, connected_components
from graphmine_tpu_torch.ops.lpa import label_propagation, lpa_superstep
from graphmine_tpu_torch.ops.pagerank import pagerank
from graphmine_tpu_torch.ops.segment import segment_sum
from graphmine_tpu_torch.pipeline import driver, planner
from graphmine_tpu_torch.pipeline import resilience as res
from graphmine_tpu_torch.pipeline.config import PipelineConfig
from graphmine_tpu_torch.pipeline.driver import run_pipeline
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.testing import faults

CPU = "cpu"
RTOL = 1e-5


def _power_law(rng):
    v, e = 600, 4000
    raw = rng.pareto(1.2, size=2 * e)
    ids = np.minimum((raw * v / 50).astype(np.int64), v - 1).astype(np.int32)
    return ids[:e], ids[e:], v


def _ring(rng):
    v = 257
    src = np.arange(v, dtype=np.int32)
    return src, np.roll(src, -1).astype(np.int32), v


def _self_loops(rng):
    v, e = 300, 1500
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[::7] = src[::7]
    return src, dst, v


def _isolated(rng):
    # vertices [200, 300) are in no edge
    v, e = 300, 1200
    src = rng.integers(0, 200, e).astype(np.int32)
    dst = rng.integers(0, 200, e).astype(np.int32)
    return src, dst, v


def _dup_edges(rng):
    v, e = 250, 900
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[: e // 3] = src[0]  # one edge many times: multiplicity counts
    dst[: e // 3] = dst[0]
    return src, dst, v


def _hub(rng):
    # 5,000 vertices; vertex 7 receives 1,500 messages, past every budget
    # below, so it gets an oversized bin of its own
    v, e = 5000, 12_000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[:1500] = 7
    return src, dst, v


GRAPHS = {"power_law": _power_law, "ring": _ring, "self_loops": _self_loops,
          "isolated": _isolated, "dup_edges": _dup_edges, "hub": _hub}


def _edges(name, seed=3):
    return GRAPHS[name](np.random.default_rng(seed))


def _pair(name, symmetric=True, weighted=False, seed=3):
    src, dst, v = _edges(name, seed)
    w = np.random.default_rng(6).random(len(src)).astype(np.float32) if weighted else None
    return (jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric, edge_weights=w),
            build_graph(src, dst, num_vertices=v, symmetric=symmetric, edge_weights=w,
                        device=CPU))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_plans_equal(p, jp) -> None:
    assert (p.num_vertices, p.num_messages, p.num_bins, p.tile_slots, p.tile_alloc) == (
        jp.num_vertices, jp.num_messages, jp.num_bins, jp.tile_slots, jp.tile_alloc)
    for name in ("src_sorted", "scatter_pos"):
        got, want = getattr(p, name), getattr(jp, name)
        assert got.dtype == torch.int32
        _eq(got, want)
    for name in ("row_idx", "row_vertex", "weight_mat"):
        got, want = getattr(p, name), getattr(jp, name)
        assert (got is None) == (want is None), name
        assert len(got or ()) == len(want or ()), name
        for a, b in zip(got or (), want or ()):
            assert str(a.dtype).split(".")[-1] == str(b.dtype), name
            _eq(a, b)


# ---- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("tile_slots", [64, 1024])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_arrays_bit_equal(name, tile_slots, weighted):
    jg, g = _pair(name, weighted=weighted)
    jp = jb.BlockedPlan.from_graph(jg, tile_slots=tile_slots)
    p = tb.BlockedPlan.from_graph(g, tile_slots=tile_slots)
    _assert_plans_equal(p, jp)
    assert (p.padded_row_slots, p.num_width_classes) == (jp.padded_row_slots,
                                                         jp.num_width_classes)
    assert tb.plan_build_stats(p, g.num_edges) == jb.plan_build_stats(jp, jg.num_edges)
    if name == "hub":
        # the hub's oversized bin sets every bin's width
        assert p.tile_slots > tile_slots and p.num_bins > 1


def test_plan_from_numpy_inputs_and_the_shared_build(monkeypatch):
    src, dst, v = _edges("hub")
    jg, jp = jb.build_graph_and_blocked_plan(src, dst, num_vertices=v, tile_slots=256)
    g, p = tb.build_graph_and_blocked_plan(src, dst, num_vertices=v, tile_slots=256,
                                           device=CPU)
    _assert_plans_equal(p, jp)
    ptr = np.asarray(jg.msg_ptr)
    _assert_plans_equal(tb.BlockedPlan.from_ptr(ptr, v, np.asarray(jg.msg_send),
                                                tile_slots=256, device=CPU), jp)
    # the env sets the default budget, in both packages
    monkeypatch.setenv("GRAPHMINE_BLOCKED_TILE_SLOTS", "96")
    _assert_plans_equal(tb.BlockedPlan.from_graph(g), jb.BlockedPlan.from_graph(jg))
    with pytest.raises(ValueError, match="tile_slots"):
        tb.BlockedPlan.from_graph(g, tile_slots=0)


def test_plan_of_an_edgeless_graph():
    jg = jbuild_graph(np.zeros(0, np.int32), np.zeros(0, np.int32), num_vertices=5)
    g = build_graph(np.zeros(0, np.int32), np.zeros(0, np.int32), num_vertices=5, device=CPU)
    p, jp = tb.BlockedPlan.from_graph(g, tile_slots=64), jb.BlockedPlan.from_graph(
        jg, tile_slots=64)
    _assert_plans_equal(p, jp)
    lbl = torch.arange(5, dtype=torch.int32)
    _eq(tb.lpa_superstep_blocked(lbl, g, p), jlpa_superstep(jnp.arange(5, dtype=jnp.int32), jg))
    _eq(tb.cc_superstep_blocked(lbl, p), jcc_superstep(jnp.arange(5, dtype=jnp.int32), jg))


# ---- supersteps -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lpa_blocked_per_superstep_bit_equal(name):
    """Every superstep, not only the last, against the JAX package's sort
    superstep and its blocked one, from a scrambled state."""
    jg, g = _pair(name)
    jp, p = jb.BlockedPlan.from_graph(jg, tile_slots=100), tb.BlockedPlan.from_graph(
        g, tile_slots=100)
    v = g.num_vertices
    jsort, jblocked = jax.jit(jlpa_superstep), jax.jit(jb.lpa_superstep_blocked)
    lbl = np.random.default_rng(1).integers(0, v, v).astype(np.int32)
    for _ in range(4):
        want = np.asarray(jsort(jnp.asarray(lbl), jg))
        np.testing.assert_array_equal(np.asarray(jblocked(jnp.asarray(lbl), jg, jp)), want)
        _eq(tb.lpa_superstep_blocked(torch.from_numpy(lbl.copy()), g, p), want)
        lbl = want
    got, hist = label_propagation(g, 5, plan=p, return_history=True)
    want, jhist = jlpa(jg, 5, plan=None, return_history=True)
    _eq(got, want)
    _eq(hist, jhist)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_weighted_lpa_blocked_bit_equal(name):
    jg, g = _pair(name, weighted=True)
    jp, p = jb.BlockedPlan.from_graph(jg, tile_slots=160), tb.BlockedPlan.from_graph(
        g, tile_slots=160)
    assert p.weight_mat is not None
    want = jlpa(jg, 5, plan=None)
    _eq(label_propagation(g, 5, plan=p), want)
    _eq(label_propagation(g, 5, plan=p), jlpa(jg, 5, plan=jp))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cc_blocked_bit_equal(name):
    jg, g = _pair(name)
    jp, p = jb.BlockedPlan.from_graph(jg, tile_slots=96), tb.BlockedPlan.from_graph(
        g, tile_slots=96)
    v = g.num_vertices
    jstep = jax.jit(jcc_superstep)
    lbl = np.arange(v, dtype=np.int32)
    for _ in range(3):
        want = np.asarray(jstep(jnp.asarray(lbl), jg))
        _eq(tb.cc_superstep_blocked(torch.from_numpy(lbl.copy()), p), want)
        _eq(cc_superstep(torch.from_numpy(lbl.copy()), g), want)
        lbl = want
    labels, iters = connected_components(g, plan=p, return_iterations=True)
    jlabels, jiters = jcc(jg, plan=jp, return_iterations=True)
    _eq(labels, jlabels)
    assert iters == int(jiters)
    _eq(labels, jcc(jg, plan=None))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_blocked_matches_jax(name):
    jg, g = _pair(name, symmetric=False)
    jp, p = jb.BlockedPlan.from_graph(jg, tile_slots=128), tb.BlockedPlan.from_graph(
        g, tile_slots=128)
    kw = dict(tol=0.0, max_iter=30)
    got = pagerank(g, plan=p, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpagerank(jg, plan=jp, **kw)),
                               rtol=RTOL, atol=1e-8)
    np.testing.assert_allclose(got.numpy(), pagerank(g, plan=None, **kw).numpy(),
                               rtol=RTOL, atol=1e-8)
    assert abs(float(got.sum()) - 1.0) < 1e-4


def test_blocked_inflow_matches_jax_and_the_segment_sum():
    src, dst, v = _power_law(np.random.default_rng(9))
    jg = jbuild_graph(src, dst, num_vertices=v, symmetric=False)
    g = build_graph(src, dst, num_vertices=v, symmetric=False, device=CPU)
    jp, p = jb.BlockedPlan.from_graph(jg, tile_slots=200), tb.BlockedPlan.from_graph(
        g, tile_slots=200)
    contrib = np.random.default_rng(9).random(v).astype(np.float32)
    got = tb.blocked_inflow(p, torch.from_numpy(contrib))
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.blocked_inflow(jp, contrib)),
                               rtol=RTOL)
    ref = segment_sum(torch.from_numpy(contrib)[g.src.long()], g.dst, v)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL)
    with pytest.raises(ValueError, match="mismatch"):
        tb.blocked_inflow(p, torch.zeros(v + 1))


# ---- refusals -------------------------------------------------------------------


def test_plan_graph_mismatch_refuses():
    """A same-V plan of another graph is refused by LPA, CC and PageRank."""
    src, dst, v = _self_loops(np.random.default_rng(5))
    half = len(src) // 2
    for symmetric in (True, False):
        g = build_graph(src, dst, num_vertices=v, symmetric=symmetric, device=CPU)
        other = build_graph(src[:half], dst[:half], num_vertices=v, symmetric=symmetric,
                            device=CPU)
        plan = tb.BlockedPlan.from_graph(other)
        calls = ([lambda: label_propagation(g, 2, plan=plan),
                  lambda: connected_components(g, plan=plan)] if symmetric
                 else [lambda: pagerank(g, plan=plan)])
        for call in calls:
            with pytest.raises(ValueError, match="mismatch"):
                call()


def test_weighted_graph_weightless_plan_refuses():
    rng = np.random.default_rng(7)
    src, dst, v = _self_loops(rng)
    w = rng.random(len(src)).astype(np.float32)
    weightless = tb.BlockedPlan.from_graph(build_graph(src, dst, num_vertices=v, device=CPU))
    g_w = build_graph(src, dst, num_vertices=v, edge_weights=w, device=CPU)
    with pytest.raises(ValueError, match="weight"):
        tb.lpa_superstep_blocked(torch.arange(v, dtype=torch.int32), g_w, weightless)
    jg_w = jbuild_graph(src, dst, num_vertices=v, edge_weights=w)
    with pytest.raises(ValueError, match="weight"):
        jb.lpa_superstep_blocked(jnp.arange(v, dtype=jnp.int32), jg_w,
                                 jb.BlockedPlan.from_graph(jbuild_graph(src, dst, num_vertices=v)))


def test_pagerank_blocked_refusals():
    rng = np.random.default_rng(8)
    src, dst, v = _self_loops(rng)
    g_sym = build_graph(src, dst, num_vertices=v, device=CPU)
    with pytest.raises(ValueError, match="directed"):
        pagerank(g_sym, plan=tb.BlockedPlan.from_graph(g_sym))
    g_dir = build_graph(src, dst, num_vertices=v, symmetric=False, device=CPU)
    w = rng.random(len(src)).astype(np.float32)
    with pytest.raises(ValueError, match="weight"):
        pagerank(g_dir, weights=w, plan=tb.BlockedPlan.from_graph(g_dir))
    with pytest.raises(ValueError, match="plan must be 'auto', None, or a BlockedPlan"):
        pagerank(g_dir, plan="blocked")


# ---- the family policy ----------------------------------------------------------

# (GRAPHMINE_BLOCKED_MIN_MESSAGES, GRAPHMINE_BLOCKED_MIN_VERTICES), set on
# both packages so their policies are compared like with like
WALLS = [(1 << 22, 1 << 21), (1 << 10, 1 << 8), (1, 1)]


@pytest.mark.parametrize("walls", WALLS, ids=["jax_seed", "low", "one"])
def test_policy_picks_the_jax_family_under_the_same_walls(walls, monkeypatch):
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY", raising=False)
    monkeypatch.setenv("GRAPHMINE_BLOCKED_MIN_MESSAGES", str(walls[0]))
    monkeypatch.setenv("GRAPHMINE_BLOCKED_MIN_VERTICES", str(walls[1]))
    grid = itertools.product((10, 255, 256, 1 << 20, 1 << 21, 1 << 23),
                             (100, 1023, 1024, 1 << 16, 1 << 22, 1 << 24))
    for v, m in grid:
        fam, _ = tb.select_superstep_family(v, m)
        assert fam == jb.select_superstep_family(v, m)[0], (v, m)
        p, jp = planner.plan_superstep(v, m), jplanner.plan_superstep(v, m)
        assert (p.family, p.degrade_to) == (jp.family, jp.degrade_to), (v, m)
    thr, jthr = tb.crossover_thresholds(), jb.crossover_thresholds()
    assert {k: thr[k] for k in thr if k in jthr} == {k: jthr[k] for k in thr if k in jthr}
    assert {"bucketed_min_messages", "blocked_min_messages", "blocked_min_vertices",
            "blocked_tile_slots"} == set(thr)


def test_policy_env_family_and_requested_validation(monkeypatch):
    for requested in ("blocked", "bucketed", "sort"):
        fam, why = tb.select_superstep_family(10, 10, requested=requested)
        assert fam == requested == jb.select_superstep_family(10, 10, requested=requested)[0]
        assert "requested" in why
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="unknown superstep family"):
            mod.select_superstep_family(10, 10, requested="warp")
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "sort")
    fam, why = tb.select_superstep_family(1 << 24, 1 << 24)
    assert fam == "sort" == jb.select_superstep_family(1 << 24, 1 << 24)[0]
    assert "env override" in why
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "nope")
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="GRAPHMINE_SUPERSTEP_FAMILY"):
            mod.select_superstep_family(1 << 24, 1 << 24)


def test_sharded_2d_and_more_devices_raise_a_plan_error_naming_a7(monkeypatch):
    with pytest.raises(planner.PlanError, match="A7"):
        tb.select_superstep_family(1 << 22, 1 << 23, requested="sharded_2d")
    with pytest.raises(planner.PlanError, match="A7"):
        tb.select_superstep_family(1 << 22, 1 << 23, num_devices=2)
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "sharded_2d")
    with pytest.raises(planner.PlanError, match="A7"):
        planner.plan_superstep(4096, 1 << 20)
    with pytest.raises(planner.PlanError, match="A7"):
        planner.degradation_ladder("single", 1, family="sharded_2d")


def test_planner_ladder_and_predegrade_walk_as_the_jax_planner():
    for fam in ("blocked", "bucketed", "sort"):
        assert planner.degradation_ladder("single", 1, family=fam) == \
            jplanner.degradation_ladder("single", 1, family=fam)
    assert planner.degradation_ladder("single", 1, family="blocked") == [
        "single_bucketed", "single_sort"]
    p = planner.plan_superstep(10, 10, requested="blocked")
    assert (p.family, p.degrade_to) == ("blocked", "bucketed")
    for budget in (1, 1 << 40):
        fam, _, steps = memmodel.predegrade_superstep("blocked", 1 << 20, 1 << 22, 1 << 21,
                                                      False, budget)
        assert fam == ("sort" if budget == 1 else "blocked")
        assert [(a, b) for a, b, _ in steps] == (
            [("blocked", "bucketed"), ("bucketed", "sort")] if budget == 1 else [])


# ---- cost, memory and records -----------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_footprint_counts_the_plans_tensors_and_the_cost_the_jax_slots(weighted):
    from graphmine_tpu.obs.costmodel import superstep_cost as jcost

    jg, g = _pair("hub", weighted=weighted)
    p = tb.BlockedPlan.from_graph(g, tile_slots=256)
    jp = jb.BlockedPlan.from_graph(jg, tile_slots=256)
    est = memmodel.superstep_footprint("lpa_superstep", "auto", g.num_vertices,
                                       g.num_messages, num_edges=g.num_edges, plan=p)
    inv = est.inventory
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    assert est.exact and est.family == "blocked" and est.weighted == weighted
    assert inv["stream"] == nbytes(p.src_sorted, p.scatter_pos)
    assert inv["tile"] == 4 * p.tile_alloc
    assert inv["reduce_rows"] == nbytes(*p.row_idx)
    assert inv["row_vertex"] == nbytes(*p.row_vertex)
    assert inv.get("weight_mats", 0) == nbytes(*(p.weight_mat or ()))
    assert inv["gather_transient"] >= 4 * g.num_messages
    for op in ("lpa_superstep", "cc_superstep"):
        cost = costmodel.superstep_cost(op, "auto", g.num_vertices, g.num_messages,
                                        g.num_edges, plan=p)
        want = jcost(op, "auto", jg.num_vertices, jg.num_messages, jg.num_edges, plan=jp)
        for key in ("family", "slots", "padded_slots", "bytes_gathered", "bytes_scattered",
                    "padding_overhead"):
            assert getattr(cost, key) == getattr(want, key), key
    # the pre-build estimate models a tile of at least M slots
    seeded = memmodel.superstep_footprint("lpa_superstep", "blocked", g.num_vertices,
                                          g.num_messages, num_edges=g.num_edges)
    assert seeded.inventory["tile"] >= 4 * g.num_messages and not seeded.exact


def _strip(rec: dict) -> dict:
    """A record without its time, its build seconds and the cost model's
    anchor-dependent values."""
    out = {k: v for k, v in rec.items() if k not in (
        "t", "seconds", "reason", "thresholds", "run_id", "trace_id", "span_id", "span_path")}
    if "cost" in out:
        out["cost"] = {k: v for k, v in out["cost"].items() if k in (
            "family", "devices", "slots", "padded_slots", "bytes_gathered", "bytes_scattered",
            "padding_overhead", "exchange_bytes", "unit")}
    return out


def _records(sink, phase):
    return [_strip(r) for r in sink.records if r["phase"] == phase]


def test_auto_resolves_blocked_with_the_jax_records(monkeypatch):
    """Forced to the blocked family, ``"auto"`` flips LPA and CC to it with
    the JAX package's labels and ``impl_selected`` / ``plan_build`` records;
    CC reuses LPA's cached plan; both streams validate against both
    registries."""
    from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink

    jg, g = _pair("power_law", seed=13)
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "blocked")
    monkeypatch.setenv("GRAPHMINE_BLOCKED_TILE_SLOTS", "512")
    sink, jsink = MetricsSink(), JMetricsSink()
    _eq(label_propagation(g, 5, sink=sink), jlpa(jg, 5, plan="auto", sink=jsink))
    _eq(connected_components(g, sink=sink), jcc(jg, plan="auto", sink=jsink))
    for phase in ("impl_selected", "plan_build"):
        assert _records(sink, phase) == _records(jsink, phase), phase
    sel = sink.of_phase("impl_selected")
    assert [r["impl"] for r in sel] == ["blocked", "blocked"]
    assert all(r["thresholds"]["blocked_tile_slots"] == 512 for r in sel)
    builds = sink.of_phase("plan_build")
    assert [b["cached"] for b in builds] == [False, True] and builds[1]["seconds"] == 0.0
    assert builds[0]["tile_slots"] >= 512 and builds[0]["bins"] >= 1
    for recs in (sink.records, jsink.records):
        assert schema.validate_records(recs) == []
        assert jschema.validate_records(recs) == []


def test_auto_sort_family_emits_the_selection_only():
    jg, g = _pair("self_loops", seed=14)  # M < 2^16: sort
    sink, jsink = MetricsSink(), JSink()
    _eq(label_propagation(g, 2, sink=sink), jlpa(jg, 2, plan="auto", sink=jsink))
    assert _records(sink, "impl_selected") == _records(jsink, "impl_selected")
    assert sink.of_phase("impl_selected")[0]["impl"] == "sort"
    assert not sink.of_phase("plan_build")


def test_pagerank_auto_takes_blocked_past_the_walls(monkeypatch):
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY", raising=False)
    monkeypatch.setenv("GRAPHMINE_BLOCKED_MIN_MESSAGES", "1")
    monkeypatch.setenv("GRAPHMINE_BLOCKED_MIN_VERTICES", "1")
    jg, g = _pair("power_law", symmetric=False)
    sink, jsink = MetricsSink(), JSink()
    got = pagerank(g, tol=0.0, max_iter=20, sink=sink)
    want = jpagerank(jg, tol=0.0, max_iter=20, sink=jsink)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-8)
    for phase in ("impl_selected", "plan_build"):
        assert _records(sink, phase) == _records(jsink, phase), phase
    assert sink.of_phase("impl_selected")[0]["impl"] == "blocked"
    (timing,) = sink.of_phase("superstep_timing")
    assert timing["family"] == "blocked" and timing["window"] == 20
    # a symmetric graph keeps the segment path: no resolution record
    sink = MetricsSink()
    pagerank(build_graph(*_edges("power_law")[:2], device=CPU), max_iter=3, sink=sink)
    assert not sink.of_phase("impl_selected")


# ---- the driver -------------------------------------------------------------------


@pytest.fixture(scope="module")
def edges_path(tmp_path_factory):
    src, dst, _ = _power_law(np.random.default_rng(15))
    path = tmp_path_factory.mktemp("blocking") / "edges.txt"
    path.write_text("".join(f"{s} {d}\n" for s, d in zip(src, dst)))
    return str(path)


@pytest.fixture
def numpy_loaders(monkeypatch):
    """Both loaders on their NumPy paths, so the two packages number the
    vertices alike."""
    monkeypatch.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
    monkeypatch.setattr(driver, "load_edge_list",
                        functools.partial(load_edge_list, use_native=False))


def _configs(path, **kw):
    base = dict(data_path=path, data_format="edgelist", outlier_method="none", max_iter=5)
    fast = dict(backoff_base_s=0.001, backoff_max_s=0.01)
    return (JConfig(**base, num_devices=1, resilience=jres.ResilienceConfig(**fast), **kw),
            PipelineConfig(**base, device=CPU, resilience=res.ResilienceConfig(**fast), **kw))


def _lpa_records(metrics, phase):
    return [r for r in _records(metrics, phase) if r.get("op") == "lpa_superstep"]


def test_driver_runs_the_blocked_family_as_the_jax_driver(edges_path, numpy_loaders,
                                                         monkeypatch):
    jcfg, cfg = _configs(edges_path)
    base = run_pipeline(cfg)
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "blocked")
    got, want = run_pipeline(cfg), jrun(jcfg)
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_array_equal(got.labels, base.labels)
    assert got.num_communities == int(want.num_communities)
    for phase in ("impl_selected", "plan_build"):
        ours = _lpa_records(got.metrics, phase)
        theirs = _lpa_records(want.metrics, phase)
        assert ours and len(ours) == len(theirs), phase
        # the port's driver adds the graph's max degree and the weighting
        assert [{k: v for k, v in r.items() if k not in ("max_degree", "weighted")}
                for r in ours] == theirs, phase
    assert got.metrics.of_phase("plan_build")[0]["family"] == "blocked"
    assert schema.validate_records(got.metrics.records) == []


def test_oom_walks_blocked_to_single_bucketed(edges_path, numpy_loaders, monkeypatch):
    """A memory error at the third superstep takes the ``single_bucketed``
    rung in both packages: the blocked plan goes, the bucketed one is built
    and recorded, and the labels are the uninterrupted run's."""
    jcfg, cfg = _configs(edges_path)
    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "blocked")
    clean = run_pipeline(cfg).labels
    runs = []
    for mod, run, c in ((jfaults, jrun, jcfg), (faults, run_pipeline, cfg)):
        inj = mod.FaultInjector().add("lpa_superstep", mod.oom_error, at=3)
        with inj.installed():
            runs.append(run(c))
    want, got = runs
    np.testing.assert_array_equal(got.labels, clean)
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    (deg,) = got.metrics.of_phase("degrade")
    (jdeg,) = want.metrics.of_phase("degrade")
    assert (deg["stage"], deg["to"], deg["depth"]) == (jdeg["stage"], jdeg["to"],
                                                        jdeg["depth"]) == ("lpa",
                                                                           "single_bucketed", 1)
    assert deg["mem"]["family"] == "blocked"
    fams = [r["family"] for r in got.metrics.of_phase("plan_build")]
    assert fams == [r["family"] for r in want.metrics.of_phase("plan_build")] == [
        "blocked", "bucketed"]
    assert [r["iteration"] for r in got.metrics.of_phase("lpa_iter")] == [1, 2, 3, 4, 5]


def test_the_auto_plan_cache_goes_with_its_graph(monkeypatch):
    """``"auto"`` builds a family's plan once per graph; the entry goes
    when the graph's ``msg_ptr`` is collected."""
    import gc

    from graphmine_tpu_torch.ops import lpa as tlpa

    monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", "blocked")
    _, g = _pair("power_law")
    key = id(g.msg_ptr)
    first = tlpa._cached_auto_plan(g, "blocked")
    again = tlpa._cached_auto_plan(g, "blocked")
    assert first[2] is False and again[2] is True and again[0] is first[0]
    assert isinstance(tlpa._cached_auto_plan(g, "bucketed")[0], tb.BucketedModePlan)
    assert set(tlpa._auto_plan_cache[key][1]) == {"blocked", "bucketed"}
    del g, first, again
    gc.collect()
    assert key not in tlpa._auto_plan_cache
