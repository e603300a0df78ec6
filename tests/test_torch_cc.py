"""Port parity: connected components against the JAX package (CPU).

Both packages build the same message CSR and the same fused degree-bucketed
plan from one edge list. Every CC superstep is a minimum and a pointer
jump, exact in any order, so the labels must be bit-equal at every
superstep (sort and bucketed supersteps on each side) and at the fixpoint,
with equal superstep counts. The graphs cover a power-law draw, a ring,
self-loops, isolated vertices, duplicate edges, and a hub of degree above
2048, whose messages take the plan's hub path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.ops.bucketed_mode import build_graph_and_plan as jbuild
from graphmine_tpu.ops.cc import cc_superstep as jcc_superstep
from graphmine_tpu.ops.cc import cc_superstep_bucketed as jcc_superstep_bucketed
from graphmine_tpu.ops.cc import connected_components as jconnected_components

import torch

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.ops.bucketed_mode import build_graph_and_plan
from graphmine_tpu_torch.ops.blocking import select_superstep_family
from graphmine_tpu_torch.ops.cc import (
    BUCKETED_MIN_MESSAGES,
    cc_superstep,
    cc_superstep_bucketed,
    connected_components,
)
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from _torch_threads import one_torch_thread  # noqa: F401


def _graph(kind):
    """``(src, dst, num_vertices)`` of one test graph, from a seed."""
    rng = np.random.default_rng(11)
    if kind == "power_law":
        src, dst = datasets.rmat(10, 6, seed=3)
        return src, dst, int(max(src.max(), dst.max())) + 1
    if kind == "ring":
        v = 500
        src = np.arange(v)
        return src, (src + 1) % v, v
    if kind == "self_loops_isolated":
        # two chains with self-loops, and vertices 300..399 isolated
        src = np.concatenate([np.arange(0, 149), np.arange(150, 299), [5, 77, 200, 200]])
        dst = np.concatenate([np.arange(1, 150), np.arange(151, 300), [5, 77, 200, 200]])
        return src, dst, 400
    if kind == "duplicates":
        src = rng.integers(0, 300, 800)
        dst = rng.integers(0, 300, 800)
        return np.concatenate([src, src[:400]]), np.concatenate([dst, dst[:400]]), 300
    if kind == "hub":
        # vertex 0 has degree 3000 (> 2048): the plan's hub path; the rest
        # is sparse, with small components beside the hub's
        leaves = rng.choice(np.arange(1, 5000), 3000, replace=False)
        a = rng.integers(3000, 6000, 2000)
        b = rng.integers(3000, 6000, 2000)
        return (np.concatenate([np.zeros(3000, np.int64), a]),
                np.concatenate([leaves, b]), 6000)
    raise ValueError(kind)


KINDS = ["power_law", "ring", "self_loops_isolated", "duplicates", "hub"]


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    src, dst, v = _graph(request.param)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    jgraph, jplan = jbuild(src, dst, num_vertices=v, use_native=False)
    graph, plan = build_graph_and_plan(src, dst, num_vertices=v, device="cpu")
    return request.param, jgraph, jplan, graph, plan


def test_hub_graph_takes_the_hub_path(pair):
    kind, _, jplan, _, plan = pair
    has_hub = plan.hist_vertex_ids is not None
    assert has_hub == (jplan.hist_vertex_ids is not None) == (kind == "hub")


@pytest.mark.parametrize("bucketed", [False, True], ids=["sort", "bucketed"])
def test_every_superstep_equal(pair, bucketed):
    _, jgraph, jplan, graph, plan = pair
    v = graph.num_vertices
    jl = jnp.arange(v, dtype=jnp.int32)
    tl = torch.arange(v, dtype=torch.int32)
    for step in range(v + 2):
        jn = jcc_superstep_bucketed(jl, jplan) if bucketed else jcc_superstep(jl, jgraph)
        tn = cc_superstep_bucketed(tl, plan) if bucketed else cc_superstep(tl, graph)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=f"superstep {step}")
        # both superstep kinds agree on the port's side too
        other = cc_superstep(tl, graph) if bucketed else cc_superstep_bucketed(tl, plan)
        np.testing.assert_array_equal(other.numpy(), tn.numpy())
        if np.array_equal(np.asarray(jn), np.asarray(jl)):
            break
        jl, tl = jn, tn
    else:
        pytest.fail("no fixpoint within V + 2 supersteps")


@pytest.mark.parametrize("bucketed", [False, True], ids=["sort", "bucketed"])
def test_fixpoint_and_iterations_equal(pair, bucketed):
    _, jgraph, jplan, graph, plan = pair
    jlabels, jiters = jconnected_components(jgraph, return_iterations=True,
                                            plan=jplan if bucketed else None)
    labels, iters = connected_components(graph, return_iterations=True,
                                         plan=plan if bucketed else None)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert iters == int(jiters)
    # max_iter caps the supersteps as on the JAX side
    capped, n = connected_components(graph, max_iter=1, return_iterations=True, plan=None)
    jcapped = jconnected_components(jgraph, max_iter=1, plan=None)
    assert n == 1
    np.testing.assert_array_equal(capped.numpy(), np.asarray(jcapped))


def test_auto_plan_picks_sort_or_bucketed_and_says_so(pair, monkeypatch):
    """``"auto"`` resolves through the shared superstep policy: sort or
    bucketed by the message count, and blocked once the blocked walls
    (set alike on both packages) are passed; labels and the
    ``impl_selected`` / ``plan_build`` records equal the JAX package's
    apart from times, reasons and the cost model's anchors."""
    from graphmine_tpu.pipeline.metrics import MetricsSink as JSink

    def strip(rec):
        out = {k: v for k, v in rec.items() if k not in ("t", "seconds", "reason")}
        out["cost"] = {k: v for k, v in rec["cost"].items()
                       if k in ("family", "slots", "padded_slots", "bytes_gathered")}
        if "thresholds" in rec:
            out["thresholds"] = {k: v for k, v in rec["thresholds"].items()
                                 if k in ("bucketed_min_messages", "blocked_min_messages",
                                          "blocked_min_vertices")}
        return out

    _, jgraph, _, graph, _ = pair
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY", raising=False)
    for walls in ("4194304", "1"):
        monkeypatch.setenv("GRAPHMINE_BLOCKED_MIN_MESSAGES", walls)
        monkeypatch.setenv("GRAPHMINE_BLOCKED_MIN_VERTICES", walls)
        sink, jsink = MetricsSink(), JSink()
        labels = connected_components(graph, sink=sink)
        np.testing.assert_array_equal(labels.numpy(),
                                      np.asarray(jconnected_components(jgraph, sink=jsink)))
        (sel,) = sink.of_phase("impl_selected")
        want = ("blocked" if walls == "1" else
                "bucketed" if graph.num_messages >= BUCKETED_MIN_MESSAGES else "sort")
        assert sel["op"] == "cc_superstep" and sel["impl"] == want
        for phase in ("impl_selected", "plan_build"):
            assert [strip(r) for r in sink.of_phase(phase)] == \
                [strip(r) for r in jsink.of_phase(phase)], phase
        assert len(sink.of_phase("plan_build")) == (want != "sort")


def test_auto_plan_builds_the_bucketed_plan_past_the_crossover():
    src, dst = datasets.rmat(13, 5, seed=5)
    v = int(max(src.max(), dst.max())) + 1
    graph, plan = build_graph_and_plan(src, dst, num_vertices=v, device="cpu")
    assert graph.num_messages >= BUCKETED_MIN_MESSAGES
    assert select_superstep_family(v, graph.num_messages)[0] == "bucketed"
    assert select_superstep_family(v, BUCKETED_MIN_MESSAGES - 1)[0] == "sort"
    sink = MetricsSink()
    labels, iters = connected_components(graph, return_iterations=True, sink=sink)
    ref, ref_iters = connected_components(graph, return_iterations=True, plan=None)
    assert torch.equal(labels, ref) and iters == ref_iters
    (build,) = sink.of_phase("plan_build")
    assert build["family"] == "bucketed" and build["buckets"] == len(plan.vertex_ids)
    with pytest.raises(ValueError, match="mismatch"):
        small, _ = build_graph_and_plan(src[:10], dst[:10], num_vertices=v, device="cpu")
        connected_components(small, plan=plan)
