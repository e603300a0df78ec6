"""Port parity: PageRank and batched personalized PageRank against the
JAX package (CPU).

Both packages sum inflows per destination in element order on the CPU;
the dangling mass and the L1 delta are full reductions whose order XLA
chooses, so ranks agree within rtol 1e-5 / atol 1e-7 rather than bit for
bit. Runs at ``tol=0`` compare a fixed iteration count; the default-tol
runs use graphs whose delta does not land near ``tol``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import pagerank as tpr
from graphmine_tpu_torch.pipeline.planner import PlanError
from _torch_threads import one_torch_thread  # noqa: F401

jpr = importlib.import_module("graphmine_tpu.ops.pagerank")
RTOL, ATOL = 1e-5, 1e-7


def _graphs(seed, v, e, symmetric=False, dangling=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v - dangling, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    return (jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric),
            build_graph(src, dst, num_vertices=v, symmetric=symmetric, device="cpu"), rng)


def _close(a, b):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dangling", [0, 20])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [{}, {"tol": 0.0, "max_iter": 30}, {"alpha": 0.5},
                                {"max_iter": 3}, {"max_iter": 0}],
                         ids=["default", "fixed30", "alpha05", "three", "zero"])
def test_pagerank_matches_jax(kw, seed, dangling):
    jg, g, _ = _graphs(seed, 400, 2500, dangling=dangling)
    want = jpr.pagerank(jg, **kw)
    got = tpr.pagerank(g, **kw)
    assert got.dtype == torch_float32() and got.shape == (400,)
    _close(want, got)


def torch_float32():
    import torch

    return torch.float32


@pytest.mark.parametrize("symmetric", [False, True])
def test_weighted_and_personalized(symmetric):
    jg, g, rng = _graphs(3, 300, 2000, symmetric=symmetric, dangling=10)
    w = rng.random(2000).astype(np.float32)
    w[:50] = 0.0
    reset = rng.random(300).astype(np.float32)
    reset[::3] = 0.0
    for kw in ({"weights": w}, {"reset": reset}, {"weights": w, "reset": reset, "tol": 0.0,
                                                   "max_iter": 25}):
        jkw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x for k, x in kw.items()}
        _close(jpr.pagerank(jg, **jkw), tpr.pagerank(g, **kw))
        assert abs(float(tpr.pagerank(g, **kw).sum()) - 1.0) < 1e-5


def test_plan_auto_and_none_take_the_segment_path():
    jg, g, _ = _graphs(4, 200, 1200)
    want = tpr.pagerank(g, tol=0.0, max_iter=20)
    for plan in ("auto", None):
        assert np.array_equal(tpr.pagerank(g, tol=0.0, max_iter=20, plan=plan).numpy(),
                              want.numpy())
        _close(jpr.pagerank(jg, tol=0.0, max_iter=20, plan=plan), want)


def test_a_blocked_plan_is_refused_naming_a5():
    """A ``BlockedPlan`` of a directed graph routes the inflow through the
    blocked layout: ranks within the module's tolerance of the JAX
    package's blocked PageRank and of the segment path."""
    from graphmine_tpu.ops.blocking import BlockedPlan as JBlockedPlan

    from graphmine_tpu_torch.ops.blocking import BlockedPlan

    jg, g, _ = _graphs(5, 200, 1200, dangling=10)
    plan, jplan = BlockedPlan.from_graph(g, tile_slots=128), JBlockedPlan.from_graph(
        jg, tile_slots=128)
    got = tpr.pagerank(g, tol=0.0, max_iter=20, plan=plan)
    _close(jpr.pagerank(jg, tol=0.0, max_iter=20, plan=jplan), got)
    _close(tpr.pagerank(g, tol=0.0, max_iter=20, plan=None), got)
    assert not isinstance(got, PlanError)


@pytest.mark.parametrize("plan", ["blocked", 3, object()], ids=["str", "int", "object"])
def test_other_plans_raise_the_jax_value_error(plan):
    jg, g, _ = _graphs(6, 50, 200)
    with pytest.raises(ValueError, match="plan must be 'auto', None, or a BlockedPlan"):
        jpr.pagerank(jg, plan=plan)
    with pytest.raises(ValueError, match="plan must be 'auto', None, or a BlockedPlan") as err:
        tpr.pagerank(g, plan=plan)
    assert not isinstance(err.value, PlanError)


def test_sink_records_the_superstep_window():
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink

    _, g, _ = _graphs(7, 200, 1200)
    sink = MetricsSink()
    pr = tpr.pagerank(g, sink=sink, tol=0.0, max_iter=7)
    (rec,) = [r for r in sink.records if r["phase"] == "superstep_timing"]
    assert rec["op"] == "pagerank_inflow" and rec["window"] == 7 and rec["variant"] == "fused"
    assert np.array_equal(pr.numpy(), tpr.pagerank(g, tol=0.0, max_iter=7).numpy())


@pytest.mark.parametrize("kw", [{}, {"tol": 0.0, "max_iter": 25}, {"alpha": 0.7}],
                         ids=["default", "fixed25", "alpha07"])
def test_parallel_personalized_pagerank(kw):
    jg, g, _ = _graphs(8, 300, 2000, dangling=15)
    sources = [0, 7, 7, 299, 150]
    want = jpr.parallel_personalized_pagerank(jg, sources, **kw)
    got = tpr.parallel_personalized_pagerank(g, sources, **kw)
    assert got.shape == (300, 5)
    _close(want, got)


def test_ppr_validates_sources():
    jg, g, _ = _graphs(9, 30, 100)
    assert tpr.parallel_personalized_pagerank(g, []).shape == (30, 0)
    for bad in ([30], [-1, 2]):
        with pytest.raises(ValueError, match="out of range"):
            tpr.parallel_personalized_pagerank(g, bad)
