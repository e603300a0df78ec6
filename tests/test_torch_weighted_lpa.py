"""Port parity for weighted LPA: the weighted segment mode, the weighted
message CSR, the plan's weight payload and the weighted bucketed superstep
against the JAX package (CPU).

Weights are multiples of 1/4, so every weight sum is exact in float32 and
does not depend on the order of summation: labels must be bit-equal,
counts and sums too. The graph has a hub above degree 2048 (the histogram
path) and a hub whose weights are all 0, which must still pick a label it
received.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.ops import lpa as jlpa
from graphmine_tpu.ops.bucketed_mode import build_graph_and_plan as jbuild_graph_and_plan
from graphmine_tpu.ops.bucketed_mode import lpa_superstep_bucketed as jsuperstep_bucketed
from graphmine_tpu.ops.modularity import modularity as jmodularity
from graphmine_tpu.ops.segment import segment_mode as jsegment_mode

import torch

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.interop import graph_from_reference_arrays, reference_arrays
from graphmine_tpu_torch.ops import lpa
from graphmine_tpu_torch.ops.bucketed_mode import build_graph_and_plan, lpa_superstep_bucketed
from graphmine_tpu_torch.ops.modularity import modularity
from graphmine_tpu_torch.ops.segment import segment_mode

CPU = "cpu"
V = 700


def _quarters(rng, n, low=1):
    return (rng.integers(low, 16, n) / 4).astype(np.float32)


@pytest.fixture(scope="module")
def hub_graph():
    """Random edges over 700 vertices, hub 0 with 2,600 edges (above the
    histogram threshold of 2048) and hub 1 with 2,300 edges of weight 0."""
    rng = np.random.default_rng(6)
    n_rand, n_h0, n_h1 = 6000, 2600, 2300
    src = np.concatenate([rng.integers(0, V, n_rand), np.zeros(n_h0, np.int64),
                          np.ones(n_h1, np.int64)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, V, n_rand), rng.integers(2, 80, n_h0),
                          rng.integers(2, 80, n_h1)]).astype(np.int32)
    w = _quarters(rng, len(src))
    w[n_rand + n_h0:] = 0.0
    return src, dst, w


@pytest.mark.parametrize("case", ["random", "drop_sentinel", "empty_segments", "zero_weights"])
def test_segment_mode_weighted_bit_equal(case):
    rng = np.random.default_rng(11)
    m, ns = 6000, 300
    seg = rng.integers(0, ns, m).astype(np.int32)
    val = rng.integers(0, 12, m).astype(np.int32)
    w = _quarters(rng, m, low=0)
    if case == "drop_sentinel":
        seg[rng.random(m) < 0.3] = ns
    elif case == "empty_segments":
        seg = (seg // 3) * 3
    elif case == "zero_weights":
        w[seg < ns // 2] = 0.0
    jm, jc = jsegment_mode(jnp.asarray(seg), jnp.asarray(val), ns, weights=jnp.asarray(w))
    tm, tc = segment_mode(torch.tensor(seg), torch.tensor(val), ns, weights=torch.tensor(w))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.float32


def test_weighted_csr_and_plan_array_equal(hub_graph):
    src, dst, w = hub_graph
    jg, jp = jbuild_graph_and_plan(src, dst, num_vertices=V, edge_weights=w)
    tg, tp = build_graph_and_plan(src, dst, num_vertices=V, edge_weights=w, device=CPU)
    ref, got = reference_arrays(jg, jp), reference_arrays(tg, tp)
    assert sorted(got) == sorted(ref)
    assert "plan_hist_weight" in got and "plan_weight_mat_0" in got
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert tp.hist_vertex_ids.tolist() == [0, 1]


@pytest.mark.parametrize("source", ["port_plan", "jax_plan"])
def test_superstep_bucketed_weighted_bit_equal(hub_graph, source):
    src, dst, w = hub_graph
    jg, jp = jbuild_graph_and_plan(src, dst, num_vertices=V, edge_weights=w)
    if source == "port_plan":
        tg, tp = build_graph_and_plan(src, dst, num_vertices=V, edge_weights=w, device=CPU)
    else:
        tg, tp = graph_from_reference_arrays(reference_arrays(jg, jp), device=CPU)
    step = jax.jit(jsuperstep_bucketed)
    lbl = np.random.default_rng(1).integers(0, V, V).astype(np.int32)
    for _ in range(4):
        ref = np.asarray(step(jnp.asarray(lbl), jg, jp))
        got = lpa_superstep_bucketed(torch.tensor(lbl), tg, tp).numpy()
        np.testing.assert_array_equal(got, ref)
        lbl = ref
    # the all-zero hub picked a label one of its neighbours holds
    neighbours = dst[src == 1]
    assert lbl[1] in set(lbl[neighbours].tolist())


def test_zero_weight_hub_picks_a_received_label():
    # one hub of degree 2100, every weight 0, neighbours all labelled 5..:
    # an all-zero histogram row must not argmax to label 0
    src = np.zeros(2100, np.int32)
    dst = (np.arange(2100) % 40 + 5).astype(np.int32)
    w = np.zeros(2100, np.float32)
    tg, tp = build_graph_and_plan(src, dst, num_vertices=50, edge_weights=w, device=CPU)
    assert tp.hist_vertex_ids.tolist() == [0]
    out = lpa_superstep_bucketed(torch.arange(50, dtype=torch.int32), tg, tp)
    assert int(out[0]) == 5  # the smallest received label


def test_label_propagation_weighted_both_paths_bit_equal(hub_graph):
    src, dst, w = hub_graph
    ref = np.asarray(jlpa.label_propagation(
        jbuild_graph(src, dst, num_vertices=V, edge_weights=w), max_iter=5, plan=None))
    sort_path = lpa.label_propagation(
        build_graph(src, dst, num_vertices=V, edge_weights=w, device=CPU), max_iter=5)
    tg, tp = build_graph_and_plan(src, dst, num_vertices=V, edge_weights=w, device=CPU)
    bucketed = lpa.label_propagation(tg, max_iter=5, plan=tp)
    np.testing.assert_array_equal(sort_path.numpy(), ref)
    np.testing.assert_array_equal(bucketed.numpy(), ref)
    # weights change the answer: unweighted LPA differs on this graph
    unweighted = lpa.label_propagation(build_graph(src, dst, num_vertices=V, device=CPU),
                                       max_iter=5)
    assert not np.array_equal(unweighted.numpy(), ref)


def test_weighted_plan_is_required_by_a_weighted_graph(hub_graph):
    src, dst, w = hub_graph
    tg, _ = build_graph_and_plan(src, dst, num_vertices=V, edge_weights=w, device=CPU)
    _, plain_plan = build_graph_and_plan(src, dst, num_vertices=V, device=CPU)
    with pytest.raises(ValueError, match="no weight payload"):
        lpa_superstep_bucketed(torch.arange(V, dtype=torch.int32), tg, plain_plan)


def test_weighted_modularity_agrees(hub_graph):
    src, dst, w = hub_graph
    labels = np.random.default_rng(3).integers(0, 40, V).astype(np.int32)
    ref = float(jmodularity(jnp.asarray(labels), jbuild_graph(src, dst, num_vertices=V,
                                                               edge_weights=w)))
    got = modularity(torch.tensor(labels),
                     build_graph(src, dst, num_vertices=V, edge_weights=w, device=CPU))
    assert got == pytest.approx(ref, abs=1e-6)
