"""Port parity: segment mode, LPA, census, modularity and the recursive-LPA
outliers. Integer outputs must be bit-equal to the JAX package's on the
CPU; modularity agrees within 1e-6 (JAX sums in float32, the port in
float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.ops import census as jcensus
from graphmine_tpu.ops import lpa as jlpa
from graphmine_tpu.ops.bucketed_mode import build_graph_and_plan as jbuild_graph_and_plan
from graphmine_tpu.ops.bucketed_mode import lpa_superstep_bucketed as jsuperstep_bucketed
from graphmine_tpu.ops.modularity import modularity as jmodularity
from graphmine_tpu.ops.outliers import masked_label_propagation as jmasked
from graphmine_tpu.ops.outliers import recursive_lpa_outliers as jrecursive
from graphmine_tpu.ops.segment import segment_mode as jsegment_mode

import torch

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.interop import graph_from_reference_arrays, reference_arrays
from graphmine_tpu_torch.ops import census, lpa
from graphmine_tpu_torch.ops.bucketed_mode import build_graph_and_plan, lpa_superstep_bucketed
from graphmine_tpu_torch.ops.modularity import modularity
from graphmine_tpu_torch.ops.outliers import masked_label_propagation, recursive_lpa_outliers
from graphmine_tpu_torch.ops.segment import segment_mode

CPU = "cpu"


def _graphs():
    """(name, src, dst, V): planted communities, an SBM, and a graph with a
    degree > 2048 hub so the histogram path runs."""
    s1, d1, _, _ = datasets.planted_anomaly_graph(1024, 12_000, seed=2)
    s2, d2, _ = datasets.sbm([50, 80, 120], 0.15, 0.01, seed=4)
    rng = np.random.default_rng(6)
    v = 700
    s3 = np.concatenate([rng.integers(0, v, 4000), np.zeros(2500, np.int64)])
    d3 = np.concatenate([rng.integers(0, v, 4000), rng.integers(1, 40, 2500)])
    return [("planted", s1, d1, 1024), ("sbm", s2, d2, 250),
            ("hub", s3.astype(np.int32), d3.astype(np.int32), v)]


GRAPHS = {g[0]: g[1:] for g in _graphs()}


@pytest.mark.parametrize("case", ["random", "drop_sentinel", "empty_segments"])
def test_segment_mode_bit_equal(case):
    rng = np.random.default_rng(11)
    m, ns = 5000, 300
    seg = rng.integers(0, ns, m).astype(np.int32)
    val = rng.integers(0, 12, m).astype(np.int32)
    if case == "drop_sentinel":
        seg[rng.random(m) < 0.3] = ns
    elif case == "empty_segments":
        seg = (seg // 3) * 3  # two thirds of the segments stay empty
    jm, jc = jsegment_mode(jnp.asarray(seg), jnp.asarray(val), ns)
    tm, tc = segment_mode(torch.tensor(seg), torch.tensor(val), ns)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_superstep_bucketed_bit_equal(name):
    src, dst, v = GRAPHS[name]
    jg, jp = jbuild_graph_and_plan(src, dst, num_vertices=v)
    tg, tp = build_graph_and_plan(src, dst, num_vertices=v, device=CPU)
    if name == "hub":
        assert tp.hist_vertex_ids is not None
    jstep = jax.jit(jsuperstep_bucketed)
    # a few supersteps from a non-trivial state
    lbl = np.random.default_rng(1).integers(0, v, v).astype(np.int32)
    for _ in range(3):
        ref = np.asarray(jstep(jnp.asarray(lbl), jg, jp))
        got = lpa_superstep_bucketed(torch.tensor(lbl), tg, tp).numpy()
        np.testing.assert_array_equal(got, ref)
        # ...and equal to the sort-based superstep
        np.testing.assert_array_equal(lpa.lpa_superstep(torch.tensor(lbl), tg).numpy(), ref)
        lbl = ref
    # the JAX-built CSR and plan carried over give the same superstep
    g2, p2 = graph_from_reference_arrays(reference_arrays(jg, jp), device=CPU)
    np.testing.assert_array_equal(
        lpa_superstep_bucketed(torch.tensor(lbl), g2, p2).numpy(),
        np.asarray(jstep(jnp.asarray(lbl), jg, jp)),
    )


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_label_propagation_bit_equal(name):
    src, dst, v = GRAPHS[name]
    jg = jbuild_graph(src, dst, num_vertices=v)
    ref, ref_hist = jlpa.label_propagation(jg, max_iter=5, plan=None, return_history=True)
    tg, tp = build_graph_and_plan(src, dst, num_vertices=v, device=CPU)
    for plan in (None, tp):
        got, hist = lpa.label_propagation(tg, max_iter=5, plan=plan, return_history=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))
    assert lpa.num_communities(got) == int(jlpa.num_communities(ref))
    np.testing.assert_array_equal(lpa.canonicalize(got).numpy(),
                                  np.asarray(jlpa.canonicalize(ref)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_census_and_modularity(name):
    src, dst, v = GRAPHS[name]
    jg = jbuild_graph(src, dst, num_vertices=v)
    labels = np.asarray(jlpa.label_propagation(jg, max_iter=5, plan=None))
    tg = build_graph(src, dst, num_vertices=v, device=CPU)
    tl = torch.tensor(labels)
    for x, y in zip(census.census_table(tl, tg), jcensus.census_table(jnp.asarray(labels), jg)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(census.community_sizes(tl).numpy(),
                                  np.asarray(jcensus.community_sizes(jnp.asarray(labels))))
    assert abs(modularity(tl, tg) - float(jmodularity(jnp.asarray(labels), jg))) < 1e-6


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_recursive_outliers_bit_equal(name):
    src, dst, v = GRAPHS[name]
    jg = jbuild_graph(src, dst, num_vertices=v)
    comm = np.asarray(jlpa.label_propagation(jg, max_iter=2, plan=None))
    tg = build_graph(src, dst, num_vertices=v, device=CPU)
    tc = torch.tensor(comm)
    np.testing.assert_array_equal(
        masked_label_propagation(tg, tc, max_iter=5).numpy(),
        np.asarray(jmasked(jg, jnp.asarray(comm), max_iter=5)),
    )
    ref = jrecursive(jg, jnp.asarray(comm), max_iter=5, decile=0.1)
    got = recursive_lpa_outliers(tg, tc, max_iter=5, decile=0.1)
    for key in ("sub_labels", "outlier_vertices", "sub_sizes", "sub_parents"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert got.thresholds == ref.thresholds


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generic_bucketed_mode_bit_equal(name, weighted):
    """``bucketed_mode`` under a message-index plan (``from_graph``
    without senders) equals the JAX package's, with the plan's weights or
    forced plain, and serves the LPA superstep."""
    from graphmine_tpu.ops.bucketed_mode import BucketedModePlan as JPlan
    from graphmine_tpu.ops.bucketed_mode import bucketed_mode as jbucketed_mode

    from graphmine_tpu_torch.ops.bucketed_mode import BucketedModePlan, bucketed_mode

    src, dst, v = GRAPHS[name]
    w = np.random.default_rng(2).integers(1, 8, len(src)).astype(np.float32) / 4 \
        if weighted else None
    jg = jbuild_graph(src, dst, num_vertices=v, edge_weights=w)
    tg = build_graph(src, dst, num_vertices=v, edge_weights=w, device=CPU)
    jp, tp = JPlan.from_graph(jg), BucketedModePlan.from_graph(tg)
    assert tp.send_idx is None and tp.hist_vertex_ids is None
    assert len(tp.msg_idx) == len(jp.msg_idx)
    for a, b in zip(tp.msg_idx, jp.msg_idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, 9, tg.num_messages).astype(np.int32)
    fallback = rng.integers(0, v, v).astype(np.int32)
    jmode = jax.jit(jbucketed_mode, static_argnames=("weights",))
    for mode in ("plan", None):
        got = bucketed_mode(tp, torch.tensor(msgs), torch.tensor(fallback), weights=mode)
        want = jmode(jp, jnp.asarray(msgs), jnp.asarray(fallback), weights=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lbl = torch.arange(v, dtype=torch.int32)
    np.testing.assert_array_equal(lpa_superstep_bucketed(lbl, tg, tp).numpy(),
                                  lpa.lpa_superstep(lbl, tg).numpy())
    with pytest.raises(ValueError, match="fused"):
        bucketed_mode(build_graph_and_plan(src, dst, num_vertices=v, device=CPU)[1],
                      torch.tensor(msgs), torch.tensor(fallback))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_intra_community_edge_mask_bit_equal(name):
    src, dst, v = GRAPHS[name]
    jg = jbuild_graph(src, dst, num_vertices=v)
    labels = np.asarray(jlpa.label_propagation(jg, max_iter=3, plan=None))
    got = census.intra_community_edge_mask(torch.tensor(labels), build_graph(
        src, dst, num_vertices=v, device=CPU))
    want = jcensus.intra_community_edge_mask(jnp.asarray(labels), jg)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_auto_plan_with_a_sink_matches_the_jax_records(name):
    """``label_propagation``'s default ``plan="auto"`` takes the JAX
    package's family (sort below 2^16 messages, bucketed from there),
    gives its labels and history, and emits its ``impl_selected`` and
    ``plan_build`` records (apart from times, reasons and the cost
    model's anchors) and a ``superstep_timing`` record; custom
    ``init_labels`` stay on the sort superstep."""
    from graphmine_tpu.pipeline.metrics import MetricsSink as JSink

    from graphmine_tpu_torch.pipeline.metrics import MetricsSink

    def strip(rec):
        out = {k: v for k, v in rec.items() if k not in ("t", "seconds", "reason",
                                                          "thresholds", "cost")}
        out["cost"] = {k: rec["cost"][k] for k in ("family", "slots", "padded_slots")}
        return out

    src, dst, v = GRAPHS[name]
    jg = jbuild_graph(src, dst, num_vertices=v)
    tg = build_graph(src, dst, num_vertices=v, device=CPU)
    sink, jsink = MetricsSink(), JSink()
    got, hist = lpa.label_propagation(tg, max_iter=5, return_history=True, sink=sink)
    want, jhist = jlpa.label_propagation(jg, max_iter=5, return_history=True, sink=jsink)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    for phase in ("impl_selected", "plan_build"):
        assert [strip(r) for r in sink.of_phase(phase)] == \
            [strip(r) for r in jsink.of_phase(phase)], phase
    (timing,) = sink.of_phase("superstep_timing")
    assert timing["window"] == 5 and timing["family"] == sink.of_phase(
        "impl_selected")[0]["impl"]
    # a second call reuses the cached plan; init_labels keep the sort path
    sink = MetricsSink()
    lpa.label_propagation(tg, max_iter=1, sink=sink)
    assert all(r["cached"] for r in sink.of_phase("plan_build"))
    sink = MetricsSink()
    init = torch.arange(v, dtype=torch.int32)
    np.testing.assert_array_equal(
        lpa.label_propagation(tg, max_iter=2, init_labels=init, sink=sink).numpy(),
        np.asarray(jlpa.label_propagation(jg, max_iter=2, init_labels=jnp.asarray(init.numpy()))))
    assert not sink.of_phase("impl_selected")
