"""The replicated schedule: the port on a ``[cpu] * D`` virtual mesh against
the JAX package on its own virtual CPU mesh (D = 2 and 4).

Partition arrays (the message CSR slices, the degrees, the stacked bucket
plan, weighted or not) are bit-equal to JAX's; LPA (sort body, bucketed
body, the ``lpa_only`` placement, weighted), CC, the LPA fixpoint and
their telemetry counters are bit-equal to JAX's sharded ops and to the
single-device ops, including a hub past the width ladder's 2,048 and a
ragged last shard; PageRank agrees within rtol 1e-5; the tripwires fire
with JAX's kind, shard and superstep. Graphs have at most 4,096 vertices.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild
from graphmine_tpu.ops.degrees import out_degrees as jout_degrees
from graphmine_tpu.ops.degrees import out_weights as jout_weights
from graphmine_tpu.parallel import sharded as js
from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh
from graphmine_tpu.parallel.mesh import make_multislice_mesh as jmultislice
from graphmine_tpu.pipeline.resilience import DivergenceError as JDivergence

from graphmine_tpu_torch.graph.container import build_graph as tbuild
from graphmine_tpu_torch.ops.cc import connected_components
from graphmine_tpu_torch.ops.degrees import out_degrees, out_weights
from graphmine_tpu_torch.ops.lpa import label_propagation
from graphmine_tpu_torch.parallel import sharded as ts
from graphmine_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
from graphmine_tpu_torch.pipeline.resilience import DivergenceError

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def virtual_devices():
    """An 8-shard virtual CPU mesh, and one intra-op thread: the shard
    bodies are many small ops, whose thread pools would otherwise
    oversubscribe the cores the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", "8")
        yield
    torch.set_num_threads(threads)


def meshes(d):
    return jmake_mesh(d), make_mesh(d, devices=[CPU] * d)


def _edges(seed, v, e, hub=0):
    """Random edges, plus ``hub`` edges into vertex 0 (a hub past 2,048)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if hub:
        src = np.concatenate([src, rng.integers(1, v, hub).astype(np.int32)])
        dst = np.concatenate([dst, np.zeros(hub, np.int32)])
    w = (rng.integers(1, 16, len(src)) / 4).astype(np.float32)
    return src, dst, w


GRAPHS = {
    # V not a multiple of 8 * D: a ragged last shard and padding vertices
    "random": (3, 301, 1500, 0),
    "hub": (5, 4093, 9000, 2600),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph_pair(request):
    seed, v, e, hub = GRAPHS[request.param]
    src, dst, w = _edges(seed, v, e, hub)
    return request.param, src, dst, w, v


def _pair(src, dst, v, w=None, symmetric=True):
    return (jbuild(src, dst, num_vertices=v, edge_weights=w, symmetric=symmetric),
            tbuild(src, dst, num_vertices=v, edge_weights=w, symmetric=symmetric, device="cpu"))


def _same_partition(jp, tp):
    for f in ("msg_recv_local", "msg_send", "degrees", "msg_weight"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b), f
    for f in ("bucket_send", "bucket_target", "bucket_weight"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == y.dtype and np.array_equal(np.asarray(x), y), f
    assert (jp.chunk_size, jp.num_shards, jp.num_vertices) == \
        (tp.chunk_size, tp.num_shards, tp.num_vertices)


@pytest.mark.parametrize("bucket", [False, True], ids=["sort", "bucketed"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 4])
def test_partition_arrays_bit_equal(graph_pair, d, weighted, bucket):
    _, src, dst, w, v = graph_pair
    jg, tg = _pair(src, dst, v, w if weighted else None)
    _same_partition(js.partition_graph(jg, num_shards=d, build_bucket_plan=bucket),
                    ts.partition_graph(tg, num_shards=d, build_bucket_plan=bucket))
    # raw (src, dst) arrays partition the same way as a built graph
    if not weighted:
        _same_partition(js.partition_graph(src, dst, num_vertices=v, num_shards=d),
                        ts.partition_graph(src, dst, num_vertices=v, num_shards=d))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 4])
def test_lpa_bit_equal_every_body(graph_pair, d, weighted):
    _, src, dst, w, v = graph_pair
    jg, tg = _pair(src, dst, v, w if weighted else None)
    jm, tm = meshes(d)
    single = label_propagation(tg, max_iter=5, plan=None).numpy()
    for bucket in (False, True):
        jp = js.partition_graph(jg, mesh=jm, build_bucket_plan=bucket)
        tp = ts.partition_graph(tg, mesh=tm, build_bucket_plan=bucket)
        want = np.asarray(js.sharded_label_propagation(js.shard_graph_arrays(jp, jm), jm,
                                                       max_iter=5))
        np.testing.assert_array_equal(want, single)
        got = ts.sharded_label_propagation(ts.shard_graph_arrays(tp, tm), tm, max_iter=5)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if bucket:
            lean = ts.shard_graph_arrays(tp, tm, lpa_only=True)
            assert lean.msg_send is None and lean.degrees is None
            np.testing.assert_array_equal(
                ts.sharded_label_propagation(lean, tm, max_iter=5).numpy(), want)
            with pytest.raises(ValueError, match="lpa_only"):
                ts.sharded_connected_components(lean, tm)
    with pytest.raises(ValueError, match="lpa_only"):
        ts.shard_graph_arrays(ts.partition_graph(tg, mesh=tm), tm, lpa_only=True)


@pytest.mark.parametrize("d", [2, 4])
def test_cc_lpa_telemetry_and_fixpoint_equal(d):
    src, dst, _ = _edges(7, 400, 380)  # many components
    jg, tg = _pair(src, dst, 400)
    jm, tm = meshes(d)
    jsg = js.shard_graph_arrays(js.partition_graph(jg, mesh=jm), jm)
    tsg = ts.shard_graph_arrays(ts.partition_graph(tg, mesh=tm), tm)
    want, jt = js.sharded_connected_components(jsg, jm, telemetry=True)
    got, tt = ts.sharded_connected_components(tsg, tm, telemetry=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), connected_components(tg).numpy())
    assert tt.iterations == jt.iterations
    np.testing.assert_array_equal(tt.labels_changed, jt.labels_changed)
    np.testing.assert_array_equal(tt.shard_changed, jt.shard_changed)
    np.testing.assert_array_equal(tt.imbalance_ratio(), jt.imbalance_ratio())
    want, jt = js.sharded_label_propagation(jsg, jm, max_iter=4, telemetry=True)
    got, tt = ts.sharded_label_propagation(tsg, tm, max_iter=4, telemetry=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tt.shard_changed, jt.shard_changed)
    assert tt.iterations == jt.iterations == 4
    for budget in (0, 2):
        jl, jit_, jconv = js.sharded_lpa_fixpoint(jsg, jm, max_iter=budget)
        tl, tit, tconv = ts.sharded_lpa_fixpoint(tsg, tm, max_iter=budget)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert (tit, tconv) == (jit_, jconv)
    # init_labels resume a fixpoint mid-run to the same answer
    half = np.array(js.sharded_connected_components(jsg, jm, max_iter=1))
    np.testing.assert_array_equal(
        ts.sharded_connected_components(tsg, tm, init_labels=torch.from_numpy(half)).numpy(),
        np.asarray(js.sharded_connected_components(jsg, jm, init_labels=jnp.asarray(half))))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 4])
def test_pagerank_within_rtol(d, weighted):
    src, dst, w = _edges(11, 300, 1200)
    jg, tg = _pair(src, dst, 300, w if weighted else None, symmetric=False)
    jm, tm = meshes(d)
    jsg = js.shard_graph_arrays(js.partition_graph(jg, mesh=jm), jm)
    tsg = ts.partition_graph(tg, mesh=tm)  # a host partition is placed on the call
    jod = jout_weights(jg) if weighted else jout_degrees(jg)
    tod = out_weights(tg) if weighted else out_degrees(tg)
    want, jt = js.sharded_pagerank(jsg, jm, jod, max_iter=60, telemetry=True)
    got, tt = ts.sharded_pagerank(tsg, tm, tod, max_iter=60, telemetry=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-4
    assert tt.iterations == jt.iterations
    # residuals are float32 L1 deltas: the same to float32 noise
    np.testing.assert_allclose(tt.residuals, jt.residuals, rtol=0, atol=1e-6)
    resumed = ts.sharded_pagerank(tsg, tm, tod, max_iter=60, init_ranks=got)
    np.testing.assert_allclose(resumed.numpy(), got.numpy(), rtol=1e-5)
    if weighted:
        with pytest.raises(ValueError, match="float out-edge weight sums"):
            ts.sharded_pagerank(tsg, tm, out_degrees(tg))


def test_multislice_mesh_parity():
    src, dst, _ = _edges(5, 160, 640)
    jg, tg = _pair(src, dst, 160)
    jm = jmultislice(2, 4)
    tm = make_multislice_mesh(2, 4, devices=[CPU] * 8)
    jsg = js.shard_graph_arrays(js.partition_graph(jg, mesh=jm), jm)
    tsg = ts.shard_graph_arrays(ts.partition_graph(tg, mesh=tm), tm)
    np.testing.assert_array_equal(ts.sharded_label_propagation(tsg, tm, max_iter=5).numpy(),
                                  np.asarray(js.sharded_label_propagation(jsg, jm, max_iter=5)))
    np.testing.assert_array_equal(ts.sharded_connected_components(tsg, tm).numpy(),
                                  np.asarray(js.sharded_connected_components(jsg, jm)))
    jgd, tgd = _pair(src, dst, 160, symmetric=False)
    np.testing.assert_allclose(
        ts.sharded_pagerank(ts.partition_graph(tgd, mesh=tm), tm, out_degrees(tgd),
                            max_iter=60).numpy(),
        np.asarray(js.sharded_pagerank(js.shard_graph_arrays(js.partition_graph(jgd, mesh=jm),
                                                             jm), jm, jout_degrees(jgd),
                                       max_iter=60)), rtol=1e-5)


def _trip(fn):
    with pytest.raises((DivergenceError, JDivergence)) as ei:
        fn()
    return ei.value.kind, ei.value.shard, ei.value.iteration


def test_tripwires_match_jax():
    jm, tm = meshes(4)
    src, dst, w = _edges(3, 64, 300)
    jg, tg = _pair(src, dst, 64)
    jsg = js.shard_graph_arrays(js.partition_graph(jg, mesh=jm), jm)
    tsg = ts.shard_graph_arrays(ts.partition_graph(tg, mesh=tm), tm)
    # silent on a clean run
    np.testing.assert_array_equal(
        ts.sharded_label_propagation(tsg, tm, max_iter=4, tripwire_every=2).numpy(),
        ts.sharded_label_propagation(tsg, tm, max_iter=4).numpy())
    bad = np.arange(64, dtype=np.int32)
    bad[40:48] = 10_000  # a wrapped gather index
    assert _trip(lambda: ts.sharded_label_propagation(
        tsg, tm, max_iter=4, init_labels=torch.from_numpy(bad), tripwire_every=1)) == \
        _trip(lambda: js.sharded_label_propagation(
            jsg, jm, max_iter=4, init_labels=jnp.asarray(bad), tripwire_every=1))
    # period-2 oscillation on K2
    j2, t2 = meshes(2)
    jk, tk = _pair(np.array([0, 1], np.int32), np.array([1, 0], np.int32), 2)
    assert _trip(lambda: ts.sharded_label_propagation(
        ts.partition_graph(tk, mesh=t2), t2, max_iter=6, tripwire_every=1)) == \
        _trip(lambda: js.sharded_label_propagation(
            js.shard_graph_arrays(js.partition_graph(jk, mesh=j2), j2), j2, max_iter=6,
            tripwire_every=1)) == ("oscillation", 0, 2)
    # CC: a negative label keeps itself forever
    csrc = np.arange(0, 30, dtype=np.int32)
    jc, tc = _pair(csrc, (csrc + 1) % 31, 31)
    cbad = np.arange(31, dtype=np.int32)
    cbad[5] = -9
    assert _trip(lambda: ts.sharded_connected_components(
        ts.partition_graph(tc, mesh=tm), tm, init_labels=torch.from_numpy(cbad),
        tripwire_every=1)) == _trip(lambda: js.sharded_connected_components(
            js.shard_graph_arrays(js.partition_graph(jc, mesh=jm), jm), jm,
            init_labels=jnp.asarray(cbad), tripwire_every=1))
    # PageRank: NaN weights in shard 2, attributed to it
    jgw, tgw = _pair(src, dst, 64, w, symmetric=False)
    jh, th = js.partition_graph(jgw, mesh=jm), ts.partition_graph(tgw, mesh=tm)
    mw = np.asarray(jh.msg_weight).copy()
    mw[2, :4] = np.nan
    assert _trip(lambda: ts.sharded_pagerank(
        dataclasses.replace(th, msg_weight=mw), tm, out_weights(tgw), max_iter=20,
        tripwire_every=2)) == _trip(lambda: js.sharded_pagerank(
            js.shard_graph_arrays(dataclasses.replace(jh, msg_weight=mw), jm), jm,
            jout_weights(jgw), max_iter=20, tripwire_every=2))


@pytest.mark.parametrize("d", [2, 4])
def test_unported_partitions_and_mesh_errors(d):
    """What waited for ROADMAP A7b runs: the source-sharded PPR (within
    rtol 1e-5 of JAX's sharded run and of the single-device batch, empty
    sources included) and the blocked and 2-D partitions; the mesh
    errors stay."""
    from graphmine_tpu.parallel.ppr import sharded_personalized_pagerank as jppr

    from graphmine_tpu_torch.ops.pagerank import parallel_personalized_pagerank
    from graphmine_tpu_torch.parallel import sharded_personalized_pagerank

    src, dst, _ = _edges(1, 50, 200)
    jg, tg = _pair(src, dst, 50, symmetric=False)
    jm, tm = meshes(d)
    sources = [0, 3, 3, 17, 49]
    got = sharded_personalized_pagerank(tg, sources, tm)
    assert got.shape == (50, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jppr(jg, sources, jm)), rtol=1e-5,
                               atol=1e-7)
    assert torch.equal(got, parallel_personalized_pagerank(tg, sources))
    assert sharded_personalized_pagerank(tg, [], tm).shape == (50, 0)
    with pytest.raises(ValueError, match="out of range"):
        sharded_personalized_pagerank(tg, [50], tm)
    for kw in ({"build_blocked_plan": True}, {"build_plan2d": True}):
        sg = ts.partition_graph(tg, num_shards=d, **kw)
        assert sg.blk_row_idx and (sg.x2d_src_local is not None) == ("build_plan2d" in kw)
    with pytest.raises(ValueError, match="pass num_shards or mesh"):
        ts.partition_graph(tg)
    _, t4 = meshes(4)
    _, t2 = meshes(2)
    with pytest.raises(ValueError, match="partitioned into 4 shards but the mesh has 2"):
        ts.sharded_label_propagation(ts.partition_graph(tg, mesh=t4), t2)
