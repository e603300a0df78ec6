"""The ring schedule: labels stay sharded and chunks rotate. The port on a
``[cpu] * D`` virtual mesh against the JAX package's ring ops on its own
virtual CPU mesh (D = 2 and 4): LPA (weighted too) and CC bit-equal,
PageRank within rtol 1e-5 (weighted too); a multi-axis mesh is refused
as in JAX.
"""

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild
from graphmine_tpu.ops.degrees import out_degrees as jout_degrees
from graphmine_tpu.ops.degrees import out_weights as jout_weights
from graphmine_tpu.parallel import ring as jr
from graphmine_tpu.parallel import sharded as js
from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh

from graphmine_tpu_torch.graph.container import build_graph as tbuild
from graphmine_tpu_torch.ops.degrees import out_degrees, out_weights
from graphmine_tpu_torch.parallel import ring as tr
from graphmine_tpu_torch.parallel import sharded as ts
from graphmine_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh

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


def _edges(seed, v, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    return src, dst, (rng.integers(1, 16, e) / 4).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 4])
def test_ring_lpa_and_cc_bit_equal(d, weighted):
    src, dst, w = _edges(21, 333, 900)
    w = w if weighted else None
    jg = jbuild(src, dst, num_vertices=333, edge_weights=w)
    tg = tbuild(src, dst, num_vertices=333, edge_weights=w, device="cpu")
    jm, tm = jmake_mesh(d), make_mesh(d, devices=[CPU] * d)
    jsg = js.shard_graph_arrays(js.partition_graph(jg, mesh=jm), jm)
    tsg = ts.shard_graph_arrays(ts.partition_graph(tg, mesh=tm), tm)
    want = np.asarray(jr.ring_label_propagation(jsg, jm, max_iter=5))
    got = tr.ring_label_propagation(tsg, tm, max_iter=5)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same labels as the replicated schedule, from a resumed state too
    np.testing.assert_array_equal(got.numpy(),
                                  ts.sharded_label_propagation(tsg, tm, max_iter=5).numpy())
    mid = tr.ring_label_propagation(tsg, tm, max_iter=2)
    np.testing.assert_array_equal(
        tr.ring_label_propagation(tsg, tm, max_iter=3, init_labels=mid).numpy(), want)
    if not weighted:
        np.testing.assert_array_equal(tr.ring_connected_components(tsg, tm).numpy(),
                                      np.asarray(jr.ring_connected_components(jsg, jm)))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 4])
def test_ring_pagerank_within_rtol(d, weighted):
    src, dst, w = _edges(9, 250, 1000)
    w = w if weighted else None
    jg = jbuild(src, dst, num_vertices=250, edge_weights=w, symmetric=False)
    tg = tbuild(src, dst, num_vertices=250, edge_weights=w, symmetric=False, device="cpu")
    jm, tm = jmake_mesh(d), make_mesh(d, devices=[CPU] * d)
    jod = jout_weights(jg) if weighted else jout_degrees(jg)
    tod = out_weights(tg) if weighted else out_degrees(tg)
    want = np.asarray(jr.ring_pagerank(js.shard_graph_arrays(js.partition_graph(jg, mesh=jm),
                                                             jm), jm, jod, max_iter=60))
    tsg = ts.partition_graph(tg, mesh=tm)
    got = tr.ring_pagerank(tsg, tm, tod, max_iter=60).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, ts.sharded_pagerank(tsg, tm, tod, max_iter=60).numpy(),
                               rtol=1e-5, atol=0)


def test_ring_rejects_a_multislice_mesh():
    src, dst, _ = _edges(2, 64, 200)
    tg = tbuild(src, dst, num_vertices=64, device="cpu")
    tm = make_multislice_mesh(2, 2, devices=[CPU] * 4)
    sg = ts.partition_graph(tg, mesh=tm)
    with pytest.raises(ValueError, match="ring schedules need a 1-D"):
        tr.ring_label_propagation(sg, tm)
    with pytest.raises(ValueError, match="ring schedules need a 1-D"):
        tr.ring_connected_components(sg, tm)
