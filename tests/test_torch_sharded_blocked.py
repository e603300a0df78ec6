"""The blocked shard family: the port on a ``[cpu] * D`` virtual mesh
against the JAX package on its virtual CPU mesh (D = 2 and 4).

The stacked blocking plan (each shard's chunk a bin group of destination
tiles, one width ladder and tile width over the shards) is bit-equal to
JAX's, weighted or not, at a multi-bin budget and the default; LPA
(weighted too), CC with its telemetry and the LPA fixpoint on it are
bit-equal to JAX's sharded blocked runs and to the single-device ops,
including a hub past the width ladder's 2,048 and a ragged last shard;
the ``lpa_only`` placement keeps the plan and drops the sort-body
arrays. Graphs have at most 4,093 vertices.
"""

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild
from graphmine_tpu.parallel import sharded as js
from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh

from graphmine_tpu_torch.graph.container import build_graph as tbuild
from graphmine_tpu_torch.ops.cc import connected_components
from graphmine_tpu_torch.ops.lpa import label_propagation
from graphmine_tpu_torch.parallel import sharded as ts
from graphmine_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def virtual_devices():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", "8")
        yield
    torch.set_num_threads(threads)


def _edges(seed, v, e, hub=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if hub:
        src = np.concatenate([src, rng.integers(1, v, hub).astype(np.int32)])
        dst = np.concatenate([dst, np.zeros(hub, np.int32)])
    return src, dst, (rng.integers(1, 16, len(src)) / 4).astype(np.float32)


GRAPHS = {"random": (3, 301, 1500, 0), "hub": (5, 4093, 9000, 2600)}


def _pair(name, weighted):
    seed, v, e, hub = GRAPHS[name]
    src, dst, w = _edges(seed, v, e, hub)
    kw = dict(num_vertices=v, edge_weights=w if weighted else None)
    return jbuild(src, dst, **kw), tbuild(src, dst, device="cpu", **kw)


@pytest.mark.parametrize("tile_slots", [512, None], ids=["multibin", "default"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_blocked_plan_arrays_bit_equal(name, d, weighted, tile_slots):
    jg, tg = _pair(name, weighted)
    jp = js.partition_graph(jg, num_shards=d, build_blocked_plan=True,
                            blocked_tile_slots=tile_slots)
    tp = ts.partition_graph(tg, num_shards=d, build_blocked_plan=True,
                            blocked_tile_slots=tile_slots)
    for f in ("blk_src", "blk_pos", "msg_recv_local", "msg_send", "degrees"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f)
        assert b.dtype == a.dtype and np.array_equal(a, b), f
    for f in ("blk_row_idx", "blk_row_target", "blk_row_weight"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert len(a) == len(b) and all(np.array_equal(np.asarray(x), y)
                                        for x, y in zip(a, b)), f
    assert tp.blk_tile_alloc == jp.blk_tile_alloc and tp.x2d_src_local is None
    assert bool(tp.blk_row_weight) == weighted


@pytest.fixture(scope="module")
def jax_blocked():
    """JAX's sharded blocked runs at 4 shards on both graphs: LPA (4
    supersteps, unweighted and weighted), CC with telemetry, the LPA
    fixpoint."""
    jm = jmake_mesh(4)
    out = {}
    for name in GRAPHS:
        runs = {}
        for weighted in (False, True):
            jg, _ = _pair(name, weighted)
            jsg = js.shard_graph_arrays(js.partition_graph(jg, mesh=jm, build_blocked_plan=True,
                                                           blocked_tile_slots=512), jm)
            runs[weighted] = np.asarray(js.sharded_label_propagation(jsg, jm, max_iter=4))
            if not weighted:
                cc, tele = js.sharded_connected_components(jsg, jm, telemetry=True)
                fix = js.sharded_lpa_fixpoint(jsg, jm, max_iter=12)
                runs["cc"] = (np.asarray(cc), tele)
                runs["fixpoint"] = (np.asarray(fix[0]), fix[1], fix[2])
        out[name] = runs
    return out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_blocked_runs_bit_equal_to_jax_and_single(name, jax_blocked):
    m = make_mesh(4, devices=[CPU] * 4)
    want = jax_blocked[name]
    for weighted in (False, True):
        _, tg = _pair(name, weighted)
        host = ts.partition_graph(tg, mesh=m, build_blocked_plan=True, blocked_tile_slots=512)
        sg = ts.shard_graph_arrays(host, m)
        got = ts.sharded_label_propagation(sg, m, max_iter=4)
        assert np.array_equal(got.numpy(), want[weighted]), weighted
        assert torch.equal(got, label_propagation(tg, max_iter=4))
        lean = ts.shard_graph_arrays(host, m, lpa_only=True)
        assert lean.msg_send is None and lean.blk_src is not None
        assert torch.equal(ts.sharded_label_propagation(lean, m, max_iter=4), got)
    _, tg = _pair(name, False)
    sg = ts.partition_graph(tg, mesh=m, build_blocked_plan=True, blocked_tile_slots=512)
    cc, tele = ts.sharded_connected_components(sg, m, telemetry=True)
    want_cc, want_tele = want["cc"]
    assert np.array_equal(cc.numpy(), want_cc) and torch.equal(cc, connected_components(tg))
    assert tele.iterations == want_tele.iterations
    np.testing.assert_array_equal(tele.labels_changed, want_tele.labels_changed)
    np.testing.assert_array_equal(tele.shard_changed, want_tele.shard_changed)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_blocked_fixpoint_equal(name, jax_blocked):
    m = make_mesh(4, devices=[CPU] * 4)
    _, tg = _pair(name, False)
    sg = ts.partition_graph(tg, mesh=m, build_blocked_plan=True, blocked_tile_slots=512)
    labels, it, conv = ts.sharded_lpa_fixpoint(sg, m, max_iter=12)
    want_l, want_it, want_conv = jax_blocked[name]["fixpoint"]
    assert np.array_equal(labels.numpy(), want_l) and (it, conv) == (want_it, want_conv)
