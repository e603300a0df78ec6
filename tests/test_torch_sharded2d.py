"""The 2-D edge partition and its neighbour-only exchange: the port on a
``[cpu] * D`` virtual mesh against the JAX package on its virtual CPU mesh.

Plan arrays (the blocked bin groups with and without the per-peer tables,
for 2, 3 and 4 shards, weighted or not, at two bin budgets) are bit-equal
to JAX's; on hand-built 3-shard graphs the send tables decode to the
blocked stream and the boundary sets are the hand-computed ones. LPA,
weighted LPA and CC on the ``sharded_2d`` family are bit-equal to the
JAX package's single-device ops and sharded 2-D run, and to the port's
blocked family superstep by superstep; the fixpoint and warm start, the
multi-axis refusal, the crossover policy and its environment overrides,
the planner's ladder, the cost and memory models' exact bytes and the
``shard_exchange`` record are the JAX package's. JAX results are shared
through module fixtures; graphs have at most 301 vertices.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild
from graphmine_tpu.obs import costmodel as jcost
from graphmine_tpu.obs import memmodel as jmem
from graphmine_tpu.ops import blocking as jb
from graphmine_tpu.ops.cc import connected_components as jcc
from graphmine_tpu.ops.lpa import label_propagation as jlpa
from graphmine_tpu.parallel import sharded as js
from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh
from graphmine_tpu.pipeline import planner as jplanner

from graphmine_tpu_torch.graph.container import build_graph as tbuild
from graphmine_tpu_torch.obs import costmodel, memmodel
from graphmine_tpu_torch.obs.schema import validate_record
from graphmine_tpu_torch.ops import blocking as tb
from graphmine_tpu_torch.parallel import sharded as ts
from graphmine_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
from graphmine_tpu_torch.pipeline import planner

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def virtual_devices():
    """An 8-shard virtual CPU mesh and one intra-op thread (the shard
    bodies are many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", "8")
        yield
    torch.set_num_threads(threads)


def tmesh(d):
    return make_mesh(d, devices=[CPU] * d)


def _zoo():
    """The JAX suite's parity graphs: power-law, a ring (the chunk-local
    pointer jump's slow case), self-loops, isolated vertices, duplicates."""
    rng = np.random.default_rng(15)
    v = 96
    deg = rng.pareto(1.2, 400)
    pl_src = np.minimum((deg * v / 40).astype(np.int64), v - 1).astype(np.int32)
    pl_dst = rng.integers(0, v, 400).astype(np.int32)
    ring_src = np.arange(64, dtype=np.int32)
    ring_dst = ((ring_src + 1) % 64).astype(np.int32)
    loops = np.arange(0, 40, 2, dtype=np.int32)
    dup = rng.integers(0, 30, 50).astype(np.int32)
    return {
        "powerlaw": (pl_src, pl_dst, v),
        "ring": (ring_src, ring_dst, 64),
        "self_loops": (np.concatenate([pl_src[:100], loops]),
                       np.concatenate([pl_dst[:100], loops]), v),
        "isolated": (pl_src[:200] % 90, pl_dst[:200] % 90, v),
        "duplicates": (np.concatenate([dup, dup]), np.concatenate([dup[::-1], dup[::-1]]), 30),
    }


ZOO = _zoo()


@pytest.fixture(scope="module")
def jax_oracle():
    """The JAX package's single-device LPA (4 supersteps) and CC of every
    zoo graph."""
    out = {}
    for name, (src, dst, v) in ZOO.items():
        g = jbuild(src, dst, num_vertices=v)
        out[name] = (np.asarray(jlpa(g, max_iter=4)), np.asarray(jcc(g)))
    return out


def _edges(seed, v, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    return src, dst, (rng.integers(1, 16, e) / 4).astype(np.float32)


# ---- plan arrays ---------------------------------------------------------------


PLAN_FIELDS = ("blk_src", "blk_pos", "x2d_send_tab", "x2d_src_local")
PLAN_TUPLES = ("blk_row_idx", "blk_row_target", "blk_row_weight")
PLAN_INTS = ("blk_tile_alloc", "x2d_boundary", "x2d_boundary_total")


def same_plan(jp, tp):
    for f in PLAN_FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == np.asarray(a).dtype and np.array_equal(np.asarray(a), b), f
    for f in PLAN_TUPLES:
        a, b = getattr(jp, f), getattr(tp, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), y), f
    for f in PLAN_INTS:
        assert getattr(jp, f) == getattr(tp, f), f


@pytest.mark.parametrize("tile_slots", [64, None], ids=["multibin", "default"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_plan2d_arrays_bit_equal(d, weighted, tile_slots):
    src, dst, w = _edges(d, 301, 1500)
    kw = dict(num_vertices=301, edge_weights=w if weighted else None)
    jg, tg = jbuild(src, dst, **kw), tbuild(src, dst, device="cpu", **kw)
    jp = js.partition_graph(jg, num_shards=d, build_plan2d=True, blocked_tile_slots=tile_slots)
    tp = ts.partition_graph(tg, num_shards=d, build_plan2d=True, blocked_tile_slots=tile_slots)
    assert tp.blk_src is None and tp.x2d_src_local is not None
    same_plan(jp, tp)


def _decode_table_ids(sg):
    """The global sender id of every compact-table slot, per shard."""
    d, vc, b = sg.num_shards, sg.chunk_size, sg.x2d_boundary
    tab = np.asarray(sg.x2d_send_tab)
    ids = np.zeros((d, vc + (d - 1) * b + 1), dtype=np.int64)
    for s in range(d):
        ids[s, :vc] = s * vc + np.arange(vc)
        for r in range(1, d):
            owner = (s - r) % d
            ids[s, vc + (r - 1) * b: vc + r * b] = owner * vc + tab[owner, r - 1]
        ids[s, -1] = vc * d
    return ids


@pytest.mark.parametrize("pad", [1, 8])
def test_index_tables_reconstruct_stream_3_shards(pad):
    """Each shard's compact table, decoded through the send tables, gives
    the blocked family's global sender stream slot for slot, as JAX's."""
    src = np.array([0, 3, 7, 11, 15, 17, 2, 9, 9, 4], dtype=np.int32)
    dst = np.array([6, 13, 1, 5, 0, 12, 2, 16, 16, 10], dtype=np.int32)
    kw = dict(num_vertices=18, num_shards=3, pad_multiple=pad)
    blk = ts.partition_graph(src, dst, build_blocked_plan=True, **kw)
    sg = ts.partition_graph(src, dst, build_plan2d=True, **kw)
    decoded = np.take_along_axis(_decode_table_ids(sg), sg.x2d_src_local.astype(np.int64), 1)
    np.testing.assert_array_equal(decoded, blk.blk_src)
    same_plan(js.partition_graph(src, dst, build_plan2d=True, **kw), sg)


def test_boundary_sets_are_unique_sorted_and_exact():
    """3 shards of 2 vertices; edges 0-2, 1-4, 3-5 (messages both ways)."""
    src, dst = np.array([0, 1, 3], np.int32), np.array([2, 4, 5], np.int32)
    sg = ts.partition_graph(src, dst, num_vertices=6, num_shards=3, build_plan2d=True,
                            pad_multiple=1)
    assert sg.chunk_size == 2
    want = {(2, 1): [0], (1, 2): [0], (0, 1): [0], (2, 2): [1], (1, 1): [1], (0, 2): [1]}
    for (owner, r), ids in want.items():
        assert sg.x2d_send_tab[owner, r - 1, :len(ids)].tolist() == ids, (owner, r)
    assert sg.x2d_boundary_total == 6 and sg.x2d_boundary >= 1
    same_plan(js.partition_graph(src, dst, num_vertices=6, num_shards=3, build_plan2d=True,
                                 pad_multiple=1), sg)


def test_plan2d_mutually_exclusive_with_bucket_plan():
    src, dst, _ = _edges(1, 20, 50)
    for mod in (js, ts):
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.partition_graph(src, dst, num_vertices=20, num_shards=2,
                                build_bucket_plan=True, build_plan2d=True)


# ---- labels --------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ZOO))
def test_2d_lpa_cc_bit_equal(name, jax_oracle):
    """LPA and CC on the 2-D family, at 8 shards (most of them tiny), equal
    the JAX single-device ops and the port's blocked family."""
    src, dst, v = ZOO[name]
    g = tbuild(src, dst, num_vertices=v, device="cpu")
    m = tmesh(8)
    sg = ts.shard_graph_arrays(ts.partition_graph(g, mesh=m, build_plan2d=True), m)
    blk = ts.shard_graph_arrays(ts.partition_graph(g, mesh=m, build_blocked_plan=True), m)
    want_lpa, want_cc = jax_oracle[name]
    got = ts.sharded_label_propagation(sg, m, max_iter=4)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want_lpa)
    assert np.array_equal(ts.sharded_label_propagation(blk, m, max_iter=4).numpy(), want_lpa)
    assert np.array_equal(ts.sharded_connected_components(sg, m).numpy(), want_cc)
    assert np.array_equal(ts.sharded_connected_components(blk, m).numpy(), want_cc)


@pytest.fixture(scope="module")
def jax_2d_runs():
    """The JAX package's own 2-D runs at 4 shards: LPA (1, 3 supersteps and
    the fixpoint), CC with its telemetry, on one random graph."""
    src, dst, _ = _edges(7, 90, 350)
    jm = jmake_mesh(4)
    jsg = js.shard_graph_arrays(
        js.partition_graph(jbuild(src, dst, num_vertices=90), mesh=jm, build_plan2d=True), jm)
    fix = js.sharded_lpa_fixpoint(jsg, jm, max_iter=64)
    cc, tele = js.sharded_connected_components(jsg, jm, telemetry=True)
    return {"graph": (src, dst, 90),
            "lpa": {it: np.asarray(js.sharded_label_propagation(jsg, jm, max_iter=it))
                    for it in (1, 3)},
            "fixpoint": (np.asarray(fix[0]), fix[1], fix[2]),
            "cc": (np.asarray(cc), tele)}


def _placed_2d(src, dst, v, d=4, **kw):
    m = tmesh(d)
    g = tbuild(src, dst, num_vertices=v, device="cpu", **kw)
    return ts.shard_graph_arrays(ts.partition_graph(g, mesh=m, build_plan2d=True), m), m, g


def test_2d_runs_bit_equal_to_jax_2d(jax_2d_runs):
    """Every superstep count, the fixpoint and CC with its telemetry (the
    chunk-local pointer jump's superstep count too) equal JAX's 2-D run."""
    sg, m, _ = _placed_2d(*jax_2d_runs["graph"])
    for it, want in jax_2d_runs["lpa"].items():
        assert np.array_equal(ts.sharded_label_propagation(sg, m, max_iter=it).numpy(), want)
    labels, it, conv = ts.sharded_lpa_fixpoint(sg, m, max_iter=64)
    want_l, want_it, want_conv = jax_2d_runs["fixpoint"]
    assert np.array_equal(labels.numpy(), want_l) and (it, conv) == (want_it, want_conv)
    cc, tele = ts.sharded_connected_components(sg, m, telemetry=True)
    want_cc, want_tele = jax_2d_runs["cc"]
    assert np.array_equal(cc.numpy(), want_cc)
    assert tele.iterations == want_tele.iterations
    np.testing.assert_array_equal(tele.labels_changed, want_tele.labels_changed)
    np.testing.assert_array_equal(tele.shard_changed, want_tele.shard_changed)


def test_2d_weighted_lpa_bit_equal():
    src, dst, w = _edges(8, 80, 400)
    want = np.asarray(jlpa(jbuild(src, dst, num_vertices=80, edge_weights=w), max_iter=4))
    sg, m, _ = _placed_2d(src, dst, 80, d=8, edge_weights=w)
    assert sg.blk_row_weight
    assert np.array_equal(ts.sharded_label_propagation(sg, m, max_iter=4).numpy(), want)


def test_2d_matches_blocked_family_per_superstep():
    """The 2-D tile is the blocked one value for value: LPA after 1, 2, 3
    and 5 supersteps equals the blocked family's, and so do the CC
    fixpoint and the LPA fixpoint's telemetry-free answer."""
    src, dst, _ = _edges(9, 70, 300)
    g = tbuild(src, dst, num_vertices=70, device="cpu")
    m = tmesh(8)
    blk = ts.shard_graph_arrays(ts.partition_graph(g, mesh=m, build_blocked_plan=True), m)
    sg = ts.shard_graph_arrays(ts.partition_graph(g, mesh=m, build_plan2d=True), m)
    for it in (1, 2, 3, 5):
        assert torch.equal(ts.sharded_label_propagation(blk, m, max_iter=it),
                           ts.sharded_label_propagation(sg, m, max_iter=it)), it
    assert torch.equal(ts.sharded_connected_components(blk, m),
                       ts.sharded_connected_components(sg, m))


def test_2d_fixpoint_and_warm_start(jax_2d_runs):
    """A fixpoint stays a fixpoint under one more superstep (the sampled
    check's predicate), warm-started through the 2-D family."""
    sg, m, _ = _placed_2d(*jax_2d_runs["graph"])
    labels, it, conv = ts.sharded_lpa_fixpoint(sg, m, max_iter=64)
    assert conv and it >= 1
    again, it2, conv2 = ts.sharded_lpa_fixpoint(sg, m, max_iter=1, init_labels=labels)
    assert conv2 and it2 == 1 and torch.equal(again, labels)


def test_2d_multi_axis_mesh_rejected():
    src, dst, _ = _edges(10, 40, 200)
    mesh = make_multislice_mesh(2, 2, devices=[CPU] * 4)
    sg = ts.partition_graph(src, dst, num_vertices=40, mesh=mesh, build_plan2d=True)
    for run in (ts.sharded_label_propagation, ts.sharded_connected_components):
        with pytest.raises(ValueError, match="1-D mesh"):
            run(sg, mesh, max_iter=2)


def test_2d_lpa_only_placement_and_tripwire():
    """``lpa_only`` keeps the 2-D plan (LPA and CC still run on it) and
    drops the sort-body arrays; a poisoned label trips the range guard."""
    from graphmine_tpu_torch.pipeline.resilience import DivergenceError

    src, dst, _ = _edges(11, 60, 250)
    m = tmesh(4)
    host = ts.partition_graph(src, dst, num_vertices=60, mesh=m, build_plan2d=True)
    lean = ts.shard_graph_arrays(host, m, lpa_only=True)
    full = ts.shard_graph_arrays(host, m)
    assert lean.msg_send is None and lean.x2d_src_local is not None
    assert torch.equal(ts.sharded_label_propagation(lean, m, max_iter=3),
                       ts.sharded_label_propagation(full, m, max_iter=3))
    bad = np.arange(60, dtype=np.int32)
    bad[7] = 10_000
    with pytest.raises(DivergenceError):
        ts.sharded_lpa_fixpoint(full, m, max_iter=4, init_labels=bad, tripwire_every=1)


# ---- policy and planner ----------------------------------------------------------


def test_policy_selects_2d_past_crossover(monkeypatch):
    monkeypatch.delenv("GRAPHMINE_SUPERSTEP_FAMILY", raising=False)
    # below either package's blocked wall (the port's sits above the JAX
    # package's, chip smoke phase 10c)
    for v, msgs, d in itertools.product((10, 1 << 16), (tb.SHARDED2D_MIN_MESSAGES - 1,
                                                             tb.SHARDED2D_MIN_MESSAGES, 1 << 23),
                                        (1, 2, 8)):
        got = tb.select_superstep_family(v, msgs, num_devices=d)
        want = jb.select_superstep_family(v, msgs, num_devices=d)
        assert got[0] == want[0], (v, msgs, d)
    fam, reason = tb.select_superstep_family(1 << 16, tb.SHARDED2D_MIN_MESSAGES, num_devices=8)
    assert fam == "sharded_2d" and "neighbor-only" in reason and "not measured" in reason
    assert (tb.SHARDED2D_MIN_MESSAGES, tb.SHARDED2D_MIN_DEVICES) == (
        jb.SHARDED2D_MIN_MESSAGES, jb.SHARDED2D_MIN_DEVICES)


def test_policy_requested_2d_on_one_device_is_loud():
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="2-device mesh"):
            mod.select_superstep_family(100, 100, requested="sharded_2d")
        fam, reason = mod.select_superstep_family(100, 100, requested="sharded_2d",
                                                  num_devices=4)
        assert fam == "sharded_2d" and "requested" in reason


def test_policy_env_overrides(monkeypatch):
    monkeypatch.setenv("GRAPHMINE_SHARDED2D_MIN_MESSAGES", "10")
    monkeypatch.setenv("GRAPHMINE_SHARDED2D_MIN_DEVICES", "3")
    thr, jthr = tb.crossover_thresholds(), jb.crossover_thresholds()
    assert (thr["sharded2d_min_messages"], thr["sharded2d_min_devices"]) == (10, 3)
    for key in ("sharded2d_min_messages", "sharded2d_min_devices"):
        assert thr[key] == jthr[key], key
    for env in (None, "sharded_2d"):
        if env:
            monkeypatch.setenv("GRAPHMINE_SUPERSTEP_FAMILY", env)
        for msgs, d in ((10, 3), (10, 2), (5, 2), (5, 1)):
            got, want = (mod.select_superstep_family(100, msgs, num_devices=d)
                         for mod in (tb, jb))
            assert got[0] == want[0], (env, msgs, d)
    assert tb.select_superstep_family(100, 5, num_devices=1)[0] != "sharded_2d"


def test_planner_ladder_degrades_2d_to_one_allgather():
    assert planner._SUPERSTEP_DEGRADE == jplanner._SUPERSTEP_DEGRADE
    assert memmodel.FAMILY_DEGRADE == jmem.FAMILY_DEGRADE
    for d in (1, 8):
        got, want = planner.plan_superstep(1 << 16, 1 << 14, num_devices=d), \
            jplanner.plan_superstep(1 << 16, 1 << 14, num_devices=d)
        assert (got.family, got.degrade_to) == (want.family, want.degrade_to)
    assert planner.plan_superstep(1 << 16, 1 << 14, num_devices=8).degrade_to == "blocked"
    assert planner.degradation_ladder("single", 1, family="sharded_2d") == \
        jplanner.degradation_ladder("single", 1, family="sharded_2d")


# ---- cost and memory models ------------------------------------------------------


def _tiny_2d(d=4, v=4096, e=8192, seed=12):
    """Power-law senders (boundaries well under Vc): the host partition of
    both packages."""
    rng = np.random.default_rng(seed)
    src = np.minimum((rng.pareto(1.2, e) * v / 50).astype(np.int64), v - 1).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    kw = dict(num_vertices=v, num_shards=d, build_plan2d=True)
    return ts.partition_graph(src, dst, **kw), js.partition_graph(src, dst, **kw)


@pytest.mark.parametrize("d", [4, 8])
def test_costmodel_exchange_bytes_exact_and_below_ladder(d):
    tp, jp = _tiny_2d(d=d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", str(d))
        placed = ts.shard_graph_arrays(tp, tmesh(d))
    want = jcost.sharded_superstep_cost("lpa_superstep", jp, 8192)
    for sg in (tp, placed):
        cost = costmodel.sharded_superstep_cost("lpa_superstep", sg, 8192)
        assert (cost.family, cost.devices) == ("sharded_2d", d)
        for key in ("exchange_bytes", "padded_slots", "slots", "bytes_gathered",
                    "bytes_scattered"):
            assert getattr(cost, key) == getattr(want, key), key
        assert cost.exchange_bytes == 4 * (d - 1) * tp.x2d_boundary < \
            costmodel.allgather_exchange_bytes(sg) == 4 * tp.chunk_size * (d - 1)
        assert costmodel.neighbor_frontier_bytes(sg) == jcost.neighbor_frontier_bytes(jp) == \
            4 * -(-tp.x2d_boundary_total // d)
        assert costmodel.neighbor_exchange_bytes(sg) == jcost.neighbor_exchange_bytes(jp)
    # the blocked family's compute model reads the same shapes
    src, dst, _ = _edges(13, 200, 900)
    kw = dict(num_vertices=200, num_shards=d, build_blocked_plan=True)
    tblk, jblk = ts.partition_graph(src, dst, **kw), js.partition_graph(src, dst, **kw)
    got = costmodel.sharded_superstep_cost("cc_superstep", tblk, 900, weighted=False)
    want = jcost.sharded_superstep_cost("cc_superstep", jblk, 900, weighted=False)
    assert got.family == want.family == "blocked"
    for key in ("exchange_bytes", "padded_slots", "bytes_gathered", "bytes_scattered"):
        assert getattr(got, key) == getattr(want, key), key


def test_memmodel_footprint_exact_against_shapes():
    d = 4
    tp, jp = _tiny_2d(d=d)
    est = memmodel.sharded_superstep_footprint("lpa_superstep", tp)
    want = jmem.sharded_superstep_footprint("lpa_superstep", jp)
    assert est.family == want.family == "sharded_2d" and est.exact
    inv, b = est.inventory, tp.x2d_boundary
    for key in ("exchange_send_tab", "exchange_recv_bufs", "labels_sharded", "stream", "tile",
                "reduce_rows", "row_vertex"):
        assert inv[key] == want.inventory[key], key
    assert inv["exchange_send_tab"] == inv["exchange_recv_bufs"] == 4 * (d - 1) * b
    assert inv["labels_sharded"] == 2 * 4 * tp.chunk_size
    assert "labels_replicated" not in inv and "exchange_buffer" not in inv
    assert est.record()["family"] == "sharded_2d" and est.record()["total_bytes"] > 0


def test_predegrade_per_peer_buffers():
    """The pre-build 2-D estimate models every boundary as the whole peer
    chunk; a budget below it walks to the one-all-gather ``blocked`` rung
    with the oversized inventory, as the JAX model does."""
    v, m, e, d = 1 << 16, 1 << 17, 1 << 16, 8
    est = memmodel.superstep_footprint("lpa_superstep", "sharded_2d", v, m, num_edges=e,
                                       num_devices=d)
    assert not est.exact and est.devices == d
    vc = -(-v // d)
    assert est.inventory["exchange_send_tab"] == est.inventory["exchange_recv_bufs"] == \
        4 * vc * (d - 1)
    for budget in (est.total_bytes // 4, 1 << 40):
        fam, _fit, steps = memmodel.predegrade_superstep("sharded_2d", v, m, e, False, budget,
                                                         num_devices=d)
        jfam, _jfit, jsteps = jmem.predegrade_superstep("sharded_2d", v, m, e, False, budget,
                                                        num_devices=d)
        assert [s[:2] for s in steps] == [s[:2] for s in jsteps]
        assert (fam == "sharded_2d") == (jfam == "sharded_2d") == (budget == 1 << 40)
    assert steps == [] and fam == "sharded_2d"
    fam, _fit, steps = memmodel.predegrade_superstep("sharded_2d", v, m, e, False,
                                                     est.total_bytes // 4, num_devices=d)
    assert steps[0][:2] == ("sharded_2d", "blocked")
    assert steps[0][2].total_bytes == est.total_bytes
    with pytest.raises(ValueError, match="num_devices >= 2"):
        memmodel.superstep_footprint("lpa_superstep", "sharded_2d", v, m, num_edges=e)


def test_shard_exchange_record_shape():
    class Sink:
        def emit(self, phase, **kv):
            return dict(phase=phase, t=time.time(), **kv)

    tp, jp = _tiny_2d()
    rec, want = (mod.emit_shard_exchange(Sink(), "delta_repair", sg)
                 for mod, sg in ((costmodel, tp), (jcost, jp)))
    assert validate_record(rec) == []
    keys = ("family", "devices", "peers", "exchange_bytes", "frontier_bytes", "ladder_bytes",
            "frontier_frac", "boundary_slots", "padded_boundary")
    assert {k: rec[k] for k in keys} == {k: want[k] for k in keys}
    assert rec["family"] == "sharded_2d" and rec["peers"] == 3
    assert rec["frontier_bytes"] <= rec["exchange_bytes"]
    sort = ts.partition_graph(np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32)[::-1],
                              num_vertices=8, num_shards=2)
    rec2 = costmodel.emit_shard_exchange(Sink(), "delta_repair", sort)
    assert rec2["family"] == "sort" and rec2["frontier_frac"] == 1.0
    assert costmodel.emit_shard_exchange(None, "x", tp) is None
