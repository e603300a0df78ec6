"""The bucketed LPA superstep's row-mode kernel (``csrc/bucketed_mode.cu``,
wrapper ``kernels/mode_cuda.py``).

On the CPU: the plan's descriptor table against its matrices, the routing
of classes between the kernel and the plain ``_bucket_mode`` (weighted
plans and classes past ``MAX_WIDTH`` stay plain, and on a CUDA device are
counted), and that a CPU superstep never reaches the kernel or its
counters. The ``card`` tests hold the kernel against ``_bucket_mode`` class
by class, labels equal, on every tier and on adversarial labels, and full
label propagation against the sort superstep.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.interop import graph_from_reference_arrays, reference_arrays
from graphmine_tpu_torch.kernels import mode_cuda
from graphmine_tpu_torch.ops import lpa
from graphmine_tpu_torch.ops.bucketed_mode import (
    _SENTINEL,
    BucketedModePlan,
    _bucket_mode,
    _mode_route,
    build_graph_and_plan,
)
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
INT32_MIN = -(1 << 31)
# Every tier and its edges: narrow (w <= 32), mid (33-2048), wide (the
# graph500-22 ladder's 3,072-34,992, and the widest the kernel takes).
TIER_WIDTHS = (1, 2, 3, 4, 5, 7, 8, 13, 16, 17, 31, 32, 33, 47, 64, 65, 100, 128, 257, 1000,
               1025, 2047, 2048, 2049, 3072, 4608, 10368, 34992, mode_cuda.MAX_WIDTH)
LABEL_KINDS = ("distinct", "duplicates", "ties", "extremes")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rows_of(width: int) -> int:
    """Rows a test class of ``width`` holds: partial blocks in every tier,
    few where rows are wide."""
    if width <= 32:
        return 1000 + width
    if width <= 2048:
        return 37 + 4096 // width
    return 5 if width <= 10368 else 2


def _synthetic_plan(widths, num_vertices: int, rng, senders=None, device=CPU,
                    min_degree: int = 1) -> BucketedModePlan:
    """A fused plan with one class a width (no hubs): each row's degree
    between the previous width (or ``min_degree``) and its own, padded with
    V; the senders drawn from ``senders(n, w)`` (uniform over ``[0, V)`` by
    default)."""
    order = rng.permutation(num_vertices)
    vertex_ids, send_idx, start, prev = [], [], 0, 0
    for w in widths:
        n = _rows_of(w)
        mat = (senders(n, w) if senders is not None
               else rng.integers(0, num_vertices, size=(n, w)))
        deg = rng.integers(max(prev + 1, min_degree), w + 1, size=n)
        mat = np.where(np.arange(w)[None, :] < deg[:, None], mat, num_vertices)
        send_idx.append(torch.from_numpy(mat.astype(np.int32)).to(device))
        vertex_ids.append(torch.from_numpy(order[start:start + n].astype(np.int32)).to(device))
        start, prev = start + n, w
    assert start <= num_vertices
    return BucketedModePlan(vertex_ids=tuple(vertex_ids), send_idx=tuple(send_idx),
                            num_vertices=num_vertices,
                            num_messages=int(sum(int(s.shape[0] * s.shape[1]) for s in send_idx)))


def _plain_rows(labels: torch.Tensor, plan: BucketedModePlan) -> torch.Tensor:
    """Every class's mode by the plain path, into a copy of the labels."""
    lbl_pad = torch.cat([labels, labels.new_full((1,), _SENTINEL)])
    out = labels.clone()
    for ids, sidx in zip(plan.vertex_ids, plan.send_idx):
        out[ids] = _bucket_mode(lbl_pad[sidx])
    return out


def _labels(kind: str, num_vertices: int, rng) -> np.ndarray:
    """Labels of each kind: all distinct (the first superstep, here random
    int32 of both signs); three values (heavy duplicates); eight values, so
    rows tie many ways; and int32's extremes with the sentinel among them."""
    if kind == "distinct":
        vals = rng.choice(np.arange(INT32_MIN, _SENTINEL, 4099, dtype=np.int64), num_vertices,
                          replace=False)
    elif kind == "duplicates":
        vals = rng.choice(np.array([7, -3, 1 << 30]), num_vertices, p=[0.6, 0.3, 0.1])
    elif kind == "ties":
        vals = rng.integers(-4, 4, num_vertices)
    else:
        vals = rng.choice(np.array([INT32_MIN, -1, 0, 1, _SENTINEL - 1, _SENTINEL]),
                          num_vertices)
    return vals.astype(np.int32)


def _fmix32(h: np.ndarray) -> np.ndarray:
    """The kernel's hash (murmur3's finaliser) on uint32."""
    h = h.astype(np.uint64)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h.astype(np.uint32)


def _unfmix32(h: np.ndarray) -> np.ndarray:
    """The labels whose hashes are ``h``: the finaliser's inverse."""
    h = h.astype(np.uint64)
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 1 << 32)) & 0xFFFFFFFF
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 1 << 32)) & 0xFFFFFFFF
    h ^= h >> 16
    return h.astype(np.uint32).view(np.int32)


# ---- CPU: the table, the routing, the wrapper's guard ---------------------


def test_class_layout_tiers_fit_their_kernels():
    for w in list(range(1, 4200)) + [10368, 34992, mode_cuda.MAX_WIDTH]:
        lay = mode_cuda.class_layout(w)
        if w <= mode_cuda.NARROW_MAX_W:
            assert lay["tier"] == "narrow" and lay["parts"] == 1
            assert w <= lay["cap"] < 2 * w or lay["cap"] == w == 1
            assert 32 % lay["cap"] == 0
            assert lay["rows_per_block"] * lay["cap"] == mode_cuda.NARROW_THREADS
        elif w <= mode_cuda.MID_MAX_W:
            assert lay["tier"] == "mid" and lay["parts"] == 1
            assert 2 * w <= lay["cap"] < 4 * w  # at most half full
            assert lay["rows_per_block"] * lay["cap"] <= mode_cuda.MID_TABLE
            assert lay["rows_per_block"] in (1, 2, 4, 8)
        else:
            assert lay["tier"] == "wide" and lay["rows_per_block"] == 1
            assert lay["cap"] <= mode_cuda.WIDE_MAX_TABLE
            num, den = mode_cuda.WIDE_LOAD
            # each part's share of an all-distinct row fits at WIDE_LOAD
            assert -(-w // lay["parts"]) * den <= lay["cap"] * num
            assert lay["parts"] <= mode_cuda.MAX_PARTS
    assert mode_cuda.class_layout(mode_cuda.MAX_WIDTH + 1) is None
    assert mode_cuda.class_layout(0) is None


def _check_table(plan: BucketedModePlan) -> None:
    table = plan.mode_table
    desc = table.desc.cpu().numpy()
    cols = {name: desc[:, i] for i, name in enumerate(mode_cuda.DESC_COLUMNS)}
    assert desc.shape == (len(table.classes), len(mode_cuda.DESC_COLUMNS))
    assert sorted(table.classes + table.plain_classes) == list(range(len(plan.vertex_ids)))
    tiers, scratch_rows = [], 0
    for i, b in enumerate(table.classes):
        sidx, ids = plan.send_idx[b], plan.vertex_ids[b]
        lay = mode_cuda.class_layout(int(sidx.shape[1]))
        tiers.append(mode_cuda.TIERS.index(lay["tier"]))
        assert cols["send"][i] == sidx.data_ptr() and cols["vids"][i] == ids.data_ptr()
        assert cols["width"][i] == sidx.shape[1]
        assert cols["rows"][i] == sidx.shape[0] == ids.shape[0]
        assert (cols["rows_per_block"][i], cols["cap"][i], cols["parts"][i]) == (
            lay["rows_per_block"], lay["cap"], lay["parts"])
        if lay["parts"] > 1:  # two words a row, in the table's scratch
            offset = int(cols["scratch"][i]) - table.scratch.data_ptr()
            assert offset % 16 == 0 and 0 <= offset // 16 <= table.scratch.shape[0] - sidx.shape[0]
            scratch_rows += int(sidx.shape[0])
        else:
            assert cols["scratch"][i] == 0
    assert table.scratch.shape == (scratch_rows, 2) and not table.scratch.any()
    assert tiers == sorted(tiers)  # tier order, one launch a tier
    start = 0
    for t, (n_cls, blocks) in enumerate(zip(table.tier_classes, table.tier_blocks)):
        assert tiers[start:start + n_cls] == [t] * n_cls
        widths = list(cols["width"][start:start + n_cls])
        assert widths == sorted(widths, reverse=True)  # widest first
        first = 0
        for i in range(start, start + n_cls):
            assert cols["first_block"][i] == first
            rows, per_block = int(cols["rows"][i]), int(cols["rows_per_block"][i])
            first += -(-rows // per_block) * int(cols["parts"][i])
        assert blocks == first
        start += n_cls
    wide = [int(c) for c, t in zip(cols["cap"], tiers) if t == 2]
    assert table.wide_cap == max(wide, default=0)
    assert table.launches == sum(1 for n in table.tier_classes if n)
    assert table.kernel_rows == sum(int(plan.vertex_ids[b].shape[0]) for b in table.classes)
    assert table.plain_rows == sum(int(plan.vertex_ids[b].shape[0]) for b in table.plain_classes)


@pytest.mark.parametrize("source", ["planted", "rmat", "synthetic", "interop", "replace"])
def test_plan_table_matches_the_plan(source):
    rng = np.random.default_rng(3)
    if source == "planted":
        s, d, _, _ = datasets.planted_anomaly_graph(1024, 12_000, seed=2)
        _, plan = build_graph_and_plan(s, d, device=CPU)
    elif source == "rmat":
        s, d = datasets.rmat(12, 16, seed=5)
        _, plan = build_graph_and_plan(s, d, device=CPU)
        assert plan.hist_vertex_ids is not None  # hubs stay out of the table
    else:
        plan = _synthetic_plan((1, 3, 32, 33, 700, 2049, 5000, mode_cuda.MAX_WIDTH + 1), 6000,
                               rng)
        if source == "interop":
            s, d, _, _ = datasets.planted_anomaly_graph(512, 6000, seed=4)
            graph, ref_plan = build_graph_and_plan(s, d, device=CPU)
            _, plan = graph_from_reference_arrays(reference_arrays(graph, ref_plan), device=CPU)
        elif source == "replace":
            plan = dataclasses.replace(plan, send_idx=plan.send_idx[:-1],
                                       vertex_ids=plan.vertex_ids[:-1])
    _check_table(plan)
    assert plan.mode_table.launches >= 2
    if source == "synthetic":
        assert plan.mode_table.tier_classes == (3, 2, 2)
        assert plan.mode_table.plain_classes == (7,)


def test_weighted_and_message_index_plans_have_no_table():
    s, d, _, _ = datasets.planted_anomaly_graph(512, 6000, seed=4)
    w = np.random.default_rng(1).random(len(s)).astype(np.float32)
    graph, weighted = build_graph_and_plan(s, d, edge_weights=w, device=CPU)
    assert weighted.mode_table is None
    assert BucketedModePlan.from_graph(graph).mode_table is None


def _counts() -> tuple:
    return (mode_cuda.LAUNCHES.value, mode_cuda.KERNEL_ROWS.value, mode_cuda.PLAIN_ROWS.value)


def test_routing_on_a_cuda_device_counts_the_plain_rows():
    """The routing is host code: a CPU-built plan routed as for a CUDA
    device, without launching anything."""
    rng = np.random.default_rng(8)
    plan = _synthetic_plan((2, 40, 3000, mode_cuda.MAX_WIDTH + 1), 3000, rng)
    wide_rows = int(plan.vertex_ids[3].shape[0])
    before = _counts()
    table, plain = _mode_route(plan, CUDA)
    assert table is plan.mode_table and tuple(plain) == (3,)
    assert table.classes == (0, 1, 2) and table.launches == 3
    assert _counts() == (before[0], before[1], before[2] + wide_rows)

    s, d, _, _ = datasets.planted_anomaly_graph(512, 6000, seed=4)
    w = np.random.default_rng(1).random(len(s)).astype(np.float32)
    _, weighted = build_graph_and_plan(s, d, edge_weights=w, device=CPU)
    rows = sum(int(ids.shape[0]) for ids in weighted.vertex_ids)
    before = _counts()
    table, plain = _mode_route(weighted, CUDA)
    assert table is None and list(plain) == list(range(len(weighted.vertex_ids)))
    assert _counts() == (before[0], before[1], before[2] + rows)

    before = _counts()
    table, plain = _mode_route(plan, CPU)
    assert table is None and list(plain) == [0, 1, 2, 3]
    assert _counts() == before


def test_cpu_superstep_never_touches_the_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("the CPU superstep launched the kernel")

    monkeypatch.setattr(mode_cuda, "launch", refuse)
    s, d = datasets.rmat(11, 16, seed=7)
    graph, plan = build_graph_and_plan(s, d, device=CPU)
    before = _counts()
    labels = lpa.label_propagation(graph, max_iter=3, plan=plan)
    assert _counts() == before
    assert torch.equal(labels, lpa.label_propagation(graph, max_iter=3, plan=None))


def test_kernel_wrapper_takes_only_cuda_tensors():
    rng = np.random.default_rng(2)
    plan = _synthetic_plan((3, 40), 2000, rng)
    labels = torch.arange(2000, dtype=torch.int32)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        mode_cuda.launch(labels, labels.clone(), plan.mode_table)
    assert _counts() == before


# ---- the card ---------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("kind", LABEL_KINDS)
def test_kernel_equals_the_plain_mode_on_every_tier(card, kind):
    rng = np.random.default_rng(LABEL_KINDS.index(kind))
    v = 40_000
    plan = _synthetic_plan(TIER_WIDTHS, v, rng, device=card)
    assert plan.mode_table.launches == 3 and not plan.mode_table.plain_classes
    labels = torch.from_numpy(_labels(kind, v, rng)).to(card)
    out = labels.clone()
    mode_cuda.launch(labels, out, plan.mode_table)
    torch.cuda.synchronize()
    assert torch.equal(out, _plain_rows(labels, plan))


@pytest.mark.card
@pytest.mark.parametrize("ways", [2, 3, 5])
def test_kernel_breaks_many_way_ties_toward_the_smallest_label(card, ways):
    """Each row holds ``ways`` labels equally often (its degree a multiple
    of them) plus padding: every row is a tie, won by its smallest label."""
    rng = np.random.default_rng(ways)
    v = 30_000
    alphabet = rng.choice(np.arange(-(1 << 30), 1 << 30, 7919), ways, replace=False)
    labels = torch.from_numpy(alphabet[np.arange(v) % ways].astype(np.int32)).to(card)

    def senders(n, w):
        base = rng.integers(0, v // ways, size=(n, w)) * ways
        return base + np.arange(w)[None, :] % ways

    widths = tuple(w for w in TIER_WIDTHS if w >= ways and w <= 34992)
    plan = _synthetic_plan(widths, v, rng, senders=senders, device=card, min_degree=ways)
    # whole cycles of the alphabet: trim each row's degree to a multiple
    send_idx = []
    for s in plan.send_idx:
        deg = (s != v).sum(dim=1, keepdim=True)
        keep = torch.arange(s.shape[1], device=card)[None, :] < deg - deg % ways
        send_idx.append(torch.where(keep, s, v).contiguous())
    plan = dataclasses.replace(plan, send_idx=tuple(send_idx))
    out = labels.clone()
    mode_cuda.launch(labels, out, plan.mode_table)
    torch.cuda.synchronize()
    want = _plain_rows(labels, plan)
    assert torch.equal(out, want)
    rows = torch.cat(plan.vertex_ids).long()
    assert bool((out[rows] == int(alphabet.min())).all())


@pytest.mark.card
def test_kernel_ignores_the_sentinel_by_value(card):
    """A real label equal to the sentinel is ignored like padding; a row
    holding nothing else yields the sentinel."""
    rng = np.random.default_rng(11)
    v = 20_000
    labels = np.where(rng.random(v) < 0.5, _SENTINEL, rng.integers(-5, 5, v)).astype(np.int32)
    only_sentinel = np.nonzero(labels == _SENTINEL)[0]

    def senders(n, w):
        mat = rng.integers(0, v, size=(n, w))
        mat[: n // 3] = rng.choice(only_sentinel, size=(n // 3, w))
        return mat

    plan = _synthetic_plan(TIER_WIDTHS[:-1], v, rng, senders=senders, device=card)
    labels = torch.from_numpy(labels).to(card)
    out = labels.clone()
    mode_cuda.launch(labels, out, plan.mode_table)
    torch.cuda.synchronize()
    assert torch.equal(out, _plain_rows(labels, plan))
    first = torch.cat([ids[: ids.shape[0] // 3] for ids in plan.vertex_ids]).long()
    assert bool((out[first] == _SENTINEL).all())


@pytest.mark.card
@pytest.mark.parametrize("distinct", [8000, 20_000])
def test_wide_rows_whose_hashes_collide_stay_exact(card, distinct):
    """Labels whose hashes all fall in the first pass's range overflow its
    table: the kernel redoes that range in halves and stays exact."""
    rng = np.random.default_rng(distinct)
    v = distinct + 10
    hashes = rng.choice(1 << 22, distinct, replace=False).astype(np.uint32)
    vals = _unfmix32(hashes)
    assert np.array_equal(_fmix32(vals.view(np.uint32)), hashes)
    labels = torch.from_numpy(np.concatenate([vals, np.zeros(10, np.int32)])).to(card)

    def senders(n, w):
        return rng.integers(0, distinct, size=(n, w))

    plan = _synthetic_plan((10368, 34992, mode_cuda.MAX_WIDTH), v, rng, senders=senders,
                           device=card)
    out = labels.clone()
    mode_cuda.launch(labels, out, plan.mode_table)
    torch.cuda.synchronize()
    assert torch.equal(out, _plain_rows(labels, plan))


def _graph_and_plan(kind: str, device):
    if kind == "kronecker":
        s, d = datasets.rmat(15, 16, seed=21)
    else:
        s, d, _, _ = datasets.planted_anomaly_graph(1 << 14, 600_000, seed=22)
    return build_graph_and_plan(s, d, device=device)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["kronecker", "planted"])
def test_label_propagation_on_the_kernel_equals_the_sort_superstep(card, kind):
    graph, plan = _graph_and_plan(kind, card)
    table = plan.mode_table
    assert table.launches >= 2 and not table.plain_classes
    before = _counts()
    got = lpa.label_propagation(graph, max_iter=10, plan=plan)
    torch.cuda.synchronize()
    after = _counts()
    # one launch a tier that has a class, each superstep; no plain rows
    assert after[0] - before[0] == 10 * table.launches
    assert after[1] - before[1] == 10 * table.kernel_rows
    assert after[2] == before[2]
    assert torch.equal(got, lpa.label_propagation(graph, max_iter=10, plan=None))


@pytest.mark.card
def test_arbitrary_initial_labels_equal_the_sort_superstep(card):
    """The serving plane's repair passes its own labels: any int32 without
    hubs (the histogram indexes by label)."""
    s, d, _, _ = datasets.planted_anomaly_graph(1 << 13, 200_000, seed=23)
    graph, plan = build_graph_and_plan(s, d, device=card)
    assert plan.hist_vertex_ids is None
    rng = np.random.default_rng(24)
    init = torch.from_numpy(
        rng.choice(np.array([INT32_MIN, -7, 0, 9, 1 << 30]), graph.num_vertices)
        .astype(np.int32)).to(card)
    got = lpa.label_propagation(graph, max_iter=4, init_labels=init, plan=plan)
    assert torch.equal(got, lpa.label_propagation(graph, max_iter=4, init_labels=init,
                                                  plan=None))


@pytest.mark.card
def test_a_class_past_the_limit_keeps_the_plain_mode_on_the_card(card):
    """Past the hub budget (2^26 / V hubs) a vertex wider than MAX_WIDTH
    lands in a class: the plain row sort takes it, counted, and the labels
    equal the sort superstep's."""
    rng = np.random.default_rng(31)
    v = 1 << 20
    hubs = 1 + (1 << 26) // v
    width = mode_cuda.MAX_WIDTH + 1  # its class (the ladder's next width) is past the limit
    degs = [width + 10_000] * (hubs - 1) + [width]
    src = np.concatenate([np.full(k, c, np.int64) for c, k in enumerate(degs)])
    dst = rng.integers(hubs, v, size=src.shape[0])
    graph, plan = build_graph_and_plan(src.astype(np.int32), dst.astype(np.int32),
                                       num_vertices=v, device=card)
    table = plan.mode_table
    assert len(table.plain_classes) == 1 and table.plain_rows == 1
    before = _counts()
    got = lpa.label_propagation(graph, max_iter=3, plan=plan)
    after = _counts()
    assert after[2] - before[2] == 3 and after[0] - before[0] == 3 * table.launches
    assert torch.equal(got, lpa.label_propagation(graph, max_iter=3, plan=None))
