"""The partition built on the mesh's devices
(``parallel/sharded.py::partition_graph_on_mesh``), the sharded bucketed
superstep's routing and its spans and counters.

On the CPU, on ``[cpu] * D`` virtual meshes (D = 1, 2, 4): the placed
partition equals ``shard_graph_arrays(partition_graph(...))`` array for
array (the message CSR slices, the degrees, the bucket plan, weighted or
not, ``lpa_only`` or not, the edges streamed in one chunk or many) on a
Kronecker draw and on a star whose hub passes the width ladder; the
sharded LPA on it equals ``ops.lpa.label_propagation``; the supersteps are
spanned and counted, and an exchange inside one device moves no byte
between devices. The ``card`` tests run the body on the row-mode kernel,
on a virtual mesh of one card and on 2 and 4 cards, bit-equal to one
card's LPA, with at most three launches a shard a superstep and plain
rows only for classes past ``MAX_WIDTH``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import profile

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.kernels import mode_cuda
from graphmine_tpu_torch.obs.registry import PROCESS
from graphmine_tpu_torch.obs.spans import OPS
from graphmine_tpu_torch.ops.lpa import label_propagation
from graphmine_tpu_torch.parallel import sharded
from graphmine_tpu_torch.parallel.mesh import make_mesh
from graphmine_tpu_torch.parallel.sharded import (
    partition_graph,
    partition_graph_on_mesh,
    shard_graph_arrays,
    sharded_label_propagation,
    sharded_lpa_fixpoint,
)
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FIELDS = ("msg_recv_local", "msg_send", "degrees", "msg_weight", "bucket_send", "bucket_target",
          "bucket_weight")


@pytest.fixture(autouse=True)
def virtual_devices(monkeypatch):
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")


def _graph(kind: str):
    """``(src, dst, V)``: a Kronecker draw at scale 11, or a star whose hub
    (vertex 5) has 2,600 neighbours, past the ladder's 2,048, beside a
    sparse random graph."""
    if kind == "kronecker":
        s, d = datasets.rmat(11, 16, seed=3)
    else:
        rng = np.random.default_rng(7)
        leaves = np.arange(6, 2606, dtype=np.int32)
        s = np.concatenate([np.full(2600, 5, np.int32), rng.integers(0, 3000, 4000)])
        d = np.concatenate([leaves, rng.integers(0, 3000, 4000)])
        s, d = s.astype(np.int32), d.astype(np.int32)
    return s, d, int(max(s.max(), d.max())) + 1


def _weights(n: int, weighted: bool):
    return np.random.default_rng(1).random(n).astype(np.float32) if weighted else None


def _assert_same(got, want, name: str) -> None:
    if got is None or want is None:
        assert got is None and want is None, name
        return
    assert len(got) == len(want), name
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, tuple):
            _assert_same(a, b, f"{name}[{i}]")
            continue
        assert a.device == b.device and a.dtype == b.dtype and a.shape == b.shape, (name, i)
        assert torch.equal(a, b), (name, i)


@pytest.mark.parametrize("chunk", [1 << 26, 1500])
@pytest.mark.parametrize("lpa_only", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["kronecker", "star"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_partition_on_mesh_equals_the_host_partition(monkeypatch, d, kind, weighted, lpa_only,
                                                     chunk):
    s, t, v = _graph(kind)
    w = _weights(len(s), weighted)
    mesh = make_mesh(d, devices=[CPU] * d)
    graph = build_graph(s, t, v, edge_weights=w, device=CPU)
    want = shard_graph_arrays(partition_graph(graph, mesh=mesh, build_bucket_plan=True), mesh,
                              lpa_only=lpa_only)
    monkeypatch.setattr(sharded, "PARTITION_CHUNK_EDGES", chunk)
    got = partition_graph_on_mesh(s, t, v, mesh, lpa_only=lpa_only, edge_weights=w)
    assert (got.num_vertices, got.chunk_size, got.num_shards) == (
        want.num_vertices, want.chunk_size, want.num_shards)
    assert got.mesh == mesh and got.mode_tables == ()
    for f in FIELDS:
        _assert_same(getattr(got, f), getattr(want, f), f)
    if kind == "star":
        assert max(b[0].shape[1] for b in got.bucket_send) > 2048


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["kronecker", "star"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_lpa_on_the_mesh_partition_equals_one_device(monkeypatch, d, kind, weighted):
    s, t, v = _graph(kind)
    w = _weights(len(s), weighted)
    mesh = make_mesh(d, devices=[CPU] * d)
    monkeypatch.setattr(sharded, "PARTITION_CHUNK_EDGES", 4096)
    sg = partition_graph_on_mesh(s, t, v, mesh, lpa_only=True, edge_weights=w)
    want = label_propagation(build_graph(s, t, v, edge_weights=w, device=CPU), max_iter=6)
    assert torch.equal(sharded_label_propagation(sg, mesh, max_iter=6), want)


def test_partition_on_mesh_takes_tensors_and_infers_the_vertex_count():
    s, t, v = _graph("kronecker")
    mesh = make_mesh(2, devices=[CPU] * 2)
    got = partition_graph_on_mesh(torch.from_numpy(s), torch.from_numpy(t), None, mesh)
    want = shard_graph_arrays(partition_graph(s, t, v, mesh=mesh, build_bucket_plan=True), mesh)
    assert got.num_vertices == v
    for f in FIELDS:
        _assert_same(getattr(got, f), getattr(want, f), f)


def test_partition_on_mesh_refuses_bad_input():
    s, t, v = _graph("kronecker")
    mesh = make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="out of range"):
        partition_graph_on_mesh(s, t, v - 1, mesh)
    with pytest.raises(ValueError, match="non-negative"):
        partition_graph_on_mesh(s, t, v, mesh, edge_weights=-np.ones(len(s), np.float32))
    with pytest.raises(ValueError, match="equal-length"):
        partition_graph_on_mesh(s, t[:-1], v, mesh)


def _span_counts() -> dict:
    return {name: tot["count"] for name, tot in OPS.totals().items()}


def test_sharded_supersteps_are_spanned_and_counted():
    s, t, v = _graph("kronecker")
    mesh = make_mesh(4, devices=[CPU] * 4)
    sg = partition_graph_on_mesh(s, t, v, mesh, lpa_only=True)
    steps = "graphmine_sharded_lpa_supersteps_total"
    moved = "graphmine_mesh_all_gather_bytes_total"
    before, spans = PROCESS.values(), _span_counts()
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sharded_label_propagation(sg, mesh, max_iter=3)
        _, iterations, _ = sharded_lpa_fixpoint(sg, mesh, max_iter=4)
        partition_graph_on_mesh(s, t, v, mesh, lpa_only=True)
    after, now = PROCESS.values(), _span_counts()
    assert after[steps] - before[steps] == 3 + iterations
    assert now["lpa.sharded_superstep"] - spans.get("lpa.sharded_superstep", 0) == 3 + iterations
    assert now["mesh.all_gather"] - spans.get("mesh.all_gather", 0) == 3 + iterations
    assert now["mesh.partition"] - spans.get("mesh.partition", 0) == 1
    # a virtual mesh's exchange stays inside one device
    assert after[moved] == before[moved]


def test_plan_table_checks_every_target_against_the_output():
    rows = torch.tensor([0, 3, 9], dtype=torch.int32)
    send = torch.zeros((3, 4), dtype=torch.int32)
    assert mode_cuda.plan_table((send,), (rows,), 10).out_rows == 10
    for out_rows, bad in ((9, rows), (10, torch.tensor([0, -1, 2], dtype=torch.int32))):
        with pytest.raises(ValueError, match="outside"):
            mode_cuda.plan_table((send,), (bad,), out_rows)


# ---- the card -----------------------------------------------------------------


@pytest.fixture
def card():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cards(n: int) -> list:
    have = torch.cuda.device_count()
    if have < n:
        pytest.skip(f"needs {n} CUDA cards; have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def _mesh_of(kind: str, card):
    """A virtual mesh of 4 shards on ``card``, or the first 2 or 4 cards."""
    if kind == "virtual4":
        return make_mesh(4, devices=[card] * 4)
    return make_mesh(int(kind[-1]), devices=_cards(int(kind[-1])))


def _counts() -> tuple:
    return (mode_cuda.LAUNCHES.value, mode_cuda.KERNEL_ROWS.value, mode_cuda.PLAIN_ROWS.value)


def _star_and_kronecker(scale: int, hub: int):
    """A Kronecker draw at ``scale`` with a star of ``hub`` leaves on its
    vertex 1 (past ``MAX_WIDTH`` where ``hub`` is)."""
    s, d = datasets.rmat(scale, 16, seed=20)
    v = 1 << scale
    leaves = np.arange(2, 2 + hub, dtype=np.int32) % v
    return (np.concatenate([s, np.ones(hub, np.int32)]).astype(np.int32),
            np.concatenate([d, leaves]).astype(np.int32), v)


@pytest.mark.card
@pytest.mark.parametrize("hub", [0, mode_cuda.MAX_WIDTH + 5000])
@pytest.mark.parametrize("kind", ["virtual4", "cards2", "cards4"])
def test_sharded_lpa_on_the_kernel_equals_one_card(card, kind, hub):
    s, t, v = _star_and_kronecker(20, hub)
    mesh = _mesh_of(kind, card)
    sg = partition_graph_on_mesh(s, t, v, mesh, lpa_only=True)
    assert len(sg.mode_tables) == mesh.size
    want = label_propagation(build_graph(s, t, v, device=card), max_iter=10)
    before = _counts()
    got = sharded_label_propagation(sg, mesh, max_iter=10)
    torch.cuda.synchronize()
    after = _counts()
    assert torch.equal(got, want)
    wide = [c for c, b in enumerate(sg.bucket_send) if b[0].shape[1] > mode_cuda.MAX_WIDTH]
    assert bool(wide) == bool(hub)
    plain = sum(int(sg.bucket_target[c][sh].shape[0]) for c in wide for sh in range(mesh.size))
    launches = sum(tab.launches for tab in sg.mode_tables)
    assert all(1 <= tab.launches <= 3 for tab in sg.mode_tables)
    assert after[0] - before[0] == 10 * launches
    assert after[1] - before[1] == 10 * sum(tab.kernel_rows for tab in sg.mode_tables)
    assert after[2] - before[2] == 10 * plain


@pytest.mark.card
def test_the_four_card_exchange_is_counted(card):
    mesh = make_mesh(4, devices=_cards(4))
    s, t, v = _star_and_kronecker(14, 0)
    sg = partition_graph_on_mesh(s, t, v, mesh, lpa_only=True)
    moved = "graphmine_mesh_all_gather_bytes_total"
    before = PROCESS.values()[moved]
    sharded_label_propagation(sg, mesh, max_iter=2)
    assert PROCESS.values()[moved] - before == 2 * 12 * 4 * sg.chunk_size


@pytest.mark.card
def test_launch_refuses_an_output_too_short_or_on_another_card(card):
    s, t, v = _star_and_kronecker(12, 0)
    sg = partition_graph_on_mesh(s, t, v, make_mesh(1, devices=[card]), lpa_only=True)
    table = sg.mode_tables[0]
    labels = torch.arange(sg.padded_vertices, dtype=torch.int32, device=card)
    before = _counts()
    with pytest.raises(ValueError, match="rows"):
        mode_cuda.launch(labels, torch.zeros(table.out_rows - 1, dtype=torch.int32,
                                             device=card), table)
    if torch.cuda.device_count() > 1:
        other = torch.zeros(table.out_rows, dtype=torch.int32, device="cuda:1")
        with pytest.raises(ValueError, match="device"):
            mode_cuda.launch(labels, other, table)
    assert _counts() == before


@pytest.mark.card
def test_the_pipelines_replicated_schedule_partitions_on_the_cards(card, tmp_path, monkeypatch):
    from graphmine_tpu_torch.pipeline.config import PipelineConfig
    from graphmine_tpu_torch.pipeline.driver import run_pipeline

    src, dst, _, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=9)
    path = tmp_path / "edges.txt"
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")
    base = dict(data_path=str(path), data_format="edgelist", max_iter=5, outlier_method="none")
    calls = []
    built = sharded.partition_graph_on_mesh
    monkeypatch.setattr(sharded, "partition_graph_on_mesh",
                        lambda *a, **k: calls.append(a[3]) or built(*a, **k))
    meshed = run_pipeline(PipelineConfig(**base, num_devices=4, schedule="replicated"))
    assert len(calls) == 1 and all(d.type == "cuda" for d in calls[0].devices)
    single = run_pipeline(PipelineConfig(**base, num_devices=1))
    assert np.array_equal(meshed.labels, single.labels)
