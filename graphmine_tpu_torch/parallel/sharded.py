"""Sharded graph container + distributed LPA / CC / PageRank supersteps.

Counterpart of ``graphmine_tpu/parallel/sharded.py``: **1-D vertex-range
sharding**. Shard ``d`` owns the vertex chunk ``[d*Vc, (d+1)*Vc)`` and every
message received by those vertices; the message CSR is sorted by receiver,
so each shard's messages are a contiguous slice, padded to the largest
shard's count. One superstep of the replicated schedule is:

    gather from the shard's copy of the full label vector
      -> shard-local segment mode / segment min over its owned vertices
      -> all-gather of the updated chunks onto every shard

(:func:`~graphmine_tpu_torch.parallel.mesh.all_gather`). Each shard body
runs on its own device: one after the other in this process on an
in-process mesh, each process its own shard on a process mesh
(:func:`~graphmine_tpu_torch.parallel.mesh.initialize_distributed`). The
answers are those of the single-device supersteps, bit for bit for
labels, and on a process mesh they come back whole on every process.

:func:`partition_graph` is host NumPy, array for array the JAX package's
(the message CSR slices, the degrees and the stacked degree-bucket plan of
the fast LPA body), so both packages partition a graph identically;
:func:`shard_graph_arrays` places it on a mesh, one tensor per shard on
that shard's device. The JAX package's blocked and 2-D partitions
(``build_blocked_plan``, ``build_plan2d``) are array for array the JAX
package's too: the blocked one makes each shard's chunk a bin group of
destination tiles (the same one all-gather a superstep); the 2-D one
keeps the labels sharded, and each superstep ships to every peer only the
label slots its bins read, one :func:`~graphmine_tpu_torch.parallel.mesh.ppermute`
a peer distance, in place of the all-gather.

The in-loop divergence tripwires and the superstep telemetry keep the JAX
package's kinds, attribution and counters. Their guards run on the device
at the armed cadence and keep the first firing there; the result is read
once, when the run has finished, and a firing raises
:class:`~graphmine_tpu_torch.pipeline.resilience.DivergenceError`. The CC
and PageRank loops read one scalar a superstep (their stopping test); the
LPA loop reads nothing until it returns. Every value that decides a branch
(the stopping test, the tripwire state, the telemetry rows) is built from
every shard's value gathered in shard order, so on a process mesh every
process takes the same branch: one that stopped or raised alone would
leave the others waiting in their next collective.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import SegmentSums, segment_min, segment_mode
from graphmine_tpu_torch.parallel.mesh import (
    Mesh,
    agree,
    all_gather,
    gather_to,
    place,
    ppermute,
    stack,
)

_SENTINEL = (1 << 31) - 1

# ---- in-loop divergence tripwires ------------------------------------------

_TRIP_KINDS = (
    "none", "label_out_of_range", "oscillation", "nonfinite_ranks",
    "cc_nonmonotone",
)


class _Trip:
    """The first tripwire firing of one armed run, kept on the device as
    ``[kind, shard, iteration]`` (kind 0 = none); read once by
    :meth:`raise_if_tripped`."""

    def __init__(self, device):
        self.state = torch.zeros(3, dtype=torch.int64, device=device)

    def fire(self, kind: torch.Tensor, shard: torch.Tensor, iteration: int) -> None:
        """Record ``(kind, shard, iteration)`` when ``kind > 0`` and
        nothing fired before."""
        cand = torch.stack([kind.to(torch.int64), shard.to(torch.int64),
                            torch.full_like(shard, iteration, dtype=torch.int64)])
        take = (self.state[0] == 0) & (cand[0] > 0)
        self.state = torch.where(take, cand, self.state)

    def raise_if_tripped(self) -> None:
        from graphmine_tpu_torch.pipeline.resilience import DivergenceError

        code, shard, it = (int(x) for x in self.state.tolist())
        if code:
            raise DivergenceError(_TRIP_KINDS[code], shard, it)


def _per_shard(mesh: Mesh, fn, *lists) -> torch.Tensor:
    """``fn`` of each shard's entries of ``lists``, every shard's result
    stacked in shard order on the mesh's home device (one gather on a
    process mesh)."""
    return stack(mesh, mesh.each(lambda s: fn(*(lst[s] for lst in lists))))


def _first_shard(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first shard whose flag is set (0 when none is), the
    shard that ``argmax`` over the padded vector names."""
    return torch.argmax(flags.to(torch.int32))


def _out_of_range(n, v_pad: int) -> torch.Tensor:
    return ((n < 0) | (n >= v_pad)).any()


def _label_tripwire(trip: _Trip, mesh: Mesh, new, cur, prev, it: int, v_pad: int) -> None:
    """LPA guards over per-shard chunks: labels outside ``[0, v_pad)``,
    and period-2 oscillation (state t+1 == state t-1 while != state t)."""
    rows = _per_shard(mesh, lambda n, c, p: torch.stack(
        [_out_of_range(n, v_pad), (n == p).all(), (n != c).any()]), new, cur, prev)
    bad = rows[:, 0]
    osc = rows[:, 1].all() & rows[:, 2].any()
    kind = torch.where(bad.any(), 1, torch.where(osc, 2, 0))
    trip.fire(kind, _first_shard(bad), it + 1)


def _cc_tripwire(trip: _Trip, mesh: Mesh, new, cur, it: int, v_pad: int) -> None:
    """CC guards: label range, then monotonicity (min-propagation labels
    never rise); the shard is attributed by the reported kind."""
    rows = _per_shard(mesh, lambda n, c: torch.stack(
        [_out_of_range(n, v_pad), (n > c).any()]), new, cur)
    bad, mono = rows[:, 0], rows[:, 1]
    any_bad = bad.any()
    kind = torch.where(any_bad, 1, torch.where(mono.any(), 4, 0))
    trip.fire(kind, _first_shard(torch.where(any_bad, bad, mono)), it + 1)


def _lpa_range_tripwire(trip: _Trip, mesh: Mesh, new, cur, it: int, v_pad: int) -> None:
    """Range-only LPA guard of the fixpoint runner (no previous iterate
    to test oscillation against)."""
    bad = _per_shard(mesh, lambda n: _out_of_range(n, v_pad), new)
    trip.fire(torch.where(bad.any(), 1, 0), _first_shard(bad), it + 1)


def _rank_tripwire(trip: _Trip, mesh: Mesh, new, it: int) -> None:
    """PageRank guard: NaN or Inf anywhere in the ranks."""
    bad = _per_shard(mesh, lambda n: (~torch.isfinite(n)).any(), new)
    trip.fire(torch.where(bad.any(), 3, 0), _first_shard(bad), it + 1)


# ---- superstep telemetry -----------------------------------------------------


@dataclass(frozen=True)
class SuperstepTelemetry:
    """Per-superstep counters of a sharded LPA/CC run: ``labels_changed[t]``
    (the frontier), ``shard_changed[t, d]`` split by owning shard, and the
    ``iterations`` run."""

    labels_changed: np.ndarray      # [T] int32
    shard_changed: np.ndarray       # [T, D] int32
    iterations: int

    @property
    def frontier(self) -> np.ndarray:
        return self.labels_changed

    def imbalance_ratio(self) -> np.ndarray:
        """Per-superstep max-shard / mean-shard activity (1.0 when
        quiescent)."""
        mean = self.shard_changed.mean(axis=1)
        peak = self.shard_changed.max(axis=1, initial=0)
        return np.where(mean > 0, peak / np.maximum(mean, 1e-9), 1.0)


@dataclass(frozen=True)
class PowerIterTelemetry:
    """Per-iteration residuals of a sharded PageRank run: the global L1
    delta and its per-shard split over the ``iterations`` run."""

    residuals: np.ndarray           # [T] float32
    shard_residuals: np.ndarray     # [T, D] float32
    iterations: int


def _telemetry_row(mesh: Mesh, new, cur):
    """One superstep's counters: (changed total, per-shard changed), on
    the mesh's home device. Padding vertices never change."""
    per = _per_shard(mesh, lambda n, c: (n != c).sum(dtype=torch.int32), new, cur)
    return per.sum(dtype=torch.int32), per


def _residual_row(mesh: Mesh, new, pr):
    """One power iteration's residuals: (L1 delta, per-shard L1)."""
    per = _per_shard(mesh, lambda n, p: (n - p).abs().sum(), new, pr)
    return per.sum(), per


# ---- the container -------------------------------------------------------------


@dataclass(frozen=True)
class ShardedGraph:
    """Vertex-range-sharded message CSR with static shapes.

    As :func:`partition_graph` returns it, each array field is a stacked
    host NumPy array with the shard on axis 0; :func:`shard_graph_arrays`
    turns each into a tuple of one tensor per shard on that shard's device
    and records the ``mesh``. Fields (D shards, Vc padded vertices per
    shard, Mp padded messages per shard):

    msg_recv_local : int32 [D, Mp]  receiver minus chunk start; padding = Vc
    msg_send       : int32 [D, Mp]  global sender id; padding = 0
    degrees        : int32 [D, Vc]  messages per owned vertex (0 = keep)
    msg_weight     : float32 [D, Mp] per-message weights, padding 0, or None
    bucket_send    : per width class c, int32 [D, n_c, w_c] global sender
                     ids (padding = D*Vc, the label sentinel slot)
    bucket_target  : per class, int32 [D, n_c] local owned-vertex rows
                     (padding rows = Vc + j, scratch past the chunk)
    bucket_weight  : per class, float32 [D, n_c, w_c] (weighted plans)
    blk_src        : int32 [D, Mp] the shard's senders in sender-major order
                     (padding = D*Vc, the label sentinel slot), or None
    blk_pos        : int32 [D, Mp] each streamed message's slot in the
                     shard's tile (padding: scratch slots past the bins)
    blk_row_idx    : per class, int32 [D, n_c, w_c] tile slots (padding =
                     the reserved slot ``blk_tile_alloc - 1``)
    blk_row_target : per class, int32 [D, n_c] local owned-vertex rows
                     (padding rows = Vc + j)
    blk_row_weight : per class, float32 [D, n_c, w_c] (weighted plans)
    x2d_send_tab   : int32 [D, D-1, B] local ids of the own chunk shipped
                     at peer distance r (row r-1); padding 0
    x2d_src_local  : int32 [D, Mp] the blocked stream remapped onto the
                     compact table ``[own (Vc) | peer buffers (D-1)*B |
                     sentinel]``; padding points at the sentinel
    x2d_boundary   : B, the shared padded per-peer width;
    x2d_boundary_total: the unpadded boundary slots over every (shard,
                     peer) pair (a 2-D partition drops ``blk_src``)
    """

    msg_recv_local: object
    msg_send: object
    degrees: object
    num_vertices: int
    chunk_size: int
    num_shards: int
    bucket_send: tuple = ()
    bucket_target: tuple = ()
    msg_weight: object = None
    bucket_weight: tuple = ()
    blk_src: object = None
    blk_pos: object = None
    blk_row_idx: tuple = ()
    blk_row_target: tuple = ()
    blk_row_weight: tuple = ()
    blk_tile_alloc: int = 0
    x2d_send_tab: object = None
    x2d_src_local: object = None
    x2d_boundary: int = 0
    x2d_boundary_total: int = 0
    mesh: Mesh | None = None

    @property
    def padded_vertices(self) -> int:
        return self.chunk_size * self.num_shards


def _host_graph_arrays(g: Graph):
    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    return host(g.msg_recv), host(g.msg_send), host(g.msg_weight), host(g.msg_ptr)


def partition_graph(graph_or_src, dst=None, num_vertices: int | None = None,
                    num_shards: int | None = None, mesh: Mesh | None = None,
                    pad_multiple: int = 8, build_bucket_plan: bool = False,
                    build_blocked_plan: bool = False, blocked_tile_slots: int | None = None,
                    build_plan2d: bool = False) -> ShardedGraph:
    """Partition a graph's message CSR into vertex-range shards (host
    NumPy). Takes a :class:`Graph` on any device, or raw ``(src, dst)``
    host arrays (built into a host graph first). The shard count comes
    from ``num_shards`` or ``mesh``. ``build_bucket_plan`` adds the stacked
    degree-bucket plan of the fast LPA shard body. ``build_blocked_plan``
    adds the stacked blocking plan instead (each shard's chunk a bin group
    of destination tiles, read by the blocked LPA and CC bodies;
    ``blocked_tile_slots`` overrides the bin budget), and
    ``build_plan2d`` extends it with the per-peer boundary tables of the
    ``sharded_2d`` family, remapping the stream onto the compact table
    and dropping ``blk_src``. One plan family per partition."""
    if build_bucket_plan and (build_blocked_plan or build_plan2d):
        raise ValueError(
            "build_bucket_plan and build_blocked_plan/build_plan2d are "
            "mutually exclusive — one plan family per partition"
        )
    if mesh is not None and num_shards is None:
        num_shards = mesh.size
    if num_shards is None:
        raise ValueError("pass num_shards or mesh")
    if not isinstance(graph_or_src, Graph):
        from graphmine_tpu_torch.graph.container import build_graph

        graph_or_src = build_graph(graph_or_src, dst, num_vertices=num_vertices, device="cpu")
    g = graph_or_src
    recv, send, w_msg, ptr = _host_graph_arrays(g)
    num_vertices = g.num_vertices

    d = num_shards
    vc = -(-num_vertices // d)
    vc = -(-vc // pad_multiple) * pad_multiple
    # recv is CSR-sorted: shard boundaries are d binary searches
    offsets = np.zeros(d + 1, dtype=np.int64)
    offsets[1:-1] = np.searchsorted(recv, np.arange(1, d) * vc)
    offsets[-1] = len(recv)
    counts = np.diff(offsets)
    mp = max(int(counts.max(initial=0)), 1)
    mp = -(-mp // pad_multiple) * pad_multiple
    int32_max = (1 << 31) - 1
    if mp > int32_max:
        worst = int(np.argmax(counts))
        raise ValueError(
            f"per-shard message count {mp:,} (shard {worst} holds "
            f"{int(counts[worst]):,} of {len(recv):,} messages) exceeds the "
            f"int32 gather-index bound {int32_max:,}; add devices so every "
            f"receiver-range shard's messages fit int32"
        )

    recv_local = np.empty((d, mp), dtype=np.int32)
    send_pad = np.empty((d, mp), dtype=np.int32)
    w_pad = None if w_msg is None else np.zeros((d, mp), dtype=np.float32)
    for s in range(d):
        lo, hi = offsets[s], offsets[s + 1]
        n = hi - lo
        np.subtract(recv[lo:hi], s * vc, out=recv_local[s, :n], casting="unsafe")
        recv_local[s, n:] = vc  # Vc = drop sentinel
        send_pad[s, :n] = send[lo:hi]
        send_pad[s, n:] = 0
        if w_pad is not None:
            w_pad[s, :n] = w_msg[lo:hi]

    deg = np.zeros(d * vc, dtype=np.int32)
    deg[:num_vertices] = np.diff(np.asarray(ptr, dtype=np.int64)).astype(np.int32)
    deg = deg.reshape(d, vc)

    bucket_send, bucket_target, bucket_weight = (), (), ()
    if build_bucket_plan:
        bucket_send, bucket_target, bucket_weight = _build_shard_bucket_plan(
            deg, send_pad, counts, vc, d, w_pad)
    blk = {}
    if build_blocked_plan or build_plan2d:
        blk = _build_shard_blocked_plan(deg, send_pad, vc, d, w_pad, blocked_tile_slots)
    if build_plan2d:
        blk.update(_build_shard_plan2d(blk.pop("blk_src"), vc, d, pad_multiple))
    return ShardedGraph(
        msg_recv_local=recv_local, msg_send=send_pad, degrees=deg,
        num_vertices=num_vertices, chunk_size=vc, num_shards=d,
        bucket_send=bucket_send, bucket_target=bucket_target,
        msg_weight=w_pad, bucket_weight=bucket_weight, **blk,
    )


def _build_shard_bucket_plan(deg, send_pad, counts, chunk_size, d, w_pad=None):
    """Stacked per-shard degree-bucket plan with uniform shapes: every
    shard's owned vertices bucketed on the shared width ladder, each
    class's row count padded to the largest shard's. No histogram path:
    mega-hubs ride wide sort rows (the JAX package's sharded plan, array
    for array)."""
    from graphmine_tpu_torch.ops.bucketed_mode import _extend_widths

    sentinel_send = chunk_size * d
    widths = _extend_widths(int(deg.max(initial=1)))
    classes = np.searchsorted(widths, np.maximum(deg, 1))
    ptr = np.zeros((d, chunk_size), dtype=np.int64)
    np.cumsum(deg[:, :-1], axis=1, out=ptr[:, 1:])

    eligible = deg > 0
    n_classes = len(widths)
    # one stable argsort per shard groups owned vertices by class, rows
    # ascending within a class; deg == 0 sorts to a trailing pseudo-class
    sort_key = np.where(eligible, classes, n_classes).astype(np.int64)
    order = np.argsort(sort_key, axis=1, kind="stable")
    flat = np.arange(d, dtype=np.int64)[:, None] * (n_classes + 1) + sort_key
    cnt = np.bincount(flat.ravel(), minlength=d * (n_classes + 1)).reshape(d, n_classes + 1)
    start = np.zeros_like(cnt)
    np.cumsum(cnt[:, :-1], axis=1, out=start[:, 1:])
    max_idx = np.maximum(counts.astype(np.int64) - 1, 0)[:, None, None]

    bucket_send, bucket_target, bucket_weight = [], [], []
    for c in np.unique(classes[eligible]):
        w = int(widths[c])
        n_s = cnt[:, c]
        n_c = int(n_s.max())
        j = np.arange(n_c, dtype=np.int64)[None, :]
        row_valid = j < n_s[:, None]
        pos = np.minimum(start[:, c, None] + j, deg.shape[1] - 1)
        rows = np.take_along_axis(order, pos, 1)
        ptr_r = np.take_along_axis(ptr, rows, 1)
        deg_r = np.where(row_valid, np.take_along_axis(deg, rows, 1), 0)
        offs = np.arange(w, dtype=np.int64)[None, None, :]
        idx = ptr_r[..., None] + offs
        valid = offs < deg_r[..., None]
        flat_idx = np.minimum(idx, max_idx).reshape(d, -1)
        gathered = np.take_along_axis(send_pad, flat_idx, 1).reshape(d, n_c, w)
        bucket_send.append(np.where(valid, gathered, sentinel_send).astype(np.int32))
        # padding rows scatter into distinct scratch slots past the chunk
        bucket_target.append(np.where(row_valid, rows, chunk_size + j).astype(np.int32))
        if w_pad is not None:
            wg = np.take_along_axis(w_pad, flat_idx, 1).reshape(d, n_c, w)
            bucket_weight.append(np.where(valid, wg, 0.0).astype(np.float32))
    return tuple(bucket_send), tuple(bucket_target), tuple(bucket_weight)


def _build_shard_blocked_plan(deg, send_pad, chunk_size, d, w_pad=None, tile_slots=None):
    """Stacked per-shard blocking plan with uniform shapes: each shard's
    local message CSR split into destination bins by
    :func:`~graphmine_tpu_torch.ops.blocking._blocked_layout` (on the
    host), on one shared width ladder and one tile width (the largest over
    the shards). Padding messages stream the sentinel sender into scratch
    slots past the bins; padding rows target ``chunk_size + j``."""
    from graphmine_tpu_torch.ops.blocking import (
        DEFAULT_TILE_SLOTS,
        _bin_bounds,
        _blocked_layout,
    )
    from graphmine_tpu_torch.ops.bucketed_mode import _extend_widths

    if tile_slots is None:
        tile_slots = int(os.environ.get("GRAPHMINE_BLOCKED_TILE_SLOTS", DEFAULT_TILE_SLOTS))
    sentinel_send = chunk_size * d
    mp = send_pad.shape[1]
    widths = _extend_widths(int(deg.max(initial=1)))

    ptrs, tb = [], 8
    for s in range(d):
        ptr_s = np.zeros(chunk_size + 1, dtype=np.int64)
        np.cumsum(deg[s], out=ptr_s[1:])
        ptrs.append(ptr_s)
        bounds = _bin_bounds(ptr_s, tile_slots)
        sizes = ptr_s[bounds[1:]] - ptr_s[bounds[:-1]]
        tb = max(tb, -(-int(sizes.max(initial=1)) // 8) * 8)

    layouts, n_bins_max = [], 1
    for s in range(d):
        weights = None if w_pad is None else torch.from_numpy(w_pad[s])
        layout = _blocked_layout(ptrs[s], torch.from_numpy(send_pad[s]), tile_slots,
                                 weights=weights, widths=widths, tile_width=tb)
        layouts.append(layout)
        n_bins_max = max(n_bins_max, len(layout[2]) - 1)

    tile_total = n_bins_max * tb
    tile_alloc = tile_total + mp + 1
    sentinel_slot = tile_alloc - 1
    blk_src = np.full((d, mp), sentinel_send, dtype=np.int32)
    blk_pos = np.empty((d, mp), dtype=np.int32)
    class_rows: dict = {}
    for s, (src_sorted, scatter_pos, _bounds, _tb, rows) in enumerate(layouts):
        n = len(src_sorted)
        blk_src[s, :n] = src_sorted.numpy()
        blk_pos[s, :n] = scatter_pos.numpy()
        # padding messages: distinct scratch slots past the bins
        blk_pos[s, n:] = tile_total + np.arange(n, mp, dtype=np.int64)
        for c, vr, idx, wmat in rows:
            class_rows.setdefault(c, [None] * d)[s] = (
                vr, idx.numpy(), None if wmat is None else wmat.numpy())

    blk_row_idx, blk_row_target, blk_row_weight = [], [], []
    for c in sorted(class_rows):
        w = int(widths[c])
        per_shard = class_rows[c]
        n_c = max((p[0].shape[0] for p in per_shard if p is not None), default=0)
        idx_c = np.full((d, n_c, w), sentinel_slot, dtype=np.int32)
        tgt_c = np.empty((d, n_c), dtype=np.int32)
        tgt_c[:] = chunk_size + np.arange(n_c, dtype=np.int64)[None, :]
        wgt_c = None if w_pad is None else np.zeros((d, n_c, w), dtype=np.float32)
        for s, payload in enumerate(per_shard):
            if payload is None:
                continue
            vr, idx, wmat = payload
            n = len(vr)
            idx_c[s, :n] = np.where(idx < 0, sentinel_slot, idx)
            tgt_c[s, :n] = vr
            if wgt_c is not None:
                wgt_c[s, :n] = wmat
        blk_row_idx.append(idx_c)
        blk_row_target.append(tgt_c)
        if wgt_c is not None:
            blk_row_weight.append(wgt_c)
    return dict(blk_src=blk_src, blk_pos=blk_pos, blk_row_idx=tuple(blk_row_idx),
                blk_row_target=tuple(blk_row_target), blk_row_weight=tuple(blk_row_weight),
                blk_tile_alloc=tile_alloc)


def _build_shard_plan2d(blk_src, chunk_size, d, pad_multiple=8):
    """The source axis of the blocked bin groups: per-peer boundary tables
    and the stream's remap onto the compact table.

    For shard ``s`` and peer distance ``r`` (1..D-1), ``need(s, r)`` is
    the sorted unique local ids of the senders that ``s``'s bins read from
    the owner ``(s - r) % D``. Every set pads to one width ``B``;
    ``send_tab[s, r-1]`` holds what ``s`` ships at shift ``r``,
    ``need((s + r) % D, r)``, so the shift delivers it to the shard that
    reads it. The stream's global sender ids are remapped onto ``[own (Vc)
    | bufs (D-1)*B | sentinel]``; padding messages point at the
    sentinel. Every row of ``blk_src`` is ascending, as the blocked
    plan build makes it, so each owner's senders are one slice of the row,
    and the distinct ids and each entry's rank among them come from one
    pass over the run starts (no sort, no search per entry)."""
    mp = blk_src.shape[1]
    bounds_at = np.arange(d + 1, dtype=np.int64) * chunk_size
    need: list[list] = [[] for _ in range(d)]
    ranks, uniq_bounds, owner_bounds = [], [], []
    for s in range(d):
        g = blk_src[s]
        start = np.empty(mp, dtype=bool)
        start[:1] = True
        np.not_equal(g[1:], g[:-1], out=start[1:])
        ranks.append(np.cumsum(start, dtype=np.int64) - 1)
        uniq = g[start].astype(np.int64)                  # the sentinel included
        bound = np.searchsorted(uniq, bounds_at)
        uniq_bounds.append(bound)
        owner_bounds.append(np.searchsorted(g, bounds_at))
        for r in range(1, d):
            peer = (s - r) % d
            need[s].append(uniq[bound[peer]: bound[peer + 1]] - peer * chunk_size)
    b = max((len(ids) for row in need for ids in row), default=1)
    b = max(-(-max(b, 1) // pad_multiple) * pad_multiple, pad_multiple)
    send_tab = np.zeros((d, max(d - 1, 0), b), dtype=np.int32)
    for s in range(d):
        for r in range(1, d):
            ids = need[(s + r) % d][r - 1]
            send_tab[s, r - 1, : len(ids)] = ids
    sentinel_slot = chunk_size + (d - 1) * b
    src_local = np.full((d, mp), sentinel_slot, dtype=np.int32)  # padding stays here
    for s in range(d):
        for owner in range(d):
            lo, hi = owner_bounds[s][owner], owner_bounds[s][owner + 1]
            if owner == s:
                src_local[s, lo:hi] = blk_src[s, lo:hi] - s * chunk_size
            else:
                base = chunk_size + ((s - owner) % d - 1) * b - uniq_bounds[s][owner]
                src_local[s, lo:hi] = ranks[s][lo:hi] + base
    total = sum(len(ids) for row in need for ids in row)
    return dict(x2d_send_tab=send_tab, x2d_src_local=src_local, x2d_boundary=int(b),
                x2d_boundary_total=int(total))


def shard_graph_arrays(sg: ShardedGraph, mesh: Mesh, lpa_only: bool = False) -> ShardedGraph:
    """Place a partition on ``mesh``: shard ``s`` of every array on
    ``mesh.devices[s]``. ``lpa_only`` (with a bucket, blocked or 2-D plan)
    drops the sort-body arrays, which those LPA bodies never read; such a
    graph serves :func:`sharded_label_propagation` alone (and the blocked
    and 2-D CC bodies, which read only their plan)."""
    _check_mesh(sg, mesh)
    if sg.mesh is not None:
        raise ValueError(f"this partition is already placed on {sg.mesh}")
    if lpa_only and not sg.bucket_send and sg.blk_src is None and sg.x2d_src_local is None:
        raise ValueError(
            "lpa_only requires partition_graph(build_bucket_plan=True), "
            "partition_graph(build_blocked_plan=True) or "
            "partition_graph(build_plan2d=True)"
        )

    def put(a):
        return None if a is None else place(mesh, a)

    keep = (lambda a: None) if lpa_only else put
    return ShardedGraph(
        msg_recv_local=keep(sg.msg_recv_local), msg_send=keep(sg.msg_send),
        degrees=keep(sg.degrees), num_vertices=sg.num_vertices,
        chunk_size=sg.chunk_size, num_shards=sg.num_shards,
        bucket_send=tuple(put(b) for b in sg.bucket_send),
        bucket_target=tuple(put(t) for t in sg.bucket_target),
        msg_weight=keep(sg.msg_weight),
        bucket_weight=tuple(put(b) for b in sg.bucket_weight),
        blk_src=put(sg.blk_src), blk_pos=put(sg.blk_pos),
        blk_row_idx=tuple(put(b) for b in sg.blk_row_idx),
        blk_row_target=tuple(put(t) for t in sg.blk_row_target),
        blk_row_weight=tuple(put(w) for w in sg.blk_row_weight),
        blk_tile_alloc=sg.blk_tile_alloc,
        x2d_send_tab=put(sg.x2d_send_tab), x2d_src_local=put(sg.x2d_src_local),
        x2d_boundary=sg.x2d_boundary, x2d_boundary_total=sg.x2d_boundary_total,
        mesh=mesh,
    )


def _check_mesh(sg: ShardedGraph, mesh: Mesh) -> None:
    if mesh.size != sg.num_shards:
        raise ValueError(
            f"graph was partitioned into {sg.num_shards} shards but the mesh "
            f"has {mesh.size} devices; re-run partition_graph(mesh=mesh)"
        )


def _on_mesh(sg: ShardedGraph, mesh: Mesh) -> ShardedGraph:
    """``sg`` placed on ``mesh`` (a host partition is placed here)."""
    _check_mesh(sg, mesh)
    if not mesh.local:
        raise ValueError(f"this process holds no shard of {mesh!r}")
    if sg.mesh is None:
        return shard_graph_arrays(sg, mesh)
    if sg.mesh.devices != mesh.devices or sg.mesh.ranks != mesh.ranks:
        raise ValueError(f"graph is placed on {sg.mesh}, not on {mesh}")
    return sg


def _need(arr, what: str):
    if arr is None:
        raise ValueError(f"this partition has no {what} (placed with lpa_only=True); "
                         "place the host partition without lpa_only")
    return arr


# ---- shard bodies --------------------------------------------------------------


def _jax_index(n: int, idx: torch.Tensor) -> torch.Tensor:
    """Gather indices as JAX normalizes them: negatives wrap once, then
    everything clamps into ``[0, n)`` (labels used as indices may be
    corrupt; the tripwires report that, the gather must not fault)."""
    idx = idx.to(torch.int64)
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _own(full: torch.Tensor, s: int, vc: int) -> torch.Tensor:
    return full[s * vc:(s + 1) * vc]


def _lpa_shard_body(full, recv_local, send, deg, weight, s: int, vc: int):
    """One shard's sort-body LPA superstep: gather sender labels from the
    full vector, segment mode over the owned vertices, keep a vertex's
    label when it has no messages. Returns the shard's new chunk."""
    mode, _ = segment_mode(recv_local, full[send], vc, weights=weight)
    return torch.where(deg > 0, mode, _own(full, s, vc)).to(torch.int32)


def _lpa_shard_body_bucketed(full, bsend, btarget, bweight, s: int, vc: int):
    """One shard's bucketed LPA superstep: each width class's rows gather
    from the full vector padded with the sentinel label and take their row
    mode (weighted when the class carries weights); padding rows scatter
    into scratch slots past the chunk, which are cut off."""
    lbl_pad = torch.cat([full, full.new_full((1,), _SENTINEL)])
    return _rows_mode(lbl_pad, _own(full, s, vc), bsend, btarget, bweight, vc)


def _cc_shard_body(full, recv_local, send, deg, s: int, vc: int):
    """One shard's CC superstep before the exchange: the minimum of the
    own label and the incoming ones."""
    neigh_min = segment_min(full[send], recv_local, vc)
    own = _own(full, s, vc)
    return torch.where(deg > 0, torch.minimum(own, neigh_min), own).to(torch.int32)


def _blocked_shard_tile(values, blk_src, blk_pos, tile_alloc: int, fill) -> torch.Tensor:
    """One shard's bin pass: ``values`` (padded with ``fill`` at the
    sentinel slot) read in stream order and scattered into the shard's
    destination-binned tile; slots nobody writes keep ``fill``. The
    blocked family streams the full label vector by global sender id;
    the 2-D family its compact table ``[own | peer buffers]`` by the
    remapped ids, which gives the same tile value for value."""
    pad = torch.cat([values, values.new_full((1,), fill)])
    tile = values.new_full((tile_alloc,), fill)
    tile[blk_pos] = pad[blk_src]
    return tile


def _rows_mode(tile, own, row_idx, row_target, row_weight, vc: int) -> torch.Tensor:
    """The reduce pass of the LPA bodies: each width class's rows of
    ``tile`` slots (a blocked tile, or the bucketed body's padded label
    vector) take their (weighted) row mode into the owned chunk; padding
    rows write scratch past it, which is cut off."""
    from graphmine_tpu_torch.ops.bucketed_mode import _bucket_mode, _bucket_wmode

    n_max = max((t.shape[-1] for t in row_target), default=0)
    out = torch.cat([own, own.new_zeros((n_max,))])
    for c, (ridx, tgt) in enumerate(zip(row_idx, row_target)):
        mat = tile[ridx]
        out[tgt] = _bucket_mode(mat) if row_weight is None else _bucket_wmode(mat, row_weight[c])
    return out[:vc].to(torch.int32)


def _rows_min(tile, own, row_idx, row_target, vc: int) -> torch.Tensor:
    """The reduce pass of the CC bodies: each row's minimum against the
    owned label (the int32-max fill never wins); targets are distinct."""
    n_max = max((t.shape[-1] for t in row_target), default=0)
    out = torch.cat([own, own.new_zeros((n_max,))])
    for ridx, tgt in zip(row_idx, row_target):
        out[tgt] = torch.minimum(out[tgt], tile[ridx].min(dim=1).values)
    return out[:vc].to(torch.int32)


def _lpa_shard_body_blocked(full, blk_src, blk_pos, row_idx, row_target, row_weight,
                            s: int, vc: int, tile_alloc: int):
    """One shard's blocked LPA superstep: the bin pass into the shard's
    tile, then the row modes with tile-local indices. Returns the shard's
    new chunk (the exchange is the step's all-gather)."""
    tile = _blocked_shard_tile(full, blk_src, blk_pos, tile_alloc, _SENTINEL)
    return _rows_mode(tile, _own(full, s, vc), row_idx, row_target, row_weight, vc)


def _cc_shard_body_blocked(full, blk_src, blk_pos, row_idx, row_target, s: int, vc: int,
                           tile_alloc: int):
    """One shard's blocked CC superstep before the exchange: the row
    minima of its tile against the owned labels; the step's pointer jump
    runs on the gathered vector, as the sort body's does."""
    tile = _blocked_shard_tile(full, blk_src, blk_pos, tile_alloc, _SENTINEL)
    return _rows_min(tile, _own(full, s, vc), row_idx, row_target, vc)


def _check_2d_mesh(mesh: Mesh) -> None:
    """The 2-D family's exchange is a ring of shifts over one mesh axis:
    a multi-axis mesh is refused (the one-all-gather families take it)."""
    if len(tuple(mesh.axis_names)) != 1:
        raise ValueError(
            f"the sharded_2d family needs a 1-D mesh for its ppermute "
            f"neighbor exchange (got axes {tuple(mesh.axis_names)}); use "
            "the one-all_gather families on multi-slice meshes"
        )


def _exchange_2d(mesh: Mesh, own, send_tab) -> list:
    """The neighbour-only exchange: for each peer distance ``r``, one
    :func:`~graphmine_tpu_torch.parallel.mesh.ppermute` shift carrying
    each shard's padded boundary buffer (``send_tab[s][r-1]``, the label
    slots its peer's bins read). Returns, per shard, its D - 1 received
    buffers in distance order (the compact table's layout)."""
    d = mesh.size
    got = [ppermute(mesh, mesh.each(lambda i, r=r: own[i][send_tab[i][r - 1]]), r)
           for r in range(1, d)]
    return [[got[r][s] for r in range(d - 1)] for s in range(d)]


def _lpa_shard_body_2d(own, bufs, src_local, blk_pos, row_idx, row_target, row_weight,
                       vc: int, tile_alloc: int):
    """One shard's 2-D LPA superstep on its own chunk and its received
    buffers: the tile is the blocked family's, so the labels are too.
    Labels stay sharded: in and out is the shard's ``[Vc]`` chunk."""
    tile = _blocked_shard_tile(torch.cat([own, *bufs]), src_local, blk_pos, tile_alloc,
                               _SENTINEL)
    return _rows_mode(tile, own, row_idx, row_target, row_weight, vc)


def _cc_shard_body_2d(own, bufs, src_local, blk_pos, row_idx, row_target, s: int, vc: int,
                      tile_alloc: int):
    """One shard's 2-D CC superstep: the row minima, then a chunk-local
    pointer jump (a label in the shard's own range is followed; the full
    jump would need the O(V) exchange this family removes). Convergence
    may take more supersteps than the one-all-gather bodies, up to the
    diameter where a chain alternates shards; the fixpoint, the component
    minimum, is the same."""
    tile = _blocked_shard_tile(torch.cat([own, *bufs]), src_local, blk_pos, tile_alloc,
                               _SENTINEL)
    new = _rows_min(tile, own, row_idx, row_target, vc)
    loc = new.to(torch.int64) - s * vc
    in_chunk = (loc >= 0) & (loc < vc)
    jumped = new[torch.clamp(loc, 0, vc - 1)]
    return torch.minimum(new, torch.where(in_chunk, jumped, new))


def _pointer_jump(full: torch.Tensor) -> torch.Tensor:
    """``min(labels, labels[labels])`` on a full vector (no exchange)."""
    return torch.minimum(full, full[_jax_index(full.shape[0], full)])


# ---- loop drivers ------------------------------------------------------------


def _replicated_chunks(sg: ShardedGraph):
    """Per-shard chunks of a replicated state (one full vector per shard)."""
    vc = sg.chunk_size
    return lambda state: [None if f is None else _own(f, s, vc) for s, f in enumerate(state)]


def _scan_supersteps(step_fn, state, max_iter: int, chunks, mesh: Mesh,
                     tripwire_every: int = 0, v_pad: int = 0, collect: bool = False):
    """Exactly ``max_iter`` supersteps (LPA). ``chunks(state)`` gives the
    per-shard chunks the guards and counters read. Returns ``state`` or,
    with ``collect``, ``(state, (changed [T], shard_changed [T, D]))``;
    an armed tripwire raises after the loop."""
    dev = mesh.home
    trip = _Trip(dev) if tripwire_every else None
    rows = []
    prev = state
    for it in range(max_iter):
        new = step_fn(state)
        if trip is not None and (it + 1) % tripwire_every == 0:
            _label_tripwire(trip, mesh, chunks(new), chunks(state), chunks(prev), it, v_pad)
        if collect:
            rows.append(_telemetry_row(mesh, chunks(new), chunks(state)))
        prev, state = state, new
    if trip is not None:
        # unconditional exit check: the last supersteps may fall between
        # two armed ones
        last = chunks(state)
        _label_tripwire(trip, mesh, last, chunks(prev), chunks(prev), max_iter - 1, v_pad)
        trip.raise_if_tripped()
    if not collect:
        return state
    d = mesh.size
    changed = (torch.stack([r[0] for r in rows]) if rows
               else torch.zeros(0, dtype=torch.int32, device=dev))
    per = (torch.stack([r[1] for r in rows]) if rows
           else torch.zeros((0, d), dtype=torch.int32, device=dev))
    return state, (changed, per)


# Telemetry rows kept by an unbounded (max_iter=0) fixpoint run; a longer
# run overwrites the last row.
_FIXPOINT_TELEMETRY_CAP = 4096


def _fixpoint_supersteps(step_fn, state, sg: ShardedGraph, max_iter: int, chunks, mesh: Mesh,
                         tripwire_every: int = 0, collect: bool = False, guard=_cc_tripwire):
    """Supersteps until no label changes (CC semantics), bounded by
    ``max_iter`` when nonzero: one host read a superstep, the changed
    count. ``guard`` is the tripwire armed every ``tripwire_every``
    supersteps. With ``collect`` returns ``(state, (changed [cap],
    shard_changed [cap, D], iterations))``."""
    limit = max_iter if max_iter > 0 else sg.num_vertices + 2
    cap = min(limit, _FIXPOINT_TELEMETRY_CAP)
    v_pad = sg.padded_vertices
    dev = mesh.home
    trip = _Trip(dev) if tripwire_every else None
    if collect:
        buf_c = torch.zeros(cap, dtype=torch.int32, device=dev)
        buf_s = torch.zeros((cap, sg.num_shards), dtype=torch.int32, device=dev)
    changed, it = 1, 0
    while changed > 0 and it < limit:
        new = step_fn(state)
        if trip is not None and (it + 1) % tripwire_every == 0:
            guard(trip, mesh, chunks(new), chunks(state), it, v_pad)
        total, per = _telemetry_row(mesh, chunks(new), chunks(state))
        if collect:
            row = min(it, cap - 1)
            buf_c[row] = total
            buf_s[row] = per
        changed = int(total)
        state = new
        it += 1
    if trip is not None:
        last = chunks(state)
        guard(trip, mesh, last, last, it - 1, v_pad)
        trip.raise_if_tripped()
    if collect:
        return state, (buf_c, buf_s, it)
    return state


def _padded_init_labels(sg: ShardedGraph, device) -> torch.Tensor:
    return torch.arange(sg.padded_vertices, dtype=torch.int32, device=device)


def _pad_labels(labels, sg: ShardedGraph, device) -> torch.Tensor:
    """``labels`` [V] followed by the padding vertices' own ids."""
    lab = torch.as_tensor(np.asarray(labels) if not isinstance(labels, torch.Tensor)
                          else labels).to(device=device, dtype=torch.int32)
    pad = torch.arange(sg.num_vertices, sg.padded_vertices, dtype=torch.int32, device=device)
    return torch.cat([lab, pad])


def _init_full(sg, mesh, init_labels) -> list:
    """The initial state: one padded label vector per shard, or for a 2-D
    partition (labels sharded) each shard's own chunk."""
    home = mesh.home
    full = (_padded_init_labels(sg, home) if init_labels is None
            else _pad_labels(init_labels, sg, home))
    if _is_2d(sg):
        vc = sg.chunk_size
        return mesh.each(lambda s: _own(full, s, vc).to(mesh.devices[s], copy=True))
    return mesh.each(lambda s: full.to(mesh.devices[s], copy=True))


def _is_2d(sg: ShardedGraph) -> bool:
    return sg.x2d_src_local is not None


def _state_chunks(sg: ShardedGraph):
    """Per-shard chunks of a state: a 2-D state is its chunks already."""
    return list if _is_2d(sg) else _replicated_chunks(sg)


def _labels_of(sg: ShardedGraph, mesh: Mesh, state) -> torch.Tensor:
    """The ``[V]`` labels of a state, on the mesh's home device (on every
    process of a process mesh)."""
    full = gather_to(state, mesh.home, mesh) if _is_2d(sg) else state[mesh.local[0]]
    return full[: sg.num_vertices]


def _build_lpa_step(sg: ShardedGraph, mesh: Mesh):
    """The LPA superstep over the state of :func:`_init_full`: the 2-D body
    on a 2-D partition (its exchange inside the step), else the blocked,
    bucketed or sort body followed by one all-gather."""
    vc = sg.chunk_size
    if _is_2d(sg):
        _check_2d_mesh(mesh)
        wts = sg.blk_row_weight or None

        def step(own):
            bufs = _exchange_2d(mesh, own, sg.x2d_send_tab)
            return mesh.each(lambda s: _lpa_shard_body_2d(
                own[s], bufs[s], sg.x2d_src_local[s], sg.blk_pos[s],
                [r[s] for r in sg.blk_row_idx], [t[s] for t in sg.blk_row_target],
                None if wts is None else [w[s] for w in wts], vc, sg.blk_tile_alloc))

        return step
    if sg.blk_src is not None:
        wts = sg.blk_row_weight or None

        def step(full):
            return all_gather(mesh, mesh.each(lambda s: _lpa_shard_body_blocked(
                full[s], sg.blk_src[s], sg.blk_pos[s], [r[s] for r in sg.blk_row_idx],
                [t[s] for t in sg.blk_row_target],
                None if wts is None else [w[s] for w in wts], s, vc, sg.blk_tile_alloc)))

        return step
    if sg.bucket_send:
        weights = sg.bucket_weight or None

        def step(full):
            return all_gather(mesh, mesh.each(lambda s: _lpa_shard_body_bucketed(
                full[s], [b[s] for b in sg.bucket_send], [t[s] for t in sg.bucket_target],
                None if weights is None else [w[s] for w in weights], s, vc)))

        return step
    recv, send, deg = (_need(sg.msg_recv_local, "message CSR"), sg.msg_send, sg.degrees)
    w = sg.msg_weight

    def step(full):
        return all_gather(mesh, mesh.each(lambda s: _lpa_shard_body(
            full[s], recv[s], send[s], deg[s], None if w is None else w[s], s, vc)))

    return step


def sharded_label_propagation(sg: ShardedGraph, mesh: Mesh, max_iter: int = 5,
                              init_labels=None, tripwire_every: int = 0,
                              telemetry: bool = False):
    """Distributed synchronous LPA, semantics identical to
    :func:`graphmine_tpu_torch.ops.lpa.label_propagation`. Returns int32
    labels ``[V]`` on the mesh's home device (every process's own on a
    process mesh), or ``(labels,
    SuperstepTelemetry)`` with ``telemetry``. ``tripwire_every`` arms the
    label-range and oscillation guards every K supersteps; a firing raises
    ``DivergenceError`` with the offending shard."""
    sg = _on_mesh(sg, mesh)
    out = _scan_supersteps(
        _build_lpa_step(sg, mesh), _init_full(sg, mesh, init_labels), max_iter,
        _state_chunks(sg), mesh, tripwire_every=tripwire_every,
        v_pad=sg.padded_vertices, collect=telemetry)
    if not telemetry:
        return _labels_of(sg, mesh, out)
    state, (changed, per) = out
    return _labels_of(sg, mesh, state), SuperstepTelemetry(
        changed.cpu().numpy(), per.cpu().numpy(), int(max_iter))


def sharded_lpa_fixpoint(sg: ShardedGraph, mesh: Mesh, max_iter: int = 0, init_labels=None,
                         tripwire_every: int = 0):
    """Warm-start LPA to fixpoint: supersteps until no label changes,
    bounded by ``max_iter`` (0 = unbounded). Returns ``(labels[:V],
    iterations, converged)``; ``converged`` is False when the budget ran
    out first. ``tripwire_every`` arms the range-only guard."""
    sg = _on_mesh(sg, mesh)
    state, (changed, _per, it) = _fixpoint_supersteps(
        _build_lpa_step(sg, mesh), _init_full(sg, mesh, init_labels), sg, max_iter,
        _state_chunks(sg), mesh, tripwire_every=tripwire_every,
        collect=True, guard=_lpa_range_tripwire)
    row = min(it, changed.shape[0]) - 1
    converged = it == 0 or int(changed[row]) == 0
    return _labels_of(sg, mesh, state), it, converged


def _build_cc_step(sg: ShardedGraph, mesh: Mesh):
    """The CC superstep: the 2-D body (its exchange and a chunk-local
    pointer jump inside it), else the blocked or sort body, one
    all-gather and the pointer jump on every shard's full vector."""
    vc = sg.chunk_size
    if _is_2d(sg):
        _check_2d_mesh(mesh)

        def step(own):
            bufs = _exchange_2d(mesh, own, sg.x2d_send_tab)
            return mesh.each(lambda s: _cc_shard_body_2d(
                own[s], bufs[s], sg.x2d_src_local[s], sg.blk_pos[s],
                [r[s] for r in sg.blk_row_idx], [t[s] for t in sg.blk_row_target], s, vc,
                sg.blk_tile_alloc))

        return step
    if sg.blk_src is not None:
        def body(full, s):
            return _cc_shard_body_blocked(
                full[s], sg.blk_src[s], sg.blk_pos[s], [r[s] for r in sg.blk_row_idx],
                [t[s] for t in sg.blk_row_target], s, vc, sg.blk_tile_alloc)
    else:
        recv, send, deg = (_need(sg.msg_recv_local, "message CSR"), sg.msg_send, sg.degrees)

        def body(full, s):
            return _cc_shard_body(full[s], recv[s], send[s], deg[s], s, vc)

    def step(full):
        gathered = all_gather(mesh, mesh.each(lambda s: body(full, s)))
        # pointer jumping on each shard's full vector: no extra exchange
        return mesh.each(lambda s: _pointer_jump(gathered[s]))

    return step


def sharded_connected_components(sg: ShardedGraph, mesh: Mesh, max_iter: int = 0,
                                 tripwire_every: int = 0, init_labels=None,
                                 telemetry: bool = False):
    """Distributed weakly connected components (min-propagation and
    pointer jumping), equal to
    :func:`graphmine_tpu_torch.ops.cc.connected_components`.
    ``init_labels`` resumes a fixpoint mid-run; ``telemetry`` returns
    ``(labels, SuperstepTelemetry)``."""
    sg = _on_mesh(sg, mesh)
    out = _fixpoint_supersteps(
        _build_cc_step(sg, mesh), _init_full(sg, mesh, init_labels), sg, max_iter,
        _state_chunks(sg), mesh, tripwire_every=tripwire_every,
        collect=telemetry)
    if not telemetry:
        return _labels_of(sg, mesh, out)
    state, (changed, per, it) = out
    n = min(it, changed.shape[0])
    return _labels_of(sg, mesh, state), SuperstepTelemetry(
        changed.cpu().numpy()[:n], per.cpu().numpy()[:n], it)


# ---- PageRank -------------------------------------------------------------------


def _check_pagerank_weighted(sg: ShardedGraph, out_degrees, weighted):
    """Resolve ``weighted`` (None: the graph carries weights) and require
    float out-edge weight sums for a weighted run."""
    if weighted is None:
        weighted = sg.msg_weight is not None
    if weighted:
        if sg.msg_weight is None:
            raise ValueError("weighted=True but the graph has no msg_weight")
        dtype = out_degrees.dtype if isinstance(out_degrees, torch.Tensor) \
            else np.asarray(out_degrees).dtype
        floating = dtype.is_floating_point if isinstance(dtype, torch.dtype) \
            else np.issubdtype(dtype, np.floating)
        if not floating:
            raise ValueError(
                "weighted PageRank needs float out-edge weight sums "
                "(ops.degrees.out_weights), not integer out-degrees; pass "
                "weighted=False for unweighted ranks on this graph"
            )
    return bool(weighted)


def _pagerank_terms(out_degrees, v: int, v_pad: int, device):
    """Padded ``(inv_out, reset, dangling)``, each ``[v_pad]``, shared by the
    replicated and ring schedules."""
    od = out_degrees if isinstance(out_degrees, torch.Tensor) else \
        torch.from_numpy(np.asarray(out_degrees))
    out = torch.zeros(v_pad, dtype=torch.float32, device=device)
    out[:v] = od.to(device=device, dtype=torch.float32)
    live = torch.arange(v_pad, device=device) < v
    inv_out = torch.where(out > 0, 1.0 / torch.clamp(out, min=1e-30), 0.0)
    dangling = (out <= 0) & live
    reset = torch.where(live, torch.tensor(1.0 / v, dtype=torch.float32, device=device),
                        0.0).to(torch.float32)
    return inv_out, reset, dangling


def _pagerank_shard_body(pr_full, inv_out_full, reset_own, dangling_full, recv_local, send,
                         sums: SegmentSums, weight, vc: int, alpha: float):
    """One shard's power-iteration step: contributions gathered from the
    full rank vector, summed per owned vertex, plus the dangling mass
    spread by the reset vector. Returns the shard's new rank chunk."""
    contrib = pr_full * inv_out_full
    msg = contrib[send] * (recv_local < vc)
    if weight is not None:
        msg = msg * weight
    inflow = sums.sum(msg)
    dangling_mass = torch.where(dangling_full, pr_full, 0.0).sum()
    return alpha * (inflow + dangling_mass * reset_own) + (1.0 - alpha) * reset_own


def sharded_pagerank(sg: ShardedGraph, mesh: Mesh, out_degrees, alpha: float = 0.85,
                     max_iter: int = 100, tol: float = 1e-6, weighted: bool | None = None,
                     tripwire_every: int = 0, init_ranks=None, telemetry: bool = False):
    """Distributed PageRank over a partition of a **directed** graph.
    ``out_degrees`` are the directed out-degrees, or for a weighted run
    the float out-edge weight sums. Returns float32 ranks ``[V]`` summing
    to 1 (within rtol 1e-5 of
    :func:`graphmine_tpu_torch.ops.pagerank.pagerank`), or ``(ranks,
    PowerIterTelemetry)``. ``tripwire_every`` arms the NaN/Inf guard;
    ``init_ranks`` resumes a power iteration."""
    sg = _on_mesh(sg, mesh)
    weighted = _check_pagerank_weighted(sg, out_degrees, weighted)
    home, h, vc, d = mesh.home, mesh.local[0], sg.chunk_size, sg.num_shards
    v, v_pad = sg.num_vertices, sg.padded_vertices
    inv_out, reset, dangling = _pagerank_terms(out_degrees, v, v_pad, home)
    recv, send = _need(sg.msg_recv_local, "message CSR"), sg.msg_send
    devs = mesh.devices
    inv_r = mesh.each(lambda s: inv_out.to(devs[s], copy=True))
    dang_r = mesh.each(lambda s: dangling.to(devs[s], copy=True))
    reset_own = mesh.each(lambda s: _own(reset, s, vc).to(devs[s], copy=True))
    sums = mesh.each(lambda s: SegmentSums(recv[s], vc))
    wts = mesh.each(lambda s: sg.msg_weight[s] if weighted else None)
    if init_ranks is None:
        pr0 = reset
    else:
        pr0 = torch.zeros(v_pad, dtype=torch.float32, device=home)
        pr0[:v] = torch.as_tensor(np.asarray(init_ranks) if not isinstance(
            init_ranks, torch.Tensor) else init_ranks).to(home, torch.float32)
    pr = mesh.each(lambda s: pr0.to(devs[s], copy=True))
    chunks = _replicated_chunks(sg)
    trip = _Trip(home) if tripwire_every else None
    res_rows, shard_rows = [], []
    delta, it = 1.0, 0
    while delta > tol and it < max_iter:
        new = all_gather(mesh, mesh.each(lambda s: _pagerank_shard_body(
            pr[s], inv_r[s], reset_own[s], dang_r[s], recv[s], send[s], sums[s], wts[s],
            vc, alpha)))
        if trip is not None and (it + 1) % tripwire_every == 0:
            _rank_tripwire(trip, mesh, chunks(new), it)
        if telemetry:
            dl, per = _residual_row(mesh, chunks(new), chunks(pr))
            res_rows.append(dl)
            shard_rows.append(per)
        else:
            # the full vector is the same on every shard: shard 0's delta
            dl = agree(mesh, (new[h] - pr[h]).abs().sum())
        delta = float(dl)
        pr = new
        it += 1
    if trip is not None:
        _rank_tripwire(trip, mesh, chunks(pr), it - 1)
        trip.raise_if_tripped()
    ranks = pr[h][:v]
    if not telemetry:
        return ranks
    res = (torch.stack(res_rows).cpu().numpy() if res_rows
           else np.zeros(0, np.float32))
    per = (torch.stack(shard_rows).cpu().numpy() if shard_rows
           else np.zeros((0, d), np.float32))
    return ranks, PowerIterTelemetry(res, per, it)

