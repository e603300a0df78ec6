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
runs on its own device, one after the other in this process; the answers
are those of the single-device supersteps, bit for bit for labels.

:func:`partition_graph` is host NumPy, array for array the JAX package's
(the message CSR slices, the degrees and the stacked degree-bucket plan of
the fast LPA body), so both packages partition a graph identically;
:func:`shard_graph_arrays` places it on a mesh, one tensor per shard on
that shard's device. The JAX package's blocked and 2-D partitions
(``build_blocked_plan``, ``build_plan2d``) wait for ROADMAP item A7b.

The in-loop divergence tripwires and the superstep telemetry keep the JAX
package's kinds, attribution and counters. Their guards run on the device
at the armed cadence and keep the first firing there; the result is read
once, when the run has finished, and a firing raises
:class:`~graphmine_tpu_torch.pipeline.resilience.DivergenceError`. The CC
and PageRank loops read one scalar a superstep (their stopping test); the
LPA loop reads nothing until it returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import SegmentSums, segment_min, segment_mode
from graphmine_tpu_torch.parallel.mesh import Mesh, all_gather, place

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


def _stack0(parts, device) -> torch.Tensor:
    """One value per shard, stacked in shard order on ``device``."""
    return torch.stack([p.to(device) for p in parts])


def _first_shard(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first shard whose flag is set (0 when none is), the
    shard that ``argmax`` over the padded vector names."""
    return torch.argmax(flags.to(torch.int32))


def _label_tripwire(trip: _Trip, new, cur, prev, it: int, v_pad: int, dev) -> None:
    """LPA guards over per-shard chunks: labels outside ``[0, v_pad)``,
    and period-2 oscillation (state t+1 == state t-1 while != state t)."""
    bad = _stack0([((n < 0) | (n >= v_pad)).any() for n in new], dev)
    osc = (_stack0([(n == p).all() for n, p in zip(new, prev)], dev).all()
           & _stack0([(n != c).any() for n, c in zip(new, cur)], dev).any())
    kind = torch.where(bad.any(), 1, torch.where(osc, 2, 0))
    trip.fire(kind, _first_shard(bad), it + 1)


def _cc_tripwire(trip: _Trip, new, cur, it: int, v_pad: int, dev) -> None:
    """CC guards: label range, then monotonicity (min-propagation labels
    never rise); the shard is attributed by the reported kind."""
    bad = _stack0([((n < 0) | (n >= v_pad)).any() for n in new], dev)
    mono = _stack0([(n > c).any() for n, c in zip(new, cur)], dev)
    any_bad = bad.any()
    kind = torch.where(any_bad, 1, torch.where(mono.any(), 4, 0))
    trip.fire(kind, _first_shard(torch.where(any_bad, bad, mono)), it + 1)


def _lpa_range_tripwire(trip: _Trip, new, cur, it: int, v_pad: int, dev) -> None:
    """Range-only LPA guard of the fixpoint runner (no previous iterate
    to test oscillation against)."""
    bad = _stack0([((n < 0) | (n >= v_pad)).any() for n in new], dev)
    trip.fire(torch.where(bad.any(), 1, 0), _first_shard(bad), it + 1)


def _rank_tripwire(trip: _Trip, new, it: int, dev) -> None:
    """PageRank guard: NaN or Inf anywhere in the ranks."""
    bad = _stack0([(~torch.isfinite(n)).any() for n in new], dev)
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


def _telemetry_row(new, cur, dev):
    """One superstep's counters: (changed total, per-shard changed), on
    ``dev``. Padding vertices never change."""
    per = _stack0([(n != c).sum(dtype=torch.int32) for n, c in zip(new, cur)], dev)
    return per.sum(dtype=torch.int32), per


def _residual_row(new, pr, dev):
    """One power iteration's residuals: (L1 delta, per-shard L1)."""
    per = _stack0([(n - p).abs().sum() for n, p in zip(new, pr)], dev)
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
    degree-bucket plan of the fast LPA shard body."""
    del blocked_tile_slots
    if build_blocked_plan or build_plan2d:
        raise NotImplementedError(
            "the blocked and 2-D shard partitions (build_blocked_plan, "
            "build_plan2d) wait for ROADMAP item A7b"
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
    return ShardedGraph(
        msg_recv_local=recv_local, msg_send=send_pad, degrees=deg,
        num_vertices=num_vertices, chunk_size=vc, num_shards=d,
        bucket_send=bucket_send, bucket_target=bucket_target,
        msg_weight=w_pad, bucket_weight=bucket_weight,
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


def shard_graph_arrays(sg: ShardedGraph, mesh: Mesh, lpa_only: bool = False) -> ShardedGraph:
    """Place a partition on ``mesh``: shard ``s`` of every array on
    ``mesh.devices[s]``. ``lpa_only`` (with a bucket plan only) drops the
    sort-body arrays, which the bucketed LPA body never reads; such a
    graph serves :func:`sharded_label_propagation` alone."""
    _check_mesh(sg, mesh)
    if sg.mesh is not None:
        raise ValueError(f"this partition is already placed on {sg.mesh}")
    if lpa_only and not sg.bucket_send:
        raise ValueError("lpa_only requires partition_graph(build_bucket_plan=True)")

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
    if sg.mesh is None:
        return shard_graph_arrays(sg, mesh)
    if sg.mesh.devices != mesh.devices:
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
    from graphmine_tpu_torch.ops.bucketed_mode import _bucket_mode, _bucket_wmode

    lbl_pad = torch.cat([full, full.new_full((1,), _SENTINEL)])
    n_max = max((t.shape[-1] for t in btarget), default=0)
    own = torch.cat([_own(full, s, vc), full.new_zeros((n_max,))])
    for c, (sidx, tgt) in enumerate(zip(bsend, btarget)):
        mat = lbl_pad[sidx]
        vals = _bucket_mode(mat) if bweight is None else _bucket_wmode(mat, bweight[c])
        own[tgt] = vals
    return own[:vc].to(torch.int32)


def _cc_shard_body(full, recv_local, send, deg, s: int, vc: int):
    """One shard's CC superstep before the exchange: the minimum of the
    own label and the incoming ones."""
    neigh_min = segment_min(full[send], recv_local, vc)
    own = _own(full, s, vc)
    return torch.where(deg > 0, torch.minimum(own, neigh_min), own).to(torch.int32)


def _pointer_jump(full: torch.Tensor) -> torch.Tensor:
    """``min(labels, labels[labels])`` on a full vector (no exchange)."""
    return torch.minimum(full, full[_jax_index(full.shape[0], full)])


# ---- loop drivers ------------------------------------------------------------


def _replicated_chunks(sg: ShardedGraph):
    """Per-shard chunks of a replicated state (one full vector per shard)."""
    vc = sg.chunk_size
    return lambda state: [_own(f, s, vc) for s, f in enumerate(state)]


def _scan_supersteps(step_fn, state, max_iter: int, chunks, dev, tripwire_every: int = 0,
                     v_pad: int = 0, collect: bool = False):
    """Exactly ``max_iter`` supersteps (LPA). ``chunks(state)`` gives the
    per-shard chunks the guards and counters read. Returns ``state`` or,
    with ``collect``, ``(state, (changed [T], shard_changed [T, D]))``;
    an armed tripwire raises after the loop."""
    trip = _Trip(dev) if tripwire_every else None
    rows = []
    prev = state
    for it in range(max_iter):
        new = step_fn(state)
        if trip is not None and (it + 1) % tripwire_every == 0:
            _label_tripwire(trip, chunks(new), chunks(state), chunks(prev), it, v_pad, dev)
        if collect:
            rows.append(_telemetry_row(chunks(new), chunks(state), dev))
        prev, state = state, new
    if trip is not None:
        # unconditional exit check: the last supersteps may fall between
        # two armed ones
        last = chunks(state)
        _label_tripwire(trip, last, chunks(prev), chunks(prev), max_iter - 1, v_pad, dev)
        trip.raise_if_tripped()
    if not collect:
        return state
    d = len(chunks(state))
    changed = (torch.stack([r[0] for r in rows]) if rows
               else torch.zeros(0, dtype=torch.int32, device=dev))
    per = (torch.stack([r[1] for r in rows]) if rows
           else torch.zeros((0, d), dtype=torch.int32, device=dev))
    return state, (changed, per)


# Telemetry rows kept by an unbounded (max_iter=0) fixpoint run; a longer
# run overwrites the last row.
_FIXPOINT_TELEMETRY_CAP = 4096


def _fixpoint_supersteps(step_fn, state, sg: ShardedGraph, max_iter: int, chunks, dev,
                         tripwire_every: int = 0, collect: bool = False, guard=_cc_tripwire):
    """Supersteps until no label changes (CC semantics), bounded by
    ``max_iter`` when nonzero: one host read a superstep, the changed
    count. ``guard`` is the tripwire armed every ``tripwire_every``
    supersteps. With ``collect`` returns ``(state, (changed [cap],
    shard_changed [cap, D], iterations))``."""
    limit = max_iter if max_iter > 0 else sg.num_vertices + 2
    cap = min(limit, _FIXPOINT_TELEMETRY_CAP)
    v_pad = sg.padded_vertices
    trip = _Trip(dev) if tripwire_every else None
    if collect:
        buf_c = torch.zeros(cap, dtype=torch.int32, device=dev)
        buf_s = torch.zeros((cap, sg.num_shards), dtype=torch.int32, device=dev)
    changed, it = 1, 0
    while changed > 0 and it < limit:
        new = step_fn(state)
        if trip is not None and (it + 1) % tripwire_every == 0:
            guard(trip, chunks(new), chunks(state), it, v_pad, dev)
        total, per = _telemetry_row(chunks(new), chunks(state), dev)
        if collect:
            row = min(it, cap - 1)
            buf_c[row] = total
            buf_s[row] = per
        changed = int(total)
        state = new
        it += 1
    if trip is not None:
        last = chunks(state)
        guard(trip, last, last, it - 1, v_pad, dev)
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
    """The replicated initial state: one padded label vector per shard."""
    dev0 = mesh.devices[0]
    full = (_padded_init_labels(sg, dev0) if init_labels is None
            else _pad_labels(init_labels, sg, dev0))
    return [full.to(dev, copy=True) for dev in mesh.devices]


def _build_lpa_step(sg: ShardedGraph, mesh: Mesh):
    """The replicated LPA superstep over a list of full label vectors:
    the bucketed body when the partition has a plan, else the sort body;
    then one all-gather."""
    vc, d = sg.chunk_size, sg.num_shards
    if sg.bucket_send:
        weights = sg.bucket_weight or None

        def step(full):
            return all_gather(mesh, [_lpa_shard_body_bucketed(
                full[s], [b[s] for b in sg.bucket_send], [t[s] for t in sg.bucket_target],
                None if weights is None else [w[s] for w in weights], s, vc)
                for s in range(d)])

        return step
    recv, send, deg = (_need(sg.msg_recv_local, "message CSR"), sg.msg_send, sg.degrees)
    w = sg.msg_weight

    def step(full):
        return all_gather(mesh, [_lpa_shard_body(
            full[s], recv[s], send[s], deg[s], None if w is None else w[s], s, vc)
            for s in range(d)])

    return step


def sharded_label_propagation(sg: ShardedGraph, mesh: Mesh, max_iter: int = 5,
                              init_labels=None, tripwire_every: int = 0,
                              telemetry: bool = False):
    """Distributed synchronous LPA, semantics identical to
    :func:`graphmine_tpu_torch.ops.lpa.label_propagation`. Returns int32
    labels ``[V]`` on the mesh's first device, or ``(labels,
    SuperstepTelemetry)`` with ``telemetry``. ``tripwire_every`` arms the
    label-range and oscillation guards every K supersteps; a firing raises
    ``DivergenceError`` with the offending shard."""
    sg = _on_mesh(sg, mesh)
    dev0 = mesh.devices[0]
    out = _scan_supersteps(
        _build_lpa_step(sg, mesh), _init_full(sg, mesh, init_labels), max_iter,
        _replicated_chunks(sg), dev0, tripwire_every=tripwire_every,
        v_pad=sg.padded_vertices, collect=telemetry)
    if not telemetry:
        return out[0][: sg.num_vertices]
    state, (changed, per) = out
    return state[0][: sg.num_vertices], SuperstepTelemetry(
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
        _replicated_chunks(sg), mesh.devices[0], tripwire_every=tripwire_every,
        collect=True, guard=_lpa_range_tripwire)
    row = min(it, changed.shape[0]) - 1
    converged = it == 0 or int(changed[row]) == 0
    return state[0][: sg.num_vertices], it, converged


def _build_cc_step(sg: ShardedGraph, mesh: Mesh):
    vc, d = sg.chunk_size, sg.num_shards
    recv, send, deg = (_need(sg.msg_recv_local, "message CSR"), sg.msg_send, sg.degrees)

    def step(full):
        gathered = all_gather(mesh, [_cc_shard_body(full[s], recv[s], send[s], deg[s], s, vc)
                                     for s in range(d)])
        # pointer jumping on each shard's full vector: no extra exchange
        return [_pointer_jump(f) for f in gathered]

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
        _replicated_chunks(sg), mesh.devices[0], tripwire_every=tripwire_every,
        collect=telemetry)
    if not telemetry:
        return out[0][: sg.num_vertices]
    state, (changed, per, it) = out
    n = min(it, changed.shape[0])
    return state[0][: sg.num_vertices], SuperstepTelemetry(
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
    dev0, vc, d = mesh.devices[0], sg.chunk_size, sg.num_shards
    v, v_pad = sg.num_vertices, sg.padded_vertices
    inv_out, reset, dangling = _pagerank_terms(out_degrees, v, v_pad, dev0)
    recv, send = _need(sg.msg_recv_local, "message CSR"), sg.msg_send
    devs = mesh.devices
    inv_r = [inv_out.to(x, copy=True) for x in devs]
    dang_r = [dangling.to(x, copy=True) for x in devs]
    reset_own = [_own(reset, s, vc).to(x, copy=True) for s, x in enumerate(devs)]
    sums = [SegmentSums(recv[s], vc) for s in range(d)]
    wts = [sg.msg_weight[s] if weighted else None for s in range(d)]
    if init_ranks is None:
        pr0 = reset
    else:
        pr0 = torch.zeros(v_pad, dtype=torch.float32, device=dev0)
        pr0[:v] = torch.as_tensor(np.asarray(init_ranks) if not isinstance(
            init_ranks, torch.Tensor) else init_ranks).to(dev0, torch.float32)
    pr = [pr0.to(x, copy=True) for x in devs]
    chunks = _replicated_chunks(sg)
    trip = _Trip(dev0) if tripwire_every else None
    res_rows, shard_rows = [], []
    delta, it = 1.0, 0
    while delta > tol and it < max_iter:
        new = all_gather(mesh, [_pagerank_shard_body(
            pr[s], inv_r[s], reset_own[s], dang_r[s], recv[s], send[s], sums[s], wts[s],
            vc, alpha) for s in range(d)])
        if trip is not None and (it + 1) % tripwire_every == 0:
            _rank_tripwire(trip, chunks(new), it, dev0)
        if telemetry:
            dl, per = _residual_row(chunks(new), chunks(pr), dev0)
            res_rows.append(dl)
            shard_rows.append(per)
        else:
            dl = (new[0] - pr[0]).abs().sum()
        delta = float(dl)
        pr = new
        it += 1
    if trip is not None:
        _rank_tripwire(trip, chunks(pr), it - 1, dev0)
        trip.raise_if_tripped()
    ranks = pr[0][:v]
    if not telemetry:
        return ranks
    res = (torch.stack(res_rows).cpu().numpy() if res_rows
           else np.zeros(0, np.float32))
    per = (torch.stack(shard_rows).cpu().numpy() if shard_rows
           else np.zeros((0, d), np.float32))
    return ranks, PowerIterTelemetry(res, per, it)

