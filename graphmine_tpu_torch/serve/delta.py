"""Incremental delta ingest: splice edge batches, repair labels warm
(PyTorch, one device).

Counterpart of ``graphmine_tpu/serve/delta.py``'s single-device path:

1. **validate** an insert/delete batch through the ingestion-quarantine
   rules (negative or absurdly large ids, deletes that match nothing are
   counted and set aside);
2. **splice** it into the host edge arrays: inserts append (duplicates
   keep LPA multiplicity), each delete removes one matching directed
   occurrence (multiset semantics, earliest position first);
3. **repair**: the previous snapshot's labels seed the new graph's LPA and
   CC on the ingestor's device (``_warm_lpa``: the sort-based
   ``lpa_superstep`` to a fixpoint, period-2 cycles exit early;
   ``_warm_cc``: min-propagation from valid upper bounds) under a
   frontier-derived superstep budget;
4. **verify**: one exact superstep of the new graph at sampled vertices
   (every delta-affected vertex plus ``np.random.default_rng(version)``
   draws, the JAX package's samples) must leave the repaired labels
   unchanged, and every label must be a real vertex id; a disagreement or
   an exhausted budget emits ``repair_fallback`` and falls back to a cold
   recompute.

CC repair is exact by construction (deletes reset every vertex of a
touched component to its own id first); LPA fixpoints are not unique, so
warm LPA is checked, not assumed. Outlier scores ride
:class:`~graphmine_tpu_torch.ops.streaming_lof.StreamingLOF` with
``impl="ivf"`` and one reused set of k-means centers. Labels, CC labels,
the repair method and its iteration counts are bit-equal to the JAX
package's on the same store and deltas.

The sharded repair (``num_shards > 1``: ``_warm_lpa_sharded``,
``_sharded_exact_step``, ``_resolve_shard_family``, ``_repair_sharded``)
is ROADMAP item A7b and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.pipeline import resilience
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.serve.snapshot import Snapshot, SnapshotStore

_SHARDED = ("the sharded delta repair (num_shards > 1) is ROADMAP item A7b "
            "of the port; this ingestor repairs on one device")

# Growth guard: a typo'd insert id must not allocate a billion-row label
# vector. Inserts past current V + this bound are quarantined.
MAX_NEW_VERTICES = 1 << 20


@dataclass
class EdgeDelta:
    """One edge insert/delete batch (directed endpoints, dense ids).

    ``insert_weight``: optional float32 per-insert edge weights (weighted
    snapshots). ``None`` = unweighted inserts; splicing into a
    weighted snapshot then defaults them to 1.0. Deletes are always
    keyed by ``(src, dst)`` alone — a delete removes ONE occurrence of
    the directed edge, whatever its weight (multiset semantics; the
    earliest-position occurrence goes first, deterministically).
    """

    insert_src: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    insert_dst: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    delete_src: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    delete_dst: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    insert_weight: np.ndarray | None = None

    def __post_init__(self):
        for name in ("insert_src", "insert_dst", "delete_src", "delete_dst"):
            setattr(self, name, np.asarray(getattr(self, name), np.int64))
        if (
            self.insert_src.shape != self.insert_dst.shape
            or self.delete_src.shape != self.delete_dst.shape
        ):
            raise ValueError("src/dst arrays must be equal-length")
        if self.insert_weight is not None:
            w = np.asarray(self.insert_weight, np.float32)
            if w.shape != self.insert_src.shape:
                raise ValueError(
                    "insert_weight must be one float per insert row"
                )
            if len(w) and (not np.isfinite(w).all() or (w < 0).any()):
                raise ValueError(
                    "insert_weight must be non-negative and finite"
                )
            self.insert_weight = w

    @classmethod
    def from_pairs(cls, insert=(), delete=()) -> "EdgeDelta":
        """Build from ``[(src, dst), ...]`` pair lists (the JSON wire
        shape the HTTP front end accepts); insert rows may uniformly be
        ``(src, dst, weight)`` triples for weighted snapshots. Malformed
        input — null, non-iterable, non-numeric, fractional ids, or
        mixed 2/3-wide insert rows — raises ValueError (the HTTP
        layer's 400), never TypeError, and never silently truncates
        ``1.9`` to vertex ``1``. Integral floats (``40.0``, which JSON
        encoders routinely emit for integers) are accepted as ids.
        """

        from graphmine_tpu_torch.serve.query import _as_int_ids

        def _rows(name, pairs, widths):
            try:
                lst = list(pairs)
            except TypeError as e:
                raise ValueError(
                    f"{name} must be an array of [src, dst] pairs ({e})"
                ) from e
            try:
                seen = {len(r) for r in lst}
            except TypeError as e:
                raise ValueError(
                    f"{name} rows must be [src, dst] pairs ({e})"
                ) from e
            if seen and seen not in [{w} for w in widths]:
                raise ValueError(
                    f"{name} rows must uniformly be "
                    f"{' or '.join(str(w) for w in widths)} wide "
                    f"(got widths {sorted(seen)})"
                )
            return lst, (seen.pop() if seen else widths[0])

        ins, iw = _rows("insert", insert, (2, 3))
        del_, _ = _rows("delete", delete, (2,))
        weight = None
        if iw == 3 and ins:
            try:
                weight = np.asarray([r[2] for r in ins], np.float32)
            except (TypeError, ValueError) as e:
                raise ValueError(f"insert weights must be numeric ({e})") from e
            ins = [(r[0], r[1]) for r in ins]
        ins_ids = _as_int_ids(ins, "insert").reshape(-1, 2)
        del_ids = _as_int_ids(del_, "delete").reshape(-1, 2)
        return cls(
            ins_ids[:, 0], ins_ids[:, 1], del_ids[:, 0], del_ids[:, 1],
            insert_weight=weight,
        )

    @property
    def num_inserts(self) -> int:
        return len(self.insert_src)

    @property
    def num_deletes(self) -> int:
        return len(self.delete_src)

    def take(self, insert_index, delete_index) -> "EdgeDelta":
        """Row-select a sub-delta by original row indices (the sharded
        write plane's splitter): inserts keep their weights, and because
        the indices are positions into this delta's arrays, a scatter of
        the sub-deltas back through the same indices is bit-identical to
        the original."""
        ins = np.asarray(insert_index, np.int64)
        dels = np.asarray(delete_index, np.int64)
        return EdgeDelta(
            self.insert_src[ins], self.insert_dst[ins],
            self.delete_src[dels], self.delete_dst[dels],
            insert_weight=(
                None if self.insert_weight is None
                else self.insert_weight[ins]
            ),
        )


def validate_delta(
    delta: EdgeDelta, num_vertices: int,
    max_new_vertices: int = MAX_NEW_VERTICES,
) -> tuple[EdgeDelta, dict]:
    """Quarantine-validate a delta against the current vertex space.

    Returns ``(clean_delta, quarantine)`` — the same count-and-set-aside
    contract as ingestion (``io/edges.from_arrays``): negative ids and
    inserts past the growth guard are dropped as ``out_of_range_ids``;
    deletes referencing vertices that don't exist can never match an
    edge and are dropped as ``unmatched_deletes``. Nothing raises on bad
    rows — a served endpoint crashing on one malformed batch row is the
    failure mode quarantine exists to prevent.
    """
    q = {"out_of_range_ids": 0, "unmatched_deletes": 0}
    cap = num_vertices + max_new_vertices
    ok_i = (
        (delta.insert_src >= 0) & (delta.insert_dst >= 0)
        & (delta.insert_src < cap) & (delta.insert_dst < cap)
    )
    q["out_of_range_ids"] += int((~ok_i).sum())
    ok_d = (
        (delta.delete_src >= 0) & (delta.delete_dst >= 0)
        & (delta.delete_src < num_vertices) & (delta.delete_dst < num_vertices)
    )
    q["unmatched_deletes"] += int((~ok_d).sum())
    return EdgeDelta(
        delta.insert_src[ok_i], delta.insert_dst[ok_i],
        delta.delete_src[ok_d], delta.delete_dst[ok_d],
        insert_weight=(
            None if delta.insert_weight is None
            else delta.insert_weight[ok_i]
        ),
    ), q


def splice_edges(src, dst, num_vertices: int, delta: EdgeDelta, weights=None):
    """Apply a validated delta to host edge arrays.

    Inserts append (multiplicity kept); each delete row removes ONE
    matching directed occurrence (multiset delete — deleting an edge
    that appears 3x leaves 2; the earliest array position goes first,
    which makes weighted splices deterministic too). Returns
    ``(src', dst', num_vertices', stats)`` with
    ``stats = {inserted, deleted, unmatched_deletes}``; the vertex space
    only ever grows (deletes remove edges, never vertices — stable ids
    are the serving contract).

    ``weights``: the snapshot's per-edge float weights (weighted
    graphs). When given, the return is the FIVE-tuple
    ``(src', dst', weights', num_vertices', stats)`` — deleted rows drop
    their weight with them, inserted rows carry ``delta.insert_weight``
    (default 1.0 when the delta is unweighted). Passing a weighted delta
    against ``weights=None`` raises: silently discarding client weights
    would change weighted-LPA semantics without a trace.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if weights is None and delta.insert_weight is not None:
        raise ValueError(
            "delta carries insert weights but the snapshot is unweighted; "
            "republish the snapshot with a weights array or drop the "
            "weight column from the delta"
        )
    if weights is not None:
        weights = np.asarray(weights, np.float32)
        if weights.shape != src.shape:
            raise ValueError(
                f"weights has {weights.shape} entries for {src.shape} edges"
            )
    v_new = int(
        max(
            num_vertices,
            delta.insert_src.max(initial=-1) + 1,
            delta.insert_dst.max(initial=-1) + 1,
        )
    )
    keep = np.ones(len(src), bool)
    unmatched = 0
    if delta.num_deletes:
        enc = v_new + 1
        ekey = src * enc + dst
        dkey = delta.delete_src * enc + delta.delete_dst
        dk_u, dk_c = np.unique(dkey, return_counts=True)
        # Prefilter to rows whose key a delete targets — searchsorted
        # against the tiny sorted dk_u is O(E log d), so the
        # occurrence-rank sort runs over the handful of candidates, not
        # all E edges (np.isin would fall back to an O(E log E)
        # sort-based path for int64 key ranges this wide).
        pos_all = np.minimum(np.searchsorted(dk_u, ekey), len(dk_u) - 1)
        cand = np.flatnonzero(dk_u[pos_all] == ekey)
        order = np.argsort(ekey[cand], kind="stable")
        sk = ekey[cand][order]
        # occurrence rank of each edge within its (src, dst) group
        rank = np.arange(len(sk)) - np.searchsorted(sk, sk, side="left")
        want = dk_c[np.searchsorted(dk_u, sk)]  # every sk is in dk_u
        drop_sorted = rank < want
        keep[cand[order[drop_sorted]]] = False
        unmatched = int(delta.num_deletes - drop_sorted.sum())
    src2 = np.concatenate([src[keep], delta.insert_src])
    dst2 = np.concatenate([dst[keep], delta.insert_dst])
    stats = {
        "inserted": delta.num_inserts,
        "deleted": int((~keep).sum()),
        "unmatched_deletes": unmatched,
    }
    if weights is not None:
        ins_w = (
            delta.insert_weight if delta.insert_weight is not None
            else np.ones(delta.num_inserts, np.float32)
        )
        w2 = np.concatenate([weights[keep], ins_w]).astype(np.float32)
        return src2.astype(np.int32), dst2.astype(np.int32), w2, v_new, stats
    return src2.astype(np.int32), dst2.astype(np.int32), v_new, stats


def affected_vertices(delta: EdgeDelta) -> np.ndarray:
    """Distinct vertex ids a delta touches directly — the repair frontier
    seed (their labels may change first; propagation widens from here)."""
    return np.unique(
        np.concatenate(
            [delta.insert_src, delta.insert_dst,
             delta.delete_src, delta.delete_dst]
        )
    ).astype(np.int64)


def frontier_budget(num_vertices: int, affected: int) -> int:
    """Frontier-derived superstep budget for a warm repair.

    Label effects propagate one hop per superstep, so a delta touching
    ``affected`` seeds needs depth proportional to how far its influence
    can reach before dying out: ``log2``-ish in the graph size (pointer
    jumping / small-world propagation depth) plus a term in the seed
    count. Deliberately generous — exhausting it without convergence
    triggers the full-recompute fallback, so a tight budget only costs a
    wasted warm attempt, never a wrong answer.
    """
    v_term = math.ceil(math.log2(num_vertices + 2))
    a_term = math.ceil(math.log2(affected + 2))
    return int(min(128, 2 * v_term + a_term + 8))


# ---- warm fixpoint runners -------------------------------------------------


def _device_labels(labels, graph) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int32)).to(graph.device)


def _warm_lpa(graph, init_labels: np.ndarray, budget: int):
    """Warm-start synchronous LPA to a fixpoint, bounded by ``budget``:
    one sort-based superstep (:func:`~graphmine_tpu_torch.ops.lpa.lpa_superstep`)
    per iteration on the graph's device. Returns ``(labels, iterations,
    converged)``.

    Period-2 cycles (synchronous LPA's livelock on e.g. bipartite hub
    structures) are detected (state t+1 == state t-1) and exit early as
    ``converged=False``. Each superstep reads two booleans on the host,
    as the JAX package does."""
    from graphmine_tpu_torch.ops.lpa import lpa_superstep

    labels = _device_labels(init_labels, graph)
    prev = None
    for it in range(budget):
        new = lpa_superstep(labels, graph)
        if not bool(torch.any(new != labels)):
            return new.cpu().numpy(), it + 1, True
        if prev is not None and not bool(torch.any(new != prev)):
            return new.cpu().numpy(), it + 1, False  # period-2 livelock
        prev = labels
        labels = new
    return labels.cpu().numpy(), budget, False


def _warm_cc(graph, init_labels: np.ndarray, budget: int):
    """Warm-start min-propagation CC to a fixpoint (monotone, so any valid
    upper-bound init converges to THE fixpoint). Returns ``(labels,
    iterations, converged)``."""
    from graphmine_tpu_torch.ops.cc import cc_superstep

    labels = _device_labels(init_labels, graph)
    for it in range(budget):
        new = cc_superstep(labels, graph)
        if not bool(torch.any(new != labels)):
            return new.cpu().numpy(), it + 1, True
        labels = new
    return labels.cpu().numpy(), budget, False


def cc_repair_init(
    prev_cc: np.ndarray, num_vertices: int, delta: EdgeDelta
) -> np.ndarray:
    """Valid min-propagation upper bounds seeded from the previous CC
    labels: every vertex of a component touched by a DELETE resets to its
    own id (the split case — its old min may have landed in the other
    part), new vertices get their own id, everything else keeps its
    (exact) label. See the module docstring for why this makes CC repair
    == cold recompute by construction."""
    init = np.arange(num_vertices, dtype=np.int32)
    init[: len(prev_cc)] = prev_cc
    if delta.num_deletes:
        touched = np.unique(
            prev_cc[
                np.concatenate([delta.delete_src, delta.delete_dst]).astype(
                    np.int64
                )
            ]
        )
        reset = np.isin(prev_cc, touched)
        init[: len(prev_cc)][reset] = np.arange(len(prev_cc), dtype=np.int32)[
            reset
        ]
    return init


def sampled_exact_check(
    graph, labels: np.ndarray, samples: np.ndarray, kind: str = "lpa",
    shards=None,
) -> tuple[bool, int]:
    """The repair tripwire: one EXACT superstep of the new graph must
    leave the repaired labels unchanged at every sampled vertex, and
    every sampled label must be a real vertex id. A genuine fixpoint
    passes by construction; corrupted state, a non-fixpoint (budget ran
    out) or a wrong-graph mixup does not. Returns
    ``(ok, mismatching_samples)``. ``shards`` (the sharded check) is
    ROADMAP item A7b."""
    if shards is not None:
        raise NotImplementedError(_SHARDED)
    from graphmine_tpu_torch.ops.cc import cc_superstep
    from graphmine_tpu_torch.ops.lpa import lpa_superstep

    v = graph.num_vertices
    lbl = np.asarray(labels)
    oob = int(((lbl < 0) | (lbl >= v)).sum())
    if oob:
        return False, oob
    step = lpa_superstep if kind == "lpa" else cc_superstep
    nxt = step(_device_labels(lbl, graph), graph).cpu().numpy()
    samples = np.asarray(samples, np.int64)
    samples = samples[(samples >= 0) & (samples < v)]
    bad = int((nxt[samples] != lbl[samples]).sum())
    return bad == 0, bad


@dataclass(frozen=True)
class RepairResult:
    """Outcome of one delta repair."""

    labels: np.ndarray            # community labels [V'] (LPA fixpoint)
    cc_labels: np.ndarray         # CC labels [V']
    method: str                   # "warm" | "full_recompute"
    iterations: int               # supersteps the winning path ran (LPA + CC)
    fallback_reason: str | None = None
    checked_samples: int = 0
    budget: int = 0               # frontier budget the warm attempt was granted


class RepairDebt:
    """Host-side ledger of how far behind serving-state repair is.

    The write-heavy-serving rungs the ROADMAP names next (delta
    coalescing, admission control, load shedding) all need ONE signal:
    how much un-repaired work has accumulated, and how fast repairs are
    keeping up. This ledger is that signal, fed from the two ends of the
    delta path:

    - :meth:`submitted` when a delta batch *arrives* (the HTTP handler,
      before it queues on the publish lock) — pending rows and the
      arrival time of the oldest unapplied batch (**ingest lag**: how
      stale the served snapshot is against accepted writes);
    - :meth:`applied` when the ingestor *publishes* — drains the oldest
      pending entry and accrues the repair economics: warm vs
      full-recompute counts (the warm ratio is the number the serve
      bench tier exists to improve), supersteps spent vs the frontier
      budget granted (a budget fraction pinned near 1.0 means deltas
      are one graph-growth away from the fallback cliff).

    Pure host bookkeeping under one lock — nothing here touches a
    device.
    When a ``registry`` is given, the ledger mirrors itself into
    scrapeable gauges/counters on every event.
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._pending: deque = deque()   # (t_submitted, rows) FIFO
        self._pending_rows = 0
        self.applies_warm = 0
        self.applies_cold = 0
        self.supersteps_total = 0
        self.budget_granted_total = 0
        self.last_budget_frac = 0.0
        self.rows_applied_total = 0
        self.sheds_total = 0
        self.rows_shed_total = 0
        self._registry = registry

    def submitted(self, rows: int, t: float | None = None) -> None:
        """One delta batch accepted (``rows`` = insert + delete rows)."""
        with self._lock:
            self._pending.append((time.time() if t is None else t, int(rows)))
            self._pending_rows += int(rows)
        self._export()

    def applied(
        self, method: str, iterations: int, budget: int, batches: int = 1
    ) -> None:
        """One delta apply published; drains the ``batches`` oldest
        pending entries — a coalesced apply settles every batch it
        merged, not just one (no-op on the pending side when the
        ingestor is driven directly, without a front end calling
        :meth:`submitted`)."""
        with self._lock:
            for _ in range(max(1, int(batches))):
                if not self._pending:
                    break
                _, rows = self._pending.popleft()
                self._pending_rows -= rows
                self.rows_applied_total += rows
            if method == "warm":
                self.applies_warm += 1
            else:
                self.applies_cold += 1
            self.supersteps_total += int(iterations)
            self.budget_granted_total += int(budget)
            self.last_budget_frac = (
                round(int(iterations) / int(budget), 4) if budget else 0.0
            )
        reg = self._registry
        if reg is not None:
            reg.counter(
                "graphmine_serve_repairs_warm_total",
                "delta applies repaired warm",
            ).inc(1 if method == "warm" else 0)
            reg.counter(
                "graphmine_serve_repairs_cold_total",
                "delta applies that fell back to full recompute",
            ).inc(0 if method == "warm" else 1)
            reg.counter(
                "graphmine_serve_repair_supersteps_total",
                "repair supersteps spent across all delta applies",
            ).inc(int(iterations))
        self._export()

    @property
    def applies_total(self) -> int:
        """Settled applies (warm + cold) — the caller's marker for "did
        my apply get as far as settling its debt before it raised"."""
        with self._lock:
            return self.applies_warm + self.applies_cold

    def abandoned(self) -> None:
        """A submitted batch will never publish (validation raised, the
        ingestor refused the snapshot, admission shed it off the queue):
        drop the oldest pending entry so the ledger doesn't report a
        phantom backlog forever. FIFO is an approximation under
        concurrent submitters — the ledger is advisory telemetry, and
        totals rebalance as the queue drains."""
        with self._lock:
            if self._pending:
                _, rows = self._pending.popleft()
                self._pending_rows -= rows
        self._export()

    def shed(self, rows: int) -> None:
        """Admission control refused ``rows`` delta rows (a 503 the
        client must retry) — the lost-write accounting the serve bench
        tier's shed rate reads. Pure accounting: sheds at the front door
        were never :meth:`submitted`, so nothing drains here (a
        queued-then-shed batch pairs this with :meth:`abandoned`)."""
        with self._lock:
            self.sheds_total += 1
            self.rows_shed_total += int(rows)
        self._export()

    def ingest_lag_s(self, now: float | None = None) -> float:
        """Age of the oldest accepted-but-unapplied delta (0.0 when the
        queue is drained) — the staleness bound a load balancer reads."""
        with self._lock:
            if not self._pending:
                return 0.0
            return max(0.0, (time.time() if now is None else now)
                       - self._pending[0][0])

    def snapshot(self) -> dict:
        """One JSON-ready read of the whole ledger."""
        lag = self.ingest_lag_s()
        with self._lock:
            applies = self.applies_warm + self.applies_cold
            return {
                "pending_deltas": len(self._pending),
                "pending_rows": self._pending_rows,
                "ingest_lag_s": round(lag, 4),
                "applies_warm": self.applies_warm,
                "applies_cold": self.applies_cold,
                "warm_ratio": (
                    round(self.applies_warm / applies, 4) if applies else 1.0
                ),
                "supersteps_total": self.supersteps_total,
                "budget_granted_total": self.budget_granted_total,
                "last_budget_frac": self.last_budget_frac,
                "rows_applied_total": self.rows_applied_total,
                "sheds_total": self.sheds_total,
                "rows_shed_total": self.rows_shed_total,
            }

    def _export(self) -> None:
        reg = self._registry
        if reg is None:
            return
        snap = self.snapshot()
        reg.gauge(
            "graphmine_serve_repair_debt_rows",
            "delta rows accepted but not yet repaired/published",
        ).set(snap["pending_rows"])
        reg.gauge(
            "graphmine_serve_ingest_lag_seconds",
            "age of the oldest accepted-but-unapplied delta batch",
        ).set(snap["ingest_lag_s"])
        reg.gauge(
            "graphmine_serve_repair_budget_frac",
            "supersteps used / frontier budget granted, last apply",
        ).set(snap["last_budget_frac"])


def cold_recompute(graph, budget: int = 0, shards=None):
    """Cold full recompute, the fallback AND the equivalence oracle: LPA
    from the identity run to a fixpoint (bounded, period-2 cycles exit
    early), CC from the identity. Returns ``(labels, cc_labels, iters)``.
    On graphs whose synchronous LPA livelocks the result is the
    cycle-stopped bounded recompute, and every delta on such a graph
    routes here through the repair fallback. ``shards`` is ROADMAP item
    A7b."""
    if shards is not None:
        raise NotImplementedError(_SHARDED)
    from graphmine_tpu_torch.ops.cc import connected_components

    v = graph.num_vertices
    budget = budget or frontier_budget(v, v)
    labels, it_l, _ = _warm_lpa(graph, np.arange(v, dtype=np.int32), budget)
    cc = connected_components(graph).cpu().numpy()
    return labels, cc, it_l


def _verify_or_fallback(
    graph, labels, cc, conv_l, conv_c, delta: EdgeDelta, budget: int,
    iterations: int, check_samples: int, sink, num_shards: int = 1,
    seed: int = 0, shards=None, tenant: str = "",
) -> RepairResult:
    """The shared tail of the repair: fault seam → sampled exact check →
    accept or fall back (``shards``, the sharded caller's, is ROADMAP item
    A7b).

    The fault seam is where tests corrupt the repaired state
    (poison_labels-style mutator) to prove the sampled check catches
    silent damage and the fallback republishes exact labels. A mutator
    may hand back a tensor: the labels return to the host as arrays.
    """
    state = {"labels": labels, "cc_labels": cc}
    # tenant rides the ctx: a tenant-targeted injector
    # (noisy_neighbor_burst's staller) fires only on the abusive
    # tenant's applies, leaving its co-tenants' repairs untouched.
    resilience.fault_point(
        "delta_repair", state=state, num_shards=num_shards, tenant=tenant,
    )
    labels, cc = np.asarray(state["labels"]), np.asarray(state["cc_labels"])

    v = graph.num_vertices
    rng = np.random.default_rng(seed)
    extra = rng.integers(0, v, size=min(check_samples, v))
    samples = np.unique(np.concatenate([affected_vertices(delta), extra]))
    ok_l, bad_l = sampled_exact_check(
        graph, labels, samples, kind="lpa", shards=shards
    )
    ok_c, bad_c = sampled_exact_check(
        graph, cc, samples, kind="cc", shards=shards
    )

    reason = None
    if not (conv_l and conv_c):
        reason = (
            f"budget exhausted before fixpoint (lpa converged={conv_l}, "
            f"cc converged={conv_c}, budget={budget})"
        )
    elif not (ok_l and ok_c):
        reason = (
            f"sampled exact check failed ({bad_l} lpa / {bad_c} cc "
            f"disagreements over {len(samples)} samples)"
        )
    if reason is None:
        return RepairResult(
            labels=labels, cc_labels=cc, method="warm",
            iterations=iterations, checked_samples=len(samples),
            budget=budget,
        )
    if sink is not None:
        sink.emit("repair_fallback", stage="delta_repair", reason=reason)
    labels, cc, it = cold_recompute(graph, shards=shards)
    return RepairResult(
        labels=labels, cc_labels=cc, method="full_recompute",
        iterations=it, fallback_reason=reason,
        checked_samples=len(samples), budget=budget,
    )


def repair_labels(
    graph,
    prev_labels: np.ndarray,
    prev_cc: np.ndarray,
    delta: EdgeDelta,
    budget: int | None = None,
    check_samples: int = 64,
    sink=None,
    seed: int = 0,
    tenant: str = "",
) -> RepairResult:
    """Warm-start repair of community + CC labels on the spliced graph.

    The previous snapshot's labels seed both propagations (see module
    docstring for the exact init rules); the sampled exact check accepts
    or rejects the result, and rejection — or a budget exhausted before
    the frontier emptied — falls back to :func:`cold_recompute` with a
    ``repair_fallback`` record through ``sink``. The returned labels are
    therefore ALWAYS a verified fixpoint of the new graph.
    """
    v = graph.num_vertices
    if budget is None:
        budget = frontier_budget(v, len(affected_vertices(delta)))

    init_lpa = np.arange(v, dtype=np.int32)
    init_lpa[: len(prev_labels)] = prev_labels
    labels, it_l, conv_l = _warm_lpa(graph, init_lpa, budget)
    cc, it_c, conv_c = _warm_cc(
        graph, cc_repair_init(np.asarray(prev_cc), v, delta), budget
    )
    return _verify_or_fallback(
        graph, labels, cc, conv_l, conv_c, delta, budget, it_l + it_c,
        check_samples, sink, seed=seed, tenant=tenant,
    )


class DeltaIngestor:
    """Applies edge deltas to a snapshot store: validate → splice →
    warm repair → streaming LOF refresh → publish.

    Holds the host-side working state (edge arrays + labels) between
    deltas so consecutive batches never re-load the store, and one
    :class:`~graphmine_tpu_torch.ops.streaming_lof.StreamingLOF` whose
    trained IVF centers are reused across deltas (``impl="ivf"``: Lloyd
    runs once per ingestor, not once per batch). The graph, the repair,
    the features, the LOF and the canary probe run on ``device`` (CUDA
    unless the caller names another).

    ``num_shards > 1`` (the sharded repair) is ROADMAP item A7b and raises
    ``NotImplementedError``.
    """

    def __init__(
        self,
        store: SnapshotStore,
        sink=None,
        lof_k: int = 16,
        lof_capacity: int = 4096,
        check_samples: int = 64,
        num_shards: int = 1,
        snapshot: Snapshot | None = None,
        debt: RepairDebt | None = None,
        epoch: int | None = None,
        quality: bool | None = None,
        device=None,
    ):
        if num_shards > 1:
            raise NotImplementedError(_SHARDED)
        self.device = resolve_device(device)
        self.store = store
        self.sink = sink
        self.check_samples = check_samples
        self.num_shards = num_shards
        # Writer epoch every publish carries (replicated writers):
        # None = inherit the store's epoch (single-writer callers). A
        # stale epoch makes the publish refuse with PublishFencedError —
        # the deposed-writer fence lives at the store, this just says
        # which epoch this ingestor believes it is.
        self.epoch = epoch
        # Repair-debt ledger (docs/OBSERVABILITY.md "serving SLO"): the
        # front end owns one and shares it here so the pending side
        # survives ingestor rebasing on /reload; a bare ingestor gets a
        # private ledger so the delta_apply record always carries debt.
        self.debt = debt if debt is not None else RepairDebt(
            registry=sink.registry if sink is not None else None
        )
        snap = snapshot if snapshot is not None else store.load(sink=sink)
        if snap is None:
            raise ValueError(
                f"snapshot store at {store.root!r} is empty; publish a "
                "pipeline snapshot (--snapshot-out) before ingesting deltas"
            )
        self.snapshot = snap
        self.src = np.asarray(snap["src"], np.int32)
        self.dst = np.asarray(snap["dst"], np.int32)
        # Weighted snapshots ingest deltas end-to-end: the graph is
        # rebuilt with edge_weights, so warm LPA/sampled-check/cold
        # fallback all run the WEIGHTED supersteps (weight-sum mode,
        # ops/lpa.py) — CC is weight-oblivious min-propagation. The loud
        # refusal below remains only for a genuinely unsupported shape:
        # a weights column that doesn't align with the edge arrays.
        w = snap.get("weights")
        self.weights = None if w is None else np.asarray(w, np.float32)
        if self.weights is not None and self.weights.shape != self.src.shape:
            raise ValueError(
                f"snapshot weights array has {self.weights.shape} entries "
                f"for {self.src.shape} edges; this store is damaged or was "
                "published by an incompatible writer — republish it"
            )
        self.labels = np.asarray(snap["labels"], np.int32)
        self.cc_labels = np.asarray(
            snap.get("cc_labels", snap["labels"]), np.int32
        )
        lof = snap.get("lof")
        self.lof = (
            np.zeros(len(self.labels), np.float32) if lof is None
            else np.asarray(lof, np.float32).copy()
        )
        self.lof_k = lof_k
        self.lof_capacity = max(lof_capacity, lof_k + 2)
        self._stream = None
        # IVF centers from a prior process's publishes (if any): the
        # StreamingLOF(centers=...) reuse path — Lloyd never re-trains
        # what an earlier ingestor already paid for.
        self._centers = snap.get("lof_centers")
        # LOF-staleness backlog (admission rung 2, serve/admission.py):
        # vertices whose scores a deferred apply skipped. The next
        # lof_mode="refresh" apply re-scores the union. A snapshot loaded
        # already-stale has no backlog list — the first refresh then
        # re-scores everything (rare, and the honest recovery).
        self._stale_aff = np.empty(0, np.int64)
        self._stale_all = bool(snap.meta.get("lof_stale", False))
        # Result-quality plane: every publish runs a bounded quality pass
        # — census/LOF drift vs the parent (whose labels this ingestor
        # already holds), sketch states, and the canary probe re-score.
        # GRAPHMINE_QUALITY=0 (or quality=False) disables the whole
        # pass; the canary probe persists in the snapshot (the
        # lof_centers pattern) so every writer in the store's lifetime
        # scores the SAME frozen probe — a fresh store generates one,
        # seeded by GRAPHMINE_CANARY_SEED.
        if quality is None:
            quality = os.environ.get("GRAPHMINE_QUALITY", "1") != "0"
        self.quality_enabled = bool(quality)
        self.last_quality = None       # QualityReport of the last apply
        self._quality_state = None     # parent state reused next apply
        self._canary = None
        if self.quality_enabled:
            from graphmine_tpu_torch.obs.quality import CanaryProbe

            self._canary = CanaryProbe.from_arrays(snap.arrays, snap.meta)
            if self._canary is None:
                self._canary = CanaryProbe.generate(
                    seed=int(os.environ.get("GRAPHMINE_CANARY_SEED", "0"))
                )

    @property
    def num_vertices(self) -> int:
        return len(self.labels)

    def _repair(self, graph, delta: EdgeDelta) -> RepairResult:
        # Rotate the sampled-check seed per apply (the snapshot version
        # increments every publish): a fixed seed would pick the same
        # "random" vertices on every delta, gutting the tripwire's
        # long-run coverage of silent corruption outside the frontier.
        seed = self.snapshot.version
        tenant = getattr(self.store, "tenant", "")
        return repair_labels(
            graph, self.labels, self.cc_labels, delta,
            check_samples=self.check_samples, sink=self.sink,
            seed=seed, tenant=tenant,
        )

    def _refresh_lof(self, graph, labels: np.ndarray, aff: np.ndarray):
        """Score delta-affected vertices through the streaming IVF-reuse
        path and splice them into the LOF column. The first delta
        bootstraps the window from the full feature matrix (and refreshes
        every score); later deltas STREAM-SCORE only the affected rows —
        but the feature matrix itself is still the whole-graph vectorized
        pass (vertex_features has no per-vertex entry point; features
        depend on neighbor degrees and community sizes, which a delta can
        shift beyond its own endpoints). That O(V+E) host term is the
        delta hot path's known cost floor — incremental features are the
        ROADMAP's serving scale-out item, not a claim this code makes."""
        from graphmine_tpu_torch.ops.features import standardize, vertex_features
        from graphmine_tpu_torch.ops.streaming_lof import StreamingLOF

        feats = standardize(
            vertex_features(graph, _device_labels(labels, graph),
                            include_clustering="sampled")
        ).cpu().numpy()
        grew = len(self.lof) < len(feats)
        if grew:
            # vertex growth: new vertices start at score 0 (fresh array —
            # concatenate never resizes in place)
            self.lof = np.concatenate([
                self.lof,
                np.zeros(len(feats) - len(self.lof), np.float32),
            ])
        k = min(self.lof_k, len(feats) - 2)
        if self._stream is None:
            if k < 1:
                # Too few vertices to LOF-score (k needs >= 1 real
                # neighbors): keep the existing scores and publish —
                # never crash the apply over an unscorable batch. The
                # bootstrap retries once the graph grows past the
                # threshold.
                return
            self._stream = StreamingLOF(
                k=k,
                capacity=min(self.lof_capacity, max(len(feats), self.lof_k + 2)),
                impl="ivf",
                sink=self.sink,
                centers=self._centers,
                device=self.device,
            )
            self.lof = np.array(self._stream.update(feats), np.float32)
            self._centers = self._stream._centers
            return
        if len(aff):
            # Copy-on-write: the last published Snapshot (and any
            # QueryEngine serving it) aliases self.lof, so an in-place
            # splice would mutate the live engine mid-apply — torn reads
            # under the double-buffer's no-torn-read guarantee. A growth
            # delta already rebuilt the column fresh above; nothing
            # published aliases that one, so skip the second O(V) copy.
            lof = self.lof if grew else self.lof.copy()
            lof[aff] = self._stream.update(feats[aff])
            self.lof = lof
        self._centers = self._stream._centers

    def apply(
        self, delta: EdgeDelta, lof_mode: str = "refresh", batches: int = 1,
        extra_meta: dict | None = None,
    ) -> Snapshot:
        """Validate, splice, repair, rescore and publish one delta batch.

        Returns the newly published snapshot (its ``parent`` is the
        snapshot this ingestor last published/loaded). Emits one
        ``delta_apply`` record carrying the quarantine counts, the repair
        method (warm vs fallback) and the per-stage outcome.

        ``lof_mode="defer"`` (admission rung 2, serve/admission.py):
        skip the per-delta LOF refresh — the dominant non-repair cost —
        and publish with the outlier column marked stale
        (``lof_stale`` manifest flag). Labels are NEVER deferred: repair
        plus the sampled exact check run unconditionally, so served
        labels stay verified. The deferred vertices accumulate and the
        next ``refresh`` apply re-scores the whole backlog.

        ``batches``: how many submitted delta batches this apply settles
        in the debt ledger (a coalesced apply settles its whole group).

        ``extra_meta``: extra manifest keys for the publish (the apply
        worker stamps the write-ahead log cursor this publish absorbs,
        ``wal_applied_seq`` / ``wal_applied_above``, so a crash between
        the publish and the log's commit cannot replay absorbed entries).
        """
        if lof_mode not in ("refresh", "defer"):
            raise ValueError(
                f"lof_mode must be 'refresh' or 'defer', got {lof_mode!r}"
            )
        t0 = time.perf_counter()
        span = (
            self.sink.span("delta_apply") if self.sink is not None
            else _null_ctx()
        )
        with span:
            # Parent snapshot's result columns, captured BEFORE the
            # repair overwrites them: the quality pass's drift baseline.
            # References, not copies — the LOF splice is copy-on-write
            # and labels are reassigned wholesale, so these stay the
            # parent's arrays.
            prev_labels, prev_lof = self.labels, self.lof
            prev_version = self.snapshot.version
            clean, quarantine = validate_delta(delta, self.num_vertices)
            if self.weights is not None:
                src2, dst2, w2, v2, stats = splice_edges(
                    self.src, self.dst, self.num_vertices, clean,
                    weights=self.weights,
                )
            else:
                src2, dst2, v2, stats = splice_edges(
                    self.src, self.dst, self.num_vertices, clean
                )
                w2 = None
            quarantine["unmatched_deletes"] += stats.pop("unmatched_deletes")
            from graphmine_tpu_torch.graph.container import build_graph

            graph = build_graph(
                src2, dst2, num_vertices=v2, edge_weights=w2,
                device=self.device,
            )
            t_r = time.perf_counter()
            result = self._repair(graph, clean)
            repair_seconds = time.perf_counter() - t_r
            self.src, self.dst, self.weights = src2, dst2, w2
            self.labels, self.cc_labels = result.labels, result.cc_labels
            aff = affected_vertices(clean)
            t_l = time.perf_counter()
            lof_stale = self._lof_pass(graph, result.labels, aff, lof_mode)
            lof_seconds = time.perf_counter() - t_l

            from graphmine_tpu_torch.ops.census import census_table

            present, sizes, edge_counts = census_table(
                _device_labels(result.labels, graph), graph
            )
            arrays = {
                "src": self.src,
                "dst": self.dst,
                "labels": self.labels,
                "cc_labels": self.cc_labels,
                "lof": self.lof,
                "census_present": np.asarray(present),
                "census_sizes": np.asarray(sizes),
                "census_edges": np.asarray(edge_counts),
            }
            if self.weights is not None:
                arrays["weights"] = self.weights
            if self._centers is not None:
                arrays["lof_centers"] = np.asarray(self._centers, np.float32)
            if self._canary is not None:
                # probe identity rides the store (the lof_centers
                # pattern): a restarted or promoted writer re-scores the
                # SAME frozen probe, so canary recall is comparable
                # across the whole version chain
                arrays.update(self._canary.arrays())
            snap = self.store.publish(
                arrays,
                fingerprint=graph_fingerprint(
                    self.src, self.dst, self.weights
                ),
                run_id=self.snapshot.meta.get("run_id", ""),
                mesh_shape=[self.num_shards],
                extra_meta={
                    **(extra_meta or {}),
                    **({"lof_stale": True} if lof_stale else {}),
                    **(
                        {"canary": self._canary.meta()}
                        if self._canary is not None else {}
                    ),
                } or None,
                sink=self.sink,
                epoch=self.epoch,
            )
            self.snapshot = snap
            if self.quality_enabled:
                # The result-quality pass: still inside the
                # delta_apply span, so quality_snapshot/quality_drift/
                # canary_score land span-joined to the publishing trace.
                # Bounded O(V) host work + the tiny frozen canary probe;
                # its seconds ride the quality_snapshot record (the
                # bench `quality_pass` sub-record measures the same
                # pass at three graph sizes).
                from graphmine_tpu_torch.obs.quality import run_quality_pass

                # The cached state is reusable only when it describes
                # the ACTUAL parent (a skipped/failed pass leaves it at
                # an older version — drift vs stale sketches would lie).
                parent_state = self._quality_state
                if (
                    parent_state is not None
                    and parent_state.version != prev_version
                ):
                    parent_state = None
                try:
                    report = run_quality_pass(
                        self.labels, self.lof, snap.version,
                        parent_labels=prev_labels, parent_lof=prev_lof,
                        parent_version=prev_version,
                        parent_state=parent_state,
                        canary=self._canary,
                        sink=self.sink,
                        device=self.device,
                        registry=(
                            self.sink.registry if self.sink is not None
                            else None
                        ),
                    )
                    self.last_quality = report
                    self._quality_state = report.state
                except Exception as e:  # noqa: BLE001 — telemetry only:
                    # a quality-pass crash must never fail (or appear to
                    # fail) a publish that already landed
                    if self.sink is not None:
                        self.sink.emit(
                            "warning",
                            message=f"quality pass failed: {e!r}",
                        )
            # Settle the debt ledger BEFORE emitting, so the record's
            # repair_debt snapshot reflects this apply as drained.
            self.debt.applied(
                method=result.method, iterations=result.iterations,
                budget=result.budget, batches=batches,
            )
            if self.sink is not None:
                self.sink.emit(
                    "delta_apply",
                    inserts=stats["inserted"],
                    deletes=stats["deleted"],
                    method=result.method,
                    iterations=result.iterations,
                    budget=result.budget,
                    quarantine=quarantine,
                    affected=len(aff),
                    version=snap.version,
                    num_vertices=v2,
                    num_edges=len(self.src),
                    batches=int(batches),
                    lof_mode=lof_mode,
                    lof_stale=bool(lof_stale),
                    seconds=round(time.perf_counter() - t0, 4),
                    # stage split: the repair-vs-recompute comparison the
                    # bench serve tier reports is the repair term; LOF
                    # refresh amortizes (full bootstrap only on the first
                    # apply of an ingestor's lifetime)
                    repair_seconds=round(repair_seconds, 4),
                    lof_seconds=round(lof_seconds, 4),
                    # the repair-debt ledger as of this publish — the
                    # obs_report SLO section's debt-timeline raw material
                    repair_debt=self.debt.snapshot(),
                )
        return snap

    def _lof_pass(
        self, graph, labels: np.ndarray, aff: np.ndarray, lof_mode: str
    ) -> bool:
        """Refresh — or defer — the LOF column for this apply. Returns
        whether the published column is stale. Deferred applies still
        pad the column for vertex growth (new vertices score 0, same as
        a refresh would seed them) so every published array stays
        [V]-aligned."""
        v = graph.num_vertices
        if lof_mode == "defer":
            if len(self.lof) < v:
                self.lof = np.concatenate(
                    [self.lof, np.zeros(v - len(self.lof), np.float32)]
                )
            self._stale_aff = np.union1d(self._stale_aff, aff.astype(np.int64))
            return True
        if self._stale_all:
            # loaded from an already-stale snapshot with no backlog
            # list: the only honest repair is re-scoring everything
            aff = np.arange(v, dtype=np.int64)
            self._stale_all = False
        elif len(self._stale_aff):
            aff = np.union1d(self._stale_aff, aff.astype(np.int64))
        self._stale_aff = np.empty(0, np.int64)
        self._refresh_lof(graph, labels, aff)
        return False


def _null_ctx():
    import contextlib

    return contextlib.nullcontext()
