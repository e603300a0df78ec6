"""Batched query engine over a loaded result snapshot (PyTorch).

Counterpart of ``graphmine_tpu/serve/query.py``. Every query is O(1) or
O(log n) against indexes built once at snapshot load:

- ``membership`` / ``score`` / ``community_size`` / ``community_decile``:
  one array index;
- ``neighbors``: one slice of the message CSR, rebuilt on the host from
  the snapshot's edge arrays with the graph container's ``_message_csr``
  on the CPU (the JAX host CSR's order: receivers ascending, senders in
  message order);
- ``top_outliers(community, k)``: one binary search and a k-slice of the
  (label asc, LOF desc)-sorted vertex order;
- ``query_batch``: a whole vector of ids resolves in one index gather
  over a stacked int32 ``[3, V]`` table plus the float32 LOF column on the
  engine's device, and one copy to the host. The JAX package pads batches
  to powers of two to bound its traces; nothing here is traced, so there
  is no pad, but the ``pad`` stage key stays (it times the validation).
  ``device=False`` keeps the JAX host twin of the table.
"""

from __future__ import annotations

import threading
import time

import numpy as np

import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.serve.snapshot import Snapshot


def _as_int_ids(values, what: str) -> np.ndarray:
    """Coerce wire input to an int64 id array. Integral floats are
    accepted (JSON encoders routinely emit ``40.0`` for 40); fractional,
    non-finite or non-numeric ids raise ValueError (the HTTP layer's
    400) — never a TypeError crash, never a silent truncation of ``1.9``
    to id ``1``. Shared by the query and delta wire paths so the two can
    never drift on what counts as a valid id."""
    try:
        arr = np.asarray(values)
    except TypeError as e:
        raise ValueError(f"{what} must be an array of integers ({e})") from e
    if arr.size == 0 or np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.int64)
    if (
        np.issubdtype(arr.dtype, np.floating)
        and np.isfinite(arr).all()
        and (arr == np.floor(arr)).all()
    ):
        return arr.astype(np.int64)
    raise ValueError(f"{what} ids must be integers (got dtype {arr.dtype})")


class QueryEngine:
    """Immutable per-snapshot read index. Thread-safe by construction
    (nothing mutates after ``__init__`` — the one exception is the
    lock-guarded stage-timing accumulator, which is advisory telemetry,
    never read by a query), which is what lets the server double-buffer:
    in-flight requests keep serving the engine they grabbed while a
    delta publish swaps the reference under them."""

    def __init__(self, snapshot: Snapshot, device=None):
        """``device``: where the batched gather's table lives (CUDA
        unless the caller names another device); ``False`` keeps the
        table on the host, as the JAX engine's ``device=False``."""
        self.snapshot = snapshot
        # Stage-split accounting for the batched path: host wall-clock
        # around pad (validation; the JAX engine also pads here), gather
        # (the device gather and the copy to the host, the sync point)
        # and host (response assembly). Zero added device syncs.
        self._stage_lock = threading.Lock()
        self._stages = {
            "batches": 0, "ids": 0,
            "pad_seconds": 0.0, "gather_seconds": 0.0, "host_seconds": 0.0,
        }
        # Deferred-LOF staleness (admission rung 2, serve/admission.py):
        # when the publish skipped the outlier refresh under write
        # pressure, results carry this flag so readers can tell a fresh
        # score from one that predates the latest deltas.
        self.lof_stale = bool(snapshot.meta.get("lof_stale", False))
        # Result-quality plane (docs/OBSERVABILITY.md "Result quality"):
        # the anomaly threshold /explain verdicts use, and a lazily-
        # built-once QualityState (sketches + census scalars) served on
        # /statusz and /alertz and merged fleet-wide by the router.
        from graphmine_tpu_torch.obs.quality import lof_threshold

        self._lof_threshold = lof_threshold()
        self._quality_state = None
        self._explain_idx = None   # lazy /explain side index
        self._quality_lock = threading.Lock()
        self.labels = np.asarray(snapshot["labels"], np.int32)
        v = len(self.labels)
        self.num_vertices = v
        self.cc_labels = np.asarray(
            snapshot.get("cc_labels", self.labels), np.int32
        )
        lof = snapshot.get("lof")
        self.lof = (
            np.zeros(v, np.float32) if lof is None
            else np.asarray(lof, np.float32)
        )

        # neighbors: the message CSR over the snapshot's edge arrays
        # (both directions, multiplicity kept — the same adjacency LPA
        # propagated over). Host-side; one O(E) build per load.
        from graphmine_tpu_torch.graph.container import _message_csr, _prepare_edges

        src, dst, _ = _prepare_edges(snapshot["src"], snapshot["dst"], v)
        ptr, _, send, _ = _message_csr(torch.from_numpy(src), torch.from_numpy(dst), v,
                                       symmetric=True)
        ptr = ptr.numpy()
        self._nbr_ptr = ptr.astype(np.int32) if (len(ptr) == 0 or ptr[-1] < 1 << 31) else ptr
        self._nbr = send.numpy()

        # community census: sizes per present community + size deciles
        if "census_sizes" in snapshot.arrays:
            self._present = np.asarray(snapshot["census_present"], np.int64)
            self._sizes = np.asarray(snapshot["census_sizes"], np.int64)
        else:
            counts = np.bincount(self.labels, minlength=v)
            self._present = np.flatnonzero(counts).astype(np.int64)
            self._sizes = counts[self._present].astype(np.int64)
        size_of = np.zeros(v, np.int64)
        size_of[self._present] = self._sizes
        self._size_by_vertex = size_of[self.labels].astype(np.int32)
        self._sizes_sorted = np.sort(self._sizes)

        # top-k outliers per community: vertices sorted (label asc, LOF
        # desc) once; each community is then one contiguous block whose
        # start binary-searches in O(log C).
        order = np.lexsort((-self.lof, self.labels))
        self._by_comm = order.astype(np.int64)
        sorted_labels = self.labels[order].astype(np.int64)
        self._block_labels, self._block_starts = np.unique(
            sorted_labels, return_index=True
        )

        self._dev = None
        self._table = None
        if device is False:
            # host twin of the device table, built ONCE (a per-call
            # np.stack would memcpy 3x[V] ints on every batch)
            self._table = np.stack(
                [self.labels, self.cc_labels, self._size_by_vertex]
            )
        else:
            dev = resolve_device(device)
            # built whole before the engine is published: a server swaps
            # engines by one reference assignment, so no reader sees a
            # half-copied table
            self._dev = (
                torch.from_numpy(np.stack(
                    [self.labels, self.cc_labels, self._size_by_vertex]
                )).to(dev),
                torch.from_numpy(np.ascontiguousarray(self.lof)).to(dev),
            )
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @property
    def version(self) -> int:
        return self.snapshot.version

    def memory_bytes(self) -> dict:
        """Host-side byte accounting of this engine: the
        snapshot's array payload vs the DERIVED query index (adjacency
        CSR, census columns, per-vertex size map, the stacked gather
        table) — the two components a serve process deliberately holds,
        so a growing RSS decomposes into "the graph grew" vs "the index
        grew" from /statusz alone. Engines are immutable, so the counts
        are stable for this served version (the lazy /explain side
        index is counted when built)."""
        # np.asarray on an already-right-dtype snapshot array returns the
        # SAME object (and cc_labels falls back to labels when absent):
        # count each underlying buffer once, and never re-count a buffer
        # the snapshot accounting already covers — otherwise a label-heavy
        # snapshot reads 2-3x its real RSS contribution across the split.
        seen = set()
        for a in self.snapshot.arrays.values():
            seen.add(id(a))
            if getattr(a, "base", None) is not None:
                seen.add(id(a.base))
        idx = 0
        arrays = []
        for name in (
            "labels", "cc_labels", "lof", "_nbr_ptr", "_nbr", "_present",
            "_sizes", "_size_by_vertex", "_sizes_sorted", "_by_comm",
            "_block_labels", "_block_starts", "_table", "_explain_idx",
        ):
            a = getattr(self, name, None)
            if isinstance(a, tuple):  # the lazy /explain index is a pair
                arrays.extend(a)
            elif a is not None:
                arrays.append(a)
        for a in arrays:
            if not hasattr(a, "nbytes"):
                continue
            base = a.base if getattr(a, "base", None) is not None else a
            if id(a) in seen or id(base) in seen:
                continue
            seen.add(id(a))
            seen.add(id(base))
            idx += int(a.nbytes)
        return {
            "snapshot_bytes": self.snapshot.nbytes,
            "index_bytes": idx,
        }

    def quality_state(self, build: bool = True):
        """This snapshot's :class:`~graphmine_tpu_torch.obs.quality.QualityState`, built ONCE on first read (engines are immutable
        and die at snapshot swap, so the state can never go stale) —
        the /statusz "quality" section and the router's fleet-merge
        source. Lazy: a replica nobody asks never pays the O(V) pass.
        ``build=False`` returns only an already-built state (else None)
        — the /healthz alert pass reads through here, and a liveness
        probe must never be the thing that pays the O(V) build (the
        probe would time out on exactly the replicas swapping snapshots
        fastest)."""
        with self._quality_lock:
            if self._quality_state is None and build:
                from graphmine_tpu_torch.obs.quality import QualityState

                self._quality_state = QualityState.from_arrays(
                    self.labels, self.lof, version=self.version,
                    threshold=self._lof_threshold,
                )
            return self._quality_state

    def stage_snapshot(self) -> dict:
        """Accumulated batched-path stage split since this engine was
        built (engines die at snapshot swap, so the window is one served
        version): batches/ids resolved and pad/gather/host seconds —
        ``/statusz`` serves it so a p99 spike triages to the stage that
        actually moved (RUNBOOKS §7) instead of "the device is slow"."""
        with self._stage_lock:
            out = dict(self._stages)
        for k in ("pad_seconds", "gather_seconds", "host_seconds"):
            out[k] = round(out[k], 6)
        return out

    # -- single lookups ----------------------------------------------------
    def _check(self, vertex: int) -> int:
        vertex = int(vertex)
        if not 0 <= vertex < self.num_vertices:
            raise KeyError(
                f"vertex {vertex} not in [0, {self.num_vertices})"
            )
        return vertex

    def membership(self, vertex: int) -> int:
        """Community label of one vertex."""
        return int(self.labels[self._check(vertex)])

    def component(self, vertex: int) -> int:
        """Weakly-connected-component label of one vertex."""
        return int(self.cc_labels[self._check(vertex)])

    def score(self, vertex: int) -> float:
        """LOF outlier score of one vertex (higher = more outlying)."""
        return float(self.lof[self._check(vertex)])

    def community_size(self, vertex: int) -> int:
        """Vertex count of the community ``vertex`` belongs to."""
        return int(self._size_by_vertex[self._check(vertex)])

    def community_decile(self, vertex: int) -> int:
        """Size decile (0-9) of the vertex's community among all present
        communities — 0 = smallest tenth (the recursive-LPA outlier
        criterion's bottom decile), 9 = largest."""
        size = self._size_by_vertex[self._check(vertex)]
        n = len(self._sizes_sorted)
        if not n:
            return 0
        rank = int(np.searchsorted(self._sizes_sorted, size, side="right"))
        return min(9, 10 * (rank - 1) // n)

    def neighbors(self, vertex: int) -> np.ndarray:
        """Message-neighbor ids of one vertex (both edge directions,
        multiplicity kept) — one CSR row slice."""
        vertex = self._check(vertex)
        return self._nbr[self._nbr_ptr[vertex]: self._nbr_ptr[vertex + 1]]

    def _explain_index(self):
        """Lazily-built-once /explain side index (the quality_state
        lifecycle: engines are immutable and die at swap): the inverse
        permutation of the (label asc, LOF desc) vertex order — making
        rank-in-community one subtraction — and the sorted LOF column
        for O(log V) percentile lookups. Without it every /explain
        would scan the full LOF column; a dashboard walking a firing
        alert's top-k would pay O(kV)."""
        with self._quality_lock:
            if self._explain_idx is None:
                pos = np.empty(self.num_vertices, np.int64)
                pos[self._by_comm] = np.arange(self.num_vertices)
                self._explain_idx = (pos, np.sort(self.lof))
            return self._explain_idx

    def explain(self, vertex: int, max_neighbors: int = 32) -> dict:
        """Per-vertex outlier explanation — the triage companion to a
        firing canary/drift alert (RUNBOOKS §13): everything the engine's
        existing indexes say about WHY this vertex scores the way it
        does, in one read — O(log V + deg) against indexes built at
        load plus a lazily-built-once side index (:meth:`_explain_index`):
        LOF/label columns, the census tables, the neighbor CSR and the
        (label asc, LOF desc) community blocks.

        Fields: the vertex row (label/component/LOF/size/decile), its
        LOF rank within its community and global score percentile, and
        degree + up to ``max_neighbors`` neighbor ids with their scores'
        mean/max (an outlier whose neighbors also score high is a
        shifted REGION — drift — not a point anomaly). Per-vertex
        k-distances are NOT served: the streaming scorer's window does
        not cover all V, so no snapshot column holds them.
        """
        vertex = self._check(vertex)
        nbrs = self.neighbors(vertex)
        label = int(self.labels[vertex])
        score = float(self.lof[vertex])
        pos_in_order, lof_sorted = self._explain_index()
        # rank of this vertex inside its community's LOF-desc block:
        # its position in the global (label asc, LOF desc) order minus
        # the block start — one array read, no block scan
        i = int(np.searchsorted(self._block_labels, label))
        start = int(self._block_starts[i])
        rank_in_comm = int(pos_in_order[vertex]) - start
        out = {
            "vertex": int(vertex),
            "label": label,
            "component": int(self.cc_labels[vertex]),
            "lof": score,
            "lof_stale": self.lof_stale,
            "community_size": int(self._size_by_vertex[vertex]),
            "community_decile": self.community_decile(vertex),
            "lof_rank_in_community": rank_in_comm,
            "community_top_lof": float(self.lof[self._by_comm[start]]),
            # global percentile of this score (1.0 = the most outlying)
            "lof_percentile": round(
                float(np.searchsorted(lof_sorted, score, side="right"))
                / max(1, len(lof_sorted)), 4
            ),
            "anomaly": bool(score > self._lof_threshold),
            "lof_threshold": self._lof_threshold,
            "degree": int(len(nbrs)),
            "neighbors": nbrs[:max_neighbors],
            "neighbors_truncated": bool(len(nbrs) > max_neighbors),
        }
        if len(nbrs):
            nscores = self.lof[nbrs]
            out["neighbor_lof_mean"] = round(float(nscores.mean()), 4)
            out["neighbor_lof_max"] = round(float(nscores.max()), 4)
        return out

    def top_outliers(self, community: int, k: int = 10):
        """Top-``k`` LOF outliers of one community:
        ``[(vertex, score), ...]`` descending. O(log C) block lookup +
        an O(k) slice."""
        i = np.searchsorted(self._block_labels, int(community))
        if i >= len(self._block_labels) or self._block_labels[i] != community:
            raise KeyError(f"community {community} has no members")
        start = self._block_starts[i]
        end = (
            self._block_starts[i + 1] if i + 1 < len(self._block_starts)
            else len(self._by_comm)
        )
        block = self._by_comm[start: min(end, start + max(int(k), 0))]
        return [(int(vtx), float(self.lof[vtx])) for vtx in block]

    # -- batched path ------------------------------------------------------
    def query_batch(self, vertices) -> dict:
        """Resolve a vector of vertex ids in one device gather.

        Returns ``{"vertex", "label", "component", "community_size",
        "lof"}`` as aligned arrays. Out-of-range ids raise (the HTTP
        layer turns that into a 400, never a wrong answer).
        """
        t0 = time.perf_counter()
        ids = _as_int_ids(vertices, "vertex").reshape(-1)
        if len(ids) and (ids.min() < 0 or ids.max() >= self.num_vertices):
            bad = ids[(ids < 0) | (ids >= self.num_vertices)]
            raise KeyError(
                f"{len(bad)} vertex id(s) not in [0, {self.num_vertices}): "
                f"{bad[:5].tolist()}..."
            )
        if self._dev is not None:
            t1 = time.perf_counter()
            table, lof_col = self._dev
            idx = torch.from_numpy(ids).to(table.device)
            # one gather of the [3, V] table and the LOF column, one copy
            # to the host (the copy is the sync point)
            ints = table[:, idx].cpu().numpy()
            lof = lof_col[idx].cpu().numpy()
        else:
            t1 = time.perf_counter()
            ints, lof = self._table[:, ids], self.lof[ids]
        t2 = time.perf_counter()
        out = {
            "vertex": ids,
            "label": ints[0],
            "component": ints[1],
            "community_size": ints[2],
            "lof": lof,
        }
        t3 = time.perf_counter()
        with self._stage_lock:
            self._stages["batches"] += 1
            self._stages["ids"] += len(ids)
            self._stages["pad_seconds"] += t1 - t0
            self._stages["gather_seconds"] += t2 - t1
            self._stages["host_seconds"] += t3 - t2
        return out
