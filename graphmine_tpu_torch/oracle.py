"""GraphX ``LabelPropagation`` semantics oracle (host-side NumPy).

The port's own copy of ``graphmine_tpu/oracle.py`` (pure NumPy, the same
labels bit for bit); the rule named ``"smallest"`` below is the port's
``ops/segment.py::segment_mode`` tie-break as well.

The north star (BASELINE.json) asks for "matching GraphFrames community
IDs on bundled data". GraphFrames 0.6.0 delegates to GraphX's
``LabelPropagation.run`` (reached from the reference at
``Graphframes.py:81``), whose Pregel program is:

- initial label = vertex id;
- ``sendMessage`` emits ``(src, {dstLabel: 1})`` and ``(dst, {srcLabel: 1})``
  for every edge triplet — i.e. undirected propagation over the directed
  edge list, duplicate edges counted with multiplicity;
- ``mergeMessage`` sums the per-label counts (map union);
- ``vertexProgram`` keeps the current label on an empty message and
  otherwise takes ``message.maxBy(_._2)._1`` — the FIRST maximal entry in
  the merged map's iteration order;
- Pregel first applies the vertex program with an empty initial message
  (a no-op), then runs exactly ``maxSteps`` send→merge→apply rounds with
  no convergence test; vertices that receive no messages keep their label.

This module reproduces that structure exactly, with the tie-break as an
explicit parameter — because GraphX's own tie-break is NOT a fixed rule:

``maxBy`` iterates a ``scala.collection.immutable.Map`` whose iteration
order depends on its concrete type. Merged maps of ≤4 entries are
``Map1``..``Map4`` (insertion order — determined by the order Spark's
shuffle combiners merged partial maps, which depends on partitioning and
scheduling), larger ones are hash tries (order determined by the improved
key hash). Exact label-for-label GraphX parity on tie-heavy graphs is
therefore machine- and partitioning-dependent *in the reference stack
itself*; the well-defined validation target is partition agreement under
canonicalization with measured tie sensitivity (SURVEY §6 "hard parts").

Tie rules provided:

- ``"smallest"`` — deterministic smallest label (this engine's rule,
  ``ops/segment.py:segment_mode``): enables exact label-for-label parity
  checks between this oracle and the engine.
- ``"largest"`` — the opposite extreme, for tie-sensitivity bounds.
- ``"hash_order"`` — first max in Scala-2.11 ``HashMap`` trie iteration
  order (``improve(Long.##)`` hashed, 5-bit-chunk little-endian order):
  the order a large merged map would iterate in, i.e. the closest
  machine-independent approximation of GraphX's behavior.
"""

from __future__ import annotations

import numpy as np


def _scala_long_hashcode(v: np.ndarray) -> np.ndarray:
    """``java.lang.Long.hashCode``: ``(int)(value ^ (value >>> 32))``."""
    v = v.astype(np.int64)
    return (v ^ (v >> np.int64(32))).astype(np.uint32)


def _scala_improve(h: np.ndarray) -> np.ndarray:
    """Scala 2.11 ``immutable.HashMap.improve`` (bit-avalanche) on uint32."""
    h = h.astype(np.uint32)
    h = h + (~(h << np.uint32(9)))
    h = h ^ (h >> np.uint32(14))
    h = h + (h << np.uint32(4))
    h = h ^ (h >> np.uint32(10))
    return h


def scala_trie_order_key(labels: np.ndarray) -> np.ndarray:
    """Sort key reproducing Scala 2.11 ``HashMap`` trie iteration order.

    The trie consumes the improved hash in 5-bit chunks, least-significant
    first; siblings at each level iterate in ascending chunk value. The
    iteration order therefore compares keys lexicographically on the
    little-endian 5-bit digit sequence — equivalently, on the integer whose
    base-32 digits are reversed. uint64 holds the 7-digit reversal exactly.
    """
    h = _scala_improve(_scala_long_hashcode(labels)).astype(np.uint64)
    key = np.zeros_like(h)
    for i in range(7):  # ceil(32 / 5) digits
        key = (key << np.uint64(5)) | ((h >> np.uint64(5 * i)) & np.uint64(31))
    return key


def _tie_key(labels: np.ndarray, tie: str, rng) -> np.ndarray:
    if tie == "smallest":
        return labels.astype(np.uint64)
    if tie == "largest":
        return (np.iinfo(np.int64).max - labels).astype(np.uint64)
    if tie == "hash_order":
        return scala_trie_order_key(labels)
    if tie == "random":
        if labels.size == 0:
            return labels.astype(np.uint64)
        perm = rng.permutation(int(labels.max()) + 1).astype(np.uint64)
        return perm[labels]
    raise ValueError(f"unknown tie rule {tie!r}")


def graphx_label_propagation(
    src,
    dst,
    num_vertices: int,
    max_iter: int = 5,
    tie: str = "hash_order",
    seed: int = 0,
) -> np.ndarray:
    """Synchronous LPA with GraphX ``LabelPropagation.run`` structure.

    ``src``/``dst`` are int arrays of directed edge endpoints (duplicates
    kept, exactly as the reference builds them at ``Graphframes.py:70-74``).
    Returns int64 labels ``[num_vertices]``.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    v = int(num_vertices)
    rng = np.random.default_rng(seed)
    labels = np.arange(v, dtype=np.int64)

    # Both-direction message structure: receiver gets the sender's label.
    recv = np.concatenate([src, dst])
    send = np.concatenate([dst, src])

    for _ in range(max_iter):
        sent_labels = labels[send]
        # Count messages per (receiver, label) pair.
        pairs = recv * v + sent_labels
        uniq, cnt = np.unique(pairs, return_counts=True)
        r = uniq // v
        lab = uniq % v
        # vertexProgram: first maximal count in the tie rule's order.
        order = np.lexsort((_tie_key(lab, tie, rng), -cnt, r))
        r_sorted = r[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = r_sorted[1:] != r_sorted[:-1]
        new_labels = labels.copy()
        new_labels[r_sorted[first]] = lab[order][first]
        labels = new_labels
    return labels


def canonical_partition(labels) -> np.ndarray:
    """Host-side canonicalization: dense ids ordered by first member vertex
    (the NumPy twin of ``ops.lpa.canonicalize`` for oracle comparisons)."""
    labels = np.asarray(labels)
    v = labels.shape[0]
    first_member = np.full(v, v, dtype=np.int64)
    np.minimum.at(first_member, labels, np.arange(v, dtype=np.int64))
    rep = first_member[labels]
    _, dense = np.unique(rep, return_inverse=True)
    return dense.astype(np.int32)
