"""String → dense int32 vertex-id factorization (host-side NumPy).

Counterpart of ``graphmine_tpu/io/factorize.py``, kept as a copy so the
port never imports the JAX package. Vertex ids come out dense and in
first-appearance order over the concatenated columns; every label the two
packages compute is a vertex id, so this order is what makes their outputs
comparable element by element.
"""

from __future__ import annotations

import numpy as np


def factorize(*columns: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
    """Map string columns to dense int32 codes over their *union* of values.

    Returns ``(codes, uniques)`` where ``codes[i]`` is the int32 code array
    for ``columns[i]`` and ``uniques`` is the vocabulary. Codes are assigned
    in first-appearance order over the concatenated columns.
    """
    if not columns:
        raise ValueError("factorize() needs at least one column")
    flat = np.concatenate([np.asarray(c) for c in columns])
    codes_flat, uniques = _factorize_first_appearance(flat)
    out, off = [], 0
    for c in columns:
        n = len(c)
        out.append(codes_flat[off : off + n].astype(np.int32))
        off += n
    return out, uniques


def _factorize_first_appearance(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    # np.unique sorts; remap so codes follow first appearance (the
    # insertion-order semantics of a hash-map interner).
    uniq_sorted, first_idx, inv = np.unique(values, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    codes = rank[inv].astype(np.int32)
    return codes, uniq_sorted[order]


class IncrementalFactorizer:
    """Streaming string -> dense int32 interner for batched ingestion.

    Each :meth:`add` call encodes one column batch, assigning new codes in
    first-appearance order *within the batch*. Peak memory is the
    vocabulary plus one batch.
    """

    def __init__(self):
        self._index: dict = {}
        self._names: list = []

    def add(self, column: np.ndarray) -> np.ndarray:
        codes_batch, uniques = _factorize_first_appearance(np.asarray(column))
        return self._intern_uniques(codes_batch, uniques)

    def add_dictionary(self, indices: np.ndarray, dictionary: np.ndarray) -> np.ndarray:
        """Encode a batch given as ``dictionary[indices]`` without building
        the per-row strings: equal to ``add(dictionary[indices])``, since a
        dictionary's values are unique, so first appearance over the index
        stream is first appearance over the values. Only the batch's
        distinct values touch Python."""
        codes_batch, uniq_idx = _factorize_first_appearance(np.asarray(indices))
        return self._intern_uniques(codes_batch, np.asarray(dictionary)[uniq_idx])

    def _intern_uniques(self, codes_batch, uniques) -> np.ndarray:
        lut = np.empty(len(uniques), dtype=np.int32)
        index, names = self._index, self._names
        for i, val in enumerate(uniques.tolist()):
            code = index.get(val)
            if code is None:
                code = len(names)
                index[val] = code
                names.append(val)
            lut[i] = code
        return lut[codes_batch].astype(np.int32)

    def names(self) -> np.ndarray:
        return np.asarray(self._names, dtype=object)
