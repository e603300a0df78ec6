"""Mergeable quantile sketches over fixed log ladders, and their drift.

Counterpart of ``graphmine_tpu/obs/sketch.py``: a :class:`QuantileSketch`
is a bucket histogram over a log-spaced ladder of values (LOF scores,
community sizes); sketches on one ladder serialize to JSON
(:meth:`~QuantileSketch.to_state`) and compare by the population
stability index (:func:`psi_distance`).
"""

from __future__ import annotations

import math
import os

from graphmine_tpu_torch.obs.histogram import Histogram


def env_float(name: str, default: float) -> float:
    """``$name`` as a float, ``default`` when unset; malformed raises."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError as e:
        raise ValueError(f"{name}={raw!r} is not a float") from e


def log_ladder(lo: float, hi: float, steps_per_octave: int = 1) -> tuple:
    """Geometric bounds ``lo * 2**(i / steps_per_octave)`` from ``lo`` to
    at least ``hi``."""
    lo, hi = float(lo), float(hi)
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi (got lo={lo}, hi={hi})")
    if steps_per_octave < 1:
        raise ValueError("steps_per_octave must be >= 1")
    n = math.ceil(math.log2(hi / lo) * steps_per_octave)
    return tuple(lo * 2 ** (i / steps_per_octave) for i in range(n + 1))


# LOF scores: quarter octaves from 1/16 to 64; community sizes: octaves
# from 1 to 2^30.
DEFAULT_SCORE_LADDER = log_ladder(0.0625, 64.0, steps_per_octave=4)
DEFAULT_SIZE_LADDER = log_ladder(1.0, float(1 << 30), steps_per_octave=1)

# Probability floor of the PSI log-ratio: an empty bucket adds a large
# finite term, not an infinite one.
PSI_EPS = 1e-4


class QuantileSketch(Histogram):
    """A value-domain bucket histogram over one fixed log ladder, with
    bulk ingestion of pre-binned counts and a JSON state."""

    def __init__(self, name: str = "sketch", help: str = "",
                 buckets=DEFAULT_SCORE_LADDER, labels: dict | None = None):
        super().__init__(name, help, buckets, labels=labels)

    def add_counts(self, counts, total: float = 0.0) -> "QuantileSketch":
        """Deposit one count per finite bound plus the overflow bucket;
        ``total`` accrues into the running sum."""
        counts = [int(c) for c in counts]
        if len(counts) != len(self._bounds) + 1:
            raise ValueError(
                f"counts has {len(counts)} buckets for a "
                f"{len(self._bounds)}-bound ladder (+1 overflow)"
            )
        if any(c < 0 for c in counts):
            raise ValueError("bucket counts must be non-negative")
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += float(total)
        return self

    def to_state(self) -> dict:
        """``{bounds, counts, sum, count}``, JSON-ready."""
        snap = self.snapshot()
        return {"bounds": [float(b) for b in snap.bounds],
                "counts": [int(c) for c in snap.counts],
                "sum": float(snap.sum), "count": int(snap.count)}

    @classmethod
    def from_state(cls, state: dict, name: str = "sketch") -> "QuantileSketch":
        """Rebuild a sketch from :meth:`to_state` output (a record field, a
        replica's ``/alertz`` body); malformed state raises ValueError, so
        a router merging replica sketches refuses a torn payload."""
        try:
            bounds = tuple(float(b) for b in state["bounds"])
            counts = [int(c) for c in state["counts"]]
            total = float(state.get("sum", 0.0))
            sk = cls(name=name, buckets=bounds)
            sk.add_counts(counts, total=total)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed sketch state: {e!r}") from e
        return sk


def _state_of(sketch) -> tuple:
    """``(bounds, counts)`` of a sketch or of a ``to_state`` dict."""
    if isinstance(sketch, Histogram):
        snap = sketch.snapshot()
        return tuple(snap.bounds), list(snap.counts)
    try:
        return (tuple(float(b) for b in sketch["bounds"]),
                [int(c) for c in sketch["counts"]])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed sketch state: {e!r}") from e


def psi_distance(a, b, eps: float = PSI_EPS) -> float:
    """Population stability index ``sum_i (p_i - q_i) ln(p_i / q_i)`` of
    two sketches on one ladder, proportions floored at ``eps``; 0.0 for
    two empty sketches; mismatched ladders raise."""
    bounds_a, counts_a = _state_of(a)
    bounds_b, counts_b = _state_of(b)
    if bounds_a != bounds_b:
        raise ValueError(
            f"cannot compare sketches with different ladders "
            f"({len(bounds_a)} vs {len(bounds_b)} bounds)"
        )
    tot_a, tot_b = sum(counts_a), sum(counts_b)
    if tot_a == 0 and tot_b == 0:
        return 0.0
    psi = 0.0
    for ca, cb in zip(counts_a, counts_b):
        p = max(ca / tot_a if tot_a else 0.0, eps)
        q = max(cb / tot_b if tot_b else 0.0, eps)
        psi += (p - q) * math.log(p / q)
    return psi
