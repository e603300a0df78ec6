"""Pre-allocation memory planner and plan-family selection, one device.

Counterpart of the single-device part of
``graphmine_tpu/pipeline/planner.py``: :func:`plan_run` checks the LPA
operating point against the card's memory before anything is allocated
(a config that cannot fit raises :class:`PlanError` with the numbers),
:func:`plan_superstep` resolves the superstep family (``blocked``,
``bucketed`` or ``sort``, through the ops layer's
:func:`~graphmine_tpu_torch.ops.blocking.select_superstep_family`) with
its degradation rung, :func:`plan_lof` the LOF kNN family
(``ivf`` or ``exact``) with the opposite family as its rung, and
:func:`degradation_ladder` lists the memory rungs the driver walks.

The byte model is :mod:`graphmine_tpu_torch.obs.memmodel`'s, counted from
the port's own buffers. The budget is the card's own memory
(``torch.cuda.get_device_properties(device).total_memory``) unless
``GRAPHMINE_HBM_BYTES`` overrides it; only a run off CUDA, which has no
device memory to budget, plans against a nominal 16 GiB.

The JAX package's multi-device schedules (``replicated``, ``ring``), its
``sharded_2d`` superstep family and the elastic device rungs are not
ported: asking for one raises :class:`PlanError` naming the
ROADMAP item that ports it, never a silent substitute. One device has no
elastic rung, so a device-loss error raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from graphmine_tpu_torch.obs import memmodel
from graphmine_tpu_torch.ops.blocking import (  # noqa: F401 — the planner's policy surface
    crossover_thresholds,
    select_superstep_family,
)

# Off CUDA there is no device memory: a nominal budget, the JAX package's
# default, keeps plans on the CPU comparable with its plans.
_DEFAULT_HBM = 16 * (1 << 30)
# Plan against 90% of the card: the caching allocator's fragmentation and
# the CUDA context live in the rest.
_HBM_HEADROOM = 0.9
_INT32_MAX = (1 << 31) - 1

# What is not ported, and the ROADMAP queue-1 item that ports it.
_NOT_PORTED = {
    "sharded_2d": "A7 (multi-device)",
    "replicated": "A7 (multi-device)",
    "ring": "A7 (multi-device)",
}


class PlanError(ValueError):
    """No operating point fits, or the request names one the port does
    not run: raised at plan time, before any allocation."""


def _not_ported(what: str, kind: str) -> PlanError:
    return PlanError(
        f"{kind} {what!r} is not ported to the single-device PyTorch driver; "
        f"it waits for ROADMAP queue 1 item {_NOT_PORTED[what]}"
    )


@dataclass(frozen=True)
class RunPlan:
    """Resolved execution plan for one LPA run."""

    schedule: str            # "single"
    bytes_per_device: int    # modeled peak of the LPA operating point
    hbm_bytes: int           # the budget the plan was made against
    reason: str


def device_hbm_bytes(device) -> int | None:
    """The card's memory in bytes (``total_memory``) for a CUDA
    ``device``; None for any other device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def hbm_bytes_per_device(device_bytes=None) -> int:
    """The memory the planner budgets against: ``GRAPHMINE_HBM_BYTES``,
    else ``device_bytes`` (an int, or a zero-arg callable queried only
    when the env var did not win, e.g. ``lambda: device_hbm_bytes(dev)``),
    else the nominal 16 GiB of a run off CUDA."""
    env = os.environ.get("GRAPHMINE_HBM_BYTES")
    if env:
        return int(env)
    if callable(device_bytes):
        device_bytes = device_bytes()
    if device_bytes:
        return int(device_bytes)
    return _DEFAULT_HBM


def estimate_bytes_per_device(schedule: str, num_vertices: int, num_edges: int,
                              num_devices: int, weighted: bool = False) -> int:
    """Modeled peak bytes of ``schedule`` (``memmodel``'s single owner)."""
    if schedule in _NOT_PORTED:
        raise _not_ported(schedule, "schedule")
    return memmodel.schedule_bytes_per_device(schedule, num_vertices, num_edges,
                                              num_devices, weighted)


def degradation_ladder(schedule: str, num_devices: int, family: str = "bucketed") -> list[str]:
    """The LPA operating points after resource exhaustion: the blocked
    superstep steps down to ``single_bucketed`` (the tile and the stream
    arrays go, the bucketed plan is built) and then ``single_sort``, the
    bucketed one to ``single_sort`` (the padded plan matrices and their
    transients go), and sort is the floor."""
    if schedule != "single" or num_devices != 1:
        raise _not_ported(schedule if schedule in _NOT_PORTED else "replicated", "schedule")
    if family in _NOT_PORTED:
        raise _not_ported(family, "superstep family")
    return {"blocked": ["single_bucketed", "single_sort"], "sort": []}.get(
        family, ["single_sort"])


@dataclass(frozen=True)
class SuperstepPlan:
    """Resolved superstep family: ``family`` (``"blocked"`` /
    ``"bucketed"`` / ``"sort"``) and ``degrade_to``, the family a resource
    failure steps down to."""

    family: str
    degrade_to: str
    reason: str


_SUPERSTEP_DEGRADE = {"blocked": "bucketed", "bucketed": "sort", "sort": "sort"}


def plan_superstep(num_vertices: int, num_messages: int, requested: str = "auto",
                   weighted: bool = False, num_devices: int = 1) -> SuperstepPlan:
    """Resolve the LPA/CC superstep family at plan time, with its
    degradation rung."""
    family, reason = select_superstep_family(num_vertices, num_messages, requested=requested,
                                             weighted=weighted, num_devices=num_devices)
    return SuperstepPlan(family=family, degrade_to=_SUPERSTEP_DEGRADE[family], reason=reason)


@dataclass(frozen=True)
class LofPlan:
    """Resolved LOF kNN family: ``impl`` (``"ivf"`` / ``"exact"``) and
    ``degrade_to``, always the other one."""

    impl: str
    degrade_to: str
    reason: str


def plan_lof(num_points: int, k: int, requested: str = "auto",
             ivf_min_points: int | None = None) -> LofPlan:
    """Resolve the LOF kNN family through the port's
    :func:`~graphmine_tpu_torch.ops.lof.select_lof_impl`, with the
    opposite family as the degradation rung."""
    from graphmine_tpu_torch.ops.lof import select_lof_impl

    family, reason = select_lof_impl(num_points, k, impl=requested,
                                     ivf_min_points=ivf_min_points)
    return LofPlan(impl=family, degrade_to="exact" if family == "ivf" else "ivf",
                   reason=reason)


def plan_run(num_vertices: int, num_edges: int, num_devices: int, weighted: bool = False,
             requested: str = "auto", hbm: int | None = None) -> RunPlan:
    """Check the single-device LPA operating point for (V, E) against 90%
    of the budget ``hbm``, or raise :class:`PlanError` with the numbers.
    ``requested`` is ``"auto"`` or ``"single"``; more than one device, or
    a multi-device schedule, raises (ROADMAP item A7)."""
    if num_devices < 1:
        raise ValueError("num_devices must be >= 1")
    if requested in _NOT_PORTED:
        raise _not_ported(requested, "schedule")
    if num_devices != 1:
        raise _not_ported("replicated", "schedule")
    if requested not in ("auto", "single"):
        raise ValueError(f"unknown schedule {requested!r}")
    budget = int((hbm if hbm is not None else hbm_bytes_per_device()) * _HBM_HEADROOM)
    need = estimate_bytes_per_device("single", num_vertices, num_edges, 1, weighted)

    def _gb(b):
        return f"{b / (1 << 30):.2f} GiB"

    if 2 * num_edges > _INT32_MAX:
        raise PlanError(
            f"message-index overflow: E={num_edges:,} gives {2 * num_edges:,} messages, "
            f"above the int32 index bound {_INT32_MAX:,} of the device kernels; "
            "sharding the messages waits for ROADMAP item A7"
        )
    if need > budget:
        raise PlanError(
            f"the single-device LPA needs {_gb(need)} for V={num_vertices:,} "
            f"E={num_edges:,}{' weighted' if weighted else ''} — budget is {_gb(budget)} "
            f"(90% of {_gb(int(budget / _HBM_HEADROOM))}); multi-device schedules wait "
            "for ROADMAP item A7, or set GRAPHMINE_HBM_BYTES if the card has more memory"
        )
    why = "one device: fused bucketed kernel" if requested == "auto" else \
        f"requested 'single' ({_gb(need)}/device fits)"
    return RunPlan(schedule="single", bytes_per_device=need, hbm_bytes=budget, reason=why)
