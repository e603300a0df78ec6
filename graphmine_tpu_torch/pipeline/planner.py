"""Pre-allocation memory planner and plan-family selection.

Counterpart of ``graphmine_tpu/pipeline/planner.py``: :func:`plan_run`
picks the LPA schedule for (V, E, D) against the card's memory before
anything is allocated: ``single`` on one device, else ``replicated`` (the
full label vector on every shard, one all-gather a superstep) before
``ring`` (labels sharded); a requested schedule is checked, and a config
that cannot fit raises :class:`PlanError` with the numbers.
:func:`plan_superstep` resolves the superstep family (``sharded_2d`` on
a mesh, ``blocked``, ``bucketed`` or ``sort``, through the ops layer's
:func:`~graphmine_tpu_torch.ops.blocking.select_superstep_family`) with
its degradation rung, :func:`plan_lof` the LOF kNN family (``ivf`` or
``exact``) with the opposite family as its rung,
:func:`degradation_ladder` lists the memory rungs the driver walks
(``replicated`` steps to ``ring``) and :func:`elastic_device_ladder` the
halved meshes a device loss walks.

The byte model is :mod:`graphmine_tpu_torch.obs.memmodel`'s, counted from
the port's own buffers. The budget is the card's own memory
(``torch.cuda.get_device_properties(device).total_memory``) unless
``GRAPHMINE_HBM_BYTES`` overrides it; only a run off CUDA, which has no
device memory to budget, plans against a nominal 16 GiB.

One device has no elastic rung, so a device-loss error there raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

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
# The modeled per-device message count of a sharded schedule takes 12%
# slack for the width ladder's and the shard padding; partition_graph
# checks the exact count.
_SHARD_PAD_SLACK = 1.12

class PlanError(ValueError):
    """No operating point fits: raised at plan time, before any
    allocation."""


@dataclass(frozen=True)
class RunPlan:
    """Resolved execution plan for one LPA run."""

    schedule: str            # "single" | "replicated" | "ring"
    bytes_per_device: int    # modeled peak of the LPA operating point
    hbm_bytes: int           # the budget the plan was made against
    reason: str
    lpa_only: bool = False   # shard_graph_arrays drops the sort-body arrays
    estimates: dict = field(default_factory=dict)  # schedule -> bytes/device


def messages_per_device(schedule: str, num_edges: int, num_devices: int) -> int:
    """Modeled per-device message-array length of ``schedule``."""
    m = 2.0 * num_edges
    if schedule == "single" or num_devices <= 1:
        return int(m)
    return int(m / num_devices * _SHARD_PAD_SLACK)


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
    return memmodel.schedule_bytes_per_device(schedule, num_vertices, num_edges,
                                              num_devices, weighted)


def degradation_ladder(schedule: str, num_devices: int, family: str = "bucketed") -> list[str]:
    """The LPA operating points after resource exhaustion. One device: the
    blocked superstep steps down to ``single_bucketed`` (the tile and the
    stream arrays go, the bucketed plan is built) and then
    ``single_sort``, the bucketed one to ``single_sort`` (the padded plan
    matrices and their transients go), and sort is the floor. A mesh:
    ``replicated`` steps to ``ring`` (no replicated label vector), and
    ring is the floor."""
    if schedule == "single" or num_devices <= 1:
        return {"blocked": ["single_bucketed", "single_sort"], "sort": []}.get(
            family, ["single_sort"])
    if schedule == "replicated":
        return ["ring"]
    return []


def elastic_device_ladder(schedule: str, num_devices: int) -> list[int]:
    """The surviving-mesh rungs after a device loss: D//2, D//4, ..., 1
    (the survivors keep their memory, so the answer is a smaller mesh, not
    a leaner schedule; halving bounds the re-partitions to log D). One
    device has no mesh to shrink."""
    if schedule == "single" or num_devices <= 1:
        return []
    rungs, d = [], num_devices // 2
    while d >= 1:
        rungs.append(d)
        d //= 2
    return rungs


@dataclass(frozen=True)
class SuperstepPlan:
    """Resolved superstep family: ``family`` (``"sharded_2d"`` /
    ``"blocked"`` / ``"bucketed"`` / ``"sort"``) and ``degrade_to``, the
    family a resource failure steps down to: the 2-D family to the
    one-all-gather ``blocked`` one (its per-peer tables go), blocked to
    bucketed, bucketed to sort."""

    family: str
    degrade_to: str
    reason: str


_SUPERSTEP_DEGRADE = {"sharded_2d": "blocked", "blocked": "bucketed", "bucketed": "sort",
                      "sort": "sort"}


def plan_superstep(num_vertices: int, num_messages: int, requested: str = "auto",
                   weighted: bool = False, num_devices: int = 1) -> SuperstepPlan:
    """Resolve the LPA/CC superstep family at plan time, with its
    degradation rung; ``num_devices`` >= 2 (the serving repair's mesh)
    may resolve the ``sharded_2d`` family."""
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
    """Pick the LPA schedule for (V, E, D) against 90% of the per-device
    budget ``hbm``, or raise :class:`PlanError` with the numbers.
    ``"auto"`` takes the first schedule that fits in speed order: the
    single-device superstep on one device, else ``replicated``, else
    ``ring``. A requested schedule is honoured but still checked (on one
    device every request runs ``single``). ``estimates`` always holds
    ``single``: the driver reads it to decide whether the whole graph may
    also live on one device or must stay on the host (scale-out)."""
    if num_devices < 1:
        raise ValueError("num_devices must be >= 1")
    if requested not in ("auto", "single", "replicated", "ring"):
        raise ValueError(f"unknown schedule {requested!r}")
    budget = int((hbm if hbm is not None else hbm_bytes_per_device()) * _HBM_HEADROOM)
    candidates = ["single"] if num_devices == 1 else ["replicated", "ring"]
    est = {s: estimate_bytes_per_device(s, num_vertices, num_edges, num_devices, weighted)
           for s in dict.fromkeys(candidates + ["single"])}

    def _gb(b):
        return f"{b / (1 << 30):.2f} GiB"

    def _idx_ok(s):
        return messages_per_device(s, num_edges, num_devices) <= _INT32_MAX

    def _idx_error(s):
        mpd = messages_per_device(s, num_edges, num_devices)
        need_d = int(2.0 * num_edges * _SHARD_PAD_SLACK / _INT32_MAX) + 1
        return PlanError(
            f"message-index overflow: schedule '{s}' puts ~{mpd:,} messages on one device "
            f"for E={num_edges:,} on {num_devices} device(s), above the int32 index bound "
            f"{_INT32_MAX:,} of the device kernels; use >= {need_d} devices so every "
            "shard's messages fit int32"
        )

    if requested != "auto":
        sched = requested if num_devices > 1 else "single"
        if not _idx_ok(sched):
            raise _idx_error(sched)
        need = est[sched]
        if need > budget:
            fits = [s for s, b in est.items() if b <= budget]
            hint = (f"schedule '{fits[0]}' would fit ({_gb(est[fits[0]])})" if fits
                    else "no schedule fits; add devices or shrink the graph")
            raise PlanError(
                f"schedule '{sched}' needs {_gb(need)}/device for V={num_vertices:,} "
                f"E={num_edges:,} on {num_devices} device(s) — budget is {_gb(budget)} "
                f"(90% of {_gb(int(budget / _HBM_HEADROOM))}); {hint}"
            )
        return RunPlan(schedule=sched, bytes_per_device=need, hbm_bytes=budget,
                       reason=f"requested '{requested}' ({_gb(need)}/device fits)",
                       lpa_only=sched == "replicated", estimates=est)
    idx_blocked = [s for s in candidates if not _idx_ok(s)]
    for sched in candidates:
        if est[sched] <= budget and _idx_ok(sched):
            why = {
                "single": "one device: fused bucketed kernel",
                "replicated": "fastest multi-device schedule that fits",
                "ring": (f"replicated labels would not fit "
                         f"({_gb(est.get('replicated', 0))}/device); ring keeps labels sharded"),
            }[sched]
            return RunPlan(schedule=sched, bytes_per_device=est[sched], hbm_bytes=budget,
                           reason=why, lpa_only=sched == "replicated", estimates=est)
    if idx_blocked and all(est[s] <= budget for s in idx_blocked):
        raise _idx_error(idx_blocked[-1])
    detail = ", ".join(f"{s}={_gb(b)}" for s, b in est.items())
    raise PlanError(
        f"no LPA schedule fits V={num_vertices:,} E={num_edges:,} "
        f"{'weighted ' if weighted else ''}on {num_devices} device(s): modeled peak per "
        f"device {detail} vs budget {_gb(budget)} (90% of the card's memory). Add devices "
        "(the O(E) terms shard), or set GRAPHMINE_HBM_BYTES if the card has more memory."
    )
