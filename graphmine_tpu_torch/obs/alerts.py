"""Declarative alerting over gauges and quality records.

Counterpart of ``graphmine_tpu/obs/alerts.py``, with the same rules, rule
names, states and ``alert`` records. An :class:`AlertRule` is ``metric OP
threshold`` sustained for ``for_s`` seconds; the :class:`AlertManager`
evaluates every rule against a flat value dict on the serving layer's
existing cadences (``/healthz``, ``/alertz`` and ``/statusz`` reads, every
snapshot swap), with the state machine ``inactive -> pending -> firing ->
resolved`` and one ``alert`` record on each firing and resolved
transition. :func:`default_rules` reads every threshold from its
``GRAPHMINE_ALERT_*`` variable (a malformed value raises). Host-only.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from graphmine_tpu_torch.obs.sketch import env_float

__all__ = [
    "AlertManager",
    "AlertRule",
    "default_rules",
]

# Rule states.
INACTIVE = "inactive"     # condition false, never fired (or fully reset)
PENDING = "pending"       # condition true, for_s not yet sustained
FIRING = "firing"         # condition sustained — the alert
RESOLVED = "resolved"     # condition false again after firing

_OPS = {
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
}


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule: ``metric OP threshold`` for ``for_s``.

    ``severity``: ``"page"`` gates CI (``obs_report`` exits non-zero on
    a stream ending with one firing) and should be reserved for
    conditions that mean *served results are wrong* (the canary);
    ``"warn"`` is the drifting-but-investigate tier.
    """

    name: str
    metric: str               # key into the evaluate() value dict
    op: str                   # ">" or "<"
    threshold: float
    for_s: float = 0.0        # sustained-condition duration before firing
    severity: str = "warn"    # "warn" | "page"
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {self.op!r}")
        if self.for_s < 0:
            raise ValueError("for_s must be >= 0")
        if self.severity not in ("warn", "page"):
            raise ValueError(
                f"severity must be 'warn' or 'page', got {self.severity!r}"
            )

    def condition(self, value: float) -> bool:
        return _OPS[self.op](float(value), self.threshold)


def default_rules() -> list:
    """The quality plane's default rule set, every threshold
    ``GRAPHMINE_ALERT_*`` env-tunable (resolved at call time, so a
    server constructed under a test env sees the test thresholds):

    ====================  =====================================  ========
    rule                  fires when                             default
    ====================  =====================================  ========
    canary_recall_low     canary_recall < CANARY_RECALL          0.7
    lof_drift_high        quality_lof_psi > LOF_PSI              0.25
    size_drift_high       quality_size_psi > SIZE_PSI            0.25
    anomaly_rate_high     quality_anomaly_rate > ANOMALY_RATE    0.2
    ingest_lag_high       ingest_lag_s > INGEST_LAG_S            60.0
                          for INGEST_LAG_FOR_S                   5.0
    mem_headroom_low      memory_headroom_frac < MEM_HEADROOM    0.1
    ====================  =====================================  ========

    ``canary_recall_low`` is the one ``page``: the probe's features are
    frozen, so a recall drop is a scorer regression by construction —
    the alert infra metrics cannot raise.
    """
    return [
        AlertRule(
            "canary_recall_low", "canary_recall", "<",
            env_float("GRAPHMINE_ALERT_CANARY_RECALL", 0.7),
            severity="page",
            description="planted-anomaly canary recall collapsed: the "
            "LOF scorer regressed (RUNBOOKS §13)",
        ),
        AlertRule(
            "lof_drift_high", "quality_lof_psi", ">",
            env_float("GRAPHMINE_ALERT_LOF_PSI", 0.25),
            description="LOF score distribution shifted vs parent "
            "snapshot (PSI > threshold)",
        ),
        AlertRule(
            "size_drift_high", "quality_size_psi", ">",
            env_float("GRAPHMINE_ALERT_SIZE_PSI", 0.25),
            description="community size distribution shifted vs parent "
            "snapshot (PSI > threshold)",
        ),
        AlertRule(
            "anomaly_rate_high", "quality_anomaly_rate", ">",
            env_float("GRAPHMINE_ALERT_ANOMALY_RATE", 0.2),
            description="share of vertices scoring above the LOF "
            "threshold is abnormally high",
        ),
        AlertRule(
            "ingest_lag_high", "ingest_lag_s", ">",
            env_float("GRAPHMINE_ALERT_INGEST_LAG_S", 60.0),
            for_s=env_float("GRAPHMINE_ALERT_INGEST_LAG_FOR_S", 5.0),
            description="oldest accepted-but-unapplied delta is older "
            "than the lag bound",
        ),
        AlertRule(
            "mem_headroom_low", "memory_headroom_frac", "<",
            env_float("GRAPHMINE_ALERT_MEM_HEADROOM", 0.1),
            description="serve-process memory headroom below the low "
            "watermark — read the memory waterfall before shrinking the "
            "graph (RUNBOOKS §14)",
        ),
    ]


class _RuleState:
    __slots__ = ("rule", "state", "since", "last_value", "last_change",
                 "times_fired", "times_resolved")

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = INACTIVE
        self.since = 0.0           # when the current condition run began
        self.last_value: float | None = None
        self.last_change = 0.0
        self.times_fired = 0
        self.times_resolved = 0

    def snapshot(self) -> dict:
        r = self.rule
        return {
            "name": r.name,
            "state": self.state,
            "severity": r.severity,
            "metric": r.metric,
            "op": r.op,
            "threshold": r.threshold,
            "for_s": r.for_s,
            "value": self.last_value,
            "times_fired": self.times_fired,
            "times_resolved": self.times_resolved,
            "description": r.description,
        }


class AlertManager:
    """Evaluates a rule set against flat value dicts; owns the per-rule
    state machines; emits ``alert`` records on firing/resolved
    transitions; serves the ``/alertz`` level view.

    A metric ABSENT from a value dict leaves its rule's state untouched
    (a replica with no canary never fires — or resolves — the canary
    rule), which is why evaluation can safely run on partial views like
    ``/healthz``'s. Thread-safe: handler threads, the apply worker and
    the fleet prober all drive :meth:`evaluate` concurrently.
    """

    def __init__(
        self, rules=None, sink=None, registry=None, clock=None,
        tenant: str = "",
    ):
        self.rules = list(default_rules() if rules is None else rules)
        names = [r.name for r in self.rules]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.sink = sink
        self.registry = registry
        # Tenant-scoped manager: a non-empty tenant stamps
        # every alert record with the owner — tenant A's canary page
        # names A — and skips the unlabelled firing gauge (per-tenant
        # managers racing one gauge would be last-writer-wins noise;
        # the default manager, tenant="", keeps the fleet-facing gauge).
        self.tenant = tenant
        self._clock = clock if clock is not None else time.monotonic
        self._states = {r.name: _RuleState(r) for r in self.rules}
        self._lock = threading.Lock()

    # -- evaluation --------------------------------------------------------
    def evaluate(self, values: dict, now: float | None = None) -> list:
        """One pass over every rule; returns the transitions fired this
        pass as ``(name, from_state, to_state)`` triples. Emission
        happens OUTSIDE the state lock (a sink fsync must not serialize
        /healthz against the apply worker — the serve/admission.py
        discipline)."""
        now = self._clock() if now is None else now
        transitions = []
        emits = []  # (_RuleState, state, value, times_fired) captured
        # UNDER the lock: a concurrent evaluate may overwrite
        # st.last_value before the out-of-lock emission runs, and a
        # "firing" record carrying a value that doesn't satisfy its own
        # threshold would mislead the obs_report timeline.
        with self._lock:
            for st in self._states.values():
                rule = st.rule
                if rule.metric not in values:
                    continue
                value = values[rule.metric]
                if value is None:
                    continue
                st.last_value = float(value)
                cond = rule.condition(value)
                before = st.state
                if cond:
                    if st.state in (INACTIVE, RESOLVED):
                        st.state, st.since = PENDING, now
                    if st.state == PENDING and now - st.since >= rule.for_s:
                        st.state = FIRING
                        st.times_fired += 1
                else:
                    if st.state == PENDING:
                        st.state = INACTIVE
                    elif st.state == FIRING:
                        st.state = RESOLVED
                        st.times_resolved += 1
                if st.state != before:
                    st.last_change = now
                    transitions.append((rule.name, before, st.state))
                    if st.state == FIRING or (
                        st.state == RESOLVED and before == FIRING
                    ):
                        emits.append(
                            (st, st.state, st.last_value, st.times_fired)
                        )
        for st, state, value, times_fired in emits:
            self._emit(st, state, value, times_fired)
        self._export()
        return transitions

    def _emit(
        self, st: _RuleState, state: str, value: float, times_fired: int,
    ) -> None:
        if self.sink is None:
            return
        r = st.rule
        kv = {}
        if self.tenant:
            kv["tenant"] = self.tenant
        self.sink.emit(
            "alert",
            name=r.name,
            state=state,
            severity=r.severity,
            metric=r.metric,
            op=r.op,
            value=value,
            threshold=r.threshold,
            for_s=r.for_s,
            times_fired=times_fired,
            description=r.description,
            **kv,
        )

    def _export(self) -> None:
        if self.registry is None or self.tenant:
            return
        self.registry.gauge(
            "graphmine_alerts_firing", "alert rules currently firing"
        ).set(len(self.firing()))

    # -- level views -------------------------------------------------------
    def firing(self) -> list:
        """Names of rules currently firing."""
        with self._lock:
            return [
                s.rule.name for s in self._states.values()
                if s.state == FIRING
            ]

    def snapshot(self) -> dict:
        """The ``/alertz`` body: every rule's level state."""
        with self._lock:
            rules = [s.snapshot() for s in self._states.values()]
        return {
            "firing": sum(1 for r in rules if r["state"] == FIRING),
            "rules": rules,
        }
