"""Tenancy of the serving plane: tenant ids and the tenant registry.

Counterpart of ``graphmine_tpu/serve/tenancy.py``, whole. Tenant ids
become path components under ``<root>/tenants/``, so the grammar
(:data:`TENANT_RE`) admits no separators and no dots; a malformed id
raises ``ValueError`` (HTTP 400), a valid id with no store namespace
:class:`UnknownTenantError` (HTTP 404). :class:`TenantRegistry` holds the
tenants a server has served, their admission-bound overrides
(``GRAPHMINE_TENANT_BOUNDS``, a JSON object of tenant id to
``AdmissionBounds`` keys) and their resident snapshot bytes; the server
keeps its state per tenant, the default tenant included.
"""

from __future__ import annotations

import json
import os
import re
import threading

DEFAULT_TENANT = "default"

# Tenant ids become path components and durable record values; the
# grammar is hostile-input-proof by construction — no separators, no
# dots, nothing a path traversal can ride. fullmatch only.
TENANT_RE = re.compile(r"[a-z0-9_-]{1,64}")

_ENV_BOUNDS = "GRAPHMINE_TENANT_BOUNDS"


class UnknownTenantError(KeyError):
    """A syntactically valid tenant id with no store namespace behind it.

    Distinct from ``ValueError`` (a hostile/malformed id — HTTP 400) on
    purpose: the serve middleware maps THIS to **404**, the same answer
    a valid vertex id under the wrong tenant gets — existence of other
    tenants' data must never be distinguishable from a miss."""


def validate_tenant_id(tenant) -> str:
    """Return ``tenant`` if it matches the tenant-id grammar; raise
    ``ValueError`` (the serve middleware's 400) otherwise. The check is
    ``fullmatch`` on purpose: a prefix-valid id like ``a/../b`` must
    die here, never reach ``os.path.join``."""
    if not isinstance(tenant, str) or not TENANT_RE.fullmatch(tenant):
        raise ValueError(
            f"invalid tenant id {tenant!r}: tenant ids must match "
            "[a-z0-9_-]{1,64}"
        )
    return tenant


class TenantRegistry:
    """Known tenants + per-tenant admission policy + per-tenant bytes.

    Thread-safe; one instance per server (the fleet router keeps none —
    tenancy is replica state, the router only relays the header). The
    registry is deliberately *not* the source of truth for which tenants
    exist on disk — :meth:`SnapshotStore.list_tenants
    <graphmine_tpu_torch.serve.snapshot.SnapshotStore.list_tenants>` is — it
    tracks the tenants THIS process has served plus any with explicit
    overrides, so an empty store still answers policy questions.
    """

    def __init__(self, overrides: dict | None = None):
        self._lock = threading.Lock()
        self._overrides: dict[str, dict] = {}
        self._nbytes: dict[str, int] = {}
        self._known: set[str] = {DEFAULT_TENANT}
        env = os.environ.get(_ENV_BOUNDS, "")
        if env:
            try:
                parsed = json.loads(env)
                if not isinstance(parsed, dict):
                    raise ValueError("not a JSON object")
            except ValueError as e:
                raise ValueError(
                    f"{_ENV_BOUNDS} must be a JSON object mapping tenant id "
                    f"to an AdmissionBounds override dict: {e}"
                ) from e
            for tid, kv in parsed.items():
                self.set_overrides(tid, **dict(kv))
        for tid, kv in (overrides or {}).items():
            self.set_overrides(tid, **dict(kv))

    # -- enumeration -------------------------------------------------------
    def note(self, tenant: str) -> str:
        """Record that ``tenant`` exists (validated); returns the id."""
        tenant = validate_tenant_id(tenant)
        with self._lock:
            self._known.add(tenant)
        return tenant

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._known)

    # -- per-tenant admission policy ---------------------------------------
    def set_overrides(self, tenant: str, **bounds) -> None:
        """Replace ``tenant``'s AdmissionBounds overrides (validated
        keys happen at ``bounds_for`` time, where AdmissionBounds'
        dataclass signature is the schema)."""
        tenant = validate_tenant_id(tenant)
        with self._lock:
            self._known.add(tenant)
            if bounds:
                self._overrides[tenant] = dict(bounds)
            else:
                self._overrides.pop(tenant, None)

    def bounds_for(self, tenant: str):
        """The tenant's :class:`AdmissionBounds`: the shared env/default
        ladder with this tenant's overrides applied on top. Import is
        lazy to keep this module stdlib-only (snapshot.py imports it,
        and admission → delta → snapshot would otherwise cycle)."""
        from graphmine_tpu_torch.serve.admission import AdmissionBounds

        tenant = validate_tenant_id(tenant)
        with self._lock:
            kv = dict(self._overrides.get(tenant, {}))
        return AdmissionBounds.from_env(**kv)

    def overrides_for(self, tenant: str) -> dict:
        tenant = validate_tenant_id(tenant)
        with self._lock:
            return dict(self._overrides.get(tenant, {}))

    # -- packing oracle ----------------------------------------------------
    def note_bytes(self, tenant: str, nbytes: int) -> None:
        """Record ``tenant``'s resident snapshot payload bytes (the
        server calls this on every engine swap)."""
        tenant = validate_tenant_id(tenant)
        with self._lock:
            self._known.add(tenant)
            self._nbytes[tenant] = int(nbytes)

    def bytes_by_tenant(self) -> dict[str, int]:
        with self._lock:
            return dict(self._nbytes)

    def memory_payload(self, budget_bytes: int | None) -> dict:
        """The packing-oracle view for ``/statusz``: per-tenant resident
        snapshot bytes against the ONE fleet-wide serve memory budget.
        ``fits`` answers "could I add tenant X's bytes to this replica"
        for a balancer; headroom stays fleet-wide because the budget
        is the machine's, not a tenant's."""
        with self._lock:
            per = dict(self._nbytes)
        total = int(sum(per.values()))
        out = {
            "tenants": {t: int(b) for t, b in sorted(per.items())},
            "total_snapshot_bytes": total,
        }
        if budget_bytes:
            out["budget_bytes"] = int(budget_bytes)
            out["headroom_bytes"] = int(budget_bytes) - total
            out["fits"] = total <= int(budget_bytes)
        return out

    def snapshot(self) -> dict:
        """Introspection payload (``/statusz`` ``tenancy`` section)."""
        with self._lock:
            return {
                "tenants": sorted(self._known),
                "overrides": {
                    t: dict(kv) for t, kv in sorted(self._overrides.items())
                },
                "snapshot_bytes": dict(self._nbytes),
            }
