"""Tenant ids of the snapshot store.

Counterpart of the id primitives of ``graphmine_tpu/serve/tenancy.py``
(``DEFAULT_TENANT``, ``TENANT_RE``, ``validate_tenant_id``,
``UnknownTenantError``). Tenant ids become path components under
``<root>/tenants/``, so the grammar admits no separators and no dots.
The tenant registry and per-tenant policy wait for the serving slice.
"""

from __future__ import annotations

import re

DEFAULT_TENANT = "default"

# fullmatch only
TENANT_RE = re.compile(r"[a-z0-9_-]{1,64}")


class UnknownTenantError(KeyError):
    """A valid tenant id with no store namespace behind it."""


def validate_tenant_id(tenant) -> str:
    """``tenant`` if it matches :data:`TENANT_RE` in full, else
    ``ValueError``, before any path is built from it."""
    if not isinstance(tenant, str) or not TENANT_RE.fullmatch(tenant):
        raise ValueError(
            f"invalid tenant id {tenant!r}: tenant ids must match [a-z0-9_-]{{1,64}}"
        )
    return tenant
