"""The fault-injection seam of the pipeline.

Counterpart of ``fault_point`` and ``set_fault_hook`` in
``graphmine_tpu/pipeline/resilience.py``: code calls ``fault_point(site,
...)`` at instrumented points, and a test installs a hook that raises or
mutates there. Retry, the degradation ladders and the watchdog wait for a
later slice (ROADMAP.md).
"""

from __future__ import annotations

_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or clear, with None) the process-wide fault hook."""
    global _fault_hook
    _fault_hook = hook


def fault_point(site: str, **ctx) -> None:
    """Named instrumentation point: calls the installed hook, if any,
    with the site and its context."""
    hook = _fault_hook
    if hook is not None:
        hook(site, **ctx)
