"""The port's graph operations. The blocked superstep family is exported
here under the JAX package's names, lazily (PEP 562): an attribute
imports its module on first access."""

# export name -> defining module
_EXPORTS = {
    "BlockedPlan": "graphmine_tpu_torch.ops.blocking",
    "blocked_inflow": "graphmine_tpu_torch.ops.blocking",
    "build_graph_and_blocked_plan": "graphmine_tpu_torch.ops.blocking",
    "cc_superstep_blocked": "graphmine_tpu_torch.ops.blocking",
    "lpa_superstep_blocked": "graphmine_tpu_torch.ops.blocking",
    "select_superstep_family": "graphmine_tpu_torch.ops.blocking",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module_name = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value
    return value
