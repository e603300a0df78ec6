"""The port's device rule: CUDA unless the caller names another device.

There is no "CUDA when available, else CPU" fallback: a caller who wants
the CPU (the parity tests) says so with ``device="cpu"``. A mesh's devices
come from :func:`visible_devices`.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (default CUDA); raises when CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# The one setting that makes virtual devices: the caller's device repeated
# N times, the counterpart of XLA's forced host device count. Tests set it
# on the CPU, the chip smoke on the card; nothing sets it on its own.
VIRTUAL_DEVICES_ENV = "GRAPHMINE_VIRTUAL_DEVICES"


def virtual_device_count() -> int:
    """``GRAPHMINE_VIRTUAL_DEVICES`` as an int (0 when unset)."""
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not raw:
        return 0
    n = int(raw)
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be >= 1, got {raw!r}")
    return n


def visible_devices(device=None) -> list:
    """The devices a mesh may use: the distinct CUDA cards (``device``
    names the kind, default CUDA), or ``[cpu]`` for a CPU caller. With
    ``GRAPHMINE_VIRTUAL_DEVICES=N`` it is the caller's device repeated N
    times instead: N shards of a virtual mesh share that one device."""
    dev = resolve_device(device)
    n_virtual = virtual_device_count()
    if n_virtual:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * n_virtual
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]
