"""Device mesh and its collectives, inside one process (PyTorch).

Counterpart of ``graphmine_tpu/parallel/mesh.py``. A :class:`Mesh` is an
ordered tuple of ``torch.device`` s with axis names: ``("v",)`` for the
1-D vertex-axis mesh, ``("dcn", "ici")`` for :func:`make_multislice_mesh`,
whose shards are its devices in row-major order. Sharded state is one
tensor per shard on that shard's device, and the collectives below are
plain functions over such per-shard lists:

- :func:`all_gather` concatenates the shards' chunks onto every shard;
- :func:`ppermute` is the ring shift (shard ``i``'s tensor goes to shard
  ``i + shift``);
- :func:`psum`, :func:`pmax` and :func:`pmin` reduce one value per shard
  in shard order and give every shard the result.

Between distinct CUDA cards a transfer is a device-to-device copy; between
two shards of one device it is an ordinary copy on that device, so every
hop of a virtual mesh still moves its bytes. A virtual mesh (a device
repeated) exists only when ``GRAPHMINE_VIRTUAL_DEVICES`` asks for one
(:func:`~graphmine_tpu_torch.device.visible_devices`); its exchanges are
copies inside one device and say nothing of an interconnect. Nothing is
traced, so the JAX package's compiled-program cache has no counterpart.
"""

from __future__ import annotations

from collections import Counter

import torch

from graphmine_tpu_torch.device import VIRTUAL_DEVICES_ENV, virtual_device_count, visible_devices

VERTEX_AXIS = "v"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Ordered devices with axis names; ``size`` shards, one per device
    slot. ``virtual`` is true when a device appears more than once, which
    only ``GRAPHMINE_VIRTUAL_DEVICES`` allows."""

    def __init__(self, devices, axis_names=(VERTEX_AXIS,), shape=None):
        self.devices = tuple(_as_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (len(self.devices),)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes {self.axis_names}")
        n = 1
        for s in self.shape:
            n *= int(s)
        if n != len(self.devices) or n < 1:
            raise ValueError(f"mesh shape {self.shape} holds {n} devices, "
                             f"got {len(self.devices)}")
        repeat = max(Counter(self.devices).values())
        self.virtual = repeat > 1
        if self.virtual and repeat > virtual_device_count():
            raise ValueError(
                f"a mesh that repeats a device ({repeat} shards on "
                f"{Counter(self.devices).most_common(1)[0][0]}) is a virtual mesh; "
                f"set {VIRTUAL_DEVICES_ENV}={repeat} (or more) to ask for one"
            )

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_names == other.axis_names and self.shape == other.shape)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names, self.shape))

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual else ""
        return f"Mesh({kind}{self.shape} {self.axis_names}: {[str(d) for d in self.devices]})"


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the vertex axis: the first ``num_devices`` of
    ``devices`` (default :func:`~graphmine_tpu_torch.device.visible_devices`,
    every visible CUDA card)."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, only {len(devices)} visible")
        devices = devices[:num_devices]
    return Mesh(devices, (VERTEX_AXIS,))


def surviving_mesh(num_devices: int, exclude=(), devices=None) -> Mesh:
    """A 1-D vertex-axis mesh over the devices that survived a loss:
    ``exclude`` holds indices (into ``devices``, default the visible ones)
    of dead or suspect devices; takes the first ``num_devices`` survivors
    and raises when fewer remain."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    exclude = set(exclude)
    alive = [d for i, d in enumerate(devices) if i not in exclude]
    if num_devices > len(alive):
        raise ValueError(
            f"requested {num_devices} devices, only {len(alive)} survive "
            f"({len(exclude)} excluded of {len(devices)} visible)"
        )
    return Mesh(alive[:num_devices], (VERTEX_AXIS,))


def make_multislice_mesh(num_slices: int, chips_per_slice: int | None = None,
                         devices=None) -> Mesh:
    """A 2-D ``("dcn", "ici")`` mesh: ``num_slices`` rows of
    ``chips_per_slice`` devices, slice-major. The replicated schedules
    shard vertices over both axes in that order; the ring schedules need
    a 1-D mesh."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    if chips_per_slice is None:
        if len(devices) % num_slices:
            raise ValueError(f"{len(devices)} devices do not divide into {num_slices} slices")
        chips_per_slice = len(devices) // num_slices
    need = num_slices * chips_per_slice
    if need > len(devices):
        raise ValueError(f"requested {need} devices, only {len(devices)} visible")
    return Mesh(devices[:need], (DCN_AXIS, ICI_AXIS), shape=(num_slices, chips_per_slice))


def initialize_distributed(**kw) -> bool:
    """The multi-process bootstrap. A mesh here lives inside one process,
    so with no arguments (no cluster to join) this returns ``False``, as
    the JAX package does on one host. Joining a cluster of processes
    raises :class:`NotImplementedError`: a multi-process mesh over
    ``torch.distributed`` waits for ROADMAP item A7c."""
    if kw:
        raise NotImplementedError(
            "a multi-process mesh (torch.distributed, one process per card) "
            "waits for ROADMAP item A7c; this mesh lives inside one process"
        )
    return False


# ---- collectives over per-shard lists --------------------------------------


def place(mesh: Mesh, stacked) -> tuple:
    """Shard ``s`` of a stacked ``[D, ...]`` host array (or tensor) onto
    ``mesh.devices[s]``: a tuple of D tensors."""
    if len(stacked) != mesh.size:
        raise ValueError(f"{len(stacked)} shards for a mesh of {mesh.size}")
    out = []
    for s, dev in enumerate(mesh.devices):
        part = stacked[s]
        part = torch.from_numpy(part) if not isinstance(part, torch.Tensor) else part
        out.append(part.to(dev, copy=True).contiguous())
    return tuple(out)


def replicate(mesh: Mesh, value: torch.Tensor) -> list:
    """One copy of ``value`` on every shard's device."""
    return [value.to(dev, copy=True) for dev in mesh.devices]


def all_gather(mesh: Mesh, chunks) -> list:
    """The shards' chunks concatenated in shard order, on every shard's
    device (a tiled all-gather)."""
    return [torch.cat([c.to(dev) for c in chunks]) for dev in mesh.devices]


def gather_to(chunks, device) -> torch.Tensor:
    """The shards' chunks concatenated in shard order on one ``device``
    (what a caller reads back from a sharded result)."""
    return torch.cat([c.to(device) for c in chunks])


def ppermute(mesh: Mesh, parts, shift: int = 1) -> list:
    """The ring shift: shard ``(i + shift) % D`` receives shard ``i``'s
    tensor, copied onto its device."""
    d = mesh.size
    out = [None] * d
    for i, part in enumerate(parts):
        j = (i + shift) % d
        out[j] = part.to(mesh.devices[j], copy=True)
    return out


def _reduce(mesh: Mesh, parts, op) -> list:
    acc = parts[0].to(mesh.devices[0])
    for p in parts[1:]:
        acc = op(acc, p.to(mesh.devices[0]))
    return replicate(mesh, acc)


def psum(mesh: Mesh, parts) -> list:
    """Sum of one value per shard, added in shard order, on every shard."""
    return _reduce(mesh, parts, torch.add)


def pmax(mesh: Mesh, parts) -> list:
    """Elementwise maximum of one value per shard, on every shard."""
    return _reduce(mesh, parts, torch.maximum)


def pmin(mesh: Mesh, parts) -> list:
    """Elementwise minimum of one value per shard, on every shard."""
    return _reduce(mesh, parts, torch.minimum)
