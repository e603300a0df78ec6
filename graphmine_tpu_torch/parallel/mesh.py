"""Device mesh and its collectives, in one process or across processes (PyTorch).

Counterpart of ``graphmine_tpu/parallel/mesh.py``. A :class:`Mesh` is an
ordered tuple of shards with axis names: ``("v",)`` for the 1-D
vertex-axis mesh, ``("dcn", "ici")`` for :func:`make_multislice_mesh`,
whose shards are taken in row-major order. Sharded state is a list of one
tensor per shard, and the collectives below are plain functions over such
per-shard lists:

- :func:`all_gather` concatenates the shards' chunks onto every shard;
- :func:`ppermute` is the ring shift (shard ``i``'s tensor goes to shard
  ``i + shift``);
- :func:`psum`, :func:`pmax` and :func:`pmin` reduce one value per shard
  in shard order and give every shard the result.

**In one process** every shard is a device of this process. Between
distinct CUDA cards a transfer is a device-to-device copy; between two
shards of one device it is an ordinary copy on that device, so every hop
of a virtual mesh still moves its bytes. A virtual mesh (a device
repeated) exists only when ``GRAPHMINE_VIRTUAL_DEVICES`` asks for one
(:func:`~graphmine_tpu_torch.device.visible_devices`); its exchanges are
copies inside one device and say nothing of an interconnect.

**Across processes**, after :func:`initialize_distributed`, the mesh
factories span the world: shard ``s`` is rank ``s``, one shard a process
on the rank's own device. Such a mesh holds its process group and the
shards of this process (``local``); a per-shard list holds a tensor at
each local shard and ``None`` elsewhere, so the same bodies run in both
kinds of mesh, each process looping over its own shards. A mesh over
some of the ranks runs on a group of those ranks (every rank creates the
group; ranks outside it hold no shard). The exchanges are
``torch.distributed`` collectives: NCCL when every rank has a card of its
own; gloo on the CPU, and for ranks that share one card (a virtual world,
again only with ``GRAPHMINE_VIRTUAL_DEVICES``), staged through host
tensors. The reductions gather every shard's value and reduce them in
shard order on each process, never with ``all_reduce``, whose order of
addition is not fixed; so a process mesh gives the sums of the
in-process mesh, bit for bit. Nothing is traced, so the JAX package's
compiled-program cache has no counterpart.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta

import torch

from graphmine_tpu_torch.device import (
    VIRTUAL_DEVICES_ENV,
    resolve_device,
    virtual_device_count,
    visible_devices,
)
from graphmine_tpu_torch.obs.registry import PROCESS
from graphmine_tpu_torch.obs.spans import OPS

_ALL_GATHER_BYTES = PROCESS.counter(
    "graphmine_mesh_all_gather_bytes_total",
    "bytes the mesh's all-gathers moved between distinct devices (a device's copy to "
    "itself not counted)")

VERTEX_AXIS = "v"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class World:
    """This process's place in the ``torch.distributed`` world that
    :func:`initialize_distributed` joined: its ``rank`` of ``size``, the
    ``backend``, the ``device`` its shard lives on, and ``virtual`` when
    the ranks share one card."""

    rank: int
    size: int
    backend: str
    device: torch.device
    virtual: bool


# The world this process joined (None until initialize_distributed), and
# the process groups of meshes over some of its ranks, by rank tuple: a
# group is created once, by every rank, in the same order.
_world: World | None = None
_groups: dict = {}


def world() -> World | None:
    """The world :func:`initialize_distributed` joined, or None."""
    return _world


class Mesh:
    """Ordered shards with axis names; ``size`` shards, one per device
    slot. ``virtual`` is true when a device appears more than once, which
    only ``GRAPHMINE_VIRTUAL_DEVICES`` allows (in one process, or a world
    whose ranks share a card).

    A process mesh (``ranks`` given) maps shard ``s`` to global rank
    ``ranks[s]``: ``devices`` holds this process's device at its own shard
    and ``None`` at the others, ``local`` that shard's index (empty on a
    rank outside the mesh), ``group`` the process group."""

    def __init__(self, devices, axis_names=(VERTEX_AXIS,), shape=None, ranks=None,
                 group=None, virtual: bool = False):
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self.group = group
        if self.ranks is None:
            self.devices = tuple(_as_device(d) for d in devices)
        else:
            self.devices = tuple(None if d is None else _as_device(d) for d in devices)
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
        if self.ranks is not None:
            self.local = tuple(s for s, d in enumerate(self.devices) if d is not None)
            self.virtual = bool(virtual)
            return
        self.local = tuple(range(len(self.devices)))
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

    @property
    def process(self) -> bool:
        """True when the shards are processes of a world."""
        return self.ranks is not None

    @property
    def home(self) -> torch.device:
        """The device results come back on: the first local shard's."""
        if not self.local:
            raise ValueError(f"this process holds no shard of {self!r}; only ranks "
                             f"{list(self.ranks)} run its bodies")
        return self.devices[self.local[0]]

    def each(self, fn) -> list:
        """``[fn(s)]`` over the shards, ``None`` at the shards of other
        processes."""
        out = [None] * self.size
        for s in self.local:
            out[s] = fn(s)
        return out

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_names == other.axis_names and self.shape == other.shape
                and self.ranks == other.ranks)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names, self.shape, self.ranks))

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual else ""
        if self.ranks is not None:
            return (f"Mesh({kind}{self.shape} {self.axis_names}: ranks {list(self.ranks)}, "
                    f"local {list(self.local)})")
        return f"Mesh({kind}{self.shape} {self.axis_names}: {[str(d) for d in self.devices]})"


def _group(ranks: tuple):
    """The process group of ``ranks``: the world's own for all of them, else
    a group created once (by every rank, as ``new_group`` requires)."""
    import torch.distributed as dist

    if ranks == tuple(range(_world.size)):
        return dist.group.WORLD
    if ranks not in _groups:
        _groups[ranks] = dist.new_group(list(ranks), backend=_world.backend)
    return _groups[ranks]


def _process_mesh(ranks, axis_names=(VERTEX_AXIS,), shape=None) -> Mesh:
    """A mesh whose shard ``s`` is rank ``ranks[s]`` of the world."""
    ranks = tuple(int(r) for r in ranks)
    devices = [_world.device if r == _world.rank else None for r in ranks]
    return Mesh(devices, axis_names, shape, ranks=ranks, group=_group(ranks),
                virtual=_world.virtual)


def _too_few(n: int, have: int) -> ValueError:
    return ValueError(f"requested {n} devices, only {have} visible")


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the vertex axis: the first ``num_devices`` of
    ``devices`` (default :func:`~graphmine_tpu_torch.device.visible_devices`,
    every visible CUDA card). In a world (:func:`initialize_distributed`)
    with ``devices`` left out, the first ``num_devices`` ranks (default
    all), one shard each."""
    if devices is None and _world is not None:
        n = _world.size if num_devices is None else int(num_devices)
        if n > _world.size:
            raise _too_few(n, _world.size)
        return _process_mesh(range(n))
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise _too_few(num_devices, len(devices))
        devices = devices[:num_devices]
    return Mesh(devices, (VERTEX_AXIS,))


def device_mesh(num_shards: int, device) -> Mesh:
    """A 1-D vertex-axis mesh of ``num_shards`` on ``device``'s kind with
    ``device`` first: the distinct cards, or on a virtual mesh
    (``GRAPHMINE_VIRTUAL_DEVICES``) ``device`` repeated. Too few visible
    devices raises, naming the variable that makes a virtual mesh. In a
    world, the first ``num_shards`` ranks, whose shards live on their own
    devices (of ``device``'s kind)."""
    dev = _as_device(device)
    if _world is not None:
        if dev.type != _world.device.type:
            raise ValueError(f"this world's shards live on {_world.device.type} devices, "
                             f"not {dev.type}")
        if num_shards > _world.size:
            raise ValueError(f"requested {num_shards} shards, the world has "
                             f"{_world.size} ranks")
        return _process_mesh(range(num_shards))
    visible = [_as_device(d) for d in visible_devices(dev)]
    if dev in visible and len(set(visible)) == len(visible):
        visible = [dev] + [d for d in visible if d != dev]
    if num_shards > len(visible):
        raise ValueError(
            f"requested {num_shards} shards, only {len(visible)} {dev.type} device(s) "
            f"visible; to run {num_shards} shards on one device, set "
            f"{VIRTUAL_DEVICES_ENV}={num_shards} (a virtual mesh)"
        )
    return Mesh(visible[:num_shards], (VERTEX_AXIS,))


def surviving_mesh(num_devices: int, exclude=(), devices=None) -> Mesh:
    """A 1-D vertex-axis mesh over the devices that survived a loss:
    ``exclude`` holds indices (into ``devices``, default the visible ones,
    or in a world its ranks) of dead or suspect devices; takes the first
    ``num_devices`` survivors and raises when fewer remain."""
    exclude = set(exclude)
    if devices is None and _world is not None:
        alive = [r for r in range(_world.size) if r not in exclude]
        total = _world.size
    else:
        devices = list(visible_devices() if devices is None else devices)
        alive = [d for i, d in enumerate(devices) if i not in exclude]
        total = len(devices)
    if num_devices > len(alive):
        raise ValueError(
            f"requested {num_devices} devices, only {len(alive)} survive "
            f"({len(exclude)} excluded of {total} visible)"
        )
    if devices is None:
        return _process_mesh(alive[:num_devices])
    return Mesh(alive[:num_devices], (VERTEX_AXIS,))


def make_multislice_mesh(num_slices: int, chips_per_slice: int | None = None,
                         devices=None) -> Mesh:
    """A 2-D ``("dcn", "ici")`` mesh: ``num_slices`` rows of
    ``chips_per_slice`` devices (in a world, ranks), slice-major. The
    replicated schedules shard vertices over both axes in that order; the
    ring schedules need a 1-D mesh."""
    in_world = devices is None and _world is not None
    if in_world:
        devices = list(range(_world.size))
    elif devices is None:
        devices = visible_devices()
    devices = list(devices)
    if chips_per_slice is None:
        if len(devices) % num_slices:
            raise ValueError(f"{len(devices)} devices do not divide into {num_slices} slices")
        chips_per_slice = len(devices) // num_slices
    need = num_slices * chips_per_slice
    if need > len(devices):
        raise _too_few(need, len(devices))
    shape = (num_slices, chips_per_slice)
    if in_world:
        return _process_mesh(devices[:need], (DCN_AXIS, ICI_AXIS), shape)
    return Mesh(devices[:need], (DCN_AXIS, ICI_AXIS), shape=shape)


# ---- the world ----------------------------------------------------------------

# What torchrun (or any launcher of the env:// kind) sets for each rank.
_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_KWARGS = ("coordinator_address", "num_processes", "process_id", "local_device_ids",
           "initialization_timeout")
# The JAX package's default initialization timeout, in seconds: a world
# whose ranks never all arrive, or a collective a rank never joins, fails
# after it instead of waiting forever.
DEFAULT_TIMEOUT_S = 300


def _first_id(ids):
    if ids is None:
        return None
    if isinstance(ids, int):
        return ids
    ids = list(ids)
    if len(ids) != 1:
        raise ValueError(f"local_device_ids={ids}: a rank drives one device")
    return int(ids[0])


def _local_rank_and_size(rank: int, size: int, cards: int) -> tuple:
    """This rank's place among the ranks of its host, from the launcher's
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (``torchrun`` sets both). Without
    them the world is taken for one host only when it has no more ranks
    than the host has cards; a larger world may span hosts, and guessing
    there would give a rank a card it does not have."""
    local = [os.environ.get(k) or None for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")]
    if all(v is not None for v in local):
        local_rank, local_size = (int(v) for v in local)
        if not 0 <= local_rank < local_size:
            raise ValueError(f"LOCAL_RANK {local_rank} is outside LOCAL_WORLD_SIZE {local_size}")
        return local_rank, local_size
    if any(v is not None for v in local) or size > cards:
        raise ValueError(
            f"a world of {size} ranks on a host of {cards} card(s) needs LOCAL_RANK and "
            "LOCAL_WORLD_SIZE (torchrun sets them) or local_device_ids to place each rank"
        )
    return rank, size


def _pick_device(dev: torch.device, rank: int, size: int, local_ids) -> tuple:
    """``(device, backend, virtual)`` of this rank: gloo on the CPU; NCCL
    on a card of its own (``local_device_ids``, or one card per rank of
    the host); gloo on a card shared by the host's ranks (a virtual
    world), only with ``GRAPHMINE_VIRTUAL_DEVICES``."""
    if dev.type == "cpu":
        return dev, "gloo", False
    if dev.type != "cuda":
        raise ValueError(f"no distributed backend for {dev.type} devices")
    cards = torch.cuda.device_count()
    index = _first_id(local_ids)
    if index is not None:
        if not 0 <= index < cards:
            raise ValueError(f"local_device_ids={local_ids}: this host has {cards} card(s)")
        return torch.device("cuda", index), "nccl", False
    local_rank, local_size = _local_rank_and_size(rank, size, cards)
    if local_size <= cards:
        index = dev.index if dev.index is not None else local_rank
        return torch.device("cuda", index), "nccl", False
    if virtual_device_count() < local_size:
        raise ValueError(
            f"{local_size} ranks on this host share {cards} card(s): a virtual world, "
            f"which NCCL refuses; set {VIRTUAL_DEVICES_ENV}={local_size} (or more) to "
            "run it over gloo on the shared card"
        )
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.device("cuda", index), "gloo", True


def initialize_distributed(device=None, **kw) -> bool:
    """Join a multi-process world (``torch.distributed``), idempotently.

    The JAX package's contract: call once per process before building
    meshes. Returns True once a world exists (already, or joined now) and
    False when there is nothing to join: no arguments and none of the
    variables a launcher sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``torchrun --nproc-per-node N`` sets them all). A
    partly set environment raises, and so does a join that fails: a
    failed pod run never goes on quietly as N single-process runs.

    The JAX arguments map onto the world: ``coordinator_address``
    (``host:port``) is its ``tcp://`` rendezvous (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` its size (default
    ``WORLD_SIZE``), ``process_id`` this rank (default ``RANK``),
    ``local_device_ids`` the rank's card, ``initialization_timeout`` the
    seconds the world waits, for the rendezvous and for each collective
    (default :data:`DEFAULT_TIMEOUT_S`). ``device`` is the port's device
    rule: CUDA unless the caller names another (``"cpu"`` for a gloo world
    on the host). On CUDA the backend is NCCL when every rank of the host
    has a card of its own, and gloo when the ranks share one card (a
    virtual world, which ``GRAPHMINE_VIRTUAL_DEVICES`` must ask for, as
    for a virtual mesh); nothing falls back on its own."""
    global _world
    import torch.distributed as dist

    unknown = sorted(set(kw) - set(_KWARGS))
    if unknown:
        raise TypeError(f"initialize_distributed got unknown arguments {unknown}")
    if dist.is_available() and dist.is_initialized():
        if _world is None:
            raise RuntimeError(
                "a torch.distributed process group exists that initialize_distributed "
                "did not create; let initialize_distributed create the world"
            )
        return True
    env = {k: os.environ.get(k) or None for k in _CLUSTER_ENV}
    if not kw and not any(env.values()):
        return False
    addr = kw.get("coordinator_address")
    if addr is None and env["MASTER_ADDR"] and env["MASTER_PORT"]:
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    size = kw.get("num_processes", env["WORLD_SIZE"])
    rank = kw.get("process_id", env["RANK"])
    missing = [name for name, v in (("coordinator_address (or MASTER_ADDR and MASTER_PORT)",
                                     addr),
                                    ("num_processes (or WORLD_SIZE)", size),
                                    ("process_id (or RANK)", rank)) if v is None]
    if missing:
        raise ValueError(f"cannot join a world without {', '.join(missing)}; set every "
                         f"one of {list(_CLUSTER_ENV)} (torchrun does) or pass the arguments")
    size, rank = int(size), int(rank)
    if not 0 <= rank < size:
        raise ValueError(f"process_id {rank} is outside a world of {size}")
    timeout = float(kw.get("initialization_timeout") or DEFAULT_TIMEOUT_S)
    dev, backend, virtual = _pick_device(resolve_device(device), rank, size,
                                         kw.get("local_device_ids"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    _world = World(rank=rank, size=size, backend=backend, device=dev, virtual=virtual)
    _groups.clear()
    return True


# ---- collectives over per-shard lists --------------------------------------


def _only_local(mesh: Mesh) -> int:
    """The one shard of this process on a process mesh."""
    if len(mesh.local) != 1:
        raise ValueError(f"this process holds no shard of {mesh!r}")
    return mesh.local[0]


def _on_nccl(mesh: Mesh) -> bool:
    return _world is not None and _world.backend == "nccl"


def _world_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every shard's ``t`` (one shape on all), concatenated in shard order
    along dim 0, on ``t``'s device: NCCL's all-gather into one tensor, or
    on gloo the gather of host copies."""
    import torch.distributed as dist

    t = t.contiguous()
    if _on_nccl(mesh):
        out = t.new_empty((mesh.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return out
    host = t.cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts).to(t.device)


def place(mesh: Mesh, stacked) -> tuple:
    """Shard ``s`` of a stacked ``[D, ...]`` host array (or tensor) onto
    ``mesh.devices[s]``, for this process's shards: a tuple of D entries
    (``None`` at other processes' shards)."""
    if len(stacked) != mesh.size:
        raise ValueError(f"{len(stacked)} shards for a mesh of {mesh.size}")

    def put(s):
        part = stacked[s]
        part = torch.from_numpy(part) if not isinstance(part, torch.Tensor) else part
        return part.to(mesh.devices[s], copy=True).contiguous()

    return tuple(mesh.each(put))


def replicate(mesh: Mesh, value: torch.Tensor) -> list:
    """One copy of ``value`` on every (local) shard's device."""
    return mesh.each(lambda s: value.to(mesh.devices[s], copy=True))


def all_gather(mesh: Mesh, chunks) -> list:
    """The shards' chunks concatenated in shard order, on every shard's
    device (a tiled all-gather). Spanned as ``mesh.all_gather`` (host
    seconds); the bytes it moves between distinct devices, this process's
    receipts on a process mesh, are counted in
    ``graphmine_mesh_all_gather_bytes_total``."""
    with OPS.span("mesh.all_gather"):
        if not mesh.process:
            _ALL_GATHER_BYTES.inc(sum(_nbytes(c) for dev in mesh.devices for c in chunks
                                      if c.device != dev))
            return [torch.cat([c.to(dev) for c in chunks]) for dev in mesh.devices]
        s = _only_local(mesh)
        out = [None] * mesh.size
        out[s] = _world_gather(mesh, chunks[s])
        if not mesh.virtual:
            _ALL_GATHER_BYTES.inc((mesh.size - 1) * _nbytes(chunks[s]))
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def gather_to(chunks, device, mesh: Mesh | None = None) -> torch.Tensor:
    """The shards' chunks concatenated in shard order on one ``device``
    (what a caller reads back from a sharded result); on a process
    ``mesh``, an all-gather, so every process reads the whole."""
    if mesh is None or not mesh.process:
        return torch.cat([c.to(device) for c in chunks])
    return _world_gather(mesh, chunks[_only_local(mesh)]).to(device)


def ppermute(mesh: Mesh, parts, shift: int = 1) -> list:
    """The ring shift: shard ``(i + shift) % D`` receives shard ``i``'s
    tensor, copied onto its device (every shard's tensor of one shape on a
    process mesh: one send and one receive a process)."""
    d = mesh.size
    out = [None] * d
    if not mesh.process:
        for i, part in enumerate(parts):
            j = (i + shift) % d
            out[j] = part.to(mesh.devices[j], copy=True)
        return out
    import torch.distributed as dist

    s = _only_local(mesh)
    if shift % d == 0:
        out[s] = parts[s].clone()
        return out
    send = parts[s].contiguous() if _on_nccl(mesh) else parts[s].cpu().contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, mesh.ranks[(s + shift) % d], mesh.group),
           dist.P2POp(dist.irecv, recv, mesh.ranks[(s - shift) % d], mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out[s] = recv.to(mesh.devices[s])
    return out


def _shard_values(mesh: Mesh, parts) -> list:
    """Every shard's value (one shape on all), in shard order, on the
    mesh's home device: what a reduction reads, the same list on every
    process."""
    if not mesh.process:
        return [p.to(mesh.devices[0]) for p in parts]
    s = _only_local(mesh)
    return list(_world_gather(mesh, parts[s].unsqueeze(0)).unbind(0))


def stack(mesh: Mesh, parts) -> torch.Tensor:
    """Every shard's value (one shape on all) stacked in shard order:
    ``[D, ...]`` on the mesh's home device, the same on every process."""
    return torch.stack(_shard_values(mesh, parts))


def agree(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """``value`` as shard 0 computed it, on every process: a value each
    shard derives the same way from replicated data, made one before it
    decides a branch that every process must take alike."""
    if not mesh.process:
        return value
    import torch.distributed as dist

    t = value.contiguous() if _on_nccl(mesh) else value.cpu().contiguous()
    t = t.clone()
    dist.broadcast(t, src=mesh.ranks[0], group=mesh.group)
    return t.to(value.device)


def _reduce(mesh: Mesh, parts, op) -> list:
    vals = _shard_values(mesh, parts)
    acc = vals[0]
    for p in vals[1:]:
        acc = op(acc, p)
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

