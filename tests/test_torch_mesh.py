"""The port's mesh: devices, the virtual-device setting and the collectives.

A mesh repeats a device only when ``GRAPHMINE_VIRTUAL_DEVICES`` asks for
one; ``make_mesh``, ``surviving_mesh`` and ``make_multislice_mesh`` keep
the JAX package's signatures, errors and device order (held against the
JAX mesh built over its 8 virtual CPU devices); the collectives move every
shard's value as the JAX collectives do.
"""

import jax
import numpy as np
import pytest
import torch

from graphmine_tpu.parallel import mesh as jmesh

from graphmine_tpu_torch.device import visible_devices
from graphmine_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


@pytest.fixture
def virtual8(monkeypatch):
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "8")
    return [CPU] * 8


def test_visible_devices_and_the_virtual_setting(monkeypatch):
    monkeypatch.delenv("GRAPHMINE_VIRTUAL_DEVICES", raising=False)
    assert visible_devices("cpu") == [CPU]
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "3")
    assert visible_devices("cpu") == [CPU] * 3
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "0")
    with pytest.raises(ValueError, match="GRAPHMINE_VIRTUAL_DEVICES"):
        visible_devices("cpu")


def test_make_mesh_2_raises_without_the_virtual_setting(monkeypatch):
    monkeypatch.delenv("GRAPHMINE_VIRTUAL_DEVICES", raising=False)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 visible"):
        tmesh.make_mesh(2, devices=visible_devices("cpu"))
    # repeating a device by hand is a virtual mesh too: refused without it
    with pytest.raises(ValueError, match="GRAPHMINE_VIRTUAL_DEVICES"):
        tmesh.make_mesh(devices=[CPU, CPU])
    one = tmesh.make_mesh(devices=visible_devices("cpu"))
    assert one.size == 1 and not one.virtual and one.axis_names == ("v",)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_keeps_the_jax_shape_and_errors(virtual8, n):
    jm = jmesh.make_mesh(n)
    tm = tmesh.make_mesh(n, devices=virtual8)
    assert tm.size == jm.size and tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == tuple(jm.devices.shape) and tm.virtual == (n > 1)
    with pytest.raises(ValueError, match="requested 9 devices, only 8 visible"):
        jmesh.make_mesh(9)
    with pytest.raises(ValueError, match="requested 9 devices, only 8 visible"):
        tmesh.make_mesh(9, devices=virtual8)


def test_surviving_and_multislice_meshes_follow_jax(virtual8):
    ids = [f"cuda:{i}" for i in range(8)]  # distinct devices, never touched
    jm = jmesh.surviving_mesh(3, exclude=[0, 2], devices=jax.devices())
    tm = tmesh.surviving_mesh(3, exclude=[0, 2], devices=ids)
    assert [d.id for d in jm.devices] == [int(str(d).split(":")[1]) for d in tm.devices]
    for fn in (jmesh.surviving_mesh, tmesh.surviving_mesh):
        with pytest.raises(ValueError, match="only 2 survive"):
            fn(3, exclude=range(6), devices=jax.devices() if fn is jmesh.surviving_mesh
               else ids)
    jm2 = jmesh.make_multislice_mesh(2, 4)
    tm2 = tmesh.make_multislice_mesh(2, 4, devices=virtual8)
    assert tm2.axis_names == tuple(jm2.axis_names) == ("dcn", "ici")
    assert tm2.shape == tuple(jm2.devices.shape) == (2, 4) and tm2.size == 8
    for fn, devs in ((jmesh.make_multislice_mesh, None),
                     (tmesh.make_multislice_mesh, virtual8)):
        with pytest.raises(ValueError, match="do not divide into 3 slices"):
            fn(3, devices=devs) if devs is not None else fn(3)


def test_initialize_distributed(monkeypatch):
    # no cluster to join: False, as the JAX package answers on one host;
    # a cluster named only in part raises and joins nothing (the whole
    # contract, joining included, is held in a world of processes by
    # tests/test_torch_distributed.py)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert tmesh.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=r"process_id \(or RANK\)"):
        tmesh.initialize_distributed(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="num_processes"):
        tmesh.initialize_distributed(coordinator_address="localhost:1234", process_id=0,
                                     device="cpu")
    with pytest.raises(TypeError, match="unknown arguments"):
        tmesh.initialize_distributed(cluster_detection_method="slurm")
    assert tmesh.world() is None


# (device, rank, size, local_device_ids, cards, LOCAL_RANK, LOCAL_WORLD_SIZE,
#  GRAPHMINE_VIRTUAL_DEVICES) -> (device, backend, virtual), or the error's text
PICKS = [
    pytest.param("cpu", 3, 4, None, 0, None, None, None, ("cpu", "gloo", False), id="cpu"),
    # two hosts of 8 cards, 16 ranks, started the JAX way: the card named
    pytest.param("cuda", 9, 16, [1], 8, None, None, None, ("cuda:1", "nccl", False),
                 id="jax-multihost"),
    pytest.param("cuda", 9, 16, None, 8, "1", "8", None, ("cuda:1", "nccl", False),
                 id="torchrun-multihost"),
    pytest.param("cuda", 2, 4, None, 4, None, None, None, ("cuda:2", "nccl", False),
                 id="one-host-no-local"),
    pytest.param("cuda", 1, 4, None, 1, "1", "4", "4", ("cuda:0", "gloo", True),
                 id="virtual"),
    # a world larger than the host, placed by nothing: never a virtual world
    pytest.param("cuda", 9, 16, None, 8, None, None, "16", "LOCAL_RANK and LOCAL_WORLD_SIZE",
                 id="multihost-unplaced"),
    pytest.param("cuda", 1, 2, None, 1, "1", None, None, "LOCAL_RANK and LOCAL_WORLD_SIZE",
                 id="partial-local"),
    pytest.param("cuda", 1, 4, None, 1, "1", "4", None, "GRAPHMINE_VIRTUAL_DEVICES=4",
                 id="virtual-not-asked"),
    pytest.param("cuda", 0, 2, [8], 8, None, None, None, "has 8 card", id="id-out-of-range"),
]


@pytest.mark.parametrize("device,rank,size,ids,cards,lrank,lsize,virtual,want", PICKS)
def test_pick_device_places_each_rank(monkeypatch, device, rank, size, ids, cards, lrank, lsize,
                                      virtual, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for key, value in (("LOCAL_RANK", lrank), ("LOCAL_WORLD_SIZE", lsize),
                       ("GRAPHMINE_VIRTUAL_DEVICES", virtual)):
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, value)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tmesh._pick_device(torch.device(device), rank, size, ids)
        return
    dev, backend, is_virtual = tmesh._pick_device(torch.device(device), rank, size, ids)
    assert (str(dev), backend, is_virtual) == want


def test_collectives_move_every_shard(virtual8):
    mesh = tmesh.make_mesh(4, devices=virtual8)
    chunks = [torch.arange(3, dtype=torch.int32) + 10 * s for s in range(4)]
    full = tmesh.all_gather(mesh, chunks)
    assert len(full) == 4 and all(torch.equal(f, torch.cat(chunks)) for f in full)
    assert len({f.data_ptr() for f in full}) == 4  # one copy per shard
    moved = tmesh.ppermute(mesh, chunks)
    for s in range(4):
        assert torch.equal(moved[(s + 1) % 4], chunks[s])
        assert moved[(s + 1) % 4].data_ptr() != chunks[s].data_ptr()  # a real copy
    parts = [torch.tensor(float(s + 1)) for s in range(4)]
    assert all(float(x) == 10.0 for x in tmesh.psum(mesh, parts))
    assert all(float(x) == 4.0 for x in tmesh.pmax(mesh, parts))
    assert all(float(x) == 1.0 for x in tmesh.pmin(mesh, parts))
    placed = tmesh.place(mesh, np.arange(8, dtype=np.int32).reshape(4, 2))
    assert [p.tolist() for p in placed] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="3 shards for a mesh of 4"):
        tmesh.place(mesh, np.zeros((3, 2)))
