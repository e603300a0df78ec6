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


def test_initialize_distributed():
    # no cluster to join: False, as the JAX package answers on one host
    assert tmesh.initialize_distributed() is False
    with pytest.raises(NotImplementedError, match="A7c"):
        tmesh.initialize_distributed(coordinator_address="localhost:1234", num_processes=2,
                                     process_id=0)


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
