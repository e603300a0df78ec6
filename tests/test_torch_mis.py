"""Port parity: Luby MIS and greedy colouring against the JAX package
(CPU). The port draws each round's priorities from its copy of JAX's
PRNG, so masks and colours are bit-equal for the same seed."""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import mis as tm
from _torch_threads import one_torch_thread  # noqa: F401

jm = importlib.import_module("graphmine_tpu.ops.mis")


def _graphs(src, dst, v, symmetric=True):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    return (jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric),
            build_graph(src, dst, num_vertices=v, symmetric=symmetric, device="cpu"))


def _random(seed, v, e):
    rng = np.random.default_rng(seed)
    return _graphs(rng.integers(0, v, e), rng.integers(0, v, e), v)


GRAPHS = {
    "sparse": lambda: _random(0, 500, 800),
    "dense": lambda: _random(1, 300, 6000),
    "odd_v": lambda: _random(2, 1999, 5000),
    # a clique of 6, a self-loop, duplicates and isolated vertices
    "clique": lambda: _graphs([a for a in range(6) for b in range(a + 1, 6)] + [7, 0],
                              [b for a in range(6) for b in range(a + 1, 6)] + [7, 1], 9),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mis_bit_equal_independent_and_maximal(name, seed):
    jg, g = GRAPHS[name]()
    got = tm.maximal_independent_set(g, seed=seed).numpy()
    assert np.array_equal(got, np.asarray(jm.maximal_independent_set(jg, seed=seed)))
    send, recv = g.msg_send.numpy(), g.msg_recv.numpy()
    real = send != recv
    assert not (got[send] & got[recv] & real).any()
    covered = np.zeros(g.num_vertices, bool)
    covered[recv[real & got[send]]] = True
    assert (got | covered).all()


@pytest.mark.parametrize("max_iter", [1, 2])
def test_mis_round_cap(max_iter):
    jg, g = GRAPHS["dense"]()
    assert np.array_equal(tm.maximal_independent_set(g, seed=3, max_iter=max_iter).numpy(),
                          np.asarray(jm.maximal_independent_set(jg, seed=3, max_iter=max_iter)))


@pytest.mark.parametrize("kw", [{"seed": 0}, {"seed": 5}, {"seed": 0, "max_colors": 3}],
                         ids=["seed0", "seed5", "capped"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_greedy_color_bit_equal_and_proper(name, kw):
    jg, g = GRAPHS[name]()
    got = tm.greedy_color(g, **kw).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jm.greedy_color(jg, **kw)))
    send, recv = g.msg_send.numpy(), g.msg_recv.numpy()
    both = (got[send] >= 0) & (got[recv] >= 0) & (send != recv)
    assert not (both & (got[send] == got[recv])).any()
    if "max_colors" not in kw:
        assert (got >= 0).all()


def test_directed_graphs_are_refused():
    _, g = _graphs([0, 1], [1, 2], 3, symmetric=False)
    with pytest.raises(ValueError, match="symmetric"):
        tm.maximal_independent_set(g)
    with pytest.raises(ValueError, match="symmetric"):
        tm.greedy_color(g)
