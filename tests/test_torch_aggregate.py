"""Port parity: ``aggregate_messages`` and ``pregel`` against the JAX
package (CPU), on the inputs of ``tests/test_aggregate.py`` and a random
graph. Integer reductions and float minima/maxima must be equal; float
sums and means are summed in message order on both sides and are equal
too (checked exactly)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops.aggregate import aggregate_messages, pregel
from graphmine_tpu_torch.ops.cc import connected_components
from _torch_threads import one_torch_thread  # noqa: F401

jagg = importlib.import_module("graphmine_tpu.ops.aggregate")


def _small():
    # 0->1, 1->2, 2->0 triangle plus 3->4 pendant, 5 isolated
    return np.array([0, 1, 2, 3], np.int32), np.array([1, 2, 0, 4], np.int32), 6


def _random():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 90, 400).astype(np.int32),
            rng.integers(0, 90, 400).astype(np.int32), 90)


GRAPHS = {"small": _small, "random": _random}


def _graphs(name):
    src, dst, v = GRAPHS[name]()
    return jbuild_graph(src, dst, num_vertices=v), build_graph(src, dst, num_vertices=v,
                                                                device="cpu")


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("reduce", ["sum", "min", "max", "mean", "mode"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_aggregate_messages_equal(name, reduce, dtype):
    jg, g = _graphs(name)
    v, e = g.num_vertices, g.num_edges
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 7, v) if dtype == "int32" else rng.random(v)).astype(dtype)
    w = rng.random(e).astype(np.float32) if dtype == "float32" else \
        rng.integers(1, 4, e).astype(np.int32)
    kw = dict(reduce=reduce, to_dst=lambda s, d, ev: s * 2 + ev, to_src=lambda s, d, ev: d - s)
    if reduce == "mode" and dtype == "float32":
        with pytest.raises(TypeError, match="integer"):
            aggregate_messages(g, torch.from_numpy(x), torch.from_numpy(w), **kw)
        return
    want = np.asarray(jagg.aggregate_messages(jg, jnp.asarray(x), jnp.asarray(w), **kw))
    got = aggregate_messages(g, torch.from_numpy(x), torch.from_numpy(w), **kw)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_aggregate_needs_a_message_fn_and_a_known_reduce():
    _, g = _graphs("small")
    x = torch.zeros(g.num_vertices)
    with pytest.raises(ValueError, match="to_dst"):
        aggregate_messages(g, x)
    with pytest.raises(ValueError, match="reduce"):
        aggregate_messages(g, x, to_dst=lambda s, d, e: s, reduce="median")


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pregel_min_propagation_equals_jax_and_cc(name):
    jg, g = _graphs(name)
    init = np.arange(g.num_vertices, dtype=np.int32)
    want = np.asarray(jagg.pregel(jg, jnp.asarray(init), to_dst=lambda s, d, e: s,
                                  to_src=lambda s, d, e: d, reduce="min",
                                  update=lambda st, agg: jnp.minimum(st, agg), max_iter=6))
    got = pregel(g, torch.from_numpy(init), to_dst=lambda s, d, e: s, to_src=lambda s, d, e: d,
                 reduce="min", update=lambda st, agg: torch.minimum(st, agg), max_iter=6)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "small":
        np.testing.assert_array_equal(got.numpy(), connected_components(g).numpy())


def test_pregel_pytree_state_equal():
    jg, g = _graphs("small")
    jout = jagg.pregel(
        jg, {"v": jnp.arange(6, dtype=jnp.int32), "steps": jnp.zeros((6,), jnp.int32)},
        to_dst=lambda s, d, e: s["v"], reduce="max", max_iter=3,
        update=lambda st, agg: {"v": jnp.maximum(st["v"], agg), "steps": st["steps"] + 1})
    out = pregel(
        g, {"v": torch.arange(6, dtype=torch.int32), "steps": torch.zeros(6, dtype=torch.int32)},
        to_dst=lambda s, d, e: s["v"], reduce="max", max_iter=3,
        update=lambda st, agg: {"v": torch.maximum(st["v"], agg), "steps": st["steps"] + 1})
    for key in ("v", "steps"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    assert out["v"][:3].tolist() == [2, 2, 2] and int(out["steps"][0]) == 3
