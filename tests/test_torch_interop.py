"""The port's package surface and NetworkX bridges, against the JAX package.

The port exports every name the JAX package exports (``datasets`` and
``obs`` as modules), each resolving to the port's own object; the
NetworkX bridges convert an edge table and a graph as the JAX ones do
(the same NetworkX graphs, the same tables back, the same message CSR);
``message_ptr`` gives the JAX package's row pointers.
"""

import types

import networkx as nx
import numpy as np
import torch

import graphmine_tpu
from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.graph.container import message_ptr as jmessage_ptr
from graphmine_tpu.interop import from_networkx as jfrom_nx
from graphmine_tpu.interop import graph_from_networkx as jgraph_from_nx
from graphmine_tpu.interop import to_networkx as jto_nx
from graphmine_tpu.io.edges import from_arrays as jfrom_arrays

import graphmine_tpu_torch as gm
from graphmine_tpu_torch.graph.container import build_graph, message_ptr
from graphmine_tpu_torch.io.edges import EdgeTable, from_arrays


def _same_nx(a, b) -> None:
    assert type(a) is type(b)
    assert list(a.nodes(data=True)) == list(b.nodes(data=True))
    assert sorted(a.edges()) == sorted(b.edges())


def test_surface_bridges_and_message_ptr_match_the_jax_package():
    # every JAX export, under its name, resolving to the port's own object
    assert set(graphmine_tpu.__all__) - {"__version__"} == set(gm.__all__) - {"resolve_device"}
    for name in gm.__all__:
        value = getattr(gm, name)
        where = value.__name__ if isinstance(value, types.ModuleType) else value.__module__
        assert where.startswith("graphmine_tpu_torch"), (name, where)
    assert isinstance(gm.datasets, types.ModuleType) and isinstance(gm.obs, types.ModuleType)

    rng = np.random.default_rng(7)
    src = rng.integers(0, 40, 200).astype(np.int32)
    dst = rng.integers(0, 40, 200).astype(np.int32)
    names = np.array([f"v{i}" for i in range(40)])
    et, jet = from_arrays(src, dst, names=names), jfrom_arrays(src, dst, names=names)
    labels = rng.integers(0, 5, 40)
    for directed in (True, False):
        for multigraph in (True, False):
            kw = {"directed": directed, "multigraph": multigraph}
            _same_nx(gm.to_networkx(et, labels=labels, **kw),
                     jto_nx(jet, labels=labels, **kw))
            _same_nx(gm.to_networkx(build_graph(src, dst, num_vertices=40, device="cpu"),
                                    labels=torch.from_numpy(labels), **kw),
                     jto_nx(jbuild_graph(src, dst, num_vertices=40), labels=labels, **kw))

    # NetworkX -> EdgeTable and -> Graph: the JAX package's tables and CSR
    nxg = jto_nx(jet, multigraph=True)
    nxg.add_edge("extra", 3)  # a node object that is no int, named by str()
    back, jback = gm.from_networkx(nxg), jfrom_nx(nxg)
    assert isinstance(back, EdgeTable)
    np.testing.assert_array_equal(back.src, jback.src)
    np.testing.assert_array_equal(back.dst, jback.dst)
    assert back.names.tolist() == jback.names.tolist()
    g, jg = gm.graph_from_networkx(nxg, device="cpu"), jgraph_from_nx(nxg)
    for key in ("src", "dst", "msg_recv", "msg_send", "msg_ptr"):
        np.testing.assert_array_equal(getattr(g, key).numpy(), np.asarray(getattr(jg, key)))
    und = nx.karate_club_graph()
    np.testing.assert_array_equal(gm.from_networkx(und).src, jfrom_nx(und).src)

    for symmetric in (True, False):
        want = jmessage_ptr(src, dst, 45, symmetric=symmetric)
        np.testing.assert_array_equal(message_ptr(src, dst, 45, symmetric=symmetric), want)
        np.testing.assert_array_equal(
            message_ptr(torch.from_numpy(src), torch.from_numpy(dst), 45, symmetric), want)
    recv = np.concatenate([dst, src])
    np.testing.assert_array_equal(message_ptr(None, None, 45, recv=recv),
                                  jmessage_ptr(None, None, 45, recv=recv))
