"""Port parity: datasets, ingestion and the message CSR + bucketed plan.

The same seeds go through the JAX package and the PyTorch port on the CPU;
generators must be bit-equal, ids identical, CSR and plan arrays equal.
"""

import numpy as np
import pytest

from graphmine_tpu import datasets as jdatasets
from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.graph.container import simple_undirected_edges as jsimple
from graphmine_tpu.io.edges import from_arrays as jfrom_arrays
from graphmine_tpu.io.edges import load_edge_list as jload_edge_list
from graphmine_tpu.ops.bucketed_mode import build_graph_and_plan as jbuild_graph_and_plan

import torch

from graphmine_tpu_torch import datasets as tdatasets
from graphmine_tpu_torch.graph.container import build_graph, simple_undirected_edges
from graphmine_tpu_torch.interop import graph_from_reference_arrays, reference_arrays
from graphmine_tpu_torch.io.edges import from_arrays, load_edge_list
from graphmine_tpu_torch.ops.bucketed_mode import build_graph_and_plan

CPU = "cpu"


def _hub_graph(seed=3, v=600, hub_deg=2600, e=3000):
    """Random edges plus a vertex of message degree > 2048 (the histogram path)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, v, e), np.zeros(hub_deg, np.int64)])
    dst = np.concatenate([rng.integers(0, v, e), rng.integers(1, v, hub_deg)])
    return src.astype(np.int32), dst.astype(np.int32), v


@pytest.mark.parametrize("gen", ["rmat", "sbm", "planted"])
def test_datasets_bit_equal(gen):
    if gen == "rmat":
        a, b = jdatasets.rmat(10, 8, seed=5), tdatasets.rmat(10, 8, seed=5)
    elif gen == "sbm":
        a = jdatasets.sbm([40, 60, 80], 0.2, 0.01, seed=2)
        b = tdatasets.sbm([40, 60, 80], 0.2, 0.01, seed=2)
    else:
        a = jdatasets.planted_anomaly_graph(2048, 20_000, seed=9)
        b = tdatasets.planted_anomaly_graph(2048, 20_000, seed=9)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_edge_list_ids_match(tmp_path):
    src, dst, _, _ = tdatasets.planted_anomaly_graph(512, 4000, seed=4)
    p = tmp_path / "e.txt"
    np.savetxt(p, np.stack([src * 7 + 3, dst * 7 + 3], 1), fmt="%d")
    # the NumPy paths, bulk and chunked (interned chunk by chunk, as the
    # JAX chunked path); tests/test_torch_native.py holds the native parsers
    for chunk in (None, 1 << 12):
        ref = jload_edge_list(str(p), use_native=False, chunk_bytes=chunk)
        et = load_edge_list(str(p), use_native=False, chunk_bytes=chunk)
        np.testing.assert_array_equal(et.names.astype(str), ref.names.astype(str))
        np.testing.assert_array_equal(et.src, ref.src)
        np.testing.assert_array_equal(et.dst, ref.dst)
        assert et.num_rows_raw == ref.num_rows_raw == len(src)


def test_from_arrays_matches():
    a = jfrom_arrays([0, 2, 5], [1, 1, 3])
    b = from_arrays([0, 2, 5], [1, 1, 3])
    np.testing.assert_array_equal(a.names, b.names)
    assert a.num_vertices == b.num_vertices == 6


@pytest.mark.parametrize("symmetric", [True, False])
def test_csr_array_equal(symmetric):
    src, dst, _, _ = tdatasets.planted_anomaly_graph(1024, 9000, seed=1)
    jg = jbuild_graph(src, dst, symmetric=symmetric)
    tg = build_graph(src, dst, symmetric=symmetric, device=CPU)
    for key in ("src", "dst", "msg_recv", "msg_send", "msg_ptr"):
        np.testing.assert_array_equal(getattr(tg, key).numpy(), np.asarray(getattr(jg, key)))
    assert tg.num_vertices == jg.num_vertices
    np.testing.assert_array_equal(tg.degrees().numpy(), np.asarray(jg.degrees()))
    for x, y in zip(simple_undirected_edges(tg), jsimple(jg)):
        np.testing.assert_array_equal(x, y)


def test_plan_array_equal_with_hub():
    src, dst, v = _hub_graph()
    jg, jp = jbuild_graph_and_plan(src, dst, num_vertices=v)
    tg, tp = build_graph_and_plan(src, dst, num_vertices=v, device=CPU)
    assert jp.hist_vertex_ids is not None and tp.hist_vertex_ids is not None
    ref = reference_arrays(jg, jp)
    got = reference_arrays(tg, tp)
    assert sorted(ref) == sorted(got)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_interop_round_trip():
    src, dst, v = _hub_graph(seed=8)
    jg, jp = jbuild_graph_and_plan(src, dst, num_vertices=v)
    g, plan = graph_from_reference_arrays(reference_arrays(jg, jp), device=CPU)
    assert g.num_vertices == v and plan.num_messages == g.num_messages
    assert g.msg_send.dtype == torch.int32
    g2, none = graph_from_reference_arrays(reference_arrays(jg), device=CPU)
    assert none is None and g2.num_messages == g.num_messages


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_graph([0], [1])


def test_weighted_build_takes_good_weights_and_refuses_bad_ones():
    g = build_graph([0, 1], [1, 2], edge_weights=[1.0, 0.5], device=CPU)
    assert g.msg_weight.tolist() == [1.0, 1.0, 0.5, 0.5]
    for bad, match in (([1.0], "one float per edge"), ([1.0, -1.0], "non-negative"),
                       ([1.0, float("nan")], "non-negative")):
        with pytest.raises(ValueError, match=match):
            build_graph([0, 1], [1, 2], edge_weights=bad, device=CPU)
