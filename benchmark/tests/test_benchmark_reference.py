"""The plain reference against the program on the CPU at small sizes."""

import pytest
import torch

from benchmark.generators import kronecker, planted
from benchmark.reference import features, lof
from benchmark.reference.cdlp import cdlp
from benchmark.reference.wcc import wcc
from conftest import SMALL_PARAMS

CPU = torch.device("cpu")


def _graph(name: str, seed: int):
    gen = kronecker if name == "graph500-22" else planted
    return gen.generate(SMALL_PARAMS[name], seed, CPU)


def _port_graph(data):
    from graphmine_tpu_torch.graph.container import build_graph

    return build_graph(data["src"].numpy(), data["dst"].numpy(),
                       num_vertices=data["num_vertices"], device="cpu")


@pytest.mark.parametrize("name,iters", [("graph500-22", 10), ("e2e-2e18", 5)])
@pytest.mark.parametrize("plan", ["auto", None])
def test_cdlp_equals_the_programs_label_propagation(name, iters, plan):
    from graphmine_tpu_torch.ops.lpa import label_propagation

    data = _graph(name, 5)
    want = cdlp(data["src"], data["dst"], data["num_vertices"], iters)
    got = label_propagation(_port_graph(data), max_iter=iters, plan=plan)
    assert torch.equal(got.long(), want)


def test_cdlp_breaks_ties_to_the_smallest_label():
    # a path 0-1-2: vertex 1 sees labels 0 and 2 once each
    src, dst = torch.tensor([0, 1]), torch.tensor([1, 2])
    assert cdlp(src, dst, 3, 1).tolist() == [1, 0, 1]


@pytest.mark.parametrize("name", ["graph500-22", "e2e-2e18"])
def test_wcc_equals_the_programs_components(name):
    from graphmine_tpu_torch.ops.cc import connected_components

    data = _graph(name, 6)
    want, steps = wcc(data["src"], data["dst"], data["num_vertices"])
    assert steps > 0
    assert torch.equal(connected_components(_port_graph(data)).long(), want)


def test_wcc_labels_each_component_by_its_smallest_id():
    src, dst = torch.tensor([4, 2, 5]), torch.tensor([2, 0, 3])
    labels, steps = wcc(src, dst, 6)
    assert labels.tolist() == [0, 1, 0, 3, 0, 3]
    short, _ = wcc(src, dst, 6, max_steps=steps - 1)
    assert not torch.equal(short, labels)


def test_knn_sets_equal_the_programs_on_a_cloud_with_ties():
    from graphmine_tpu_torch.ops.knn import knn

    # small integers: every distance is exact in float32, and ties abound
    g = torch.Generator().manual_seed(3)
    pts = torch.randint(0, 4, (700, 3), generator=g).to(torch.float32)
    d2, idx = lof.knn(pts, 40, block=128)
    pd2, pidx = knn(pts, 40)
    assert torch.equal(torch.sort(idx, dim=1).values, torch.sort(pidx.long(), dim=1).values)
    assert torch.equal(torch.sort(d2, dim=1).values, pd2)


def test_knn_distances_are_the_programs_bits_on_a_normal_cloud():
    from graphmine_tpu_torch.ops.knn import knn

    g = torch.Generator().manual_seed(5)
    pts = torch.randn(900, 8, generator=g)
    d2, idx = lof.knn(pts, 24, block=100)
    pd2, pidx = knn(pts, 24)
    assert torch.equal(torch.sort(idx, dim=1).values, torch.sort(pidx.long(), dim=1).values)
    assert torch.equal(torch.sort(d2, dim=1).values, pd2)


def test_lof_equals_the_programs_within_float32_rounding():
    from graphmine_tpu_torch.ops.lof import lof_scores

    g = torch.Generator().manual_seed(4)
    pts = torch.randn(1500, 8, generator=g)
    want = lof.lof(pts, 32, block=256)
    got = lof_scores(pts, k=32, impl="exact").to(torch.float64)
    assert float(((got - want).abs() / want).max()) < 1e-5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -2.0 - 2.0**-12])
    assert lof.round_to_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -2.0]


def test_feature_columns_follow_the_programs_definitions():
    from graphmine_tpu_torch.ops.features import _vertex_features

    data = _graph("e2e-2e18", 8)
    v = data["num_vertices"]
    comm = cdlp(data["src"], data["dst"], v, 5)
    mine = features.vertex_features(data["src"], data["dst"], v, comm, 64, 8)
    theirs = _vertex_features(_port_graph(data), comm, mine[:, 7].clone())
    assert torch.allclose(mine, theirs, rtol=1e-6, atol=1e-6)
    # the sampled clustering column is a share of 64 samples
    assert bool(((mine[:, 7] * 64).round() == mine[:, 7] * 64).all())
    z = features.standardize(mine)
    assert torch.allclose(z.double().mean(0), torch.zeros(8, dtype=torch.float64), atol=1e-5)
