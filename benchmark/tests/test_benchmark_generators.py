"""The generators: the same seed gives the same graph, another seed
another, and the Kronecker draw is simple, undirected and compact."""

import torch

from benchmark.generators import kronecker, planted
from conftest import SMALL_PARAMS

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 123_456_789


def _same(a: dict, b: dict) -> bool:
    return (a["num_vertices"] == b["num_vertices"] and torch.equal(a["src"], b["src"])
            and torch.equal(a["dst"], b["dst"]))


def test_kronecker_is_a_function_of_the_seed():
    params = SMALL_PARAMS["graph500-22"]
    one = kronecker.generate(params, BIG_SEED, CPU)
    assert _same(one, kronecker.generate(params, BIG_SEED, CPU))
    assert not _same(one, kronecker.generate(params, BIG_SEED + 1, CPU))


def test_kronecker_counts_at_a_small_scale():
    params = {**SMALL_PARAMS["graph500-22"], "scale": 10}
    g = kronecker.generate(params, 7, CPU)
    src, dst, v = g["src"].long(), g["dst"].long(), g["num_vertices"]
    e = src.numel()
    # 16 * 1024 draws, less self-loops and repeated pairs; no isolated ids
    assert 0.5 * 16 * 1024 < e < 16 * 1024
    assert 0.3 * 1024 < v <= 1024
    assert g["src"].dtype == torch.int32 and g["dst"].dtype == torch.int32
    assert bool((src < dst).all())
    assert torch.unique(src * v + dst).numel() == e
    assert torch.equal(torch.unique(torch.cat([src, dst])), torch.arange(v))
    # sorted by (a, b), as the dataset's file lists it
    key = src * v + dst
    assert bool((key[1:] > key[:-1]).all())


def test_kronecker_skew_puts_hubs_in_the_graph():
    g = kronecker.generate(SMALL_PARAMS["graph500-22"], 3, CPU)
    deg = torch.bincount(torch.cat([g["src"], g["dst"]]).long())
    assert int(deg.max()) > 20 * float(deg.float().mean())


def test_planted_is_a_function_of_the_seed_and_keeps_its_counts():
    params = SMALL_PARAMS["e2e-2e18"]
    one = planted.generate(params, BIG_SEED, CPU)
    assert _same(one, planted.generate(params, BIG_SEED, CPU))
    assert not _same(one, planted.generate(params, BIG_SEED + 1, CPU))
    anomalies = max(32, params["num_vertices"] // 2000)
    assert one["src"].numel() == params["num_edges"] + anomalies * params["edges_per_anomaly"]
    assert one["num_vertices"] == params["num_vertices"]
    both = torch.cat([one["src"], one["dst"]]).long()
    assert int(both.min()) >= 0 and int(both.max()) < params["num_vertices"]
    # the edge budget lands as duplicate multiplicity
    pairs = torch.unique(one["src"].long() * params["num_vertices"] + one["dst"].long())
    assert pairs.numel() < 0.8 * one["src"].numel()
