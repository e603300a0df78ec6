"""Shared set-up of the benchmark's own tests (``python -m pytest
benchmark/tests``): the repository root on ``sys.path``, the ``card``
marker, and small configurations of the cells for the CPU."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_PARAMS = {
    "graph500-22": {"scale": 12, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19},
    "e2e-2e18": {"num_vertices": 4096, "num_edges": 120000, "n_communities": None,
                 "size_skew": 0.7, "n_friends": 4, "hub_skew": 1.3, "hub_scale": 20.0,
                 "p_noise": 0.03, "num_anomalies": None, "edges_per_anomaly": 60},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided in a fixture)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_cell(name: str):
    """The cell ``name`` with its configuration cut to a CPU test's size."""
    from benchmark import harness

    cell = harness.resolve_cell(harness.load_spec(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["generator"]["params"] = dict(SMALL_PARAMS[cell.config["name"]])
    return cell


CELLS = ("graph500-22.cdlp", "e2e-2e18.lof", "e2e-2e18.cdlp", "graph500-22.wcc")
