"""The blocked plain CDLP (``reference/cdlp_blocked.py``) against the plain
CDLP (``reference/cdlp.py``) on the CPU, and the four-card cell's job at a
small scale: its labels against the blocked reference, its control
against its reference."""

import copy

import pytest
import torch

from benchmark.generators import kronecker, planted
from benchmark.reference.cdlp import cdlp
from benchmark.reference.cdlp_blocked import cdlp_blocked
from conftest import SMALL_PARAMS

CPU = torch.device("cpu")


def _graph(name: str, seed: int):
    gen = kronecker if name == "graph500-22" else planted
    return gen.generate(SMALL_PARAMS[name], seed, CPU)


@pytest.mark.parametrize("blocks", [1, 2, 3, 7])
@pytest.mark.parametrize("name,iters", [("graph500-22", 10), ("e2e-2e18", 5)])
def test_blocked_cdlp_equals_the_plain_cdlp(name, iters, blocks):
    data = _graph(name, 11)
    args = (data["src"], data["dst"], data["num_vertices"])
    want = cdlp(*args, iters)
    got = cdlp_blocked(*args, iters, blocks=blocks, devices=[CPU, CPU])
    assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.parametrize("blocks", [1, 3])
def test_the_blocked_control_differs_from_the_reference(blocks):
    data = _graph("graph500-22", 12)
    args = (data["src"], data["dst"], data["num_vertices"])
    ten = cdlp_blocked(*args, 10, blocks=blocks)
    assert torch.equal(cdlp_blocked(*args, 9, blocks=blocks), cdlp(*args, 9))
    assert int((cdlp_blocked(*args, 9, blocks=blocks) != ten).sum()) > 0


def test_blocked_cdlp_keeps_isolated_and_ragged_blocks():
    # vertices 5 and 6 receive nothing; 7 blocks over 7 vertices, one each
    src, dst = torch.tensor([0, 1, 2, 0]), torch.tensor([1, 2, 3, 4])
    assert torch.equal(cdlp_blocked(src, dst, 7, 3, blocks=7), cdlp(src, dst, 7, 3))
    assert torch.equal(cdlp_blocked(src, dst, 7, 3, blocks=9), cdlp(src, dst, 7, 3))


def test_the_mesh_job_on_a_virtual_mesh(monkeypatch):
    from benchmark import harness

    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")
    cell = harness.resolve_cell(harness.load_spec(), "graph500-26.cdlp-mesh")
    cell.config = copy.deepcopy(cell.config)
    cell.config["generator"]["params"] = dict(SMALL_PARAMS["graph500-22"])
    job = harness.make_job(cell, 3, [CPU] * 4)
    job.setup({})
    out = job.run()
    facts = job.facts
    assert facts["cards"] == 4 and sum(facts["card_messages"]) == facts["messages"]
    assert sum(facts["card_vertices"]) == facts["vertices"]
    job.release()
    ref = job.reference()
    assert job.compare(out, ref) == {"label_mismatches": 0}
    assert job.compare(job.control(), ref)["label_mismatches"] > 0
