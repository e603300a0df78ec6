"""The comparison that decides ``correct`` can fail: the control fails
each cell's limits, and a run with the program broken underneath comes
out not correct, for each fault the cell can have."""

import pytest
import torch

import graphmine_tpu_torch.ops.bucketed_mode as bucketed_mode
import graphmine_tpu_torch.ops.cc as cc
import graphmine_tpu_torch.ops.lof as lof_ops
import graphmine_tpu_torch.ops.lpa as lpa
from benchmark import harness
from conftest import CELLS, small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 7, 90_000_000_001])
def test_the_control_fails_the_limits(name, seed):
    cell = small_cell(name)
    job = harness.make_job(cell, seed, CPU)
    job.setup({})
    ref = job.reference()
    assert all(v <= cell.limits[k] for k, v in job.compare(job.run(), ref).items())
    assert any(v > cell.limits[k] for k, v in job.compare(job.control(), ref).items())


def _unchanged(_fn):
    return lambda labels, *args: labels.to(torch.int32)


def _half(fn):
    def step(labels, *args):
        new = fn(labels, *args).clone()
        half = new.shape[0] // 2
        new[half:] = labels[half:].to(new.dtype)
        return new
    return step


def _altered(fn):
    def entry(*args, **kwargs):
        out = fn(*args, **kwargs)
        labels = (out[0] if isinstance(out, tuple) else out).clone()
        labels[labels.shape[0] // 3] += 1
        return (labels, *out[1:]) if isinstance(out, tuple) else labels
    return entry


def _half_knn(fn):
    def knn(points, k, *args, **kwargs):
        d2, idx = fn(points, k, *args, **kwargs)
        half = d2.shape[0] // 2
        d2, idx = d2.clone(), idx.clone()
        d2[half:], idx[half:] = d2[:d2.shape[0] - half], idx[:d2.shape[0] - half]
        return d2, idx
    return knn


def _doubled_score(fn):
    def entry(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[out.shape[0] // 3] *= 2
        return out
    return entry


FAULTS = [
    ("graph500-22.cdlp", "unchanged", bucketed_mode, "lpa_superstep_bucketed", _unchanged),
    ("graph500-22.cdlp", "half", bucketed_mode, "lpa_superstep_bucketed", _half),
    ("graph500-22.cdlp", "altered", lpa, "label_propagation", _altered),
    ("e2e-2e18.cdlp", "unchanged", bucketed_mode, "lpa_superstep_bucketed", _unchanged),
    ("e2e-2e18.cdlp", "half", bucketed_mode, "lpa_superstep_bucketed", _half),
    ("e2e-2e18.cdlp", "altered", lpa, "label_propagation", _altered),
    ("graph500-22.wcc", "unchanged", cc, "cc_superstep_bucketed", _unchanged),
    ("graph500-22.wcc", "half", cc, "cc_superstep_bucketed", _half),
    ("graph500-22.wcc", "altered", cc, "connected_components", _altered),
    ("e2e-2e18.lof", "half", lof_ops, "knn", _half_knn),
    ("e2e-2e18.lof", "altered", lof_ops, "lof_scores", _doubled_score),
]


@pytest.mark.parametrize("name,fault,module,attr,wrap", FAULTS,
                         ids=[f"{f[0]}-{f[1]}" for f in FAULTS])
def test_a_run_with_a_fault_underneath_is_not_correct(name, fault, module, attr, wrap,
                                                      monkeypatch):
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    result = harness.run_cell(small_cell(name), 2**31 + 5, 0.2, False, CPU)
    assert result["correct"] is False and result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
