"""The run harness end to end: the port's ``run_pipeline`` against the JAX
package's, one device, the same injected fault plan on both.

The cases are the JAX package's own resilience cases
(``tests/test_resilience.py``): transient retry, the OOM degradation of
the LPA superstep, the LOF ladder in both directions, preemption and
resume, a corrupted checkpoint, a hung superstep, the fingerprint
refusal, poisoned labels with and without a checkpoint, and the tripwire
on a checkpointed superstep. Labels must be bit-equal to the JAX run's
and to the fault-free run's, and the recovery records (``retry``,
``degrade``, ``resume``, ``tripwire``, ``watchdog_timeout``,
``checkpoint_rollback*``, ``retries_exhausted``) must carry the same
stages, rungs, attempts and iterations. LOF scores agree to rtol 1e-4.

Both loaders take their NumPy paths (column-by-column interning), so the
two packages assign the same vertex ids.
"""

import functools
import os

import numpy as np
import pytest

from graphmine_tpu.io import native as jnative
from graphmine_tpu.pipeline import checkpoint as jckpt
from graphmine_tpu.pipeline import resilience as jres
from graphmine_tpu.pipeline.config import PipelineConfig as JConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch.io.edges import load_edge_list
from graphmine_tpu_torch.pipeline import checkpoint as ckpt
from graphmine_tpu_torch.pipeline import driver
from graphmine_tpu_torch.pipeline import resilience as res
from graphmine_tpu_torch.pipeline.config import PipelineConfig
from graphmine_tpu_torch.pipeline.driver import run_pipeline
from graphmine_tpu_torch.testing import faults

pytestmark = pytest.mark.faults

RECOVERY = ("retry", "retries_exhausted", "degrade", "resume", "tripwire",
            "watchdog_timeout", "checkpoint_rollback", "checkpoint_rollback_ok")
KEYS = ("stage", "to", "depth", "kind", "attempt", "attempts", "iteration", "reason",
        "shard", "bad_vertices", "checkpointed", "timeout_s")


@pytest.fixture(scope="module")
def graph_path(tmp_path_factory):
    """The JAX resilience suite's graph: two planted communities of 80
    vertices plus 5% random cross edges, 800 edges."""
    rng = np.random.default_rng(7)
    v, e = 160, 800
    src = rng.integers(0, v, e)
    dst = (src + rng.integers(1, v // 2, e)) % (v // 2) + (src // (v // 2)) * (v // 2)
    cross = rng.random(e) < 0.05
    dst = np.where(cross, rng.integers(0, v, e), dst)
    path = tmp_path_factory.mktemp("harness") / "edges.txt"
    path.write_text("".join(f"{s} {t}\n" for s, t in zip(src, dst)))
    return str(path)


@pytest.fixture(autouse=True)
def numpy_loaders(monkeypatch):
    monkeypatch.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
    monkeypatch.setattr(driver, "load_edge_list",
                        functools.partial(load_edge_list, use_native=False))


def _jcfg(path, resilience=None, **kw):
    resilience = dict(backoff_base_s=0.001, backoff_max_s=0.01, **(resilience or {}))
    base = dict(data_path=path, data_format="edgelist", outlier_method="none",
                num_devices=1, max_iter=5, resilience=jres.ResilienceConfig(**resilience))
    return JConfig(**{**base, **kw})


def _pcfg(path, resilience=None, **kw):
    resilience = dict(backoff_base_s=0.001, backoff_max_s=0.01, **(resilience or {}))
    base = dict(data_path=path, data_format="edgelist", outlier_method="none",
                max_iter=5, resilience=res.ResilienceConfig(**resilience), device="cpu")
    return PipelineConfig(**{**base, **kw})


def _trail(metrics) -> list:
    return [(r["phase"], {k: r[k] for k in KEYS if k in r})
            for r in metrics.records if r["phase"] in RECOVERY]


@pytest.fixture(scope="module")
def baseline(graph_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
        mp.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
        mp.setattr(driver, "load_edge_list", functools.partial(load_edge_list, use_native=False))
        ref = np.asarray(jrun(_jcfg(graph_path)).labels)
        port = run_pipeline(_pcfg(graph_path)).labels
    np.testing.assert_array_equal(port, ref)
    return port


def _both(plan, jkw, pkw, raises=(None, None)):
    """Run the JAX and the port pipeline under the same fault plan
    (``plan(faults_module)`` -> [(site, factory, at, repeat)]); returns
    the two results, or the two raised errors."""
    out = []
    for mod, run, kw, exc in ((jfaults, jrun, jkw, raises[0]), (faults, run_pipeline, pkw,
                                                                 raises[1])):
        inj = mod.FaultInjector()
        for site, factory, at, repeat in plan(mod):
            inj.add(site, factory, at=at, repeat=repeat)
        with inj.installed():
            if exc is None:
                out.append(run(kw()))
            else:
                with pytest.raises(exc) as ei:
                    run(kw())
                out.append(ei.value)
    return out


def test_transient_errors_retry_to_identical_labels(graph_path, baseline):
    ref, port = _both(lambda f: [("load", f.transient_error, 1, 1),
                                 ("lpa_superstep", f.transient_error, 2, 1)],
                      lambda: _jcfg(graph_path), lambda: _pcfg(graph_path))
    np.testing.assert_array_equal(port.labels, baseline)
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    assert _trail(port.metrics) == _trail(ref.metrics)
    assert {r["stage"] for r in port.metrics.of_phase("retry")} == {"load", "lpa"}


def test_oom_degrades_bucketed_to_sort(graph_path, baseline):
    ref, port = _both(lambda f: [("lpa_superstep", f.oom_error, 2, 1)],
                      lambda: _jcfg(graph_path), lambda: _pcfg(graph_path))
    np.testing.assert_array_equal(port.labels, baseline)
    assert _trail(port.metrics) == _trail(ref.metrics)
    (deg,) = port.metrics.of_phase("degrade")
    assert deg["stage"] == "lpa" and deg["to"] == "single_sort"
    assert "mem" in deg and deg["mem"]["family"] == "bucketed"
    assert [r["iteration"] for r in port.metrics.of_phase("lpa_iter")] == [1, 2, 3, 4, 5]


def test_failed_rung_memory_is_released_before_the_next(graph_path):
    """The OOM rung's superstep cache and the bucketed plan are dropped
    when the sort rung starts: the plan holder is emptied."""
    inj = faults.FaultInjector().add("lpa_superstep", faults.oom_error, at=2)
    seen = {}
    real = driver._run_lpa

    def spy(config, table, graph, m, plan_holder, *a):
        seen["holder"] = plan_holder
        return real(config, table, graph, m, plan_holder, *a)

    with inj.installed(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "_run_lpa", spy)
        run_pipeline(_pcfg(graph_path))
    assert seen["holder"] == [None]


@pytest.mark.parametrize("primary", ["exact", "ivf"])
def test_lof_ladder_crosses_to_the_other_family(graph_path, monkeypatch, primary):
    monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", "64")
    jimpl, pimpl = ("xla", "exact") if primary == "exact" else ("auto", "auto")
    ref, port = _both(lambda f: [("outliers_lof", f.oom_error, 1, 1)],
                      lambda: _jcfg(graph_path, outlier_method="lof", lof_k=8, lof_impl=jimpl),
                      lambda: _pcfg(graph_path, outlier_method="lof", lof_k=8, lof_impl=pimpl))
    other = "ivf" if primary == "exact" else "exact"
    (deg,) = port.metrics.of_phase("degrade")
    assert deg["stage"] == "outliers_lof" and deg["to"] == f"lof_{other}"
    assert deg["mem"]["family"] == primary
    assert _trail(port.metrics) == _trail(ref.metrics)
    sel = [r["impl"] for r in port.metrics.of_phase("impl_selected") if r["op"] == "lof_knn"]
    assert sel == [other]
    (wm,) = [r for r in port.metrics.of_phase("memory_watermark") if r["op"] == "lof_knn"]
    assert wm["impl"] == other
    np.testing.assert_allclose(port.lof, np.asarray(ref.lof), rtol=1e-4)


def test_preemption_resumes_to_identical_labels(graph_path, baseline, tmp_path):
    jck, pck = str(tmp_path / "jck"), str(tmp_path / "pck")
    errs = _both(lambda f: [("lpa_superstep", f.preemption, 3, 1)],
                 lambda: _jcfg(graph_path, checkpoint_dir=jck),
                 lambda: _pcfg(graph_path, checkpoint_dir=pck),
                 raises=(jfaults.SimulatedPreemption, faults.SimulatedPreemption))
    assert len(errs) == 2
    assert ckpt.load_labels(pck)[1] == jckpt.load_labels(jck)[1] == 2
    ref = jrun(_jcfg(graph_path, checkpoint_dir=jck, resume=True))
    port = run_pipeline(_pcfg(graph_path, checkpoint_dir=pck, resume=True))
    np.testing.assert_array_equal(port.labels, baseline)
    assert _trail(port.metrics) == _trail(ref.metrics) == [("resume", {"iteration": 2})]


def test_corrupted_checkpoint_rolls_back(graph_path, baseline, tmp_path):
    trails = []
    for run, cfg, mod, d in ((jrun, _jcfg, jfaults, "jck"), (run_pipeline, _pcfg, faults, "pck")):
        ck = str(tmp_path / d)
        run(cfg(graph_path, checkpoint_dir=ck))
        mod.corrupt_file(os.path.join(ck, "lpa_labels.npz"))
        out = run(cfg(graph_path, checkpoint_dir=ck, resume=True))
        np.testing.assert_array_equal(np.asarray(out.labels), baseline)
        trails.append(_trail(out.metrics))
    assert trails[1] == trails[0]
    assert ("resume", {"iteration": 4}) in trails[1]
    assert [p for p, _ in trails[1]][:2] == ["checkpoint_rollback", "checkpoint_rollback_ok"]


def test_hung_superstep_checkpoints_then_resumes(graph_path, baseline, tmp_path):
    jck, pck = str(tmp_path / "jck"), str(tmp_path / "pck")
    watchdog = dict(superstep_timeout_s=0.3)
    errs = _both(lambda f: [("lpa_superstep", f.hang(3.0), 2, 1)],
                 lambda: _jcfg(graph_path, checkpoint_dir=jck, checkpoint_every=10,
                               resilience=watchdog),
                 lambda: _pcfg(graph_path, checkpoint_dir=pck, checkpoint_every=10,
                               resilience=watchdog),
                 raises=(jres.SuperstepTimeout, res.SuperstepTimeout))
    assert "was checkpointed" in str(errs[1])
    assert ckpt.load_labels(pck)[1] == jckpt.load_labels(jck)[1] == 1
    port = run_pipeline(_pcfg(graph_path, checkpoint_dir=pck, resume=True))
    np.testing.assert_array_equal(port.labels, baseline)
    assert port.metrics.of_phase("resume")[0]["iteration"] == 1


def test_fingerprint_mismatch_refuses_resume(graph_path, tmp_path):
    lines = open(graph_path).readlines()
    permuted = tmp_path / "permuted.txt"
    permuted.write_text("".join(reversed(lines)))
    weighted = tmp_path / "weighted.txt"
    weighted.write_text("".join(f"{ln.rstrip()} {1.0 + i % 3}\n" for i, ln in enumerate(lines)))
    for run, cfg, mod, d in ((jrun, _jcfg, jckpt, "jck"), (run_pipeline, _pcfg, ckpt, "pck")):
        ck = str(tmp_path / d)
        run(cfg(graph_path, checkpoint_dir=ck, max_iter=2))
        with pytest.raises(mod.FingerprintMismatch, match="different graph"):
            run(cfg(str(permuted), checkpoint_dir=ck, resume=True))
        with pytest.raises(mod.FingerprintMismatch):
            run(cfg(str(weighted), edge_weight_col=2, checkpoint_dir=ck, resume=True))


def test_poisoned_labels_trip_roll_back_and_complete(graph_path, baseline, tmp_path):
    ref, port = _both(lambda f: [("lpa_superstep", f.poison_labels(shard=1, num_shards=4), 3, 1)],
                      lambda: _jcfg(graph_path, checkpoint_dir=str(tmp_path / "jck"),
                                    resilience=dict(tripwire_every_k=1)),
                      lambda: _pcfg(graph_path, checkpoint_dir=str(tmp_path / "pck"),
                                    resilience=dict(tripwire_every_k=1)))
    np.testing.assert_array_equal(port.labels, baseline)
    assert _trail(port.metrics) == _trail(ref.metrics)
    (tw,) = port.metrics.of_phase("tripwire")
    assert tw["kind"] == "label_out_of_range" and tw["iteration"] == 3
    assert tw["shard"] == 0 and tw["bad_vertices"] > 0
    resume = port.metrics.of_phase("resume")
    assert resume[0]["iteration"] == 2 and resume[0]["reason"] == "tripwire"


def test_poisoned_labels_without_checkpoint_raise(graph_path):
    errs = _both(lambda f: [("lpa_superstep", f.poison_labels(shard=0, num_shards=4), 2, 1)],
                 lambda: _jcfg(graph_path, resilience=dict(max_retries=1, tripwire_every_k=1)),
                 lambda: _pcfg(graph_path, resilience=dict(max_retries=1, tripwire_every_k=1)),
                 raises=(jres.RetriesExhausted, res.RetriesExhausted))
    assert isinstance(errs[0].__cause__, jres.DivergenceError)
    assert isinstance(errs[1].__cause__, res.DivergenceError)


def test_checkpointed_supersteps_are_always_guarded(graph_path, baseline, tmp_path):
    ref, port = _both(lambda f: [("lpa_superstep", f.poison_labels(shard=1, num_shards=4), 3, 1)],
                      lambda: _jcfg(graph_path, checkpoint_dir=str(tmp_path / "jck"),
                                    resilience=dict(tripwire_every_k=2)),
                      lambda: _pcfg(graph_path, checkpoint_dir=str(tmp_path / "pck"),
                                    resilience=dict(tripwire_every_k=2)))
    np.testing.assert_array_equal(port.labels, baseline)
    assert _trail(port.metrics) == _trail(ref.metrics)
    assert port.metrics.of_phase("tripwire")[0]["iteration"] == 3
    assert port.metrics.of_phase("resume")[0]["iteration"] == 2
