"""The port's resilience layer against the JAX package's.

``classify_error`` gives the JAX classifier's class for every message of
``tests/test_resilience.py``'s taxonomy tests, and maps torch's errors
(``torch.cuda.OutOfMemoryError`` by type, the sticky CUDA errors fatal);
``ResilienceConfig`` validates and ``backoff_s`` computes the same;
``run_phase`` leaves the same record trail for the same stub thunks; the
watchdog cases hold; and a thunk that fails degradable leaves no tensor
alive when the next rung starts.
"""

import random
import time
import weakref

import pytest
import torch

from graphmine_tpu.obs import spans as jspans
from graphmine_tpu.pipeline import resilience as jres
from graphmine_tpu.pipeline.metrics import MetricsSink as JSink
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch.obs import spans
from graphmine_tpu_torch.pipeline import resilience as res
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.testing import faults

pytestmark = pytest.mark.faults


def _err(cls, msg, **attrs):
    e = cls(msg)
    for k, v in attrs.items():
        setattr(e, k, v)
    return e


# every message of the JAX package's taxonomy tests
TAXONOMY = [
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("DEADLINE_EXCEEDED: rpc"),
    ConnectionResetError("peer"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 1 bytes"),
    MemoryError(),
    RuntimeError("RESOURCE_EXHAUSTED: OOM; socket closed while spilling"),
    ValueError("bad config"),
    KeyError("x"),
    _err(RuntimeError, "UNAVAILABLE: looks transient", graphmine_error_class="fatal"),
    RuntimeError("DATA_LOSS: checkpoint shard unreadable"),
    RuntimeError("UNAVAILABLE: device failure on chip 0"),
    ValueError("failed reading /data/DATA_LOSS_run/x"),
    RuntimeError("INTERNAL: CpuCallback error: GRAPHMINE_DIVERGENCE: x"),
    RuntimeError("failed reading /data/ABORTED_run/x"),
    # torch's out-of-memory message, as the caching allocator words it
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: out of memory"),
]


@pytest.mark.parametrize("exc", TAXONOMY, ids=lambda e: f"{type(e).__name__}:{e}"[:60])
def test_classify_error_matches_the_jax_classifier(exc):
    assert res.classify_error(exc) == jres.classify_error(exc)


def test_injected_faults_classify_alike():
    for name in ("transient_error", "oom_error", "preemption"):
        assert res.classify_error(getattr(faults, name)()) == \
            jres.classify_error(getattr(jfaults, name)())
    de = res.DivergenceError("label_out_of_range", 3, 7)
    assert res.classify_error(de) == res.RETRYABLE
    assert (de.kind, de.shard, de.iteration) == ("label_out_of_range", 3, 7)


def test_torch_errors():
    oom = faults.oom_error()
    assert isinstance(oom, torch.cuda.OutOfMemoryError)
    assert res.classify_error(oom) == res.DEGRADABLE
    # matched by type before any message test
    assert res.classify_error(torch.cuda.OutOfMemoryError("no marker")) == res.DEGRADABLE
    assert faults.device_oom("cpu").args == faults.oom_error().args
    for sticky in ("CUDA error: an illegal memory access was encountered",
                   "CUDA error: device-side assert triggered",
                   "CUDA error: unspecified launch failure",
                   "CUDA error: misaligned address"):
        # fatal even where a retryable or degradable marker rides along
        for prefix in ("", "UNAVAILABLE: ", "RESOURCE_EXHAUSTED: out of memory; "):
            assert res.classify_error(RuntimeError(prefix + sticky)) == res.FATAL


@pytest.mark.parametrize("kw", [dict(), dict(max_retries=-1), dict(jitter=1.5),
                                dict(superstep_timeout_s=0), dict(degradation="maybe"),
                                dict(tripwire_every_k=-1), dict(backoff_base_s=-1),
                                dict(tripwire_every_k=4)])
def test_resilience_config_validation_matches(kw):
    outcomes = []
    for mod in (jres, res):
        try:
            mod.ResilienceConfig(**kw).validate()
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_backoff_equal():
    for pol in ((0.1, 0.4, 0.0), (0.1, 10.0, 0.5), (0.05, 5.0, 0.5)):
        jp = jres.ResilienceConfig(backoff_base_s=pol[0], backoff_max_s=pol[1], jitter=pol[2])
        pp = res.ResilienceConfig(backoff_base_s=pol[0], backoff_max_s=pol[1], jitter=pol[2])
        for n in range(1, 7):
            assert res.backoff_s(pp, n, random.Random(n)) == jres.backoff_s(jp, n, random.Random(n))


def _no_sleep(_):
    pass


def _trail(sink):
    return [(r["phase"], {k: r[k] for k in ("stage", "to", "depth", "kind", "attempt",
                                            "attempts", "backoff_s", "span_path") if k in r})
            for r in sink.records]


def _scenarios(f):
    """(name, fn, policy kwargs, ladder, device_ladder, progress) stubs,
    built from a faults module."""

    def flaky():
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] < 3:
                raise f.transient_error()
            return "ok"
        return fn

    def boom(factory):
        def fn():
            raise factory()
        return fn

    def rung_flaky():
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] == 1:
                raise f.transient_error()
            return "rung-ok"
        return fn

    return [
        ("retry", flaky(), dict(max_retries=3), (), ()),
        ("exhausted", boom(f.transient_error), dict(max_retries=2), (), ()),
        ("fatal", boom(lambda: ValueError("bug")), dict(max_retries=5), (), ()),
        ("degrade", boom(f.oom_error), dict(), (("smaller", lambda: "ok"),), ()),
        ("ladder_empty", boom(f.oom_error), dict(), (), ()),
        ("degradation_off", boom(f.oom_error), dict(degradation="off"),
         (("smaller", lambda: "no"),), ()),
        ("rung_retried", boom(f.oom_error), dict(max_retries=1), (("rung", rung_flaky()),), ()),
        ("device_loss_one_device", boom(lambda: RuntimeError("DATA_LOSS: device failure")),
         dict(), (("smaller", lambda: "no"),), ()),
    ]


@pytest.mark.parametrize("traced", [False, True], ids=["bare", "traced"])
@pytest.mark.parametrize("case", range(8))
def test_run_phase_record_trail_matches(case, traced):
    """The same records in the same order; traced, each carries the same
    span path (``run/rung:<label>``)."""
    sinks = (JSink(), MetricsSink())
    if traced:
        sinks = (JSink(tracer=jspans.Tracer(run_id="r")),
                 MetricsSink(tracer=spans.Tracer(run_id="r")))
    trails = []
    for mod, fmod, sink in ((jres, jfaults, sinks[0]), (res, faults, sinks[1])):
        name, fn, kw, ladder, dev = _scenarios(fmod)[case]
        policy = mod.ResilienceConfig(**kw)
        try:
            out = mod.run_phase("p", fn, policy, sink, ladder=ladder, device_ladder=dev,
                                sleep=_no_sleep)
        except Exception as e:  # noqa: BLE001 — the class is compared below
            out = (type(e).__name__, mod.classify_error(e))
        trails.append((out, _trail(sink)))
    (jout, jtrail), (pout, ptrail) = trails
    assert ptrail == jtrail
    if isinstance(jout, tuple):
        # the OOM classes differ by package (InjectedOOM / torch's)
        assert pout[1] == jout[1]
    else:
        assert pout == jout


def test_retry_budget_is_per_incident():
    m = MetricsSink()
    state = {"it": 0}
    fail_at = {2, 5, 8}

    def runner():
        while state["it"] < 10:
            if state["it"] in fail_at:
                fail_at.discard(state["it"])
                raise faults.transient_error()
            state["it"] += 1
        return "done"

    assert res.run_phase("p", runner, res.ResilienceConfig(max_retries=1), m,
                         sleep=_no_sleep, progress=lambda: state["it"]) == "done"
    assert [r["attempt"] for r in m.of_phase("retry")] == [1, 1, 1]


def test_failed_rung_tensors_are_dead_when_the_next_rung_starts():
    refs = {}

    def primary():
        big = torch.empty(1 << 16)
        refs["primary"] = weakref.ref(big)
        raise faults.oom_error()

    def rung():
        refs["alive_at_rung"] = refs["primary"]() is not None
        return "ok"

    assert res.run_phase("p", primary, res.ResilienceConfig(), MetricsSink(),
                         ladder=(("rung", rung),), sleep=_no_sleep) == "ok"
    assert refs["alive_at_rung"] is False


def test_retried_attempt_tensors_are_dead_before_the_retry():
    refs = {}
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            t = torch.empty(1 << 16)
            refs["t"] = weakref.ref(t)
            raise faults.transient_error()
        return refs["t"]() is None

    assert res.run_phase("p", flaky, res.ResilienceConfig(), MetricsSink(),
                         sleep=_no_sleep) is True


# ---- the watchdog (tests/test_resilience.py:244-300) --------------------------


def test_watchdog_passthrough_and_errors():
    m = MetricsSink()
    assert res.run_with_watchdog("p", lambda: 42, 5.0, m) == 42
    assert res.run_with_watchdog("p", lambda: 42, None, m) == 42
    with pytest.raises(ValueError):
        res.run_with_watchdog("p", lambda: (_ for _ in ()).throw(ValueError("x")), 5.0, m)
    assert not m.of_phase("watchdog_timeout")


def test_watchdog_times_out_and_checkpoints():
    m = MetricsSink()
    fired = []
    with pytest.raises(res.SuperstepTimeout, match="was checkpointed"):
        res.run_with_watchdog("p", lambda: time.sleep(1.5), 0.1, m,
                              on_timeout=lambda: fired.append(True))
    assert fired == [True]
    (rec,) = m.of_phase("watchdog_timeout")
    assert rec["timeout_s"] == 0.1 and rec["checkpointed"]


def test_watchdog_without_hook_does_not_claim_a_checkpoint():
    m = MetricsSink()
    with pytest.raises(res.SuperstepTimeout, match="NO checkpoint hook"):
        res.run_with_watchdog("p", lambda: time.sleep(1.5), 0.1, m)
    assert m.of_phase("watchdog_timeout")[0]["checkpointed"] is False


def test_watchdog_survives_a_failing_checkpoint_hook():
    m = MetricsSink()

    def bad_save():
        raise OSError("No space left on device")

    with pytest.raises(res.SuperstepTimeout, match="hook FAILED") as ei:
        res.run_with_watchdog("p", lambda: time.sleep(1.5), 0.1, m, on_timeout=bad_save)
    assert isinstance(ei.value.__cause__, OSError)
    assert m.of_phase("watchdog_timeout")[0]["checkpointed"] is False


def test_fault_injector_is_deterministic():
    inj = faults.FaultInjector()
    inj.add("s", faults.transient_error, at=2)
    inj.add("s", faults.oom_error, at=4, repeat=2)
    seen = []
    with inj.installed():
        for i in range(1, 7):
            try:
                res.fault_point("s", i=i)
                seen.append("ok")
            except faults.InjectedTransientError:
                seen.append("transient")
            except torch.cuda.OutOfMemoryError:
                seen.append("oom")
    assert seen == ["ok", "transient", "ok", "oom", "oom", "ok"]
    assert inj.fired("s") == 3 and [ctx["i"] for (_, _, ctx) in inj.log] == list(range(1, 7))
    res.fault_point("s", i=99)
    assert len(inj.log) == 6


def test_poison_labels_keeps_the_tensor_type():
    state = {"labels": torch.arange(8, dtype=torch.int32)}
    faults.poison_labels(shard=1, num_shards=4)(state=state)
    assert state["labels"].dtype == torch.int32
    assert state["labels"].tolist() == [0, 1, -7, -7, 4, 5, 6, 7]


# ---- the elastic mesh rungs and the tripwires, through the driver ---------
#
# A 4-shard virtual CPU mesh (GRAPHMINE_VIRTUAL_DEVICES) runs the
# replicated schedule; the JAX driver runs the same faults on its own
# 4-device virtual mesh. Labels equal the no-fault run's, and the
# recovery records carry the JAX driver's values.


@pytest.fixture(scope="module")
def mesh_graph(tmp_path_factory):
    import numpy as np

    rng = np.random.default_rng(11)
    v, e = 203, 1200
    src = rng.integers(0, v, e)
    dst = (src + rng.integers(1, v // 4, e)) % v
    path = tmp_path_factory.mktemp("mesh") / "edges.txt"
    path.write_text("".join(f"{s} {t}\n" for s, t in zip(src, dst)))
    return str(path)


@pytest.fixture
def mesh_env(monkeypatch):
    import functools

    from graphmine_tpu.io import native as jnative

    from graphmine_tpu_torch.io.edges import load_edge_list
    from graphmine_tpu_torch.pipeline import driver

    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")
    monkeypatch.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
    monkeypatch.setattr(driver, "load_edge_list",
                        functools.partial(load_edge_list, use_native=False))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many small shard ops: keep the workers' cores free
    yield
    torch.set_num_threads(threads)


def _mesh_cfg(pkg, path, **kw):
    from graphmine_tpu.pipeline.config import PipelineConfig as JConfig

    from graphmine_tpu_torch.pipeline.config import PipelineConfig

    base = dict(data_path=path, data_format="edgelist", outlier_method="none", max_iter=5,
                num_devices=4)
    base.update(kw)
    if pkg == "jax":
        base["resilience"] = jres.ResilienceConfig(**{"backoff_base_s": 0.001,
                                                      "backoff_max_s": 0.01,
                                                      **base.pop("res", {})})
        return JConfig(**base)
    base["resilience"] = res.ResilienceConfig(**{"backoff_base_s": 0.001, "backoff_max_s": 0.01,
                                                 **base.pop("res", {})})
    return PipelineConfig(**base, device="cpu")


def _run(pkg, path, inj=None, **kw):
    from graphmine_tpu.pipeline.driver import run_pipeline as jrun

    from graphmine_tpu_torch.pipeline.driver import run_pipeline

    run = jrun if pkg == "jax" else run_pipeline
    if inj is None:
        return run(_mesh_cfg(pkg, path, **kw))
    with inj.installed():
        return run(_mesh_cfg(pkg, path, **kw))


_MESH_KEYS = ("from_devices", "to_devices", "schedule", "iteration", "resumed_from",
              "dead_devices")


def test_device_loss_walks_the_elastic_rungs_as_jax(mesh_graph, mesh_env, tmp_path):
    import numpy as np

    from graphmine_tpu_torch.pipeline import checkpoint as ckpt

    base = _run("port", mesh_graph, num_devices=1).labels
    got, want = [], []
    for pkg, fmod, out in (("port", faults, got), ("jax", jfaults, want)):
        inj = fmod.FaultInjector()
        inj.add("lpa_superstep", fmod.device_loss, at=3)
        ck = str(tmp_path / pkg)
        r = _run(pkg, mesh_graph, inj, checkpoint_dir=ck)
        np.testing.assert_array_equal(np.asarray(r.labels), base)
        out += [{k: rec[k] for k in _MESH_KEYS} for rec in r.metrics.of_phase("mesh_degrade")]
        out += [(rec["kind"], rec["to"]) for rec in r.metrics.of_phase("degrade")]
        out.append([rec["iteration"] for rec in r.metrics.of_phase("lpa_iter")])
        assert ckpt.load_sharded(ck)[1] == 5
        if pkg == "port":
            (md,) = r.metrics.of_phase("mesh_degrade")
            assert md["virtual"] is True
            assert all(rec.get("virtual") for rec in r.metrics.of_phase("partition"))
    assert got == want
    assert got[0] == {"from_devices": 4, "to_devices": 2, "schedule": "replicated",
                      "iteration": 2, "resumed_from": "memory", "dead_devices": [2]}
    # two losses walk 4 -> 2 -> 1 (the one-device sort superstep)
    inj = faults.FaultInjector()
    inj.add("lpa_superstep", faults.device_loss, at=2)
    inj.add("lpa_superstep", faults.device_loss, at=4)
    r = _run("port", mesh_graph, inj, checkpoint_dir=str(tmp_path / "twice"))
    np.testing.assert_array_equal(r.labels, base)
    assert [(x["from_devices"], x["to_devices"]) for x in r.metrics.of_phase("mesh_degrade")] \
        == [(4, 2), (2, 1)]


def test_kill_resumes_on_fewer_devices_and_tripwire_rolls_back(mesh_graph, mesh_env,
                                                               tmp_path):
    import numpy as np

    from graphmine_tpu_torch.pipeline import checkpoint as ckpt

    base = _run("port", mesh_graph, num_devices=1).labels
    ck = str(tmp_path / "ck")
    inj = faults.FaultInjector()
    inj.add("lpa_superstep", faults.preemption, at=3)
    with pytest.raises(faults.SimulatedPreemption):
        _run("port", mesh_graph, inj, checkpoint_dir=ck)
    assert ckpt.load_sharded(ck)[1] == 2
    r = _run("port", mesh_graph, checkpoint_dir=ck, resume=True, num_devices=2)
    np.testing.assert_array_equal(r.labels, base)
    assert r.metrics.of_phase("resume")[0]["iteration"] == 2
    # a poisoned shard: caught, rolled back to superstep 2, retried through
    inj = faults.FaultInjector()
    inj.add("lpa_superstep", faults.poison_labels(shard=1, num_shards=4), at=3)
    r = _run("port", mesh_graph, inj, checkpoint_dir=str(tmp_path / "tw"),
             res={"tripwire_every_k": 1})
    np.testing.assert_array_equal(r.labels, base)
    (tw,) = r.metrics.of_phase("tripwire")
    assert (tw["kind"], tw["iteration"]) == ("label_out_of_range", 3)
    assert 0 <= tw["shard"] < 4 and tw["bad_vertices"] > 0
    assert r.metrics.of_phase("resume")[0] == {**r.metrics.of_phase("resume")[0],
                                              "iteration": 2, "reason": "tripwire"}
