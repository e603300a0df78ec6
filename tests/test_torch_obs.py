"""The port's observability against the JAX package's: tracer identities,
the Prometheus textfile, the heartbeat, the record schema both ways, and
the profiler hook on the CPU."""

import functools
import json
import re
import time

import numpy as np
import pytest

from graphmine_tpu.io import native as jnative
from graphmine_tpu.obs import registry as jregistry
from graphmine_tpu.obs import schema as jschema
from graphmine_tpu.obs import spans as jspans
from graphmine_tpu.pipeline.config import PipelineConfig as JConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.io.edges import load_edge_list
from graphmine_tpu_torch.obs import registry, schema, spans
from graphmine_tpu_torch.obs.heartbeat import Heartbeat
from graphmine_tpu_torch.pipeline import driver
from graphmine_tpu_torch.pipeline.config import PipelineConfig
from graphmine_tpu_torch.pipeline.metrics import MetricsSink, maybe_profile
from graphmine_tpu_torch.pipeline.resilience import ResilienceConfig
from graphmine_tpu_torch.testing import faults
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.obs


def test_tracer_ids_paths_and_traceparent():
    tr = spans.Tracer(run_id="r1")
    assert tr.run_id == "r1" and re.fullmatch(r"[0-9a-f]{16}", tr.trace_id)
    assert re.fullmatch(r"\d{8}T\d{6}-[0-9a-f]{6}", spans.new_run_id())
    with tr.span("lpa") as a, tr.span("rung:primary") as b:
        assert b.path == "run/lpa/rung:primary" and b.parent_id == a.span_id
        assert tr.latest() is b and tr.current() is b
        header = b.context().to_header()
    assert tr.current() is tr.root
    ctx = spans.TraceContext.from_header(header)
    jctx = jspans.TraceContext.from_header(header)
    assert (ctx.trace_id, ctx.span_id, ctx.sampled) == (jctx.trace_id, jctx.span_id, jctx.sampled)
    assert ctx.to_header() == jctx.to_header() == header
    for bad in ("", "00-xyz-1-01", "00-" + "a" * 16 + "-" + "b" * 8, None):
        assert spans.TraceContext.from_header(bad) is None
    with tr.span("remote", remote=ctx) as r:
        assert r.trace_id == ctx.trace_id and r.parent_id == ctx.span_id and r.path == "remote"
    with pytest.raises(RuntimeError), tr.span("boom") as s:
        raise RuntimeError("x")
    assert s.status == "error" and s.end_mono is not None


def _drive(reg):
    reg.counter("graphmine_supersteps_total", "LPA supersteps completed this run").inc(5)
    reg.gauge("graphmine_superstep", "last completed LPA superstep").set(5)
    reg.gauge("graphmine_labels_changed").set(17.5)
    reg.gauge("graphmine_wal_pending", "per shard", shard="2").set(3)
    reg.gauge("graphmine_wal_pending", "per shard", shard="0").set(1)
    h = reg.histogram("graphmine_request_seconds", "latency", endpoint="query")
    for x in (0.0003, 0.02, 0.7, 12.0):
        h.observe(x)
    reg.histogram("graphmine_request_seconds", endpoint="vertex").observe(0.001)


def test_registry_textfile_is_byte_equal_to_the_jax_one(tmp_path):
    port, ref = registry.Registry(), jregistry.Registry()
    _drive(port)
    _drive(ref)
    labels = {"run_id": 'smoke "5c"'}
    assert port.render_textfile(labels) == ref.render_textfile(labels)
    assert port.values() == ref.values()
    port.write_textfile(str(tmp_path / "p.prom"), labels)
    ref.write_textfile(str(tmp_path / "j.prom"), labels)
    assert (tmp_path / "p.prom").read_bytes() == (tmp_path / "j.prom").read_bytes()
    with pytest.raises(ValueError):
        port.gauge("graphmine_supersteps_total")


def test_heartbeat_beats_and_writes_the_textfile(tmp_path):
    m = MetricsSink(tracer=spans.Tracer(run_id="hb"))
    m.registry.gauge("graphmine_superstep").set(3)
    prom = str(tmp_path / "hb.prom")
    hb = Heartbeat(m, every_s=0.05, prom_path=prom).start()
    with m.span("lpa"):
        deadline = time.time() + 5
        while hb.beats < 3 and time.time() < deadline:
            time.sleep(0.02)
    hb.stop()
    beats = m.of_phase("heartbeat")
    assert len(beats) >= 3 and beats[0]["gauges"]["graphmine_superstep"] == 3
    assert any(b["busy"] == "run/lpa" for b in beats)
    assert 'graphmine_superstep{run_id="hb"} 3' in open(prom).read()
    with pytest.raises(ValueError):
        Heartbeat(m, every_s=0)


def test_profile_capture_on_the_cpu(tmp_path):
    import torch

    m = MetricsSink(tracer=spans.Tracer(run_id="prof"))
    with maybe_profile(str(tmp_path / "prof"), sink=m):
        with m.span("lpa"):
            torch.ones(1000).cumsum(0)
    (rec,) = m.of_phase("profile_capture")
    assert rec["ok"] and rec["activities"] == ["CPU"] and rec["top_device_ops"] == []
    assert rec["start_seconds"] >= 0 and rec["seconds"] >= 0
    trace = json.load(open(rec["trace"]))
    assert any(ev.get("name") == "run/lpa" for ev in trace["traceEvents"])
    with maybe_profile(None, sink=m):
        pass
    assert len(m.of_phase("profile_capture")) == 1


def test_metrics_finalize_appends_without_truncating(tmp_path):
    path = str(tmp_path / "m.jsonl")
    open(path, "w").write('{"phase": "run_start", "t": 1}\n{"torn')
    m = MetricsSink()
    m.emit("counts", rows_raw=1, edges=1, vertices=2)
    m.finalize(path)
    lines = open(path).read().splitlines()
    assert lines[0].startswith('{"phase": "run_start"') and lines[1] == '{"torn'
    assert json.loads(lines[2])["phase"] == "counts"


@pytest.fixture
def jax_schema_with_port_phases(monkeypatch):
    """The JAX package's registry, extended through its own ``register``
    with the records only the port emits (``schema.PORT_PHASES``)."""
    monkeypatch.setattr(jschema, "SCHEMAS", dict(jschema.SCHEMAS))
    for phase, keys in schema.PORT_PHASES.items():
        jschema.register(phase, *keys)
    return jschema


@pytest.fixture(scope="module")
def edge_list(tmp_path_factory):
    src, dst, _, _ = datasets.planted_anomaly_graph(512, 5_000, seed=3)
    path = tmp_path_factory.mktemp("obs") / "edges.txt"
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")
    return str(path)


def test_the_ports_stream_validates_against_the_jax_schema(edge_list, tmp_path,
                                                           jax_schema_with_port_phases,
                                                           monkeypatch):
    monkeypatch.setattr(driver, "load_edge_list",
                        functools.partial(load_edge_list, use_native=False))
    out = tmp_path / "m.jsonl"
    cfg = PipelineConfig(
        data_path=edge_list, data_format="edgelist", lof_k=16, lof_impl="exact", device="cpu",
        checkpoint_dir=str(tmp_path / "ck"), metrics_out=str(out), run_id="obs-run",
        heartbeat_every_s=0.05, prom_out=str(tmp_path / "p.prom"),
        profile_dir=str(tmp_path / "prof"), snapshot_out=str(tmp_path / "store"),
        resilience=ResilienceConfig(backoff_base_s=0.001, tripwire_every_k=1),
    )
    inj = faults.FaultInjector().add("lpa_superstep", faults.transient_error, at=2)
    with inj.installed():
        run_pipeline = driver.run_pipeline
        res = run_pipeline(cfg)
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == len(res.metrics.records)
    phases = {r["phase"] for r in recs}
    assert {"retry", "checkpoint_save", "superstep_timing", "memory_watermark", "plan",
            "superstep_telemetry", "profile_capture", "cc_summary", "canary_score",
            "run_end"} <= phases
    assert all(r["run_id"] == "obs-run" for r in recs)
    assert jax_schema_with_port_phases.validate_records(recs) == []
    assert schema.validate_records(recs) == []
    prom = open(tmp_path / "p.prom").read()
    assert 'graphmine_supersteps_total{run_id="obs-run"} 5' in prom
    assert 'graphmine_retries_total{run_id="obs-run"} 1' in prom
    assert "graphmine_quality_canary_recall" in prom


def test_a_jax_run_validates_against_the_ports_schema(edge_list, monkeypatch):
    monkeypatch.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
    ref = jrun(JConfig(data_path=edge_list, data_format="edgelist", num_devices=1,
                       lof_k=16, lof_impl="xla", max_iter=3))
    assert schema.validate_records(ref.metrics.records) == []
    assert schema.validate_record({"phase": "nope", "t": 1.0})
    assert schema.validate_record({"phase": "retry", "t": 1.0, "run_id": "x"})
