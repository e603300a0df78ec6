"""One run of one cell: make the inputs from the seed, hand them to the
program, warm up, run the cell's jobs back to back for the window, check
what the window produced against the plain reference, and print one line.

The cell's parts are found by name. ``BENCHMARK.json`` gives the cell's
configuration file and traffic mix; the configuration names its
generator (``generators/<name>.py``), the mix names its job
(``jobs/<name>.py``), the cell's limits are ``limits/<cell>.json``, and
every metric is read by ``metrics/<name>.py``. A job is a class ``Job``
built from ``(config, traffic, inputs, device, seed)`` with:

- ``facts``: what one job does (vertices, edges, points, ...);
- ``setup(spans)``: hand the inputs to the program (host-clock spans of
  set-up go into ``spans``, synchronised);
- ``run()``: one job through the program's entry, unsynchronised; its
  output is what the check compares;
- ``release()``: drop the program's state;
- ``reference()`` and ``control()``: the plain reference's answer, and
  the control's (the reference with one stated guarantee or precision
  broken);
- ``compare(output, reference)``: ``{number: value}`` for the limits.

The window is a closed loop (one analyst's jobs, each synchronised before
the next). A mix's optional ``params`` override the configuration's
``algorithms.<job>`` entries, so a mix that changes a job's parameters
is a data file alone. A metric module's ``read(ctx)`` returns a number or ``None``
when it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.trace import JOB, WINDOW

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "graphmine_tpu")
TRACE_SECONDS = 3.0  # the profiled window's length at most
KEEP_OUTPUTS = 4  # jobs sampled from the seed for the check, beside the last


class BenchError(RuntimeError):
    """A run that cannot give a result (exit code 2, nothing printed)."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class RunContext:
    """What a metric reads: the job's facts, each job's seconds in the
    window of a ``--trace 0`` run, set-up seconds and spans, the device's
    peak bytes, and the trace of a ``--trace 1`` run with the number of
    jobs in it."""

    facts: dict
    job_seconds: list = field(default_factory=list)
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    peak_bytes: int = 0
    trace: object = None
    jobs_traced: int = 0


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` with its files read."""
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    traffic = _json(HERE / "mixes" / f"{work['traffic']}.json")
    if traffic.get("loop", "closed") != "closed" or traffic.get("clients", 1) != 1:
        raise BenchError(f"mix {work['traffic']!r}: only a closed loop of one client runs here")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(work["chips"]), config=_json(root / conf["file"]),
                traffic=traffic,
                limits=_json(HERE / "limits" / f"{name}.json"), end_to_end=e2e,
                per_layer=layer)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind} module {path.relative_to(ROOT)}")
    mod_name = "benchmark_" + kind + "_" + "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_job(cell: Cell, seed: int, device):
    """The cell's job with its inputs made from ``seed`` on ``device``."""
    gen = cell.config["generator"]
    data = load_module("generators", gen["name"]).generate(gen["params"], seed, device)
    return load_module("jobs", cell.traffic["job"]).Job(cell.config, cell.traffic, data,
                                                      device, seed)


def synchronizer(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


@contextmanager
def span(spans: dict, name: str, sync):
    """Host-clock seconds of the body, synchronised at both ends, into
    ``spans[name]``."""
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    spans[name] = time.perf_counter() - t0


def _keep(kept: list, i: int, out, rng: random.Random) -> None:
    """Reservoir sample of the window's outputs, drawn from the seed."""
    if len(kept) < KEEP_OUTPUTS:
        kept.append(out)
    else:
        j = rng.randrange(i + 1)
        if j < KEEP_OUTPUTS:
            kept[j] = out


def window(job, seconds: float, sync, rng: random.Random, record=None) -> tuple:
    """``(job seconds, outputs kept for the check)``: jobs back to back
    until ``seconds`` have passed, every one that started completed."""
    times, kept = [], []
    rec = record or (lambda _name: nullcontext())
    t_end = time.perf_counter() + seconds
    i, out = 0, None
    while True:
        t0 = time.perf_counter()
        with rec(JOB):
            out = job.run()
            sync()
        times.append(time.perf_counter() - t0)
        _keep(kept, i, out, rng)
        i += 1
        if time.perf_counter() >= t_end:
            break
    if not any(o is out for o in kept):
        kept.append(out)
    return times, kept


def traced_window(job, seconds: float, sync, rng: random.Random, device) -> tuple:
    """``(job seconds, kept outputs, Trace or None)`` of a short window
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import read_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync()
        with record_function(WINDOW):
            times, kept = window(job, seconds, sync, rng, record=record_function)
            sync()
    return times, kept, read_profile(prof)


def device_facts(device, chips: int, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in BANNED_MODULES})


def read_metrics(entries: list, ctx: RunContext) -> dict:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, err=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    sync = synchronizer(device)
    rng = random.Random(int(seed) * 1_000_003 + 17)
    job = make_job(cell, seed, device)
    print(f"bench: {cell.name} seed {seed}: {json.dumps(job.facts)}", file=err, flush=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ctx = RunContext(facts=job.facts)
    job.setup(ctx.spans)
    job.run()  # warm-up: the plan, the kernel's library, the allocator
    sync()
    ctx.setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        times, kept, tr = traced_window(job, min(seconds, TRACE_SECONDS), sync, rng, device)
        ctx.trace, ctx.jobs_traced = tr, len(times)
        attempted = len(times)
    else:
        ctx.job_seconds, kept = window(job, seconds, sync, rng)
        attempted = len(ctx.job_seconds)
    if device.type == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated(device)
    job.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = job.reference()
    readings = [job.compare(out, ref) for out in kept]
    del kept, ref
    checks, failed = {}, 0
    for reading in readings:
        bad = False
        for name, value in reading.items():
            limit = cell.limits[name]
            ok = math.isfinite(value) and value <= limit
            bad |= not ok
            prev = checks.get(name)
            if prev is None or not (value <= prev["value"]):
                checks[name] = {"value": value, "limit": limit}
        failed += bad
    missing = set(cell.limits) - set(checks)
    if missing:
        raise BenchError(f"no reading of {sorted(missing)}")
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    result = {"correct": failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": device_facts(device, cell.chips, ctx.peak_bytes)}
    if trace:
        result["device"]["busy_s"] = tr.busy_s if tr else 0.0
        result["device"]["window_s"] = tr.window_s if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    result["checks"] = checks
    return result
