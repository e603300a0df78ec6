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

A cell with ``chips: n`` runs in one process that owns the cards
``cuda:0`` to ``cuda:n-1`` (:func:`cell_cards`). Its inputs are made on the
first, which is also the ``device`` a job is built with; the job gets
all of them as ``job.devices``, set by :func:`make_job` before
``setup``. A one-card job need not read it; a job that spans cards
places its state on them and times its set-up spans with
``synchronizer(self.devices)``. The warm-up, the window and the traced
window synchronise every card, so a job ends when its last card does;
the peak is the fullest card's, and the trace is read card by card.

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
    window of a ``--trace 0`` run, set-up seconds and spans, the peak
    bytes of the cell's fullest card, and the trace of a ``--trace 1`` run
    with the number of jobs in it."""

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


def as_cards(devices) -> list:
    """``devices`` (one device, or a list of them) as a list."""
    return list(devices) if isinstance(devices, (list, tuple)) else [devices]


def cell_cards(cell: Cell) -> list:
    """The cell's cards, ``cuda:0`` to ``cuda:chips-1`` in order; a
    :class:`BenchError` where fewer are visible."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        raise BenchError(f"{cell.name} needs {cell.chips} CUDA device(s); have {have}")
    return [torch.device("cuda", i) for i in range(cell.chips)]


def make_job(cell: Cell, seed: int, devices):
    """The cell's job with its inputs made from ``seed`` on the first of
    ``devices`` (one device or the cell's list), and all of them as
    ``job.devices``."""
    cards = as_cards(devices)
    gen = cell.config["generator"]
    data = load_module("generators", gen["name"]).generate(gen["params"], seed, cards[0])
    job = load_module("jobs", cell.traffic["job"]).Job(cell.config, cell.traffic, data,
                                                     cards[0], seed)
    job.devices = cards
    return job


def synchronizer(devices):
    """A function that waits for each CUDA card of ``devices`` (one
    device or a list) in turn; on the CPU it does nothing."""
    import torch

    cuda = [d for d in as_cards(devices) if d.type == "cuda"]
    if len(cuda) == 1:
        device = cuda[0]
        return lambda: torch.cuda.synchronize(device)

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)
    return sync


def empty_caches(cards: list) -> None:
    """Return each CUDA card's cached blocks to the driver."""
    import torch

    for d in cards:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


def reset_peaks(cards: list) -> None:
    """On each CUDA card: wait for it, return its cached blocks and reset
    its peak statistics."""
    import torch

    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
            empty_caches([d])
            torch.cuda.reset_peak_memory_stats(d)


def read_peaks(cards: list) -> list:
    """Each CUDA card's peak allocated bytes since :func:`reset_peaks`, in
    the cards' order."""
    import torch

    return [int(torch.cuda.max_memory_allocated(d)) for d in cards if d.type == "cuda"]


@contextmanager
def span(spans: dict, name: str, sync):
    """Host-clock seconds of the body, synchronised at both ends by
    ``sync`` (a :func:`synchronizer` of the cards the span waits for),
    into ``spans[name]``."""
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


def traced_window(job, seconds: float, sync, rng: random.Random, cards: list) -> tuple:
    """``(job seconds, kept outputs, Trace or None)`` of a short window
    under ``torch.profiler``, its device operations read on each CUDA
    card of ``cards``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import read_profile

    cuda = [d.index for d in cards if d.type == "cuda"]
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync()
        with record_function(WINDOW):
            times, kept = window(job, seconds, sync, rng, record=record_function)
            sync()
    return times, kept, read_profile(prof, cuda)


def device_facts(cards: list, peaks: list) -> dict:
    """The result line's ``device``: the CUDA cards of ``cards`` with the
    fullest one's peak bytes, and on more than one card each card's peak
    (``peaks``, in the same order)."""
    import torch

    cuda = [d for d in cards if d.type == "cuda"]
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(cuda[0]),
             "count": len(cuda), "memory_peak_bytes": max(peaks)}
    if len(cuda) > 1:
        facts["memory_peak_bytes_per_card"] = list(peaks)
    return facts


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


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices,
             t_start: float | None = None, err=sys.stderr) -> dict:
    """One run of ``cell`` on ``devices`` (one device, or the cell's
    cards from :func:`cell_cards`); returns the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cards = as_cards(devices)
    sync = synchronizer(cards)
    rng = random.Random(int(seed) * 1_000_003 + 17)
    job = make_job(cell, seed, cards)
    print(f"bench: {cell.name} seed {seed}: {json.dumps(job.facts)}", file=err, flush=True)
    gc.collect()
    reset_peaks(cards)
    ctx = RunContext(facts=job.facts)
    job.setup(ctx.spans)
    job.run()  # warm-up: the plan, the kernel's library, the allocator
    sync()
    ctx.setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        times, kept, tr = traced_window(job, min(seconds, TRACE_SECONDS), sync, rng, cards)
        ctx.trace, ctx.jobs_traced = tr, len(times)
        attempted = len(times)
    else:
        ctx.job_seconds, kept = window(job, seconds, sync, rng)
        attempted = len(ctx.job_seconds)
    peaks = read_peaks(cards)
    ctx.peak_bytes = max(peaks, default=0)
    job.release()
    gc.collect()
    empty_caches(cards)
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
              "device": device_facts(cards, peaks)}
    if trace:
        result["device"]["busy_s"] = tr.busy_s if tr else 0.0
        result["device"]["window_s"] = tr.window_s if tr else 0.0
        if tr:
            if len(tr.cards) > 1:
                result["device"]["busy_s_per_card"] = list(tr.busy_s_by_card().values())
            result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    result["checks"] = checks
    return result
