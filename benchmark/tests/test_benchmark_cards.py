"""A cell's cards: the harness waits for, resets and reads the peak of
every card a cell asks for. On the CPU with the CUDA calls stubbed; on
four cards (``card`` marker, skips with fewer) with a cell built here
whose job fills each card to another height and sleeps on the last."""

import contextlib
import statistics
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from conftest import small_cell

CPU = torch.device("cpu")
MIB = 2**20


def _cuda(n):
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture
def cuda_calls(monkeypatch):
    """``torch.cuda``'s calls on cards recorded, not made: ``[(call,
    device), ...]``; ``max_memory_allocated`` answers from ``peaks``."""
    calls = []
    peaks = {}
    current = []

    @contextlib.contextmanager
    def device(d):
        current.append(d)
        yield
        current.pop()

    def record(name):
        return lambda d=None: calls.append((name, d))

    monkeypatch.setattr(torch.cuda, "synchronize", record("synchronize"))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", record("reset"))
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append(("empty_cache", current[-1])))
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: peaks[d.index])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "NVIDIA H100 80GB HBM3")
    return SimpleNamespace(calls=calls, peaks=peaks)


@pytest.mark.parametrize("devices", [torch.device("cuda", 0), _cuda(1)])
def test_one_card_is_synchronised_once(devices, cuda_calls):
    harness.synchronizer(devices)()
    assert cuda_calls.calls == [("synchronize", torch.device("cuda", 0))]


def test_every_card_of_the_cell_is_synchronised(cuda_calls):
    sync = harness.synchronizer(_cuda(4))
    sync()
    assert cuda_calls.calls == [("synchronize", d) for d in _cuda(4)]


def test_the_cpu_synchronises_nothing(cuda_calls):
    harness.synchronizer(CPU)()
    harness.synchronizer([CPU])()
    assert cuda_calls.calls == []


def test_peaks_are_reset_and_read_on_every_card(cuda_calls):
    harness.reset_peaks(_cuda(4))
    assert cuda_calls.calls == [(call, d) for d in _cuda(4)
                                for call in ("synchronize", "empty_cache", "reset")]
    cuda_calls.peaks.update({0: 5 * MIB, 1: 9 * MIB, 2: 7 * MIB, 3: 1 * MIB})
    peaks = harness.read_peaks(_cuda(4))
    assert peaks == [5 * MIB, 9 * MIB, 7 * MIB, 1 * MIB]
    facts = harness.device_facts(_cuda(4), peaks)
    assert facts == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
                     "memory_peak_bytes": 9 * MIB,
                     "memory_peak_bytes_per_card": [5 * MIB, 9 * MIB, 7 * MIB, 1 * MIB]}


def test_one_cards_device_keys_are_unchanged(cuda_calls):
    cuda_calls.peaks[0] = 3 * MIB
    facts = harness.device_facts(_cuda(1), harness.read_peaks(_cuda(1)))
    assert list(facts) == ["platform", "kind", "count", "memory_peak_bytes"]
    assert facts["count"] == 1 and facts["memory_peak_bytes"] == 3 * MIB
    assert harness.device_facts([CPU], harness.read_peaks([CPU])) == {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def test_a_job_gets_the_cells_cards():
    job = harness.make_job(small_cell("e2e-2e18.cdlp"), 3, CPU)
    assert job.devices == [CPU] and job.device == CPU
    job = harness.make_job(small_cell("e2e-2e18.cdlp"), 3, [CPU, CPU])
    assert job.devices == [CPU, CPU]


def test_too_few_cards_is_a_refusal(monkeypatch):
    cell = small_cell("e2e-2e18.lof")
    cell.chips = 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(harness.BenchError, match="needs 4 CUDA device"):
        harness.cell_cards(cell)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert harness.cell_cards(cell) == _cuda(4)


# The four-card cell: a job that holds another number of bytes on each
# card (card 1 the fullest, card 0 not) and sleeps on card 3 alone.
HELD = (64 * MIB, 768 * MIB, 256 * MIB, 512 * MIB)
SLEEP_CYCLES = 200_000_000  # about 0.1 s at the H100's clock
NAME = "cards_test"


class FourCardJob:
    def __init__(self, config, traffic, data, device, seed):
        self.device = device
        self.facts = {"held_bytes": list(HELD)}
        self.sleeps = []

    def setup(self, spans):
        cards = self.devices
        self.held = [torch.empty(n, dtype=torch.uint8, device=d) for n, d in zip(HELD, cards)]

    def run(self):
        last = self.devices[3]
        with torch.cuda.device(last):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(SLEEP_CYCLES)
            out = torch.full((1,), 3, device=last)
            stop.record()
        self.sleeps.append((start, stop))
        return out

    def sleep_s(self):
        """Each run's sleep on card 3 by its CUDA events, in seconds."""
        for _, stop in self.sleeps:
            stop.synchronize()
        return [1e-3 * a.elapsed_time(b) for a, b in self.sleeps]

    def release(self):
        self.held = None

    def reference(self):
        return 3

    def control(self):
        return 4

    @staticmethod
    def compare(output, reference):
        return {"wrong": int(int(output.item()) != reference)}


def four_card_cell():
    return harness.Cell(
        name=NAME, chips=4, config={"name": NAME, "generator": {"name": NAME, "params": {}}},
        traffic={"job": NAME}, limits={"wrong": 0},
        end_to_end=[{"name": "peak_device_gib", "unit": "GiB"},
                    {"name": "job_s_min", "unit": "s"}],
        per_layer=[{"name": "device.idle_pct", "unit": "%"}])


def install(monkeypatch, job_class=FourCardJob):
    """``harness.load_module`` answers for the test cell's generator, job
    and ``job_s_min`` metric; returns the jobs it built."""
    built = []
    real = harness.load_module

    def make(*args):
        built.append(job_class(*args))
        return built[-1]

    def load(kind, name):
        if name == NAME and kind == "generators":
            return SimpleNamespace(generate=lambda params, seed, device: {})
        if name == NAME and kind == "jobs":
            return SimpleNamespace(Job=make)
        if (kind, name) == ("metrics", "job_s_min"):
            return SimpleNamespace(read=lambda ctx: min(ctx.job_seconds, default=None))
        return real(kind, name)

    monkeypatch.setattr(harness, "load_module", load)
    return built


@pytest.fixture
def four_cards():
    """The first four CUDA cards, or a skip where there are fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return _cuda(4)


@pytest.mark.card
def test_four_cards_peak_and_job_seconds_cover_every_card(four_cards, monkeypatch):
    built = install(monkeypatch)
    result = harness.run_cell(four_card_cell(), 11, 1.0, False, four_cards)
    job = built[0]
    assert job.devices == four_cards
    assert result["correct"] is True
    dev = result["device"]
    per_card = dev["memory_peak_bytes_per_card"]
    assert dev["count"] == 4 and len(per_card) == 4
    for held, peak in zip(HELD, per_card):
        assert held <= peak < held + 16 * MIB
    assert dev["memory_peak_bytes"] == max(per_card) == per_card[1]
    assert result["metrics"]["peak_device_gib"]["value"] == per_card[1] / 2**30
    sleep = statistics.median(job.sleep_s())
    assert result["metrics"]["job_s_min"]["value"] >= 0.9 * sleep
    print({"per_card": per_card, "sleep_s": sleep,
           "job_s_min": result["metrics"]["job_s_min"]["value"]})


@pytest.mark.card
def test_four_cards_trace_reads_each_card(four_cards, monkeypatch):
    built = install(monkeypatch)
    result = harness.run_cell(four_card_cell(), 12, 1.0, True, four_cards)
    assert result["correct"] is True
    dev = result["device"]
    busy = dev["busy_s_per_card"]
    assert len(busy) == 4
    slept = sum(built[0].sleep_s()[1:])  # the warm-up's sleep is before the window
    assert busy[3] >= 0.9 * slept
    assert max(busy[:3]) < 0.1 * busy[3]
    assert dev["busy_s"] == pytest.approx(sum(busy) / 4, rel=1e-12)
    names = [name for name, _ in result["breakdown"]["device_ops"]]
    assert names and all(name.startswith("cuda:") for name in names)
    assert names[0].startswith("cuda:3 ")
    assert all(label.startswith("cuda:")
               for label, _ in result["breakdown"]["idle_gaps"])
    print({"busy_s_per_card": busy, "window_s": dev["window_s"],
           "device_ops": result["breakdown"]["device_ops"][:3]})


@pytest.mark.card
def test_the_profiler_names_each_operations_card(four_cards, tmp_path):
    import json

    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import DEVICE_CATS, event_card

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for d in four_cards:
            torch.full((1 << 20,), d.index, device=d).sum()
            torch.cuda.synchronize(d)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    device_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    assert {event_card(e) for e in device_events} == {0, 1, 2, 3}
    seen = sorted({("device" in (e.get("args") or {}), e.get("pid") == event_card(e))
                   for e in device_events})
    print({"args.device present, pid equal": seen})
