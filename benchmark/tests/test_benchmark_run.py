"""A run end to end on the CPU path, the command's refusals, and the
benchmark's description against its own files."""

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from conftest import CELLS, ROOT, small_cell

CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_run_prints_a_well_formed_line(name, trace, capsys):
    cell = small_cell(name)
    result = harness.run_cell(cell, 2**31 + 99, 0.3, bool(trace), CPU)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(cell.limits)
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for metric, body in line["metrics"].items():
        assert body["unit"] == units[metric] and isinstance(body["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # every end-to-end metric but the device's peak reads on the CPU
        assert set(line["metrics"]) == set(units) - {"peak_device_gib"}


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "e2e-2e18.lof",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_command_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_description_names_files_that_exist():
    spec = harness.load_spec()
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in metrics:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    reported = {w["name"]: {m["name"] for m in spec["end_to_end"]
                            if "workloads" not in m or w["name"] in m["workloads"]}
                for w in spec["workloads"]}
    for m in spec["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in reported[w]
    for w in spec["workloads"]:
        cell = harness.resolve_cell(spec, w["name"])
        assert len(reported[w["name"]]) >= 2 and cell.per_layer
        assert (ROOT / "benchmark" / "jobs" / f"{cell.traffic['job']}.py").is_file()
        gen = cell.config["generator"]["name"]
        assert (ROOT / "benchmark" / "generators" / f"{gen}.py").is_file()
    assert {w["config"] for w in spec["workloads"]} == {c["name"] for c in spec["configs"]}


@pytest.mark.card
def test_a_run_on_the_card(card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "e2e-2e18.lof",
                           "--seed", "5", "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
