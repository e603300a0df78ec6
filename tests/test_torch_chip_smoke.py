"""The chip smoke's host side: what it can show without a card.

``chip_smoke.py`` runs only on a CUDA card. Here: it exits non-zero with
no result line on a machine without CUDA and in a directory that holds it
alone, its bulk edge-list writer gives the ids the port's loader reads
back, and its kNN bound and parity check compute what they say.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from graphmine_tpu_torch.io.edges import load_edge_list  # noqa: E402
from graphmine_tpu_torch.ops.knn import _tiled_knn  # noqa: E402


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_edge_list_writer_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 100_000, 5000).astype(np.int32)
    dst = rng.integers(0, 100_000, 5000).astype(np.int32)
    src[:3] = [0, 7, 99_999]
    path = tmp_path / "e.txt"
    chip_smoke.write_edge_list(path, src, dst)
    et = load_edge_list(str(path))
    names = et.names.astype(np.int64)
    np.testing.assert_array_equal(names[et.src], src)
    np.testing.assert_array_equal(names[et.dst], dst)
    np.testing.assert_array_equal(np.loadtxt(path, dtype=np.int64), np.stack([src, dst], 1))


def test_knn_bound_is_operations_at_the_main_path_shape():
    ms, by = chip_smoke.knn_bound_ms(262_144, 8, 128)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 262_144 * 262_143 * 19 / 67e12)
    assert chip_smoke.knn_bound_ms(1000, 1, 999)[1] == "bytes"


def test_check_knn_accepts_equal_and_rejects_a_swap():
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 5)).astype(np.float32))
    d, i = _tiled_knn(pts, 10)
    assert chip_smoke.check_knn(pts, 10, d, i, d, i) == {"max_abs_err": 0.0,
                                                          "index_mismatches": 0}
    swapped = i.clone()
    swapped[0, 3], swapped[0, 4] = i[0, 4], i[0, 3]
    with pytest.raises(RuntimeError, match="2 kernel indices differ"):
        chip_smoke.check_knn(pts, 10, d, swapped, d, i)
    selfish = i.clone()
    selfish[5, 0] = 5
    with pytest.raises(RuntimeError, match="itself"):
        chip_smoke.check_knn(pts, 10, d, selfish, d, i)
    json.dumps(chip_smoke.check_knn(pts, 10, d, i, d, i))


def test_check_knn_rejects_a_swap_between_tied_neighbours():
    pts = torch.from_numpy(np.random.default_rng(3).integers(0, 3, size=(200, 2)).astype(np.float32))
    d, i = _tiled_knn(pts, 20)
    row, col = next((r, c) for r in range(200) for c in range(19) if d[r, c] == d[r, c + 1])
    swapped = i.clone()
    swapped[row, col], swapped[row, col + 1] = i[row, col + 1], i[row, col]
    with pytest.raises(RuntimeError, match="2 kernel indices differ"):
        chip_smoke.check_knn(pts, 20, d, swapped, d, i)
