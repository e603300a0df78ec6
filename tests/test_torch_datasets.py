"""Port parity: the benchmark ladder of ``datasets`` against the JAX
package's (CPU).

``LADDER`` holds the same rungs; ``snap_path`` resolves a rung's SNAP file
alike; ``load`` gives the same edge table from the R-MAT stand-in (each
rung capped at ``max_scale`` <= 12) and from a SNAP file written to
``tmp_path``. The JAX package's native parser is built with ``make -C
native`` when it is missing, so both loaders take their native paths.
"""

import dataclasses
import subprocess
from pathlib import Path

import numpy as np
import pytest

from graphmine_tpu import datasets as jdatasets
from graphmine_tpu.io import native as jnative

from graphmine_tpu_torch import datasets

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib():
    if not jnative.available():
        subprocess.run(["make", "-C", str(REPO / "native")], check=True, capture_output=True)
        jnative._LIB_TRIED = False  # probe again after the build
    assert jnative.available()


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    assert got.src.dtype == want.src.dtype == np.int32
    assert got.names.tolist() == want.names.tolist()
    assert got.num_rows_raw == want.num_rows_raw
    assert (got.weights is None) == (want.weights is None)


def test_the_ladder_holds_the_jax_rungs():
    assert list(datasets.LADDER) == list(jdatasets.LADDER)
    for name, rung in datasets.LADDER.items():
        assert dataclasses.asdict(rung) == dataclasses.asdict(jdatasets.LADDER[name])
    lj = datasets.LADDER["com-livejournal"]
    assert (lj.scale, lj.edge_factor) == (22, 8.3)
    assert int(lj.edge_factor * (1 << lj.scale)) == 34_812_723


@pytest.mark.parametrize("max_scale", [8, 12])
@pytest.mark.parametrize("name", sorted(jdatasets.LADDER))
def test_stand_in_equals_the_jax_packages(name, max_scale, tmp_path):
    for seed in (0, 3):
        got = datasets.load(name, data_dir=str(tmp_path), seed=seed, max_scale=max_scale)
        want = jdatasets.load(name, data_dir=str(tmp_path), seed=seed, max_scale=max_scale)
        _assert_tables_equal(got, want)


def test_a_snap_file_on_disk_is_loaded_in_full(tmp_path):
    rung = datasets.LADDER["ego-facebook"]
    assert datasets.snap_path("ego-facebook", str(tmp_path)) is None
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 5000, 3000), rng.integers(0, 5000, 3000)
    path = tmp_path / rung.snap_file
    path.write_text("# SNAP header\n" + "".join(f"{s}\t{d}\n" for s, d in zip(src, dst)))
    assert datasets.snap_path("ego-facebook", str(tmp_path)) == \
        jdatasets.snap_path("ego-facebook", str(tmp_path)) == str(path)
    got = datasets.load("ego-facebook", data_dir=str(tmp_path), max_scale=4)
    want = jdatasets.load("ego-facebook", data_dir=str(tmp_path), max_scale=4)
    _assert_tables_equal(got, want)
    assert got.num_edges == 3000  # the file, not a stand-in capped at scale 4


def test_unknown_rungs_raise_in_both_packages():
    for mod in (datasets, jdatasets):
        with pytest.raises(KeyError, match="unknown ladder rung"):
            mod.load("nope")
        with pytest.raises(KeyError, match="unknown ladder rung"):
            mod.snap_path("nope")
