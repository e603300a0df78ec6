"""Port parity for ingestion: the port's streaming C++ parser against the
JAX package's native parser, and the port's NumPy paths against the JAX
package's NumPy paths (CPU).

``src``/``dst``/``names``/``weights`` must be bit-equal on string and
integer ids, with comments, a weight column, and chunks small enough to
cut lines; quarantine counts and error messages must be equal. The JAX
package's library is built here with ``make -C native`` when it is missing
(as ``tests/test_native.py`` builds it), and must then load: no skip.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from graphmine_tpu.io import native as jnative
from graphmine_tpu.io.edges import load_edge_list as jload_edge_list

from graphmine_tpu_torch.io import native
from graphmine_tpu_torch.io.edges import load_edge_list

REPO = Path(__file__).resolve().parent.parent

FILES = {
    "strings": "# header\nalpha beta\nbeta gamma  # trailing note\n\n  gamma alpha\ndelta alpha\n"
               "beta beta\n",
    "integers": "10 20\n20 30\n10 30\n30 10\n40 20\n",
    "weighted": "# src dst weight extra\na b 0.25 x\nb c 1.5 y\n\tc a 2 z\nd a 0.75 w\na d 3.25 v\n",
    "no_final_newline": "1 2 0.5\n2 3 0.25\n3 1 1",
}
WEIGHT_COL = {"strings": None, "integers": None, "weighted": 2, "no_final_newline": 2}


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib():
    if not jnative.available():
        subprocess.run(["make", "-C", str(REPO / "native")], check=True, capture_output=True)
        jnative._LIB_TRIED = False  # probe again after the build
    assert jnative.available() and jnative.chunked_parse_available()


def _write(tmp_path, text, name="edges.txt"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    assert got.src.dtype == want.src.dtype == np.int32
    assert got.names.tolist() == want.names.tolist()
    assert got.num_rows_raw == want.num_rows_raw
    if want.weights is None:
        assert got.weights is None
    else:
        assert got.weights.dtype == np.float32
        np.testing.assert_array_equal(got.weights, want.weights)
    assert got.quarantine == want.quarantine


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("chunk_bytes", [None, 7], ids=["whole", "chunks_of_7_bytes"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_tables_bit_equal(tmp_path, name, chunk_bytes, use_native):
    path = _write(tmp_path, FILES[name])
    kw = dict(use_native=use_native, weight_col=WEIGHT_COL[name], chunk_bytes=chunk_bytes)
    _assert_tables_equal(load_edge_list(path, **kw), jload_edge_list(path, **kw))


def test_native_order_is_line_by_line(tmp_path):
    # the native parsers intern source then destination, line by line; the
    # NumPy paths intern the whole source column first
    path = _write(tmp_path, "a b\nc d\n")
    assert load_edge_list(path).names.tolist() == ["a", "b", "c", "d"]
    assert load_edge_list(path, use_native=False).names.tolist() == ["a", "c", "b", "d"]


def test_large_random_file_bit_equal(tmp_path):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 3000, 20_000)
    dst = rng.integers(0, 3000, 20_000)
    w = rng.integers(1, 16, 20_000) / 4
    lines = [f"v{s} v{d} {x}" for s, d, x in zip(src, dst, w)]
    path = _write(tmp_path, "# generated\n" + "\n".join(lines) + "\n")
    for chunk_bytes in (None, 4096):
        got = load_edge_list(path, weight_col=2, chunk_bytes=chunk_bytes)
        want = jload_edge_list(path, weight_col=2, chunk_bytes=chunk_bytes)
        _assert_tables_equal(got, want)
    assert got.num_edges == 20_000 and got.weights.sum() == w.sum()


QUARANTINE_FILES = {
    "ragged": ("a b 1.0\nb\nc a 2.0\nd a\nq\n", 2),
    "nan_weights": ("a b 1.0\nb c nan\nc a inf\nd a 0.5\n", 2),
    "bad_weight_token": ("a b 1.0\nb c heavy\nc a 2.0\n", 2),
    "unweighted_ragged": ("a b\nb c d\nc a\n", None),
}


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(QUARANTINE_FILES))
def test_quarantine_counts_equal(tmp_path, name, use_native):
    text, wcol = QUARANTINE_FILES[name]
    path = _write(tmp_path, text)
    got = load_edge_list(path, use_native=use_native, weight_col=wcol, quarantine=True)
    want = jload_edge_list(path, use_native=use_native, weight_col=wcol, quarantine=True)
    _assert_tables_equal(got, want)
    assert sum(got.quarantine.values()) > 0 or name == "unweighted_ragged"


def test_quarantine_refuses_a_file_whose_every_row_fails(tmp_path):
    path = _write(tmp_path, "a b x\nb c y\n")
    for loader in (load_edge_list, jload_edge_list):
        with pytest.raises(ValueError, match="every data row"):
            loader(path, weight_col=2, quarantine=True)


ERROR_FILES = {
    "one_token_line": ("a b\nc\n", None),
    "columns_change": ("a b\nc d e\n", None),
    "missing_weight_token": ("a b 1.0\nc d 2.0\n", 3),
    "unparseable_weight": ("a b 1.0\nc d x\n", 2),
}


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(ERROR_FILES))
def test_errors_equal(tmp_path, name, use_native):
    text, wcol = ERROR_FILES[name]
    path = _write(tmp_path, text)
    errors = []
    for loader in (load_edge_list, jload_edge_list):
        with pytest.raises(ValueError) as err:
            loader(path, use_native=use_native, weight_col=wcol)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_weight_col_must_not_be_an_endpoint(tmp_path):
    path = _write(tmp_path, "a b 1\n")
    with pytest.raises(ValueError, match="columns 0-1 are the endpoints"):
        load_edge_list(path, weight_col=1)


def test_library_is_built_from_the_ports_source(tmp_path):
    native.build()
    lib = native.library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "graphmine_tpu_torch"
    assert lib.name.startswith("libgraph_builder_")
    # a second build finds the library and compiles nothing
    assert native.build() < 1.0


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_edge_list(str(tmp_path / "absent.txt"))
