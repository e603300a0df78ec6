"""Port parity: parquet ingest and the pipeline on parquet (CPU).

Every test writes its own parquet files with pyarrow from seeded NumPy
draws: string columns ``_c1 -> _c2``, dictionary-encoded or plain, with
null endpoints, in one file, a directory of three files or a glob, read
whole or in batches smaller than a file. Ids, names and the ``null_rows``
quarantine count must be bit-equal to the JAX ``load_parquet_edges`` with
the same ``batch_rows``.

The pipeline runs on the same parquet file in both packages with the
default config (parquet, LOF "auto", which is the exact kNN at 4,096
vertices) at lof_k=32: labels, census and recursive-LPA flags must be
equal; LOF agrees to rtol 1e-4 on 99.9% of vertices and to 1e-2 on all,
the tolerance of the port's default-config parity tests (the JAX
package's matrix-product distances and the port's feature-by-feature sums
round apart on near-ties).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from graphmine_tpu.io.edges import _column_codes as j_column_codes
from graphmine_tpu.io.edges import load_parquet_edges as jload_parquet_edges
from graphmine_tpu.io.factorize import IncrementalFactorizer as JFactorizer
from graphmine_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun_pipeline

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.io.edges import _column_codes, load_parquet_edges
from graphmine_tpu_torch.io.factorize import IncrementalFactorizer
from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
from graphmine_tpu_torch.pipeline.config import parse_args


def _column(ids, null_mask, dictionary: bool):
    vals = [None if null else f"v{i}" for i, null in zip(ids, null_mask)]
    arr = pa.array(vals, type=pa.string())
    return arr.dictionary_encode() if dictionary else arr


def _write(path, src, dst, null_src=None, null_dst=None, dictionary=True):
    n = len(src)
    null_src = np.zeros(n, bool) if null_src is None else null_src
    null_dst = np.zeros(n, bool) if null_dst is None else null_dst
    table = pa.table({"_c0": pa.array([f"p{i}" for i in range(n)]),
                      "_c1": _column(src, null_src, dictionary),
                      "_c2": _column(dst, null_dst, dictionary),
                      "_c3": pa.array([f"c{i}" for i in range(n)])})
    pq.write_table(table, path, use_dictionary=dictionary)


def _layout(tmp_path, layout):
    """A parquet input of ~6,000 rows with nulls, and its path."""
    rng = np.random.default_rng(21)
    parts = 3 if layout in ("directory", "glob") else 1
    paths = []
    for part in range(parts):
        n = 2000 if parts == 3 else 6000
        src = rng.zipf(1.6, n) % 900
        dst = rng.integers(0, 1200, n)
        null_src = rng.random(n) < 0.02
        null_dst = rng.random(n) < 0.02
        path = tmp_path / f"part-{part:05d}.parquet"
        _write(path, src, dst, null_src, null_dst, dictionary=layout != "plain")
        paths.append(path)
    (tmp_path / "README.txt").write_text("not a parquet file")
    if layout == "directory":
        return str(tmp_path)
    if layout == "glob":
        return str(tmp_path / "part-*.parquet")
    return str(paths[0])


@pytest.mark.parametrize("batch_rows", [None, 700, 100_000])
@pytest.mark.parametrize("layout", ["dictionary", "plain", "directory", "glob"])
def test_ids_names_and_quarantine_equal(tmp_path, layout, batch_rows):
    path = _layout(tmp_path, layout)
    ref = jload_parquet_edges(path, batch_rows=batch_rows)
    et = load_parquet_edges(path, batch_rows=batch_rows)
    np.testing.assert_array_equal(et.src, ref.src)
    np.testing.assert_array_equal(et.dst, ref.dst)
    assert et.src.dtype == et.dst.dtype == np.int32
    np.testing.assert_array_equal(et.names, ref.names)
    assert et.num_rows_raw == ref.num_rows_raw == 6000
    assert et.quarantine == ref.quarantine
    assert 0 < et.quarantine["null_rows"] < 6000 - et.num_edges + 1
    assert et.num_edges + et.quarantine["null_rows"] == 6000


def test_batches_assign_ids_batch_by_batch(tmp_path):
    # ids follow first appearance per batch, source column first in each:
    # batch 1 interns a, b then c; batch 2 interns d, then e
    path = tmp_path / "e.parquet"
    _write(path, [0, 1, 3], [2, 0, 4])
    names = load_parquet_edges(str(path), batch_rows=2).names.tolist()
    assert names == ["v0", "v1", "v2", "v3", "v4"]
    whole = load_parquet_edges(str(path)).names.tolist()
    assert whole == ["v0", "v1", "v3", "v2", "v4"]


@pytest.mark.parametrize("dictionary", [True, False])
def test_column_codes_equal_and_null_safe(dictionary):
    rng = np.random.default_rng(5)
    chunks = []
    for _ in range(3):
        ids = rng.integers(0, 50, 400)
        chunks.append(_column(ids, rng.random(400) < 0.1, dictionary))
    col = pa.chunked_array(chunks)
    interner, jinterner = IncrementalFactorizer(), JFactorizer()
    codes = _column_codes(col, interner)
    ref = j_column_codes(col, jinterner)
    np.testing.assert_array_equal(codes, ref)
    np.testing.assert_array_equal(interner.names(), jinterner.names())
    assert None not in interner.names().tolist()
    assert len(_column_codes(pa.chunked_array([], type=pa.string()), interner)) == 0


def test_add_dictionary_equals_add():
    rng = np.random.default_rng(8)
    dictionary = np.array([f"n{i}" for i in rng.permutation(40)], dtype=object)
    a, b = IncrementalFactorizer(), IncrementalFactorizer()
    for _ in range(3):
        idx = rng.integers(0, 40, 300).astype(np.int32)
        np.testing.assert_array_equal(a.add_dictionary(idx, dictionary), b.add(dictionary[idx]))
    np.testing.assert_array_equal(a.names(), b.names())


def test_missing_input_and_bad_batch_rows_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_parquet_edges(str(tmp_path))
    path = tmp_path / "e.parquet"
    _write(path, [0, 1], [1, 2])
    with pytest.raises(ValueError, match="batch_rows"):
        load_parquet_edges(str(path), batch_rows=0)


def test_config_takes_the_jax_defaults_and_validation():
    ref = JPipelineConfig()
    cfg = PipelineConfig()
    assert cfg.data_format == ref.data_format == "parquet"
    assert cfg.batch_rows is ref.batch_rows is None
    assert cfg.snapshot_out is ref.snapshot_out is None
    for bad in (dict(batch_rows=0), dict(batch_rows=5, data_format="edgelist"),
                dict(edge_weight_col=2), dict(data_format="csv")):
        with pytest.raises(ValueError):
            PipelineConfig(**bad).validate()
        with pytest.raises(ValueError):
            JPipelineConfig(**bad).validate()
    cfg = parse_args(["--data-path", "x", "--batch-rows", "4000000", "--snapshot-out", "s"])
    assert (cfg.data_format, cfg.batch_rows, cfg.snapshot_out) == ("parquet", 4_000_000, "s")


# ---- the pipeline on parquet ---------------------------------------------

LOF_K = 32


@pytest.fixture(scope="module", params=[None, 20_000], ids=["whole", "batched"])
def parquet_runs(request, tmp_path_factory):
    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=9)
    path = tmp_path_factory.mktemp("parquet") / "edges.parquet"
    table = pa.table({"_c1": pa.array(src.astype(str)).dictionary_encode(),
                      "_c2": pa.array(dst.astype(str)).dictionary_encode()})
    pq.write_table(table, path)
    batch_rows = request.param
    ref = jrun_pipeline(JPipelineConfig(data_path=str(path), num_devices=1, lof_k=LOF_K,
                                        batch_rows=batch_rows))
    port = run_pipeline(PipelineConfig(data_path=str(path), lof_k=LOF_K,
                                       batch_rows=batch_rows, device="cpu"))
    return ref, port


def test_parquet_pipeline_labels_census_flags_equal(parquet_runs):
    ref, port = parquet_runs
    np.testing.assert_array_equal(port.edge_table.names, ref.edge_table.names)
    np.testing.assert_array_equal(port.edge_table.src, ref.edge_table.src)
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    assert port.num_communities == ref.num_communities
    for got, want in zip(port.community_table, ref.community_table):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(port.outliers.outlier_vertices, ref.outliers.outlier_vertices)
    assert port.outliers.outlier_vertices.any()


def test_parquet_pipeline_lof_agrees(parquet_runs):
    ref, port = parquet_runs
    ref_lof = np.asarray(ref.lof)
    assert np.isfinite(port.lof).all() and port.lof.shape == ref_lof.shape
    rel = np.abs(port.lof - ref_lof) / np.abs(ref_lof)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, rel.max()


def test_parquet_pipeline_records(parquet_runs):
    ref, port = parquet_runs
    (load,) = port.metrics.of_phase("load")
    assert load["format"] == "parquet"
    (q,) = port.metrics.of_phase("quarantine")
    (jq,) = [r for r in ref.metrics.records if r["phase"] == "quarantine"]
    assert q["null_rows"] == jq["null_rows"] == 0
    lof_sel = [r for r in port.metrics.of_phase("impl_selected") if r["op"] == "lof_knn"]
    assert [r["impl"] for r in lof_sel] == ["exact"] and lof_sel[0]["requested"] == "auto"
