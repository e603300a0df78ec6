"""Port parity for the whole slice: the PyTorch pipeline against the JAX
pipeline on one edge list (CPU, one device).

Both run load -> build -> 5 LPA supersteps -> census -> recursive-LPA
outliers -> features -> exact kNN/LOF at lof_k=32 on
``planted_anomaly_graph(4096, 60_000, seed=9)``. Integer outputs (labels,
community count, census, outlier flags) must be equal. LOF scores agree to
rtol 1e-4 (1.1e-6 measured on this input): the feature columns round in
another library (log1p, divisions), and many vertices share a feature row
exactly (discrete degrees and counts), so neighbour lists hold runs of
near-equal distances that the JAX package's matrix-product distances and
the port's feature-by-feature sums round differently, and the
reach-distance sums and density ratios amplify that. The AUROC against the
planted anomalies agrees within 1e-3.

The JAX loader is held to its NumPy path, which the port copies: its
optional native parser interns ids line by line (source, then
destination), another first-appearance order than the NumPy path's
column by column.
"""

import numpy as np
import pytest

from graphmine_tpu.io import native as jnative
from graphmine_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun_pipeline

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.ops.lof import auroc
from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
from graphmine_tpu_torch.pipeline.config import parse_args
from graphmine_tpu_torch.pipeline.driver import main

LOF_K = 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=9)
    path = tmp_path_factory.mktemp("slice") / "edges.txt"
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
        mp.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
        ref = jrun_pipeline(JPipelineConfig(
            data_path=str(path), data_format="edgelist", num_devices=1,
            max_iter=5, outlier_method="both", lof_k=LOF_K, lof_impl="xla",
        ))
    port = run_pipeline(PipelineConfig(
        data_path=str(path), data_format="edgelist", max_iter=5,
        outlier_method="both", lof_k=LOF_K, lof_impl="exact", device="cpu",
    ))
    # ingestion renumbers vertices by first appearance; names carry the
    # generator's ids
    orig = port.edge_table.names.astype(np.int64)
    return ref, port, is_anomaly[orig], str(path)


def test_labels_and_census_equal(runs):
    ref, port, _, _ = runs
    np.testing.assert_array_equal(port.edge_table.names, ref.edge_table.names)
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    assert port.num_communities == ref.num_communities
    for got, want in zip(port.community_table, ref.community_table):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_recursive_lpa_flags_equal(runs):
    ref, port, _, _ = runs
    np.testing.assert_array_equal(port.outliers.sub_labels, ref.outliers.sub_labels)
    np.testing.assert_array_equal(port.outliers.outlier_vertices,
                                  ref.outliers.outlier_vertices)
    assert port.outliers.outlier_vertices.any()


def test_lof_scores_and_auroc_agree(runs):
    ref, port, is_anomaly, _ = runs
    assert port.feature_mode == "exact"
    ref_lof = np.asarray(ref.lof)
    assert port.lof.shape == ref_lof.shape and np.isfinite(port.lof).all()
    np.testing.assert_allclose(port.lof, ref_lof, rtol=1e-4, atol=0)
    assert auroc(port.lof, is_anomaly) == pytest.approx(auroc(ref_lof, is_anomaly), abs=1e-3)


def test_metrics_records(runs):
    ref, port, _, _ = runs
    m = port.metrics
    (counts,) = m.of_phase("counts")
    ref_counts = [r for r in ref.metrics.records if r["phase"] == "counts"][0]
    for key in ("rows_raw", "edges", "vertices"):
        assert counts[key] == ref_counts[key]
    assert m.of_phase("communities")[0]["count"] == port.num_communities
    methods = [r["method"] for r in m.of_phase("outlier_summary")]
    assert methods == ["recursive_lpa", "lof"]
    assert [r["impl"] for r in m.of_phase("impl_selected") if r["op"] == "lof_knn"] == ["exact"]
    (plan,) = m.of_phase("plan_build")
    assert plan["buckets"] > 0 and plan["hub_vertices"] == 0
    assert plan["max_degree"] == int(port.graph.degrees().max())
    (mode,) = m.of_phase("feature_mode")
    assert mode["mode"] == port.feature_mode and 0 < mode["wedges"] <= mode["wedge_budget"]
    phases = m.phase_seconds()
    for phase in ("load", "build_graph", "lpa", "census", "outliers_recursive_lpa",
                  "features", "outliers_lof"):
        assert phases[phase] >= 0


def test_cli_runs_on_the_cpu(runs, capsys):
    _, port, _, path = runs
    cfg = parse_args(["--data-path", path, "--data-format", "edgelist",
                      "--lof-impl", "exact", "--lof-k", str(LOF_K), "--device", "cpu"])
    assert cfg.device == "cpu" and cfg.lof_impl == "exact" and cfg.max_iter == 5
    main(["--data-path", path, "--data-format", "edgelist", "--lof-impl", "exact",
          "--lof-k", str(LOF_K), "--device", "cpu", "--outlier-method", "recursive_lpa"])
    out = capsys.readouterr().out
    assert f"There are {port.num_communities} Communities in the Dataset." in out


def test_auto_lof_raises_at_ivf_scale(runs, monkeypatch):
    # "auto" resolves to IVF from the crossover (2^17 points; lowered here
    # to the test graph's size); the port has no IVF index and never
    # switches to exact on its own
    from graphmine_tpu_torch.ops import lof

    _, port, _, path = runs
    monkeypatch.setattr(lof, "LOF_IVF_MIN_POINTS", port.graph.num_vertices)
    cfg = PipelineConfig(data_path=path, max_iter=0, outlier_method="lof",
                         lof_impl="auto", device="cpu", wedge_budget=0)
    with pytest.raises(NotImplementedError, match="IVF"):
        run_pipeline(cfg)


def test_config_rejects_what_waits():
    with pytest.raises(NotImplementedError, match="parquet"):
        PipelineConfig(data_format="parquet").validate()
    with pytest.raises(ValueError, match="lof_impl"):
        PipelineConfig(lof_impl="xla").validate()
