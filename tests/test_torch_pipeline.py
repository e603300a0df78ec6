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

Both loaders are held to their NumPy paths here: the native parsers
intern ids line by line (source, then destination), another
first-appearance order than the NumPy paths' column by column. The
default-config cases below run both packages' native parsers.
"""

import functools

import numpy as np
import pytest

from graphmine_tpu.io import native as jnative
from graphmine_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun_pipeline

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.ops.lof import auroc
from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
from graphmine_tpu_torch.io.edges import load_edge_list
from graphmine_tpu_torch.pipeline import driver
from graphmine_tpu_torch.pipeline.config import parse_args
from graphmine_tpu_torch.pipeline.driver import main
from _torch_threads import one_torch_thread  # noqa: F401

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
        mp.setattr(driver, "load_edge_list", functools.partial(load_edge_list, use_native=False))
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


def test_cli_runs_on_the_cpu(runs, capsys, monkeypatch):
    _, port, _, path = runs
    monkeypatch.setattr(driver, "load_edge_list", functools.partial(load_edge_list, use_native=False))
    cfg = parse_args(["--data-path", path, "--data-format", "edgelist",
                      "--lof-impl", "exact", "--lof-k", str(LOF_K), "--device", "cpu"])
    assert cfg.device == "cpu" and cfg.lof_impl == "exact" and cfg.max_iter == 5
    main(["--data-path", path, "--data-format", "edgelist", "--lof-impl", "exact",
          "--lof-k", str(LOF_K), "--device", "cpu", "--outlier-method", "recursive_lpa"])
    out = capsys.readouterr().out
    assert f"There are {port.num_communities} Communities in the Dataset." in out


def test_auto_lof_takes_ivf_at_ivf_scale(runs, monkeypatch):
    # "auto" resolves to IVF from the crossover (2^17 points; lowered here
    # to the test graph's size); a guard that sends the index to the exact
    # kNN says so with a warning and a record, never quietly
    import warnings

    from graphmine_tpu_torch.ops import lof

    _, port, _, path = runs
    monkeypatch.setattr(lof, "LOF_IVF_MIN_POINTS", port.graph.num_vertices)
    cfg = PipelineConfig(data_path=path, data_format="edgelist", max_iter=0,
                         outlier_method="lof", lof_impl="auto", device="cpu", wedge_budget=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = run_pipeline(cfg)
    m = res.metrics
    assert [r["impl"] for r in m.of_phase("impl_selected") if r["op"] == "lof_knn"] == ["ivf"]
    guard_warnings = [w for w in caught if "ivf_knn guard" in str(w.message)]
    assert len(m.of_phase("ivf_index")) + len(m.of_phase("ivf_fallback")) == 1
    assert len(guard_warnings) == len(m.of_phase("ivf_fallback"))
    assert np.isfinite(res.lof).all() and res.lof.shape == (port.graph.num_vertices,)


def test_config_takes_parquet_and_the_jax_lof_names():
    assert PipelineConfig(data_format="parquet").validate().data_format == "parquet"
    for name in ("auto", "xla", "pallas", "exact", "ivf"):
        assert PipelineConfig(lof_impl=name).validate().lof_impl == name
        JPipelineConfig(lof_impl=name if name != "exact" else "xla").validate()
    with pytest.raises(ValueError, match="lof_impl"):
        PipelineConfig(lof_impl="triton").validate()
    with pytest.raises(ValueError, match="data_format"):
        PipelineConfig(data_format="csv").validate()


@pytest.mark.parametrize("name", ["xla", "pallas"])
def test_jax_lof_names_run_the_exact_knn(runs, name, monkeypatch):
    # the JAX CLI's names run on the port: the exact kNN, with the name the
    # caller gave in the impl_selected record
    ref, port, _, path = runs
    monkeypatch.setattr(driver, "load_edge_list", functools.partial(load_edge_list, use_native=False))
    res = run_pipeline(parse_args(["--data-path", path, "--data-format", "edgelist",
                                   "--lof-impl", name, "--lof-k", str(LOF_K),
                                   "--device", "cpu", "--outlier-method", "lof"]))
    (sel,) = [r for r in res.metrics.of_phase("impl_selected") if r["op"] == "lof_knn"]
    assert (sel["impl"], sel["requested"]) == ("exact", name)
    np.testing.assert_array_equal(res.lof, port.lof)


# ---- the JAX package's default pipeline: native ingest, IVF LOF --------
#
# Both packages run their default config on an edge list, each through
# its own native parser (ids in the same line-by-line order), with the
# IVF crossover lowered to 2,048 points on both (GRAPHMINE_LOF_IVF_MIN_N)
# so that "auto" takes the IVF index at this CPU size, and lof_k=32: at
# 4,096 vertices the default k=128 exceeds every k-means cluster, and the
# k_unfillable guard would send both to the exact kNN. The weighted case
# reads a third column of quarter weights (sums exact in float32).
# Labels and flags must be equal. LOF agrees to rtol 1e-4 on 99.9% of
# vertices and to 1e-2 on all: the kNN distances round differently in the
# JAX matrix product and the port's feature-by-feature sums, and one
# vertex of the weighted graph (2.1e-3) sits on a near-tie of its
# neighbour list that rounds apart; the rest agree within 1.1e-6.

DEFAULT_LOF_K = 32


@pytest.fixture(scope="module", params=["unweighted", "weighted"])
def default_runs(request, tmp_path_factory):
    import subprocess
    from pathlib import Path

    if not jnative.available():
        subprocess.run(["make", "-C", str(Path(__file__).resolve().parent.parent / "native")],
                       check=True, capture_output=True)
        jnative._LIB_TRIED = False  # probe again after the build
    assert jnative.available()
    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=9)
    weighted = request.param == "weighted"
    path = tmp_path_factory.mktemp("default") / "edges.txt"
    cols = [src, dst]
    if weighted:
        cols.append(np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    np.savetxt(path, np.stack(cols, axis=1), fmt=["%d", "%d", "%.2f"][:len(cols)])
    wcol = 2 if weighted else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_LOF_IVF_MIN_N", "2048")
        ref = jrun_pipeline(JPipelineConfig(
            data_path=str(path), data_format="edgelist", num_devices=1,
            lof_k=DEFAULT_LOF_K, edge_weight_col=wcol,
        ))
        port = run_pipeline(PipelineConfig(data_path=str(path), data_format="edgelist",
                                           lof_k=DEFAULT_LOF_K, edge_weight_col=wcol,
                                           device="cpu"))
    return ref, port, weighted


def test_default_config_labels_and_flags_equal(default_runs):
    ref, port, weighted = default_runs
    assert (port.graph.msg_weight is not None) == weighted
    np.testing.assert_array_equal(port.edge_table.names, ref.edge_table.names)
    np.testing.assert_array_equal(port.edge_table.src, ref.edge_table.src)
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    assert port.num_communities == ref.num_communities
    np.testing.assert_array_equal(port.outliers.outlier_vertices,
                                  ref.outliers.outlier_vertices)


def test_default_config_lof_agrees(default_runs):
    ref, port, _ = default_runs
    ref_lof = np.asarray(ref.lof)
    assert np.isfinite(port.lof).all() and port.lof.shape == ref_lof.shape
    rel = np.abs(port.lof - ref_lof) / np.abs(ref_lof)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, rel.max()


def test_default_config_takes_ivf_and_records_quarantine(default_runs):
    ref, port, weighted = default_runs
    jrecords = [r for r in ref.metrics.records if r["phase"] in ("impl_selected", "quarantine")]
    for m in (port.metrics.records, jrecords):
        assert [r["impl"] for r in m if r["phase"] == "impl_selected"
                and r.get("op") == "lof_knn"] == ["ivf"]
    (q,) = port.metrics.of_phase("quarantine")
    (jq,) = [r for r in jrecords if r["phase"] == "quarantine"]
    keys = ("bad_rows", "nan_weights") if weighted else ("bad_rows",)
    assert {k: q[k] for k in keys} == {k: jq[k] for k in keys} == dict.fromkeys(keys, 0)
    assert port.metrics.of_phase("ivf_index") and not port.metrics.of_phase("ivf_fallback")


def test_config_parses_weight_col_and_quarantine():
    cfg = parse_args(["--data-path", "x.txt", "--data-format", "edgelist",
                      "--edge-weight-col", "2", "--device", "cpu"])
    assert cfg.edge_weight_col == 2 and cfg.quarantine_inputs and cfg.lof_impl == "auto"
    cfg = parse_args(["--data-path", "x.txt", "--no-quarantine-inputs"])
    assert cfg.edge_weight_col is None and not cfg.quarantine_inputs
    with pytest.raises(ValueError, match="edge_weight_col"):
        PipelineConfig(edge_weight_col=1).validate()
    # the JAX package's defaults for the fields both have
    ref, port = JPipelineConfig(), PipelineConfig()
    for name in ("edge_weight_col", "quarantine_inputs", "max_iter", "outlier_method",
                 "sub_max_iter", "decile", "lof_k", "lof_impl", "data_format", "batch_rows",
                 "snapshot_out"):
        assert getattr(port, name) == getattr(ref, name), name


def test_quarantine_record_counts_set_aside_rows(tmp_path):
    path = tmp_path / "dirty.txt"
    rows = [f"{i} {(i * 7) % 50} {1 + i % 4}" for i in range(300)]
    rows[10] = "3 4 nan"
    rows[20] = "5"
    path.write_text("\n".join(rows) + "\n")
    res = run_pipeline(PipelineConfig(data_path=str(path), data_format="edgelist",
                                      edge_weight_col=2, lof_k=8, device="cpu"))
    (q,) = res.metrics.of_phase("quarantine")
    assert (q["bad_rows"], q["nan_weights"]) == (1, 1)
    assert res.graph.num_edges == 298 and res.graph.msg_weight is not None
    with pytest.raises(ValueError):
        run_pipeline(PipelineConfig(data_path=str(path), data_format="edgelist",
                                    edge_weight_col=2, lof_k=8, quarantine_inputs=False,
                                    device="cpu"))


# ---- the pipeline on a mesh: replicated, ring, scale-out ---------------
#
# A 4-shard virtual CPU mesh (GRAPHMINE_VIRTUAL_DEVICES) against the JAX
# driver on its own 4-device virtual mesh, on the slice's graph with the
# NumPy loaders and the exact LOF at lof_k=32. Labels and flags are equal
# (the ring's too: it gives the replicated schedule's labels); LOF agrees
# as the default-config tests above say (rtol 1e-4 on 99.9%, 1e-2 on all).
# Scale-out: GRAPHMINE_HBM_BYTES between the two planners' replicated and
# single-device estimates keeps the graph on the host in both packages;
# the published labels and CC labels are equal. Its host features are
# bit-equal to the JAX package's, but their standardization reduces the
# column means in float32 in another order (XLA's against PyTorch's), an
# ulp apart, and one vertex on a near-tie of its neighbour list moves by
# 1.15e-2 (the rest within 1.4e-6): that case's bound on all vertices is
# 2e-2.

SCALE_OUT_HBM = "1200000"


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    from graphmine_tpu.serve.snapshot import SnapshotStore as JStore

    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=9)
    root = tmp_path_factory.mktemp("mesh")
    path = root / "edges.txt"
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")
    base = dict(data_path=str(path), data_format="edgelist", max_iter=5, outlier_method="both",
                lof_k=LOF_K, num_devices=4)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")
        mp.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
        mp.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
        mp.setattr(driver, "load_edge_list",
                   functools.partial(load_edge_list, use_native=False))
        out["jax"] = jrun_pipeline(JPipelineConfig(**base, lof_impl="xla"))
        for sched in ("replicated", "ring"):
            out[sched] = run_pipeline(PipelineConfig(**base, schedule=sched,
                                                     lof_impl="exact", device="cpu"))
        mp.setenv("GRAPHMINE_HBM_BYTES", SCALE_OUT_HBM)
        out["jax_scale_out"] = jrun_pipeline(JPipelineConfig(
            **base, lof_impl="xla", snapshot_out=str(root / "jax_store")))
        out["scale_out"] = run_pipeline(PipelineConfig(
            **base, lof_impl="exact", device="cpu", snapshot_out=str(root / "port_store")))
    out["stores"] = (JStore(str(root / "jax_store")).load(),
                     SnapshotStore(str(root / "port_store")).load())
    out["is_anomaly"] = is_anomaly[out["replicated"].edge_table.names.astype(np.int64)]
    return out


def _lof_close(got, want, worst=1e-2):
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= worst, rel.max()


@pytest.mark.parametrize("run", ["replicated", "ring", "scale_out"])
def test_mesh_pipeline_labels_flags_and_lof(mesh_runs, run):
    ref = mesh_runs["jax_scale_out" if run == "scale_out" else "jax"]
    port = mesh_runs[run]
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    assert port.num_communities == ref.num_communities
    np.testing.assert_array_equal(port.outliers.outlier_vertices,
                                  ref.outliers.outlier_vertices)
    _lof_close(port.lof, np.asarray(ref.lof), worst=2e-2 if run == "scale_out" else 1e-2)
    assert auroc(port.lof, mesh_runs["is_anomaly"]) == pytest.approx(
        auroc(np.asarray(ref.lof), mesh_runs["is_anomaly"]), abs=1e-3)


def test_mesh_pipeline_records(mesh_runs):
    for run in ("replicated", "ring", "scale_out"):
        m, jm = mesh_runs[run].metrics, mesh_runs["jax_scale_out" if run == "scale_out"
                                                  else "jax"].metrics
        (plan,) = m.of_phase("plan")
        jplan = [r for r in jm.records if r["phase"] == "plan"][0]
        assert plan["schedule"] == (run if run != "scale_out" else jplan["schedule"])
        assert plan["virtual"] is True and plan["mem"]["devices"] == 4
        parts = m.of_phase("partition")
        assert parts and all(p["virtual"] and p["shards"] == 4 for p in parts)
        assert all(r["virtual"] for r in m.of_phase("superstep_timing"))
        (lof,) = m.of_phase("outliers_lof")
        assert lof["devices"] == 4
        sel = [r for r in m.of_phase("impl_selected")  # not the publish's canary
               if r["op"] == "lof_knn" and r["n"] == mesh_runs[run].graph.num_vertices]
        assert [(r["impl"], r["devices"]) for r in sel] == [("exact", 4)]
        assert bool(m.of_phase("scale_out")) == (run == "scale_out") == bool(
            [r for r in jm.records if r["phase"] == "scale_out"])
    so = mesh_runs["scale_out"]
    assert so.scale_out and so.feature_mode == "host-8-sampled"
    assert so.graph.device.type == "cpu"
    (rec,) = so.metrics.of_phase("outliers_recursive_lpa")
    assert (rec["schedule"], rec["devices"]) == ("replicated", 4)
    assert so.metrics.of_phase("outliers_lof")[0]["features"] == "host-8-sampled"
    assert [p["schedule"] for p in mesh_runs["ring"].metrics.of_phase("partition")] == ["ring"]


def test_scale_out_publish_equals_jax(mesh_runs):
    jsnap, psnap = mesh_runs["stores"]
    for name in ("labels", "cc_labels", "src", "dst", "census_sizes"):
        np.testing.assert_array_equal(psnap.arrays[name], np.asarray(jsnap.arrays[name]))
    assert psnap.meta["mesh_shape"] == [4] == list(jsnap.meta["mesh_shape"])
    (cc,) = mesh_runs["scale_out"].metrics.of_phase("cc_summary")
    assert cc["iterations"] >= 1
    timing = [r for r in mesh_runs["scale_out"].metrics.of_phase("superstep_timing")
              if r["op"] == "cc_superstep"]
    assert [(r["variant"], r["devices"]) for r in timing] == [("sharded", 4)]


def test_host_features_bit_equal(mesh_runs):
    from graphmine_tpu.graph.container import build_graph as jbuild
    from graphmine_tpu.ops.features import vertex_features_host as jfeatures

    from graphmine_tpu_torch.ops.features import vertex_features_host

    port = mesh_runs["scale_out"]
    g = port.graph
    jg = jbuild(port.edge_table.src, port.edge_table.dst, num_vertices=g.num_vertices,
                to_device=False)
    for clustering in ("sampled", True, False):
        np.testing.assert_array_equal(
            vertex_features_host(g, port.labels, include_clustering=clustering),
            jfeatures(jg, port.labels, include_clustering=clustering))
    with pytest.raises(ValueError, match="include_clustering"):
        vertex_features_host(g, port.labels, include_clustering="sample")
