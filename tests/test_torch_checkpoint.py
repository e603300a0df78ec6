"""Label checkpoints of the port: the JAX package's npz format, rotation,
rollback and integrity, and resume across the two packages.

A checkpoint the JAX driver wrote resumes in the port's driver, and the
other way round, to labels bit-equal to an uninterrupted run's; both
packages' loaders read each other's files with the same verdicts.
"""

import functools
import os

import numpy as np
import pytest
import torch

from graphmine_tpu.io import native as jnative
from graphmine_tpu.pipeline import checkpoint as jckpt
from graphmine_tpu.pipeline.config import PipelineConfig as JConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun
from graphmine_tpu.pipeline.resilience import ResilienceConfig as JResilience

from graphmine_tpu_torch.io.edges import load_edge_list
from graphmine_tpu_torch.pipeline import checkpoint as ckpt
from graphmine_tpu_torch.pipeline import driver
from graphmine_tpu_torch.pipeline.config import PipelineConfig
from graphmine_tpu_torch.pipeline.driver import run_pipeline
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.testing import faults

pytestmark = pytest.mark.faults


def test_save_is_atomic_and_rotates(tmp_path):
    d = str(tmp_path)
    lbl = torch.arange(10, dtype=torch.int32)
    path = ckpt.save_labels(d, lbl, 1)
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    m = MetricsSink()
    ckpt.save_labels(d, lbl + 1, 2, sink=m)
    labels, it = ckpt.load_labels(d)
    assert it == 2 and labels.dtype == np.int32
    np.testing.assert_array_equal(labels, (lbl + 1).numpy())
    assert os.path.exists(path[: -len(".npz")] + ".prev.npz")
    (rec,) = m.of_phase("checkpoint_save")
    assert rec["format"] == "npz" and rec["iteration"] == 2 and rec["bytes"] > 0


@pytest.mark.parametrize("damage", [faults.corrupt_file, lambda p: faults.truncate_file(p, 0.3)],
                         ids=["bitflip", "truncate"])
def test_corrupt_checkpoint_rolls_back(tmp_path, damage):
    d = str(tmp_path)
    good = np.arange(32, dtype=np.int32) % 7
    ckpt.save_labels(d, good, 3)
    ckpt.save_labels(d, good * 0, 4)
    damage(os.path.join(d, "lpa_labels.npz"))
    m = MetricsSink()
    labels, it = ckpt.load_labels(d, sink=m)
    np.testing.assert_array_equal(labels, good)
    assert it == 3
    assert m.of_phase("checkpoint_rollback") and m.of_phase("checkpoint_rollback_ok")
    assert ckpt.load_labels(d)[1] == 3
    assert os.path.exists(os.path.join(d, "lpa_labels.npz.corrupt"))


def test_both_generations_corrupt_is_a_clean_failure(tmp_path):
    d = str(tmp_path)
    ckpt.save_labels(d, np.arange(8, dtype=np.int32), 1)
    ckpt.save_labels(d, np.arange(8, dtype=np.int32), 2)
    faults.corrupt_file(os.path.join(d, "lpa_labels.npz"))
    faults.corrupt_file(os.path.join(d, "lpa_labels.prev.npz"))
    with pytest.raises(ckpt.CheckpointCorruptionError, match="both"):
        ckpt.load_labels(d)


def test_unrecoverable_corruption_emits_no_rollback_record(tmp_path):
    d = str(tmp_path)
    ckpt.save_labels(d, np.arange(8, dtype=np.int32), 1)
    faults.corrupt_file(os.path.join(d, "lpa_labels.npz"))
    m = MetricsSink()
    with pytest.raises(ckpt.CheckpointCorruptionError, match="no\\s+previous"):
        ckpt.load_labels(d, sink=m)
    assert not m.of_phase("checkpoint_rollback")


def test_checksum_catches_an_internally_consistent_rewrite(tmp_path):
    d = str(tmp_path)
    ckpt.save_labels(d, np.arange(8, dtype=np.int32), 1)
    ckpt.save_labels(d, np.arange(8, dtype=np.int32), 2)
    path = os.path.join(d, "lpa_labels.npz")
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    state["labels"] = state["labels"] + 1
    np.savez(path, **state)
    m = MetricsSink()
    assert ckpt.load_labels(d, sink=m)[1] == 1
    assert "checksum" in m.of_phase("checkpoint_rollback")[0]["error"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_load_with_the_same_verdicts(tmp_path, writer):
    d = str(tmp_path)
    save, load = (jckpt.save_labels, ckpt.load_labels) if writer == "jax" else \
        (ckpt.save_labels, jckpt.load_labels)
    good = np.arange(64, dtype=np.int32) % 5
    save(d, good, 3, fingerprint="fp")
    save(d, good + 1, 4, fingerprint="fp")
    labels, it = load(d, fingerprint="fp")
    assert it == 4
    np.testing.assert_array_equal(labels, good + 1)
    with pytest.raises(ValueError, match="different graph"):  # FingerprintMismatch
        load(d, fingerprint="other")
    faults.corrupt_file(os.path.join(d, "lpa_labels.npz"))
    labels, it = load(d, fingerprint="fp")
    assert it == 3
    np.testing.assert_array_equal(labels, good)


def test_load_newest_passes_over_a_sharded_generation(tmp_path):
    d = str(tmp_path)
    jckpt.save_sharded(d, np.arange(16, dtype=np.int32), 9, num_shards=2)
    m = MetricsSink()
    assert ckpt.load_newest(d, sink=m) is None
    (warn,) = m.of_phase("warning")
    assert "lpa_sharded" in warn["message"]
    ckpt.save_labels(d, np.arange(16, dtype=np.int32) * 2, 2)
    labels, it = ckpt.load_newest(d, sink=MetricsSink())
    assert it == 2
    np.testing.assert_array_equal(labels, np.arange(16) * 2)
    assert ckpt.load_newest(str(tmp_path / "nothing")) is None


# ---- resume across the packages -------------------------------------------


@pytest.fixture(scope="module")
def graph_path(tmp_path_factory):
    rng = np.random.default_rng(11)
    v, e = 200, 1200
    src = rng.integers(0, v, e)
    dst = (src + rng.integers(1, v // 4, e)) % v
    path = tmp_path_factory.mktemp("cross") / "edges.txt"
    path.write_text("".join(f"{s} {t}\n" for s, t in zip(src, dst)))
    return str(path)


@pytest.fixture(autouse=True)
def numpy_loaders(monkeypatch):
    monkeypatch.setattr(jnative, "load_edge_list_chunked", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_edge_list_native", lambda *a, **k: None)
    monkeypatch.setattr(driver, "load_edge_list",
                        functools.partial(load_edge_list, use_native=False))


def _jcfg(path, **kw):
    return JConfig(data_path=path, data_format="edgelist", outlier_method="none",
                   num_devices=1, resilience=JResilience(backoff_base_s=0.001), **kw)


def _pcfg(path, **kw):
    return PipelineConfig(data_path=path, data_format="edgelist", outlier_method="none",
                          device="cpu", **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_resume_to_the_same_final_labels(graph_path, tmp_path, writer):
    ck = str(tmp_path / "ck")
    full = run_pipeline(_pcfg(graph_path, max_iter=6)).labels
    np.testing.assert_array_equal(full, np.asarray(jrun(_jcfg(graph_path, max_iter=6)).labels))
    if writer == "jax":
        jrun(_jcfg(graph_path, max_iter=3, checkpoint_dir=ck))
        out = run_pipeline(_pcfg(graph_path, max_iter=6, checkpoint_dir=ck, resume=True))
    else:
        run_pipeline(_pcfg(graph_path, max_iter=3, checkpoint_dir=ck))
        out = jrun(_jcfg(graph_path, max_iter=6, checkpoint_dir=ck, resume=True))
    np.testing.assert_array_equal(np.asarray(out.labels), full)
    assert out.metrics.of_phase("resume")[0]["iteration"] == 3
    assert [r["iteration"] for r in out.metrics.of_phase("lpa_iter")] == [4, 5, 6]
