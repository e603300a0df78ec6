"""Port parity: the masked cross kNN and streaming LOF (CPU).

The same seeded inputs go through the JAX package's ``cross_knn``,
``fit_lof``, ``score_lof`` and ``StreamingLOF`` and through the port's.
Indices are equal; on clouds of integer coordinates every squared
distance is an integer below 2^24, exact in float32 in any order, so the
distances are bit-equal there (the JAX ``Precision.HIGHEST`` product and
the port's feature-by-feature sums round real-valued near-ties apart in
the last bits). LOF holds the port's stated tolerance: rtol 1e-4 on 99.9%
of rows and 1e-2 on all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmine_tpu.ops import streaming_lof as jsl
from graphmine_tpu.ops.knn import cross_knn as jcross_knn

from graphmine_tpu_torch.ops import streaming_lof as sl
from graphmine_tpu_torch.ops.knn import cross_knn
from _torch_threads import one_torch_thread  # noqa: F401


def _lof_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, rel.max()


def _cloud(n, f, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 200, (n, f)).astype(np.float32)
    return rng.normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "integer"])
@pytest.mark.parametrize("valid,k", [(300, 20), (250, 20), (15, 20)],
                         ids=["unmasked", "masked", "fewer_valid_than_k"])
def test_cross_knn_ref_mask_matches(integer, valid, k):
    q = _cloud(60, 6, integer, 1)
    r = _cloud(300, 6, integer, 2)
    mask = np.zeros(300, bool)
    mask[:valid] = True
    mask = np.random.default_rng(3).permutation(mask) if valid < 300 else mask
    jd, ji = jcross_knn(jnp.asarray(q), jnp.asarray(r), k=k, ref_mask=jnp.asarray(mask))
    pd, pi = cross_knn(torch.from_numpy(q), torch.from_numpy(r), k=k,
                       ref_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    jd, pd = np.asarray(jd), pd.numpy()
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
    if integer:
        np.testing.assert_array_equal(pd, jd)
    else:
        fin = np.isfinite(jd)
        np.testing.assert_allclose(pd[fin], jd[fin], rtol=1e-5, atol=1e-5)
    # masked slots never beat a valid one, and take +inf
    assert mask[pi.numpy()[np.isfinite(pd)]].all()


def test_cross_knn_is_true_float32_under_tf32():
    q, r = _cloud(40, 8, False, 4), _cloud(120, 8, False, 5)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        a = cross_knn(torch.from_numpy(q), torch.from_numpy(r), k=9)
        torch.backends.cuda.matmul.allow_tf32 = True
        b = cross_knn(torch.from_numpy(q), torch.from_numpy(r), k=9)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [5, 12])
def test_fit_and_score_padded_match_unpadded_and_jax(k):
    pts = _cloud(200, 5, False, 6)
    queries = _cloud(70, 5, False, 7)
    padded = np.zeros((320, 5), np.float32)
    padded[:200] = pts
    mask = np.zeros(320, bool)
    mask[:200] = True
    whole = sl.fit_lof(torch.from_numpy(pts), k=k)
    pad = sl.fit_lof(torch.from_numpy(padded), torch.from_numpy(mask), k=k)
    # the duplicate floor sums over the padded window: only its order moves
    np.testing.assert_allclose(pad.kdist[:200].numpy(), whole.kdist.numpy(), rtol=1e-6)
    np.testing.assert_allclose(pad.lrd[:200].numpy(), whole.lrd.numpy(), rtol=1e-5)
    assert not pad.kdist[200:].any() and not pad.lrd[200:].any()
    _lof_close(sl.score_lof(pad, torch.from_numpy(queries)).numpy(),
               sl.score_lof(whole, torch.from_numpy(queries)).numpy())
    jm = jsl.fit_lof(jnp.asarray(padded), jnp.asarray(mask), k=k)
    np.testing.assert_allclose(pad.kdist.numpy(), np.asarray(jm.kdist), rtol=1e-5, atol=1e-6)
    _lof_close(pad.lrd.numpy()[:200], np.asarray(jm.lrd)[:200])
    _lof_close(sl.score_lof(pad, torch.from_numpy(queries)).numpy(),
               np.asarray(jsl.score_lof(jm, jnp.asarray(queries))))


def test_model_state_from_knn_matches_fit():
    """The IVF re-fit's state formula equals the exact fit's on the same
    self-kNN."""
    from graphmine_tpu_torch.ops.knn import knn

    pts = torch.from_numpy(_cloud(150, 4, False, 8))
    d2, idx = knn(pts, 7)
    kdist, lrd = sl._model_state_from_knn(d2, idx, 7)
    fit = sl.fit_lof(pts, k=7)
    np.testing.assert_allclose(kdist.numpy(), fit.kdist.numpy(), rtol=1e-6)
    np.testing.assert_allclose(lrd.numpy(), fit.lrd.numpy(), rtol=1e-5)


@pytest.mark.parametrize("impl,seeded", [("exact", False), ("ivf", False), ("ivf", True)],
                         ids=["exact", "ivf", "ivf_seeded_centers"])
def test_streaming_lof_matches_jax_over_a_chunk_sequence(impl, seeded):
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(1400, 6)).astype(np.float32)
    centers = None
    if seeded:
        from graphmine_tpu.ops.ann import default_n_clusters, kmeans as jkmeans

        centers = np.asarray(jkmeans(pts[:512], default_n_clusters(512), seed=0))
    js = jsl.StreamingLOF(k=10, capacity=512, impl=impl, centers=centers)
    ps = sl.StreamingLOF(k=10, capacity=512, impl=impl, centers=centers, device="cpu")
    for i in range(0, 1400, 200):
        _lof_close(ps.update(pts[i:i + 200]), js.update(pts[i:i + 200]))
    assert ps.ivf_retrains == js.ivf_retrains == (1 if impl == "ivf" and not seeded else 0)
    assert ps._valid == js._valid and ps._write == js._write
    np.testing.assert_array_equal(ps._refs, js._refs)
    if impl == "ivf":
        np.testing.assert_allclose(ps._centers, np.asarray(js._centers), atol=1e-5)
    ps.sync()


def test_streaming_lof_admit_threshold_and_retrain_cadence():
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(1200, 4)).astype(np.float32)
    pts[::50] *= 8  # a few far points the threshold keeps out
    kw = dict(k=8, capacity=300, admit_threshold=1.6, impl="ivf", ivf_retrain_every=2)
    js, ps = jsl.StreamingLOF(**kw), sl.StreamingLOF(**kw, device="cpu")
    for i in range(0, 1200, 150):
        _lof_close(ps.update(pts[i:i + 150]), js.update(pts[i:i + 150]))
    assert ps.ivf_retrains == js.ivf_retrains >= 2
    assert ps._valid == js._valid and ps._write == js._write


@pytest.mark.parametrize("kw,chunk", [
    (dict(k=20, capacity=21), 30),
    (dict(k=5, impl="hnsw"), 30),
    (dict(k=5, ivf_retrain_every=-1), 30),
    (dict(k=20, capacity=100), 10),
], ids=["capacity", "impl", "retrain", "first_chunk"])
def test_streaming_lof_refusals_match(kw, chunk):
    pts = np.random.default_rng(0).normal(size=(chunk, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        jsl.StreamingLOF(**kw).update(pts)
    with pytest.raises(ValueError):
        sl.StreamingLOF(**kw, device="cpu").update(pts)


def test_streaming_lof_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sl.StreamingLOF(k=4, capacity=64)
