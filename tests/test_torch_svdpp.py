"""Port parity: SVD++ against the JAX package (CPU).

From the same ``init`` (the JAX model's arrays carried across with
``SVDPlusPlusModel.from_numpy``) the RMSE history, the learned factors and
the predictions agree within rtol 1e-5 / atol 1e-6 (segment sums in
element order on both sides; XLA fuses the dense updates). The seeded
draw itself is the port's copy of JAX's (normal within 4 ulp), so a run
without ``init`` agrees within the same tolerance."""

import importlib

import numpy as np
import pytest
import torch

js = importlib.import_module("graphmine_tpu.ops.svdpp")
from graphmine_tpu_torch.ops import svdpp as ts  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("p", "q", "y", "bu", "bi", "mu")


def _ratings(seed, users=60, items=40, e=900):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, users, e)
    dst = users + rng.integers(0, items, e)
    r = rng.integers(1, 6, e).astype(np.float32)
    return src, dst, r, users + items


def _carry(jmodel):
    return ts.SVDPlusPlusModel.from_numpy(*(np.asarray(getattr(jmodel, f)) for f in FIELDS),
                                          device="cpu")


def _close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"rank": 4, "max_iter": 12, "lr_factor": 0.2},
                                {"reg_bias": 0.5, "min_val": 1.0, "max_val": 5.0}],
                         ids=["default", "rank4", "regs"])
def test_training_from_a_shared_init(kw):
    src, dst, r, v = _ratings(0)
    jinit, _ = js.svd_plus_plus(src, dst, r, v, rank=kw.get("rank", 10), max_iter=0, seed=9)
    jm, jh = js.svd_plus_plus(src, dst, r, v, **kw, seed=5)
    # the JAX run starts from its own seed-5 draw: carry that draw across
    jstart, _ = js.svd_plus_plus(src, dst, r, v, rank=kw.get("rank", 10), max_iter=0, seed=5)
    m, h = ts.svd_plus_plus(src, dst, r, v, **kw, device="cpu", init=_carry(jstart))
    _close(jh, h)
    for f in FIELDS:
        _close(getattr(jm, f), getattr(m, f))
    assert not np.array_equal(np.asarray(jinit.p), np.asarray(jstart.p))


def test_seeded_draw_matches_jax():
    src, dst, r, v = _ratings(1)
    jm, jh = js.svd_plus_plus(src, dst, r, v, max_iter=15, seed=3)
    m, h = ts.svd_plus_plus(src, dst, r, v, max_iter=15, seed=3, device="cpu")
    _close(jh, h)
    for f in FIELDS:
        _close(getattr(jm, f), getattr(m, f))
    assert float(h[-1]) < float(h[0])


@pytest.mark.parametrize("bounds", [(0.0, 5.0), (None, None), (1.0, None)])
def test_predictions(bounds):
    src, dst, r, v = _ratings(2)
    jm, _ = js.svd_plus_plus(src, dst, r, v, max_iter=10)
    m = _carry(jm)
    rng = np.random.default_rng(4)
    qs, qd = rng.integers(0, 60, 300), 60 + rng.integers(0, 40, 300)
    want = js.svdpp_predict(jm, qs, qd, src, dst, *bounds)
    got = ts.svdpp_predict(m, qs, qd, src, dst, *bounds)
    _close(want, got)


def test_model_carried_across_keeps_its_bits():
    src, dst, r, v = _ratings(3)
    jm, _ = js.svd_plus_plus(src, dst, r, v, max_iter=3)
    m = _carry(jm)
    for f in FIELDS:
        t = getattr(m, f)
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), np.asarray(getattr(jm, f)))


def test_tensor_inputs_and_no_epochs():
    src, dst, r, v = _ratings(4)
    m, h = ts.svd_plus_plus(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(r), v,
                            max_iter=0)
    assert h.shape == (0,) and m.p.device.type == "cpu"
    assert m.p.shape == (v, 10) and float(m.mu) == pytest.approx(float(r.mean()))
