"""The port's COD metrics (spegnet_tpu_torch/metrics/torch_metrics.py) against
the JAX package's (spegnet_tpu/metrics/jax_metrics.py) and its float64
NumPy oracle (metrics/numpy_reference.py).

Both device implementations are f32 over the same canvas; their sums run in
different orders, so each metric is held to 1e-5 absolute against JAX.  The
oracle is f64 per sample, held to 2e-4 as tests/test_metrics.py holds JAX.
The quantization and the distance transforms must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.metrics import jax_metrics as jm
from spegnet_tpu.metrics.numpy_reference import compute_sample_metrics_np
from spegnet_tpu_torch.metrics import torch_metrics as tm
from tests.test_metrics import blob_mask, soft_pred

KEYS = ("sm", "wfm", "mae", "em", "fm")


def _canvas(samples, canvas):
    b = len(samples)
    hc, wc = canvas
    pred = np.zeros((b, hc, wc), np.uint8)
    gt = np.zeros((b, hc, wc), np.float32)
    valid = np.zeros((b, hc, wc), np.float32)
    hw = np.zeros((b, 2), np.int32)
    dst = np.zeros((b, hc, wc), np.float32)
    idx = np.zeros((b, hc, wc), np.int32)
    for i, (p, g) in enumerate(samples):
        h, w = g.shape
        pred[i, :h, :w] = p
        gt[i, :h, :w] = g
        valid[i, :h, :w] = 1.0
        hw[i] = (h, w)
        dst[i], idx[i] = tm.edt_for_canvas(g, canvas)
    return pred, gt, valid, hw, dst, idx


def _random_samples():
    rng = np.random.default_rng(0)
    out = []
    for h, w in [(50, 70), (64, 64), (90, 41), (33, 96)]:
        g = blob_mask(rng, h, w, n_blobs=2)
        out.append((soft_pred(rng, g), g))
    return out, (96, 96)


def _edge_samples():
    """tests/test_metrics.py:62-100: empty and full ground truths, perfect,
    constant and binary predictions."""
    rng = np.random.default_rng(1)
    h = w = 40
    zeros, ones = np.zeros((h, w), np.float32), np.ones((h, w), np.float32)
    g = blob_mask(rng, h, w)
    return [
        (np.zeros((h, w), np.uint8), zeros),
        (np.full((h, w), 255, np.uint8), ones),
        (soft_pred(rng, zeros), zeros),
        (soft_pred(rng, ones), ones),
        (np.full((h, w), 128, np.uint8), blob_mask(rng, h, w)),
        ((blob_mask(rng, h, w) * 255).astype(np.uint8), blob_mask(rng, h, w)),
        ((g * 255).astype(np.uint8), g),                                  # perfect
    ], (64, 64)


@pytest.fixture(scope="module", params=["random_blobs", "edge_cases"])
def case(request):
    samples, canvas = (_random_samples if request.param == "random_blobs"
                       else _edge_samples)()
    arrays = _canvas(samples, canvas)
    port = tm.compute_batch_metrics(*[torch.from_numpy(a) for a in arrays])
    jax_out = jm.compute_batch_metrics(*[jnp.asarray(a) for a in arrays])
    oracle = [compute_sample_metrics_np(p, (g * 255).astype(np.uint8)) for p, g in samples]
    return ({k: v.numpy() for k, v in port.items()},
            {k: np.asarray(v) for k, v in jax_out.items()}, oracle)


@pytest.mark.parametrize("key", KEYS)
def test_metric_matches_jax_and_oracle(case, key):
    port, jax_out, oracle = case
    assert port[key].dtype == np.float32
    np.testing.assert_allclose(port[key], jax_out[key], rtol=0, atol=1e-5)
    np.testing.assert_allclose(port[key], [o[key] for o in oracle], rtol=0, atol=2e-4)


def test_perfect_prediction_scores():
    rng = np.random.default_rng(7)
    g = blob_mask(rng, 60, 60)
    pred, gt, valid, hw, dst, idx = _canvas([((g * 255).astype(np.uint8), g)], (64, 64))
    m = tm.compute_sample_metrics(*[torch.from_numpy(a[0]) for a in (pred, gt, valid, hw,
                                                                       dst, idx)])
    assert float(m["mae"]) == 0.0
    assert float(m["sm"]) > 0.95 and float(m["wfm"]) > 0.99 and float(m["em"]) > 0.99


def test_without_edt_maps_there_is_no_weighted_f():
    pred, gt, valid, hw, _, _ = _canvas(_random_samples()[0][:1], (96, 96))
    out = tm.compute_batch_metrics(*[torch.from_numpy(a) for a in (pred, gt, valid, hw)])
    assert set(out) == {"sm", "mae", "em", "fm"}


def test_quantize_predictions_bit_exact():
    rng = np.random.default_rng(3)
    logits = np.concatenate([np.linspace(-8, 8, 4001, dtype=np.float32),
                             (rng.standard_normal(20000) * 4).astype(np.float32)])
    got = tm.quantize_predictions(torch.from_numpy(logits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.quantize_predictions(jnp.asarray(logits))))


@pytest.mark.parametrize("shape,canvas", [((40, 50), (64, 64)), ((64, 64), (64, 64)),
                                          ((30, 20), (32, 48))])
def test_edt_for_canvas_equals_jax_scipy_branch(monkeypatch, shape, canvas):
    from spegnet_tpu import native

    monkeypatch.setattr(native, "edt_with_indices", lambda fg: None)
    rng = np.random.default_rng(5)
    for g in (blob_mask(rng, *shape, n_blobs=3), np.zeros(shape, np.float32)):
        d, i = tm.edt_for_canvas(g, canvas)
        jd, ji = jm.edt_for_canvas(g, canvas)
        assert d.dtype == np.float32 and i.dtype == np.int32
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(i, ji)
