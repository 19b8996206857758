"""The port's decoder block 2 (spegnet_tpu_torch/ops/fused_decoder.py) against
the JAX package's decoder_block_reference and its Pallas kernel in interpret
mode, in f32, border rows and columns included.

Tolerance 2e-4 (abs and rel), the JAX package's own kernel-vs-reference
tolerance for the head output (tests/test_fused_decoder.py): f32 on both
sides, 9*Cin-term conv reductions summed in different orders.

The edge form of the block (block 1's geometry, no model path) against
JAX's edge kernel and reference: f32 within 2e-5 (JAX's own
kernel-vs-reference tolerance for the block output), bf16 within JAX's bf16
tolerance (6e-2 of max(|ref|, 1)); its border strips as JAX's make_strips.
The int8 mode is tests/test_torch_decoder_i8.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_decoder as jfd
from spegnet_tpu_torch.ops import fused_decoder as tfd
from tests.test_torch_decoder_i8 import BF, _jax_block, _jx, _port, capture  # noqa: F401
from tests.test_torch_decoder_i8 import _case as _case_i8

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def interpret_on(monkeypatch):
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    yield


def _case(rng, b=2, s=32, cin=16, cm=8):
    def n(*shape, s_=1.0):
        return (rng.standard_normal(shape) * s_).astype(np.float32)

    def bn():
        return dict(gamma=rng.uniform(0.5, 1.5, cm).astype(np.float32),
                    beta=n(cm, s_=0.1), mean=n(cm, s_=0.1),
                    var=rng.uniform(0.5, 2.0, cm).astype(np.float32))

    return dict(x=n(b, s, s, cin), k1=n(3, 3, cin, cm, s_=0.05), b1=n(cm, s_=0.1),
                bn1=bn(), k2=n(3, 3, cm, cm, s_=0.05), b2=n(cm, s_=0.1), bn2=bn(),
                head_w=n(cm, 1, s_=0.1), head_b=n(1))


def _port_params(c):
    t = torch.from_numpy

    def bn(d):
        return (t(d["gamma"]), t(d["beta"]), t(d["mean"]), t(d["var"]), 1e-5)

    return tfd.DecoderParams(
        t(c["k1"].transpose(3, 2, 0, 1).copy()), t(c["b1"]), bn(c["bn1"]),
        t(c["k2"].transpose(3, 2, 0, 1).copy()), t(c["b2"]), bn(c["bn2"]),
        t(c["head_w"].T.reshape(1, -1, 1, 1).copy()), t(c["head_b"]))


def _jax(c):
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
             else {kk: jnp.asarray(vv) for kk, vv in v.items()}) for k, v in c.items()}
    _, ref = jfd.decoder_block_reference(j["x"], j["k1"], j["b1"], j["bn1"], j["k2"],
                                         j["b2"], j["bn2"], head_w=j["head_w"],
                                         head_b=j["head_b"])
    params = jfd.pack_params(j["k1"], j["b1"], j["bn1"], j["k2"], j["b2"], j["bn2"],
                             head_w=j["head_w"], head_b=j["head_b"], dtype=jnp.float32)
    strips = jfd.make_strips(j["x"], j["k1"], dtype=jnp.float32)
    _, ker = jfd.fused_decoder_block(j["x"], params, strips, sh=8, interpret=True)
    b, s = c["x"].shape[:2]
    return np.asarray(ref), np.asarray(ker).reshape(b, 2 * s, 2 * s, 1)


@pytest.mark.parametrize("s,cin,cm", [(32, 16, 8), (16, 32, 16)])
def test_block2_matches_jax(rng, s, cin, cm):
    c = _case(rng, s=s, cin=cin, cm=cm)
    got = tfd.fused_decoder_block(torch.from_numpy(c["x"]), _port_params(c)).numpy()
    assert got.shape == (2, 2 * s, 2 * s, 1)
    ref, ker = _jax(c)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, ker, **TOL)
    # The outermost rows and columns, where conv zero padding meets the
    # bilinear edge clamp (the TPU kernel pastes them from separate strips).
    for sl in ((slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0),
               (slice(None), slice(None), -1)):
        np.testing.assert_allclose(got[sl], ker[sl], **TOL)


def test_fold_bn_matches_jax(rng):
    cm = 8
    args = [rng.standard_normal(cm).astype(np.float32) for _ in range(4)]
    var = rng.uniform(0.5, 2.0, cm).astype(np.float32)
    s, t = tfd.fold_bn(*[torch.from_numpy(a) for a in args], torch.from_numpy(var))
    js, jt = jfd.fold_bn(*[jnp.asarray(a) for a in args], jnp.asarray(var))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)


def test_edge_strips_match_jax(rng):
    c = _case_i8(rng, cin=16, cm=8, edge=True)
    got = tfd.make_strips(torch.from_numpy(c["x"]), torch.from_numpy(c["k1"]),
                          torch.from_numpy(c["k_edge"]), torch.from_numpy(c["ef"]),
                          dtype=torch.float32)
    want = jfd.make_strips(jnp.asarray(c["x"]), jnp.asarray(c["k1"]), jnp.asarray(c["k_edge"]),
                           jnp.asarray(c["ef"]), dtype=jnp.float32)
    b, s, cm = 2, 32, 8
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0])[:, :, :2 * cm].reshape(
        b, 2 * s, cm), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3])[:, :, 0].reshape(
        b, s, 2, 2, cm)[:, :, :, 1].reshape(b, 2 * s, cm), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("head", [False, True])
def test_edge_form_matches_jax_f32(rng, capture, head):
    c = _case_i8(rng, cin=16, cm=8, edge=True)
    want_out, want_pred, _ = _jax_block(c, jnp.float32, capture, edge=True, head=head)
    p = _port(c, head=head)
    got = tfd.fused_decoder_block(torch.from_numpy(c["x"]), p, torch.from_numpy(c["ef"]))
    ref, ref_pred = jfd.decoder_block_reference(
        _jx(c, "x"), _jx(c, "k1"), _jx(c, "b1"), _jx(c, "bn1"), _jx(c, "k2"), _jx(c, "b2"),
        _jx(c, "bn2"), k_edge=_jx(c, "k_edge"), ef=_jx(c, "ef"),
        head_w=_jx(c, "head_w") if head else None, head_b=_jx(c, "head_b") if head else None)
    if head:
        assert got.shape == (2, 64, 64, 1)
        np.testing.assert_allclose(got[..., 0].numpy(), want_pred, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_pred), rtol=2e-5, atol=2e-5)
    else:
        assert got.shape == (2, 64, 64, 8)
        np.testing.assert_allclose(got.numpy(), want_out, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_edge_form_bf16_close_to_jax(rng, capture):
    c = _case_i8(rng, cin=16, cm=8, edge=True)
    want, _, _ = _jax_block(c, jnp.bfloat16, capture, edge=True, head=False)
    got = tfd.decoder_block_plain(torch.from_numpy(c["x"]).to(BF), _port(c, head=False),
                                  torch.from_numpy(c["ef"]).to(BF)).float().numpy()
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) < 6e-2
    # int8 with an edge branch is the bf16 block, as in JAX (:582-583)
    p = _port(c, head=False)
    xb, eb = torch.from_numpy(c["x"]).to(BF), torch.from_numpy(c["ef"]).to(BF)
    torch.testing.assert_close(tfd.fused_decoder_block(xb, p, eb, int8=True),
                               tfd.fused_decoder_block(xb, p, eb), rtol=0, atol=0)


def test_edge_features_go_with_the_edge_branch(rng):
    c = _case_i8(rng, b=1, s=16, cin=16, cm=8, edge=True)
    x, ef = torch.from_numpy(c["x"]), torch.from_numpy(c["ef"])
    with pytest.raises(ValueError):
        tfd.fused_decoder_block(x, _port(c), None)
    with pytest.raises(ValueError):
        tfd.fused_decoder_block(x, _port(c)._replace(we=None), ef)
