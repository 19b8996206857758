"""The port's decoder block 2 (spegnet_tpu_torch/ops/fused_decoder.py) against
the JAX package's decoder_block_reference and its Pallas kernel in interpret
mode, in f32, border rows and columns included.

Tolerance 2e-4 (abs and rel), the JAX package's own kernel-vs-reference
tolerance for the head output (tests/test_fused_decoder.py): f32 on both
sides, 9*Cin-term conv reductions summed in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_decoder as jfd
from spegnet_tpu_torch.ops import fused_decoder as tfd

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
