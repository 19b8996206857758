"""The port's attention wrappers (spegnet_tpu_torch/ops/pallas_attention.py,
ops/attention.py) against the JAX package, in f32 on the CPU.

The plain versions (which the wrappers take for CPU tensors) are held
against JAX's ``fused_attention_lanes`` and ``fused_attention`` with their
Pallas kernels in interpret mode, at head_dim 72 and the window lengths of
Hiera-L's decomposed blocks: 64 and 256 (windows), 484, 576 and 1600 (the
global blocks at 352^2, 384^2 and 640^2; 1600 takes JAX's query-blocked
kernel).  JAX's lanes entry gets the qkv zero-padded to 128 lanes per head,
as its model hands it (``MultiScaleAttention.pad_qkv``); the port's takes the
unpadded nn.Linear columns.  The autograd Functions (whose backward
recomputes through the plain version) are run with the kernel launcher
replaced by the plain version and their gradients held against JAX's custom
VJPs.  Tolerance atol 2e-5 / rtol 1e-4, as tests/test_pallas_attention.py:
f32 on both sides, softmax sums of at most 1600 terms in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.ops import pallas_attention as jpa
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import attention as tatt
from spegnet_tpu_torch.ops import pallas_attention as tpa

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)
D, HP = 72, 128
LENGTHS = (64, 256, 484, 576, 1600)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpa.pl, "pallas_call", interp)
    yield


def _problems(l):
    """(problems, heads) small enough for interpret mode at length l."""
    return (3, 2) if l <= 256 else (1, 2)


def _pad_heads(qkv, heads):
    """[B, L, 3*H*D] -> [B, L, 3*H*HP]: each (q|k|v, head) zero-padded to HP
    lanes, as spegnet_tpu/models/hiera.py:272 pads the weights."""
    b, l, _ = qkv.shape
    t = qkv.reshape(b, l, 3, heads, D)
    return np.pad(t, ((0, 0), (0, 0), (0, 0), (0, 0), (0, HP - D))).reshape(b, l, -1)


def _strip_heads(o, heads):
    b, l, _ = o.shape
    return o.reshape(b, l, heads, -1)[..., :D].reshape(b, l, heads * D)


@pytest.mark.parametrize("l", LENGTHS)
def test_lanes_plain_matches_jax_lanes_kernel(rng, l):
    p, heads = _problems(l)
    qkv = rng.standard_normal((p, l, 3 * heads * D)).astype(np.float32)
    want = jpa.fused_attention_lanes(jnp.asarray(_pad_heads(qkv, heads)), heads, D ** -0.5)
    want = _strip_heads(np.asarray(want), heads)
    got = tpa.fused_attention_lanes(torch.from_numpy(qkv), heads, D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("l", LENGTHS)
def test_attention_plain_matches_jax_fused_attention(rng, l):
    p, heads = _problems(l)
    q, k, v = (rng.standard_normal((p, l, heads, D)).astype(np.float32) for _ in range(3))
    want = jpa.fused_attention(*(jnp.asarray(t) for t in (q, k, v)))
    got = tpa.fused_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def plain_launcher(monkeypatch):
    """The kernel launcher replaced by the plain version, so the autograd
    Functions run on the CPU."""
    monkeypatch.setattr(kernels, "attention",
                        lambda q, k, v, scale: tatt.attention_reference(q, k, v, scale))


@pytest.mark.parametrize("l", (64, 484))
def test_lanes_function_gradient_matches_jax(rng, plain_launcher, l):
    p, heads = _problems(l)
    qkv = rng.standard_normal((p, l, 3 * heads * D)).astype(np.float32)
    g = rng.standard_normal((p, l, heads * D)).astype(np.float32)
    gp = _pad_heads(np.concatenate([g, g, g], -1), heads)[..., : heads * HP]

    def loss(t):
        return jnp.sum(jpa.fused_attention_lanes(t, heads, D ** -0.5) * jnp.asarray(gp))

    want = _strip_heads(np.asarray(jax.grad(loss)(jnp.asarray(_pad_heads(qkv, heads)))),
                        3 * heads)
    t = torch.from_numpy(qkv).requires_grad_()
    out = tpa.LanesFunction.apply(t, heads, D ** -0.5)
    np.testing.assert_allclose(out.detach().numpy(),
                               tpa.lanes_plain(torch.from_numpy(qkv), heads, D ** -0.5).numpy(),
                               **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("l", (64, 484))
def test_attention_function_gradient_matches_jax(rng, plain_launcher, l):
    p, heads = _problems(l)
    q, k, v, g = (rng.standard_normal((p, l, heads, D)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jpa.fused_attention(q, k, v) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    tpa.AttentionFunction.apply(*leaves, D ** -0.5).backward(torch.from_numpy(g))
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), **TOL)


def test_gates_match_jax(monkeypatch):
    """lanes_supported / is_supported decide as JAX's do on a TPU backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for l in (4, 15, 16, 64, 100, 256, 484, 576, 1024, 1025, 1600, 2304, 4096, 4100, 8192,
              8256, 12288):
        assert tpa.lanes_supported(l, D) == jpa.lanes_supported(l, D), l
        for d, lk in ((72, l), (288, l), (72, l + 4)):
            shp = (1, l, 2, d)
            jq = jax.ShapeDtypeStruct(shp, jnp.float32)
            jk = jax.ShapeDtypeStruct((1, lk, 2, d), jnp.float32)
            tq, tk = torch.empty(shp, device="meta"), torch.empty((1, lk, 2, d), device="meta")
            assert tpa.is_supported(tq, tk, tk) == jpa.is_supported(jq, jk, jk), (l, d, lk)


def test_dispatch_takes_fused_attention_where_supported(rng, monkeypatch):
    calls = []
    orig = tpa.fused_attention
    monkeypatch.setattr(tpa, "fused_attention", lambda *a: calls.append(1) or orig(*a))
    q = torch.from_numpy(rng.standard_normal((2, 64, 2, 8)).astype(np.float32))
    torch.testing.assert_close(tatt.scaled_dot_product_attention(q, q, q),
                               tatt.attention_reference(q, q, q))
    assert len(calls) == 1
    qp = q[:, :16]   # a pooled query: no fused path
    tatt.scaled_dot_product_attention(qp, q, q)
    assert len(calls) == 1


def test_wrappers_refuse_other_devices():
    qkv = torch.empty((1, 64, 3 * 2 * 8), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tpa.fused_attention_lanes(qkv, 2, 0.25)
    q = torch.empty((1, 64, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tpa.fused_attention(q, q, q)
    before = dict(kernels.launches)
    assert kernels.launches == before
