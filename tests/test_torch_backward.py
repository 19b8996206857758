"""Gradients of the port's block, gen-1 block and Q-pool front
(spegnet_tpu_torch/ops/fused_block_t.py, ops/fused_block.py) against the
JAX package's backward kernels and autodiff, in f32 on small Morton
geometries.

On the CPU the port's wrappers run their plain versions and autograd
differentiates them (on CUDA the same wrappers run the Hopper backward
kernels; tests/test_torch_kernels_cuda.py holds those against the plain
gradient).  The JAX side is ``_backward`` / ``_qpool_backward`` (the Pallas
backward kernels, in interpret mode) and the vjp of the XLA references, fed
the same numpy weights zero-padded to its head widths; its gradients are
unpadded before the comparison.  Tolerance: the JAX package's own for its
backward kernels (atol 2e-3, rtol 1e-3, tests/test_fused_block_t.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blocks import (
    _jax_gen1_weights,
    _jax_t_weights,
    _pad_qkv_rows,
    _port_block,
    _weights,
)

from spegnet_tpu.ops import fused_block as jfb
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch.ops import fused_block as tfb
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    yield


def _unpad_rows(a, heads, d, groups):
    """[groups*H*hp, ...] -> [groups*H*d, ...] (head pads dropped)."""
    a = np.asarray(a)
    hp = a.shape[0] // (groups * heads)
    return a.reshape(groups, heads, hp, *a.shape[1:])[:, :, :d].reshape(
        groups * heads * d, *a.shape[1:])


def _unpad_block_grads(dw, heads, d):
    """TBlockWeights of padded [out, in] / [C, 1] grads -> the port's layout."""
    col = lambda a: np.asarray(a)[:, 0]  # noqa: E731
    c = np.asarray(dw.wproj_t).shape[0]
    wproj = np.asarray(dw.wproj_t).reshape(c, heads, -1)[:, :, :d].reshape(c, heads * d)
    return [col(dw.ln1_scale), col(dw.ln1_bias), _unpad_rows(dw.wqkv_t, heads, d, 3),
            _unpad_rows(dw.bqkv_t, heads, d, 3)[:, 0], wproj, col(dw.bproj_t),
            col(dw.ln2_scale), col(dw.ln2_bias), np.asarray(dw.wfc1_t), col(dw.bfc1_t),
            np.asarray(dw.wfc2_t), col(dw.bfc2_t)]


def _port_grads(fn, x, weights, cot):
    """Gradients of sum(fn(x, *weights) * cot) w.r.t. x and every weight."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, *weights)]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    return [t.grad.numpy() for t in leaves]


def _assert_grads(names, got, want):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


BLOCK_CASES = [  # (C, heads, d, L, tokens, approx_gelu)
    (32, 2, 16, 16, 256, False),
    (32, 2, 16, 64, 256, True),
    (32, 2, 16, 256, 256, False),    # global
    (128, 16, 8, 64, 256, False),    # 16 heads (the stage-4 head count)
]


@pytest.mark.parametrize("c,heads,d,l,n,approx", BLOCK_CASES)
def test_block_grad_matches_jax_backward(rng, c, heads, d, l, n, approx):
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    g = (0.1 * rng.standard_normal((2, n, c))).astype(np.float32)
    names = ("x",) + tfbt.BlockWeights._fields
    port_w = [t.numpy() for t in _port_block(w)]

    got = _port_grads(lambda x, *ws: tfbt.fused_block_t(
        x, tfbt.BlockWeights(*ws), heads, l, d ** -0.5, 1e-6, approx), x, port_w, (g,))

    jw, hp = _jax_t_weights(w, heads, d)
    kw = dict(heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=approx)
    xt, gt = jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(g.transpose(0, 2, 1))
    dx_k, dw_k = jfbt._backward(xt, jw, gt, interpret=True, **kw)
    _assert_grads(names, got, [np.asarray(dx_k).transpose(0, 2, 1)]
                  + _unpad_block_grads(dw_k, heads, d))
    _, vjp = jax.vjp(lambda xx, ww: jfbt.block_t_reference(xx, ww, **kw), xt, jw)
    dx_r, dw_r = vjp(gt)
    _assert_grads(names, got, [np.asarray(dx_r).transpose(0, 2, 1)]
                  + _unpad_block_grads(dw_r, heads, d))


@pytest.mark.parametrize("c,heads,d,l,n,approx", [BLOCK_CASES[1], BLOCK_CASES[3]])
def test_gen1_block_grad_matches_jax(rng, c, heads, d, l, n, approx):
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2 * n // l, l, c)).astype(np.float32)
    g = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    port_w = [t.numpy() for t in _port_block(w)]
    got = _port_grads(lambda x, *ws: tfb.fused_block(
        x, tfbt.BlockWeights(*ws), heads, d ** -0.5, 1e-6, approx), x, port_w, (g,))

    jw, hp = _jax_gen1_weights(w, heads, d)

    def loss(xx, ww):
        y = jfb.fused_block(xx, ww, heads, hp, d ** -0.5, 1e-6, approx)
        return jnp.sum(y * g)

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jw)
    row = lambda a: np.asarray(a)[0]  # noqa: E731
    ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2 = dw
    wproj = np.asarray(wproj).T.reshape(c, heads, hp)[:, :, :d].reshape(c, heads * d)
    want = [np.asarray(dx), row(ln1s), row(ln1b), _unpad_rows(np.asarray(wqkv).T, heads, d, 3),
            _unpad_rows(row(bqkv), heads, d, 3), wproj, row(bproj), row(ln2s), row(ln2b),
            np.asarray(wfc1).T, row(bfc1), np.asarray(wfc2).T, row(bfc2)]
    _assert_grads(("x",) + tfbt.BlockWeights._fields, got, want)


def _tie_rows(x):
    """Copy rows inside the aligned 4-token pool groups so pooled values
    tie: every third group 4-way, the next 2-way (kernel_check._tie_rows)."""
    b, n, c = x.shape
    grp = x.reshape(b, n // 4, 4, c).copy()
    r = np.arange(n // 4)
    grp[:, r % 3 == 0] = grp[:, r % 3 == 0, :1]
    grp[:, r % 3 == 1, 1] = grp[:, r % 3 == 1, 0]
    return grp.reshape(b, n, c)


@pytest.mark.parametrize("l,ties", [(16, False), (64, False), (256, False), (64, True)])
def test_qpool_grad_matches_jax_backward(rng, l, ties):
    cin, cout, heads, d, n = 16, 32, 2, 16, 256
    w = _weights(rng, cin, heads, d, cout=cout)
    x = rng.standard_normal((2, n, cin)).astype(np.float32)
    if ties:
        x = _tie_rows(x)
    go = (0.1 * rng.standard_normal((2, n // 4, heads * d))).astype(np.float32)
    gsc = (0.1 * rng.standard_normal((2, n // 4, cout))).astype(np.float32)
    port_w = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wsc", "bsc")]
    got = _port_grads(lambda x, *ws: tfbt.qpool_front(
        x, tfbt.QPoolWeights(*ws), heads, l, d ** -0.5), x, port_w, (go, gsc))

    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    jw = jfbt.QPoolWeights(col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
                           jnp.asarray(w["wsc"]), col(w["bsc"]))
    kw = dict(heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6)
    go_t = np.zeros((2, heads, hp, n // 4), np.float32)
    go_t[:, :, :d] = go.transpose(0, 2, 1).reshape(2, heads, d, n // 4)
    go_t = jnp.asarray(go_t.reshape(2, heads * hp, n // 4))
    gsc_t = jnp.asarray(gsc.transpose(0, 2, 1))
    xt = jnp.asarray(x.transpose(0, 2, 1))

    def unpack(dx, dw):
        c1 = lambda a: np.asarray(a)[:, 0]  # noqa: E731
        return [np.asarray(dx).transpose(0, 2, 1), c1(dw.ln_scale), c1(dw.ln_bias),
                _unpad_rows(dw.wqkv_t, heads, d, 3), _unpad_rows(dw.bqkv_t, heads, d, 3)[:, 0],
                np.asarray(dw.wsc_t), c1(dw.bsc_t)]

    names = ("x",) + tfbt.QPoolWeights._fields
    _assert_grads(names, got, unpack(*jfbt._qpool_backward(xt, jw, go_t, gsc_t,
                                                            interpret=True, **kw)))
    _, vjp = jax.vjp(lambda xx, ww: jfbt.qpool_front_reference(xx, ww, **kw), xt, jw)
    _assert_grads(names, got, unpack(*vjp((go_t, gsc_t))))
