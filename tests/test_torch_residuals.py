"""The T-block's saved-residual pair (spegnet_tpu_torch/ops/fused_block_t.py
``block_plain_res`` / ``block_plain_bwd_res``, the plain versions of the
Hopper chains ``block_cuda_res`` / ``block_cuda_bwd_res``) against the JAX
package's ``_forward_res`` / ``_backward_res`` (the Pallas kernels in
interpret mode), in f32 on small Morton geometries, and the written-out
backward against autograd of ``block_plain`` in f64; the
``SPEGNET_SAVE_RESIDUALS`` gate against JAX's ``_save_res_ok`` and its
route counts at Hiera-L 512^2.  On the card (tests/test_torch_kernels_cuda.py)
the chains are held bit-equal to the recompute pair and to these plain
versions.

Tolerances: the forward, the JAX package's block tolerance (atol / rtol
1e-4, tests/test_torch_blocks.py); the backward, its backward kernels'
(atol 2e-3, rtol 1e-3, tests/test_fused_block_t.py); the written-out
backward against autograd in f64, 1e-12 of each gradient's max (measured:
below 1e-15)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backward import _unpad_block_grads, _unpad_rows
from test_torch_blocks import _jax_t_weights, _port_block, _weights

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
BWD_TOL = dict(atol=2e-3, rtol=1e-3)
F64_RTOL = 1e-12

CASES = [  # (C, heads, d, L, tokens, approx_gelu)
    (32, 2, 16, 16, 256, False),
    (32, 2, 16, 64, 256, True),
    (32, 2, 16, 256, 256, True),    # global
]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)


def _case(rng, c, heads, d, l, n, approx):
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    jw, hp = _jax_t_weights(w, heads, d)
    kw = dict(heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=approx)
    return w, x, jw, kw


def _tokens(a):
    """JAX's [B, F, N] -> the port's token-major [B*N, F]."""
    a = np.asarray(a)
    return a.transpose(0, 2, 1).reshape(-1, a.shape[1])


def _jax_residuals_as_port(jres, heads, d):
    """JAX BlockResiduals (head-padded, [B, F, N]) -> the port's layout."""
    qkv = np.stack([_unpad_rows(q, heads, d, 3) for q in np.asarray(jres.qkv)])
    ao = np.stack([_unpad_rows(a, heads, d, 1) for a in np.asarray(jres.ao)])
    return _tokens(qkv), _tokens(ao), _tokens(jres.u), _tokens(jres.z)


@pytest.mark.parametrize("c,heads,d,l,n,approx", CASES)
def test_plain_res_forward_matches_jax_forward_res(rng, c, heads, d, l, n, approx):
    w, x, jw, kw = _case(rng, c, heads, d, l, n, approx)
    y, res = tfbt.block_plain_res(torch.from_numpy(x), _port_block(w), heads, l, d ** -0.5,
                                  1e-6, approx)
    jy, jres = jfbt._forward_res(jnp.asarray(x.transpose(0, 2, 1)), jw, interpret=True, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy).transpose(0, 2, 1), **FWD_TOL)
    for name, got, want in zip(("qkv", "ao", "u", "z"), res[:4],
                               _jax_residuals_as_port(jres, heads, d)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **FWD_TOL)
    gelu = torch.nn.functional.gelu(res.z, approximate="tanh" if approx else "none")
    torch.testing.assert_close(res.g, gelu, rtol=0, atol=0)
    assert res.lse is None
    # the output of the pair's forward is block_plain's, bit for bit
    assert torch.equal(y, tfbt.fused_block_t(torch.from_numpy(x), _port_block(w), heads, l,
                                             d ** -0.5, 1e-6, approx))


@pytest.mark.parametrize("c,heads,d,l,n,approx", CASES)
def test_plain_res_backward_matches_jax_backward_res(rng, c, heads, d, l, n, approx):
    """Both backwards read the same residuals: JAX's, in the port's layout
    (g = gelu(z), as JAX rebuilds it)."""
    w, x, jw, kw = _case(rng, c, heads, d, l, n, approx)
    dy = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    xt, dyt = jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(dy.transpose(0, 2, 1))
    _, jres = jfbt._forward_res(xt, jw, interpret=True, **kw)
    qkv, ao, u, z = (torch.from_numpy(np.ascontiguousarray(a))
                     for a in _jax_residuals_as_port(jres, heads, d))
    g = torch.nn.functional.gelu(z, approximate="tanh" if approx else "none")
    res = tfbt.BlockResiduals(qkv, ao, u, z, g)
    dx, dws = tfbt.block_plain_bwd_res(torch.from_numpy(x), _port_block(w),
                                       torch.from_numpy(dy), res, heads, l, d ** -0.5, 1e-6,
                                       approx)
    jdx, jdw = jfbt._backward_res(xt, jw, dyt, jres, interpret=True, **kw)
    want = [np.asarray(jdx).transpose(0, 2, 1)] + _unpad_block_grads(jdw, heads, d)
    for name, a, b in zip(("x",) + tfbt.BlockWeights._fields, (dx, *dws), want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("approx", [True, False])
def test_plain_res_backward_matches_autograd(rng, approx):
    c, heads, d, l, n = 32, 2, 16, 64, 256
    w = {k: v.astype(np.float64) for k, v in _weights(rng, c, heads, d).items()}
    wts = _port_block(w)
    x = torch.from_numpy(rng.standard_normal((2, n, c)))
    dy = torch.from_numpy(rng.standard_normal((2, n, c)))
    y, res = tfbt.block_plain_res(x, wts, heads, l, d ** -0.5, 1e-6, approx)
    got = tfbt.block_plain_bwd_res(x, wts, dy, res, heads, l, d ** -0.5, 1e-6, approx)
    leaves = [t.clone().requires_grad_() for t in (x, *wts)]
    out = tfbt.block_plain(leaves[0], tfbt.BlockWeights(*leaves[1:]), heads, l, d ** -0.5,
                           1e-6, approx)
    want = torch.autograd.grad(out, leaves, dy)
    for name, a, b in zip(("x",) + tfbt.BlockWeights._fields, (got[0], *got[1]), want):
        assert a.dtype == torch.float64, name
        torch.testing.assert_close(a, b, rtol=0, atol=F64_RTOL * b.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_gate_follows_jax(monkeypatch, mode):
    monkeypatch.setattr(jfbt, "SAVE_RESIDUALS", mode)
    monkeypatch.setattr(tfbt, "SAVE_RESIDUALS", mode)
    for b in (1, 2, 8, 42, 64):
        for n in (256, 1024, 4096, 16384, 65536):
            assert tfbt.save_residuals(b, n) == jfbt._save_res_ok(b, n), (b, n)


def test_gate_refuses_unknown_values(monkeypatch):
    monkeypatch.setattr(tfbt, "SAVE_RESIDUALS", "yes")
    with pytest.raises(ValueError, match="SPEGNET_SAVE_RESIDUALS"):
        tfbt.save_residuals(8, 1024)


# Hiera-L 512^2 (patch grid 128): T-blocks on the pair per training forward,
# batch 8 / batch 42 (the config's): "auto" takes stages 2 and 3 (5 + 35
# blocks, b * n_tok <= 32768) at batch 8 and none at batch 42.
PAIR_BLOCKS = {"0": (0, 0), "1": (42, 42), "auto": (40, 0)}


@pytest.mark.parametrize("mode", sorted(PAIR_BLOCKS))
def test_gate_routes_at_hiera_l_512(monkeypatch, mode):
    monkeypatch.setattr(tfbt, "SAVE_RESIDUALS", mode)
    for batch, want in zip((8, 42), PAIR_BLOCKS[mode]):
        routes = collections.Counter(trunk_routes(HIERA_VARIANTS["large"], 128,
                                                  torch.bfloat16, False, train_batch=batch))
        assert routes["fused_block_t_res"] == want, (batch, routes)
        assert routes["fused_block_t"] + routes["fused_block_t_res"] == 42
    # inference routes never take the pair
    assert "fused_block_t_res" not in trunk_routes(HIERA_VARIANTS["large"], 128,
                                                   torch.bfloat16, False)


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_training_forward_routes_through_the_pair(monkeypatch, mode):
    """``route`` sends a block to the residual Function only when autograd
    will run its backward and the gate holds (batch 2 x 16384 tokens: 32768,
    "auto" takes it); on a CUDA tensor ``fused_block_t`` then counts
    ``fused_block_t_res`` (tests/test_torch_kernels_cuda.py runs it)."""
    monkeypatch.setattr(tfbt, "SAVE_RESIDUALS", mode)
    wts = tfbt.BlockWeights(*[torch.zeros(1) for _ in tfbt.BlockWeights._fields])
    x = torch.zeros((2, 16384, 1))
    pair = mode != "0"
    assert tfbt.route(x, wts) == "fused_block_t"
    assert tfbt.route(x.requires_grad_(), wts) == ("fused_block_t_res" if pair
                                                   else "fused_block_t")
    with torch.no_grad():
        assert tfbt.route(x, wts) == "fused_block_t"
    x = torch.zeros((3, 16384, 1))
    trained = tfbt.BlockWeights(*[t.requires_grad_() for t in wts])
    assert tfbt.route(x, trained) == ("fused_block_t_res" if mode == "1" else "fused_block_t")
