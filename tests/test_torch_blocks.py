"""The port's block and Q-pool front (spegnet_tpu_torch/ops/fused_block_t.py,
ops/fused_block.py) against the JAX package, in f32 on small Morton
geometries: C=32, 2 heads, head_dim 16, windows of 16 / 64 / 256 tokens and
a global block over 1024, plus a 16-head case.

Each port function (its plain version -- the wrappers take it for CPU
tensors) is held against the JAX XLA reference and against the Pallas
kernel run in interpret mode, in the transposed [B, C, N] layout of
fused_block_t and in the token-major [windows, L, C] layout of fused_block.
The same numpy weights feed both; the JAX side gets them zero-padded to its
head widths.  Tolerance 1e-4 (abs and rel): f32 on both sides, reductions of
at most 1024 terms summed in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.ops import fused_block as jfb
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch.ops import fused_block as tfb
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


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


def _weights(rng, c, heads, d, cout=None):
    """Unpadded nn.Linear-layout weights ([out, in]) as numpy."""
    cout = cout or c
    f = heads * d

    def n(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(ln1_w=1.0 + n(c, s=0.1), ln1_b=n(c, s=0.1), wqkv=n(3 * f, c),
                bqkv=n(3 * f, s=0.1), wproj=n(cout, f), bproj=n(cout, s=0.1),
                ln2_w=1.0 + n(cout, s=0.1), ln2_b=n(cout, s=0.1), wfc1=n(4 * cout, cout),
                bfc1=n(4 * cout, s=0.1), wfc2=n(cout, 4 * cout), bfc2=n(cout, s=0.1),
                wsc=n(cout, c), bsc=n(cout, s=0.1))


def _port_block(w):
    return tfbt.BlockWeights(*[torch.from_numpy(w[k]) for k in (
        "ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_w", "ln2_b",
        "wfc1", "bfc1", "wfc2", "bfc2")])


def _pad_qkv_rows(wqkv, bqkv, heads, d, hp):
    """[3*H*d, C] -> [3*H*hp, C] with zero rows at each head's pad."""
    c = wqkv.shape[1]
    k = np.zeros((3, heads, hp, c), np.float32)
    k[:, :, :d] = wqkv.reshape(3, heads, d, c)
    b = np.zeros((3, heads, hp), np.float32)
    b[:, :, :d] = bqkv.reshape(3, heads, d)
    return k.reshape(-1, c), b.reshape(-1)


def _pad_proj_cols(wproj, heads, d, hp):
    """[C, H*d] -> [C, H*hp] with zero columns at each head's pad."""
    c = wproj.shape[0]
    k = np.zeros((c, heads, hp), np.float32)
    k[:, :, :d] = wproj.reshape(c, heads, d)
    return k.reshape(c, -1)


def _jax_t_weights(w, heads, d):
    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    return jfbt.TBlockWeights(
        col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
        jnp.asarray(_pad_proj_cols(w["wproj"], heads, d, hp)), col(w["bproj"]),
        col(w["ln2_w"]), col(w["ln2_b"]), jnp.asarray(w["wfc1"]), col(w["bfc1"]),
        jnp.asarray(w["wfc2"]), col(w["bfc2"])), hp


def _jax_gen1_weights(w, heads, d):
    hp = -(-d // 128) * 128
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    row = lambda a: jnp.asarray(a.reshape(1, -1))  # noqa: E731
    return jfb.BlockWeights(
        row(w["ln1_w"]), row(w["ln1_b"]), jnp.asarray(wq.T), row(bq),
        jnp.asarray(_pad_proj_cols(w["wproj"], heads, d, hp).T), row(w["bproj"]),
        row(w["ln2_w"]), row(w["ln2_b"]), jnp.asarray(w["wfc1"].T), row(w["bfc1"]),
        jnp.asarray(w["wfc2"].T), row(w["bfc2"])), hp


BLOCK_CASES = [  # (C, heads, d, L, tokens)
    (32, 2, 16, 16, 1024),
    (32, 2, 16, 64, 1024),
    (32, 2, 16, 256, 1024),
    (32, 2, 16, 1024, 1024),    # global
    (256, 16, 16, 64, 256),     # 16 heads (the stage-4 head count)
]


@pytest.mark.parametrize("c,heads,d,l,n", BLOCK_CASES)
def test_block_matches_fused_block_t(rng, c, heads, d, l, n):
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    kw = dict(heads=heads, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=False)
    got = tfbt.fused_block_t(torch.from_numpy(x), _port_block(w), heads, l, d ** -0.5,
                             1e-6, approx_gelu=False).numpy()
    jw, hp = _jax_t_weights(w, heads, d)
    xt = jnp.asarray(x.transpose(0, 2, 1))
    ref = np.asarray(jfbt.block_t_reference(xt, jw, hp=hp, **kw)).transpose(0, 2, 1)
    np.testing.assert_allclose(got, ref, **TOL)
    ker = np.asarray(jfbt._forward(xt, jw, hp=hp, interpret=True, **kw)).transpose(0, 2, 1)
    np.testing.assert_allclose(got, ker, **TOL)


@pytest.mark.parametrize("c,heads,d,l,n", [BLOCK_CASES[0], BLOCK_CASES[1], BLOCK_CASES[4]])
def test_block_matches_gen1_fused_block(rng, c, heads, d, l, n):
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2 * n // l, l, c)).astype(np.float32)
    got = tfb.fused_block(torch.from_numpy(x), _port_block(w), heads, d ** -0.5, 1e-6,
                          approx_gelu=False).numpy()
    jw, hp = _jax_gen1_weights(w, heads, d)
    kw = dict(heads=heads, hp=hp, scale=d ** -0.5, eps=1e-6, approx_gelu=False)
    ref = np.asarray(jfb.block_reference(jnp.asarray(x), jw, **kw))
    np.testing.assert_allclose(got, ref, **TOL)
    ker = np.asarray(jfb._forward(jnp.asarray(x), jw, interpret=True, **kw))
    np.testing.assert_allclose(got, ker, **TOL)


def test_block_tanh_gelu_matches_reference(rng):
    """Under bf16 the model uses the tanh GELU; check that form in f32."""
    c, heads, d, l, n = BLOCK_CASES[1]
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((1, n, c)).astype(np.float32)
    got = tfbt.block_plain(torch.from_numpy(x), _port_block(w), heads, l, d ** -0.5,
                           approx_gelu=True).numpy()
    jw, hp = _jax_t_weights(w, heads, d)
    ref = jfbt.block_t_reference(jnp.asarray(x.transpose(0, 2, 1)), jw, heads=heads,
                                 hp=hp, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=True)
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 2, 1), **TOL)


@pytest.mark.parametrize("l", [16, 64, 256])
def test_qpool_front_matches_jax(rng, l):
    cin, cout, heads, d, n = 16, 32, 2, 16, 1024
    w = _weights(rng, cin, heads, d, cout=cout)
    x = rng.standard_normal((2, n, cin)).astype(np.float32)
    wts = tfbt.QPoolWeights(*[torch.from_numpy(w[k]) for k in (
        "ln1_w", "ln1_b", "wqkv", "bqkv", "wsc", "bsc")])
    o, sc = tfbt.qpool_front(torch.from_numpy(x), wts, heads, l, d ** -0.5)
    assert o.shape == (2, n // 4, heads * d) and sc.shape == (2, n // 4, cout)

    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    jw = jfbt.QPoolWeights(col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
                           jnp.asarray(w["wsc"]), col(w["bsc"]))
    xt = jnp.asarray(x.transpose(0, 2, 1))
    kw = dict(heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6)

    def unpad(o_t):  # [B, H*hp, N/4] -> [B, N/4, H*d], pad rows dropped
        o_t = np.asarray(o_t).reshape(2, heads, hp, n // 4)[:, :, :d]
        return o_t.reshape(2, heads * d, n // 4).transpose(0, 2, 1)

    for jo, jsc in (jfbt.qpool_front_reference(xt, jw, **kw),
                    jfbt._qpool_forward(xt, jw, interpret=True, **kw)):
        np.testing.assert_allclose(o.numpy(), unpad(jo), **TOL)
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc).transpose(0, 2, 1), **TOL)


@pytest.mark.parametrize("hw", [1, 2, 8, 32])
def test_morton_layout_matches_jax(rng, hw):
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    z = tfbt.to_z(torch.from_numpy(x))
    want = np.asarray(jfbt.to_z(jnp.asarray(x))).transpose(0, 2, 1)
    np.testing.assert_array_equal(z.numpy(), want)
    np.testing.assert_array_equal(tfbt.from_z(z, (hw, hw)).numpy(), x)


def test_morton_windows_and_pool_groups_are_consecutive():
    """In Morton order each aligned ws x ws window is ws^2 consecutive rows
    and each 2x2 pool group 4 consecutive rows."""
    h = 16
    grid = np.arange(h * h, dtype=np.float32).reshape(1, h, h, 1)
    z = tfbt.to_z(torch.from_numpy(grid))[0, :, 0].numpy().astype(int)
    for ws in (2, 4, 8, 16):
        for start in range(0, h * h, ws * ws):
            ys, xs = np.divmod(z[start:start + ws * ws], h)
            assert ys.max() - ys.min() == ws - 1 and xs.max() - xs.min() == ws - 1
            assert ys.min() % ws == 0 and xs.min() % ws == 0
