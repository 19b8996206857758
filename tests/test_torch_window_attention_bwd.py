"""The attention backward kernel's algorithm and launch plan
(csrc/attention_window_bwd.cu, kernels.window_bwd_plan / window_bwd_tmap)
on the CPU.

:func:`emulate` runs the kernels' dataflow in PyTorch:

* the packed route (key windows dividing 64): the plan's units of 64 keys
  of one head, in the order the persistent blocks take them, each with the
  QT = 64 Lq / Lk queries of its windows; boxes read as the tensor map that
  :func:`kernels.window_bwd_tmap` describes reads them (zero past the head
  dim and the last row); S^T = K Q^T and dP^T = V dO^T; the block-diagonal
  mask where the plan masks (key k counts for query r iff k // Lk == r //
  Lq, written as the kernel's unsigned compare) as a select, so another
  window's key gives exactly 0; P^T = exp2(S^T scale log2 e - lse) and dS^T =
  P^T (dP^T - Di) scale, rounded to bf16 (``round_``) for dV += P^T dO, dK
  += dS^T Q and dQ = dS K, dQ complete inside the unit;
* the split route: the dQ kernel first (64-row query tiles as the kernel's
  ``q_decode`` gives them, shared or per consumer, the keys of their windows
  in 64-key tiles in order, dQ += dS K summed in that order, Di written),
  then the dK / dV kernel (pairs of 64-key tiles, ``kv_decode``, each
  walking the 64-row query tiles of its windows in order, reading lse and
  the dQ kernel's Di);
* Di = rowsum(dO o) in f32.

Tolerances: f32 (nothing rounded) atol 2e-5 / rtol 1e-4 against autograd of
the plain attention (sums in other orders); in place of the attention
backward inside the block and front backwards, the JAX package's own
tolerance for its backward kernels (atol 2e-3, rtol 1e-3, as
tests/test_torch_backward.py); bf16 max|a - b| / max|b| <=
kernel_check.BWD_REL_LIMIT against bf16 autograd of the plain attention,
the limit the card's check holds the kernel to.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backward import _port_grads, _unpad_block_grads, _unpad_rows
from test_torch_blocks import _jax_t_weights, _pad_qkv_rows, _port_block, _weights

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch import kernel_check as kc
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt
from spegnet_tpu_torch.ops.attention import attention_reference

torch.set_num_threads(1)
F32_TOL = dict(atol=2e-5, rtol=1e-4)
TOL = dict(atol=2e-3, rtol=1e-3)
T = 64   # rows of a key tile, of a split query tile, of a box
LOG2E = 1.4426950408889634


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


class KvWork(NamedTuple):
    head: int
    kr: int
    qb: int
    nq: int
    active: bool


class QWork(NamedTuple):
    head: int
    row0: int
    kb: int
    ntiles: int
    active: bool


def kv_decode(item, c, k_rows, heads, lq, lk) -> KvWork:
    """The dK / dV kernel's ``kv_decode``: key tile 2 (item // heads) + c of
    head item % heads, the 64-row query tiles of its windows from qb."""
    kr = (2 * (item // heads) + c) * T
    active = kr < k_rows
    last = min(kr + T, k_rows) - 1
    qb = kr // lk * lq
    nq = -(-((last // lk + 1) * lq - qb) // T) if active else 0
    return KvWork(item % heads, kr, qb, nq, active)


def q_decode(item, c, q_rows, heads, lq, lk, shared) -> QWork:
    """The dQ kernel's ``q_decode`` (attention_window.cu's win_decode with
    one m-tile)."""
    if shared:
        chunks = lq // (2 * T)
        wh = item // chunks
        win = wh // heads
        return QWork(wh % heads, win * lq + (item % chunks) * 2 * T + c * T, win * lk,
                     lk // T, True)
    row0 = (2 * (item // heads) + c) * T
    active = row0 < q_rows
    last = min(row0 + T, q_rows) - 1
    kb = (row0 // lq) * lk
    nt = -(-((last // lq + 1) * lk - kb) // T) if active else 0
    return QWork(item % heads, row0, kb, nt, active)


def box(mat, col, heads, d, h, row0, rows, width):
    """Rows [row0, row0 + rows) of head h of the heads * d columns of
    ``mat`` from column ``col``, as the tensor map of
    kernels.window_bwd_tmap reads them, atoms side by side up to ``width``:
    zeros past column d and past the last row."""
    nr, ld = mat.shape
    (dd, nh, nrows), (s_head, s_row), (bx, _, _) = kernels.window_bwd_tmap(nr, ld, heads, d,
                                                                           rows)
    assert bx == 64 and s_head % 16 == 0 and s_row % 16 == 0 and nrows == nr
    out = torch.zeros(rows, width)
    r1 = min(row0 + rows, nrows)
    if r1 > row0 and h < nh:
        c0 = col + h * s_head // 2
        out[:r1 - row0, :min(dd, width)] = mat[row0:r1, c0:c0 + min(dd, width)]
    return out


def _rnd(x, round_):
    return x.to(torch.bfloat16).float() if round_ else x


def emulate(q, k, v, o, dout, lse, heads, d, lq, lk, scale, round_=True, sms=4, log=None):
    """The kernels on f32 tensors.  q / k / v / o / dout: (matrix, first
    column) pairs, heads * d columns each (the kernels' Cols); lse [q_rows,
    heads] in log2 units.  Returns (dq, dk, dv) [rows, heads * d] and Di
    ([q_rows, heads]; the split route's transposed copy with lse, [2 heads,
    q_rows]); ``log`` collects (output, row, head) of every store."""
    q_rows, k_rows = q[0].shape[0], k[0].shape[0]
    assert k_rows == q_rows // lq * lk
    plan = kernels.window_bwd_plan(q_rows, heads, d, lq, lk, sms)
    w, sl2 = plan.dv, scale * LOG2E
    log = [] if log is None else log
    dq = torch.full((q_rows, heads * d), float("nan"))
    dk = torch.full((k_rows, heads * d), float("nan"))
    dv = torch.full((k_rows, heads * d), float("nan"))
    ov = o[0][:, o[1]:o[1] + heads * d]
    gv = dout[0][:, dout[1]:dout[1] + heads * d]
    di_all = (ov.reshape(q_rows, heads, d) * gv.reshape(q_rows, heads, d)).sum(-1)

    def rows_of(t, r0, n, h):   # lse or Di of rows [r0, r0 + n), 0 past the last
        out = torch.zeros(n)
        r1 = min(r0 + n, q_rows)
        if r1 > r0:
            out[:r1 - r0] = t[r0:r1, h]
        return out

    def store(dst, name, row0, acc, limit, h):
        for r in range(acc.shape[0]):
            if row0 + r < limit:
                log.append((name, row0 + r, h))
                dst[row0 + r, h * d:(h + 1) * d] = acc[r, :d]

    if plan.packed:
        qt, units = plan.qt, plan.units
        for blk in range(plan.grid_a):
            for u in range(blk, units, plan.grid_a):
                kt, h = divmod(u, heads)
                k0 = kt * T
                q0 = k0 // lk * lq
                kb_, vb_ = (box(*k, heads, d, h, k0, T, w), box(*v, heads, d, h, k0, T, w))
                qb_, ob_ = (box(*q, heads, d, h, q0, qt, w), box(*dout, heads, d, h, q0, qt, w))
                ls, di = rows_of(lse, q0, qt, h), rows_of(di_all, q0, qt, h)
                st, dpt = kb_ @ qb_.T, vb_ @ ob_.T
                inn = torch.ones(T, qt, dtype=torch.bool)
                if plan.mask:   # (unsigned)(col - lo) < lq
                    lo = (k0 + torch.arange(T)) // lk * lq - q0
                    off = torch.arange(qt)[None, :] - lo[:, None]
                    inn = (off >= 0) & (off < lq)
                p = torch.where(inn, torch.exp2(st * sl2 - ls[None, :]), 0.0)
                ds = torch.where(inn, p * (dpt - di[None, :]) * scale, 0.0)
                pr, dsr = _rnd(p, round_), _rnd(ds, round_)
                store(dk, "dk", k0, dsr @ qb_, k_rows, h)
                store(dv, "dv", k0, pr @ ob_, k_rows, h)
                store(dq, "dq", q0, dsr.T @ kb_, min(q0 + qt, q_rows), h)
        return dq, dk, dv, di_all

    # Split route, the dQ kernel: dQ over its key tiles in order; lse and Di of
    # its rows by head, transposed ([2 heads, q_rows]: lse of head h in row
    # h, Di in row heads + h), for the dK / dV kernel's tensor map.
    dd = torch.full((2 * heads, q_rows), float("nan"))
    for blk in range(plan.grid_b):
        for item in range(blk, plan.items_q, plan.grid_b):
            ws = [q_decode(item, c, q_rows, heads, lq, lk, plan.shared_q) for c in (0, 1)]
            nt = max(x.ntiles for x in ws)
            for wk in ws:
                h, r0 = wk.head, wk.row0
                qb_, ob_ = box(*q, heads, d, h, r0, T, w), box(*dout, heads, d, h, r0, T, w)
                rows = torch.arange(r0, r0 + T)
                ls, di = rows_of(lse, r0, T, h), rows_of(di_all, r0, T, h)
                lo = (rows // lq) * lk - wk.kb
                acc = torch.zeros(T, w)
                for j in range(nt):
                    kb_ = box(*k, heads, d, h, wk.kb + j * T, T, w)
                    vb_ = box(*v, heads, d, h, wk.kb + j * T, T, w)
                    s, dp = qb_ @ kb_.T, ob_ @ vb_.T
                    inn = torch.ones(T, T, dtype=torch.bool)
                    if plan.mask:
                        rel = j * T + torch.arange(T)[None, :] - lo[:, None]
                        inn = (rel >= 0) & (rel < lk)
                    p = torch.where(inn, torch.exp2(s * sl2 - ls[:, None]), 0.0)
                    ds = torch.where(inn, p * (dp - di[:, None]) * scale, 0.0)
                    acc = acc + _rnd(ds, round_) @ kb_
                if wk.active:
                    store(dq, "dq", r0, acc, q_rows, h)
                    keep = rows < q_rows
                    dd[h, rows[keep]] = ls[keep]
                    dd[heads + h, rows[keep]] = di[keep]
    # The dK / dV kernel: each query tile's lse and Di from the dQ kernel's
    # copy, 64-row boxes (zeros past the last row).
    ddt = dd.T
    for blk in range(plan.grid_a):
        for item in range(blk, plan.items_kv, plan.grid_a):
            ws = [kv_decode(item, c, k_rows, heads, lq, lk) for c in (0, 1)]
            nq = max(x.nq for x in ws)
            for c, wk in enumerate(ws):
                src = ws[0] if plan.shared_kv else wk   # the slot this consumer reads
                h = wk.head
                kb_, vb_ = box(*k, heads, d, h, wk.kr, T, w), box(*v, heads, d, h, wk.kr, T, w)
                lo = (wk.kr + torch.arange(T)) // lk * lq - wk.qb
                dka, dva = torch.zeros(T, w), torch.zeros(T, w)
                for jq in range(nq):
                    r0 = src.qb + jq * T
                    qb_, ob_ = box(*q, heads, d, h, r0, T, w), box(*dout, heads, d, h, r0, T, w)
                    ls, di = rows_of(ddt, r0, T, h), rows_of(ddt, r0, T, heads + h)
                    st, dpt = kb_ @ qb_.T, vb_ @ ob_.T
                    inn = torch.ones(T, T, dtype=torch.bool)
                    if plan.mask:
                        rel = jq * T + torch.arange(T)[None, :] - lo[:, None]
                        inn = (rel >= 0) & (rel < lq)
                    p = torch.where(inn, torch.exp2(st * sl2 - ls[None, :]), 0.0)
                    ds = torch.where(inn, p * (dpt - di[None, :]) * scale, 0.0)
                    dva = dva + _rnd(p, round_) @ ob_
                    dka = dka + _rnd(ds, round_) @ qb_
                if wk.active:
                    store(dk, "dk", wk.kr, dka, k_rows, h)
                    store(dv, "dv", wk.kr, dva, k_rows, h)
    return dq, dk, dv, dd


def _forward(qw, kw, vw, scale):
    """The plain forward on [W, Lq | Lk, H, d] windows: (o, lse in log2 units
    [W * Lq, H])."""
    o = attention_reference(qw, kw, vw, scale)
    s = torch.einsum("wqhd,wkhd->wqhk", qw.float(), kw.float()) * scale
    return o, (torch.logsumexp(s, -1) * LOG2E).reshape(-1, qw.shape[2])


def _inputs(lk, pooled, heads, d, k_rows, seed, dtype=torch.float32):
    """The front's y (or a T-block's qkv) and the pooled q, the forward's o and
    lse and an output gradient, all f32 (bf16-valued with ``dtype`` bf16)."""
    g = torch.Generator().manual_seed(seed)
    hd = heads * d
    y = torch.randn((k_rows, 3 * hd + (16 if pooled else 0)), generator=g).to(dtype)
    lq = lk // 4 if pooled else lk
    t = y[:, :3 * hd].reshape(k_rows // lk, lk, 3, heads, d)
    qw = t[:, :, 0].reshape(k_rows // lk, lq, 4, heads, d).amax(2) if pooled else t[:, :, 0]
    o, lse = _forward(qw, t[:, :, 1], t[:, :, 2], d ** -0.5)
    dout = torch.randn(o.shape, generator=g).to(dtype)
    return y, qw, t, o, lse, dout, lq


def _emulate_inputs(y, qw, o, dout, lse, heads, d, lq, lk, pooled, round_, sms=4, log=None):
    hd = heads * d
    q = (qw.reshape(-1, hd).float(), 0) if pooled else (y.float(), 0)
    return emulate(q, (y.float(), hd), (y.float(), 2 * hd), (o.reshape(-1, hd).float(), 0),
                   (dout.reshape(-1, hd).float(), 0), lse, heads, d, lq, lk, d ** -0.5,
                   round_=round_, sms=sms, log=log)


def _plain_grads(qw, t, dout, scale):
    leaves = [x.detach().clone().requires_grad_() for x in (qw, t[:, :, 1], t[:, :, 2])]
    o = attention_reference(*leaves, scale)
    hd = qw.shape[2] * qw.shape[3]
    return [x.reshape(-1, hd) for x in torch.autograd.grad(o, leaves, dout)]


# (key window Lk, pooled, heads, head dim, key rows)
CASES = [
    (16, False, 2, 16, 256),     # packed, 4 windows per unit, masked (stage 2)
    (64, False, 2, 16, 256),     # packed, one window per unit (stage 1, 4)
    (64, False, 1, 72, 192),     # packed at Hiera-L's head dim, 3 units
    (32, False, 2, 8, 160),      # packed, 2 windows per unit, a partial last unit
    (256, False, 2, 16, 512),    # split, shared dQ and dK / dV items (stage 3)
    (128, False, 2, 8, 384),     # split, shared, one dQ item a window
    (1024, False, 1, 8, 2048),   # split, shared, 16 key and query tiles a window (global)
    (48, False, 2, 8, 240),      # split, masked: windows across key and query tiles
    (192, False, 1, 16, 576),    # split, unshared: a pair of key tiles across windows
    (16, True, 2, 16, 256),      # packed pooled Lq 4 / Lk 16, QT 16, masked (t23)
    (64, True, 2, 16, 512),      # packed pooled Lq 16 / Lk 64, QT 16 (t12)
    (64, True, 1, 72, 320),      # t12 at Hiera-L's head dim
    (256, True, 2, 16, 512),     # split pooled Lq 64 / Lk 256: shared dK / dV (t34)
    (1024, True, 1, 8, 2048),    # split pooled Lq 256 / Lk 1024: shared dK / dV
    (80, True, 1, 8, 320),       # split pooled Lq 20, masked, a partial query tile
    (256, False, 1, 96, 512),    # head dim 96
    (16, True, 1, 128, 128),     # head dim 128, pooled and masked
]


@pytest.mark.parametrize("lk,pooled,heads,d,rows", CASES)
def test_emulated_bwd_matches_plain_autograd(lk, pooled, heads, d, rows):
    """The emulation against autograd of the plain attention in f32 (nothing
    rounded), and in bf16 against bf16 autograd within the card check's
    limit; every gradient row stored exactly once."""
    y, qw, t, o, lse, dout, lq = _inputs(lk, pooled, heads, d, rows, lk + d)
    log = []
    got = _emulate_inputs(y, qw, o, dout, lse, heads, d, lq, lk, pooled, False, log=log)
    want = _plain_grads(qw, t, dout, d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **F32_TOL)
    q_rows = rows // lk * lq
    assert sorted(log) == sorted([("dq", r, h) for r in range(q_rows) for h in range(heads)]
                                 + [(n, r, h) for n in ("dk", "dv") for r in range(rows)
                                    for h in range(heads)])
    yb, qb, tb, ob, lseb, gb, _ = _inputs(lk, pooled, heads, d, rows, lk + d, torch.bfloat16)
    got = _emulate_inputs(yb, qb, ob, gb, lseb, heads, d, lq, lk, pooled, True)
    want = _plain_grads(qb, tb, gb, d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a - b.float()).abs().max() / b.float().abs().max()
        assert err <= kc.BWD_REL_LIMIT, (name, float(err))


@pytest.mark.parametrize("lk,pooled", [(16, False), (64, True), (256, False), (48, False),
                                       (1024, False)])
def test_emulated_bwd_is_bit_equal_across_runs_and_grids(lk, pooled):
    """Two runs give the same bits, and so do grids of another size: each
    output element is one sum in a fixed order, whichever block computes
    it."""
    heads, d, rows = 2, 16, {48: 480, 1024: 1024}.get(lk, 512)
    y, qw, t, o, lse, dout, lq = _inputs(lk, pooled, heads, d, rows, 3, torch.bfloat16)
    runs = [_emulate_inputs(y, qw, o, dout, lse, heads, d, lq, lk, pooled, True, sms=s)
            for s in (4, 4, 7)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][:3], runs[2][:3]):
        assert torch.equal(a, b)


class EmulatedAttention(torch.autograd.Function):
    """attention_reference's forward (f32) with the emulated kernel backward
    in place of autograd's."""
    calls = []

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        w, lq, heads, d = q.shape
        lk = k.shape[1]
        hd = heads * d
        EmulatedAttention.calls.append((lq, lk))
        flat = [x.reshape(-1, hd).contiguous() for x in (q, k, v, o, g)]
        dq, dk, dv, _ = emulate(*[(x, 0) for x in flat], lse, heads, d, lq, lk, ctx.scale,
                                round_=False)
        return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape), None)


@pytest.fixture
def emulated_attention(monkeypatch):
    EmulatedAttention.calls = []
    monkeypatch.setattr(tfbt, "attention_reference",
                        lambda q, k, v, scale=None: EmulatedAttention.apply(q, k, v, scale))
    yield EmulatedAttention.calls


@pytest.mark.parametrize("l", [16, 64, 256])
def test_emulated_bwd_in_block_matches_jax_backward(rng, emulated_attention, l):
    """The block's plain version with the emulated attention backward in
    place of autograd's, against JAX's T-block ``_backward``
    (fused_block_t.py:1363) in interpret mode: dx and all twelve weight
    gradients."""
    c, heads, d, n = 32, 2, 16, 256
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    g = (0.1 * rng.standard_normal((2, n, c))).astype(np.float32)
    got = _port_grads(lambda x, *ws: tfbt.block_plain(
        x, tfbt.BlockWeights(*ws), heads, l, d ** -0.5, 1e-6, False), x,
        [t.numpy() for t in _port_block(w)], (g,))
    assert emulated_attention == [(l, l)]
    jw, hp = _jax_t_weights(w, heads, d)
    kw = dict(heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=False)
    dx_k, dw_k = jfbt._backward(jnp.asarray(x.transpose(0, 2, 1)), jw,
                                jnp.asarray(g.transpose(0, 2, 1)), interpret=True, **kw)
    want = [np.asarray(dx_k).transpose(0, 2, 1)] + _unpad_block_grads(dw_k, heads, d)
    for name, a, b in zip(("x",) + tfbt.BlockWeights._fields, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("l", [16, 64, 256])
def test_emulated_bwd_in_front_matches_jax_backward(rng, emulated_attention, l):
    """The front's plain version with the emulated attention backward (on the
    pooled q, Lq = Lk / 4) in place of autograd's, against JAX's
    ``_qpool_backward`` (fused_block_t.py:935) in interpret mode."""
    cin, cout, heads, d, n = 16, 32, 2, 16, 256
    w = _weights(rng, cin, heads, d, cout=cout)
    x = rng.standard_normal((2, n, cin)).astype(np.float32)
    go = (0.1 * rng.standard_normal((2, n // 4, heads * d))).astype(np.float32)
    gsc = (0.1 * rng.standard_normal((2, n // 4, cout))).astype(np.float32)
    port_w = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wsc", "bsc")]
    got = _port_grads(lambda x, *ws: tfbt.qpool_front_plain(
        x, tfbt.QPoolWeights(*ws), heads, l, d ** -0.5), x, port_w, (go, gsc))
    assert emulated_attention == [(l // 4, l)]
    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    jw = jfbt.QPoolWeights(col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
                           jnp.asarray(w["wsc"]), col(w["bsc"]))
    go_t = np.zeros((2, heads, hp, n // 4), np.float32)
    go_t[:, :, :d] = go.transpose(0, 2, 1).reshape(2, heads, d, n // 4)
    dx, dw = jfbt._qpool_backward(jnp.asarray(x.transpose(0, 2, 1)), jw,
                                  jnp.asarray(go_t.reshape(2, heads * hp, n // 4)),
                                  jnp.asarray(gsc.transpose(0, 2, 1)), interpret=True,
                                  heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6)
    c1 = lambda a: np.asarray(a)[:, 0]  # noqa: E731
    want = [np.asarray(dx).transpose(0, 2, 1), c1(dw.ln_scale), c1(dw.ln_bias),
            _unpad_rows(dw.wqkv_t, heads, d, 3), _unpad_rows(dw.bqkv_t, heads, d, 3)[:, 0],
            np.asarray(dw.wsc_t), c1(dw.bsc_t)]
    for name, a, b in zip(("x",) + tfbt.QPoolWeights._fields, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


# Every ATTN_BWD geometry at batch 1 and 8, and shapes whose windows
# straddle tiles or end in a partial one: (lq, lk, q_rows, heads).
PLAN_CASES = ([(n, b) for n in kc.ATTN_BWD for b in (1, 8)]
              + [("odd", (48, 48, 240, 3)), ("odd", (20, 80, 80, 2)), ("odd", (128, 128, 384, 5)),
                 ("odd", (4, 16, 4, 1)), ("odd", (32, 32, 96, 1)), ("odd", (192, 192, 576, 2))])


@pytest.mark.parametrize("name,arg", PLAN_CASES)
def test_plan_covers_every_key_and_query_once(name, arg):
    """kernels.window_bwd_plan: its C argument unpacks to its fields as the
    C entry unpacks it, and the route follows the shapes.  Packed: every
    (key row, head) in exactly one unit, whose query rows are exactly those
    of its keys' windows, so each (query row, head)'s dQ comes from exactly
    one unit.  Split: the dQ kernel stores every (query row, head) once, its
    key tiles covering the keys of the row's windows (and no other window's
    where it does not mask); the dK / dV kernel stores every (key row, head)
    once, its query tiles covering the queries of the key's windows (and no
    other's without the mask), both consumers of a shared item reading the
    same tiles."""
    if name == "odd":
        lq, lk, q_rows, heads = arg
    else:
        heads, _, lk, pooled, n = kc.ATTN_BWD[name]
        lq = lk // 4 if pooled else lk
        q_rows = arg * n // (4 if pooled else 1)
    k_rows = q_rows // lq * lk
    for sms in (132, 7):
        plan = kernels.window_bwd_plan(q_rows, heads, 72, lq, lk, sms)
        m = plan.arg & 0xFFFF
        assert (m & 511, bool(m >> 9 & 1), 16 if m >> 10 & 1 else 64, bool(m >> 11 & 1),
                bool(m >> 12 & 1), bool(m >> 13 & 1), plan.arg >> 16 & 0xFFFF,
                plan.arg >> 32) == (plan.dv, plan.packed, plan.qt, plan.mask, plan.shared_kv,
                                    plan.shared_q, plan.grid_a, plan.grid_b)
        assert m < 1 << 14 and m == plan.mode and plan.grid_a <= sms and plan.grid_b <= sms
        assert plan.packed == (64 % lk == 0 and 64 // lk * lq in (16, 64))
        keys = np.zeros((k_rows, heads), np.int64)
        queries = np.zeros((q_rows, heads), np.int64)
        if plan.packed:
            assert plan.mask == (lk < 64) and plan.qt == 64 // lk * lq
            assert plan.grid_a == min(-(-plan.units // 2), sms)
            for u in range(plan.units):
                kt, h = divmod(u, heads)
                k0, q0 = kt * T, kt * T // lk * lq
                kr = np.arange(k0, min(k0 + T, k_rows))
                keys[kr, h] += 1
                qr = np.arange(q0, min(q0 + plan.qt, q_rows))
                queries[qr, h] += 1
                assert set(qr // lq) == set(kr // lk)
        else:
            assert plan.mask == (lq % 64 != 0 or lk % 64 != 0)
            for item in range(plan.items_q):
                ws = [q_decode(item, c, q_rows, heads, lq, lk, plan.shared_q) for c in (0, 1)]
                nt = max(w.ntiles for w in ws)
                assert ws[0].active and nt >= 1
                for w in ws:
                    if not w.active:
                        continue
                    rows = np.arange(w.row0, min(w.row0 + T, q_rows))
                    queries[rows, w.head] += 1
                    lo, hi = (rows // lq) * lk, (rows // lq + 1) * lk
                    assert (lo >= w.kb).all() and (hi <= w.kb + nt * T).all()
                    if not plan.mask:
                        assert (lo == w.kb).all() and (hi == w.kb + nt * T).all()
            for item in range(plan.items_kv):
                ws = [kv_decode(item, c, k_rows, heads, lq, lk) for c in (0, 1)]
                nq = max(w.nq for w in ws)
                assert ws[0].active and nq >= 1
                if plan.shared_kv:
                    assert ws[0].qb == ws[1].qb and ws[0].nq == ws[1].nq and ws[1].active
                for w in ws:
                    if not w.active:
                        continue
                    kr = np.arange(w.kr, min(w.kr + T, k_rows))
                    keys[kr, w.head] += 1
                    lo, hi = (kr // lk) * lq, (kr // lk + 1) * lq
                    assert (lo >= w.qb).all() and (hi <= w.qb + nq * T).all()
                    if not plan.mask:
                        assert (lo == w.qb).all() and (hi == w.qb + nq * T).all()
        assert (keys == 1).all() and (queries == 1).all()


@pytest.mark.parametrize("geo", ["t12", "t34", "stage3"])
def test_bwd_tmap_reads_head_columns(geo):
    """The tensor maps (kernels.window_bwd_tmap) over the operands as the
    front and the block pass them: k / v inside the front's y, whose
    shortcut columns follow (ld = 3 H d + Cout), or the T-block's qkv; the
    pooled q contiguous.  Byte strides 2 d and 2 ld, multiples of 16; head h
    reads exactly its d columns, zeros past d and past the last row, so no
    box reaches a neighbouring head or the shortcut."""
    if geo in kc.QPOOL:
        cin, cout, heads, _, _ = kc.QPOOL[geo]
        d = cout // heads
        ld = 3 * heads * d + cout
    else:
        _, c, heads, _, _ = kc.BLOCKS[geo]
        d, ld = c // heads, 3 * c
    rows = 80
    mat = torch.arange(rows * ld, dtype=torch.float32).reshape(rows, ld)
    hd = heads * d
    for rows_box in (64, 16):
        dims, strides, bx = kernels.window_bwd_tmap(rows, ld, heads, d, rows_box)
        assert dims == (d, heads, rows) and strides == (2 * d, 2 * ld)
        assert bx == (64, 1, rows_box) and all(s % 16 == 0 for s in strides)
    for col in (hd, 2 * hd):    # k and v
        for h in (0, heads - 1):
            b = box(mat, col, heads, d, h, 16, 64, 128)
            c0 = col + h * d
            np.testing.assert_array_equal(b[:, :d].numpy(), mat[16:80, c0:c0 + d].numpy())
            assert (b[:, d:] == 0).all()
    tail = box(mat, 2 * hd, heads, d, heads - 1, 48, 64, 128)
    assert (tail[32:] == 0).all()
    assert ((tail[:32, :d] == mat[48:, 3 * hd - d:3 * hd]).all())


def test_head_dims_and_cpu_tensors():
    """Every multiple of 8 up to 128 runs at the least instantiated width
    that holds it; wider heads are refused by name; the launcher takes only
    CUDA tensors (the wrappers take the plain versions for CPU tensors)."""
    for d in range(8, 129, 8):
        assert kernels.window_bwd_plan(1024, 4, d, 64, 64, 132).dv == min(
            x for x in kernels.ATTN_BWD_DV if x >= d)
    with pytest.raises(ValueError, match="attention backward"):
        kernels.window_bwd_plan(1024, 4, 136, 64, 64, 132)
    t = torch.zeros((256, 96), dtype=torch.bfloat16)
    c = kernels.Cols(t)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.attention_bwd(c, c, c, c, c, torch.zeros(256, 2), c, c, c, 2, 16, 64, 64, 0.25)
