"""The window attention kernel's algorithm and launch plan
(csrc/attention_window.cu, kernels.window_plan / window_tmap) on the CPU.

:func:`emulate` runs the kernel's dataflow in PyTorch: the work items of
:func:`work` (the kernel's ``win_decode``: shared items of 128 * mt query
rows of one window and head, or one 64-row m-tile per consumer over the
keys of the windows its rows touch), 64 x 64 boxes read through the tensor
map that :func:`kernels.window_tmap` describes (zero past the head dim, the
last head slot and the last row), 64-key tiles in the kernel's order, the
block-diagonal mask where the plan masks (key k counts for row r iff
k // Lk == r // Lq, written as the kernel's unsigned compare), the online
softmax in f32 (exp2 of the scaled score less the scaled running max; a row
whose max is still -inf keeps p and its rescale at 0), row sums of the
unrounded f32 probabilities, P rounded to bf16 for P.V, the output
normalised after P.V, and the log-sum-exp m * scale * log2 e + log2(l).
Pooled queries (the Q-pool front) are built as the kernel's pooling warps
build them (:func:`pooled_q_boxes`): the max of 4 rows per 16-byte chunk,
stored at its 128-byte-swizzle position in each consumer's Q box, the
columns past the head dim zeroed once, read back through the swizzle.

Tolerances: f32 (P not rounded) atol 2e-5 / rtol 1e-4 against the plain
version and 1e-4 against JAX's whole-block kernels in interpret mode, as
tests/test_torch_attention_tiles.py and tests/test_torch_blocks.py (f32 on
both sides, sums in other orders); the log-sum-exp within 1e-5 of the plain
scores' (log2 units, values of a few units); bf16 max|a - b| / max|b| <=
1e-2 on bf16-valued inputs (P rounded against a running max here and the
final max in the plain version, the output rounded to bf16: a few bf16 steps
of 2^-8).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blocks import TOL, _jax_t_weights, _pad_qkv_rows, _port_block, _weights

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch import kernel_check as kc
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
F32_TOL = dict(atol=2e-5, rtol=1e-4)
LSE_TOL = dict(atol=1e-5, rtol=0)
BF16_REL = 1e-2
ROWS = KT = 64   # rows of a box and of an m-tile; keys of a K/V tile
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


class Work(NamedTuple):
    head: int
    row0: int
    kb: int
    ntiles: int
    active: bool


def work(plan, item, c, q_rows, heads, lq, lk) -> Work:
    """What consumer warpgroup ``c`` computes of ``item``: the kernel's
    ``win_decode``."""
    if plan.shared:
        rows = 2 * plan.mt * ROWS
        chunks = lq // rows
        wh = item // chunks
        win = wh // heads
        return Work(wh % heads, win * lq + (item % chunks) * rows + c * plan.mt * ROWS,
                    win * lk, lk // KT, True)
    row0 = (2 * (item // heads) + c) * ROWS
    active = row0 < q_rows
    last = min(row0 + ROWS, q_rows) - 1
    kb = (row0 // lq) * lk
    nt = -(-((last // lq + 1) * lk - kb) // KT) if active else 0
    return Work(item % heads, row0, kb, nt, active)


def read_box(mat, slots, d, x, y, z, width):
    """The box at (column x, head slot y, row z) of the tensor map over
    [rows, ld] ``mat`` (kernels.window_tmap), its atoms side by side up to
    ``width`` columns: zeros past column d, the last slot and the last row."""
    rows, ld = mat.shape
    (dd, ns, nr), (s_slot, s_row), (bx, by, bz) = kernels.window_tmap(rows, ld, slots, d)
    assert (bx, by, bz) == (64, 1, ROWS) and s_slot % 16 == 0 and s_row % 16 == 0
    flat = mat.reshape(-1)
    out = torch.zeros(bz, width)
    for a in range(-(-width // bx)):
        for r in range(bz):
            for i in range(bx):
                col, row = x + a * bx + i, z + r
                if col < dd and y < ns and row < nr and a * bx + i < width:
                    out[r, a * bx + i] = flat[(row * s_row + y * s_slot) // 2 + col]
    return out


def _boxes(mat, slots, d, y, z, width):
    """A box per 64 columns is what TMA loads; rows are read in bulk here
    (read_box checks the element rule on a few boxes)."""
    rows, ld = mat.shape
    (dd, ns, nr), (s_slot, s_row), _ = kernels.window_tmap(rows, ld, slots, d)
    out = torch.zeros(ROWS, width)
    if y >= ns:
        return out
    r1 = min(z + ROWS, nr)
    if r1 > z:
        cols = y * s_slot // 2
        out[: r1 - z, : min(dd, width)] = mat[z:r1, cols:cols + min(dd, width)]
    return out


POOLERS = 96   # producer warps 1-3 of the kernel build the pooled Q boxes


def pooler_tasks(nch, pt):
    """The (consumer, row, chunk) tasks pooling thread ``pt`` takes of one
    item, in the kernel's loop order (two in flight a thread)."""
    tasks = 2 * ROWS * nch
    out = []
    for t0 in range(pt, tasks, 2 * POOLERS):
        for u in range(2):
            t = t0 + u * POOLERS
            if t < tasks:
                c, rc = divmod(t, ROWS * nch)
                out.append((c,) + divmod(rc, nch))
    return out


def pad_tasks(nch, na, qb, pt):
    """The (box, row, chunk) columns past the head dim pooling thread ``pt``
    zeroes once, over the ``qb`` Q buffers' 2 boxes of ``na`` atoms each."""
    pad = na * 8 - nch
    out = []
    for t in range(pt, qb * 2 * ROWS * pad, POOLERS):
        out.append((t // (pad * ROWS), (t // pad) % ROWS, nch + t % pad))
    return out


def swizzled(box_row, chunk):
    """The 16-byte slot of ``chunk`` in row ``box_row`` of a 64-row box in
    the 128-byte swizzle (what TMA writes and wgmma reads)."""
    return chunk ^ (box_row % 8)


def pooled_q_boxes(kv, heads, d, ws, q_rows, width):
    """The Q boxes the pooling warps build for one item's two consumers
    ``ws`` (POOL): [2][64, width] as wgmma reads them back through the
    swizzle.  Every task of every thread writes its chunk's slot, the pad
    columns are zeroed, no slot is written twice (NaN marks one never
    written)."""
    nch, na = d // 8, -(-width // 64)
    smem = torch.full((2 * na, ROWS, 8, 8), float("nan"))   # [box][row][slot][8 lanes]
    wrote = torch.zeros((2 * na, ROWS, 8), dtype=torch.int64)
    for box, r, ch in {x for pt in range(POOLERS) for x in pad_tasks(nch, na, 1, pt)}:
        smem[box * na + ch // 8, r, swizzled(r, ch % 8)] = 0.0
        wrote[box * na + ch // 8, r, swizzled(r, ch % 8)] += 1
    # All tasks at once (test_pooler_tasks_cover_each_chunk_once holds the
    # threads' loop to this set).
    c, r, ch = np.meshgrid(np.arange(2), np.arange(ROWS), np.arange(nch), indexing="ij")
    c, r, ch = (torch.from_numpy(x.reshape(-1)) for x in (c, r, ch))
    row0 = torch.tensor([w.row0 for w in ws])[c]
    head = torch.tensor([w.head for w in ws])[c]
    active = torch.tensor([w.active for w in ws])[c]
    j = row0 + r
    ok = active & (j < q_rows)
    src = kv[(4 * torch.where(ok, j, 0))[:, None] + torch.arange(4)[None, :]]   # [t, 4, ld]
    col = (head * d + ch * 8)[:, None] + torch.arange(8)[None, :]
    vals = torch.gather(src, 2, col[:, None, :].expand(-1, 4, -1)).amax(1)
    vals = torch.where(ok[:, None], vals, 0.0)
    box, slot = c * na + ch // 8, (ch % 8) ^ (r % 8)
    smem[box, r, slot] = vals
    wrote.index_put_((box, r, slot), torch.ones_like(box), accumulate=True)
    assert wrote.max() <= 1
    out = []
    for cc in range(2):
        cols = torch.arange(width)
        a, k = cols // 64, (cols % 64) // 8
        rr = torch.arange(ROWS)[:, None]
        out.append(smem[cc * na + a[None, :], rr, k[None, :] ^ (rr % 8), (cols % 8)[None, :]])
    return out


def emulate(kv, heads, d, lq, lk, scale, round_p, sms=4, mt=None, pool=False):
    """The kernel on f32 tensors: ``kv`` [k_rows, ld] (q, k, v at head slots
    h, H + h, 2H + h; ``pool``: query row j the max of q over rows 4j..4j+3);
    (out [q_rows, H * d], lse [q_rows, H])."""
    q_rows = kv.shape[0] // lk * lq
    plan = kernels.window_plan(q_rows, heads, d, lq, lk, sms, mt, pool)
    sl2 = scale * LOG2E
    out = torch.full((q_rows, heads * d), float("nan"))
    lse = torch.full((q_rows, heads), float("nan"))
    done = []
    for blk in range(plan.grid):
        for item in range(blk, plan.items, plan.grid):
            done.append(item)
            ws = [work(plan, item, c, q_rows, heads, lq, lk) for c in (0, 1)]
            nt = max(w.ntiles for w in ws)
            if plan.pool:
                qboxes = pooled_q_boxes(kv, heads, d, ws, q_rows, plan.dv)
            for c, wk in enumerate(ws):
                src = ws[0] if plan.shared else wk   # the slot this consumer reads
                tiles = [(_boxes(kv, 3 * heads, d, heads + src.head, src.kb + j * KT, plan.dv),
                          _boxes(kv, 3 * heads, d, 2 * heads + src.head, src.kb + j * KT,
                                 plan.dv)) for j in range(nt)]
                for i in range(plan.mt):
                    r0 = wk.row0 + i * ROWS
                    qb = (qboxes[c] if plan.pool
                          else _boxes(kv, 3 * heads, d, wk.head, r0, plan.dv))
                    rows = torch.arange(r0, r0 + ROWS)
                    lo = (rows // lq) * lk - wk.kb
                    m = torch.full((ROWS,), float("-inf"))
                    lsum, acc = torch.zeros(ROWS), torch.zeros(ROWS, plan.dv)
                    for j, (kb_, vb_) in enumerate(tiles):
                        s = qb @ kb_.T
                        if plan.mask:   # (unsigned)(col - (lo - 64 j)) < lk
                            col = torch.arange(KT)[None, :]
                            off = col - (lo - j * KT)[:, None]
                            s = torch.where((off >= 0) & (off < lk), s, float("-inf"))
                        mn = torch.maximum(m, s.max(1).values)
                        u = torch.where(mn == float("-inf"), 0.0, mn) if plan.mask else mn
                        al = torch.exp2((m - u) * sl2)
                        p = torch.exp2(s * sl2 - (u * sl2)[:, None])
                        m = mn
                        lsum = lsum * al + p.sum(1)
                        pr = p.to(torch.bfloat16).float() if round_p else p
                        acc = acc * al[:, None] + pr @ vb_
                    if not wk.active:
                        continue
                    keep = rows < q_rows
                    inv = torch.where(lsum > 0, 1.0 / lsum, 0.0)
                    o = acc * inv[:, None]
                    if round_p:
                        o = o.to(torch.bfloat16).float()
                    out[rows[keep], wk.head * d:(wk.head + 1) * d] = o[keep, :d]
                    lse[rows[keep], wk.head] = (m * sl2 + torch.log2(lsum))[keep]
    assert sorted(done) == list(range(plan.items))
    return out, lse


def _pool(qkv, heads, d):
    """q max-pooled over each 4 rows."""
    return qkv[:, :heads * d].reshape(-1, 4, heads * d).amax(1)


def _emulate_call(qkv, heads, d, lk, pooled, scale, round_p, mt=None):
    return emulate(qkv, heads, d, lk // 4 if pooled else lk, lk, scale, round_p, mt=mt,
                   pool=pooled)


def _plain(qkv, heads, d, lk, pooled, scale):
    """The plain version and its log-sum-exp (kernel_check.window_plain)."""
    name = next(n for n, g in kc.WINDOW.items() if g[3] == pooled)
    return kc.window_plain(name, qkv, heads, d, lk, scale)


# (key window Lk, pooled, heads, head dim, key rows, m-tiles per consumer)
CASES = [
    (16, False, 2, 16, 256, None),    # packed windows, 4 per m-tile, masked
    (64, False, 2, 16, 256, None),    # one window per m-tile, no mask
    (256, False, 2, 16, 512, 2),      # shared items, two m-tiles per consumer
    (256, False, 2, 16, 512, 1),      # shared items, one m-tile per consumer
    (1024, False, 1, 8, 2048, None),  # shared, several items per window
    (48, False, 2, 8, 240, None),     # windows across m-tiles, a partial last m-tile
    (16, True, 2, 16, 256, None),     # pooled Lq 4 / Lk 16: 16 windows per m-tile
    (64, True, 2, 16, 512, None),     # pooled Lq 16 / Lk 64 (t12)
    (256, True, 2, 16, 512, None),    # pooled Lq 64 / Lk 256: 4 full key tiles, no mask
    (80, True, 1, 8, 320, None),      # pooled Lq 20, masked, partial m-tile
    (64, False, 1, 136, 128, None),   # head dim 136: P.V width 144, three column atoms
    (16, True, 1, 256, 128, None),    # head dim 256, four atoms, pooled and masked
]


@pytest.mark.parametrize("lk,pooled,heads,d,rows,mt", CASES)
def test_emulated_window_matches_plain(lk, pooled, heads, d, rows, mt):
    """The emulation against the plain version in f32 (P not rounded) and in
    bf16, and its log-sum-exp against the plain scores'."""
    g = torch.Generator().manual_seed(lk + d)
    cols = 3 * heads * d + (16 if pooled else 0)   # the front's shortcut columns follow
    qkv = torch.randn((rows, cols), generator=g)
    scale = d ** -0.5
    got, lse = _emulate_call(qkv, heads, d, lk, pooled, scale, round_p=False, mt=mt)
    want, want_lse = _plain(qkv, heads, d, lk, pooled, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **LSE_TOL)
    qb = qkv.to(torch.bfloat16).float()
    got, _ = _emulate_call(qb, heads, d, lk, pooled, scale, round_p=True, mt=mt)
    want, _ = _plain(qb.to(torch.bfloat16), heads, d, lk, pooled, scale)
    err = (got - want.float()).abs().max() / want.float().abs().max()
    assert err <= BF16_REL, err


@pytest.mark.parametrize("l", [16, 64, 256])
def test_emulated_block_matches_jax_kernel(rng, monkeypatch, l):
    """block_plain with the emulation in place of its window attention
    against JAX's T-block ``_kernel`` (fused_block_t.py:349) in interpret
    mode."""
    c, heads, d, n = 32, 2, 16, 256
    calls = []

    def attend(qkv, heads_, l_, scale):
        b, nn, f = qkv.shape
        calls.append(l_)
        o, _ = emulate(qkv.reshape(b * nn, f), heads_, f // (3 * heads_), l_, l_, scale,
                       round_p=False)
        return o.reshape(b, nn, -1)

    monkeypatch.setattr(tfbt, "_window_attention_plain", attend)
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    got = tfbt.block_plain(torch.from_numpy(x), _port_block(w), heads, l, d ** -0.5, 1e-6,
                           approx_gelu=False).numpy()
    assert calls == [l]
    jw, hp = _jax_t_weights(w, heads, d)
    kw = dict(heads=heads, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=False)
    ker = np.asarray(jfbt._forward(jnp.asarray(x.transpose(0, 2, 1)), jw, hp=hp,
                                   interpret=True, **kw)).transpose(0, 2, 1)
    np.testing.assert_allclose(got, ker, **TOL)


@pytest.mark.parametrize("l", [16, 64, 256])
def test_emulated_qpool_matches_jax_kernel(rng, monkeypatch, l):
    """The front's plain version with the emulation (on the pooled q) in
    place of its attention against JAX's ``_qpool_kernel``
    (fused_block_t.py:634) in interpret mode."""
    cin, cout, heads, d, n = 16, 32, 2, 16, 1024
    orig = tfbt._qpool_attend

    def attend(qkv, sc, heads_, l_, scale):
        b, nn, f = qkv.shape
        flat = qkv.reshape(b * nn, f)
        o, _ = _emulate_call(flat, heads_, f // (3 * heads_), l_, True, scale, round_p=False)
        return o.reshape(b, nn // 4, -1), orig(qkv, sc, heads_, l_, scale)[1]

    monkeypatch.setattr(tfbt, "_qpool_attend", attend)
    w = _weights(rng, cin, heads, d, cout=cout)
    x = rng.standard_normal((2, n, cin)).astype(np.float32)
    wts = tfbt.QPoolWeights(*[torch.from_numpy(w[k]) for k in (
        "ln1_w", "ln1_b", "wqkv", "bqkv", "wsc", "bsc")])
    o, sc = tfbt.qpool_front_plain(torch.from_numpy(x), wts, heads, l, d ** -0.5)
    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    jw = jfbt.QPoolWeights(col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
                           jnp.asarray(w["wsc"]), col(w["bsc"]))
    jo, jsc = jfbt._qpool_forward(jnp.asarray(x.transpose(0, 2, 1)), jw, interpret=True,
                                  heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6)
    jo = np.asarray(jo).reshape(2, heads, hp, n // 4)[:, :, :d]
    np.testing.assert_allclose(o.numpy(), jo.reshape(2, heads * d, n // 4).transpose(0, 2, 1),
                               **TOL)
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc).transpose(0, 2, 1), **TOL)


# Every WINDOW geometry at batch 1 and 8 (Hiera-L's fronts included), and
# geometries whose windows straddle m-tiles or end in a partial one.
PLAN_CASES = ([(n, b) for n in kc.WINDOW for b in (1, 8)]
              + [("odd", (48, 48, 240, 3)), ("odd", (20, 80, 80, 2)), ("odd", (128, 128, 384, 5)),
                 ("odd", (4, 16, 4, 1))])


@pytest.mark.parametrize("name,arg", PLAN_CASES)
def test_plan_covers_every_row_once(name, arg):
    """kernels.window_plan: its C argument unpacks to its fields as the C
    entry unpacks it; every (query row, head) is stored by exactly one
    active consumer of one item, the keys of its window all lie in the tiles
    its consumer reads, a tile without the mask holds no other window's key,
    and both consumers of a shared item read the same tiles."""
    if name == "odd":
        lq, lk, q_rows, heads = arg
        pooled = lk == 4 * lq
    else:
        heads, _, lk, pooled, n = kc.WINDOW[name]
        lq = lk // 4 if pooled else lk
        q_rows = arg * n // (4 if pooled else 1)
    for sms in (132, 7):
        plan = kernels.window_plan(q_rows, heads, 72, lq, lk, sms, pool=pooled)
        m, grid, items = plan.arg & 0xFFFF, plan.arg >> 16 & 0xFFFF, plan.arg >> 32
        assert (m & 511, bool(m >> 9 & 1), (m >> 10 & 1) + 1, bool(m >> 11 & 1),
                bool(m >> 12 & 1), grid, items) == (plan.dv, plan.shared, plan.mt, plan.mask,
                                                    pooled, plan.grid, plan.items)
        assert not (plan.shared and plan.pool) and m < 1 << 13 and m == plan.mode
        seen = np.zeros((q_rows, heads), np.int64)
        items = sorted(i for b in range(plan.grid) for i in range(b, plan.items, plan.grid))
        assert items == list(range(plan.items)) and plan.grid <= sms
        for item in range(plan.items):
            ws = [work(plan, item, c, q_rows, heads, lq, lk) for c in (0, 1)]
            nt = max(w.ntiles for w in ws)
            assert nt >= 1 and ws[0].active
            if plan.shared:
                assert ws[0].kb == ws[1].kb and ws[0].head == ws[1].head
            for w in ws:
                if not w.active:
                    continue
                rows = np.arange(w.row0, min(w.row0 + plan.mt * ROWS, q_rows))
                seen[rows, w.head] += 1
                lo, hi = (rows // lq) * lk, (rows // lq + 1) * lk
                assert (lo >= w.kb).all() and (hi <= w.kb + nt * KT).all()
                if not plan.mask:
                    assert (lo == w.kb).all() and (hi == w.kb + nt * KT).all()
        assert (seen == 1).all()


@pytest.mark.parametrize("geo", ["t12", "t23", "t34", "stage3"])
def test_window_tmap_reads_head_columns(geo):
    """The flat tensor map (kernels.window_tmap) over the front's y, whose
    shortcut columns follow q / k / v (ld = 3 H d + Cout), and the T-block's
    qkv (ld = 3 H d): byte strides 2 d and 2 ld, multiples of 16; head slot
    h, H + h and 2H + h read exactly q, k and v of head h; columns past d,
    slots past the last and rows past the last read zeros, so no box
    reaches a neighbouring head or the shortcut.  The front's pooled Q
    boxes (the pooling warps' loads from y) read q of their head only: the
    max of its 4 rows, zeros past d and past the last pooled row."""
    if geo in kc.QPOOL:
        cin, cout, heads, _, _ = kc.QPOOL[geo]
        d = cout // heads
        ld = 3 * heads * d + cout
    else:
        _, c, heads, _, _ = kc.BLOCKS[geo]
        d, ld = c // heads, 3 * c
    rows = 80
    mat = torch.arange(rows * ld, dtype=torch.float32).reshape(rows, ld)
    dims, strides, box = kernels.window_tmap(rows, ld, 3 * heads, d)
    assert dims == (d, 3 * heads, rows) and strides == (2 * d, 2 * ld) and box == (64, 1, 64)
    assert all(s % 16 == 0 for s in strides) and 3 * heads * d <= ld
    for kind in range(3):
        for h in (0, heads - 1):
            b = read_box(mat, 3 * heads, d, 0, kind * heads + h, 16, 128)
            col0 = (kind * heads + h) * d
            np.testing.assert_array_equal(b[:, :d].numpy(), mat[16:80, col0:col0 + d].numpy())
            assert (b[:, d:] == 0).all()
    assert (read_box(mat, 3 * heads, d, 0, 3 * heads, 0, 64) == 0).all()
    tail = read_box(mat, 3 * heads, d, 0, 0, 48, 128)
    assert (tail[32:] == 0).all() and (tail[:32, :d] == mat[48:, :d]).all()
    q = _pool(mat, heads, d)
    ws = [Work(heads - 1, 0, 0, 1, True), Work(0, 64, 0, 1, False)]
    b = pooled_q_boxes(mat, heads, d, ws, rows // 4, 128)
    np.testing.assert_array_equal(b[0][:rows // 4, :d].numpy(),
                                  q[:, (heads - 1) * d:heads * d].numpy())
    assert (b[0][rows // 4:] == 0).all() and (b[0][:, d:] == 0).all() and (b[1] == 0).all()


@pytest.mark.parametrize("d", [8, 16, 72, 136, 256])
@pytest.mark.parametrize("qb", [1, 2])
def test_pooler_tasks_cover_each_chunk_once(d, qb):
    """The pooling warps' loops (POOL): over the 96 threads, each (consumer,
    row, chunk below d / 8) of an item once, and each chunk from d / 8 up to
    the box atoms' end of every Q box of ``qb`` buffers zeroed once; the
    two sets are disjoint and fill every 16-byte slot of the boxes, each at
    its own swizzled slot."""
    nch, na = d // 8, -(-d // 64)
    got = [x for pt in range(POOLERS) for x in pooler_tasks(nch, pt)]
    assert sorted(got) == [(c, r, ch) for c in range(2) for r in range(ROWS)
                           for ch in range(nch)]
    pads = [x for pt in range(POOLERS) for x in pad_tasks(nch, na, qb, pt)]
    assert sorted(pads) == [(box, r, ch) for box in range(2 * qb) for r in range(ROWS)
                            for ch in range(nch, na * 8)]
    slots = {(c * na + ch // 8, r, swizzled(r, ch % 8)) for c, r, ch in got}
    slots |= {(box * na + ch // 8, r, swizzled(r, ch % 8)) for box, r, ch in pads if box < 2}
    assert len(slots) == len(got) + len(pads) // qb == 2 * na * ROWS * 8


def test_head_dims_and_cpu_tensors():
    """Every multiple of 8 up to kernels.MAX_HEAD_DIM runs at the least
    instantiated P.V width that holds it; the launchers take only CUDA
    tensors (a CPU tensor raises: the wrappers take the plain versions for
    those)."""
    for d in range(8, kernels.MAX_HEAD_DIM + 1, 8):
        dv = kernels.window_plan(1024, 4, d, 64, 64, 132).dv
        assert dv == min(x for x in kernels.ATTN_DV if x >= d)
    qkv = torch.zeros((256, 3 * 2 * 16), dtype=torch.bfloat16)
    for fn in (kernels.window_attention, kernels.qpool_attention):
        with pytest.raises(ValueError, match="CUDA"):
            fn(qkv, 2, 16, 64, 0.25)
