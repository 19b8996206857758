"""The bf16 attention kernel's algorithm and launch plan (csrc/attention_lanes.cu,
kernels.attention_plan) on the CPU.

:func:`emulate` runs the kernel's dataflow in PyTorch: the work items and the
64-row boxes the producer loads (:func:`attention_work` and
:func:`attention_loads`, the kernel's decode and producer in Python,
zero-filled past L and past the head dim up to the P.V width), 64-row
m-tiles of queries, key tiles of 64 (the last, partial one first, its keys
past L masked), the online softmax in f32
(exp2 of the scaled score less the scaled running max, the accumulator and
the row sums rescaled at each new max), row sums of the unrounded f32
probabilities, P rounded to bf16 for P.V (in bf16), and the [rows, D] output
normalised after P.V.  It is held against JAX's ``fused_attention_lanes`` and
``fused_attention`` with Pallas in interpret mode, as
tests/test_torch_attention.py runs them, and against the port's plain
version ``lanes_plain``.  Tolerances: f32 atol 2e-5 / rtol 1e-4, as
tests/test_torch_attention.py (f32 on both sides, sums in other orders); bf16
max|a - b| / max|b| <= 1e-2 on bf16-valued inputs (P rounded to bf16 against
a running max here and against the final max in JAX, and the output rounded
to bf16: a few bf16 steps of 2^-8 of the largest output).

The f32 kernel (csrc/attention_f32.cu ``attention_tf32_kernel``, head dims
up to 80) has its own dataflow, :func:`emulate_f32`: the work items and
boxes of :func:`f32_work` / :func:`f32_loads` (windows of L dividing 32
packed 64 / L to an m-tile), 32-key tiles, the last first, the 3xTF32 split
of every operand bit for bit (``cvt.rna.tf32.f32``: round to nearest, ties
away from zero, at bit 13 of the f32 pattern, the low 13 bits cleared; small
= the rest, split the same way), S = Qs K + Q Ks + Q K of the tf32 parts
(exact products, summed in f64 and rounded to f32 once, as a fresh
accumulator per tile), the mask as a select on every score (block-diagonal
for packed windows), the online softmax in f32 with exp2, V read transposed
([D, keys] with each 8 keys permuted, P's columns in the same order), each
tile's P.V in a fresh accumulator added to O * alpha in f32.  The existing
emulation test's f32 cases run it wherever the plan takes the head dim, at
the same tolerance; above 80 the mma.sync kernel, whose algorithm the generic
emulation stands for, runs.

The plan itself: every (problem, head, query row) is computed by exactly one
consumer of one item and loaded by exactly one Q box, every key of a
problem reaches its consumers exactly once per item, the persistent blocks
walk every item once, and the tensor maps' byte strides are multiples of 16;
the same for the f32 plan (kernels.attention_f32_plan), packed windows
included.
The shape rule of the launcher (kernels.attention_head_dim) accepts every
head dim the gates admit up to kernels.MAX_HEAD_DIM and refuses wider ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.ops import pallas_attention as jpa
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import pallas_attention as tpa

torch.set_num_threads(1)
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_REL = 1e-2
LENGTHS = (1, 16, 20, 64, 65, 100, 256, 300, 484)
HEAD_DIMS = (4, 16, 72, 80, 96)
KT = ROWS = 64   # keys per K/V tile; rows per box and per m-tile


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpa.pl, "pallas_call", interp)
    yield


def attention_work(plan, item, c, problems, heads, l):
    """(problem, head, first query row, active) of consumer warpgroup ``c``
    on ``item``, its rows [row0, row0 + 64 * mt): the kernel's ``decode``."""
    if plan.solo:
        i = 2 * item + c
        return i // heads, i % heads, 0, i < problems * heads
    rows = 2 * plan.mt * ROWS
    nqt = -(-l // rows)
    ph = item // nqt
    row0 = (item % nqt) * rows + c * plan.mt * ROWS
    return ph // heads, ph % heads, row0, row0 < l


def attention_loads(plan, item, problems, heads, l):
    """The 64-row boxes the kernel's producer loads for ``item`` (the column
    atoms of a row aside), as (operand, consumer m-tile or key slot, head,
    first row, problem): "q" for each consumer's m-tiles, then "kv" for each
    64-key tile, the last (partial) one first (SOLO: one slot per
    consumer).  A box past row L or past the last problem reads as zeros."""
    w = [attention_work(plan, item, c, problems, heads, l) for c in (0, 1)]
    loads = [("q", c * plan.mt + i, hd, r0 + i * ROWS, pb)
             for c, (pb, hd, r0, _) in enumerate(w) for i in range(plan.mt)]
    if plan.solo:
        return loads + [("kv", c, hd, 0, pb) for c, (pb, hd, _, _) in enumerate(w)]
    pb, hd = w[0][0], w[0][1]
    nt = -(-l // KT)
    return loads + [("kv", 0, hd, (nt - 1 - j) * KT, pb) for j in range(nt)]


def _box(t, head, row0, prob, width):
    """A 64-row box of t [P, L, H, D] at (prob, row0, head), zero past L,
    past the last problem and past D up to ``width`` columns."""
    b = torch.zeros(ROWS, width)
    if prob < t.shape[0]:
        rows = t[prob, row0:row0 + ROWS, head]
        b[: rows.shape[0], : rows.shape[1]] = rows
    return b


def emulate(q, k, v, scale, bf16, sms=4):
    """The kernel's algorithm on [P, L, H, D] f32 tensors (bf16-valued when
    ``bf16``); ``sms`` persistent blocks."""
    p, l, h, d = q.shape
    dp = kernels.attention_head_dim(d, torch.bfloat16)
    plan = kernels.attention_plan(p, h, l, dp, sms)
    sl2 = scale * 1.4426950408889634
    out = torch.full((p, l, h, dp), float("nan"))
    for blk in range(plan.grid):
        for item in range(blk, plan.items, plan.grid):
            loads = attention_loads(plan, item, p, h, l)
            qb = {i: _box(q, hd, r0, pb, plan.dv) for op, i, hd, r0, pb in loads if op == "q"}
            kv = [(sl, r0, _box(k, hd, r0, pb, plan.dv), _box(v, hd, r0, pb, plan.dv))
                  for op, sl, hd, r0, pb in loads if op == "kv"]
            for c in (0, 1):
                pb, hd, row0, active = attention_work(plan, item, c, p, h, l)
                # (K, V, keys of the problem) of each tile this consumer reads
                tiles = [(kb, vb, l if plan.solo else min(KT, l - r0))
                         for sl, r0, kb, vb in kv if not plan.solo or sl == c]
                for i in range(plan.mt):
                    m = torch.full((ROWS,), float("-inf"))
                    lsum, acc = torch.zeros(ROWS), torch.zeros(ROWS, plan.dv)
                    for kt, vt, nk in tiles:
                        s = qb[c * plan.mt + i] @ kt.T
                        s[:, torch.arange(KT) >= nk] = float("-inf")
                        mn = torch.maximum(m, s.max(1).values)
                        alpha = torch.exp2((m - mn) * sl2)
                        pr = torch.exp2(s * sl2 - (mn * sl2)[:, None])
                        lsum = lsum * alpha + pr.sum(1)
                        if bf16:
                            pr = pr.to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + pr @ vt
                        m = mn
                    r = row0 + i * ROWS
                    n = min(ROWS, l - r)
                    if not active or n <= 0:
                        continue
                    assert torch.isnan(out[pb, r:r + n, hd]).all(), "row computed twice"
                    out[pb, r:r + n, hd] = (acc / lsum[:, None])[:n, :dp]
    assert not torch.isnan(out).any(), "a row was not computed"
    out = out[..., :d]
    return out.to(torch.bfloat16).float() if bf16 else out


TF_KT = 32   # keys per K / V tile of the f32 kernel
# V^T position p of each 8 keys holds key KEY_OF_POS[p]: the score fragment of
# keys 2t, 2t + 1 is P's A fragment of columns t, t + 4.
KEY_OF_POS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32_split(x):
    """(big, small) of the kernel's 3xTF32 split of an f32 tensor, bit for
    bit: big = cvt.rna.tf32.f32(x) with the low 13 bits cleared (round half
    away from zero on the magnitude), small = the same of x - big."""
    def rna(t):
        bits = t.contiguous().numpy().view(np.uint32).astype(np.uint64)
        return torch.from_numpy(((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32))

    big = rna(x.float())
    return big, rna(x.float() - big)


def mm3(a, b):
    """a @ b.T in 3xTF32 as the kernel's wgmma runs it: small_a big_b +
    big_a small_b + big_a big_b, the tf32 products exact, summed in f64 and
    rounded to f32 once (a fresh accumulator)."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    d = lambda x: x.double()
    return (d(as_) @ d(bb).T + d(ab) @ d(bs).T + d(ab) @ d(bb).T).float()


def f32_work(plan, item, c, problems, heads, l):
    """(first problem, head, first query row, active) of consumer ``c`` on
    ``item``: the f32 kernel's ``tf_decode``."""
    if plan.solo:
        i = 2 * item + c
        groups = -(-problems // plan.pb)
        return (i // heads) * plan.pb, i % heads, 0, i < groups * heads
    nqt = -(-l // (2 * ROWS))
    ph = item // nqt
    row0 = (item % nqt) * 2 * ROWS + c * ROWS
    return ph // heads, ph % heads, row0, row0 < l


def f32_loads(plan, item, problems, heads, l):
    """The boxes the f32 kernel's producer loads for ``item``, in order:
    ("q", consumer, head, first row, first problem, rows, problems) for both
    consumers, then ("kv", owner, key tile, head, first row, first problem,
    rows, problems) per stage, the last key tile first (owner None: both
    consumers read it; solo: consumer 0's and 1's tiles in turn).  Packed
    windows: boxes of L rows x 64 / L (Q) or 32 / L (K / V) problems."""
    w = [f32_work(plan, item, c, problems, heads, l) for c in (0, 1)]
    nt, packed = plan.key_tiles(l), plan.lg >= 0
    qr, qp = (l, ROWS // l) if packed else (ROWS, 1)
    kr, kp = (l, TF_KT // l) if packed else (TF_KT, 1)
    loads = [("q", c, hd, r0, pb, qr, qp) for c, (pb, hd, r0, _) in enumerate(w)]
    for x in range(2 * nt if plan.solo else nt):
        owner = x & 1 if plan.solo else None
        kt = nt - 1 - (x // 2 if plan.solo else x)
        pb, hd = w[owner or 0][0], w[owner or 0][1]
        row, prob = (0, pb + kt * (TF_KT // l)) if packed else (kt * TF_KT, pb)
        loads.append(("kv", owner, kt, hd, row, prob, kr, kp))
    return loads


def _box_f32(t, head, row0, prob, rows, probs, width):
    """A box of ``probs`` problems x ``rows`` rows of t [P, L, H, D] at
    (prob, row0, head), flattened to [probs * rows, width], zero past L, the
    last problem and D."""
    b = torch.zeros(probs, rows, width)
    for i in range(probs):
        if prob + i < t.shape[0]:
            r = t[prob + i, row0:row0 + rows, head]
            b[i, : r.shape[0], : r.shape[1]] = r
    return b.reshape(probs * rows, width)


def emulate_f32(q, k, v, scale, sms=4):
    """The f32 kernel's algorithm on [P, L, H, D] f32 tensors (see the module
    docstring); ``sms`` persistent blocks."""
    p, l, h, d = q.shape
    dp = kernels.attention_head_dim(d, torch.float32)
    plan = kernels.attention_f32_plan(p, h, l, dp, sms)
    dv, packed = plan.dv, plan.lg >= 0
    sl2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    rows = torch.arange(ROWS)
    out = torch.full((p, l, h, dp), float("nan"))
    for blk in range(plan.grid):
        for item in range(blk, plan.items, plan.grid):
            loads = f32_loads(plan, item, p, h, l)
            qb = {c: _box_f32(q, *x, dv) for op, c, *x in loads if op == "q"}
            kv = [(owner, kt, _box_f32(k, *x, dv), _box_f32(v, *x, dv))
                  for op, owner, kt, *x in loads if op == "kv"]
            for c in (0, 1):
                pb, hd, row0, active = f32_work(plan, item, c, p, h, l)
                m = torch.full((ROWS,), float("-inf"))
                lsum, acc = torch.zeros(ROWS), torch.zeros(ROWS, dv)
                for owner, kt, kt_, vt in kv:
                    if owner not in (None, c):
                        continue
                    s = mm3(qb[c], kt_)
                    kg = kt * TF_KT + torch.arange(TF_KT)
                    valid = ((kg[None] >> plan.lg) == (rows[:, None] >> plan.lg) if packed
                             else (kg < l)[None].expand(ROWS, TF_KT))
                    s = torch.where(valid, s * sl2, torch.tensor(float("-inf")))
                    mn = torch.maximum(m, s.max(1).values)
                    base = torch.where(mn == float("-inf"), torch.zeros(()), mn)
                    alpha = torch.exp2(m - base)
                    pr = torch.exp2(s - base[:, None])
                    lsum = lsum * alpha + pr.sum(1)
                    pos = (torch.arange(TF_KT) // 8) * 8 + KEY_OF_POS.repeat(TF_KT // 8)
                    vt_t = vt.T[:, pos]                     # V^T [dv, 32], keys permuted
                    acc = acc * alpha[:, None] + mm3(pr[:, pos], vt_t)
                    m = mn
                if not active:
                    continue
                o = (acc / lsum[:, None])[:, :dp]
                if packed:
                    for r in range(ROWS):
                        pi, qi = pb + (r >> plan.lg), r & (l - 1)
                        if pi < p:
                            assert torch.isnan(out[pi, qi, hd]).all(), "row computed twice"
                            out[pi, qi, hd] = o[r]
                else:
                    n = min(ROWS, l - row0)
                    assert torch.isnan(out[pb, row0:row0 + n, hd]).all(), "row computed twice"
                    out[pb, row0:row0 + n, hd] = o[:n]
    assert not torch.isnan(out).any(), "a row was not computed"
    return out[..., :d]


def _inputs(rng, l, d, heads=2, problems=2, bf16=False):
    qkv = rng.standard_normal((problems, l, 3 * heads * d)).astype(np.float32)
    if bf16:
        qkv = np.asarray(torch.from_numpy(qkv).to(torch.bfloat16).float())
    return qkv


def _pad_heads(qkv, heads, d, hp=128):
    b, l, _ = qkv.shape
    t = qkv.reshape(b, l, 3, heads, d)
    return np.pad(t, ((0, 0), (0, 0), (0, 0), (0, 0), (0, hp - d))).reshape(b, l, -1)


def _strip_heads(o, heads, d):
    b, l, _ = o.shape
    return o.reshape(b, l, heads, -1)[..., :d].reshape(b, l, heads * d)


def _check(got, want, bf16):
    if bf16:
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel <= BF16_REL, rel
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("l", LENGTHS)
def test_emulation_matches_jax_and_plain(rng, l, d, dtype):
    """bf16: the bf16 kernel's algorithm.  f32: the f32 kernel's
    (:func:`emulate_f32`) on 5 problems (partial groups of packed windows,
    an idle consumer) where kernels.attention_f32_plan takes the head dim,
    else the generic algorithm in f32 (the mma.sync kernel's)."""
    bf16 = dtype == "bf16"
    heads = 2
    tf32 = not bf16 and kernels.attention_f32_plan(5, heads, l, d, 4) is not None
    qkv = _inputs(rng, l, d, heads, problems=5 if tf32 else 2, bf16=bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    q, k, v = (t.float() for t in tpa.split_qkv(torch.from_numpy(qkv), heads))
    em = emulate_f32(q, k, v, d ** -0.5) if tf32 else emulate(q, k, v, d ** -0.5, bf16)
    got = em.reshape(qkv.shape[0], l, -1).numpy()
    plain = tpa.lanes_plain(torch.from_numpy(qkv).to(torch.bfloat16 if bf16 else torch.float32),
                            heads, d ** -0.5).float().numpy()
    _check(got, plain, bf16)
    if d <= 128:   # JAX's lanes layout pads each head to 128 lanes
        want = jpa.fused_attention_lanes(jnp.asarray(_pad_heads(qkv, heads, d), jdt), heads,
                                         d ** -0.5)
        _check(got, _strip_heads(np.asarray(want, np.float32), heads, d), bf16)
    want = jpa.fused_attention(*(jnp.asarray(t.numpy(), jdt) for t in (q, k, v)))
    _check(got, np.asarray(want, np.float32).reshape(got.shape), bf16)


@pytest.mark.parametrize("p,h,l,d,mt", [(2, 2, 1, 72, None), (3, 3, 20, 72, None),
                                        (5, 1, 64, 72, None), (4, 2, 65, 72, 2),
                                        (3, 2, 127, 72, 1), (2, 3, 129, 72, 2),
                                        (2, 2, 300, 136, None), (300, 3, 100, 72, None),
                                        (2, 8, 2304, 72, None), (8, 8, 1024, 72, None)])
def test_plan_covers_each_row_once(p, h, l, d, mt):
    """Each (problem, head, row) once, with the plan's own m-tile count
    (None) or a given one."""
    plan = kernels.attention_plan(p, h, l, d, 132, mt=mt)
    assert plan.solo == (l <= ROWS) and plan.grid == min(plan.items, 132)
    if mt is None:
        rounds = [-(-kernels.attention_plan(p, h, l, d, 132, mt=m).items // 132)
                  for m in ((1, 2) if not plan.solo and plan.dv <= 80 else (1,))]
        assert plan.mt == (2 if len(rounds) == 2 and 1.8 * rounds[1] < rounds[0] else 1)
    walked = sorted(i for b in range(plan.grid) for i in range(b, plan.items, plan.grid))
    assert walked == list(range(plan.items))
    computed = np.zeros((p, h, l), int)
    loaded = np.zeros((p, h, l), int)
    for item in range(plan.items):
        loads = attention_loads(plan, item, p, h, l)
        assert len([x for x in loads if x[0] == "q"]) == 2 * plan.mt
        keys = {}
        for op, sl, hd, r0, pb in loads:
            rows = slice(r0, min(r0 + ROWS, l))
            if pb >= p:   # an idle consumer's box, past the last problem
                continue
            if op == "q":
                loaded[pb, hd, rows] += 1
            else:
                keys.setdefault((sl if plan.solo else 0, pb, hd), np.zeros(l, int))[rows] += 1
        for c in (0, 1):
            pb, hd, r0, active = attention_work(plan, item, c, p, h, l)
            if active:
                computed[pb, hd, r0:min(r0 + plan.mt * ROWS, l)] += 1
                assert (keys[c if plan.solo else 0, pb, hd] == 1).all(), (item, c)
    assert (computed == 1).all() and (loaded == 1).all()
    if p == 300:   # a persistent grid: more items than blocks
        assert plan.items > plan.grid


@pytest.mark.parametrize("p,h,l,d", [(2, 2, 1, 72), (5, 1, 2, 4), (5, 3, 16, 72),
                                     (4, 2, 32, 80), (5, 3, 20, 72), (3, 2, 64, 16),
                                     (2, 3, 65, 72), (2, 2, 300, 48), (300, 3, 100, 72),
                                     (2, 8, 4096, 72), (2049, 4, 16, 72)])
def test_f32_plan_covers_each_row_once(p, h, l, d):
    """The f32 kernel's plan (kernels.attention_f32_plan): each (problem,
    head, row) computed by one consumer of one item and loaded by one Q box,
    each key of a row's problem reaching that consumer once per item (its
    own window's keys when windows are packed), the persistent blocks
    walking each item once; head dims above 80 go to the mma.sync kernel."""
    plan = kernels.attention_f32_plan(p, h, l, d, 132)
    assert plan.solo == (l <= ROWS) and plan.grid == min(plan.items, 132)
    assert plan.lg == (l.bit_length() - 1 if l <= TF_KT and TF_KT % l == 0 else -1)
    assert plan.dv == min(x for x in kernels.ATTN_F32_DV if x >= d)
    walked = sorted(i for b in range(plan.grid) for i in range(b, plan.items, plan.grid))
    assert walked == list(range(plan.items))
    computed, loaded = np.zeros((p, h, l), int), np.zeros((p, h, l), int)
    for item in range(plan.items):
        loads = f32_loads(plan, item, p, h, l)
        for op, c, hd, r0, pb, rows, probs in (x for x in loads if x[0] == "q"):
            for i in range(probs):
                if pb + i < p and r0 < l and f32_work(plan, item, c, p, h, l)[3]:
                    loaded[pb + i, hd, r0:min(r0 + rows, l)] += 1
        kv = [x for x in loads if x[0] == "kv"]
        assert len(kv) == plan.key_tiles(l) * (2 if plan.solo else 1)
        for c in (0, 1):
            pb, hd, row0, active = f32_work(plan, item, c, p, h, l)
            if not active:
                continue
            # keys (problem, token) this consumer reads, with their tile slot
            keys = np.zeros((p, l), int)
            for _, owner, kt, khd, krow, kprob, rows, probs in kv:
                if owner not in (None, c):
                    continue
                assert khd == hd
                for i in range(probs):
                    if kprob + i < p:
                        keys[kprob + i, krow:min(krow + rows, l)] += 1
            if plan.lg >= 0:
                mine = range(pb, min(pb + plan.pb, p))
                computed[list(mine), hd, :] += 1
                assert (keys[list(mine)] == 1).all() and keys.sum() == len(mine) * l
            else:
                computed[pb, hd, row0:min(row0 + ROWS, l)] += 1
                assert (keys[pb] == 1).all() and keys.sum() == l
    assert (computed == 1).all() and (loaded == 1).all()
    for dw in (84, 128, 256):
        assert kernels.attention_f32_plan(p, h, l, dw, 132) is None


@pytest.mark.parametrize("layout", ("packed", "separate", "transposed", "single"))
def test_tensor_map_strides(layout):
    """The strides the tensor maps are built from (dims D, H, L, P): the
    view's own, in elements, where its dim is longer than 1, one 16-byte
    vector where it is 1; each a multiple of 16 bytes, as TMA needs."""
    p, l, h, d = (1, 5, 3, 24) if layout == "single" else (4, 20, 3, 24)
    base = torch.zeros((p, l, 3 * h * d), dtype=torch.bfloat16)
    if layout in ("packed", "single"):
        t = tpa.split_qkv(base, h)[1]
    elif layout == "separate":
        t = torch.zeros((p, l, h, d), dtype=torch.bfloat16)
    else:
        t = torch.zeros((p, h, l, d), dtype=torch.bfloat16).transpose(1, 2)
    strides = kernels._view_strides(t, "t")
    assert all(s * 2 % 16 == 0 and s > 0 for s in strides)
    assert strides == tuple(t.stride(i) if t.shape[i] > 1 else 8 for i in range(3))
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels._view_strides(base.view(p, l, 3 * h * d // 4, 4)[:, :, :, :4], "t")


def test_shape_rule_matches_the_gates(monkeypatch):
    """The launcher's rule takes every head dim the gates admit, up to
    MAX_HEAD_DIM, and refuses 264 as is_supported does; lanes_supported
    ignores the head dim (as JAX's), so every D <= 256 it meets launches."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for l in (16, 64, 100, 1024, 1600, 8192):
        for d in (8, 16, 20, 56, 72, 96, 128, 136, 256, 264):
            q = torch.empty((1, l, 2, d), device="meta")
            admitted = tpa.is_supported(q, q, q)
            assert admitted == jpa.is_supported(*(jax.ShapeDtypeStruct(q.shape, jnp.float32),) * 3)
            for dtype, vec in ((torch.bfloat16, 8), (torch.float32, 4)):
                if d <= kernels.MAX_HEAD_DIM:
                    dp = kernels.attention_head_dim(d, dtype)
                    assert dp % vec == 0 and d <= dp < d + vec
                    assert admitted and tpa.lanes_supported(l, d)
                else:
                    assert not admitted
                    with pytest.raises(ValueError, match="head_dim <= 256"):
                        kernels.attention_head_dim(d, dtype)
    assert kernels.attention_plan(1, 1, 100, 256, 132).dv == 256
    assert [kernels.attention_plan(1, 1, 100, d, 132).dv for d in (24, 136)] == [32, 144]
