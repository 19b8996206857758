"""The persistent GEMM's launch plan and arithmetic (csrc/gemm_persistent.cuh,
kernels.gemm_plan) on the CPU.

The kernel computes C[M, N] = A[M, K] W[N, K]^T in 128 x BN output tiles;
block b of the grid walks tiles b, b + grid, ... (N fastest), its producer
thread loading every k-step of every tile into a ring of STAGES stages with
one step counter across the block's walk.  Each tile's sums run over K in
k-steps of one 128-byte row per operand row (64 bf16 values or 128 int8
codes), zero-filled past K, M and N, then the epilogue rounds them.

- The plan: every output element belongs to exactly one tile of exactly one
  block's walk, for bf16 and int8 (and int8 with an f32 output), with and
  without a residual, at M, N and K tails and M past 2^23; the tile width
  is the least of the plan's reckoning (kernels.gemm_seconds), and the
  hand-off kernel (csrc/gemm_handoff.cuh) takes the bf16 products of width
  192 without a residual; the ring's full / empty barrier phases
  (a simulation of the mbarriers) hand each consumer wait the load of the
  same (tile, k-step) across tile boundaries, at every ring depth the
  kernel may take.
- :func:`emulate_i8` runs the s8 dataflow (int32 sums per 128-code k-step
  with zero-filled tails, then the dequant epilogue in the TPU kernel's
  order, the GELU, the rounding to the output dtype and the residual add):
  bit-equal to ``ops/fused_block_t_i8.qdot`` plus the same rounding, and,
  put in place of ``qdot``, the plain int8 block held against JAX's
  ``_kernel_i8`` (spegnet_tpu/ops/fused_block_t_i8.py:137, Pallas in
  interpret mode) with the JAX package's int8 element rule.
- :func:`emulate_bf16` runs the bf16 dataflow (f32 sums in 64-deep k-steps,
  then each epilogue's rounding): the sums within 1e-6 of torch.mm in f64,
  each epilogue within one bf16 step of the same rounding of the f64 sums;
  put in place of ``block_plain``'s projections, the block held against
  JAX's ``_kernel`` (spegnet_tpu/ops/fused_block_t.py:349, interpret mode)
  with tests/test_torch_blocks.py's tolerance.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_blocks import TOL, _jax_t_weights, _port_block, _weights

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_block_t_i8 as jfbt_i8
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as tfbt_i8

torch.set_num_threads(1)
SMS = 132   # the H100's SMs, the count the plans are made for
DTYPES = ("bf16", "int8", "int8_f32")
# (M, N, K): M 1, 31, 4099 and past 2^23; N 8, 136, 576, 1728, 2304; K 32,
# 96, 144, 288, 2304 (K % 32 == 0, the int8 gate).
SHAPES = [(1, 8, 32), (31, 136, 96), (4099, 576, 144), (4099, 1728, 288),
          (8192, 2304, 2304), (2 ** 23 + 1, 2304, 144)]
K_STEP = {"bf16": 64, "int8": 128, "int8_f32": 128}


@pytest.fixture
def interpret(monkeypatch):
    """JAX's kernels in interpret mode, and its kernel gates open on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    yield


def walks(plan):
    """Each block's tiles in the order it takes them: (m0, n0) per tile."""
    for b in range(plan.grid):
        yield [(t // plan.n_tiles * kernels.GEMM_BM, t % plan.n_tiles * plan.bn)
               for t in range(b, plan.tiles, plan.grid)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_covers_every_output_once(m, n, k, dtype, residual):
    """Every output element lies in exactly one tile of exactly one block's
    walk; the grid is min(tiles, SMs) (the hand-off kernel's too), the
    busiest block takes ceil(tiles / grid) tiles, and the tile width is one
    the kernel is built for."""
    plan = kernels.gemm_plan(m, n, k, SMS, dtype, residual)
    assert plan.bn in kernels.GEMM_BN[dtype]
    assert plan.m_tiles == -(-m // kernels.GEMM_BM) and plan.n_tiles == -(-n // plan.bn)
    assert plan.grid == min(plan.tiles, SMS)
    assert plan.tiles < 2 ** 31
    seen = np.zeros((plan.m_tiles, plan.n_tiles), np.int64)
    longest = 0
    for walk in walks(plan):
        longest = max(longest, len(walk))
        for m0, n0 in walk:
            assert m0 < m and n0 < n    # no tile lies wholly past the matrix
            seen[m0 // kernels.GEMM_BM, n0 // plan.bn] += 1
    assert (seen == 1).all()
    assert longest == -(-plan.tiles // plan.grid)
    # the tiles' row and column ranges, clipped to the matrix, sum to M x N
    rows = sum(min(m, r + kernels.GEMM_BM) - r for r in range(0, m, kernels.GEMM_BM))
    cols = sum(min(n, c + plan.bn) - c for c in range(0, n, plan.bn))
    assert rows == m and cols == n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", SHAPES + [(8192, 576, 576), (131072, 432, 144)])
def test_plan_is_the_reckonings_least(m, n, k, dtype):
    """The tile width minimises kernels.gemm_seconds over kernels.GEMM_BN,
    the widest within 1e-9 of the least; at the T-block's stage-3 proj and
    fc2 (N 576, M 8192: 1.45 waves of 192-wide tiles) that is 144.  The
    hand-off kernel takes exactly the bf16 products of width 192 whose
    epilogue reads no residual, whatever the residual does to the width."""
    for residual in (False, True):
        plan = kernels.gemm_plan(m, n, k, SMS, dtype, residual)
        cost = {bn: kernels.gemm_seconds(m, n, k, bn, SMS, dtype)
                for bn in kernels.GEMM_BN[dtype]}
        best = min(cost.values())
        assert plan.bn == max(bn for bn, c in cost.items() if c <= best * (1 + 1e-9))
        assert plan.handoff == (dtype == "bf16" and plan.bn == 192 and not residual)
    if (m, n, k) == (8192, 576, 576):
        assert plan.bn == 144


def ring(total, st):
    """Simulate one block's producer and consumers over ``total`` k-steps on
    a ring of ``st`` stages with the mbarriers' parity semantics: a wait on
    parity p passes once the barrier's completed-phase count is odd for p 0,
    even for p 1.  The producer at step ``it`` waits on the empty barrier of
    stage it % st with parity (it / st - 1) & 1 (from it = st on), then its
    load completes a phase of the full barrier; the consumers at step ``it``
    wait on the full barrier with parity (it / st) & 1, read the stage and
    complete a phase of the empty barrier.  The producer runs as far ahead
    as its waits let it before each consumer step.  Returns, per consumer
    step, the step whose load it read."""
    full, empty, slot = [0] * st, [0] * st, [None] * st
    loaded = consumed = 0
    got = []

    def passes(count, parity):
        return count % 2 != parity

    while consumed < total:
        while loaded < total and (loaded < st or passes(empty[loaded % st],
                                                        (loaded // st - 1) & 1)):
            s = loaded % st
            assert slot[s] is None or slot[s] < consumed, "stage overwritten before read"
            slot[s] = loaded
            full[s] += 1
            loaded += 1
        s = consumed % st
        assert passes(full[s], (consumed // st) & 1), "deadlock"
        got.append(slot[s])
        empty[s] += 1
        consumed += 1
    return got


@pytest.mark.parametrize("st", [3, 4, 5, 6])
@pytest.mark.parametrize("steps", [1, 2, 5, 9, 36])
def test_ring_phases_cross_tile_boundaries(steps, st):
    """Over a block's walk of several tiles (one k-step each up to 36, fewer
    or more than the ring's stages), every consumer wait finds the load of
    its own step, in order, the phase bits carried across tiles."""
    assert ring(steps * 5, st) == list(range(steps * 5))


def _pad(t, rows, cols):
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _tiles(m, n, k, dtype):
    plan = kernels.gemm_plan(m, n, k, SMS, dtype)
    step = K_STEP[dtype]
    kp = -(-k // step) * step
    return plan, kp, step


def emulate_i8(a, sa, w, sw, bias, residual=None, gelu=None, sw_first=True,
               out_dtype=torch.bfloat16):
    """kernels.gemm_i8 by the kernel's dataflow: per 128 x BN tile (M, N and
    K zero-filled to whole tiles and k-steps) int32 sums taken k-step by
    k-step, then per element __int2float_rn, the two scale products in the
    ``sw_first`` order each rounded to f32, + bias, the GELU ("tanh" or
    "erf"), the rounding to ``out_dtype``, and the residual add rounded
    once more."""
    m, k = a.shape
    n = w.shape[0]
    plan, kp, step = _tiles(m, n, k, "int8_f32" if out_dtype == torch.float32 else "int8")
    mp, np_ = plan.m_tiles * kernels.GEMM_BM, plan.n_tiles * plan.bn
    ap, wp = _pad(a.long(), mp, kp), _pad(w.long(), np_, kp)
    acc = torch.zeros((mp, np_), dtype=torch.long)
    for walk in walks(plan):
        for m0, n0 in walk:
            at, wt = ap[m0:m0 + kernels.GEMM_BM], wp[n0:n0 + plan.bn]
            s = torch.zeros((kernels.GEMM_BM, plan.bn), dtype=torch.long)
            for k0 in range(0, kp, step):
                s += at[:, k0:k0 + step] @ wt[:, k0:k0 + step].T
            assert s.abs().max() < 2 ** 31      # the s32 accumulator
            acc[m0:m0 + kernels.GEMM_BM, n0:n0 + plan.bn] = s
    v = acc[:m, :n].to(torch.float32)
    v = (v * sw) * sa[:, None] if sw_first else (v * sa[:, None]) * sw
    v = v + bias
    if gelu:
        v = F.gelu(v, approximate="tanh" if gelu == "tanh" else "none")
    v = v.to(out_dtype)
    return v if residual is None else residual + v


def _codes(rng, rows, k):
    return torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k", [(1, 8, 32), (31, 136, 96), (200, 576, 288), (129, 296, 2304)])
def test_emulated_i8_matches_qdot(rng, m, n, k, out_dtype):
    """The s8 dataflow, each epilogue (none, residual, tanh GELU, erf GELU on
    f32) and both dequant orders, bit-equal to qdot + the same rounding."""
    a, w = _codes(rng, m, k), _codes(rng, n, k)
    sa = torch.from_numpy(rng.random(m).astype(np.float32) * 0.02)
    sw = torch.from_numpy(rng.random(n).astype(np.float32) * 2e-3)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    r = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(out_dtype)
    gelus = [None, "tanh"] + (["erf"] if out_dtype == torch.float32 else [])
    for sw_first in (True, False):
        for gelu in gelus:
            for res in (None, r):
                got = emulate_i8(a, sa, w, sw, bias, res, gelu, sw_first, out_dtype)
                want = tfbt_i8.qdot(a, sa[:, None], w, sw, bias, sw_first)
                if gelu:
                    want = F.gelu(want, approximate="tanh" if gelu == "tanh" else "none")
                want = want.to(out_dtype)
                if res is not None:
                    want = res + want
                assert torch.equal(got, want), (sw_first, gelu, res is None)


def _emulated_qdot(xq, sx, wq, sw, bias, sw_first=True):
    """qdot's contract (f32 out, no rounding) through the s8 dataflow."""
    lead = xq.shape[:-1]
    out = emulate_i8(xq.reshape(-1, xq.shape[-1]), sx.reshape(-1), wq, sw, bias,
                     sw_first=sw_first, out_dtype=torch.float32)
    return out.reshape(*lead, -1)


@pytest.mark.parametrize("c,heads,d,l,n", [(32, 2, 16, 16, 256), (64, 2, 32, 64, 256)])
def test_emulated_i8_block_matches_jax_kernel(rng, interpret, monkeypatch, c, heads, d, l, n):
    """The plain int8 block with the s8 dataflow in place of qdot is the
    plain int8 block bit for bit, and holds against JAX's ``_kernel_i8`` by
    the JAX package's int8 element rule (tests/test_int8_block.py)."""
    w = _weights(rng, c, heads, d)
    x = torch.from_numpy((rng.standard_normal((2, n, c)) * 0.5).astype(np.float32))
    wts = tfbt_i8.pack_i8(_port_block(w))
    plain = tfbt_i8.block_t_i8_plain(x, wts, heads, l, d ** -0.5, approx_gelu=False)
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape[-1])
        return _emulated_qdot(*args, **kw)

    monkeypatch.setattr(tfbt_i8, "qdot", counted)
    got = tfbt_i8.block_t_i8_plain(x, wts, heads, l, d ** -0.5, approx_gelu=False)
    assert sorted(calls) == sorted([c, heads * d, c, 4 * c])
    assert torch.equal(got, plain)
    jw, hp = _jax_t_weights(w, heads, d)
    ker = jfbt_i8.fused_block_t_i8(jnp.asarray(x.numpy().transpose(0, 2, 1)),
                                   jfbt_i8.pack_i8(jw), heads, hp, l, d ** -0.5, 1e-6, False)
    diff = np.abs(got.numpy() - np.asarray(ker).transpose(0, 2, 1))
    assert float((diff > 5e-4).mean()) < 0.01 and float(diff.max()) < 0.2


BF16_ACTS = ("none", "gelu", "gelu_pre", "gelu_grad")


def emulate_bf16(a, w, bias=None, residual=None, act="none"):
    """kernels.gemm and its GELU forms by the kernel's dataflow: per 128 x
    BN tile f32 sums taken 64-deep k-step by k-step (K zero-filled), then
    ACT's rounding: + bias (-> tanh GELU) rounded to a's dtype, + residual
    rounded once more; "gelu_pre" gives (pre-activation, GELU), both from
    the same f32 sum; "gelu_grad" rounds the sum, then times gelu_tanh' of
    ``residual``.  Returns the f32 sums too."""
    m, k = a.shape
    n = w.shape[0]
    plan, kp, step = _tiles(m, n, k, "bf16")
    mp, np_ = plan.m_tiles * kernels.GEMM_BM, plan.n_tiles * plan.bn
    ap, wp = _pad(a.float(), mp, kp), _pad(w.float(), np_, kp)
    acc = torch.zeros((mp, np_))
    for walk in walks(plan):
        for m0, n0 in walk:
            at, wt = ap[m0:m0 + kernels.GEMM_BM], wp[n0:n0 + plan.bn]
            s = torch.zeros((kernels.GEMM_BM, plan.bn))
            for k0 in range(0, kp, step):
                s = s + at[:, k0:k0 + step] @ wt[:, k0:k0 + step].T
            acc[m0:m0 + kernels.GEMM_BM, n0:n0 + plan.bn] = s
    s = acc[:m, :n]
    return s, bf16_epilogue(s, bias, residual, act, a.dtype)


def bf16_epilogue(s, bias, residual, act, dt):
    """Each ACT's rounding of f32 sums ``s`` (see :func:`emulate_bf16`)."""
    v = s if bias is None else s + bias.float()
    if act == "gelu_grad":
        return (v.to(dt).float() * tfbt._gelu_grad(residual.float(), True)).to(dt)
    g = F.gelu(v, approximate="tanh")
    if act == "gelu_pre":
        return v.to(dt), g.to(dt)
    out = (g if act == "gelu" else v).to(dt)
    return out if residual is None else residual + out


@pytest.mark.parametrize("act", BF16_ACTS)
@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (31, 136, 72), (300, 576, 144), (129, 200, 1160)])
def test_emulated_bf16_matches_mm_f64(rng, m, n, k, act):
    """The bf16 dataflow's f32 sums within 1e-6 of torch.mm in f64 (relative
    to the largest), and each ACT's output within one bf16 step of the same
    rounding of the f64 sums."""
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()  # noqa: E731
    a, w, bias = bf(m, k), bf(n, k), bf(n)
    res = bf(m, n) if act in ("none", "gelu_grad") else None
    s, out = emulate_bf16(a, w, None if act == "gelu_grad" else bias, res, act)
    ref = a.double() @ w.double().T
    assert float((s.double() - ref).abs().max() / ref.abs().max()) <= 1e-6
    want = bf16_epilogue(ref.float(), None if act == "gelu_grad" else bias, res, act,
                         torch.bfloat16)
    def step(t):   # one bf16 step at |t|
        _, e = torch.frexp(t.float())
        return torch.ldexp(torch.ones_like(t.float()), e - 8)

    # The f32 sum may sit across a bf16 rounding edge from the f64 one (by
    # up to 1e-6 of the largest sum): one step of the rounded value before
    # the residual add or the gelu' product (scaled by its slope, <= 1.13),
    # then one step of the output.
    v = bf16_epilogue(ref.float(), None if act == "gelu_grad" else bias, None,
                      "none" if act == "gelu_grad" else act, torch.bfloat16)
    slope = tfbt._gelu_grad(res.float(), True).abs() if act == "gelu_grad" else 1.13
    for got, exp, pre in zip(out if act == "gelu_pre" else (out,),
                             want if act == "gelu_pre" else (want,),
                             v if act == "gelu_pre" else (v,)):
        tol = step(exp) + slope * (step(pre) + 1e-6 * ref.abs().max().float())
        assert bool(((got.float() - exp.float()).abs() <= tol).all()), act


@pytest.mark.parametrize("c,heads,d,l,n", [(32, 2, 16, 16, 256), (32, 2, 16, 64, 256)])
def test_emulated_bf16_block_matches_jax_kernel(rng, monkeypatch, c, heads, d, l, n):
    """block_plain with the bf16 dataflow in place of its four projections
    (F.linear) against JAX's ``_kernel`` in interpret mode."""
    calls = []

    def linear(x, w, b=None):
        calls.append(w.shape)
        s, out = emulate_bf16(x.reshape(-1, x.shape[-1]), w, b)
        return out.reshape(*x.shape[:-1], -1)

    funcs = {k: getattr(F, k) for k in dir(F) if not k.startswith("_")}
    funcs["linear"] = linear
    monkeypatch.setattr(tfbt, "F", types.SimpleNamespace(**funcs))
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    kw = dict(heads=heads, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=False)
    got = tfbt.block_plain(torch.from_numpy(x), _port_block(w), heads, l, d ** -0.5, 1e-6,
                           approx_gelu=False).numpy()
    assert len(calls) == 4
    jw, hp = _jax_t_weights(w, heads, d)
    ker = np.asarray(jfbt._forward(jnp.asarray(x.transpose(0, 2, 1)), jw, hp=hp,
                                   interpret=True, **kw)).transpose(0, 2, 1)
    np.testing.assert_allclose(got, ker, **TOL)
