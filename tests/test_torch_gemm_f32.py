"""The f32 GEMM's launch plan and arithmetic (the 3xTF32 form of
csrc/gemm_persistent.cuh, ``pg_gemm_3xtf32``, behind kernels.gemm_f32) on
the CPU.

The kernel computes C[M, N] = A[M, K] W[N, K]^T (+ bias, -> GELU, +
residual) in f32, in 128 x 144 output tiles walked grid-strided by min(tiles,
SMs) blocks (kernels.gemm_plan with dtype "f32").  Each operand element is
split once into a tf32 big part and the rest: the tensor cores read only an
operand's top 19 bits, so big is the value truncated to tf32 (its own bits
are passed), and small = (v - big) rounded by ``cvt.rna.tf32.f32`` (to
nearest, ties away from zero, low 13 bits cleared; common.cuh
``tf32_small``); per 32-deep k-step the tensor cores sum small * big, big *
small and big * big over its four k8 slices from zero, and the sum is added
to the running f32 accumulator on the FP32 pipe, k-step by k-step.

- The plan: every output element in exactly one tile of exactly one
  block's walk at every f32 product of Hiera-L's f32 gen-1 blocks
  (kernel_check.gemm_f32_shapes: 512^2 and 384^2, batch 8) and at ragged
  shapes; the tile width the least of kernels.gemm_seconds.
- :func:`split_tf32` is that split bit for bit (hand-checked patterns of
  the rounding: ties away from zero, the carry into the exponent, signs);
  :func:`emulate` runs the dataflow and is held against torch.mm in f64
  within kernel_check.F32_REL_LIMIT at K 144 and K 4608 (and K tails), and
  so is its single-TF32 counterpart shown to miss it.
- The emulation, with its epilogue, in place of ``block_plain``'s f32
  products (F.linear), is held against JAX's ``fused_block`` ``_kernel``
  at f32 (spegnet_tpu/ops/fused_block.py:99, Pallas in interpret mode) with
  tests/test_torch_f32.py's tolerance.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_blocks import _jax_gen1_weights, _port_block, _weights

from spegnet_tpu.ops import fused_block as jfb
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch import kernel_check, kernels
from spegnet_tpu_torch.ops import fused_block as tfb
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
SMS = 132   # the H100's SMs, the count the plans are made for
K_STEP = 32   # f32 values of a 128-byte k-step
TOL = dict(atol=1e-4, rtol=1e-4)   # tests/test_torch_f32.py
# Every f32 product of Hiera-L's f32 gen-1 blocks at batch 8, and ragged
# shapes: M 1 / 31 / 300 / past 2^20, N 4 / 200 / 148, K 4 / 100 / 36.
SHAPES = sorted({v[:3] for v in kernel_check.gemm_f32_shapes(8).values()}
                | {(1, 4, 4), (31, 148, 36), (300, 200, 100), (2 ** 20 + 3, 432, 144)})


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
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_f32_plan_covers_every_output_once(m, n, k, residual):
    """Every output element lies in exactly one tile of exactly one block's
    walk; the grid is min(tiles, SMs), the busiest block takes ceil(tiles /
    grid) tiles, the tile width is the one the kernel is built for."""
    plan = kernels.gemm_plan(m, n, k, SMS, "f32", residual)
    assert plan.bn == 144 and not plan.handoff
    assert plan.m_tiles == -(-m // kernels.GEMM_BM) and plan.n_tiles == -(-n // plan.bn)
    assert plan.grid == min(plan.tiles, SMS)
    seen = np.zeros((plan.m_tiles, plan.n_tiles), np.int64)
    longest = 0
    for walk in walks(plan):
        longest = max(longest, len(walk))
        for m0, n0 in walk:
            assert m0 < m and n0 < n
            seen[m0 // kernels.GEMM_BM, n0 // plan.bn] += 1
    assert (seen == 1).all()
    assert longest == -(-plan.tiles // plan.grid)


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_f32_plan_is_the_reckonings_least(m, n, k):
    """The tile width minimises kernels.gemm_seconds over GEMM_BN["f32"] at
    the 3xTF32 rate (a third of the dense TF32 rate), with f32 outputs."""
    plan = kernels.gemm_plan(m, n, k, SMS, "f32")
    cost = {bn: kernels.gemm_seconds(m, n, k, bn, SMS, "f32") for bn in kernels.GEMM_BN["f32"]}
    assert plan.bn == min(cost, key=lambda bn: (cost[bn], -bn))
    assert kernels.gemm_seconds(m, n, k, 144, SMS, "f32") > kernels.gemm_seconds(
        m, n, k, 144, SMS, "bf16")


def rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared (common.cuh
    ``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """The kernel's split as the tensor cores see it: big = v truncated to
    tf32 (the top 19 bits they read of v itself), small = common.cuh
    ``tf32_small(v)`` = rna(v - big)."""
    big = (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, rna(v - big)


def test_split_tf32_rounds_to_nearest_ties_away():
    """The rounding of the small part, on patterns: below the half-way point
    down, at it away from zero (both signs), the carry into the exponent;
    and big + small within 2^-22 of v, both with their low 13 bits clear."""
    one = 0x3F800000
    cases = {one + 0x0FFF: one, one + 0x1000: one + 0x2000, one + 0x1FFF: one + 0x2000,
             0x3FFFF000: 0x40000000, one | (1 << 31): one | (1 << 31),
             (one + 0x1000) | (1 << 31): (one + 0x2000) | (1 << 31)}
    src = torch.tensor(list(cases), dtype=torch.int64).to(torch.int32).view(torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.int64).to(torch.int32)
    assert torch.equal(rna(src).view(torch.int32), want)
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    big, small = split_tf32(v)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(((big + small - v).abs() / v.abs()).max()) <= 2.0 ** -22


def emulate(a: torch.Tensor, w: torch.Tensor, three: bool = True) -> torch.Tensor:
    """f32 sums of the kernel's dataflow: A and W zero-filled to whole
    32-deep k-steps; per k-step, from zero, small_a * big_w, then big_a *
    small_w, then big_a * big_w, each over the step's four k8 slices in
    order (each k8 product exact: tf32 x tf32 fits f32's significand; its
    8-term sum in f32); the step's sum added to the running f32 sum in k
    order.  ``three=False``: one TF32 product (big * big) per slice."""
    m, k = a.shape
    kp = -(-k // K_STEP) * K_STEP
    ab, as_ = split_tf32(F.pad(a.float(), (0, kp - k)))
    wb, ws = split_tf32(F.pad(w.float(), (0, kp - k)))
    d = torch.zeros((m, w.shape[0]))
    for k0 in range(0, kp, K_STEP):
        f = torch.zeros_like(d)
        pairs = ((as_, wb), (ab, ws), (ab, wb)) if three else ((ab, wb),)
        for x, y in pairs:
            for kk in range(k0, k0 + K_STEP, 8):
                f = f + x[:, kk:kk + 8] @ y[:, kk:kk + 8].T
        d = d + f
    return d


def epilogue(s, bias, residual, gelu):
    """F32Epi's arithmetic: + bias, the GELU, residual + value."""
    y = s if bias is None else s + bias
    if gelu:
        y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none")
    return y if residual is None else residual + y


@pytest.mark.parametrize("m,n,k", [(64, 144, 144), (96, 288, 4608), (33, 148, 100),
                                   (128, 144, 1152)])
def test_emulated_f32_matches_mm_f64(rng, m, n, k):
    """The 3xTF32 sums within F32_REL_LIMIT (max |e - r| / max |r|) of
    torch.mm in f64, at Hiera-L's K 144 and 4608 and a K tail; one TF32
    product per slice misses the limit by two orders of magnitude."""
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32))
    ref = a.double() @ w.double().T
    rel = lambda s: float((s.double() - ref).abs().max() / ref.abs().max())  # noqa: E731
    assert rel(emulate(a, w)) <= kernel_check.F32_REL_LIMIT / 10
    assert rel(emulate(a, w, three=False)) > 10 * kernel_check.F32_REL_LIMIT


@pytest.mark.parametrize("gelu", [None, "erf", "tanh"])
def test_emulated_f32_epilogues_match_plain(rng, gelu):
    """Each epilogue on the emulated sums within F32_REL_LIMIT of the plain
    f32 version (F.linear, the GELU, + residual) that phase 3 holds the
    kernel to."""
    m, n, k = 200, 288, 576
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    for res in (None, r):
        got = epilogue(emulate(a, w), b, res, gelu)
        want = F.linear(a, w, b)
        if gelu:
            want = F.gelu(want, approximate="tanh" if gelu == "tanh" else "none")
        want = want if res is None else res + want
        assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.F32_REL_LIMIT


@pytest.mark.parametrize("c,heads,d,l,nw", [(32, 2, 16, 16, 8), (64, 4, 16, 64, 4)])
def test_emulated_f32_block_matches_jax_kernel(rng, interpret, monkeypatch, c, heads, d, l,
                                               nw):
    """block_reference with the 3xTF32 dataflow in place of its four f32
    products (F.linear) against JAX's gen-1 ``_kernel`` at f32 in interpret
    mode, and within F32_REL_LIMIT-scale agreement of the plain block."""
    calls = []

    def linear(x, w, b=None):
        calls.append(tuple(w.shape))
        out = emulate(x.reshape(-1, x.shape[-1]), w)
        return epilogue(out, b, None, None).reshape(*x.shape[:-1], -1)

    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((nw, l, c)).astype(np.float32)
    plain = tfb.block_reference(torch.from_numpy(x), _port_block(w), heads, d ** -0.5,
                                approx_gelu=False)
    funcs = {k: getattr(F, k) for k in dir(F) if not k.startswith("_")}
    funcs["linear"] = linear
    monkeypatch.setattr(tfbt, "F", types.SimpleNamespace(**funcs))
    got = tfb.block_reference(torch.from_numpy(x), _port_block(w), heads, d ** -0.5,
                              approx_gelu=False)
    assert sorted(calls) == sorted([(3 * heads * d, c), (c, heads * d), (4 * c, c),
                                    (c, 4 * c)])
    jw, hp = _jax_gen1_weights(w, heads, d)
    ker = np.asarray(jfb.fused_block(jnp.asarray(x), jw, heads, hp, d ** -0.5, 1e-6, False))
    np.testing.assert_allclose(got.numpy(), ker, **TOL)
    assert float((got - plain).abs().max() / plain.abs().max()) <= kernel_check.F32_REL_LIMIT
