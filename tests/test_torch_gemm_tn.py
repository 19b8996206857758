"""The weight-gradient GEMM's launch plan and arithmetic (csrc/hiera_block_bwd.cu
``gemm_tn_kernel``, kernels.gemm_tn_plan) on the CPU.

The kernel computes out[N, K] = a[M, N]^T b[M, K] and the column sums of a
(a weight gradient and its bias gradient) as 128 mt x tk output tiles, each
summed by ``splits`` blocks over consecutive ``m_split``-row slices of M
into f32 partials, which a second pass adds in split order.
:func:`emulate` runs that dataflow in PyTorch: every (tile, split) block's
partial sum in f32, the column sums from the first k-tile column, the
reduce as a left fold over the splits.  It is held against torch.mm in f64
(rel 1e-6: f32 sums of the bf16-valued products, ~2^-24 per add), and, put
in place of the plain block backward's weight gradients
(ops/fused_block_t.weight_grad), against the weight gradients of JAX's
T-block backward ``_backward`` (Pallas in interpret mode) at the ``test``
Hiera variant's widths, with the tolerance of tests/test_torch_backward.py
(atol 2e-3, rtol 1e-3: the rest of the chain sums in other orders).

The plan: the tiles and splits cover every output element once per split
and every row of M once per tile, the tile and split count are the least
of the plan's time reckoning (kernels.gemm_tn_seconds) over every tile and
count it may take, and the grid stays below 2^31 blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backward import _unpad_block_grads
from test_torch_blocks import _jax_t_weights, _port_block, _weights

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
SMS = 132   # the H100's SMs, the count the plans are made for
# (M, N, K): tails of N and K, M 1 and 31, the T-block's stage-1 and stage-3
# qkv and the gen-1 block's stage-4 fc1 gradients at batch 8, and M past
# 2^23 rows.
SHAPES = [(1, 8, 8), (31, 136, 72), (512, 48, 16), (4099, 264, 1160), (131072, 432, 144),
          (8192, 1728, 576), (2048, 4608, 1152), (65536 * 128 + 128, 8, 16)]
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


def blocks(plan, m, n, k):
    """(block, split, output rows, output columns, rows of M) of every block
    of the kernel's 1-D grid, in launch order (k-tile fastest, split
    slowest)."""
    for blk in range(plan.n_tiles * plan.k_tiles * plan.splits):
        kt = blk % plan.k_tiles
        nt = blk // plan.k_tiles % plan.n_tiles
        sp = blk // plan.k_tiles // plan.n_tiles
        bn = 128 * plan.mt
        n0, k0, m0 = nt * bn, kt * plan.tk, sp * plan.m_split
        yield (blk, sp, (n0, min(n, n0 + bn)), (k0, min(k, k0 + plan.tk)),
               (m0, min(m, m0 + plan.m_split)))


def emulate(a, b, sms=SMS):
    """(a^T b, column sums of a) by the kernel's dataflow, f32 partials per
    (tile, split) block, the reduce in split order."""
    m, n = a.shape
    k = b.shape[1]
    plan = kernels.gemm_tn_plan(m, n, k, sms)
    part = torch.full((plan.splits, n, k), float("nan"))
    cspart = torch.full((plan.splits, n), float("nan"))
    for _, sp, (n0, n1), (k0, k1), (m0, m1) in blocks(plan, m, n, k):
        assert torch.isnan(part[sp, n0:n1, k0:k1]).all(), "output element written twice"
        part[sp, n0:n1, k0:k1] = a[m0:m1, n0:n1].float().T @ b[m0:m1, k0:k1].float()
        if k0 == 0:
            cspart[sp, n0:n1] = a[m0:m1, n0:n1].float().sum(0)
    assert not torch.isnan(part).any() and not torch.isnan(cspart).any()
    out, cs = part[0].clone(), cspart[0].clone()
    for sp in range(1, plan.splits):
        out, cs = out + part[sp], cs + cspart[sp]
    return out, cs


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_covers_outputs_and_rows(m, n, k):
    """Per split, every output element belongs to exactly one block; per
    tile, the splits' row slices cover M exactly once, each a multiple of
    TN_BM rows but the last; the 1-D grid stays below 2^31 blocks."""
    plan = kernels.gemm_tn_plan(m, n, k, SMS)
    assert plan.m_split % kernels.TN_BM == 0 and plan.m_split > 0
    assert (plan.splits - 1) * plan.m_split < m <= plan.splits * plan.m_split
    assert plan.n_tiles * plan.k_tiles * plan.splits < 2 ** 31
    cover = {}   # (split) -> summed area of its blocks' output tiles
    rows = {}    # (n tile, k tile) -> its row slices, in split order
    for _, sp, (n0, n1), (k0, k1), (m0, m1) in blocks(plan, m, n, k):
        assert n0 < n1 and k0 < k1 and m0 < m1
        cover[sp] = cover.get(sp, 0) + (n1 - n0) * (k1 - k0)
        rows.setdefault((n0, k0), []).append((m0, m1))
    assert cover == {sp: n * k for sp in range(plan.splits)}
    assert len(rows) == plan.n_tiles * plan.k_tiles
    for slices in rows.values():
        assert slices[0][0] == 0 and slices[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_is_the_reckonings_least(m, n, k):
    """The tile and split count minimise kernels.gemm_tn_seconds over every
    tile of kernels.TN_TILES and every count from the fewest that keep a
    split within TN_MAX_SPLIT rows to one split per TN_BM rows or four
    blocks per SM, the fewer splits and then the earlier tile on a tie; the
    plan's tile counts are those of its tile."""
    plan = kernels.gemm_tn_plan(m, n, k, SMS)
    assert plan.m_split <= kernels.TN_MAX_SPLIT
    lo = -(-m // kernels.TN_MAX_SPLIT)
    times = {}
    for rank, (mt, tk) in enumerate(kernels.TN_TILES):
        for s in range(lo, max(lo, min(-(-m // kernels.TN_BM), 4 * SMS)) + 1):
            times[(s, rank)] = kernels.gemm_tn_seconds(m, n, k, mt, tk, s, SMS)
    best = min(times.values())
    s, rank = min(key for key, t in times.items() if t == best)
    assert (plan.mt, plan.tk) == kernels.TN_TILES[rank]
    assert plan.m_split == -(-m // (kernels.TN_BM * s)) * kernels.TN_BM
    assert plan.n_tiles == -(-n // (128 * plan.mt)) and plan.k_tiles == -(-k // plan.tk)


@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (31, 136, 72), (4099, 264, 136), (20000, 24, 200)])
def test_emulation_matches_mm_f64(rng, m, n, k):
    """The split-M f32 partials, reduced in split order, against torch.mm in
    f64 on bf16-valued operands; and the reduce order fixed: two runs give
    the same bits."""
    a = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).bfloat16().float()
    b = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16().float()
    out, cs = emulate(a, b)
    out2, cs2 = emulate(a, b)
    assert torch.equal(out, out2) and torch.equal(cs, cs2)
    ref, ref_cs = a.double().T @ b.double(), a.double().sum(0)
    assert float((out.double() - ref).abs().max() / ref.abs().max()) <= 1e-6
    assert float((cs.double() - ref_cs).abs().max() / ref_cs.abs().max()) <= 1e-6


# Hiera's `test` variant (embed 16, 1 head, stages of 1 block, windows 2):
# stage 1 (C 16, 1 head of 16) and stage 2 (C 32, 2 heads of 16), batch 2.
HIERA_TEST = [(16, 1, 16, 64, 256), (32, 2, 16, 16, 64)]


@pytest.mark.parametrize("c,heads,d,l,n", HIERA_TEST)
def test_emulation_matches_jax_backward(rng, monkeypatch, c, heads, d, l, n):
    """The T-block's eight weight and bias gradients (qkv, proj, fc1, fc2)
    through the emulated kernel, in the port's written-out block backward,
    against JAX's ``_backward``."""
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    g = (0.1 * rng.standard_normal((2, n, c))).astype(np.float32)
    wts = _port_block(w)
    calls = []

    def kernel_weight_grad(dout, inp):
        calls.append(tuple(dout.shape) + (inp.shape[1],))
        return emulate(dout, inp)

    monkeypatch.setattr(tfbt, "weight_grad", kernel_weight_grad)
    xt_ = torch.from_numpy(x)
    _, res = tfbt.block_plain_res(xt_, wts, heads, l, d ** -0.5)
    _, dw = tfbt.block_plain_bwd_res(xt_, wts, torch.from_numpy(g), res, heads, l, d ** -0.5)
    assert sorted(calls) == sorted([(2 * n, c, 4 * c), (2 * n, 4 * c, c), (2 * n, c, c),
                                    (2 * n, 3 * heads * d, c)])

    jw, hp = _jax_t_weights(w, heads, d)
    kw = dict(heads=heads, hp=hp, l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=True)
    xt, gt = jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(g.transpose(0, 2, 1))
    _, dw_k = jfbt._backward(xt, jw, gt, interpret=True, **kw)
    want = dict(zip(tfbt.BlockWeights._fields, _unpad_block_grads(dw_k, heads, d)))
    for name in ("wqkv", "bqkv", "wproj", "bproj", "wfc1", "bfc1", "wfc2", "bfc2"):
        np.testing.assert_allclose(getattr(dw, name).numpy(), want[name], err_msg=name, **TOL)
