"""The int8 LayerNorm + quant row pass (csrc/int8_gemm.cu
``layernorm_q8_kernel``, behind kernels.layernorm_q8) on the CPU.

The kernel serves each row with a group of G lanes (kernels.layernorm_q8_plan):
lane j holds the row's 16-byte vectors j, j + G, ... (8 bf16 or 4 f32
values each) in registers, sums its elements in vector order, and the group
reduces by a shuffle tree (offsets G/2 .. 1); mu = sum / C, the variance the
same over (x - mu)^2, r = rsqrt(var / C + eps), y = keep(((x - mu) r) w +
b) rounded to x's dtype, the row scale max(absmax * f32(1/127), 1e-12) and
the codes rint(y * (1 / s)), ties to even.

- The plan: the fewest lanes (a power of 2 up to 32) that hold a row in the
  narrow form's vectors per lane, else the wide form's; every vector of a
  row held by exactly one lane of its group, at every C the int8 blocks
  take and at others.
- :func:`emulate` runs that reduction order (bf16 and f32 rows) against
  ``layer_norm`` + ``quant_tokens`` (ops/fused_block_t_i8.py, the plain
  version) and against JAX's LayerNorm and ``_quant_tokens`` of
  ``_kernel_i8`` (spegnet_tpu/ops/fused_block_t.py ``_ln_sub``,
  spegnet_tpu/ops/fused_block_t_i8.py :111) run in a Pallas kernel in
  interpret mode, under the int8 rule (kernel_check.lnq8_ok): codes equal
  or one code apart on at most 1e-3 of them; scales equal in bf16, within
  kernel_check.LNQ8_SCALE_REL (a few ulps) in f32, whose LayerNorm output
  keeps the last bits that the summation order moves; at C 288 / 576 /
  1152 and on rows of exact .5 ties (codes and scales equal there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_block_t_i8 as jfbt_i8
from spegnet_tpu_torch import kernel_check, kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as tfbt_i8

torch.set_num_threads(1)
EPS = 1e-6
# The int8 blocks' C (stage 2 and t23: 288; stage 3, the global blocks and
# t34: 576; stage 4: 1152), and others down to one vector and up to the
# wide form's longest row.
CS = [8, 16, 144, 288, 576, 1152, 1160, 1536, 2304, 4096]


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("c", CS)
def test_plan_holds_every_vector_once(c, f32):
    """Lanes a power of 2 up to 32, the fewest that hold the row in the
    form's vectors per lane (the narrow form where it can); lane j's
    vectors j, j + lanes, ... cover the row's vectors once.  Rows past 32
    wide-form vectors a lane raise."""
    vec, dt = (4, "f32") if f32 else (8, "bf16")
    nvec = c // vec
    if nvec > 32 * kernels.LNQ8_WIDE_NV[dt]:
        with pytest.raises(ValueError):
            kernels.layernorm_q8_plan(c, f32)
        return
    plan = kernels.layernorm_q8_plan(c, f32)
    narrow = kernels.LNQ8_NV[dt]
    assert plan.wide == (nvec > 32 * narrow)
    assert plan.nv == (kernels.LNQ8_WIDE_NV[dt] if plan.wide else narrow)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert -(-nvec // plan.lanes) <= plan.nv
    assert plan.lanes == 1 or -(-nvec // (plan.lanes // 2)) > plan.nv
    held = np.zeros(nvec, np.int64)
    for j in range(plan.lanes):
        for i in range(plan.nv):
            if j + plan.lanes * i < nvec:
                held[j + plan.lanes * i] += 1
    assert (held == 1).all()


def test_int8_geometries_take_the_narrow_form():
    """Every LayerNorm + quant of an int8 forward (kernel_check.LNQ8) holds
    its LayerNorm weight and bias in registers."""
    for c, _, f32, _ in kernel_check.LNQ8.values():
        assert not kernels.layernorm_q8_plan(c, f32).wide


def tree(v: torch.Tensor, lanes: int, op) -> torch.Tensor:
    """The group's shuffle tree on [rows, lanes]: offsets lanes/2 .. 1, lane
    i combining its value with lane i ^ o's."""
    idx = torch.arange(lanes)
    o = lanes // 2
    while o:
        v = op(v, v[:, idx ^ o])
        o //= 2
    return v


def emulate(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = EPS):
    """(codes [rows, C] int8, scales [rows] f32) of the row pass on the CPU,
    with kernels.layernorm_q8_plan's lanes, in the kernel's order."""
    rows, c = x.shape
    f32 = x.dtype == torch.float32
    vec = 4 if f32 else 8
    nvec = c // vec
    plan = kernels.layernorm_q8_plan(c, f32)
    g, nv = plan.lanes, -(-nvec // plan.lanes)
    pad = nv * g - nvec

    def lay(t, lead):   # vector j + g * i -> [..., i, j, element]
        return F.pad(t.reshape(*lead, nvec, vec), (0, 0, 0, pad)).reshape(*lead, nv, g, vec)

    xv, wv, bv = lay(x.float(), (rows,)), lay(w.float(), ()), lay(b.float(), ())
    valid = (torch.arange(nv)[:, None] * g + torch.arange(g)[None]) < nvec
    s = torch.zeros((rows, g))
    for i in range(nv):
        for e in range(vec):
            s = s + xv[:, i, :, e]
    s = tree(s, g, torch.add)
    assert (s == s[:, :1]).all()      # every lane of the group has the same bits
    mu = s[:, :1] / c
    var = torch.zeros((rows, g))
    for i in range(nv):
        for e in range(vec):
            d = xv[:, i, :, e] - mu
            var = var + torch.where(valid[i], d * d, torch.zeros(()))
    var = tree(var, g, torch.add)
    r = torch.rsqrt(var[:, :1] / c + eps)
    y = ((xv - mu[:, :, None, None]) * r[:, :, None, None]) * wv + bv
    y = y.to(x.dtype).float()
    amax = tree(y.abs().amax(dim=(1, 3)), g, torch.maximum)[:, 0]
    sc = torch.clamp(amax * (1.0 / 127.0), min=1e-12)
    codes = torch.round(y * torch.reciprocal(sc)[:, None, None, None]).to(torch.int8)
    codes = codes.reshape(rows, nv * g, vec)[:, :nvec].reshape(rows, c)
    return codes, sc


def _inputs(rng, rows, c, f32, ties=False):
    """Seeded rows (N(0, 1) plus a per-row offset), LayerNorm weight ~1 +
    0.1 N and bias 0.1 N.  With ``ties``, rows of exact .5 ties: each row
    constant (mean exact, x - mu 0), so the LayerNorm output is the bias,
    here +-127 and every k + 1/2 for |k| <= 126 (exact in bf16); the scale is
    127 * f32(1/127) = 1.0 exactly and each k + 1/2 codes to a tie."""
    dt = torch.float32 if f32 else torch.bfloat16
    x = rng.standard_normal((rows, c)) + rng.standard_normal((rows, 1))
    w = 1.0 + 0.1 * rng.standard_normal(c)
    b = 0.1 * rng.standard_normal(c)
    if ties:
        x = np.repeat(0.25 * np.arange(1, rows + 1)[:, None], c, axis=1)
        b = np.resize(np.concatenate([[127.0, -127.0], np.arange(-126, 127) + 0.5]), c)
    return (torch.from_numpy(x.astype(np.float32)).to(dt),
            torch.from_numpy(w.astype(np.float32)), torch.from_numpy(b.astype(np.float32)))


def _rule(codes, scales, want_codes, want_scales, f32):
    dq = (codes.int() - want_codes.int()).abs()
    res = {"code_frac": float((dq > 0).float().mean()), "code_max": int(dq.max()),
           "scale_rel": float(((scales - want_scales).abs() / want_scales).max()),
           "same": True}
    assert kernel_check.lnq8_ok(res, f32), res
    return res


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("c", [288, 576, 1152, 1536])
def test_emulated_row_pass_matches_plain(rng, c, f32):
    """The row pass's reduction order against layer_norm + quant_tokens on
    the same rows, by the int8 rule; in bf16 the scales are equal."""
    x, w, b = _inputs(rng, 96, c, f32)
    codes, sc = emulate(x, w, b)
    qp, sp = tfbt_i8.quant_tokens(tfbt.layer_norm(x, w, b, EPS))
    res = _rule(codes, sc, qp, sp[:, 0], f32)
    if not f32:
        assert res["scale_rel"] == 0.0


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("c", [288, 576, 1152])
def test_emulated_row_pass_ties_round_to_even(rng, c, f32):
    """Rows whose codes hold exact .5 ties: the emulation and the plain
    version both round them to even, and the tie codes are present."""
    x, w, b = _inputs(rng, 8, c, f32, ties=True)
    codes, sc = emulate(x, w, b)
    qp, sp = tfbt_i8.quant_tokens(tfbt.layer_norm(x, w, b, EPS))
    _rule(codes, sc, qp, sp[:, 0], f32)
    assert torch.equal(codes, qp) and torch.equal(sc, sp[:, 0]) and (sc == 1.0).all()
    exact = tfbt.layer_norm(x, w, b, EPS).float() * torch.reciprocal(sp)
    ties = (exact - exact.floor()) == 0.5
    assert ties.float().mean() > 0.8
    assert (codes[ties].int() % 2 == 0).all()
    assert torch.equal(codes[ties].float(), torch.round(exact[ties]))


def _jax_ln_quant(x: np.ndarray, w: np.ndarray, b: np.ndarray, dtype):
    """JAX's ``_kernel_i8`` LayerNorm (``_ln_sub``) and ``_quant_tokens`` on
    the transposed rows [C, T], inside a Pallas kernel in interpret mode."""
    from jax.experimental import pallas as pl

    def kernel(x_ref, s_ref, b_ref, q_ref, sc_ref):
        h = jfbt._ln_sub(x_ref[...], s_ref[...], b_ref[...], EPS, dtype)
        q, sx = jfbt_i8._quant_tokens(h)
        q_ref[...] = q
        sc_ref[...] = sx

    c, t = x.shape[1], x.shape[0]
    call = pl.pallas_call(kernel, interpret=True,
                          out_shape=(jax.ShapeDtypeStruct((c, t), jnp.int8),
                                     jax.ShapeDtypeStruct((1, t), jnp.float32)))
    q, s = call(jnp.asarray(x.T, dtype), jnp.asarray(w[:, None]), jnp.asarray(b[:, None]))
    return torch.from_numpy(np.asarray(q).T.copy()), torch.from_numpy(np.asarray(s)[0].copy())


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("c", [288, 576, 1152])
def test_emulated_row_pass_matches_jax_kernel(rng, c, f32):
    """The row pass against JAX's LayerNorm + _quant_tokens of the int8
    kernel (interpret mode) on the same rows, by the int8 rule."""
    x, w, b = _inputs(rng, 64, c, f32)
    codes, sc = emulate(x, w, b)
    dtype = jnp.float32 if f32 else jnp.bfloat16
    xn = x.float().numpy()
    q, s = _jax_ln_quant(xn, w.numpy(), b.numpy(), dtype)
    _rule(codes, sc, q, s, f32)


@functools.lru_cache(maxsize=None)
def _wide_rows(c):
    return _inputs(np.random.default_rng(c), 16, c, False)


def test_wide_form_matches_plain():
    """A row past the narrow form (C 4096 bf16: 32 lanes of 16 vectors)
    by the same rule."""
    x, w, b = _wide_rows(4096)
    assert kernels.layernorm_q8_plan(4096, False).wide
    codes, sc = emulate(x, w, b)
    qp, sp = tfbt_i8.quant_tokens(tfbt.layer_norm(x, w, b, EPS))
    _rule(codes, sc, qp, sp[:, 0], False)
