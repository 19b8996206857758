"""The LayerNorm backward (csrc/hiera_block_bwd.cu ``layernorm_bwd_kernel``,
behind kernels.layernorm_bwd) on the CPU.

The kernel serves each bf16 row of C with a group of G lanes
(kernels.layernorm_bwd_plan): lane j holds the row's 16-byte vectors j, j +
G, ... (8 values each) of x and dy in registers, and every row reduction
(the sum, the centred variance, the pair m1 = mean(dy w), m2 = mean(dy w
xhat)) is a shuffle tree inside the group (offsets G/2 .. 1); dx = bf16(r
(dy w - m1 - xhat m2) (+ dres)).  A CTA walks a contiguous strip of rows,
its groups taking rows strip0 + group, + groups, ...; each lane keeps the
f32 sums of dy xhat and dy of its columns over the strip, the warp's groups
are added by a shuffle tree (offsets 16 .. G), the warps in order, and the
CTAs' partial rows by reduce_rows_kernel: its warp w adds rows w, w + 32,
..., then the 32 warps' sums in order.

- The plan: every 16-byte vector of a row held by exactly one lane, at the
  main path's C (144 / 288 / 576 / 1152) and at other multiples of 8 up to
  the wide form's 4096; the strips cover every row once.
- :func:`emulate` runs that reduction order on bf16 rows, with and without
  dres, against ``_layer_norm_bwd`` (ops/fused_block_t.py, the plain
  version) and against JAX's ``_ln_bwd`` (spegnet_tpu/ops/fused_block_t.py
  :1141, on the [C, rows] layout it sums over, with ``_ln_fwd_stats``'
  statistics): dx equal or one bf16 step apart on at most 1e-3 of elements
  (f32 sums in other orders move a value across a bf16 rounding edge now
  and then); dw / db within f32 summation order, 2e-6 of the sum of the
  terms' magnitudes (16 ulps of it; a strip sums a few hundred terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch import kernel_check, kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
EPS = 1e-6
DX_STEP_FRAC = 1e-3
SUM_REL = 2e-6
REDUCE_WARPS = 32   # csrc/hiera_block_bwd.cu LB_RWARPS
# The main path's C, and others down to one vector, a tail vector past 32
# lanes of 4, the narrow form's longest row, the wide form's first and last.
CS = [8, 16, 72, 144, 288, 576, 1152, 1160, 1280, 1288, 2304, 4096, 4104]


@pytest.mark.parametrize("c", CS)
def test_plan_holds_every_vector_once(c):
    """Lanes a power of 2 up to 32, the fewest that hold the row in
    LNB_NV_SHORT vectors each, else 32 lanes of at most LNB_NV (narrow) or
    LNB_WIDE_NV (wide); lane j's vectors j, j + lanes, ... cover the row's
    vectors once.  Rows past 32 wide vectors a lane raise."""
    nvec = c // 8
    if nvec > 32 * kernels.LNB_WIDE_NV:
        with pytest.raises(ValueError):
            kernels.layernorm_bwd_plan(64, c, 132)
        return
    plan = kernels.layernorm_bwd_plan(64, c, 132)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.wide == (nvec > 32 * kernels.LNB_NV)
    assert -(-nvec // plan.lanes) <= plan.nv
    if plan.lanes < 32:
        assert plan.nv <= kernels.LNB_NV_SHORT
        assert plan.lanes == 1 or -(-nvec // (plan.lanes // 2)) > kernels.LNB_NV_SHORT
    held = np.zeros(nvec, np.int64)
    for j in range(plan.lanes):
        for i in range(plan.nv):
            if j + plan.lanes * i < nvec:
                held[j + plan.lanes * i] += 1
    assert (held == 1).all()


def test_main_path_takes_the_narrow_form():
    """Every LayerNorm backward of a training step keeps its column sums in
    registers."""
    for c, _, _, _ in kernel_check.LN_BWD.values():
        assert not kernels.layernorm_bwd_plan(1024, c, 132).wide


@pytest.mark.parametrize("rows", [1, 7, 64, 300, 1000, 131072])
@pytest.mark.parametrize("c", [144, 576, 1152])
@pytest.mark.parametrize("sms", [1, 132])
def test_strips_cover_every_row_once(rows, c, sms):
    """Contiguous strips, a multiple of the CTA's groups, none empty, at
    most sms * LNB_PER_SM of them, covering rows [0, rows) once."""
    plan = kernels.layernorm_bwd_plan(rows, c, sms)
    groups = kernels.LNB_THREADS // plan.lanes
    assert plan.strip % groups == 0 and plan.strip >= 1
    assert 1 <= plan.ctas <= max(1, sms * kernels.LNB_PER_SM)
    assert (plan.ctas - 1) * plan.strip < rows <= plan.ctas * plan.strip
    seen = np.zeros(rows, np.int64)
    for k in range(plan.ctas):
        seen[k * plan.strip:min(rows, (k + 1) * plan.strip)] += 1
    assert (seen == 1).all()


def tree(v: torch.Tensor, lanes: int) -> torch.Tensor:
    """The group's shuffle sum on [..., lanes]: offsets lanes/2 .. 1."""
    idx = torch.arange(lanes)
    o = lanes // 2
    while o:
        v = v + v[..., idx ^ o]
        o //= 2
    return v


def emulate(x, w, dy, dres=None, eps=EPS, sms=132):
    """(dx bf16, dw f32, db f32) of the kernel on the CPU, in its order."""
    rows, c = x.shape
    plan = kernels.layernorm_bwd_plan(rows, c, sms)
    g, nv = plan.lanes, plan.nv
    nvec = c // 8
    if plan.wide:
        nv = -(-nvec // g)
    pad = nv * g - nvec

    def lay(t, lead):   # vector j + g * i -> [..., i, j, element]
        return F.pad(t.reshape(*lead, nvec, 8), (0, 0, 0, pad)).reshape(*lead, nv, g, 8)

    xv, gv, wv = lay(x.float(), (rows,)), lay(dy.float(), (rows,)), lay(w.float(), ())
    valid = ((torch.arange(nv)[:, None] * g + torch.arange(g)[None]) < nvec)[..., None]
    s = torch.zeros((rows, g))
    for i in range(nv):
        for e in range(8):
            s = s + xv[:, i, :, e]
    mu = tree(s, g)[:, :1] / c
    var = torch.zeros((rows, g))
    for i in range(nv):
        for e in range(8):
            d = xv[:, i, :, e] - mu
            var = var + torch.where(valid[i, :, 0], d * d, torch.zeros(()))
    r = torch.rsqrt(tree(var, g)[:, :1] / c + eps)
    mu4, r4 = mu[:, :, None, None], r[:, :, None, None]
    xh = (xv - mu4) * r4
    gw = gv * wv
    m1 = torch.zeros((rows, g))
    m2 = torch.zeros((rows, g))
    for i in range(nv):
        for e in range(8):
            ok = valid[i, :, 0]
            m1 = m1 + torch.where(ok, gw[:, i, :, e], torch.zeros(()))
            m2 = m2 + torch.where(ok, gw[:, i, :, e] * xh[:, i, :, e], torch.zeros(()))
    m1 = (tree(m1, g)[:, :1] / c)[:, :, None, None]
    m2 = (tree(m2, g)[:, :1] / c)[:, :, None, None]
    v = r4 * ((gw - m1) - xh * m2)
    if dres is not None:
        v = v + lay(dres.float(), (rows,))
    dx = v.to(torch.bfloat16).reshape(rows, nv * g, 8)[:, :nvec].reshape(rows, c)

    # column sums: lane (group, j) over the rows it takes in its CTA's strip
    groups = kernels.LNB_THREADS // g
    passes = plan.strip // groups
    tdw, tdb = gv * xh, gv                       # [rows, nv, g, 8]
    full = plan.ctas * plan.strip
    tdw, tdb = (F.pad(t, (0, 0, 0, 0, 0, 0, 0, full - rows)) for t in (tdw, tdb))
    tdw, tdb = (t.reshape(plan.ctas, passes, groups, nv, g, 8) for t in (tdw, tdb))
    adw = torch.zeros((plan.ctas, groups, nv, g, 8))
    adb = torch.zeros_like(adw)
    for p in range(passes):
        adw = adw + tdw[:, p]
        adb = adb + tdb[:, p]
    gpw = 32 // g                                # groups a warp
    adw, adb = (t.reshape(plan.ctas, kernels.LNB_THREADS // 32, gpw, nv, g, 8)
                for t in (adw, adb))
    idx = torch.arange(gpw)
    o = gpw // 2
    while o:                                     # lane offsets 16 .. g
        adw = adw + adw[:, :, idx ^ o]
        adb = adb + adb[:, :, idx ^ o]
        o //= 2
    wdw, wdb = adw[:, :, 0], adb[:, :, 0]        # [ctas, warps, nv, g, 8]
    cdw, cdb = wdw[:, 0], wdb[:, 0]
    for k in range(1, kernels.LNB_THREADS // 32):
        cdw = cdw + wdw[:, k]
        cdb = cdb + wdb[:, k]
    # reduce_rows_kernel: warp w adds partial rows w, w + 32, ..., then the
    # warps in order (one CTA: its row is the result)
    dw, db = cdw[0].reshape(-1), cdb[0].reshape(-1)
    if plan.ctas > 1:
        sw = [torch.zeros(nv * g * 8) for _ in range(REDUCE_WARPS)]
        sb = [torch.zeros(nv * g * 8) for _ in range(REDUCE_WARPS)]
        for k in range(plan.ctas):
            sw[k % REDUCE_WARPS] = sw[k % REDUCE_WARPS] + cdw[k].reshape(-1)
            sb[k % REDUCE_WARPS] = sb[k % REDUCE_WARPS] + cdb[k].reshape(-1)
        dw, db = sw[0], sb[0]
        for k in range(1, REDUCE_WARPS):
            dw, db = dw + sw[k], db + sb[k]

    def cols(t):   # [i, j, e] order back to the row's columns
        return t.reshape(nv * g, 8)[:nvec].reshape(c)

    return dx, cols(dw), cols(db)


def _inputs(rng, rows, c, dres):
    x = rng.standard_normal((rows, c)) + rng.standard_normal((rows, 1))
    w = 1.0 + 0.1 * rng.standard_normal(c)
    dy = rng.standard_normal((rows, c))
    dr = rng.standard_normal((rows, c)) if dres else None
    bf = torch.bfloat16
    return (torch.from_numpy(x.astype(np.float32)).to(bf), torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(dy.astype(np.float32)).to(bf),
            None if dr is None else torch.from_numpy(dr.astype(np.float32)).to(bf))


def _dx_ok(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal, or one bf16 step apart on at most DX_STEP_FRAC of elements."""
    frac, steps = kernel_check.bf16_steps(got, want)
    assert steps <= 1 and frac <= DX_STEP_FRAC, (steps, frac)


def _sum_ok(got: torch.Tensor, want: torch.Tensor, mag: torch.Tensor) -> None:
    assert ((got.double() - want.double()).abs() <= SUM_REL * mag.double() + 1e-30).all()


@pytest.mark.parametrize("dres", [False, True])
@pytest.mark.parametrize("c,rows,sms", [(144, 300, 2), (288, 200, 2), (576, 150, 1),
                                        (1152, 90, 1), (1160, 40, 132), (1288, 24, 1),
                                        (72, 33, 132)])
def test_emulation_matches_plain(rng, c, rows, sms, dres):
    """The kernel's order against ``_layer_norm_bwd`` (f32, + dres, rounded
    to bf16) and the column sums against the same sums in f64."""
    x, w, dy, dr = _inputs(rng, rows, c, dres)
    dx, dw, db = emulate(x, w, dy, dr, sms=sms)
    pdx, _, _ = tfbt._layer_norm_bwd(x, w, dy.float(), EPS)
    if dr is not None:
        pdx = pdx + dr.float()
    _dx_ok(dx, pdx.to(torch.bfloat16))
    _, pdw, pdb = tfbt._layer_norm_bwd(x.double(), w.double(), dy.double(), EPS)
    xd = x.double()
    xh = (xd - xd.mean(-1, keepdim=True)) * torch.rsqrt(xd.var(-1, unbiased=False,
                                                              keepdim=True) + EPS)
    _sum_ok(dw, pdw, (dy.double() * xh).abs().sum(0))
    _sum_ok(db, pdb, dy.double().abs().sum(0))


@pytest.mark.parametrize("dres", [False, True])
@pytest.mark.parametrize("c,rows", [(144, 96), (288, 64), (576, 40), (1152, 24)])
def test_emulation_matches_jax_ln_bwd(rng, c, rows, dres):
    """The kernel's order against JAX's ``_ln_bwd`` on the [C, rows] layout
    it reduces over (axis 0), with ``_ln_fwd_stats``' statistics; dw and db
    against the sums of the same JAX terms over the rows."""
    x, w, dy, dr = _inputs(rng, rows, c, dres)
    dx, dw, db = emulate(x, w, dy, dr, sms=1)
    xt = jnp.asarray(x.float().numpy().T)
    dyt = jnp.asarray(dy.float().numpy().T)
    hhat, r = jfbt._ln_fwd_stats(xt, EPS)
    jdx = np.asarray(jfbt._ln_bwd(dyt, hhat, r, jnp.asarray(w.numpy())[:, None])).T
    jdx = torch.from_numpy(jdx.copy())
    if dr is not None:
        jdx = jdx + dr.float()
    _dx_ok(dx, jdx.to(torch.bfloat16))
    terms = np.asarray(dyt * hhat, np.float64)
    _sum_ok(dw, torch.from_numpy(terms.sum(1)), torch.from_numpy(np.abs(terms).sum(1)))
    dyd = np.asarray(dyt, np.float64)
    _sum_ok(db, torch.from_numpy(dyd.sum(1)), torch.from_numpy(np.abs(dyd).sum(1)))


def test_emulation_is_deterministic_and_strip_dependent(rng):
    """The same plan gives the same bits; another card (another CTA count)
    may sum the columns in another order, within the same tolerance."""
    x, w, dy, dr = _inputs(rng, 500, 144, True)
    a = emulate(x, w, dy, dr, sms=3)
    b = emulate(x, w, dy, dr, sms=3)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = emulate(x, w, dy, dr, sms=1)
    assert torch.equal(a[0], c[0])          # dx does not depend on the strips
    mag = dy.float().abs().sum(0)
    _sum_ok(a[2], c[2], mag)
