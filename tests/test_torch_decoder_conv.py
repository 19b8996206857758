"""The PED decoder kernels' dataflow (csrc/decoder_conv.cuh, csrc/decoder_block.cu,
csrc/decoder_i8.cu), emulated in PyTorch on the CPU and held against the
plain versions and the JAX package's kernel in interpret mode.

* The plans: the frame's tiles (two output rows x 128 pixels, walked by a
  persistent grid), the strip kernel's (one strip row a tile, four strips an
  image) and the int8 conv1's (two cell rows x 64 cells per column half)
  cover every output pixel once, at S 176 / 192 / 256 / 320 / 512 and at
  ragged small S.
* The bf16 conv1's sample as the producer builds it: the 3 x 66 source
  pixels a TMA box lands (zeros outside the image), read with clamped
  indices, a 2 x 2 block of output pixels from the same four source pixels,
  zeros outside [0, 2S): bit-equal to the per-pixel formula, and equal to
  F.interpolate but for f32 rounding of the bilinear sum (one bf16 step on
  <= 1e-3 of elements).
* The f32 sums by (stage, tap, k-step) and the head's order (for c = 8k +
  2t + e, pairs, then k in turn, then a tree over t): the block against
  ``decoder_block_plain`` and, at S 16-32 / Cin 32-128, JAX's ``_dec_kernel``
  interpreted, within 2e-2 of the largest |logit| (kernel_check.REL_LIMIT:
  bf16 operands, f32 sums in another order, bf16 roundings between the
  convs); the head's order bit for bit against ``_head_i8``.
* int8, exact: the codes with their replicated border, conv1's polyphase
  sums over 2 cell rows x 64 cells x 128 columns tiles, the paste with the
  raw strips activated in the epilogue, the strip maxima gathered per cell
  row (each row into its strip and, at a strip's edge, its neighbour's
  halo), conv2's codes from a 64-byte swizzled landing slot: y1, the strip
  scales and the logits bit-equal to ``i8_parts_plain``.
* The strip pass: the sample rows across each strip lerped in f32 and
  rounded to bf16, then along it, bit-equal to ``border_strips``' rows; the
  strips (each tap's 16-channel sum taken alone, added in f32) against
  ``make_strips`` and JAX's ``make_strips`` by kernel_check.strips_ok: equal,
  or one bf16 step apart on <= 1e-3 of elements, the step of an element
  below 1/256 of its strip's peak being that of the peak / 256 (two f32
  sums of the same products in another order differ by f32 rounding of the
  large terms, many bf16 steps of a sum that cancels to near zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_decoder as jfd
from spegnet_tpu_torch import kernel_check as kc
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_decoder as tfd
from spegnet_tpu_torch.ops.fused_upsample_conv import _lerp2x_cols, upsample2x
from tests.test_torch_decoder_i8 import BF, _case, _jax_block, _jx, _port, capture  # noqa: F401

torch.set_num_threads(1)
SIZES = (176, 192, 256, 320, 512, 10, 20)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", SIZES)
def test_frame_plan_covers_every_pixel_once(s):
    b, h = 2, 2 * s
    seen = np.zeros((b, h, h), np.int32)
    tiles = list(kernels.dec_conv_tiles(b, h, h))
    for bi, y0, x0 in tiles:
        assert y0 % 2 == 0 and x0 % kernels.DEC_TC == 0
        seen[bi, y0:y0 + 2, x0:x0 + kernels.DEC_TC] += 1
    assert (seen == 1).all()
    plan = kernels.dec_conv_plan(b, h, h, 132)
    assert plan.tiles == len(tiles) and plan.grid == min(len(tiles), 132)


@pytest.mark.parametrize("s", SIZES)
def test_strip_plan_covers_every_strip_pixel_once(s):
    b, w = 2, 2 * s
    seen = np.zeros((4, b, w), np.int32)
    for bi, k, x0 in kernels.dec_conv_tiles(b, w, w, strip=True):
        seen[k, bi, x0:x0 + kernels.DEC_TC] += 1
    assert (seen == 1).all()
    assert kernels.dec_conv_plan(b, w, w, 132, strip=True).tiles == 4 * b * -(-w // 128)


@pytest.mark.parametrize("s", [16, 24] + [v for v in SIZES if v % 8 == 0])
def test_poly1_plan_covers_every_cell_once(s):
    b = 2
    seen = np.zeros((b, s, s), np.int32)
    for bi, i0, j0 in kernels.poly1_tiles(b, s):
        seen[bi, i0:i0 + 2, j0:j0 + kernels.POLY1_TC] += 1
    assert (seen == 1).all()
    plan = kernels.poly1_plan(b, s, 64, 132)
    assert plan.halves == 2 and plan.grid % 2 == 0 and plan.grid <= 132
    # the two column halves are (py = 0) and (py = 1): output rows 2i, 2i + 1
    assert 4 * 64 // kernels.POLY1_NT == plan.halves


# ---------------------------------------------------------------------------
# the bf16 conv1's sample
# ---------------------------------------------------------------------------

def _src(c: np.ndarray):
    """(x0, upper weight) of 2x bilinear output coordinates c (f32, as
    dc_src: max((c + 0.5) * 0.5 - 0.5, 0))."""
    sx = np.maximum((c.astype(np.float32) + np.float32(0.5)) * np.float32(0.5) - np.float32(0.5),
                    np.float32(0.0))
    x0 = sx.astype(np.int64)
    return x0, (sx - x0).astype(np.float32)


def build_up_tile(x: torch.Tensor, y0: int, x0: int) -> torch.Tensor:
    """The DC_UP producer's halo of one tile: x [S, S, C] bf16 -> [4, 130,
    C] bf16 at output rows y0 - 1 .. y0 + 2 and columns x0 - 1 .. x0 + 128,
    from the landing box (source rows y0/2 - 1 .., columns x0/2 - 1 .., TMA's
    zeros outside) read with clamped indices, 2 x 2 output pixels a unit."""
    s, c = x.shape[0], x.shape[2]
    w = 2 * s
    rbase, cbase = y0 // 2 - 1, x0 // 2 - 1
    land = torch.zeros((3, 66, c), dtype=torch.float32)
    for r in range(3):
        for q in range(66):
            if 0 <= rbase + r < s and 0 <= cbase + q < s:
                land[r, q] = x[rbase + r, cbase + q].float()
    out = torch.zeros((4, 130, c), dtype=BF)
    for hp in range(2):
        for m in range(65):
            ys = np.array([y0 - 1 + 2 * hp, y0 + 2 * hp])
            xs = np.array([x0 - 1 + 2 * m, x0 + 2 * m])
            mr, mc = (ys[0] - 1) // 2, (xs[0] - 1) // 2    # -1 at the top / left edge
            ra, rb = max(mr, 0) - rbase, min(mr + 1, s - 1) - rbase
            ca, cb = max(mc, 0) - cbase, min(mc + 1, s - 1) - cbase
            f = ((land[ra, ca], land[ra, cb]), (land[rb, ca], land[rb, cb]))
            _, ly = _src(ys)
            _, lx = _src(xs)
            for i in range(2):
                for j in range(2):
                    if not (0 <= ys[i] < w and 0 <= xs[j] < w):
                        continue
                    l0x, l1x = np.float32(1) - lx[j], lx[j]
                    h0 = l0x * f[0][0] + l1x * f[0][1]
                    h1 = l0x * f[1][0] + l1x * f[1][1]
                    out[2 * hp + i, 2 * m + j] = ((np.float32(1) - ly[i]) * h0 + ly[i] * h1).to(BF)
    return out


def sample_up(x: torch.Tensor) -> torch.Tensor:
    """The per-pixel formula of the sample for x [S, S, C]: [2S, 2S, C] bf16,
    ly0 (lx0 f00 + lx1 f01) + ly1 (lx0 f10 + lx1 f11) in f32, rounded once."""
    s = x.shape[0]
    o = np.arange(2 * s)
    y0, ly = _src(o)
    x0, lx = _src(o)
    y1, x1 = np.minimum(y0 + 1, s - 1), np.minimum(x0 + 1, s - 1)
    xf = x.float()
    ly, lx = torch.from_numpy(ly)[:, None, None], torch.from_numpy(lx)[None, :, None]
    f00, f01 = xf[y0][:, x0], xf[y0][:, x1]
    f10, f11 = xf[y1][:, x0], xf[y1][:, x1]
    h0 = (1 - lx) * f00 + lx * f01
    h1 = (1 - lx) * f10 + lx * f11
    return ((1 - ly) * h0 + ly * h1).to(BF)


@pytest.mark.parametrize("s,x0,y0", [(10, 0, 0), (10, 0, 18), (20, 0, 8), (70, 128, 0),
                                     (70, 0, 138), (100, 128, 100)])
def test_up_build_matches_the_sample(rng, s, x0, y0):
    x = torch.from_numpy(rng.standard_normal((s, s, 8)).astype(np.float32)).to(BF)
    got = build_up_tile(x, y0, x0)
    full = torch.zeros((2 * s + 2, 2 * s + 131, 8), dtype=BF)
    full[1:2 * s + 1, 1:2 * s + 1] = sample_up(x)
    want = full[y0:y0 + 4, x0:x0 + 130]
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [8, 16, 33])
def test_up_sample_matches_interpolate(rng, s):
    x = torch.from_numpy(rng.standard_normal((2, s, s, 16)).astype(np.float32)).to(BF)
    want = upsample2x(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = torch.stack([sample_up(x[i]) for i in range(2)])
    frac, steps = kc.bf16_steps(got, want)
    assert frac <= kc.I8_PART_FRAC and steps <= 1.0, (frac, steps)


# ---------------------------------------------------------------------------
# the bf16 block: f32 sums by (stage, tap, k-step), the head's order
# ---------------------------------------------------------------------------

def head_frame(y2: torch.Tensor, hw: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """dc_head: for c = 8k + 2t + e, part[t] = sum over k in turn of (y c hw c
    + y c+1 hw c+1), then ((p0 + p1) + (p2 + p3)) + hb, rounded to bf16."""
    v = (y2.float() * hw).unflatten(-1, (8, 4, 2))
    part = torch.zeros(v.shape[:-3] + (4,))
    for k in range(8):
        part = part + (v[..., k, :, 0] + v[..., k, :, 1])
    return ((part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3]) + hb).to(y2.dtype)


def conv_frame(a: torch.Tensor, wt: torch.Tensor, kstep: int) -> torch.Tensor:
    """The frame's f32 sums of a SAME 3x3 conv: a [B, H, W, C] bf16 (zero
    padded), wt [64, 9 C] bf16 with columns (dy, dx, ci) -> [B, H, W, 64] f32,
    summed chunk by chunk of ``kstep`` channels (a stage's k-steps), tap by
    tap, each k-step's dot products taken alone and added in f32."""
    b, h, w, c = a.shape
    ap = F.pad(a.float(), (0, 0, 1, 1, 1, 1))
    wf = wt.float().reshape(64, 3, 3, c)
    acc = torch.zeros((b, h, w, 64))
    for c0 in range(0, c, kstep):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            xs = ap[:, dy:dy + h, dx:dx + w, c0:c0 + kstep]
            acc = acc + xs @ wf[:, dy, dx, c0:c0 + kstep].t()
    return acc


def block_frame(x: torch.Tensor, p: tfd.DecoderParams) -> torch.Tensor:
    """Decoder block 2 as the bf16 kernels compute it: x [B, S, S, Cin] bf16
    -> logits [B, 2S, 2S, 1]."""
    s1, t1 = tfd.fold_bn(p.b1, *p.bn1)
    s2, t2 = tfd.fold_bn(p.b2, *p.bn2)
    up = torch.stack([sample_up(x[i]) for i in range(x.shape[0])])
    y1 = torch.relu(conv_frame(up, tfd._pack_conv_t(p.w1.to(BF)), 16) * s1 + t1).to(BF)
    y2 = torch.relu(conv_frame(y1, tfd._pack_conv_t(p.w2.to(BF)), 64) * s2 + t2).to(BF)
    return head_frame(y2, p.head_w.reshape(-1).float(), p.head_b.float())[..., None]


def test_head_order_is_the_int8_head(rng):
    y = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).to(BF)
    hw = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    hb = torch.from_numpy(rng.standard_normal(1).astype(np.float32))
    assert torch.equal(head_frame(y, hw, hb), tfd._head_i8(y, hw, hb))


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("s,cin", [(16, 32), (16, 64), (24, 128), (32, 128)])
def test_block_emulation_matches_plain(s, cin):
    g = torch.Generator().manual_seed(s + cin)
    p = kc.decoder_params(cin, 64, g, "cpu")
    x = torch.randn((2, s, s, cin), generator=g).to(BF)
    got = block_frame(x, p)
    want = tfd.decoder_block_plain(x, p)
    assert got.shape == want.shape
    assert _rel(got, want) <= kc.REL_LIMIT


@pytest.mark.parametrize("s,cin", [(16, 32), (32, 64)])
def test_block_emulation_matches_jax_kernel(rng, capture, s, cin):
    """JAX's bf16 kernel composes the upsample into its weights (bf16) and
    pastes separately computed strips: its bf16 tolerance, 6e-2 of
    max(|ref|, 1) (tests/test_torch_decoder.py)."""
    c = _case(rng, s=s, cin=cin, cm=64)
    p = _port(c)
    x = torch.from_numpy(c["x"]).to(BF)
    _, pred, _ = _jax_block(c, jnp.bfloat16, capture)
    got = block_frame(x, p)[..., 0].float().numpy()
    np.testing.assert_allclose(got, pred, rtol=0, atol=6e-2 * max(np.abs(pred).max(), 1.0))


# ---------------------------------------------------------------------------
# int8: exact
# ---------------------------------------------------------------------------

def poly1_frame(xq_pad, sx, q, raw, sh):
    """polyconv1_i8_kernel: tiles of 2 cell rows x 64 cells x 128 columns
    of exact integer sums over the padded codes, the dequant and the paste
    (the raw strips activated in the epilogue), the strip maxima per cell
    row.  Returns (y1 [B, 2S, 2S, Cm] bf16, amax [B, S / sh])."""
    b, sp, _, cin = xq_pad.shape
    s, cm = sp - 2, 64
    w1 = q.w1t.double()                                 # [4 Cm, 9 Cin], K (u, v, ci)
    y1 = torch.zeros((b, 2 * s, 2 * s, cm), dtype=BF)
    nsi = s // sh
    amax = torch.zeros((b, nsi))
    act = torch.relu(raw.float() * q.s1 + q.t1).to(BF)  # [4, B, 2S, Cm]
    for bi, i0, j0 in kernels.poly1_tiles(b, s):
        for r in range(2):
            i = i0 + r
            cells = np.arange(j0, min(j0 + 64, s))
            taps = [xq_pad[bi, i + u, cells + v].double() for u in range(3) for v in range(3)]
            acc = torch.cat(taps, 1) @ w1.t()          # [cells, 4 Cm] exact
            sc = sx[bi] * q.sw1                         # f32 products, one rounding
            out = torch.relu(acc.float() * sc + q.t1.repeat(4)).to(BF)
            out = out.reshape(len(cells), 2, 2, cm)     # (py, px, c)
            m_all = torch.zeros(())
            for py in range(2):
                row = 2 * i + py
                for px in range(2):
                    cols = 2 * torch.from_numpy(cells) + px
                    v = out[:, py, px].clone()
                    if row in (0, 2 * s - 1):
                        inner = (cols != 0) & (cols != 2 * s - 1)
                        edge = v[inner].float().max() if inner.any() else torch.zeros(())
                        k = 0 if row == 0 else nsi - 1
                        amax[bi, k] = torch.maximum(amax[bi, k], edge)
                        v = act[0 if row == 0 else 1, bi, cols].clone()
                    for side, cc in ((2, 0), (3, 2 * s - 1)):
                        at = cols == cc
                        if at.any():
                            v[at] = act[side, bi, row]
                    y1[bi, row, cols] = v
                    m_all = torch.maximum(m_all, v.float().max())
            si = i // sh
            for k in {si, si - 1 if i % sh == 0 else si, si + 1 if i % sh == sh - 1 else si}:
                if 0 <= k < nsi:
                    amax[bi, k] = torch.maximum(amax[bi, k], m_all)
    return y1, amax


def swizzle64(p: int, c: int) -> int:
    """The 16-byte chunk that chunk c of 64-byte row p occupies under TMA's
    64-byte swizzle (a slot aligned to 1024 bytes)."""
    return c ^ ((p >> 1) & 3)


def test_swizzle64_read_is_the_write():
    for p in range(520):
        assert sorted(swizzle64(p, c) for c in range(4)) == [0, 1, 2, 3]
        # dc_build_q8 reads chunk (2q + hv) of row p where TMA wrote it
        for c in range(4):
            assert swizzle64(p, c) == (c ^ ((p * 64 >> 7) & 3))


def conv2_frame(y1, sa, q, sh):
    """dec_conv_kernel<DC_Q8>: the codes of each tile's 4 x 130 halo with the
    strip scale of its output rows, exact sums, dequant, head."""
    b, h, w, cm = y1.shape
    ra = 1.0 / sa                                       # __fdiv_rn(1, s_a)
    w2 = q.w2q.double()
    pred = torch.zeros((b, h, w), dtype=BF)
    for bi, y0, x0 in kernels.dec_conv_tiles(b, h, w):
        k = y0 // (2 * sh)
        ypad = F.pad(y1[bi].float(), (0, 0, 1, 1, 1, 1))
        halo = ypad[y0:y0 + 4, x0:x0 + 130]
        codes = torch.round(halo * ra[bi, k]).double()
        for r in range(2):
            n = min(128, w - x0)
            taps = [codes[r + dy, dx:dx + n] for dy in range(3) for dx in range(3)]
            acc = torch.cat(taps, 1) @ w2.t()
            y2 = torch.relu(acc.float() * (sa[bi, k] * q.sw2) + q.t2).to(BF)
            pred[bi, y0 + r, x0:x0 + n] = head_frame(y2, q.hw, q.hb)
    return pred


@pytest.mark.parametrize("s", [16, 24, 32])
def test_int8_emulation_is_the_plain_int8_version(s):
    g = torch.Generator().manual_seed(s)
    x, q, _ = kc.dec_i8_inputs((s, 128, 64), 2, g, "cpu")
    sh = tfd.strip_height(s)
    want = tfd.i8_parts_plain(x, q)
    xq_pad = F.pad(want["xq"].permute(0, 3, 1, 2).float(), (1, 1, 1, 1),
                   mode="replicate").permute(0, 2, 3, 1).to(torch.int8)
    raw = torch.stack(tfd.make_strips(x, q.k1, dtype=x.dtype))
    y1, amax = poly1_frame(xq_pad, want["sx"], q, raw, sh)
    assert torch.equal(y1, want["y1"])
    sa = torch.clamp_min(amax * torch.tensor(1.0 / 127.0, dtype=torch.float32), 1e-12)
    assert torch.equal(sa, want["sa"])
    assert torch.equal(conv2_frame(y1, sa, q, sh), want["pred"])


# ---------------------------------------------------------------------------
# the strip pass
# ---------------------------------------------------------------------------

def strip_rows(x: torch.Tensor, o: int, edge: int) -> torch.Tensor:
    """dc_fill_strip's halo rows of strip (orientation o, edge 0 / 1) of x
    [B, S, S, C] bf16: [B, 3, 2S, C], the rows across the strip lerped in f32
    and rounded to bf16, then lerped along it and rounded again; zeros
    outside the 2S grid."""
    b, s = x.shape[:2]
    xt = x.transpose(1, 2) if o else x
    out = torch.zeros((b, 3, 2 * s, x.shape[3]), dtype=BF)
    for h in range(3):
        a = (h - 1) if edge == 0 else 2 * s - 2 + h
        if not 0 <= a < 2 * s:
            continue
        a0, l1 = _src(np.array([a]))
        a0, l1 = int(a0[0]), float(l1[0])
        a1 = min(a0 + 1, s - 1)
        f32 = torch.float32
        row = (torch.tensor(1 - l1, dtype=f32) * xt[:, a0].float()
               + torch.tensor(l1, dtype=f32) * xt[:, a1].float()).to(BF)
        out[:, h] = _lerp2x_cols(row[:, None])[:, 0]
    return out


def strips_frame(x: torch.Tensor, k1t: torch.Tensor) -> torch.Tensor:
    """dec_conv_kernel<DC_STRIP>: [4, B, 2S, 64] (top, bottom, left, right),
    each tap's 16-channel k-step summed alone and added in f32, rounded to
    bf16."""
    b, s, _, cin = x.shape
    wf = k1t.float().reshape(64, 3, 3, cin)
    out = []
    for o in (0, 1):
        for edge in (0, 1):
            rows = F.pad(strip_rows(x, o, edge).float(), (0, 0, 1, 1))
            acc = torch.zeros((b, 2 * s, 64))
            for c0 in range(0, cin, 16):
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    wtap = wf[:, dx, dy] if o else wf[:, dy, dx]
                    acc = acc + rows[:, dy, dx:dx + 2 * s, c0:c0 + 16] @ wtap[:, c0:c0 + 16].t()
            out.append(acc.to(BF))
    return torch.stack(out)


def test_strip_rows_are_border_strips_rows(rng):
    s = 12
    x = torch.from_numpy(rng.standard_normal((2, s, s, 8)).astype(np.float32)).to(BF)
    x32 = x.float()
    u_top = _lerp2x_cols(torch.stack([x32[:, 0], 0.75 * x32[:, 0] + 0.25 * x32[:, 1]], 1)
                         .to(BF))
    u_bot = _lerp2x_cols(torch.stack([0.25 * x32[:, -2] + 0.75 * x32[:, -1], x32[:, -1]], 1)
                         .to(BF))
    assert torch.equal(strip_rows(x, 0, 0)[:, 1:], u_top)
    assert torch.equal(strip_rows(x, 0, 1)[:, :2], u_bot)
    u_left = _lerp2x_cols(torch.stack([x32[:, :, 0], 0.75 * x32[:, :, 0] + 0.25 * x32[:, :, 1]],
                                      2).transpose(1, 2).to(BF))
    assert torch.equal(strip_rows(x, 1, 0)[:, 1:], u_left)
    assert not strip_rows(x, 0, 0)[:, 0].float().abs().sum()


@pytest.mark.parametrize("s,cin", [(16, 32), (24, 128)])
def test_strips_match_make_strips(s, cin):
    g = torch.Generator().manual_seed(s)
    x, q, _ = kc.dec_i8_inputs((s, cin, 64), 2, g, "cpu")
    got = strips_frame(x, q.k1t)
    want = torch.stack(tfd.make_strips(x, q.k1, dtype=x.dtype))
    assert kc.strips_ok(kc.strips_apart(got, want))
    jwant = jfd.make_strips(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                            jnp.asarray(q.k1.float().numpy(), jnp.bfloat16), dtype=jnp.bfloat16)
    b = x.shape[0]
    jt = np.asarray(jwant[0].astype(jnp.float32))[:, :, :2 * 64].reshape(1, b, 2 * s, 64)
    assert kc.strips_ok(kc.strips_apart(got[:1], torch.from_numpy(jt).to(BF)))


def test_strips_apart_reads_steps_against_the_strip_peak():
    """kernel_check.strips_apart: a difference at an element near zero
    counts in bf16 steps of 1/256 of its strip's peak (per image and
    channel); in steps of the element itself elsewhere."""
    want = torch.zeros((4, 1, 8, 64), dtype=BF)
    want[:, :, :, 0] = 2.0
    want[0, 0, 3, 0] = 1e-5
    got = want.clone()
    got[0, 0, 3, 0] = 1e-5 + 2.0 / 256 / 256        # far from 1e-5, within the peak's band
    res = kc.strips_apart(got, want)
    assert res["steps"] <= 1.0 and res["frac"] > 0
    got[0, 0, 3, 0] = 2.0 / 256 * 3 / 256          # 3 steps of the peak's 1/256
    assert kc.strips_apart(got, want)["steps"] > 1.0
    got = want.clone()
    got[0, 0, 5, 0] = 2.0 + 2 * 2.0 / 128          # 2 steps of the element itself
    assert kc.strips_apart(got, want)["steps"] > 1.0


@pytest.fixture(autouse=True)
def interpret_on(monkeypatch):
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    yield
