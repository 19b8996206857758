"""The Cm 128 form of the decoder conv frame (csrc/decoder_block.cu
``dec128_kernel``: the edge branch's conv1 over up2(x) + up4(ef), its conv2
with or without the head) on the CPU.

- The plan (kernels.dec128_plan / dec128_tiles): tiles of two rows x TC
  pixels, both consumers on every tile, consumer h the output channels
  64 h .. 64 h + 63, cover every output pixel and channel once, at
  kernel_check.DEC_EDGE's two geometries and at a small one; TC the width of
  DEC128_TCS that computes the fewest columns.
- The ring: each stage one chunk of 16 input channels, its packed weights
  (kernels.pack_dec128: [chunk][tap][2 planes][128 outputs][8 inputs]) and
  its halo; every weight chunk of x's and ef's (conv2: y1's) staged once a
  tile, in order, and the packed layout the one the kernel's descriptors
  read.
- The producer's landing slots: x's 3 x (TC/2 + 2) and ef's 3 x (TC/4 + 2)
  source pixels around a tile; every read the builders make of them, with
  clamped taps, stays in the slot and lands on the clamped source pixel;
  the samples built from them equal the per-pixel formula, and that
  formula F.interpolate's sample, up to one bf16 step on <= 1e-3.  The 4x
  build's units (2 x 2 blocks at even coordinates, which read one set of
  source pixels) cover every halo pixel of a tile once.
- The block as the kernels compute it (f32 sums by (stage, tap), BN + ReLU
  rounded to bf16, the head's two halves added) against
  ``decoder_block_plain`` within kernel_check.REL_LIMIT, with and without
  the head.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spegnet_tpu_torch import kernel_check as kc
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_decoder as tfd

torch.set_num_threads(1)
BF = torch.bfloat16
SMALL = (16, 64, 32, 128)
GEOMS = {**kc.DEC_EDGE, "small": SMALL}


@pytest.mark.parametrize("name", list(GEOMS))
def test_plan_covers_every_pixel_and_channel_once(name):
    s = GEOMS[name][0]
    b, h = 2, 2 * s
    plan = kernels.dec128_plan(b, h, h, 132)
    tiles = list(kernels.dec128_tiles(b, h, h, plan.tc))
    assert plan.tiles == len(tiles) and plan.grid == min(len(tiles), 132)
    seen = np.zeros((b, h, h, 2), np.int32)   # the two consumers' channel halves
    for bi, y0, x0 in tiles:
        assert y0 % 2 == 0 and x0 % plan.tc == 0
        for half in range(2):
            seen[bi, y0:y0 + 2, x0:x0 + plan.tc, half] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("w,tc", [(256, 128), (192, 96), (32, 96), (64, 96), (96, 96),
                                  (128, 128), (384, 128), (288, 96), (640, 128)])
def test_tile_width_computes_the_fewest_columns(w, tc):
    assert kernels.dec128_plan(1, 2, w, 132).tc == tc


def stages(name: str, conv2: bool = False):
    """The weight chunks each block's producer stages, tile by tile, as
    ``weights(ch)`` picks them: ("x", k) / ("ef", k) (conv2: ("y1", k))."""
    _, cin, ce, cm = GEOMS[name]
    if conv2:
        cin, ce = cm, 0
    nx, nch = cin // 16, cin // 16 + ce // 16
    s = GEOMS[name][0]
    plan = kernels.dec128_plan(2, 2 * s, 2 * s, 132)
    walk = {}
    for blk in range(plan.grid):
        for tile in range(blk, plan.tiles, plan.grid):
            walk[tile] = [("y1" if conv2 else "x", ch) if ch < nx else ("ef", ch - nx)
                          for ch in range(nch)]
    return walk, cin, ce


@pytest.mark.parametrize("conv2", [False, True])
@pytest.mark.parametrize("name", list(GEOMS))
def test_every_weight_chunk_staged_once_per_tile(name, conv2):
    walk, cin, ce = stages(name, conv2)
    s = GEOMS[name][0]
    assert len(walk) == kernels.dec128_plan(2, 2 * s, 2 * s, 132).tiles
    want = [("y1" if conv2 else "x", k) for k in range(cin // 16)] + [("ef", k)
                                                                        for k in range(ce // 16)]
    for seq in walk.values():
        assert seq == want


def test_pack_layout_is_the_stage_layout(rng):
    """packed[ch, tap, p, co, e] = w[co, 16 ch + 8 p + e, dy, dx]: a stage is
    9 taps x 2 planes x 128 outputs x 16 bytes, consumer h's A operand the
    64 rows from byte 1024 h of a tap's plane, its next 16 bytes of K the
    second plane (2048 bytes on)."""
    w = torch.from_numpy(rng.standard_normal((128, 48, 3, 3)).astype(np.float32))
    pk = kernels.pack_dec128(w)
    assert tuple(pk.shape) == (3, 9, 2, 128, 8) and pk.is_contiguous()
    for ch in range(3):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for p in range(2):
                want = w[:, 16 * ch + 8 * p:16 * ch + 8 * p + 8, dy, dx]
                assert torch.equal(pk[ch, tap, p], want)
    flat = pk.reshape(-1, 8)    # 16-byte rows
    assert torch.equal(flat[(9 * 2 * 128) * 1 + 4 * 2 * 128 + 1 * 128 + 70],
                       w[70, 16 + 8:16 + 16, 1, 1])
    with pytest.raises(ValueError):
        kernels.pack_dec128(torch.zeros(64, 16, 3, 3))


def _src(c: np.ndarray, f: float):
    """(x0, upper weight) of bilinear output coordinates c at factor 1 / f
    (f32, max((c + 0.5) f - 0.5, 0))."""
    sx = np.maximum((c.astype(np.float32) + np.float32(0.5)) * np.float32(f) - np.float32(0.5),
                    np.float32(0.0))
    x0 = sx.astype(np.int64)
    return x0, (sx - x0).astype(np.float32)


def landing_reads(s: int, y0: int, x0: int, tc: int, k: int):
    """The builders' reads of a landing slot for the tile at (y0, x0), at
    factor k (2: x's slot, 4: ef's), for every halo pixel inside the 2S
    grid: (slot row, slot column) of each clamped tap and the source pixel
    it must hold, [n, 4, 2] each."""
    src, w = 2 * s // k, 2 * s
    rbase, cbase = y0 // k - 1, x0 // k - 1
    ys = np.arange(y0 - 1, y0 + 3)
    xs = np.arange(x0 - 1, x0 + tc + 1)
    ys, xs = ys[(ys >= 0) & (ys < w)], xs[(xs >= 0) & (xs < w)]
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    y_0, _ = _src(yy.ravel(), 1.0 / k)
    x_0, _ = _src(xx.ravel(), 1.0 / k)
    y_1, x_1 = np.minimum(y_0 + 1, src - 1), np.minimum(x_0 + 1, src - 1)
    rows = np.stack([y_0, y_0, y_1, y_1], 1)
    cols = np.stack([x_0, x_1, x_0, x_1], 1)
    return np.stack([rows - rbase, cols - cbase], -1), np.stack([rows, cols], -1)


@pytest.mark.parametrize("name", list(GEOMS))
def test_landing_reads_stay_in_the_slot(name):
    """Every tile's reads of x's (2x) and ef's (4x) landing slot fall inside
    the TMA box (3 rows x TC/2 + 2 or TC/4 + 2 columns) on the clamped
    source pixel the box put there."""
    s = GEOMS[name][0]
    plan = kernels.dec128_plan(1, 2 * s, 2 * s, 132)
    for _, y0, x0 in kernels.dec128_tiles(1, 2 * s, 2 * s, plan.tc):
        for k in (2, 4):
            slot, src = landing_reads(s, y0, x0, plan.tc, k)
            lw = plan.tc // k + 2
            assert (slot[..., 0] >= 0).all() and (slot[..., 0] < 3).all()
            assert (slot[..., 1] >= 0).all() and (slot[..., 1] < lw).all()
            box0 = np.array([y0 // k - 1, x0 // k - 1])
            assert ((slot + box0) == src).all()
            assert (src >= 0).all() and (src < 2 * s // k).all()


@pytest.mark.parametrize("s", [8, 16, 96, 128])
def test_4x_pairs_share_their_source(s):
    """An even-aligned pair of outputs (2k, 2k + 1) at 4x has one clamped
    source pair (y0, min(y0 + 1, S/2 - 1)), from -2 (the halo's top-left
    pair) to past the grid."""
    o = np.arange(-2, 2 * s + 4, 2)
    y_a, _ = _src(o, 0.25)
    y_b, _ = _src(o + 1, 0.25)
    assert (y_a == y_b).all()


@pytest.mark.parametrize("name", list(GEOMS))
def test_4x_units_cover_the_halo_once(name):
    """e_build_up4's units, (row pair hp, column pair m) at Y0 = y0 - 2 + 2
    hp, X0 = x0 - 2 + 2 m for hp < 3, m < TC/2 + 2, writing their pixels
    inside the halo (rows y0 - 1 .. y0 + 2, columns x0 - 1 .. x0 + TC), cover
    every halo pixel of every tile once."""
    s = GEOMS[name][0]
    plan = kernels.dec128_plan(1, 2 * s, 2 * s, 132)
    tc = plan.tc
    hp, m, i, j = np.meshgrid(np.arange(3), np.arange(tc // 2 + 2), np.arange(2), np.arange(2),
                              indexing="ij")
    for _, y0, x0 in list(kernels.dec128_tiles(1, 2 * s, 2 * s, tc))[:8]:
        yy = (y0 - 2 + 2 * hp + i).ravel()
        xx = (x0 - 2 + 2 * m + j).ravel()
        keep = (yy >= y0 - 1) & (yy <= y0 + 2) & (xx >= x0 - 1) & (xx <= x0 + tc)
        seen = np.zeros((4, tc + 2), np.int32)
        np.add.at(seen, (yy[keep] - (y0 - 1), xx[keep] - (x0 - 1)), 1)
        assert (seen == 1).all()


def sample(x: torch.Tensor, k: int) -> torch.Tensor:
    """The builders' sample of x [S', S', C] at factor k: [k S', k S', C]
    bf16, ly0 (lx0 f00 + lx1 f01) + ly1 (lx0 f10 + lx1 f11) in f32, rounded
    once (e_build_up2 shares the row sums of a 2 x 2 block, the same
    products in the same order)."""
    s = x.shape[0]
    o = np.arange(k * s)
    y0, ly = _src(o, 1.0 / k)
    x0, lx = _src(o, 1.0 / k)
    y1, x1 = np.minimum(y0 + 1, s - 1), np.minimum(x0 + 1, s - 1)
    xf = x.float()
    ly, lx = torch.from_numpy(ly)[:, None, None], torch.from_numpy(lx)[None, :, None]
    h0 = (1 - lx) * xf[y0][:, x0] + lx * xf[y0][:, x1]
    h1 = (1 - lx) * xf[y1][:, x0] + lx * xf[y1][:, x1]
    return ((1 - ly) * h0 + ly * h1).to(BF)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("s", [8, 16, 24])
def test_sample_matches_interpolate(rng, s, k):
    x = torch.from_numpy(rng.standard_normal((s, s, 16)).astype(np.float32)).to(BF)
    want = F.interpolate(x.permute(2, 0, 1)[None].float(), size=(k * s, k * s),
                         mode="bilinear", align_corners=False)[0].permute(1, 2, 0).to(BF)
    frac, steps = kc.bf16_steps(sample(x, k), want)
    assert frac <= kc.I8_PART_FRAC and steps <= 1.0, (frac, steps)


def conv128(a: torch.Tensor, packed: torch.Tensor, acc=None) -> torch.Tensor:
    """The kernel's f32 sums of a SAME 3x3 conv over a [B, H, W, C] bf16
    with pack_dec128 weights: stage by stage (16 channels), tap by tap."""
    b, h, w, c = a.shape
    ap = F.pad(a.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h, w, 128)) if acc is None else acc
    for ch in range(c // 16):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            wk = packed[ch, tap].float().permute(1, 0, 2).reshape(128, 16)   # [co, ci]
            acc = acc + ap[:, dy:dy + h, dx:dx + w, 16 * ch:16 * ch + 16] @ wk.t()
    return acc


def block128(x, ef, p: tfd.DecoderParams) -> torch.Tensor:
    """The edge branch as the Cm 128 kernels compute it."""
    s1, t1 = tfd.fold_bn(p.b1, *p.bn1)
    s2, t2 = tfd.fold_bn(p.b2, *p.bn2)
    up = torch.stack([sample(v, 2) for v in x])
    ue = torch.stack([sample(v, 4) for v in ef])
    acc = conv128(up, kernels.pack_dec128(p.w1.to(BF)))
    acc = conv128(ue, kernels.pack_dec128(p.we.to(BF)), acc)
    y1 = torch.relu(acc * s1 + t1).to(BF)
    y2 = torch.relu(conv128(y1, kernels.pack_dec128(p.w2.to(BF))) * s2 + t2).to(BF)
    if p.head_w is None:
        return y2
    hw = p.head_w.reshape(-1).float()
    halves = [(y2[..., 64 * h:64 * h + 64].float() * hw[64 * h:64 * h + 64]).sum(-1)
              for h in range(2)]
    return ((halves[0] + halves[1]) + p.head_b.float()).to(BF)[..., None]


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("geom", [(8, 32, 16, 128), (12, 16, 32, 128)])
def test_block_emulation_matches_plain(geom, head):
    s, cin, ce, cm = geom
    g = torch.Generator().manual_seed(3)
    p = kc.decoder_params(cin, cm, g, "cpu", ce=ce, head=head)
    x = torch.randn((2, s, s, cin), generator=g).to(BF)
    ef = torch.randn((2, s // 2, s // 2, ce), generator=g).to(BF)
    got = block128(x, ef, p)
    want = tfd.decoder_block_plain(x, p, ef)
    assert got.shape == want.shape
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert rel <= kc.REL_LIMIT, rel
