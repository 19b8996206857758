"""PED decoder blocks (port of spegnet_tpu/ops/fused_decoder.py).

A decoder block is ``2x bilinear upsample -> conv3x3 (+ the 4x-upsampled
edge branch) -> BN -> ReLU -> conv3x3 -> BN -> ReLU (-> 1x1 head)``.  Block
2 (no edge branch, with its head) runs at the input resolution (256 -> 512
at 512^2 input).  Layout is channels-last, as in the JAX package: x
[B, S, S, Cin] -> prediction logits [B, 2S, 2S, 1], or the block's output
[B, 2S, 2S, Cm] when it has no head.

:func:`fused_decoder_block` takes the plain version for a CPU tensor and,
for a CUDA tensor, the Hopper kernels that replace the TPU kernel
``_dec_kernel`` (:338):

* bf16, no edge branch (block 2): csrc/decoder_block.cu on the TMA + wgmma
  frame of csrc/decoder_conv.cuh, exact upsample then convolve
  (:func:`decoder_block_plain`);
* bf16 with the edge branch (block 1's geometry; no model route sends a
  block there, as in the JAX package): csrc/decoder_block.cu's Cm 128 form
  of the frame (TMA + wgmma, the weights streamed through its ring) with
  the 4x bilinear sample of the edge features as conv1's second input;
* ``int8=True`` (the W8A8 speed mode, ``model.int8_decoder``): a different
  model, defined on the TPU kernel's polyphase form -- x quantized per
  image, conv1 on the composed ``[9 Cin, 4 Cm]`` weights over edge-clamped
  source cells, the exact border strips pasted, conv2 on codes with one
  activation scale per strip of ``sh`` cell rows (:func:`i8_parts_plain`
  for the arithmetic) -- in csrc/decoder_i8.cu, the border strips too
  (:func:`make_strips` is their plain version).  The TPU takes it only where
  :func:`int8_supported` holds (:582-585 with the model's bf16 gate).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.fused_block_i8 import quantize_cols
from spegnet_tpu_torch.ops.fused_block_t_i8 import _scale, quantize_rows
from spegnet_tpu_torch.ops.fused_upsample_conv import (
    border_strips,
    compose_kernel,
    upsample2x_conv3x3,
)
from spegnet_tpu_torch.ops.resize import resize_bilinear


def fold_bn(bias: Optional[torch.Tensor], gamma: torch.Tensor,
            beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN folded over a preceding conv bias: (s, t) in f32 with
    relu(bn(conv + bias)) == relu(conv * s + t)."""
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    b = 0.0 if bias is None else bias.float()
    t = (b - mean.float()) * s + beta.float()
    return s, t


class DecoderParams(NamedTuple):
    """One decoder block's parameters in torch layouts; bn1/bn2 are (gamma,
    beta, mean, var, eps).  ``head_w`` / ``head_b`` are None for a block
    without its head; ``we`` is the edge branch's part of conv1."""

    w1: torch.Tensor                    # [Cm, Cin, 3, 3]
    b1: torch.Tensor                    # [Cm]
    bn1: tuple
    w2: torch.Tensor                    # [Cm, Cm, 3, 3]
    b2: torch.Tensor
    bn2: tuple
    head_w: Optional[torch.Tensor]      # [1, Cm, 1, 1]
    head_b: Optional[torch.Tensor]      # [1]
    we: Optional[torch.Tensor] = None   # [Cm, Ce, 3, 3]


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> [3, 3, Cin, Cout] (the JAX package's layout)."""
    return w.permute(2, 3, 1, 0)


def _bn_relu(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.relu(y.float() * s[:, None, None] + t[:, None, None]).to(y.dtype)


def decoder_block_plain(x: torch.Tensor, p: DecoderParams,
                        ef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, S, Cin] (edge features ef [B, He, He, Ce] iff ``p.we``) ->
    logits [B, 2S, 2S, 1], or the block output [B, 2S, 2S, Cm] without a
    head.  As the JAX ``decoder_block_reference`` (:748): each conv's output
    is rounded to the compute dtype, the edge conv's too before it is added,
    and each BN + ReLU rounds once more."""
    dt = x.dtype
    s = x.shape[1]
    y = upsample2x_conv3x3(x.permute(0, 3, 1, 2), p.w1.to(dt))
    if p.we is not None:
        e = resize_bilinear(ef, (2 * s, 2 * s)).to(dt).permute(0, 3, 1, 2)
        y = y + F.conv2d(e, p.we.to(dt), padding=1)
    y = _bn_relu(y, *fold_bn(p.b1, *p.bn1))
    y2 = F.conv2d(y, p.w2.to(dt), padding=1)
    y2 = _bn_relu(y2, *fold_bn(p.b2, *p.bn2))
    if p.head_w is None:
        return y2.permute(0, 2, 3, 1)
    pred = (torch.einsum("bchw,c->bhw", y2.float(), p.head_w.reshape(-1).float())
            + p.head_b.float())
    return pred.to(dt)[..., None]


def _pack_conv_t(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> [Cout, 9*Cin], columns tap-major (dy, dx, ci):
    the K-major weights of csrc/decoder_conv.cuh."""
    cout, cin = w.shape[:2]
    return w.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()


def decoder_supported(s: int) -> bool:
    """Shape rule of the JAX package's decoder gate (``decoder_supported``
    :689) for x1 [B, S, S, Cin]: S a multiple of its strip height (16 from
    S = 256, else 8) and at least two strips (every input side that is a
    multiple of 32 passes)."""
    sh = strip_height(s)
    return s % sh == 0 and s >= 2 * sh


def strip_height(s: int) -> int:
    """The TPU kernel's default strip height in cell rows (:586-587)."""
    return 16 if s >= 256 else 8


def _strips_of(s: int) -> int:
    """The strip height at S, which must tile S in two or more strips."""
    sh = strip_height(s)
    if not decoder_supported(s):
        raise ValueError(f"strip height {sh} does not tile S={s} in two or more strips")
    return sh


def int8_supported(cin: int, has_edge: bool, dtype: torch.dtype) -> bool:
    """Whether ``int8=True`` runs the W8A8 block on the TPU: a bf16 block
    (the model's fused-path gate, spegnet_tpu/models/ped.py:246-257) with
    no edge branch and Cin a multiple of 128 (the hardware branch of
    :582-585; interpret mode skips the Cin rule, the port does not)."""
    return dtype == torch.bfloat16 and not has_edge and cin % 128 == 0


# ---------------------------------------------------------------------------
# The TPU kernel's packed weights and border strips
# ---------------------------------------------------------------------------

def pack_w1(k3: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO [3, 3, Cin, Cm] -> [9*Cin, 4*Cm] polyphase upsample+conv weights
    (``pack_w1`` :126): rows (u, v, ci) over the 3x3 source cells, columns
    (py, px, co) -- output pixel (2i+py, 2j+px) of cell (i, j)."""
    ke = compose_kernel(k3)
    cin, cm = k3.shape[2], k3.shape[3]
    rows = [torch.cat([ke[2 * u + 1 - py, 2 * v + 1 - px] for py in (0, 1) for px in (0, 1)],
                      -1) for u in range(3) for v in range(3)]
    return torch.cat(rows, 0).reshape(9 * cin, 4 * cm).to(dtype)


def pack_w2(k2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO [3, 3, Cm, Co] -> [12*Cm, 2*Co] phase-space weights (``pack_w2``
    :143): rows (dy, b, ci) over 4 source columns b, columns (px', co);
    column px' holds tap dx = b - px' and zeros where that is outside 0..2."""
    cm, co = k2.shape[2], k2.shape[3]
    k2 = k2.float()
    w = torch.zeros((3, 4, cm, 2, co), dtype=torch.float32, device=k2.device)
    w[:, 0:3, :, 0] = k2
    w[:, 1:4, :, 1] = k2
    return w.reshape(12 * cm, 2 * co).to(dtype)


class PackedParams(NamedTuple):
    """The TPU kernel's packed block parameters (``DecParams`` :201, without
    the edge branch): BN scales folded into the weight columns in f32, then
    cast to the compute dtype."""

    w1: torch.Tensor             # [9*Cin, 4*Cm]
    w2: torch.Tensor             # [12*Cm, 2*Cm]
    s1t1: torch.Tensor           # [2, 4*Cm] f32 rows (scale, offset), lanes (py, px, c)
    s2t2: torch.Tensor           # [2, 2*Cm] f32
    h2: Optional[torch.Tensor]   # [2*Cm, 2] block-diagonal head weights
    hb: Optional[torch.Tensor]   # [1, 2] f32 head bias


def pack_params(p: DecoderParams, dtype: torch.dtype = torch.bfloat16) -> PackedParams:
    """``pack_params`` (:213-243) of a block without an edge branch."""
    cm = p.w1.shape[0]
    s1, t1 = fold_bn(p.b1, *p.bn1)
    s2, t2 = fold_bn(p.b2, *p.bn2)
    h2 = hb = None
    if p.head_w is not None:
        hw = p.head_w.reshape(-1).to(dtype)
        z = torch.zeros_like(hw)
        h2 = torch.stack([torch.cat([hw, z]), torch.cat([z, hw])], 1)
        hb = p.head_b.float().reshape(1, -1).expand(1, 2).contiguous()
    return PackedParams(
        w1=(pack_w1(_hwio(p.w1), torch.float32) * s1.repeat(4)).to(dtype),
        w2=(pack_w2(_hwio(p.w2), torch.float32) * s2.repeat(2)).to(dtype),
        s1t1=torch.stack([s1.repeat(4), t1.repeat(4)]),
        s2t2=torch.stack([s2.repeat(2), t2.repeat(2)]),
        h2=h2, hb=hb)


def make_strips(x: torch.Tensor, k1: torch.Tensor, k_edge: Optional[torch.Tensor] = None,
                ef: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.bfloat16):
    """Exact outermost rows and columns of the block's conv1 output before
    its bias (``make_strips`` :251), for NHWC x and HWIO kernels: (top,
    bottom, left, right), each [B, 2S, Cm] in ``dtype`` -- output row 0 and
    row 2S-1 over all columns, column 0 and column 2S-1 over all rows.  (The
    JAX package tiles the same values into its kernel's lane order.)  With
    the edge branch, ``conv3x3(resize4(ef))``'s border rows and columns are
    added, each rounded to x.dtype first."""
    y_top, y_bot, y_left, y_right = border_strips(x, k1)
    if k_edge is not None:
        dt = x.dtype
        s = x.shape[1]
        e = resize_bilinear(ef, (2 * s, 2 * s)).to(dt)

        def econv(part, k, pad_h, pad_w):
            y = F.conv2d(part.permute(0, 3, 1, 2), k.to(dt).permute(3, 2, 0, 1),
                         padding=(pad_h, pad_w))
            return y.permute(0, 2, 3, 1).to(dt)

        y_top = y_top + econv(e[:, 0:2], k_edge[1:3], 0, 1)
        y_bot = y_bot + econv(e[:, -2:], k_edge[0:2], 0, 1)
        y_left = y_left + econv(e[:, :, 0:2], k_edge[:, 1:3], 1, 0)
        y_right = y_right + econv(e[:, :, -2:], k_edge[:, 0:2], 1, 0)
    return (y_top[:, 0].to(dtype), y_bot[:, 0].to(dtype), y_left[:, :, 0].to(dtype),
            y_right[:, :, 0].to(dtype))


def activate_strips(strips, s1: torch.Tensor, t1: torch.Tensor,
                    dt: torch.dtype) -> torch.Tensor:
    """The strips after conv1's folded BN + ReLU (:595-600; elementwise, so
    pasting commutes with it): [4, B, 2S, Cm] in ``dt``, in the order (top,
    bottom, left, right)."""
    return torch.stack([torch.relu(v.float() * s1 + t1).to(dt) for v in strips])


# ---------------------------------------------------------------------------
# int8 (W8A8) mode
# ---------------------------------------------------------------------------

class DecoderI8(NamedTuple):
    """Block-2 parameters of the int8 mode.  The weight codes are
    ``quantize_cols`` of the bf16 packed weights (:606-607); conv2's are
    laid out for a plain SAME conv on the 2S grid: ``pack_w2``'s two column
    halves hold the same values, so their per-column scales are the
    per-output-channel scales ``sw2`` (tests/test_torch_decoder_i8.py)."""

    k1: torch.Tensor     # [3, 3, Cin, Cm] conv1 in the compute dtype (border strips)
    s1: torch.Tensor     # [Cm] f32 folded BN scale of conv1 (strips)
    t1: torch.Tensor     # [Cm] f32 folded BN offset of conv1
    w1t: torch.Tensor    # [4*Cm, 9*Cin] int8: columns (py, px, c) as rows, K (u, v, ci)
    sw1: torch.Tensor    # [4*Cm] f32
    w2q: torch.Tensor    # [Cm_out, 9*Cm] int8, columns (dy, dx, ci)
    sw2: torch.Tensor    # [Cm_out] f32
    t2: torch.Tensor     # [Cm] f32
    hw: torch.Tensor     # [Cm] f32 values of the compute-dtype head weights
    hb: torch.Tensor     # [1] f32
    k1t: torch.Tensor    # [Cm, 9*Cin] k1 with columns (dy, dx, ci) (the strip kernel's)


def params_to(p: DecoderParams, device) -> DecoderParams:
    """``p`` with its tensors on ``device``."""
    def mv(v):
        return v.to(device) if torch.is_tensor(v) else v
    return DecoderParams(*(tuple(map(mv, f)) if isinstance(f, tuple) else mv(f) for f in p))


def pack_i8(p: DecoderParams, dtype: torch.dtype = torch.bfloat16) -> DecoderI8:
    """Pack a head-carrying block without an edge branch for the int8 mode.
    The packing runs on the CPU, so the codes are the same whatever device
    the block lies on (its BN fold's rsqrt rounds by device)."""
    if p.head_w is None or p.we is not None:
        raise ValueError("the int8 decoder block needs a head and no edge branch")
    device = p.w1.device
    p = params_to(p, "cpu")
    pk = pack_params(p, dtype)
    cm = p.w1.shape[0]
    w1q, sw1 = quantize_cols(pk.w1)
    w2q, sw2 = quantize_cols(pk.w2)
    w2q = w2q.reshape(3, 4, cm, 2, cm)[:, 0:3, :, 0].permute(3, 0, 1, 2)
    q = DecoderI8(k1=_hwio(p.w1).to(dtype), s1=pk.s1t1[0, :cm], t1=pk.s1t1[1, :cm],
                  w1t=w1q.t(), sw1=sw1, w2q=w2q.reshape(cm, 9 * cm), sw2=sw2[:cm],
                  t2=pk.s2t2[1, :cm], hw=pk.h2[:cm, 0].float(), hb=p.head_b.float().reshape(1),
                  k1t=_pack_conv_t(p.w1.to(dtype)))
    return DecoderI8(*(v.to(device).contiguous() for v in q))


def quantize_image(x: torch.Tensor):
    """x [B, ...] -> (int8 codes, f32 scales [B]): one symmetric scale per
    image, ``max(absmax * f32(1/127), 1e-12)``, and codes ``round(x / s)``
    by a true division, ties to even (:611-614)."""
    q, s = quantize_rows(x.reshape(x.shape[0], -1))
    return q.reshape(x.shape), s


def _conv3x3_exact(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer sums of a VALID 3x3 conv: codes [N, H+2, W+2, C]
    (padded), wq [Co, 9*C] with columns (dy, dx, ci) -> f64 [N, H, W, Co],
    one input at a time through an f64 matmul (|sum| <= 127^2 * 9C < 2^53)."""
    n, hp, wp, c = codes.shape
    co = wq.shape[0]
    w = wq.reshape(co, 3, 3, c).permute(3, 1, 2, 0).reshape(c * 9, co).double()
    out = []
    for i in range(n):
        cols = F.unfold(codes[i:i + 1].permute(0, 3, 1, 2).double(), 3)  # (ci, dy, dx)
        out.append((cols[0].t() @ w).reshape(hp - 2, wp - 2, co))
    return torch.stack(out)


def _s2d_to_nhwc(y: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 4*Cm] with lanes (py, px, c) -> [B, 2S, 2S, Cm]."""
    b, s, _, c4 = y.shape
    cm = c4 // 4
    return y.reshape(b, s, s, 2, 2, cm).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * s, 2 * s, cm)


def _paste(y1: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Paste the activated strips over conv1's map; left and right last, so
    they win at the corners (:466-482)."""
    y = y1.clone()
    y[:, 0], y[:, -1] = act[0], act[1]
    y[:, :, 0], y[:, :, -1] = act[2], act[3]
    return y


def i8_parts_plain(x: torch.Tensor, q: DecoderI8) -> Dict[str, torch.Tensor]:
    """The TPU kernel's int8 arithmetic (``_dec_kernel`` with ``int8=True``)
    in plain PyTorch, with exact integer sums, for x [B, S, S, Cin]:

    * ``xq``, ``sx``: the per-image codes and scales (:func:`quantize_image`);
    * ``y1``: conv1's activated map [B, 2S, 2S, Cm] after the border paste:
      ``relu(acc * (sx[b] * sw1[n]) + t1)`` in bf16, acc the exact sum over
      the 3x3 edge-clamped source cells of the codes;
    * ``sa`` [B, S / sh]: conv2's activation scale of each strip of sh cell
      rows (sh = :func:`strip_height`), ``max(amax / 127, 1e-12)`` with amax over everything the TPU
      kernel's ``a_ref`` holds: the strip's output rows, one cell row (two
      output rows) of halo above and below, and in the first (last) strip
      the halo slot of cell -1 (S), which holds the clamped cell's unpasted
      row 0 (2S-1) but for its two outermost columns;
    * ``y2``: conv2 as a SAME conv on the 2S grid of ``round(a * (1 / sa))``,
      each strip's rows with its own scale, ``relu(acc * (sa * sw2) + t2)``
      in bf16; ``pred`` [B, 2S, 2S]: ``y2 . hw + hb`` rounded to bf16."""
    b, s, _, cin = x.shape
    cm = q.t1.numel()
    sh = _strips_of(s)
    dt = x.dtype
    xq, sx = quantize_image(x)
    xp = F.pad(xq.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="replicate")
    acc1 = _conv3x3_exact(xp.permute(0, 2, 3, 1), q.w1t)          # [B, S, S, 4Cm]
    sc1 = sx[:, None, None, None] * q.sw1
    y1i = _s2d_to_nhwc(torch.relu(acc1.float() * sc1 + q.t1.repeat(4)).to(dt))
    act = activate_strips(make_strips(x, q.k1, dtype=dt), q.s1, q.t1, dt)
    y1 = _paste(y1i, act)

    nsi, h2 = s // sh, 2 * s
    y1f, y1if = y1.float(), y1i.float()
    sa = torch.empty((b, nsi), dtype=torch.float32, device=x.device)
    y2 = torch.empty_like(y1)
    for si in range(nsi):
        r0, r1 = 2 * si * sh, 2 * (si + 1) * sh      # the strip's output rows
        amax = y1f[:, max(r0 - 2, 0):min(r1 + 2, h2)].abs().amax((1, 2, 3))
        if si == 0:
            amax = torch.maximum(amax, y1if[:, 0, 1:h2 - 1].amax((1, 2)))
        if si == nsi - 1:
            amax = torch.maximum(amax, y1if[:, h2 - 1, 1:h2 - 1].amax((1, 2)))
        sa[:, si] = _scale(amax)
        ra = 1.0 / sa[:, si]
        rows = F.pad(y1f[:, max(r0 - 1, 0):min(r1 + 1, h2)].permute(0, 3, 1, 2),
                     (1, 1, int(r0 == 0), int(r1 == h2)))
        codes = torch.round(rows * ra[:, None, None, None])
        acc2 = _conv3x3_exact(codes.permute(0, 2, 3, 1), q.w2q)
        sc2 = sa[:, si, None, None, None] * q.sw2
        y2[:, r0:r1] = torch.relu(acc2.float() * sc2 + q.t2).to(dt)
    return {"xq": xq, "sx": sx, "y1": y1, "sa": sa, "y2": y2, "pred": _head_i8(y2, q.hw, q.hb)}


def _head_i8(y2: torch.Tensor, hw: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """The int8 block's 1x1 head in f32, summed in the order of
    csrc/decoder_i8.cu's epilogue so that the two agree bit for bit: for
    channels c = 8k + 2t + e, the products of each pair e, then the pairs
    over k in turn, then the four sums over t as a tree; + hb, rounded to
    y2's dtype."""
    pr = (y2.float() * hw).unflatten(-1, (-1, 4, 2))
    pairs = pr[..., 0] + pr[..., 1]
    part = pairs[..., 0, :]
    for k in range(1, pairs.shape[-2]):
        part = part + pairs[..., k, :]
    return ((part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3]) + hb).to(y2.dtype)


def decoder_block_i8_plain(x: torch.Tensor, q: DecoderI8) -> torch.Tensor:
    """The int8 block (:func:`i8_parts_plain`): logits [B, 2S, 2S, 1]."""
    return i8_parts_plain(x, q)["pred"][..., None]


def i8_parts_cuda(x: torch.Tensor, q: DecoderI8,
                  strips: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The int8 block through the kernels of csrc/decoder_i8.cu, with the
    intermediate results of :func:`i8_parts_plain` but ``y2``: the per-image
    quant (its codes written with a replicated border, conv1's edge-clamped
    cells; ``xq`` is their interior), the raw border strips [4, B, 2S, Cm]
    (``strips``, given or from the strip kernel), conv1 with the strips
    activated and pasted in its epilogue, which also keeps the strip
    maxima, and conv2 with the codes made as its halo is staged, the scales
    taken from those maxima, and the head in its epilogue."""
    sh = _strips_of(x.shape[1])
    xq, sx = kernels.quant_image_i8(x)
    if strips is None:
        strips = kernels.dec_strips(x, q.k1t)
    y1, amax = kernels.polyconv1_i8(xq, sx, q.w1t, q.sw1, q.s1, q.t1, strips, sh)
    pred, sa = kernels.conv2_i8_head(y1, sh, q.w2q, q.sw2, q.t2, q.hw, q.hb, amax=amax)
    return {"xq": xq[:, 1:-1, 1:-1], "sx": sx, "strips": strips, "y1": y1, "sa": sa,
            "pred": pred}


def fused_decoder_block(x: torch.Tensor, p: DecoderParams, ef: Optional[torch.Tensor] = None,
                        *, int8: bool = False, q: Optional[DecoderI8] = None) -> torch.Tensor:
    """One decoder block: x [B, S, S, Cin] (and ef [B, S/2, S/2, Ce] iff the
    block has its edge branch) -> logits [B, 2S, 2S, 1], or [B, 2S, 2S, Cm]
    without a head.  ``int8`` asks for the W8A8 mode, taken where
    :func:`int8_supported` holds (``q``: the block's packed int8 weights,
    packed here when not given).  CPU tensors take the plain versions; CUDA tensors
    the kernels, or this raises."""
    if (p.we is None) != (ef is None):
        raise ValueError("edge features are given iff the block has its edge branch")
    int8 = int8 and int8_supported(x.shape[-1], ef is not None, x.dtype)
    if int8:
        q = pack_i8(p, x.dtype) if q is None else q
        if x.device.type == "cpu":
            return decoder_block_i8_plain(x, q)
        if x.device.type != "cuda" or q.t1.numel() != 64:
            raise ValueError(f"no int8 decoder kernel for {x.device}, Cm {q.t1.numel()}")
        kernels.launches["fused_decoder_block_i8"] += 1
        return i8_parts_cuda(x.contiguous(), q)["pred"][..., None]
    if x.device.type == "cpu":
        return decoder_block_plain(x, p, ef)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"no decoder kernel for {x.device} {x.dtype}")
    cm = p.w1.shape[0]
    s1, t1 = fold_bn(p.b1, *p.bn1)
    s2, t2 = fold_bn(p.b2, *p.bn2)
    if ef is None:
        if cm != kernels.DEC_CM or p.head_w is None:
            raise ValueError("the decoder kernel without edge branch covers Cm 64 with a head")
        kernels.launches["fused_decoder_block"] += 1
        y1 = kernels.dec_upconv(x.contiguous(), _pack_conv_t(p.w1.to(x.dtype)),
                                s1.contiguous(), t1.contiguous())
        pred = kernels.dec_conv_head(y1, _pack_conv_t(p.w2.to(x.dtype)), s2.contiguous(),
                                     t2.contiguous(), p.head_w.reshape(-1).float().contiguous(),
                                     p.head_b.reshape(-1).float().contiguous())
        return pred[..., None]
    if cm != 128:
        raise ValueError("the decoder kernel with edge branch covers Cm 128")
    kernels.launches["fused_decoder_block_edge"] += 1
    y1 = kernels.upsample_conv3x3_bn_relu(
        x.contiguous(), kernels.pack_dec128(p.w1.to(x.dtype)), s1.contiguous(), t1.contiguous(),
        ef=ef.to(x.dtype).contiguous(), we=kernels.pack_dec128(p.we.to(x.dtype)))
    w2 = kernels.pack_dec128(p.w2.to(x.dtype))
    if p.head_w is None:
        return kernels.conv3x3_bn_relu(y1, w2, s2.contiguous(), t2.contiguous())
    pred = kernels.conv3x3_bn_relu_head(
        y1, w2, s2.contiguous(), t2.contiguous(),
        p.head_w.reshape(-1).float().contiguous(),
        p.head_b.reshape(-1).float().contiguous())
    return pred[..., None]
