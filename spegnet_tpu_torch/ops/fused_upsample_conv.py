"""2x bilinear upsample followed by a 3x3 convolution (port of
spegnet_tpu/ops/fused_upsample_conv.py).

The JAX package composes the two linear operators into one lhs-dilated
convolution with repaired border strips; both are only faster forms of the
definition kept here: ``conv3x3(resize_bilinear(x, 2x))``.  NCHW, as the
port's decoder runs.

The int8 decoder block (ops/fused_decoder.py) is defined on the composed
form, so its two pieces are ported too, as plain PyTorch (the JAX package
computes them in XLA, outside its kernel): :func:`compose_kernel`, the 6x6
kernel of the 2x bilinear composed with a 3x3 kernel (``_compose_kernel``
:35), and :func:`border_strips`, the exact outermost output rows and
columns of ``conv3x3(up2(x))`` (``_border_strips`` :57), both channels-last
with HWIO kernels as in the JAX package.

Under a spatial axis the decoder runs on a band of rows
(parallel/sharding.RowBand): :func:`upsample_rows` resizes the band's rows
with the source rows around it that :func:`source_rows` names, and gives
the output rows bit-equal to those of the whole resize.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spegnet_tpu_torch.parallel.sharding import Rows

_KU = (0.25, 0.75, 0.75, 0.25)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], bilinear, align_corners=False."""
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode="bilinear", align_corners=False)


def source_rows(lo: int, hi: int, scale: int, h: int) -> Tuple[int, int]:
    """The source rows [r0, r1) that the bilinear resize (align_corners=False)
    of an ``h``-row map by an integer ``scale`` reads for its output rows
    [lo, hi) that lie in the output (its two taps: floor of the source
    coordinate clamped at 0, and the next row clamped at h - 1)."""
    a, b = max(lo, 0), min(hi, scale * h)

    def tap(j):   # floor(max((j + 0.5) / scale - 0.5, 0)), in integers
        return max(2 * j + 1 - scale, 0) // (2 * scale)

    return tap(a), min(tap(b - 1) + 1, h - 1) + 1


def upsample_rows(rows: Rows, scale: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the bilinear ``scale`` x resize (align_corners=False,
    both dims) of the map that ``rows`` holds a part of, zero where they lie
    outside the output (a convolution's padding).  ``rows`` must hold
    :func:`source_rows` of them: the resize of those source rows then reads,
    for each output row, the same two rows with the same weights as the
    whole map's resize, since the ratio is an exact power of two and no
    clamp at the part's own edges reaches the rows kept, so they are
    bit-equal to the whole resize's."""
    if scale == 1:
        return rows.padded(lo, hi)
    r0, r1 = source_rows(lo, hi, scale, rows.h)
    m = rows.t.shape[2]
    if r0 < rows.lo or r1 > rows.lo + m:
        raise ValueError(f"output rows [{lo}, {hi}) read source rows [{r0}, {r1}), not all "
                         f"in [{rows.lo}, {rows.lo + m})")
    t = rows.t[:, :, r0 - rows.lo:r1 - rows.lo]
    y = F.interpolate(t, size=(scale * (r1 - r0), scale * t.shape[3]), mode="bilinear",
                      align_corners=False)
    return Rows(y, scale * r0, scale * rows.h).padded(lo, hi)


def upsample2x_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(upsample2x(x), weight [Cout, Cin, 3, 3]) (+ bias), zero
    padding at the 2x grid's border."""
    return F.conv2d(upsample2x(x), weight, bias, padding=1)


def compose_kernel(k3: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [6, 6, Cin, Cout] f32: k3 composed with the 2x
    bilinear transposed-conv kernel [1/4, 3/4, 3/4, 1/4] on both axes.  The
    f32 sums are taken on the CPU by one einsum, which rounds them as the
    JAX package's XLA einsum does (bit-equal, tests/test_torch_decoder_i8.py),
    whatever device ``k3`` lies on."""
    ku = torch.tensor(_KU, dtype=torch.float32)
    idx = torch.arange(6)[:, None] - torch.arange(3)[None, :]
    m = torch.where((idx >= 0) & (idx < 4), ku[idx.clamp(0, 3)], torch.zeros(()))
    ke = torch.einsum("rd,se,deio->rsio", m, m, k3.detach().float().cpu())
    return ke.to(k3.device)


def _lerp2x_cols(rows: torch.Tensor) -> torch.Tensor:
    """[B, r, W, C] -> [B, r, 2W, C]: the 2x bilinear along W, each output
    its exact two-term sum rounded once to f32 and then to the input dtype
    (the JAX package's f32 resize matmul; the clamped first and last
    outputs are copies)."""
    x = rows.double()
    even = torch.cat([x[:, :, :1], 0.25 * x[:, :, :-1] + 0.75 * x[:, :, 1:]], 2)
    odd = torch.cat([0.75 * x[:, :, :-1] + 0.25 * x[:, :, 1:], x[:, :, -1:]], 2)
    b, r, w, c = x.shape
    y = torch.stack([even, odd], 3).reshape(b, r, 2 * w, c)
    return y.float().to(rows.dtype)


def _conv_valid_rows(u: torch.Tensor, k: torch.Tensor, pad_h: int, pad_w: int,
                     dt: torch.dtype) -> torch.Tensor:
    """NHWC ``u`` (dt values) conv HWIO ``k`` (cast to dt) in f32, rounded
    to dt: the JAX package's ``_conv`` with the given zero padding."""
    w = k.to(dt).float().permute(3, 2, 0, 1)
    y = F.conv2d(u.float().permute(0, 3, 1, 2), w, padding=(pad_h, pad_w))
    return y.permute(0, 2, 3, 1).to(dt)


def border_strips(x: torch.Tensor, k3: torch.Tensor):
    """Exact outermost-output-row/col strips of conv3x3(up2(x)) for NHWC x
    [B, H, W, C] and HWIO k3: (y_top [B, 1, 2W, Co], y_bot [B, 1, 2W, Co],
    y_left [B, 2H, 1, Co], y_right [B, 2H, 1, Co]) in x.dtype, computed as
    the JAX package does: the clamped border row pair in f32, rounded to
    x.dtype, upsampled along the other axis and rounded again, then a thin
    conv with k3 in x.dtype, f32 sums rounded to x.dtype."""
    dt = x.dtype
    x32 = x.float()
    u_top = _lerp2x_cols(torch.stack(
        [x32[:, 0], 0.75 * x32[:, 0] + 0.25 * x32[:, 1]], 1).to(dt))
    u_bot = _lerp2x_cols(torch.stack(
        [0.25 * x32[:, -2] + 0.75 * x32[:, -1], x32[:, -1]], 1).to(dt))
    u_left = _lerp2x_cols(torch.stack(
        [x32[:, :, 0], 0.75 * x32[:, :, 0] + 0.25 * x32[:, :, 1]], 2)
        .transpose(1, 2).to(dt)).transpose(1, 2)
    u_right = _lerp2x_cols(torch.stack(
        [0.25 * x32[:, :, -2] + 0.75 * x32[:, :, -1], x32[:, :, -1]], 2)
        .transpose(1, 2).to(dt)).transpose(1, 2)
    return (_conv_valid_rows(u_top, k3[1:3], 0, 1, dt),
            _conv_valid_rows(u_bot, k3[0:2], 0, 1, dt),
            _conv_valid_rows(u_left, k3[:, 1:3], 1, 0, dt),
            _conv_valid_rows(u_right, k3[:, 0:2], 1, 0, dt))
