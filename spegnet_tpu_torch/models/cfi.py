"""Contextual Feature Integration: attention fusion + efficient ASPP
(port of spegnet_tpu/models/cfi.py).  NCHW inside; parameter names are the
reference state_dict keys (``conv1x1``, ``bn``, ``se_block.fc.{0,2}``,
``reduce.{0,1}``, ``branches.{k}.{0,1}``, ``global_branch.{1,2}``,
``fusion.{0,1}``, ``expand.{0,1}``).

* SE hidden width is ``max(C // 16, 32)``.
* The e-ASPP fusion conv is a grouped 1x1 (groups = reduced channels) over
  the branch-major concatenation, run as a native ``groups=`` convolution.
* BatchNorm (:class:`BatchNorm2d`) normalizes with the running statistics
  in eval and with the batch statistics in training (see there).
* Convolution and Linear weights are cast to the input's dtype at use
  (models/layers.py), so training keeps them f32.

With ``band`` (parallel/sharding.RowBand, a spatial axis: models/spegnet.py)
each module computes this rank's band of rows of its output at H/8: the
fusion reads the source rows of its band from the whole stage outputs, the
e-ASPP's dilated depthwise convolutions fetch their halos from the other
ranks (:func:`sharding.halo`, zero outside the map), the SE block's and the
global branch's means are taken over the group's bands
(:func:`sharding.spatial_mean`), and BatchNorm's statistics in training sum
the bands over the ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from spegnet_tpu_torch.models.layers import Conv2d, Linear, cast
from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.ops.fused_upsample_conv import source_rows, upsample_rows
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.parallel.sharding import RowBand, Rows


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d parameters and running statistics (kept in f32).

    Eval: normalization with the running statistics in f32, result in the
    input dtype.  Training (the JAX package's ``_BNParams``,
    spegnet_tpu/models/ped.py:112-129, and flax BatchNorm): batch mean and
    the *biased* variance mean(x^2) - mean^2 in f32 over N, H, W; the
    normalization in the input dtype, cast where the JAX package casts;
    running statistics updated with momentum 0.1 (flax's 0.9) from that
    biased variance -- torch's own BatchNorm would use the unbiased one.

    In a process group of more than one rank (data parallelism) the
    statistics are the global batch's, as under the JAX package's pjit
    (PARITY.md #5): each rank's sums of x and x^2 and its count (its
    pixels), in f32 (f64 for f64 input), summed over the ranks by the
    differentiable all-reduce (``band.stats`` with a ``band``), so the
    backward carries the other ranks' terms; padding rows count, as in JAX
    (PARITY.md #4).  Under a spatial axis the S ranks of a spatial group
    hold the S bands of rows of their data index's maps (a head map of h
    rows: h / S each; a pooled [B, C, 1, 1] map: all of it, on each), and
    the M ranks of a model group the same rows, so every sum counts each
    pixel M times (a pooled map's S M times), the count too: the ratios are
    the global batch's, and the backward is the global program's, which
    the trainer's gradient rule takes (engine/trainer.py)."""

    def forward(self, x: torch.Tensor, band: Optional[RowBand] = None) -> torch.Tensor:
        if not self.training:
            s = wide(self.weight) * torch.rsqrt(wide(self.running_var) + self.eps)
            t = wide(self.bias) - wide(self.running_mean) * s
            return torch.addcmul(t[:, None, None], x, s[:, None, None]).to(x.dtype)
        x32 = wide(x)
        if band is not None or sharding.active_world() > 1:
            count = torch.full((1,), x.numel() // x.shape[1], dtype=x32.dtype,
                               device=x.device)
            sums = sharding.sum_stats(torch.cat([x32.sum((0, 2, 3)),
                                                 (x32 * x32).sum((0, 2, 3)), count]), band)
            c = x.shape[1]
            mean = sums[:c] / sums[-1]
            var = sums[c:2 * c] / sums[-1] - mean * mean
        else:
            mean = x32.mean((0, 2, 3))
            var = (x32 * x32).mean((0, 2, 3)) - mean * mean
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        dt = x.dtype
        mul = (torch.rsqrt(var + self.eps) * wide(self.weight)).to(dt)
        y = x - mean.to(dt)[:, None, None]
        return y * mul[:, None, None] + self.bias.to(dt)[:, None, None]


def conv_bn_relu(cin: int, cout: int, kernel: int = 1, dilation: int = 1,
                 groups: int = 1) -> nn.Sequential:
    pad = dilation * (kernel // 2)
    return nn.Sequential(
        Conv2d(cin, cout, kernel, padding=pad, dilation=dilation, groups=groups,
               bias=False),
        BatchNorm2d(cout), nn.ReLU())


def _cbr(seq: nn.Sequential, x: torch.Tensor, band: Optional[RowBand] = None) -> torch.Tensor:
    convs = [m for m in seq if isinstance(m, nn.Conv2d)]
    bns = [m for m in seq if isinstance(m, nn.BatchNorm2d)]
    y = convs[0](x) if band is None else band_conv(convs[0], x)
    return torch.relu(bns[0](y, band))


def band_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``x``, a band whose first and last p rows are its halo (p,
    the conv's row padding): the band's rows, cut from the conv of the band
    with its halo.  The conv keeps its own zero padding, the call it makes
    on the whole map (the rows that read the padding are cut), so each row
    of the band is the whole map's sum."""
    p = conv.padding[0]
    y = conv(x)
    return y[:, :, p:y.shape[2] - p]


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 32)
        self.fc = nn.Sequential(Linear(channels, hidden, bias=False), nn.ReLU(),
                                Linear(hidden, channels, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor, band: Optional[RowBand] = None) -> torch.Tensor:
        y = sharding.spatial_mean(x, band).to(x.dtype)
        y = torch.sigmoid(self.fc[2](torch.relu(self.fc[0](y))))
        return x * y[:, :, None, None]


class AdaptiveAttentionFusion(nn.Module):
    """Stages 2-4 -> stage-2 resolution, 1x1 reduce, BN, ReLU, SE.  The 1x1
    conv of the concatenation is applied per stage at its own resolution and
    upsampled afterwards (a bias-free 1x1 conv commutes with the resize), as
    the JAX package does.  With ``band`` each stage is projected on the
    source rows that this rank's band of the output reads
    (ops/fused_upsample_conv.source_rows) and resized onto the band
    (``upsample_rows``), bit-equal to the whole resize's rows."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 512):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.conv1x1 = Conv2d(sum(in_channels), out_channels, 1, bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.se_block = SqueezeExcitation(out_channels)

    def forward(self, features: Sequence[torch.Tensor],
                band: Optional[RowBand] = None) -> torch.Tensor:
        """The whole ``features`` (stages 2-4, NCHW) -> the fused map, or
        this rank's band of it."""
        target = features[0].shape[2:]
        if band is not None:
            a, b = band.span(target[0] // band.size)
        x, off = None, 0
        for f in features:
            c = f.shape[1]
            w = cast(self.conv1x1.weight[:, off:off + c], f.dtype)
            if band is None:
                y = F.conv2d(f, w)
                if y.shape[2:] != target:
                    y = F.interpolate(y, size=tuple(target), mode="bilinear",
                                      align_corners=False)
            else:
                scale = target[0] // f.shape[2]
                r0, r1 = source_rows(a, b, scale, f.shape[2])
                y = upsample_rows(Rows(F.conv2d(f[:, :, r0:r1], w), r0, f.shape[2]), scale, a, b)
            x = y if x is None else x + y
            off += c
        return self.se_block(torch.relu(self.bn(x, band)), band)


class EfficientASPP(nn.Module):
    def __init__(self, in_channels: int = 512, out_channels: int = 256,
                 reduction_factor: int = 4, dilation_rates: Sequence[int] = (1, 6, 12, 18)):
        super().__init__()
        rc = in_channels // reduction_factor
        self.reduce = conv_bn_relu(in_channels, rc)
        self.branches = nn.ModuleList(
            conv_bn_relu(rc, rc, 3, dilation=r, groups=rc) for r in dilation_rates)
        self.global_branch = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                           *conv_bn_relu(rc, rc))
        self.fusion = conv_bn_relu(rc * (len(dilation_rates) + 1), rc, groups=rc)
        self.expand = conv_bn_relu(rc, out_channels)

    def forward(self, x: torch.Tensor, band: Optional[RowBand] = None) -> torch.Tensor:
        """The fused map -> the context map, or with ``band`` this rank's
        band of one from its band of the other: the dilated branches read
        their rows beyond the band from the other ranks, one halo as wide as
        the widest dilation (it may reach past the next rank's band)."""
        x = _cbr(self.reduce, x, band)
        if band is None:
            branches = [_cbr(b, x) for b in self.branches]
        else:
            a, b = band.span(x.shape[2])
            pad = [br[0].padding[0] for br in self.branches]
            rows = sharding.halo(x, band, max(pad), max(pad))
            branches = [_cbr(br, rows.padded(a - p, b + p), band)
                        for br, p in zip(self.branches, pad)]
        g = sharding.spatial_mean(x, band).to(x.dtype)[:, :, None, None]
        g = _cbr(self.global_branch, g, band)
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        # The broadcast branch would make cat fall back to NCHW; keep the
        # channels-last layout of the trunk for everything downstream.
        cat = torch.cat(branches, 1).contiguous(memory_format=torch.channels_last)
        x = _cbr(self.fusion, cat, band)
        return _cbr(self.expand, x, band)
