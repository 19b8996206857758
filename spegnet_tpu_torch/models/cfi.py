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
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from spegnet_tpu_torch.models.layers import Conv2d, Linear, cast
from spegnet_tpu_torch.ops import wide


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d parameters and running statistics (kept in f32).

    Eval: normalization with the running statistics in f32, result in the
    input dtype.  Training (the JAX package's ``_BNParams``,
    spegnet_tpu/models/ped.py:112-129, and flax BatchNorm): batch mean and
    the *biased* variance mean(x^2) - mean^2 in f32 over N, H, W; the
    normalization in the input dtype, cast where the JAX package casts;
    running statistics updated with momentum 0.1 (flax's 0.9) from that
    biased variance -- torch's own BatchNorm would use the unbiased one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            s = wide(self.weight) * torch.rsqrt(wide(self.running_var) + self.eps)
            t = wide(self.bias) - wide(self.running_mean) * s
            return torch.addcmul(t[:, None, None], x, s[:, None, None]).to(x.dtype)
        x32 = wide(x)
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


def _cbr(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    convs = [m for m in seq if isinstance(m, nn.Conv2d)]
    bns = [m for m in seq if isinstance(m, nn.BatchNorm2d)]
    return torch.relu(bns[0](convs[0](x)))


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 32)
        self.fc = nn.Sequential(Linear(channels, hidden, bias=False), nn.ReLU(),
                                Linear(hidden, channels, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = wide(x).mean((2, 3)).to(x.dtype)
        y = torch.sigmoid(self.fc[2](torch.relu(self.fc[0](y))))
        return x * y[:, :, None, None]


class AdaptiveAttentionFusion(nn.Module):
    """Stages 2-4 -> stage-2 resolution, 1x1 reduce, BN, ReLU, SE.  The 1x1
    conv of the concatenation is applied per stage at its own resolution and
    upsampled afterwards (a bias-free 1x1 conv commutes with the resize), as
    the JAX package does."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 512):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.conv1x1 = Conv2d(sum(in_channels), out_channels, 1, bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.se_block = SqueezeExcitation(out_channels)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        target = features[0].shape[2:]
        x, off = None, 0
        for f in features:
            c = f.shape[1]
            y = F.conv2d(f, cast(self.conv1x1.weight[:, off:off + c], f.dtype))
            if y.shape[2:] != target:
                y = F.interpolate(y, size=tuple(target), mode="bilinear",
                                  align_corners=False)
            x = y if x is None else x + y
            off += c
        return self.se_block(torch.relu(self.bn(x)))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cbr(self.reduce, x)
        branches = [_cbr(b, x) for b in self.branches]
        g = wide(x).mean((2, 3), keepdim=True).to(x.dtype)
        g = _cbr(self.global_branch, g)
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        # The broadcast branch would make cat fall back to NCHW; keep the
        # channels-last layout of the trunk for everything downstream.
        cat = torch.cat(branches, 1).contiguous(memory_format=torch.channels_last)
        x = _cbr(self.fusion, cat)
        return _cbr(self.expand, x)
