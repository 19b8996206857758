"""2x bilinear upsample followed by a 3x3 convolution (port of
spegnet_tpu/ops/fused_upsample_conv.py).

The JAX package composes the two linear operators into one lhs-dilated
convolution with repaired border strips; both are only faster forms of the
definition kept here: ``conv3x3(resize_bilinear(x, 2x))``.  NCHW, as the
port's decoder runs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], bilinear, align_corners=False."""
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode="bilinear", align_corners=False)


def upsample2x_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(upsample2x(x), weight [Cout, Cin, 3, 3]) (+ bias), zero
    padding at the 2x grid's border."""
    return F.conv2d(upsample2x(x), weight, bias, padding=1)
