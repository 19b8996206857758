"""Edge Feature Extraction (EFE) + Progressive Edge-guided Decoder (PED)
(port of spegnet_tpu/models/ped.py).  NCHW inside; parameter names are the
reference state_dict keys (``conv1``, ``bn1``, ``edge_conv``;
``decoder_blocks.{i}.{conv1, bn1, conv2, bn2}``, ``pred_heads.{i}``).

Block 2 (the full-resolution block, no edge branch) dispatches to
ops/fused_decoder.fused_decoder_block when ``kernels`` is set, as the JAX
package dispatched it to its Pallas kernel (spegnet_tpu/models/ped.py:239-272);
that wrapper runs the plain chain on the CPU and the Hopper kernels on CUDA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from spegnet_tpu_torch.models.cfi import BatchNorm2d
from spegnet_tpu_torch.models.layers import Conv2d
from spegnet_tpu_torch.ops.fused_decoder import DecoderParams, fused_decoder_block
from spegnet_tpu_torch.ops.fused_upsample_conv import upsample2x


class EdgeDetectionModule(nn.Module):
    """Context features -> (edge logit map, edge guidance features)."""

    def __init__(self, in_channels: int = 256, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.edge_conv = Conv2d(out_channels, 1, 1)

    def forward(self, x: torch.Tensor):
        f = torch.relu(self.bn1(self.conv1(x)))
        return self.edge_conv(f), f


def _bn_stats(bn: nn.BatchNorm2d) -> tuple:
    return (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


class DecoderBlock(nn.Module):
    """2x upsample, optional edge-feature concat (resized to match), two
    [3x3 conv + BN + ReLU]."""

    def __init__(self, in_channels: int, out_channels: int, edge_channels: int = 0):
        super().__init__()
        self.conv1 = Conv2d(in_channels + edge_channels, out_channels, 3, padding=1)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor, edge_features: Optional[torch.Tensor] = None):
        x = upsample2x(x)
        if edge_features is not None:
            ef = edge_features
            if ef.shape[2:] != x.shape[2:]:
                ef = F.interpolate(ef, size=tuple(x.shape[2:]), mode="bilinear",
                                   align_corners=False)
            x = torch.cat([x, ef], 1)
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))

    def params(self, head: nn.Conv2d) -> DecoderParams:
        return DecoderParams(self.conv1.weight, self.conv1.bias, _bn_stats(self.bn1),
                             self.conv2.weight, self.conv2.bias, _bn_stats(self.bn2),
                             head.weight, head.bias)


class BoundaryAwareDecoder(nn.Module):
    """Progressive decoder with one logit head per block (deep supervision)."""

    def __init__(self, in_channels: int = 256,
                 decoder_channels: Sequence[int] = (256, 128, 64), n_classes: int = 1,
                 edge_channels_list: Sequence[Optional[int]] = (64, 64, None)):
        super().__init__()
        self.decoder_blocks = nn.ModuleList()
        self.pred_heads = nn.ModuleList()
        cin = in_channels
        for out_ch, ec in zip(decoder_channels, edge_channels_list):
            self.decoder_blocks.append(DecoderBlock(cin, out_ch, ec or 0))
            self.pred_heads.append(Conv2d(out_ch, n_classes, 1))
            cin = out_ch
        self.edge_used = [ec is not None for ec in edge_channels_list]
        self.n_classes = n_classes

    def forward(self, x: torch.Tensor, edge_features: Optional[torch.Tensor] = None,
                kernels: bool = True):
        preds = []
        last = len(self.decoder_blocks) - 1
        for i, (blk, head) in enumerate(zip(self.decoder_blocks, self.pred_heads)):
            ef = edge_features if self.edge_used[i] else None
            if (kernels and i == last == 2 and ef is None and self.n_classes == 1
                    and not self.training):
                pred = fused_decoder_block(x.permute(0, 2, 3, 1).contiguous(),
                                           blk.params(head))
                preds.append(pred.permute(0, 3, 1, 2))
                continue
            x = blk(x, ef)
            preds.append(head(x))
        return preds
