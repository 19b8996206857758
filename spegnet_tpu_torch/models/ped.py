"""Edge Feature Extraction (EFE) + Progressive Edge-guided Decoder (PED)
(port of spegnet_tpu/models/ped.py).  NCHW inside; parameter names are the
reference state_dict keys (``conv1``, ``bn1``, ``edge_conv``;
``decoder_blocks.{i}.{conv1, bn1, conv2, bn2}``, ``pred_heads.{i}``).

Block 2 (the full-resolution block, no edge branch) dispatches to
ops/fused_decoder.fused_decoder_block when ``kernels`` is set and its input
is bf16, square and passes ``decoder_supported``, as the JAX package dispatched it
to its Pallas kernel (spegnet_tpu/models/ped.py:239-272), with ``int8``
(the model's ``int8_decoder`` in eval mode, spegnet_tpu/models/spegnet.py:106)
asking for the W8A8 block, which that wrapper takes where ``int8_supported``
holds; it runs the plain versions on the CPU and the Hopper kernels on CUDA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from spegnet_tpu_torch.models.cfi import BatchNorm2d
from spegnet_tpu_torch.models.layers import Conv2d
from spegnet_tpu_torch.ops.fused_decoder import (
    DecoderI8,
    DecoderParams,
    decoder_supported,
    fused_decoder_block,
    pack_i8,
)
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
        self._i8_cache = None   # ((dtype, device), packed int8 weights)

    def train(self, mode: bool = True):
        self._i8_cache = None
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self._i8_cache = None
        super()._load_from_state_dict(*args, **kwargs)

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

    def i8_params(self, head: nn.Conv2d, dt: torch.dtype) -> DecoderI8:
        """The block's int8 weights, packed from its stored weights on first
        use and cached (as the trunk's, models/hiera.py)."""
        key = (dt, self.conv1.weight.device)
        if self._i8_cache is None or self._i8_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                self._i8_cache = (key, pack_i8(self.params(head), dt))
        return self._i8_cache[1]


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
                kernels: bool = True, int8: bool = False):
        """``int8``: block 2 in the W8A8 mode (eval mode, kernel path)."""
        preds = []
        last = len(self.decoder_blocks) - 1
        for i, (blk, head) in enumerate(zip(self.decoder_blocks, self.pred_heads)):
            ef = edge_features if self.edge_used[i] else None
            if (kernels and i == last == 2 and ef is None and self.n_classes == 1
                    and not self.training and x.dtype == torch.bfloat16
                    and x.shape[2] == x.shape[3]
                    and decoder_supported(x.shape[2])):
                q = blk.i8_params(head, x.dtype) if int8 else None
                pred = fused_decoder_block(x.permute(0, 2, 3, 1).contiguous(), blk.params(head),
                                           int8=int8, q=q)
                preds.append(pred.permute(0, 3, 1, 2))
                continue
            x = blk(x, ef)
            preds.append(head(x))
        return preds
