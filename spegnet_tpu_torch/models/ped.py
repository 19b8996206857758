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

With ``band`` (parallel/sharding.RowBand, a spatial axis: models/spegnet.py)
each module computes this rank's band of rows of its outputs from the
:class:`~spegnet_tpu_torch.parallel.sharding.Rows` of its inputs, its band
with a halo of one row (parallel/sharding.halo): the 3x3 convolutions read
one row beyond the band on each side (zero outside the map), the 2x
upsample and the edge features' 2x and 4x resizes one source row
(ops/fused_upsample_conv.upsample_rows), and a block's conv2 fetches its
halo of conv1's output.  Every block runs decomposed there, as JAX's
``fused_ok=cfg.spatial_axis is None`` (spegnet_tpu/models/spegnet.py:100-106).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from spegnet_tpu_torch.models.cfi import BatchNorm2d, band_conv
from spegnet_tpu_torch.models.layers import Conv2d
from spegnet_tpu_torch.ops.fused_decoder import (
    DecoderI8,
    DecoderParams,
    decoder_supported,
    fused_decoder_block,
    pack_i8,
)
from spegnet_tpu_torch.ops.fused_upsample_conv import upsample2x, upsample_rows
from spegnet_tpu_torch.parallel.sharding import RowBand, Rows, halo


class EdgeDetectionModule(nn.Module):
    """Context features -> (edge logit map, edge guidance features)."""

    def __init__(self, in_channels: int = 256, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.edge_conv = Conv2d(out_channels, 1, 1)

    def forward(self, x, band: Optional[RowBand] = None):
        """``x``: the context map, or with ``band`` the Rows of its band
        with a halo of one row."""
        if band is None:
            f = torch.relu(self.bn1(self.conv1(x)))
        else:
            a, b = band.span(x.h // band.size)
            f = torch.relu(self.bn1(band_conv(self.conv1, x.padded(a - 1, b + 1)), band))
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

    def forward(self, x, edge_features=None, band: Optional[RowBand] = None):
        """``x`` and ``edge_features`` (optional): NCHW maps, or with
        ``band`` the Rows of their bands with a halo of one row; returns the
        output map, or this rank's band of it."""
        if band is not None:
            return self._band(x, edge_features, band)
        x = upsample2x(x)
        if edge_features is not None:
            ef = edge_features
            if ef.shape[2:] != x.shape[2:]:
                ef = F.interpolate(ef, size=tuple(x.shape[2:]), mode="bilinear",
                                   align_corners=False)
            x = torch.cat([x, ef], 1)
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))

    def _band(self, x: Rows, ef: Optional[Rows], band: RowBand) -> torch.Tensor:
        h = 2 * x.h
        a, b = band.span(h // band.size)
        y = upsample_rows(x, 2, a - 1, b + 1)
        if ef is not None:
            y = torch.cat([y, upsample_rows(ef, h // ef.h, a - 1, b + 1)], 1)
        y = torch.relu(self.bn1(band_conv(self.conv1, y), band))
        y = halo(y, band, 1, 1).padded(a - 1, b + 1)
        return torch.relu(self.bn2(band_conv(self.conv2, y), band))

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

    def forward(self, x, edge_features=None, kernels: bool = True, int8: bool = False,
                band: Optional[RowBand] = None):
        """``int8``: block 2 in the W8A8 mode (eval mode, kernel path).  With
        ``band``, ``x`` and ``edge_features`` are the Rows of this rank's
        bands with a halo of one row, every block runs decomposed, and the
        predictions are this rank's bands."""
        preds = []
        last = len(self.decoder_blocks) - 1
        for i, (blk, head) in enumerate(zip(self.decoder_blocks, self.pred_heads)):
            ef = edge_features if self.edge_used[i] else None
            if band is not None:
                y = blk(x, ef, band)
                preds.append(head(y))
                if i < last:
                    x = halo(y, band, 1, 1)
                continue
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
