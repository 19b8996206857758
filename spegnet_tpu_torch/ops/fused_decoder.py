"""PED decoder block 2 (port of spegnet_tpu/ops/fused_decoder.py).

Block 2 of the decoder is ``2x bilinear upsample -> conv3x3 -> BN -> ReLU ->
conv3x3 -> BN -> ReLU -> 1x1 head`` at the input resolution (256 -> 512 at
512^2 input), with no edge branch.  :func:`decoder_block_plain` is that
chain in plain PyTorch (the JAX ``decoder_block_reference`` :748);
:func:`fused_decoder_block` runs it for a CPU tensor and, for a CUDA
tensor, the two kernels of csrc/decoder_block.cu, which replace the TPU
kernel ``_dec_kernel`` (:338) in its ``int8=False``, edge-free form.

Layout is channels-last, as in the JAX package: x [B, S, S, Cin] ->
prediction logits [B, 2S, 2S, 1].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.fused_upsample_conv import upsample2x_conv3x3


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
    """Block-2 parameters in torch layouts; bn1/bn2 are (gamma, beta, mean,
    var, eps)."""

    w1: torch.Tensor        # [Cm, Cin, 3, 3]
    b1: torch.Tensor        # [Cm]
    bn1: tuple
    w2: torch.Tensor        # [Cm, Cm, 3, 3]
    b2: torch.Tensor
    bn2: tuple
    head_w: torch.Tensor    # [1, Cm, 1, 1]
    head_b: torch.Tensor    # [1]


def _bn_relu(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.relu(y.float() * s[:, None, None] + t[:, None, None]).to(y.dtype)


def decoder_block_plain(x: torch.Tensor, p: DecoderParams) -> torch.Tensor:
    """x [B, S, S, Cin] -> logits [B, 2S, 2S, 1]; each conv's output is
    rounded to the compute dtype before its folded BN, as in the JAX
    reference."""
    dt = x.dtype
    y = upsample2x_conv3x3(x.permute(0, 3, 1, 2), p.w1)
    y = _bn_relu(y, *fold_bn(p.b1, *p.bn1))
    y2 = F.conv2d(y, p.w2, padding=1)
    y2 = _bn_relu(y2, *fold_bn(p.b2, *p.bn2))
    pred = (torch.einsum("bchw,c->bhw", y2.float(), p.head_w.reshape(-1).float())
            + p.head_b.float())
    return pred.to(dt)[..., None]


def _pack_conv(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> [9*Cin, Cout], rows tap-major (dy, dx, ci)."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()


def fused_decoder_block(x: torch.Tensor, p: DecoderParams) -> torch.Tensor:
    """Decoder block 2 with its head: x [B, S, S, Cin] -> [B, 2S, 2S, 1]."""
    if x.device.type == "cpu":
        return decoder_block_plain(x, p)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"no decoder kernel for {x.device} {x.dtype}")
    if p.w1.shape[0] != 64 or p.head_w.shape[0] != 1:
        raise ValueError("the decoder kernel covers Cm = 64 with one class")
    kernels.launches["fused_decoder_block"] += 1
    s1, t1 = fold_bn(p.b1, *p.bn1)
    s2, t2 = fold_bn(p.b2, *p.bn2)
    y1 = kernels.upsample_conv3x3_bn_relu(x.contiguous(), _pack_conv(p.w1),
                                          s1.contiguous(), t1.contiguous())
    pred = kernels.conv3x3_bn_relu_head(
        y1, _pack_conv(p.w2), s2.contiguous(), t2.contiguous(),
        p.head_w.reshape(-1).float().contiguous(),
        p.head_b.reshape(-1).float().contiguous())
    return pred[..., None]
