"""Scaled dot-product attention (port of spegnet_tpu/ops/attention.py).

:func:`attention_reference` is the plain version: scores and the softmax in
f32 (f64 for f64 inputs), the probabilities cast back to the input dtype
before the product with v, as ``attention_reference`` (:26) does in the JAX
package.  :func:`scaled_dot_product_attention` is the dispatch point of the
kernel path (:37-47): the fused kernel (ops/pallas_attention.py
``fused_attention``) where its gate allows, else the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from spegnet_tpu_torch.ops import wide


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k))
    p = torch.softmax(s * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v through ``fused_attention`` where
    ``is_supported`` allows (equal q / k / v shapes, 16 <= L <= 8192), else
    :func:`attention_reference`."""
    from spegnet_tpu_torch.ops.pallas_attention import fused_attention, is_supported

    if is_supported(q, k, v):
        return fused_attention(q, k, v)
    return attention_reference(q, k, v)
