"""Plain scaled dot-product attention (port of spegnet_tpu/ops/attention.py:26).

Scores and the softmax run in f32 (f64 for f64 inputs); the
probabilities are cast back to the input dtype before the product with v,
as ``attention_reference`` does in the JAX package.
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
