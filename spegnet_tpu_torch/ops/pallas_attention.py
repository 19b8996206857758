"""Attention of Hiera's decomposed blocks (port of spegnet_tpu/ops/pallas_attention.py).

Two entries compute softmax(q k^T * scale) v per (problem, head), scores and
softmax in f32, probabilities cast to the input dtype (bf16 or f32) before
the product with v:

* :func:`fused_attention_lanes` takes the packed token-major output of a
  qkv projection ``[B, L, 3*H*D]`` in nn.Linear column order (q heads, then
  k heads, then v heads) and returns ``[B, L, H*D]``.  It carries Hiera's
  non-pooling blocks on the decomposed path (``MultiScaleAttention``,
  spegnet_tpu/models/hiera.py:287-305): every block of a grid that its
  window does not divide, and the global blocks the T-kernel does not take.
  The JAX package zero-pads each head to 128 lanes (``pad_qkv`` /
  ``pad_proj``, :272-285) so the TPU kernel can index heads as lane blocks;
  the Hopper kernel reads the unpadded columns through strides instead.
* :func:`fused_attention` takes ``[B, L, H, D]`` q / k / v, as
  ``scaled_dot_product_attention`` (ops/attention.py) hands them.  No model
  path reaches it: its gate (:func:`is_supported`) is narrower than
  :func:`lanes_supported` and the Q-pool blocks have q shorter than k.

Each has a plain PyTorch version beside it (:func:`lanes_plain`,
:func:`attention_reference`), which the wrapper runs for a CPU tensor; for a
CUDA tensor it launches csrc/attention_lanes.cu (bf16) or
csrc/attention_f32.cu (f32, the JAX package's f32 compute, whose gates
ignore the dtype), or raises.  The gradient is an autograd Function whose
backward recomputes through the plain version, as the JAX package's custom
VJPs do (:149-161, :323-332): there is no backward kernel for either; where
no gradient is recorded (inference) the wrappers launch the kernel without
the Function, which saves its host cost per call.
:func:`attend_windows` runs the same kernels, uncounted, as the window
attention of the f32 gen-1 chains (ops/fused_block.py,
ops/fused_block_t_i8.py).

The gates are the JAX package's (:188-197, :335-356) without its TPU-backend
test, so the port sends the same blocks here.
"""

from __future__ import annotations

from typing import Optional

import torch

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.attention import attention_reference

# spegnet_tpu/ops/pallas_attention.py:36-40: the whole-problem path up to
# _SMALL_L, the query-blocked path up to _MAX_L for L divisible by a block.
_SMALL_L = 1024
_MAX_L = 8192
_Q_BLOCKS = (512, 256, 128, 64)


def lanes_supported(l: int, head_dim: int) -> bool:
    """Gate of :func:`fused_attention_lanes` (``lanes_supported`` :188),
    L tokens per problem.  As JAX's, it ignores the head dim: a head wider
    than kernels.MAX_HEAD_DIM passes it and the launcher refuses it."""
    if l <= _SMALL_L:
        return l >= 16
    return l <= _MAX_L and any(l % x == 0 for x in _Q_BLOCKS)


def is_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Gate of :func:`fused_attention` (``is_supported`` :335): [B, L, H, D]
    self-attention with equal shapes, 16 <= L <= 8192, D <= 256
    (kernels.MAX_HEAD_DIM, the kernels' own limit: every D it admits
    launches, kernels.attention_head_dim)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        return False
    _, l, _, d = q.shape
    if l > _SMALL_L and not any(l % x == 0 for x in _Q_BLOCKS):
        return False
    return l <= _MAX_L and d <= kernels.MAX_HEAD_DIM and l >= 16


def split_qkv(qkv: torch.Tensor, heads: int):
    """[B, L, 3*H*D] -> q, k, v strided [B, L, H, D] views (no copy)."""
    b, l, f = qkv.shape
    if f % (3 * heads):
        raise ValueError(f"qkv width {f} does not split into 3 x {heads} heads")
    return qkv.unflatten(2, (3, heads, f // (3 * heads))).unbind(2)


def lanes_plain(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Plain version of :func:`fused_attention_lanes` (``_lanes_reference``
    :310 without the lane padding)."""
    b, l, _ = qkv.shape
    return attention_reference(*split_qkv(qkv, heads), scale).reshape(b, l, -1)


def attend_windows(qkv: torch.Tensor, heads: int, l: int, scale: float) -> torch.Tensor:
    """qkv [rows, 3*H*d] (CUDA) with windows of l consecutive rows ->
    softmax(q k^T * scale) v per window and head, [rows, H*d], through
    :func:`kernels.attention` on strided views (each window one problem)."""
    rows, f = qkv.shape
    if rows % l:
        raise ValueError(f"{rows} rows do not split into windows of {l}")
    q, k, v = split_qkv(qkv.reshape(rows // l, l, f), heads)
    return kernels.attention(q, k, v, scale).reshape(rows, f // 3)


def _plain_grads(fn, inputs, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, g)


class LanesFunction(torch.autograd.Function):
    """:func:`fused_attention_lanes` through the Hopper kernel; the backward
    recomputes through :func:`lanes_plain`."""

    @staticmethod
    def forward(ctx, qkv, heads, scale):
        ctx.save_for_backward(qkv)
        ctx.cfg = (heads, scale)
        b, l, _ = qkv.shape
        return kernels.attention(*split_qkv(qkv, heads), scale).reshape(b, l, -1)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        heads, scale = ctx.cfg
        (dqkv,) = _plain_grads(lambda t: lanes_plain(t, heads, scale), (qkv,), g)
        return dqkv, None, None


class AttentionFunction(torch.autograd.Function):
    """:func:`fused_attention` through the Hopper kernel; the backward
    recomputes through :func:`attention_reference`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return kernels.attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        grads = _plain_grads(lambda q, k, v: attention_reference(q, k, v, ctx.scale),
                             ctx.saved_tensors, g)
        return (*grads, None)


def _gate(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the Hopper attention kernels take bf16 or f32, got {t.dtype}")


def fused_attention_lanes(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """[B, L, 3*H*D] packed qkv -> [B, L, H*D].  CPU: :func:`lanes_plain`.
    CUDA: csrc/attention_lanes.cu (bf16) or csrc/attention_f32.cu (f32),
    which replace
    spegnet_tpu/ops/pallas_attention.py ``_lanes_kernel`` (:199) and
    ``_lanes_qblock_kernel`` (:220)."""
    if qkv.device.type == "cpu":
        return lanes_plain(qkv, heads, scale)
    _gate(qkv)
    kernels.launches["fused_attention_lanes"] += 1
    qkv = qkv.contiguous()
    if torch.is_grad_enabled() and qkv.requires_grad:
        return LanesFunction.apply(qkv, heads, scale)
    b, l, _ = qkv.shape   # no graph to record: the kernel alone
    return kernels.attention(*split_qkv(qkv, heads), scale).reshape(b, l, -1)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, L, H, D] q / k / v -> [B, L, H, D], scale D^-0.5 by default.
    CPU: :func:`attention_reference`.  CUDA: csrc/attention_lanes.cu (bf16)
    or csrc/attention_f32.cu (f32), which replace
    spegnet_tpu/ops/pallas_attention.py ``_attn_kernel`` (:43) and
    ``_qblock_kernel`` (:68)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    for t in (q, k, v):
        _gate(t)
    kernels.launches["fused_attention"] += 1
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionFunction.apply(q, k, v, scale)
    return kernels.attention(q, k, v, scale)
