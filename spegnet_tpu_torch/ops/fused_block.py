"""Gen-1 whole-block entry (port of spegnet_tpu/ops/fused_block.py).

The JAX package's gen-1 kernel (``_kernel`` :99) takes the non-pooling
blocks on windows of 16 to 64 tokens that its T-kernel does not: in bf16
Hiera-L's stage 4 (C 1152, 16 heads, window 8), where the transposed
kernel lost at more than 8 heads, and the blocks of grids whose windows the
T-kernel cannot tile; in f32 (``use_amp: false``), where JAX takes neither
the T-kernel nor Morton order, every such block (stages 1, 2 and 4 of
Hiera-L).  Its gate ignores the dtype; its backward is XLA autodiff of
``block_reference`` (:261-284).

On Hopper this wrapper takes the gen-1 layout ``[windows, L, C]`` and runs,
in bf16, the csrc/hiera_block.cu chain and in the backward the
csrc/hiera_block_bwd.cu chain, as
:func:`spegnet_tpu_torch.ops.fused_block_t.fused_block_t`, with its own
launch counters; in f32, the f32 chain of csrc/block_f32.cu and
csrc/attention_f32.cu (:func:`block_cuda_f32`), whose backward recomputes
through :func:`block_reference` with autograd, as the JAX package's
custom_vjp does (no backward kernel, no ``fused_block_bwd`` count).
"""

from __future__ import annotations

import torch

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.fused_block_t import (
    BlockFunction,
    BlockWeights,
    _cuda_gate,
    _f32,
    block_plain,
)
from spegnet_tpu_torch.ops.pallas_attention import _plain_grads, attend_windows


# spegnet_tpu/ops/fused_block.py:47: the gen-1 kernel's longest window.
_MAX_L = 64


def supported(l: int) -> bool:
    """Gen-1 gate (``supported`` :71): windows of 16 to 64 tokens."""
    return 16 <= l <= _MAX_L


def block_reference(x: torch.Tensor, wts: BlockWeights, heads: int,
                    scale: float, eps: float = 1e-6,
                    approx_gelu: bool = True) -> torch.Tensor:
    """Plain version on [windows, L, C] (``block_reference`` :214)."""
    nw, l, c = x.shape
    return block_plain(x.reshape(1, nw * l, c), wts, heads, l, scale, eps,
                       approx_gelu).reshape(nw, l, c)


def block_cuda_f32(x: torch.Tensor, wts: BlockWeights, heads: int, scale: float,
                   eps: float, approx_gelu: bool) -> torch.Tensor:
    """The f32 chain on [windows, L, C] (f32, CUDA): LayerNorm and the 3xTF32
    GEMMs with their bias / GELU / residual epilogues of csrc/block_f32.cu,
    the window attention of csrc/attention_f32.cu.  Replaces ``_kernel``
    (:99) at dt = f32."""
    nw, l, c = x.shape
    x2 = x.reshape(nw * l, c)
    w = BlockWeights(*(_f32(t) for t in wts))
    h1 = kernels.layernorm_f32(x2, w.ln1_w, w.ln1_b, eps)
    qkv = kernels.gemm_f32(h1, w.wqkv, w.bqkv)
    a = attend_windows(qkv, heads, l, scale)
    u = kernels.gemm_f32(a, w.wproj, w.bproj, residual=x2)
    h2 = kernels.layernorm_f32(u, w.ln2_w, w.ln2_b, eps)
    z = kernels.gemm_f32(h2, w.wfc1, w.bfc1, gelu="tanh" if approx_gelu else "erf")
    return kernels.gemm_f32(z, w.wfc2, w.bfc2, residual=u).reshape(nw, l, c)


class BlockF32Function(torch.autograd.Function):
    """:func:`fused_block` on f32 through :func:`block_cuda_f32`; the
    backward recomputes through :func:`block_reference` (``_bwd`` :274)."""

    @staticmethod
    def forward(ctx, x, heads, scale, eps, approx_gelu, *w):
        ctx.save_for_backward(x, *w)
        ctx.cfg = (heads, scale, eps, approx_gelu)
        return block_cuda_f32(x, BlockWeights(*w), heads, scale, eps, approx_gelu)

    @staticmethod
    def backward(ctx, dy):
        heads, scale, eps, approx_gelu = ctx.cfg
        grads = _plain_grads(
            lambda x, *w: block_reference(x, BlockWeights(*w), heads, scale, eps, approx_gelu),
            ctx.saved_tensors, dy)
        return (grads[0], None, None, None, None, *grads[1:])


def fused_block(x: torch.Tensor, wts: BlockWeights, heads: int, scale: float,
                eps: float = 1e-6, approx_gelu: bool = True) -> torch.Tensor:
    """One non-pooling block on [windows, L, C].  CPU:
    :func:`block_reference`.  CUDA: csrc/hiera_block.cu (bf16) or
    :func:`block_cuda_f32` (f32), which replace spegnet_tpu/ops/fused_block.py
    ``_kernel`` (:99)."""
    if x.device.type == "cpu":
        return block_reference(x, wts, heads, scale, eps, approx_gelu)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        kernels.launches["fused_block"] += 1
        return BlockF32Function.apply(x.contiguous(), heads, scale, eps, approx_gelu, *wts)
    _cuda_gate(x, approx_gelu)
    kernels.launches["fused_block"] += 1
    nw, l, c = x.shape
    y = BlockFunction.apply(x.contiguous().reshape(1, nw * l, c), heads, l, scale, eps,
                            "fused_block", *wts)
    return y.reshape(nw, l, c)
