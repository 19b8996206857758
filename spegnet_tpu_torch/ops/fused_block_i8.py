"""W8A8 gen-1 block (port of spegnet_tpu/ops/fused_block_i8.py), inference only.

The int8 encoder mode's block for the geometry the JAX package keeps on its
gen-1 token-major kernel where C % 128 == 0: Hiera-L stage 4 (C 1152, 16
heads, windows of 64 tokens), where the T-kernel gate refuses more than 8
heads, in bf16 and in f32 (JAX's gen-1 gates ignore the dtype; in f32 the
activations, the attention and the erf GELU are f32, ``_kernel_i8`` :128 at
dt = f32).  Same scheme as ops/fused_block_t_i8.py with per-output-column
weight scales on the gen-1 ``[K, M]`` layout (:func:`quantize_cols`), which
are the per-output-row scales of the port's nn.Linear layout, and the
dequant order ``acc * s_x * s_w`` (``_qdot`` :121).  The input is the gen-1
``[windows, L, C]``.
"""

from __future__ import annotations

import torch

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.fused_block import supported
from spegnet_tpu_torch.ops.fused_block_t_i8 import (
    BlockWeightsI8,
    block_cuda_i8,
    block_t_i8_plain,
    pack_i8,
    quantize_rows,
)

__all__ = ["block_i8_plain", "fused_block_i8", "pack_i8", "quantize_cols", "supported_i8"]


def quantize_cols(w: torch.Tensor):
    """[K, M] -> (int8 [K, M], f32 scales [M]): symmetric per-column absmax
    (``quantize_cols`` :84)."""
    q, s = quantize_rows(w.t())
    return q.t(), s


def supported_i8(n_windows: int, l: int, c: int) -> bool:
    """int8 gen-1 gate (``supported_i8`` :234): the gen-1 window rule
    16 <= L <= 64 (``fused_block.supported`` :71) and C % 128 == 0."""
    return n_windows > 0 and supported(l) and c % 128 == 0


def block_i8_plain(x: torch.Tensor, w: BlockWeightsI8, heads: int, scale: float,
                   eps: float = 1e-6, approx_gelu: bool = True) -> torch.Tensor:
    """Plain version on [windows, L, C] (``block_i8_reference`` :267)."""
    nw, l, c = x.shape
    return block_t_i8_plain(x.reshape(1, nw * l, c), w, heads, l, scale, eps, approx_gelu,
                            sw_first=False).reshape(nw, l, c)


def fused_block_i8(x: torch.Tensor, w: BlockWeightsI8, heads: int, scale: float,
                   eps: float = 1e-6, approx_gelu: bool = True) -> torch.Tensor:
    """One W8A8 block on [windows, L, C].  CPU: :func:`block_i8_plain`.
    CUDA (bf16 with the tanh GELU, or f32 with either): the chain of
    ops/fused_block_t_i8.block_cuda_i8 with this kernel's dequant order,
    which replaces spegnet_tpu/ops/fused_block_i8.py ``_kernel_i8`` (:128)."""
    if x.device.type == "cpu":
        return block_i8_plain(x, w, heads, scale, eps, approx_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the Hopper int8 gen-1 block takes bf16 or f32, got {x.dtype}")
    if x.dtype == torch.bfloat16 and not approx_gelu:
        raise ValueError("the bf16 int8 GEMM implements the tanh GELU")
    kernels.launches["fused_block_i8"] += 1
    nw, l, c = x.shape
    y = block_cuda_i8(x.contiguous().reshape(1, nw * l, c), w, heads, l, scale, eps,
                      sw_first=False, approx_gelu=approx_gelu)
    return y.reshape(nw, l, c)
