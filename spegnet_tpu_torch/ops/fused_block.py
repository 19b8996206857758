"""Stage-4 entry to the whole-block kernel (port of spegnet_tpu/ops/fused_block.py).

On the TPU, Hiera-L's stage 4 (C 1152, 16 heads, window 8) ran a separate
token-major kernel (``_kernel`` :99) because the transposed kernel lost at
more than 8 heads; its backward was XLA autodiff of ``block_reference``
(:274-284).  On Hopper both are one function: this wrapper takes the gen-1
layout ``[windows, L, C]`` and runs the same csrc/hiera_block.cu chain, and
in the backward the csrc/hiera_block_bwd.cu chain, as
:func:`spegnet_tpu_torch.ops.fused_block_t.fused_block_t`, with its own
launch counters.
"""

from __future__ import annotations

import torch

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.fused_block_t import (
    BlockFunction,
    BlockWeights,
    _cuda_gate,
    block_plain,
)


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


def fused_block(x: torch.Tensor, wts: BlockWeights, heads: int, scale: float,
                eps: float = 1e-6, approx_gelu: bool = True) -> torch.Tensor:
    """One non-pooling block on [windows, L, C].  CPU:
    :func:`block_reference`.  CUDA: csrc/hiera_block.cu, which replaces
    spegnet_tpu/ops/fused_block.py ``_kernel`` (:99)."""
    if x.device.type == "cpu":
        return block_reference(x, wts, heads, scale, eps, approx_gelu)
    _cuda_gate(x, approx_gelu)
    kernels.launches["fused_block"] += 1
    nw, l, c = x.shape
    y = BlockFunction.apply(x.contiguous().reshape(1, nw * l, c), heads, l, scale, eps,
                            "fused_block", *wts)
    return y.reshape(nw, l, c)
