"""Plain PyTorch operators and the wrappers of the hand-written kernels."""

import torch


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation dtype: f32 for bf16 and f32, f64 for f64.
    Statistics, softmax scores and the loss are taken in it, so an f64 run
    keeps f64 throughout while bf16 and f32 runs accumulate in f32."""
    return t.to(torch.promote_types(t.dtype, torch.float32))
