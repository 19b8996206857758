"""The device an entry point runs on."""

from __future__ import annotations

import logging
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``device`` or, when None, the card.  Raises when CUDA is asked for and
    there is none: the port runs on the GPU unless the caller asks for the
    CPU (``device="cpu"``, ``--device cpu``)."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def f32_precision(dtype: torch.dtype) -> None:
    """An f32 run (``compute_dtype: float32``) turns TF32 off for cuBLAS and
    cuDNN and logs it: cuDNN's default TF32 would run the plain f32
    convolutions (patch embed, CFI, EFE, PED) at ~3 decimal digits beside the
    f32-accurate kernels, and the f32 plain path is the accuracy anchor.

    The flags are process-wide and are not restored: once an f32 Predictor,
    Evaluator or Trainer is built, every later model in the process runs
    its f32 matmuls and convolutions without TF32 too (for a bf16 model,
    the f32 pieces such as decoder block 2's convs under ``int8_decoder``:
    slower, not less accurate).  The command line builds one engine per
    process; a program that mixes dtypes in one process and wants TF32 back
    for bf16 sets the two flags itself."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        logger.info("f32 compute: TF32 off for matmuls and convolutions")
