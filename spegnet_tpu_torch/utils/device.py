"""The device an entry point runs on."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``device`` or, when None, the card.  Raises when CUDA is asked for and
    there is none: the port runs on the GPU unless the caller asks for the
    CPU (``device="cpu"``, ``--device cpu``)."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
