"""Checkpoint loading for the port (port of spegnet_tpu/engine/model_loader.py).

Only reference PyTorch ``.pth`` checkpoints (``{'model_state_dict', 'config',
...}``, as ``save_torch_checkpoint`` writes them) are read: their state dict
is already in this package's parameter names.  Orbax directories written by
the JAX trainer are refused with a clear error.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]]]:
    """Returns ``(state_dict, embedded_config_or_None)``."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Model checkpoint not found: {path}")
    if p.is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); the "
            "PyTorch port reads .pth files only - export one with "
            "spegnet_tpu.utils.torch_import.save_torch_checkpoint")
    ckpt = torch.load(str(p), map_location="cpu", weights_only=False)
    if "model_state_dict" not in ckpt:
        raise ValueError(f"Unrecognized checkpoint schema at {path}: {list(ckpt)[:5]}")
    return ckpt["model_state_dict"], ckpt.get("config")


def load_checkpoint_config(path: str) -> Dict[str, Any]:
    _, config = load_checkpoint(path)
    if config is None:
        raise ValueError(f"Checkpoint does not contain configuration: {path}")
    return config
