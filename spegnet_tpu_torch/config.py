"""Configuration loading for the port (port of spegnet_tpu/config.py).

The YAML layout is the reference's configs/default.yaml (model / training /
evaluation / prediction sections).  The user YAML comes first; for predict
(and evaluate) the model section embedded in the checkpoint overlays
``config['model']``.  PyYAML is imported only when a file is read.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_CONFIG_PATH = Path("./configs/default.yaml")
DEFAULT_MODEL_PATH = Path("./checkpoints/model_best.ckpt")

DEFAULT_CANVAS_BUCKETS = (512, 640, 768, 896, 1024, 1280, 1536, 2048)


def load_config(config_path: Optional[Path] = None) -> Dict[str, Any]:
    """Load a YAML config, falling back to configs/default.yaml."""
    import yaml

    for candidate in (config_path, DEFAULT_CONFIG_PATH):
        if candidate and Path(candidate).exists():
            with open(candidate) as f:
                cfg = yaml.safe_load(f)
            return _apply_defaults(cfg)
    raise RuntimeError(
        "No valid configuration found. Provide --config or create "
        f"{DEFAULT_CONFIG_PATH}")


def _apply_defaults(cfg: Dict[str, Any]) -> Dict[str, Any]:
    cfg = copy.deepcopy(cfg)
    model = cfg.setdefault("model", {})
    training = cfg.setdefault("training", {})
    # use_amp in the reference enables fp16 autocast + GradScaler; here it
    # means bf16 compute (no loss scaling needed).
    if "compute_dtype" not in model:
        model["compute_dtype"] = "bfloat16" if training.get("use_amp", True) else "float32"
    training.setdefault("canvas_buckets", list(DEFAULT_CANVAS_BUCKETS))
    cfg.setdefault("parallel", {"mesh": {"data": -1}})
    return cfg


# Inference-mode switches of the model section: how to run the weights, not
# what they are, so the user's YAML keeps them over a checkpoint's (the
# spatial axis must name an axis of the user's parallel.mesh).
INFERENCE_KEYS = ("int8_encoder", "int8_decoder", "spatial_axis")


def overlay_checkpoint_config(cfg: Dict[str, Any],
                              ckpt_config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Apply the checkpoint-embedded model config on top of the user config,
    except the user's :data:`INFERENCE_KEYS`."""
    if ckpt_config and "model" in ckpt_config:
        cfg = copy.deepcopy(cfg)
        keep = {k: cfg["model"][k] for k in INFERENCE_KEYS if k in cfg["model"]}
        cfg["model"].update(ckpt_config["model"])
        cfg["model"].update(keep)
    return cfg
