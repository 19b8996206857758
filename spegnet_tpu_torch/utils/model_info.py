"""Model architecture and complexity report (port of
spegnet_tpu/utils/model_info.py).

The reference prints ptflops' MACs and parameters (reference:
main.py:366-423); the JAX package prints XLA's HLO cost analysis of the
jitted forward.  Here the model is built on the ``meta`` device (shapes
only: no memory, no weights) and its plain path (``kernels=False``: the
kernels are ctypes launches no counter sees) runs once at batch 1 under
``torch.utils.flop_counter.FlopCounterMode``, which counts 2 FLOPs per
multiply-add of every matmul, convolution and attention product and
nothing for elementwise work, normalization or resizing (XLA's analysis
counts those too).  Under a model axis of M the report adds the parameters
each rank holds (parallel/sharding.param_spec: the encoder's qkv, proj,
fc1 and fc2 split M ways, the rest whole); a spatial axis beside it splits
tokens, not parameters, so the count per rank is M's alone.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Union

import torch
import torch.nn as nn

from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.parallel.sharding import shard_dim

logger = logging.getLogger(__name__)


def meta_model(config: Union[SPEGNetConfig, Dict[str, Any]]) -> SPEGNet:
    """The plain-path SPEGNet of a config (or a config's ``model`` section)
    on the meta device."""
    if isinstance(config, dict):
        config = SPEGNetConfig.from_dict(config)
    with torch.device("meta"):
        return SPEGNet(config, kernels=False)


def _count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def model_complexity(config: Union[SPEGNetConfig, Dict[str, Any]], input_size: int,
                     flops: bool = True) -> Dict[str, Any]:
    """{"params": the exact parameter count, "flops": forward FLOPs of one
    ``input_size``^2 image (None without ``flops``)}."""
    model = meta_model(config).eval()
    out = {"params": _count(model), "flops": None}
    if flops:
        from torch.utils.flop_counter import FlopCounterMode

        x = torch.zeros((1, input_size, input_size, 3), device="meta")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
        out["flops"] = int(counter.get_total_flops())
    return out


def params_per_rank(config: Union[SPEGNetConfig, Dict[str, Any]], model_axis: int) -> int:
    """The parameters one rank holds under a model axis of ``model_axis``."""
    return sum(p.numel() // (model_axis if shard_dim(n) is not None else 1)
               for n, p in meta_model(config).named_parameters())


def architecture_lines(config: Union[SPEGNetConfig, Dict[str, Any]],
                       max_depth: int = 2) -> List[str]:
    """The module tree with per-module parameter counts, collapsed below
    ``max_depth`` (the reference's model-structure dump): a module's own
    parameters by shape, each child with its count, opened while it has
    children of its own and ``max_depth`` is not reached."""
    model = meta_model(config)
    lines = [f"{type(model).__name__}("]

    def walk(module: nn.Module, depth: int) -> None:
        indent = "  " * depth
        for name, p in module.named_parameters(recurse=False):
            lines.append(f"{indent}{name}: {tuple(p.shape)}")
        for name, child in module.named_children():
            n = _count(child)
            if not n:
                continue
            if depth >= max_depth or not any(_count(c) for c in child.children()):
                lines.append(f"{indent}{name}: {n / 1e6:.3f} M params")
            else:
                lines.append(f"{indent}{name}:  # {n / 1e6:.3f} M params")
                walk(child, depth + 1)

    walk(model, 1)
    lines.append(")")
    return lines


def print_model_info(config: Union[SPEGNetConfig, Dict[str, Any]], input_size: int,
                     model_axis: int = 1) -> None:
    logger.info("Analyzing model architecture and complexity...")
    logger.info("Model architecture:")
    for line in architecture_lines(config):
        logger.info(line)
    info = model_complexity(config, input_size)
    logger.info("-" * 30)
    logger.info(f"Number of Parameters: {info['params'] / 1e6:.2f} M")
    if model_axis > 1:
        logger.info(f"Parameters per rank (model axis {model_axis}): "
                    f"{params_per_rank(config, model_axis) / 1e6:.2f} M")
    logger.info(f"Computational Cost: {info['flops'] / 1e9:.2f} GFLOPs "
                f"(torch FlopCounterMode, matmuls / convolutions / attention, "
                f"batch 1 @ {input_size}^2)")
    logger.info("-" * 30)
