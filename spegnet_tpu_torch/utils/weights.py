"""Weights for the port: the JAX variable tree carried across, and seeded
random initialization.

:func:`state_dict_from_jax` reimplements, without JAX, the JAX package's
``export_spegnet_state_dict`` (spegnet_tpu/utils/torch_import.py:325): the
flax ``{'params', 'batch_stats'}`` tree (nested dicts of arrays) becomes the
reference-schema state dict (NumPy arrays), which ``SPEGNet.load_state_dict``
takes with ``strict=True``.

:func:`init_weights` fills a model from a ``torch.Generator`` with the
JAX package's initializers: truncated-normal fan-in (lecun) kernels, zero
biases, identity norms; the position embeddings get a small normal so the
bicubic path carries signal.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

_LN = {"scale": "weight", "bias": "bias"}
_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))     # HWIO -> OIHW


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))           # [in, out] -> [out, in]


def _posembed(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 0, 1))[None]  # [H, W, C] -> [1, C, H, W]


def _hiera(p: Dict, out: Dict, prefix: str) -> None:
    for name, sub in p.items():
        if name in ("pos_embed", "pos_embed_window"):
            out[prefix + name] = _posembed(sub)
        elif name == "patch_embed":
            out[prefix + "patch_embed.proj.weight"] = _conv(sub["kernel"])
            out[prefix + "patch_embed.proj.bias"] = sub["bias"]
        elif name.startswith("block"):
            b = f"{prefix}blocks.{int(name[5:])}."
            for ln in ("norm1", "norm2"):
                for fk, tk in _LN.items():
                    out[f"{b}{ln}.{tk}"] = sub[ln][fk]
            for path, key in ((("attn", "qkv"), "attn.qkv"), (("attn", "proj"), "attn.proj"),
                              (("mlp_fc1",), "mlp.layers.0"), (("mlp_fc2",), "mlp.layers.1"),
                              (("proj",), "proj")):
                node = sub
                for k in path:
                    node = node.get(k) if isinstance(node, dict) else None
                    if node is None:
                        break
                if node is None:
                    continue
                out[f"{b}{key}.weight"] = _linear(node["kernel"])
                if "bias" in node:
                    out[f"{b}{key}.bias"] = node["bias"]


def trunk_state_dict_from_jax(params: Dict) -> Dict[str, np.ndarray]:
    """The Hiera trunk's flax params -> ``Hiera`` state dict (no prefix)."""
    out: Dict[str, np.ndarray] = {}
    _hiera(_np(params), out, "")
    return out


def _bn(params: Dict, stats: Dict, out: Dict, key: str) -> None:
    for fk, tk in _BN_PARAM.items():
        out[f"{key}.{tk}"] = params[fk]
    for fk, tk in _BN_STAT.items():
        out[f"{key}.{tk}"] = stats[fk]
    out[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)


def _conv_bn(params, stats, out, conv_key, bn_key) -> None:
    out[f"{conv_key}.weight"] = _conv(params["conv"]["kernel"])
    _bn(params["bn"], stats["bn"], out, bn_key)


def state_dict_from_jax(tree: Dict) -> Dict[str, np.ndarray]:
    """flax ``{'params', 'batch_stats'}`` -> reference-schema state dict."""
    p = _np(tree["params"])
    s = _np(tree.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}
    _hiera(p["encoder"], out, "encoder.encoder.")

    out["fusion.conv1x1.weight"] = _conv(p["fusion"]["conv1x1"]["kernel"])
    _bn(p["fusion"]["bn"], s["fusion"]["bn"], out, "fusion.bn")
    out["fusion.se_block.fc.0.weight"] = _linear(p["fusion"]["se_block"]["fc1"]["kernel"])
    out["fusion.se_block.fc.2.weight"] = _linear(p["fusion"]["se_block"]["fc2"]["kernel"])

    cp, cs = p["context"], s["context"]
    _conv_bn(cp["reduce"], cs["reduce"], out, "context.reduce.0", "context.reduce.1")
    k = 0
    while f"branch{k}" in cp:
        _conv_bn(cp[f"branch{k}"], cs[f"branch{k}"], out,
                 f"context.branches.{k}.0", f"context.branches.{k}.1")
        k += 1
    _conv_bn(cp["global_branch"], cs["global_branch"], out,
             "context.global_branch.1", "context.global_branch.2")
    _conv_bn(cp["fusion"], cs["fusion"], out, "context.fusion.0", "context.fusion.1")
    _conv_bn(cp["expand"], cs["expand"], out, "context.expand.0", "context.expand.1")

    ep, es = p["edge_detector"], s["edge_detector"]
    out["edge_detector.conv1.weight"] = _conv(ep["conv1"]["kernel"])
    _bn(ep["bn1"], es["bn1"], out, "edge_detector.bn1")
    out["edge_detector.edge_conv.weight"] = _conv(ep["edge_conv"]["kernel"])
    out["edge_detector.edge_conv.bias"] = ep["edge_conv"]["bias"]

    dp, ds = p["decoder"], s["decoder"]
    i = 0
    while f"block{i}" in dp:
        b = f"decoder.decoder_blocks.{i}"
        for num in (1, 2):
            conv = dp[f"block{i}"][f"conv{num}"]
            out[f"{b}.conv{num}.weight"] = _conv(conv["kernel"])
            out[f"{b}.conv{num}.bias"] = conv["bias"]
            _bn(dp[f"block{i}"][f"bn{num}"], ds[f"block{i}"][f"bn{num}"], out,
                f"{b}.bn{num}")
        out[f"decoder.pred_heads.{i}.weight"] = _conv(dp[f"head{i}"]["kernel"])
        out[f"decoder.pred_heads.{i}.bias"] = dp[f"head{i}"]["bias"]
        i += 1
    return out


def to_torch(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict.items()}


def _lecun_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax lecun_normal: truncated normal on [-2, 2], variance 1 / fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.8796256610342398
    z = torch.randn(w.shape, generator=g).clamp_(-2.0, 2.0)
    with torch.no_grad():
        w.copy_(z * std)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in place (run on the CPU, before to_compute)."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            _lecun_(m.weight, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            _lecun_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
    for name, p in model.named_parameters():
        if name.endswith("pos_embed") or name.endswith("pos_embed_window"):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))
    return model
