"""COD multi-component loss over fixed canvases (port of spegnet_tpu/losses.py).

Every loss term is computed at each sample's original ground-truth size:
the predictions are resized per sample to that size inside a fixed
``[B, Hc, Wc]`` canvas (ops/resize.resize_bilinear_dynamic), the ground
truths arrive placed top-left in the canvas, and every reduction is masked
by the per-sample validity region.  Zero padding beyond the valid region
coincides with torch's zero padding at the image border for the 3x3
Laplacian and the 31x31 average pool, so the values match a per-sample
computation.

  weight map  w = 1 + lb (|Laplacian3(m)| + |avgpool31(m) - m|)
  structure   Ls = lbce * sum(w BCEpw) / sum(w) + liou (1 - (i+1)/(u-i+1)),
              class-balanced pos_weight = clip(neg/pos, 0.1, 10)
  edge        Le = mean(focal(alpha, gamma, pos_weight)) + dice
  total       L = mean_b sum_s ws Ls_s + le mean_b Le

All loss math runs in f32 whatever the model's compute dtype (in f64 for
f64 logits).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.ops.resize import resize_bilinear_dynamic


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Weights; the defaults are configs/default.yaml's ``training.loss``."""

    scale_weights: Sequence[float] = (0.2, 0.3, 0.5)
    boundary_weight: float = 2.0
    bce_weight: float = 1.25
    iou_weight: float = 1.0
    edge_weight: float = 0.75
    edge_focal_alpha: float = 0.75
    edge_focal_gamma: float = 2.0

    @classmethod
    def from_dict(cls, d: Dict) -> "LossConfig":
        """Missing keys keep the field defaults."""
        kwargs = {f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d}
        if "scale_weights" in kwargs:
            kwargs["scale_weights"] = tuple(kwargs["scale_weights"])
        return cls(**kwargs)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box sum with zero padding over [B, H, W], separable, by
    differences of cumulative sums (exact for the {0, 1} masks it gets)."""
    p = k // 2
    for dim, pad in ((1, (0, 0, p + 1, p)), (2, (p + 1, p))):
        n = x.shape[dim]
        c = F.pad(x, pad).cumsum(dim)
        x = c.narrow(dim, k, n) - c.narrow(dim, 0, n)
    return x


def boundary_weight_map(mask: torch.Tensor, valid: torch.Tensor,
                        boundary_weight: float) -> torch.Tensor:
    """w = (1 + lb (|Laplacian| + |avgpool31 - m|)) * valid over [B, Hc, Wc].
    The Laplacian [[-1..],[.,8,.],[..-1]] is 9 m - boxsum3(m); the average
    pool (31, pad 15, count_include_pad) is boxsum31(m) / 961."""
    boundary = torch.abs(9.0 * mask - _box_sum(mask, 3))
    distance = torch.abs(_box_sum(mask, 31) / (31.0 * 31.0) - mask)
    return (1.0 + boundary_weight * (boundary + distance)) * valid


def _bce_with_logits(x: torch.Tensor, y: torch.Tensor, pos_weight: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy_with_logits(pos_weight=...) elementwise."""
    sp = F.softplus(-x)
    return (1.0 - y) * x + (1.0 + (pos_weight - 1.0) * y) * sp


def structure_loss(pred_logits: torch.Tensor, mask: torch.Tensor, weight_map: torch.Tensor,
                   valid: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """Per-sample structure loss [B] over canvases [B, Hc, Wc]."""
    num_pos = torch.sum(mask * valid, dim=(1, 2), keepdim=True)
    num_neg = torch.sum((1.0 - mask) * valid, dim=(1, 2), keepdim=True)
    pos_weight = torch.clamp(num_neg / (num_pos + 1e-7), 0.1, 10.0)

    bce = _bce_with_logits(pred_logits, mask, pos_weight)
    wsum = torch.sum(weight_map, dim=(1, 2))
    weighted_bce = torch.sum(weight_map * bce, dim=(1, 2)) / wsum

    pred_sig = torch.sigmoid(pred_logits)
    inter = torch.sum(pred_sig * mask * weight_map, dim=(1, 2))
    union = torch.sum((pred_sig + mask) * weight_map, dim=(1, 2))
    weighted_iou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return cfg.bce_weight * weighted_bce + cfg.iou_weight * weighted_iou


def edge_loss(edge_logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
              hw: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """Per-sample focal + dice edge loss [B]."""
    n_pix = (hw[:, 0] * hw[:, 1]).to(edge_logits.dtype)
    num_pos = torch.sum(target * valid, dim=(1, 2), keepdim=True)
    num_neg = n_pix[:, None, None] - num_pos
    pos_weight = torch.clamp(num_neg / (num_pos + 1e-7), 0.1, 10.0)

    sig = torch.sigmoid(edge_logits)
    pt = target * sig + (1.0 - target) * (1.0 - sig)
    focal_w = (1.0 - pt) ** cfg.edge_focal_gamma
    focal = -pos_weight * cfg.edge_focal_alpha * focal_w * torch.log(torch.clamp(pt, min=1e-7))
    focal_mean = torch.sum(focal * valid, dim=(1, 2)) / n_pix

    inter = torch.sum(sig * target * valid, dim=(1, 2))
    union = torch.sum(sig * valid, dim=(1, 2)) + torch.sum(target * valid, dim=(1, 2))
    dice = 1.0 - (2.0 * inter + 1.0) / (union + 1.0)
    return focal_mean + dice


def resize_logits_to_canvas(logits: torch.Tensor, hw: torch.Tensor, canvas_hw):
    """[B, h, w, 1] logits -> (each sample resized to its hw inside the
    canvas [B, Hc, Wc], validity mask [B, Hc, Wc])."""
    return resize_bilinear_dynamic(logits[..., 0], hw[:, 0], hw[:, 1], canvas_hw)


def cod_loss(predictions: Sequence[torch.Tensor], edge_logits: torch.Tensor,
             masks: torch.Tensor, edges: torch.Tensor, mask_hw: torch.Tensor,
             edge_hw: torch.Tensor, cfg: LossConfig,
             sample_weight: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The training loss: 3 scales of [B, h_s, w_s, 1] logits and the edge
    logits [B, he, we, 1] against canvas ground truths [B, Hc, Wc] of
    per-sample sizes mask_hw / edge_hw [B, 2].  ``sample_weight`` [B] makes
    the batch means weighted means."""
    canvas_hw = tuple(masks.shape[1:3])
    dt = wide(predictions[0]).dtype
    masks = masks.to(dt)
    edges = edges.to(dt)

    seg = torch.zeros((masks.shape[0],), dtype=dt, device=masks.device)
    weight_map = None
    for pred, ws in zip(predictions, cfg.scale_weights):
        pred_c, valid = resize_logits_to_canvas(pred.to(dt), mask_hw, canvas_hw)
        if weight_map is None:
            weight_map = boundary_weight_map(masks, valid, cfg.boundary_weight)
        seg = seg + ws * structure_loss(pred_c, masks, weight_map, valid, cfg)

    edge_c, evalid = resize_logits_to_canvas(edge_logits.to(dt), edge_hw, canvas_hw)
    edge = edge_loss(edge_c, edges, evalid, edge_hw, cfg)

    if sample_weight is None:
        seg_mean, edge_mean = seg.mean(), edge.mean()
    else:
        w = sample_weight.to(dt)
        denom = torch.clamp(w.sum(), min=1.0)
        seg_mean, edge_mean = (seg * w).sum() / denom, (edge * w).sum() / denom
    return {"loss": seg_mean + cfg.edge_weight * edge_mean, "seg_loss": seg_mean,
            "edge_loss": edge_mean}
