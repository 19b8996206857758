"""COD metrics on the device, batched over a canvas (port of
spegnet_tpu/metrics/jax_metrics.py).

The five metrics of the reference's PySODMetrics (S_alpha, weighted F_beta,
MAE, adaptive E_phi, mean F_beta over the 256-threshold curve) as masked
reductions over a fixed ``[B, Hc, Wc]`` canvas: every per-sample quantity is
a sum over the sample's valid region, quadrants are indicator-weighted sums,
the threshold histogram a scatter-add and the weighted-F Gaussian a 7x7
shifted sum.  Everything runs in f32 on the tensors' device, as the JAX
package computes it in XLA, outside any Pallas kernel, except that each
per-sample sum accumulates in f64 before it is rounded to f32: over a 640²
canvas an f32 sum's order (the card's tree against the CPU's cascade) moved
a metric by up to 2.5e-4 (measured on an H100, random-weight predictions:
the covariance of the region SSIM cancels), where f64 sums agree to the
f32 rounding.

The Euclidean distance transform of each ground truth (for the weighted F)
is the one host-side piece (:func:`edt_for_canvas`, scipy): it depends on
the ground truth alone, so the input pipeline computes it per sample.
Predictions arrive as ``uint8 = trunc(sigmoid(logit) * 255)``
(:func:`quantize_predictions`), ground truths as {0, 1}.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_EPS = float(np.spacing(1))


def edt_for_canvas(gt: np.ndarray, canvas_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Distance to the nearest foreground pixel and that pixel's canvas-flat
    index, for one ground truth [h, w] placed top-left in a canvas
    (``edt_for_canvas`` :43): dst [Hc, Wc] f32 (0 on foreground and outside
    the valid region), idx [Hc, Wc] int32 (identity outside it)."""
    hc, wc = canvas_hw
    h, w = gt.shape
    dst = np.zeros((hc, wc), np.float32)
    yy, xx = np.mgrid[0:hc, 0:wc]
    idx = (yy * wc + xx).astype(np.int32)
    fg = np.asarray(gt) > 0
    if fg.any():
        from scipy import ndimage

        d, (iy, ix) = ndimage.distance_transform_edt(~fg, return_indices=True)
        dst[:h, :w] = d.astype(np.float32)
        idx[:h, :w] = (iy.astype(np.int64) * wc + ix.astype(np.int64)).astype(np.int32)
    return dst, idx


@functools.lru_cache(maxsize=1)
def _gauss7() -> np.ndarray:
    """MATLAB fspecial('gaussian', 7, 5)."""
    y, x = np.ogrid[-3:4, -3:4]
    h = np.exp(-(x * x + y * y) / 50.0)
    h /= h.sum()
    return h.astype(np.float32)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Per-sample sum over the canvas, accumulated in f64, as f32."""
    return x.sum(dim=(1, 2), dtype=torch.float64).float()


@functools.lru_cache(maxsize=None)
def _u8_values(device: torch.device) -> torch.Tensor:
    """k / 255 in f32 for k = 0..255, divided on the host: the card divides
    by a scalar as a product with its reciprocal, one ulp off for some k,
    and a k / 255 one ulp low truncates into the bin below in the F-curve."""
    return (torch.arange(256, dtype=torch.float32) / 255.0).to(device)


def _prepare(pred_u8: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """u8 -> [0, 1], min-max normalized per sample over its valid region
    (PySODMetrics' prepare_data); zero outside it."""
    p = _u8_values(pred_u8.device)[pred_u8.long()]
    inf = torch.tensor(float("inf"), device=p.device)
    pmin = torch.where(valid > 0, p, inf).amin(dim=(1, 2), keepdim=True)
    pmax = torch.where(valid > 0, p, -inf).amax(dim=(1, 2), keepdim=True)
    norm = torch.where(pmax > pmin, (p - pmin) / (pmax - pmin + 0.0), p)
    return norm * valid


def _s_object_part(values: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """2 x / (x^2 + 1 + sigma_x) over the pixels where sel == 1 (ddof 1)."""
    cnt = _sum(sel)
    x = _sum(values * sel) / torch.clamp(cnt, min=1.0)
    var = _sum(sel * (values - x[:, None, None]) ** 2) / torch.clamp(cnt - 1.0, min=1.0)
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    score = 2.0 * x / (x * x + 1.0 + sigma + _EPS)
    return torch.where(cnt > 0, score, torch.zeros_like(score))


def _ssim_masked(pred: torch.Tensor, gt: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Region SSIM over the indicator q (a rectangle), PySOD's form."""
    n = _sum(q)
    safe_n = torch.clamp(n, min=1.0)
    x = _sum(pred * q) / safe_n
    y = _sum(gt * q) / safe_n
    dn = torch.clamp(n - 1.0, min=1.0)
    dx, dy = pred - x[:, None, None], gt - y[:, None, None]
    sigma_x = _sum(q * dx ** 2) / dn
    sigma_y = _sum(q * dy ** 2) / dn
    sigma_xy = _sum(q * dx * dy) / dn
    alpha = 4.0 * x * y * sigma_xy
    beta = (x * x + y * y) * (sigma_x + sigma_y)
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    score = torch.where(alpha != 0.0, alpha / (beta + _EPS), torch.where(beta == 0.0, one, zero))
    return torch.where(n > 0, score, zero)


def _smeasure(pred, gt, valid, n_pix):
    b, hc, wc = pred.shape
    rows = torch.arange(hc, dtype=torch.float32, device=pred.device)[None, :, None]
    cols = torch.arange(wc, dtype=torch.float32, device=pred.device)[None, None, :]
    gt_cnt = _sum(gt * valid)
    y_frac = gt_cnt / n_pix
    mean_pred = _sum(pred * valid) / n_pix

    obj = y_frac * _s_object_part(pred * gt, gt * valid) + (1.0 - y_frac) * _s_object_part(
        (1.0 - pred) * (1.0 - gt), (1.0 - gt) * valid)

    safe_gt_cnt = torch.clamp(gt_cnt, min=1.0)
    cy = torch.round(_sum(rows * gt * valid) / safe_gt_cnt) + 1.0
    cx = torch.round(_sum(cols * gt * valid) / safe_gt_cnt) + 1.0
    top = rows < cy[:, None, None]
    left = cols < cx[:, None, None]
    region = torch.zeros_like(y_frac)
    for qa, qb in ((top, left), (top, ~left), (~top, left), (~top, ~left)):
        q = (qa & qb).float() * valid
        region = region + _sum(q) / n_pix * _ssim_masked(pred, gt, q)

    sm = torch.clamp(0.5 * obj + 0.5 * region, min=0.0)
    sm = torch.where(y_frac == 0.0, 1.0 - mean_pred, sm)
    return torch.where(y_frac == 1.0, mean_pred, sm)


def _emeasure_adaptive(pred, gt, valid, n_pix):
    mean_pred = _sum(pred * valid) / n_pix
    thr = torch.clamp(2.0 * mean_pred, max=1.0)
    binar = (pred >= thr[:, None, None]).float() * valid
    gt_fg = _sum(gt * valid)
    fg_fg = _sum(binar * gt)
    fg_bg = _sum(binar * (1.0 - gt) * valid)
    fg = fg_fg + fg_bg
    bg = n_pix - fg
    bg_fg = gt_fg - fg_fg
    bg_bg = bg - bg_fg
    mean_p = fg / n_pix
    mean_g = gt_fg / n_pix

    def enhance(pv, gv, numel):
        align = 2.0 * pv * gv / (pv * pv + gv * gv + _EPS)
        return (align + 1.0) ** 2 / 4.0 * numel

    general = (enhance(1.0 - mean_p, 1.0 - mean_g, fg_fg)
               + enhance(1.0 - mean_p, -mean_g, fg_bg)
               + enhance(-mean_p, 1.0 - mean_g, bg_fg)
               + enhance(-mean_p, -mean_g, bg_bg))
    enhanced = torch.where(gt_fg == 0.0, bg, torch.where(gt_fg == n_pix, fg, general))
    return enhanced / (n_pix - 1.0 + _EPS)


def _gauss_blur(x: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian of [B, H, W] with zero padding, as 49 shifted f32 sums
    (exact f32 on every device: no TF32 convolution)."""
    k = _gauss7()
    h, w = x.shape[1:]
    xp = torch.nn.functional.pad(x, (3, 3, 3, 3))
    out = torch.zeros_like(x)
    for dy in range(7):
        for dx in range(7):
            out = out + float(k[dy, dx]) * xp[:, dy:dy + h, dx:dx + w]
    return out


def _weighted_fmeasure(pred, gt, valid, dst, nearest_idx):
    b, hc, wc = pred.shape
    e = (pred - gt).abs() * valid
    gathered = torch.gather(e.reshape(b, hc * wc), 1, nearest_idx.reshape(b, -1).long())
    et = torch.where(gt > 0, e, gathered.reshape(b, hc, wc)) * valid
    ea = _gauss_blur(et)
    min_e_ea = torch.where((gt > 0) & (ea < e), ea, e)
    bmap = torch.where(gt > 0, torch.ones_like(dst),
                       2.0 - torch.exp(float(np.log(0.5) / 5.0) * dst))
    ew = min_e_ea * bmap * valid
    gt_sum = _sum(gt * valid)
    ew_fg = _sum(ew * gt)
    tpw = gt_sum - ew_fg
    fpw = _sum(ew * (1.0 - gt) * valid)
    r = 1.0 - ew_fg / torch.clamp(gt_sum, min=1.0)
    p = tpw / (tpw + fpw + _EPS)
    q = 2.0 * r * p / (r + p + _EPS)
    return torch.where(gt_sum > 0, q, torch.zeros_like(q))


def _fmeasure_curve_mean(pred, gt, valid, beta2: float = 0.3):
    b = pred.shape[0]
    pred_q = (pred * 255.0).to(torch.uint8).long().reshape(b, -1)
    fg_w = (gt * valid).reshape(b, -1)
    bg_w = ((1.0 - gt) * valid).reshape(b, -1)
    zeros = torch.zeros((b, 256), dtype=torch.float32, device=pred.device)
    fg_hist = zeros.scatter_add(1, pred_q, fg_w)
    bg_hist = zeros.scatter_add(1, pred_q, bg_w)
    tps = torch.cumsum(torch.flip(fg_hist, dims=(1,)), dim=1)
    ps = tps + torch.cumsum(torch.flip(bg_hist, dims=(1,)), dim=1)
    ps = torch.where(ps == 0, torch.ones_like(ps), ps)
    t = torch.clamp(_sum(gt * valid), min=1.0)
    precisions = tps / ps
    recalls = tps / t[:, None]
    num = (1.0 + beta2) * precisions * recalls
    den = torch.where(num == 0, torch.ones_like(num), beta2 * precisions + recalls)
    return (num / den).mean(dim=1)


def compute_batch_metrics(pred_u8: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
                          hw: torch.Tensor, dst: Optional[torch.Tensor] = None,
                          nearest_idx: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """All five COD metrics of a batch, each [B] f32 (``compute_batch_metrics``
    :246): pred_u8 [B, Hc, Wc] u8, gt {0, 1} and valid [B, Hc, Wc], hw [B, 2]
    the true sizes; ``dst`` / ``nearest_idx`` (:func:`edt_for_canvas`) add
    the weighted F-measure ``wfm``."""
    gt = gt.float()
    valid = valid.float()
    n_pix = (hw[:, 0] * hw[:, 1]).float()
    pred = _prepare(pred_u8, valid)
    out = {
        "mae": _sum((pred - gt).abs() * valid) / n_pix,
        "sm": _smeasure(pred, gt, valid, n_pix),
        "em": _emeasure_adaptive(pred, gt, valid, n_pix),
        "fm": _fmeasure_curve_mean(pred, gt, valid),
    }
    if dst is not None and nearest_idx is not None:
        out["wfm"] = _weighted_fmeasure(pred, gt, valid, dst.float(), nearest_idx)
    return out


def compute_sample_metrics(pred_u8, gt, valid, hw, dst=None, nearest_idx=None):
    """One sample (``compute_sample_metrics`` :275): adds and removes the batch dim."""
    def one(t):
        return None if t is None else t[None]

    batched = compute_batch_metrics(pred_u8[None], gt[None], valid[None], hw[None], one(dst),
                                    one(nearest_idx))
    return {k: v[0] for k, v in batched.items()}


def quantize_predictions(logits: torch.Tensor) -> torch.Tensor:
    """sigmoid -> x 255 -> uint8 truncation, in f32 (``quantize_predictions`` :285)."""
    return (torch.sigmoid(logits.float()) * 255.0).to(torch.uint8)
