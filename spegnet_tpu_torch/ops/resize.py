"""Resizes with torch ``F.interpolate`` semantics (port of spegnet_tpu/ops/resize.py).

* :func:`resize_matrix_np` builds the same host-side [out, in] bilinear
  matrix as the JAX package (plain, or antialiased when downscaling); the
  image pipeline applies it with two BLAS matmuls.
* :func:`resize_bilinear` is ``F.interpolate(mode="bilinear",
  align_corners=False)`` on channels-last arrays, antialiased on request
  when downscaling.
* :func:`resize_bicubic` is ``F.interpolate(mode="bicubic",
  align_corners=False)`` (a = -0.75, clamped border taps): Hiera's
  background position embedding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spegnet_tpu_torch.ops import wide


def resize_matrix_np(in_size: int, out_size: int,
                     antialias: bool = False) -> np.ndarray:
    """[out_size, in_size] bilinear interpolation matrix (NumPy, host).

    ``antialias=False``: torch bilinear, align_corners=False (clamped
    source coordinate, two-tap lerp).  ``antialias=True`` and downscaling:
    torch's antialiased bilinear (triangle filter of support = scale,
    truncated at the borders, renormalized per output pixel)."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    if antialias and scale > 1.0:
        center = (dst + 0.5) * scale
        xmin = np.maximum((center - scale + 0.5).astype(np.int64), 0)
        xmax = np.minimum((center + scale + 0.5).astype(np.int64), in_size)
        max_taps = int((xmax - xmin).max())
        idx = xmin[:, None] + np.arange(max_taps)[None, :]
        w = np.maximum(0.0, 1.0 - np.abs((idx + 0.5) - center[:, None]) / scale)
        w = np.where(idx < xmax[:, None], w, 0.0)
        idx = np.minimum(idx, in_size - 1)
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        mat = np.zeros((out_size, in_size), dtype=np.float64)
        np.add.at(mat, (np.repeat(np.arange(out_size), max_taps), idx.ravel()),
                  w.ravel())
        return mat.astype(np.float32)
    src = np.clip(src, 0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = src - i0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.arange(out_size), i0), 1.0 - frac)
    np.add.at(mat, (np.arange(out_size), i1), frac)
    return mat.astype(np.float32)


def _interp_channels_last(x: torch.Tensor, out_hw, mode: str,
                          antialias: bool) -> torch.Tensor:
    """F.interpolate over the two spatial dims of [..., H, W] (2-D input) or
    [..., H, W, C] (3-D and up)."""
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    if x.dim() < 2:
        raise ValueError("resize needs at least 2 dims")
    if x.dim() == 2:
        y = F.interpolate(x[None, None], size=(h_out, w_out), mode=mode,
                          align_corners=False, antialias=antialias)
        return y[0, 0]
    *lead, h, w, c = x.shape
    if (h, w) == (h_out, w_out):
        return x
    xc = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(xc, size=(h_out, w_out), mode=mode, align_corners=False,
                      antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(*lead, h_out, w_out, c)


def resize_bilinear(x: torch.Tensor, out_hw, antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of the spatial dims (channels-last, or a 2-D map).
    Antialiasing applies only when downscaling, as in torch."""
    if x.dim() == 2:
        h, w = x.shape
    else:
        h, w = x.shape[-3], x.shape[-2]
    down = out_hw[0] < h or out_hw[1] < w
    return _interp_channels_last(x, out_hw, "bilinear", antialias and down)


def resize_bicubic(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize of [..., H, W, C] (torch semantics, a = -0.75)."""
    return _interp_channels_last(x, out_hw, "bicubic", False)


def _dynamic_axis_matrix(in_size: int, canvas: int, out_size: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, canvas, in_size] lerp matrices for per-sample target lengths
    ``out_size`` [B] (spegnet_tpu/ops/resize.py:198): torch bilinear
    (align_corners=False) onto an ``out_size``-long axis placed at the
    start of a ``canvas``-long one; rows at and beyond ``out_size`` are 0."""
    kw = dict(dtype=dtype, device=out_size.device)
    dst = torch.arange(canvas, **kw)
    out = out_size.to(dtype)[:, None]
    scale = in_size / out
    src = ((dst + 0.5) * scale - 0.5).clamp(0.0, in_size - 1)
    i0 = torch.floor(src)
    frac = src - i0
    i1 = torch.clamp(i0 + 1.0, max=in_size - 1)
    cols = torch.arange(in_size, **kw)
    w0 = torch.where(cols == i0[..., None], 1.0 - frac[..., None], 0.0)
    w1 = torch.where(cols == i1[..., None], frac[..., None], 0.0)
    return (w0 + w1) * (dst < out)[..., None]


def resize_bilinear_dynamic(x: torch.Tensor, out_h: torch.Tensor, out_w: torch.Tensor,
                            canvas_hw) -> tuple:
    """Resize each sample of ``x`` ([B, H, W] or [B, H, W, C]) to its own
    (out_h[b], out_w[b]) inside a fixed ``canvas_hw`` buffer
    (spegnet_tpu/ops/resize.py:220, batched over B).

    Returns ``(canvas, valid)``: canvas [B, Hc, Wc(, C)] f32 (f64 for an
    f64 ``x``) with the resized sample top-left and zeros elsewhere, and the
    validity mask [B, Hc, Wc] in the same dtype.  Inside the valid region
    the values are
    ``F.interpolate(x, (out_h, out_w), mode="bilinear", align_corners=False)``."""
    hc, wc = canvas_hw
    squeeze = x.dim() == 3
    if squeeze:
        x = x[..., None]
    x = wide(x)
    a_h = _dynamic_axis_matrix(x.shape[1], hc, out_h, x.dtype)
    a_w = _dynamic_axis_matrix(x.shape[2], wc, out_w, x.dtype)
    y = torch.einsum("bhi,biwc->bhwc", a_h, x)
    y = torch.einsum("bwj,bhjc->bhwc", a_w, y)
    rows = torch.arange(hc, device=x.device)[None, :] < out_h[:, None]
    cols = torch.arange(wc, device=x.device)[None, :] < out_w[:, None]
    valid = (rows[:, :, None] & cols[:, None, :]).to(x.dtype)
    y = y * valid[..., None]
    return (y[..., 0] if squeeze else y), valid
