"""Whole Hiera block and Q-pool transition front (port of spegnet_tpu/ops/fused_block_t.py).

The trunk's kernel path runs token-major ``[B, N, C]`` in Morton (Z) order
on a square 2^k patch grid: :func:`to_z` is the JAX package's ``to_z``
(:570) transposed.  In that order every attention window of every stage is
L consecutive rows and every 2x2 pool group is 4 consecutive rows, so one
layout serves the whole trunk.  Morton order is the one-window case of
the window-major layout (:func:`to_w`), which serves other grids in place
of ``to_t`` (:235), ``from_t`` and ``to_t_micro`` (:608): windows in raster
order, each window in the order that makes its 2x2 pool groups 4
consecutive rows, which is again window-major at the pooled grid with half
the window.

Each operator comes in two forms:

* a plain PyTorch version (:func:`block_plain`, :func:`qpool_front_plain`),
  the same math as ``block_t_reference`` (:1070) and
  ``qpool_front_reference`` (:737) with unpadded nn.Linear weights;
* a wrapper (:func:`fused_block_t`, :func:`qpool_front`) that runs the plain
  version for a CPU tensor (autograd differentiates it) and, for a CUDA
  tensor, the hand-written kernels of ``csrc/hiera_block.cu`` /
  ``csrc/qpool_front.cu`` inside a ``torch.autograd.Function`` whose
  backward is the kernel chain of ``csrc/hiera_block_bwd.cu`` /
  ``csrc/qpool_front_bwd.cu`` (see there for what each replaces and what
  bounds it) -- or raises on what they do not cover.  Like the JAX
  package's custom_vjp with residuals off, the Function saves only the
  input and the weights and recomputes the forward in its backward; weight
  gradients are summed in f32 and returned in each weight's dtype.

The T-block also has the JAX package's saved-residual pair (``_forward_res``
:499 / ``_backward_res`` :1570): under autograd, where
:func:`save_residuals` holds (``SPEGNET_SAVE_RESIDUALS``), its forward keeps
the tensors the backward would recompute (:class:`BlockResiduals`) and its
backward reads them (:func:`block_cuda_res`, :func:`block_cuda_bwd_res`;
plain versions :func:`block_plain_res`, :func:`block_plain_bwd_res`).  Its
output and gradients are bit-equal to the recompute pair's.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.ops.attention import attention_reference


class BlockWeights(NamedTuple):
    """One non-pooling block's parameters in nn.Linear layout ([out, in]).
    LayerNorm parameters are f32; the rest are in the compute dtype."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wqkv: torch.Tensor     # [3*H*d, C]
    bqkv: torch.Tensor
    wproj: torch.Tensor    # [C, H*d]
    bproj: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    wfc1: torch.Tensor     # [hidden, C]
    bfc1: torch.Tensor
    wfc2: torch.Tensor     # [C, hidden]
    bfc2: torch.Tensor


class BlockResiduals(NamedTuple):
    """What the saved-residual forward keeps for its backward, token-major
    [B*N, ...] in the compute dtype (``BlockResiduals`` :441 transposed, plus
    g and lse): the backward then reruns only the two LayerNorms."""

    qkv: torch.Tensor   # [B*N, 3*H*d]
    a: torch.Tensor     # attention output [B*N, H*d]
    u: torch.Tensor     # x + proj [B*N, C]
    z: torch.Tensor     # fc1 pre-activation [B*N, hidden]
    # gelu(fc1), fc2's input.  JAX rebuilds it from the saved z; here it is
    # kept, since the kernel rounds it from the f32 sum that z is rounded
    # from, and gelu of the rounded z differs from it in the last bit.
    g: torch.Tensor     # [B*N, hidden]
    # Each query row's log-sum-exp in log2 units, [B*N, H] f32, from which
    # the attention backward kernel rebuilds P; None from the plain version,
    # whose backward rebuilds P from q and k.
    lse: Optional[torch.Tensor] = None


class QPoolWeights(NamedTuple):
    """Front half of a Q-pooling transition block (Cin -> Cout)."""

    ln_w: torch.Tensor
    ln_b: torch.Tensor
    wqkv: torch.Tensor     # [3*H*d, Cin]
    bqkv: torch.Tensor
    wsc: torch.Tensor      # [Cout, Cin] shortcut projection
    bsc: torch.Tensor


# ---------------------------------------------------------------------------
# token-major layouts
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _window_order(ws: int) -> np.ndarray:
    """Raster position in a ws x ws window of each row of the window-major
    layout: for even ws the 2x2 micro-windows are 4 consecutive rows (raster
    inside) ordered as the (ws/2)^2 window is, recursively; odd ws is raster.
    A 2^k window is in Morton order (y bit above x bit per level), so every
    aligned 2^j x 2^j block of it is a run of consecutive rows."""
    if ws % 2:
        return np.arange(ws * ws)
    half = ws // 2
    my, mx = np.divmod(_window_order(half), half)
    dy, dx = np.divmod(np.arange(4), 2)
    return ((2 * my[:, None] + dy) * ws + 2 * mx[:, None] + dx).reshape(-1)


@functools.lru_cache(maxsize=None)
def _window_index(h: int, w: int, ws: int) -> np.ndarray:
    """raster index of each row of the window-major layout of an h x w grid
    (ws x ws windows in raster order, each in :func:`_window_order`)."""
    if h % ws or w % ws:
        raise ValueError(f"windows of {ws} do not tile the {(h, w)} grid")
    oy, ox = np.divmod(_window_order(ws), ws)
    wy = np.arange(h // ws).repeat(w // ws)[:, None] * ws
    wx = np.tile(np.arange(w // ws), h // ws)[:, None] * ws
    return ((wy + oy) * w + wx + ox).reshape(-1)


@functools.lru_cache(maxsize=None)
def _index(h: int, w: int, ws: int, device: torch.device, inverse: bool) -> torch.Tensor:
    """Gather index of the window-major layout with windows of ``ws``."""
    idx = _window_index(h, w, ws)
    if inverse:
        idx = np.argsort(idx)
    # a normal tensor even when first made under inference_mode (predict),
    # so that a later training forward may save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device)


def _check_morton(h: int, w: int) -> None:
    if h != w or h & (h - 1):
        raise ValueError(f"Morton order needs H == W == 2^k, got {(h, w)}")


def to_z(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, C] in Morton order (H == W == 2^k): the
    window-major layout with one window of the whole grid."""
    _check_morton(*x.shape[1:3])
    return to_w(x, x.shape[1])


def from_z(xz: torch.Tensor, hw) -> torch.Tensor:
    """Inverse of :func:`to_z`: [B, N, C] -> [B, H, W, C]."""
    _check_morton(*hw)
    return from_w(xz, hw[0], hw)


def keeps_windows(lay, ws: int) -> bool:
    """Whether every ws x ws window (ws 0: the whole grid) is a run of
    consecutive rows of the window-major layout with windows of ``lay`` (0:
    raster; None: no token layout).  A window of lay keeps its aligned
    2^j x 2^j blocks consecutive (:func:`_window_order`), so a Morton layout
    (one 2^k window) keeps every 2^j window of the trunk."""
    if lay is None:
        return False
    if ws == 0:
        return True
    return lay != 0 and (ws == lay or (ws & (ws - 1) == 0 and lay % ws == 0))


def to_w(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, C] window-major with ws x ws windows (ws | H,
    ws | W); ws == 0 is raster order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h * w, c)
    return x if ws == 0 else x.index_select(1, _index(h, w, ws, x.device, False))


def from_w(xw: torch.Tensor, ws: int, hw) -> torch.Tensor:
    """Inverse of :func:`to_w`: [B, N, C] -> [B, H, W, C]."""
    b, n, c = xw.shape
    h, w = hw
    if h * w != n:
        raise ValueError(f"from_w: {n} tokens vs {(h, w)}")
    if ws:
        xw = xw.index_select(1, _index(h, w, ws, xw.device, True))
    return xw.reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

# spegnet_tpu/ops/fused_block_t.py:65: the longest exact window of the T-kernel.
_MAX_L = 1024


def _pick_cw(l: int, n_tok: int) -> int:
    """The TPU kernels' attention chunk width (``_pick_cw`` :189 under its
    default policy, and ``_pick_cw_qpool`` :1030, which agree)."""
    return l if l >= 512 else min(512, n_tok)


def supported(c: int, heads: int, l: int, n_tok: int) -> bool:
    """Shape rules of the T-kernel gate (``supported`` :203), windows of l
    tokens over n_tok tokens per image: blocks with more than 8 heads, or
    windows that do not tile its chunks, take the gen-1 kernel
    (ops/fused_block.py) or the decomposed block in the JAX package."""
    if c % 16 or heads > 8:
        return False
    ok = (l % 128 == 0 and l <= _MAX_L) if l >= 128 else 128 % l == 0
    cw = _pick_cw(l, n_tok)
    return ok and cw % max(l, 128) == 0 and n_tok % cw == 0


# The saved-residual policy of the training backward, JAX's knob and values
# (spegnet_tpu/ops/fused_block_t.py:461): "0" off, "1" on, "auto" where a
# block's batch holds at most 32768 tokens.  Read at import;
# :func:`residuals_mode` sets it for a block of code.  The default is JAX's
# "0": on an H100 the pair takes ~5% off a Hiera-L 512^2 batch-8 step's
# device time, but the step is host-bound and its time did not move
# reliably (PERF.md).
SAVE_RESIDUALS = os.environ.get("SPEGNET_SAVE_RESIDUALS", "0")


def save_residuals(b: int, n_tok: int) -> bool:
    """Whether a T-block of b images of n_tok tokens runs the saved-residual
    pair when it is trained (``_save_res_ok`` :464 on one card).  JAX's
    second condition, ``_res_bwd_vmem_ok`` (:478), checks the TPU kernel's
    VMEM footprint; the pair here is a chain of launches through device
    memory and has no such limit."""
    if SAVE_RESIDUALS not in ("0", "1", "auto"):
        raise ValueError(f"SPEGNET_SAVE_RESIDUALS={SAVE_RESIDUALS!r}: expected 0, 1 or auto")
    if SAVE_RESIDUALS == "auto":
        return b * n_tok <= 32768
    return SAVE_RESIDUALS == "1"


@contextlib.contextmanager
def residuals_mode(mode: str):
    """:data:`SAVE_RESIDUALS` set to ``mode`` inside the block."""
    global SAVE_RESIDUALS
    saved, SAVE_RESIDUALS = SAVE_RESIDUALS, mode
    try:
        yield
    finally:
        SAVE_RESIDUALS = saved


def qpool_supported(cin: int, heads: int, l: int, n_tok: int) -> bool:
    """Shape rules of the transition-front gate (``qpool_supported``
    :1039)."""
    if cin % 16 or l % 4 or l > 256:
        return False
    ok = l % 128 == 0 if l >= 128 else 128 % l == 0
    cw = _pick_cw(l, n_tok)
    return ok and cw % max(l, 128) == 0 and n_tok % cw == 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dim, statistics and affine in f32, result in
    x.dtype (the JAX package's ``_LayerNormParams``)."""
    x32 = wide(x)
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * wide(w) + wide(b)).to(x.dtype)


def _window_attention_plain(qkv: torch.Tensor, heads: int, l: int,
                            scale: float) -> torch.Tensor:
    b, n, f = qkv.shape
    d = f // (3 * heads)
    t = qkv.reshape(b * (n // l), l, 3, heads, d)
    o = attention_reference(t[:, :, 0], t[:, :, 1], t[:, :, 2], scale)
    return o.reshape(b, n, heads * d)


def block_plain(x: torch.Tensor, wts: BlockWeights, heads: int, l: int,
                scale: float, eps: float = 1e-6,
                approx_gelu: bool = True) -> torch.Tensor:
    """One non-pooling Hiera block on [B, N, C], attention over windows of l
    consecutive tokens."""
    return block_plain_res(x, wts, heads, l, scale, eps, approx_gelu)[0]


def block_plain_res(x: torch.Tensor, wts: BlockWeights, heads: int, l: int,
                    scale: float, eps: float = 1e-6, approx_gelu: bool = True):
    """:func:`block_plain` and the residuals of its forward (lse None):
    (y [B, N, C], :class:`BlockResiduals`)."""
    b, n, c = x.shape
    if n % l:
        raise ValueError(f"{n} tokens do not split into windows of {l}")
    h1 = layer_norm(x, wts.ln1_w, wts.ln1_b, eps)
    qkv = F.linear(h1, wts.wqkv, wts.bqkv)
    o = _window_attention_plain(qkv, heads, l, scale)
    u = x + F.linear(o, wts.wproj, wts.bproj)
    h2 = layer_norm(u, wts.ln2_w, wts.ln2_b, eps)
    z = F.linear(h2, wts.wfc1, wts.bfc1)
    g = F.gelu(z, approximate="tanh" if approx_gelu else "none")
    y = u + F.linear(g, wts.wfc2, wts.bfc2)
    return y, BlockResiduals(*(t.reshape(b * n, -1) for t in (qkv, o, u, z, g)))


def block_global_sp(x: torch.Tensor, wts: BlockWeights, heads: int, scale: float,
                    eps: float, approx_gelu: bool, shard) -> torch.Tensor:
    """A global-attention block on this rank's token shard [B, n, C] of a
    spatial group (``shard``: parallel/mesh.TokenShard), under sequence
    parallelism: LN1 and qkv on the local rows, K and V gathered over the
    group (parallel/sharding.gather_tokens, whose backward sums each key's
    gradient over the ranks' queries), the local queries' attention over
    every key (``scaled_dot_product_attention``), then proj + LN2 + MLP on
    the local rows.  The counterpart of the XLA reference that the JAX
    package runs there with the K / V collectives GSPMD inserts
    (``block_t_reference`` :1070, spegnet_tpu/models/hiera.py:476-486), not
    of a Pallas kernel, so plain PyTorch on the CPU and the card alike.
    Attention over all tokens is independent of their order, so the shards
    stay in Morton order."""
    from spegnet_tpu_torch.parallel.sharding import gather_tokens

    b, n, c = x.shape
    h1 = layer_norm(x, wts.ln1_w, wts.ln1_b, eps)
    qkv = F.linear(h1, wts.wqkv, wts.bqkv)
    hd = qkv.shape[-1] // 3
    d = hd // heads
    q = qkv[..., :hd].reshape(b, n, heads, d).transpose(1, 2)
    kv = gather_tokens(qkv[..., hd:], shard)
    k, v = kv.reshape(b, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    u = x + F.linear(o.transpose(1, 2).reshape(b, n, hd), wts.wproj, wts.bproj)
    z = F.linear(layer_norm(u, wts.ln2_w, wts.ln2_b, eps), wts.wfc1, wts.bfc1)
    g = F.gelu(z, approximate="tanh" if approx_gelu else "none")
    return u + F.linear(g, wts.wfc2, wts.bfc2)


def _gelu_grad(z: torch.Tensor, approx_gelu: bool) -> torch.Tensor:
    """d gelu / dz (tanh form or erf form), in z's dtype."""
    if approx_gelu:
        k = math.sqrt(2.0 / math.pi)
        t = torch.tanh(k * (z + 0.044715 * z ** 3))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * k * (1.0 + 3 * 0.044715 * z * z)
    return (0.5 * (1.0 + torch.erf(z * 0.5 ** 0.5))
            + z * torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi))


def _layer_norm_bwd(x: torch.Tensor, w: torch.Tensor, dh: torch.Tensor, eps: float):
    """LayerNorm backward over the last dim, in the accumulation dtype of
    dh: (dx, dw, db) for h = xhat * w + b."""
    x = wide(x)
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * r
    dxhat = dh * wide(w)
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (dh * xhat).sum(0), dh.sum(0)


def weight_grad(dout: torch.Tensor, inp: torch.Tensor):
    """(dout^T inp, column sums of dout), accumulated wide, for dout [M, N]
    and inp [M, K]: a weight gradient and its bias gradient, the plain
    version of kernels.gemm_tn."""
    return wide(dout).t() @ wide(inp), wide(dout).sum(0)


def block_plain_bwd_res(x: torch.Tensor, wts: BlockWeights, dy: torch.Tensor,
                        res: BlockResiduals, heads: int, l: int, scale: float,
                        eps: float = 1e-6, approx_gelu: bool = True):
    """Gradients of :func:`block_plain` from its residuals, written out
    (not autograd), as ``_bwd_kernel_res`` (:1449) computes them: the
    LayerNorms rerun, fc2, GELU, fc1, LN2, proj, the attention (softmax
    backward from P rebuilt from q and k), qkv and LN1, products and sums
    accumulated in f32 (f64 for f64 inputs), the gradients flowing between
    the layers rounded to the compute dtype where the kernels round them.
    Returns (dx [B, N, C], BlockWeights of gradients in the accumulation
    dtype)."""
    b, n, c = x.shape
    dt = x.dtype
    f = res.qkv.shape[1]
    hd = f // 3
    d = hd // heads
    x2, dy2 = x.reshape(b * n, c), dy.reshape(b * n, c)
    h1 = layer_norm(x2, wts.ln1_w, wts.ln1_b, eps)
    h2 = layer_norm(res.u, wts.ln2_w, wts.ln2_b, eps)

    def mm(a, w):       # a [M, K] @ w [K, N], accumulated wide
        return wide(a) @ wide(w)

    dwfc2, dbfc2 = weight_grad(dy2, res.g)
    dg = mm(dy2, wts.wfc2).to(dt)
    dz = (wide(dg) * _gelu_grad(wide(res.z), approx_gelu)).to(dt)
    dwfc1, dbfc1 = weight_grad(dz, h2)
    dh2 = mm(dz, wts.wfc1)
    du, dln2_w, dln2_b = _layer_norm_bwd(res.u, wts.ln2_w, dh2, eps)
    du = (du + wide(dy2)).to(dt)
    dwproj, dbproj = weight_grad(du, res.a)
    da = mm(du, wts.wproj).to(dt)

    def windows(t):     # [B*N, H*d] -> [windows, H, l, d]
        return t.reshape(b * n // l, l, heads, d).transpose(1, 2)

    q, k, v = (windows(res.qkv[:, i * hd:(i + 1) * hd]) for i in range(3))
    s = (wide(q) @ wide(k).transpose(-1, -2)) * scale
    p = torch.softmax(s, -1)
    do = windows(da)
    dp = wide(do) @ wide(v).transpose(-1, -2)
    dv = p.to(dt).transpose(-1, -2).to(dp.dtype) @ wide(do)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt)
    dq = wide(ds) @ wide(k)
    dk = wide(ds).transpose(-1, -2) @ wide(q)
    dqkv = torch.cat([t.to(dt).transpose(1, 2).reshape(b * n, hd) for t in (dq, dk, dv)], 1)
    dwqkv, dbqkv = weight_grad(dqkv, h1)
    dh1 = mm(dqkv, wts.wqkv)
    dx, dln1_w, dln1_b = _layer_norm_bwd(x2, wts.ln1_w, dh1, eps)
    dx = (dx + wide(du)).to(dt)
    return dx.reshape(b, n, c), BlockWeights(dln1_w, dln1_b, dwqkv, dbqkv, dwproj, dbproj,
                                             dln2_w, dln2_b, dwfc1, dbfc1, dwfc2, dbfc2)


def qpool_front_plain(x: torch.Tensor, wts: QPoolWeights, heads: int, l: int,
                      scale: float, eps: float = 1e-6):
    """[B, N, Cin] (Morton) -> (attention out [B, N/4, H*d], pooled shortcut
    [B, N/4, Cout]), both Morton at the pooled grid.  q and the shortcut are
    max-pooled over each 4 consecutive tokens after their dtype cast."""
    h1 = layer_norm(x, wts.ln_w, wts.ln_b, eps)
    return _qpool_attend(F.linear(h1, wts.wqkv, wts.bqkv), F.linear(h1, wts.wsc, wts.bsc),
                         heads, l, scale)


def _qpool_attend(qkv: torch.Tensor, sc: torch.Tensor, heads: int, l: int, scale: float):
    """The pooling and attention of the transition front on its projections
    qkv [B, N, 3*H*d] and sc [B, N, Cout]."""
    b, n, _ = qkv.shape
    if n % l or l % 4:
        raise ValueError(f"{n} tokens vs pooled windows of {l}")
    sc_p = sc.reshape(b, n // 4, 4, -1).amax(2)
    d = qkv.shape[-1] // (3 * heads)
    t = qkv.reshape(b * (n // l), l, 3, heads, d)
    qp = t[:, :, 0].reshape(b * (n // l), l // 4, 4, heads, d).amax(2)
    o = attention_reference(qp, t[:, :, 1], t[:, :, 2], scale)
    return o.reshape(b, n // 4, heads * d), sc_p


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _head_dim(w: torch.Tensor, heads: int) -> int:
    f = w.shape[0]
    if f % (3 * heads):
        raise ValueError(f"qkv rows {f} do not split into 3 x {heads} heads")
    return f // (3 * heads)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def block_cuda(x: torch.Tensor, wts: BlockWeights, heads: int, l: int,
               scale: float, eps: float) -> torch.Tensor:
    """The kernel chain of csrc/hiera_block.cu on [B, N, C] (bf16, CUDA)."""
    b, n, c = x.shape
    if n % l:
        raise ValueError(f"{n} tokens do not split into windows of {l}")
    d = _head_dim(wts.wqkv, heads)
    x2 = x.reshape(b * n, c)
    h1 = kernels.layernorm(x2, _f32(wts.ln1_w), _f32(wts.ln1_b), eps)
    qkv = kernels.gemm(h1, wts.wqkv, wts.bqkv)
    a = kernels.window_attention(qkv, heads, d, l, scale)
    u = kernels.gemm(a, wts.wproj, wts.bproj, residual=x2)
    h2 = kernels.layernorm(u, _f32(wts.ln2_w), _f32(wts.ln2_b), eps)
    z = kernels.gemm(h2, wts.wfc1, wts.bfc1, gelu=True)
    return kernels.gemm(z, wts.wfc2, wts.bfc2, residual=u).reshape(b, n, c)


def _t(w: torch.Tensor) -> torch.Tensor:
    """[N, K] weight -> contiguous [K, N], for dX = dY W through kernels.gemm."""
    return w.t().contiguous()


def _forward_chain(x2: torch.Tensor, wts: BlockWeights, heads: int, l: int, scale: float,
                   eps: float):
    """Everything of the block's forward on [rows, C] but fc2: (h1,
    :class:`BlockResiduals`, h2).  The attention keeps its lse, and fc1's
    epilogue writes z and g from one f32 sum (g as :func:`block_cuda`'s)."""
    d = _head_dim(wts.wqkv, heads)
    h1 = kernels.layernorm(x2, _f32(wts.ln1_w), _f32(wts.ln1_b), eps)
    qkv = kernels.gemm(h1, wts.wqkv, wts.bqkv)
    a, lse = kernels.window_attention(qkv, heads, d, l, scale, with_lse=True)
    u = kernels.gemm(a, wts.wproj, wts.bproj, residual=x2)
    h2 = kernels.layernorm(u, _f32(wts.ln2_w), _f32(wts.ln2_b), eps)
    z, g = kernels.gemm_gelu_pre(h2, wts.wfc1, wts.bfc1)
    return h1, BlockResiduals(qkv, a, u, z, g, lse), h2


def _backward_chain(x2, wts: BlockWeights, dy2, res: BlockResiduals, h1, h2, heads: int,
                    l: int, scale: float, eps: float):
    """The chain of csrc/hiera_block_bwd.cu on [rows, C] from the forward's
    tensors: (dx [rows, C], BlockWeights of f32 gradients)."""
    d = _head_dim(wts.wqkv, heads)
    hd = heads * d
    dwfc2, dbfc2 = kernels.gemm_tn(dy2, res.g)
    dz = kernels.gemm_gelu_grad(dy2, _t(wts.wfc2), res.z)
    dwfc1, dbfc1 = kernels.gemm_tn(dz, h2)
    dh2 = kernels.gemm(dz, _t(wts.wfc1))
    du, dln2_w, dln2_b = kernels.layernorm_bwd(res.u, _f32(wts.ln2_w), dh2, eps, dres=dy2)
    dwproj, dbproj = kernels.gemm_tn(du, res.a)
    da = kernels.gemm(du, _t(wts.wproj))
    qkv = res.qkv
    dqkv = torch.empty_like(qkv)
    Cols = kernels.Cols
    kernels.attention_bwd(Cols(qkv, 0), Cols(qkv, hd), Cols(qkv, 2 * hd), Cols(res.a),
                          Cols(da), res.lse, Cols(dqkv, 0), Cols(dqkv, hd),
                          Cols(dqkv, 2 * hd), heads, d, l, l, scale)
    dwqkv, dbqkv = kernels.gemm_tn(dqkv, h1)
    dh1 = kernels.gemm(dqkv, _t(wts.wqkv))
    dx, dln1_w, dln1_b = kernels.layernorm_bwd(x2, _f32(wts.ln1_w), dh1, eps, dres=du)
    return dx, BlockWeights(dln1_w, dln1_b, dwqkv, dbqkv, dwproj, dbproj,
                            dln2_w, dln2_b, dwfc1, dbfc1, dwfc2, dbfc2)


def block_cuda_bwd(x: torch.Tensor, wts: BlockWeights, dy: torch.Tensor, heads: int,
                   l: int, scale: float, eps: float):
    """Gradients of :func:`block_cuda` (dx, BlockWeights of f32 gradients):
    recompute, then the chain of csrc/hiera_block_bwd.cu."""
    b, n, c = x.shape
    x2 = x.reshape(b * n, c)
    h1, res, h2 = _forward_chain(x2, wts, heads, l, scale, eps)
    dx, dws = _backward_chain(x2, wts, dy.reshape(b * n, c), res, h1, h2, heads, l, scale,
                              eps)
    return dx.reshape(b, n, c), dws


def block_cuda_res(x: torch.Tensor, wts: BlockWeights, heads: int, l: int,
                   scale: float, eps: float):
    """The forward chain that also keeps the backward's residuals (replaces
    ``_kernel_res`` :362): (y [B, N, C], :class:`BlockResiduals`), y bit-equal
    to :func:`block_cuda`'s (fc2 reads the same g)."""
    b, n, c = x.shape
    if n % l:
        raise ValueError(f"{n} tokens do not split into windows of {l}")
    x2 = x.reshape(b * n, c)
    _, res, _ = _forward_chain(x2, wts, heads, l, scale, eps)
    y = kernels.gemm(res.g, wts.wfc2, wts.bfc2, residual=res.u)
    return y.reshape(b, n, c), res


def block_cuda_bwd_res(x: torch.Tensor, wts: BlockWeights, dy: torch.Tensor,
                       res: BlockResiduals, heads: int, l: int, scale: float, eps: float):
    """Gradients of :func:`block_cuda_res` from its residuals (replaces
    ``_bwd_kernel_res`` :1449): only the two LayerNorms rerun; dx and the
    weight gradients are bit-equal to :func:`block_cuda_bwd`'s."""
    b, n, c = x.shape
    x2 = x.reshape(b * n, c)
    h1 = kernels.layernorm(x2, _f32(wts.ln1_w), _f32(wts.ln1_b), eps)
    h2 = kernels.layernorm(res.u, _f32(wts.ln2_w), _f32(wts.ln2_b), eps)
    dx, dws = _backward_chain(x2, wts, dy.reshape(b * n, c), res, h1, h2, heads, l, scale,
                              eps)
    return dx.reshape(b, n, c), dws


def qpool_front_cuda(x: torch.Tensor, wts: QPoolWeights, heads: int, l: int,
                     scale: float, eps: float):
    """The kernel chain of csrc/qpool_front.cu on [B, N, Cin] (bf16, CUDA)."""
    b, n, cin = x.shape
    if n % l:
        raise ValueError(f"{n} tokens vs pooled windows of {l}")
    d = _head_dim(wts.wqkv, heads)
    cout = wts.wsc.shape[0]
    x2 = x.reshape(b * n, cin)
    h1 = kernels.layernorm(x2, _f32(wts.ln_w), _f32(wts.ln_b), eps)
    y = kernels.gemm(h1, torch.cat([wts.wqkv, wts.wsc]), torch.cat([wts.bqkv, wts.bsc]))
    o = kernels.qpool_attention(y, heads, d, l, scale)
    sc = kernels.pool4_rows(y, 3 * heads * d, cout)
    return o.reshape(b, n // 4, heads * d), sc.reshape(b, n // 4, cout)


def qpool_front_cuda_bwd(x: torch.Tensor, wts: QPoolWeights, go: torch.Tensor,
                         gsc: torch.Tensor, heads: int, l: int, scale: float, eps: float):
    """Gradients of :func:`qpool_front_cuda` (dx, QPoolWeights of f32
    gradients): recompute, then the chain of csrc/qpool_front_bwd.cu."""
    b, n, cin = x.shape
    d = _head_dim(wts.wqkv, heads)
    hd, f = heads * d, 3 * heads * d
    x2 = x.reshape(b * n, cin)
    ln_w = _f32(wts.ln_w)
    h1 = kernels.layernorm(x2, ln_w, _f32(wts.ln_b), eps)
    wcat = torch.cat([wts.wqkv, wts.wsc])
    y = kernels.gemm(h1, wcat, torch.cat([wts.bqkv, wts.bsc]))
    o, lse = kernels.qpool_attention(y, heads, d, l, scale, with_lse=True)
    qp = kernels.pool4_rows(y, 0, hd)

    Cols = kernels.Cols
    dy = torch.empty_like(y)
    dqp = torch.empty_like(qp)
    go2 = go.reshape(b * n // 4, hd)
    kernels.attention_bwd(Cols(qp), Cols(y, hd), Cols(y, 2 * hd), Cols(o), Cols(go2), lse,
                          Cols(dqp), Cols(dy, hd), Cols(dy, 2 * hd), heads, d, l // 4, l,
                          scale)
    kernels.pool4_scatter(Cols(y, 0), dqp, Cols(dy, 0))
    kernels.pool4_scatter(Cols(y, f), gsc.reshape(b * n // 4, -1), Cols(dy, f))
    dw, db = kernels.gemm_tn(dy, h1)
    dh1 = kernels.gemm(dy, _t(wcat))
    dx, dln_w, dln_b = kernels.layernorm_bwd(x2, ln_w, dh1, eps)
    return dx.reshape(b, n, cin), QPoolWeights(dln_w, dln_b, dw[:f], db[:f], dw[f:], db[f:])


def _as_dtypes(grads, like):
    return [g.to(w.dtype) for g, w in zip(grads, like)]


class BlockFunction(torch.autograd.Function):
    """One non-pooling block on [B, N, C] through the Hopper kernels, with
    the kernel backward.  ``counter`` names the wrapper whose backward
    launches are counted (``<counter>_bwd``)."""

    @staticmethod
    def forward(ctx, x, heads, l, scale, eps, counter, *w):
        ctx.save_for_backward(x, *w)
        ctx.cfg = (heads, l, scale, eps, counter)
        return block_cuda(x, BlockWeights(*w), heads, l, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, *w = ctx.saved_tensors
        heads, l, scale, eps, counter = ctx.cfg
        kernels.launches[counter + "_bwd"] += 1
        dx, dws = block_cuda_bwd(x, BlockWeights(*w), dy.contiguous(), heads, l, scale, eps)
        return (dx, None, None, None, None, None, *_as_dtypes(dws, w))


class BlockResFunction(torch.autograd.Function):
    """The T-block through the saved-residual pair: the forward keeps
    :class:`BlockResiduals` for the backward instead of recomputing them."""

    @staticmethod
    def forward(ctx, x, heads, l, scale, eps, *w):
        y, res = block_cuda_res(x, BlockWeights(*w), heads, l, scale, eps)
        ctx.save_for_backward(x, *res, *w)
        ctx.cfg = (heads, l, scale, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *rest = ctx.saved_tensors
        nres = len(BlockResiduals._fields)
        res, w = BlockResiduals(*rest[:nres]), rest[nres:]
        heads, l, scale, eps = ctx.cfg
        kernels.launches["fused_block_t_bwd_res"] += 1
        dx, dws = block_cuda_bwd_res(x, BlockWeights(*w), dy.contiguous(), res, heads, l,
                                     scale, eps)
        return (dx, None, None, None, None, *_as_dtypes(dws, w))


class QPoolFunction(torch.autograd.Function):
    """The Q-pool transition front through the Hopper kernels, with the
    kernel backward."""

    @staticmethod
    def forward(ctx, x, heads, l, scale, eps, *w):
        ctx.save_for_backward(x, *w)
        ctx.cfg = (heads, l, scale, eps)
        return qpool_front_cuda(x, QPoolWeights(*w), heads, l, scale, eps)

    @staticmethod
    def backward(ctx, go, gsc):
        x, *w = ctx.saved_tensors
        heads, l, scale, eps = ctx.cfg
        kernels.launches["qpool_front_bwd"] += 1
        wts = QPoolWeights(*w)
        b, n, _ = x.shape
        if go is None:
            go = x.new_zeros((b, n // 4, heads * _head_dim(wts.wqkv, heads)))
        if gsc is None:
            gsc = x.new_zeros((b, n // 4, wts.wsc.shape[0]))
        dx, dws = qpool_front_cuda_bwd(x, wts, go.contiguous(), gsc.contiguous(), heads, l,
                                       scale, eps)
        return (dx, None, None, None, None, *_as_dtypes(dws, w))


def _cuda_gate(x: torch.Tensor, approx_gelu: bool = True) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the Hopper kernels take bf16, got {x.dtype}")
    if not approx_gelu:
        raise ValueError("the Hopper block kernel implements the tanh GELU")


def fused_block_t(x: torch.Tensor, wts: BlockWeights, heads: int, l: int,
                  scale: float, eps: float = 1e-6,
                  approx_gelu: bool = True) -> torch.Tensor:
    """One non-pooling block on [B, N, C] (stages 1-3, global blocks
    included).  CPU: :func:`block_plain`.  CUDA: csrc/hiera_block.cu, which
    replaces spegnet_tpu/ops/fused_block_t.py ``_kernel`` (:349), and in the
    backward csrc/hiera_block_bwd.cu, which replaces ``_bwd_kernel`` (:1165);
    or, where :func:`route` says so, the saved-residual pair."""
    if x.device.type == "cpu":
        return block_plain(x, wts, heads, l, scale, eps, approx_gelu)
    _cuda_gate(x, approx_gelu)
    counter = route(x, wts)
    kernels.launches[counter] += 1
    if counter == "fused_block_t_res":
        return BlockResFunction.apply(x.contiguous(), heads, l, scale, eps, *wts)
    return BlockFunction.apply(x.contiguous(), heads, l, scale, eps, "fused_block_t", *wts)


def route(x: torch.Tensor, wts: BlockWeights) -> str:
    """The launch counter of :func:`fused_block_t` on the card:
    "fused_block_t_res" (the saved-residual pair) where autograd will run the
    backward and :func:`save_residuals` holds, as the JAX package takes the
    pair only in its custom_vjp forward (``_fwd`` :1710); else
    "fused_block_t"."""
    trained = torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in wts))
    return "fused_block_t_res" if trained and save_residuals(*x.shape[:2]) else "fused_block_t"


def qpool_front(x: torch.Tensor, wts: QPoolWeights, heads: int, l: int,
                scale: float, eps: float = 1e-6):
    """Q-pool transition front on [B, N, Cin].  CPU:
    :func:`qpool_front_plain`.  CUDA: csrc/qpool_front.cu, which replaces
    spegnet_tpu/ops/fused_block_t.py ``_qpool_kernel`` (:634), and in the
    backward csrc/qpool_front_bwd.cu, which replaces ``_qpool_bwd_kernel``
    (:833)."""
    if x.device.type == "cpu":
        return qpool_front_plain(x, wts, heads, l, scale, eps)
    _cuda_gate(x)
    kernels.launches["qpool_front"] += 1
    return QPoolFunction.apply(x.contiguous(), heads, l, scale, eps, *wts)
