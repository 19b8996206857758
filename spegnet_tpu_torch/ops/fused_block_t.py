"""Whole Hiera block and Q-pool transition front (port of spegnet_tpu/ops/fused_block_t.py).

The trunk's kernel path runs token-major ``[B, N, C]`` in Morton (Z) order:
:func:`to_z` is the JAX package's ``to_z`` (:570) transposed.  In that order
every attention window of every stage is L consecutive rows and every 2x2
pool group is 4 consecutive rows, so one layout serves the whole trunk.

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
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


class QPoolWeights(NamedTuple):
    """Front half of a Q-pooling transition block (Cin -> Cout)."""

    ln_w: torch.Tensor
    ln_b: torch.Tensor
    wqkv: torch.Tensor     # [3*H*d, Cin]
    bqkv: torch.Tensor
    wsc: torch.Tensor      # [Cout, Cin] shortcut projection
    bsc: torch.Tensor


# ---------------------------------------------------------------------------
# Morton layout
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _morton_index(h: int, w: int) -> np.ndarray:
    """raster index of each Morton position (y bit above x bit per level)."""
    k = h.bit_length() - 1
    if h != w or (1 << k) != h:
        raise ValueError(f"Morton order needs H == W == 2^k, got {(h, w)}")
    perm = []
    for i in range(k):
        perm += [i, k + i]
    return np.arange(h * w).reshape((2,) * (2 * k)).transpose(perm).reshape(-1)


@functools.lru_cache(maxsize=None)
def _index(h: int, w: int, device: torch.device, inverse: bool) -> torch.Tensor:
    idx = _morton_index(h, w)
    if inverse:
        idx = np.argsort(idx)
    # a normal tensor even when first made under inference_mode (predict),
    # so that a later training forward may save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device)


def to_z(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, C] in Morton order (H == W == 2^k)."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c).index_select(1, _index(h, w, x.device, False))


def from_z(xz: torch.Tensor, hw) -> torch.Tensor:
    """Inverse of :func:`to_z`: [B, N, C] -> [B, H, W, C]."""
    b, n, c = xz.shape
    h, w = hw
    if h * w != n:
        raise ValueError(f"from_z: {n} tokens vs {(h, w)}")
    return xz.index_select(1, _index(h, w, xz.device, True)).reshape(b, h, w, c)


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
    if x.shape[1] % l:
        raise ValueError(f"{x.shape[1]} tokens do not split into windows of {l}")
    h1 = layer_norm(x, wts.ln1_w, wts.ln1_b, eps)
    qkv = F.linear(h1, wts.wqkv, wts.bqkv)
    o = _window_attention_plain(qkv, heads, l, scale)
    u = x + F.linear(o, wts.wproj, wts.bproj)
    h2 = layer_norm(u, wts.ln2_w, wts.ln2_b, eps)
    z = F.gelu(F.linear(h2, wts.wfc1, wts.bfc1),
               approximate="tanh" if approx_gelu else "none")
    return u + F.linear(z, wts.wfc2, wts.bfc2)


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


def block_cuda_bwd(x: torch.Tensor, wts: BlockWeights, dy: torch.Tensor, heads: int,
                   l: int, scale: float, eps: float):
    """Gradients of :func:`block_cuda` (dx, BlockWeights of f32 gradients):
    recompute, then the chain of csrc/hiera_block_bwd.cu."""
    b, n, c = x.shape
    d = _head_dim(wts.wqkv, heads)
    hd = heads * d
    x2, dy2 = x.reshape(b * n, c), dy.reshape(b * n, c)
    ln1_w, ln2_w = _f32(wts.ln1_w), _f32(wts.ln2_w)
    h1 = kernels.layernorm(x2, ln1_w, _f32(wts.ln1_b), eps)
    qkv = kernels.gemm(h1, wts.wqkv, wts.bqkv)
    a, lse = kernels.window_attention(qkv, heads, d, l, scale, with_lse=True)
    u = kernels.gemm(a, wts.wproj, wts.bproj, residual=x2)
    h2 = kernels.layernorm(u, ln2_w, _f32(wts.ln2_b), eps)
    z, g = kernels.gemm_gelu_pre(h2, wts.wfc1, wts.bfc1)

    dwfc2, dbfc2 = kernels.gemm_tn(dy2, g)
    dz = kernels.gemm_gelu_grad(dy2, _t(wts.wfc2), z)
    dwfc1, dbfc1 = kernels.gemm_tn(dz, h2)
    dh2 = kernels.gemm(dz, _t(wts.wfc1))
    du, dln2_w, dln2_b = kernels.layernorm_bwd(u, ln2_w, dh2, eps, dres=dy2)
    dwproj, dbproj = kernels.gemm_tn(du, a)
    da = kernels.gemm(du, _t(wts.wproj))
    dqkv = torch.empty_like(qkv)
    Cols = kernels.Cols
    kernels.attention_bwd(Cols(qkv, 0), Cols(qkv, hd), Cols(qkv, 2 * hd), Cols(a), Cols(da),
                          lse, Cols(dqkv, 0), Cols(dqkv, hd), Cols(dqkv, 2 * hd),
                          heads, d, l, l, scale)
    dwqkv, dbqkv = kernels.gemm_tn(dqkv, h1)
    dh1 = kernels.gemm(dqkv, _t(wts.wqkv))
    dx, dln1_w, dln1_b = kernels.layernorm_bwd(x2, ln1_w, dh1, eps, dres=du)
    return dx.reshape(b, n, c), BlockWeights(dln1_w, dln1_b, dwqkv, dbqkv, dwproj, dbproj,
                                             dln2_w, dln2_b, dwfc1, dbfc1, dwfc2, dbfc2)


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
    backward csrc/hiera_block_bwd.cu, which replaces ``_bwd_kernel`` (:1165)."""
    if x.device.type == "cpu":
        return block_plain(x, wts, heads, l, scale, eps, approx_gelu)
    _cuda_gate(x, approx_gelu)
    kernels.launches["fused_block_t"] += 1
    return BlockFunction.apply(x.contiguous(), heads, l, scale, eps, "fused_block_t", *wts)


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
