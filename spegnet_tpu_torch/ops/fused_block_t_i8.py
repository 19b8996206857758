"""W8A8 whole Hiera block and Q-pool transition front (port of
spegnet_tpu/ops/fused_block_t_i8.py), inference only.

The flagged int8 encoder mode (``model.int8_encoder``): the four block
projections (qkv / proj / fc1 / fc2) and the transition front's qkv and
shortcut projections contract in int8 with int32 sums:

* weights: symmetric int8 per output feature, quantized once from their
  compute-dtype (bf16) values (:func:`pack_i8`, :func:`pack_qpool_i8`);
  biases are the compute-dtype biases promoted to f32;
* activations: symmetric int8 per token, computed in the forward from the
  LayerNorm output, the attention output and the GELU output
  (:func:`quant_tokens`, the reciprocal of the scale taken first);
* dequantization: a rank-1 f32 rescale of the int32 sum, ``acc * s_w *
  s_x + bias`` (:func:`qdot`), in the TPU kernel's order.

Attention, LayerNorm, GELU and the residual stream stay as in the bf16
block.  Weights are in nn.Linear layout ([out, in]) and unpadded: the JAX
package's zero head pads quantize to zero codes and leave every absmax
unchanged, so the codes and the result are the same.

Each operator comes in two forms: a plain PyTorch version
(:func:`block_t_i8_plain`, :func:`qpool_front_i8_plain`, the math of
``block_t_i8_reference`` :479 and ``qpool_i8_reference`` :424) and a wrapper
(:func:`fused_block_t_i8`, :func:`qpool_front_i8`) that runs the plain
version for a CPU tensor and, for a bf16 CUDA tensor, the chain of
csrc/int8_gemm.cu and the bf16 attention kernels, or raises.  There is no
autograd Function: training never takes this path.

The gates (:func:`supported_i8`, :func:`qpool_supported_i8`) are the JAX
package's shape rules, so the port sends the same blocks to int8.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops.fused_block_t import (
    BlockWeights,
    QPoolWeights,
    _cuda_gate,
    _head_dim,
    _qpool_attend,
    _window_attention_plain,
    layer_norm,
)

# spegnet_tpu/ops/fused_block_t.py:65: the longest exact window of the T-kernel.
_MAX_L = 1024


class BlockWeightsI8(NamedTuple):
    """A block's W8A8 parameters: int8 codes [out, in], f32 scales and
    biases [out]; LayerNorm parameters f32."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wqkv: torch.Tensor
    sqkv: torch.Tensor
    bqkv: torch.Tensor
    wproj: torch.Tensor
    sproj: torch.Tensor
    bproj: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    wfc1: torch.Tensor
    sfc1: torch.Tensor
    bfc1: torch.Tensor
    wfc2: torch.Tensor
    sfc2: torch.Tensor
    bfc2: torch.Tensor


class QPoolWeightsI8(NamedTuple):
    """A transition front's W8A8 parameters (as :class:`BlockWeightsI8`)."""

    ln_w: torch.Tensor
    ln_b: torch.Tensor
    wqkv: torch.Tensor
    sqkv: torch.Tensor
    bqkv: torch.Tensor
    wsc: torch.Tensor
    ssc: torch.Tensor
    bsc: torch.Tensor


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax * (1.0 / 127.0), min=1e-12)


def quantize_rows(w: torch.Tensor):
    """[M, K] -> (int8 [M, K], f32 scales [M]): symmetric per-row absmax of
    the f32 values, codes round(w / s) (ties to even; |w| <= absmax keeps
    them in [-127, 127])."""
    w32 = w.float()
    s = _scale(w32.abs().amax(1))
    return torch.round(w32 / s[:, None]).to(torch.int8), s


def quant_tokens(x: torch.Tensor):
    """[..., K] -> (int8 [..., K], f32 scales [..., 1]): symmetric per-token
    absmax over the last dim, codes round(x * (1 / s))."""
    x32 = x.float()
    s = _scale(x32.abs().amax(-1, keepdim=True))
    return torch.round(x32 * torch.reciprocal(s)).to(torch.int8), s


def qdot(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
         bias: torch.Tensor, sw_first: bool = True) -> torch.Tensor:
    """int8 [..., K] . int8 [M, K]^T -> f32 [..., M]: the exact integer sum
    (taken in f64, which holds it exactly: |sum| <= 127^2 K), rounded to
    f32, times the scales in the TPU kernel's order, plus the bias."""
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64).t()).float()
    return (acc * sw * sx if sw_first else acc * sx * sw) + bias


def _pack(w: torch.Tensor, b: torch.Tensor):
    q, s = quantize_rows(w)
    return q, s, b.float().contiguous()


def pack_i8(w: BlockWeights) -> BlockWeightsI8:
    """Quantize a block's compute-dtype weights (``pack_i8`` :104)."""
    f32 = [t.float().contiguous() for t in (w.ln1_w, w.ln1_b, w.ln2_w, w.ln2_b)]
    return BlockWeightsI8(f32[0], f32[1], *_pack(w.wqkv, w.bqkv), *_pack(w.wproj, w.bproj),
                          f32[2], f32[3], *_pack(w.wfc1, w.bfc1), *_pack(w.wfc2, w.bfc2))


def pack_qpool_i8(w: QPoolWeights) -> QPoolWeightsI8:
    """Quantize a transition front's weights (``pack_qpool_i8`` :282)."""
    return QPoolWeightsI8(w.ln_w.float().contiguous(), w.ln_b.float().contiguous(),
                          *_pack(w.wqkv, w.bqkv), *_pack(w.wsc, w.bsc))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def _pick_cw(l: int, n_tok: int) -> int:
    """The TPU kernels' attention chunk width (``_pick_cw`` :189 under its
    default policy, and ``_pick_cw_qpool`` :1030, which agree)."""
    return l if l >= 512 else min(512, n_tok)


def supported(c: int, heads: int, l: int, n_tok: int) -> bool:
    """Shape rules of the bf16 T-kernel gate (``supported`` :203): blocks
    with more than 8 heads, or windows that do not tile its chunks, run the
    gen-1 kernel (ops/fused_block.py) in the JAX package."""
    if c % 16 or heads > 8:
        return False
    ok = (l % 128 == 0 and l <= _MAX_L) if l >= 128 else 128 % l == 0
    cw = _pick_cw(l, n_tok)
    return ok and cw % max(l, 128) == 0 and n_tok % cw == 0


def qpool_supported(cin: int, heads: int, l: int, n_tok: int) -> bool:
    """Shape rules of the bf16 transition-front gate (``qpool_supported``
    :1039)."""
    if cin % 16 or l % 4 or l > 256:
        return False
    ok = l % 128 == 0 if l >= 128 else 128 % l == 0
    cw = _pick_cw(l, n_tok)
    return ok and cw % max(l, 128) == 0 and n_tok % cw == 0


def supported_i8(c: int, heads: int, l: int, n_tok: int) -> bool:
    """int8 block gate (``supported_i8`` :255): :func:`supported` and
    C % 32 == 0 (Hiera-L stages 2-3 and the globals; not stage 1, C 144)."""
    return supported(c, heads, l, n_tok) and c % 32 == 0


def qpool_supported_i8(cin: int, heads: int, l: int, n_tok: int) -> bool:
    """int8 transition gate (``qpool_supported_i8`` :415): t23 and t34 of
    Hiera-L; t12 (Cin 144) stays bf16."""
    return qpool_supported(cin, heads, l, n_tok) and cin % 32 == 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def block_t_i8_plain(x: torch.Tensor, w: BlockWeightsI8, heads: int, l: int, scale: float,
                     eps: float = 1e-6, approx_gelu: bool = True,
                     sw_first: bool = True) -> torch.Tensor:
    """One W8A8 block on [B, N, C], attention over windows of l consecutive
    tokens; every projection output is rounded to x.dtype as in the TPU
    kernel (fc1 after its f32 GELU)."""
    if x.shape[1] % l:
        raise ValueError(f"{x.shape[1]} tokens do not split into windows of {l}")
    dt = x.dtype
    q, s = quant_tokens(layer_norm(x, w.ln1_w, w.ln1_b, eps))
    qkv = qdot(q, s, w.wqkv, w.sqkv, w.bqkv, sw_first).to(dt)
    q, s = quant_tokens(_window_attention_plain(qkv, heads, l, scale))
    u = x + qdot(q, s, w.wproj, w.sproj, w.bproj, sw_first).to(dt)
    q, s = quant_tokens(layer_norm(u, w.ln2_w, w.ln2_b, eps))
    z = F.gelu(qdot(q, s, w.wfc1, w.sfc1, w.bfc1, sw_first),
               approximate="tanh" if approx_gelu else "none").to(dt)
    q, s = quant_tokens(z)
    return u + qdot(q, s, w.wfc2, w.sfc2, w.bfc2, sw_first).to(dt)


def qpool_front_i8_plain(x: torch.Tensor, w: QPoolWeightsI8, heads: int, l: int,
                         scale: float, eps: float = 1e-6):
    """W8A8 transition front on [B, N, Cin] (Morton) -> (attention out
    [B, N/4, H*d], pooled shortcut [B, N/4, Cout]): one per-token quant of
    the LayerNorm output feeds both projections."""
    dt = x.dtype
    q, s = quant_tokens(layer_norm(x, w.ln_w, w.ln_b, eps))
    qkv = qdot(q, s, w.wqkv, w.sqkv, w.bqkv).to(dt)
    sc = qdot(q, s, w.wsc, w.ssc, w.bsc).to(dt)
    return _qpool_attend(qkv, sc, heads, l, scale)


# ---------------------------------------------------------------------------
# kernel chains and wrappers
# ---------------------------------------------------------------------------

def block_cuda_i8(x: torch.Tensor, w: BlockWeightsI8, heads: int, l: int, scale: float,
                  eps: float, sw_first: bool = True) -> torch.Tensor:
    """The W8A8 block on [B, N, C] (bf16, CUDA): LN + quant, the int8 GEMMs
    of csrc/int8_gemm.cu with their dequant / GELU / residual epilogues, the
    bf16 window attention of csrc/attention.cuh and two row quants."""
    b, n, c = x.shape
    if n % l:
        raise ValueError(f"{n} tokens do not split into windows of {l}")
    d = _head_dim(w.wqkv, heads)
    x2 = x.reshape(b * n, c)
    q, s = kernels.layernorm_q8(x2, w.ln1_w, w.ln1_b, eps)
    qkv = kernels.gemm_i8(q, s, w.wqkv, w.sqkv, w.bqkv, sw_first=sw_first)
    q, s = kernels.quant_rows(kernels.window_attention(qkv, heads, d, l, scale))
    u = kernels.gemm_i8(q, s, w.wproj, w.sproj, w.bproj, residual=x2, sw_first=sw_first)
    q, s = kernels.layernorm_q8(u, w.ln2_w, w.ln2_b, eps)
    z = kernels.gemm_i8(q, s, w.wfc1, w.sfc1, w.bfc1, gelu=True, sw_first=sw_first)
    q, s = kernels.quant_rows(z)
    y = kernels.gemm_i8(q, s, w.wfc2, w.sfc2, w.bfc2, residual=u, sw_first=sw_first)
    return y.reshape(b, n, c)


def qpool_front_cuda_i8(x: torch.Tensor, w: QPoolWeightsI8, heads: int, l: int,
                        scale: float, eps: float):
    """The W8A8 transition front on [B, N, Cin] (bf16, CUDA): LN + quant once,
    one int8 GEMM over the stacked qkv and shortcut codes, then the pooled-q
    attention and the 4-row max-pool of csrc/qpool_front.cu."""
    b, n, cin = x.shape
    if n % l:
        raise ValueError(f"{n} tokens vs pooled windows of {l}")
    d = _head_dim(w.wqkv, heads)
    cout = w.wsc.shape[0]
    q, s = kernels.layernorm_q8(x.reshape(b * n, cin), w.ln_w, w.ln_b, eps)
    y = kernels.gemm_i8(q, s, torch.cat([w.wqkv, w.wsc]), torch.cat([w.sqkv, w.ssc]),
                        torch.cat([w.bqkv, w.bsc]))
    o = kernels.qpool_attention(y, heads, d, l, scale)
    sc = kernels.pool4_rows(y, 3 * heads * d, cout)
    return o.reshape(b, n // 4, heads * d), sc.reshape(b, n // 4, cout)


def fused_block_t_i8(x: torch.Tensor, w: BlockWeightsI8, heads: int, l: int, scale: float,
                     eps: float = 1e-6, approx_gelu: bool = True) -> torch.Tensor:
    """One W8A8 block on [B, N, C] (stages 2-3 and the globals of Hiera-L).
    CPU: :func:`block_t_i8_plain`.  CUDA: :func:`block_cuda_i8`, which
    replaces spegnet_tpu/ops/fused_block_t_i8.py ``_kernel_i8`` (:137)."""
    if x.device.type == "cpu":
        return block_t_i8_plain(x, w, heads, l, scale, eps, approx_gelu)
    _cuda_gate(x, approx_gelu)
    kernels.launches["fused_block_t_i8"] += 1
    return block_cuda_i8(x.contiguous(), w, heads, l, scale, eps)


def qpool_front_i8(x: torch.Tensor, w: QPoolWeightsI8, heads: int, l: int, scale: float,
                   eps: float = 1e-6):
    """W8A8 transition front on [B, N, Cin] (t23 and t34 of Hiera-L).  CPU:
    :func:`qpool_front_i8_plain`.  CUDA: :func:`qpool_front_cuda_i8`, which
    replaces spegnet_tpu/ops/fused_block_t_i8.py ``_qpool_kernel_i8`` (:294)."""
    if x.device.type == "cpu":
        return qpool_front_i8_plain(x, w, heads, l, scale, eps)
    _cuda_gate(x)
    kernels.launches["qpool_front_i8"] += 1
    return qpool_front_cuda_i8(x.contiguous(), w, heads, l, scale, eps)
