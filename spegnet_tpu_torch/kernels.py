"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface on first use (a few seconds), cached under
``build/kernels/`` at the repository root by a hash of the sources, and
loaded with ctypes.  Nothing here runs at import time, so the package
imports on machines without CUDA.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and raises if
the C entry returns a CUDA error.  ``launches`` counts the calls of each
model-level wrapper (ops/*) that went through a kernel; ``reset_launches``
clears it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
SOURCES = ("hiera_block.cu", "qpool_front.cu", "decoder_block.cu")

launches = {
    "fused_block_t": 0,
    "fused_block": 0,
    "qpool_front": 0,
    "fused_decoder_block": 0,
}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/kernels/libspegnet_kernels_<hash>.so
    (skipped when that file exists) and return its path.  ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's register/shared-memory report."""
    so = BUILD_DIR / f"libspegnet_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [str(CSRC / s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, so)
    return so


def load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
    sigs = {
        "sp_layernorm": [p, p, p, p, l, i, f, p],
        "sp_gemm": [p, p, p, p, p, i, i, i, i, p],
        "sp_window_attention": [p, p, i, i, i, i, i, f, p],
        "sp_qpool_attention": [p, p, i, i, i, i, i, f, p],
        "sp_pool4_rows": [p, p, l, i, i, i, p],
        "sp_upconv3x3_bn_relu": [p, p, p, p, p, i, i, i, p],
        "sp_conv3x3_bn_relu_head": [p, p, p, p, p, p, p, i, i, i, p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.sp_error_string.argtypes = [ctypes.c_int]
    lib.sp_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = load().sp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(t: torch.Tensor, name: str, dtype=torch.bfloat16, ndim=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# launchers (csrc/hiera_block.cu)
# ---------------------------------------------------------------------------

def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    """[rows, C] bf16 -> LayerNorm over C with f32 weight/bias, bf16 out."""
    _need(x, "layernorm x", ndim=2)
    _need(w, "layernorm weight", torch.float32, 1)
    _need(b, "layernorm bias", torch.float32, 1)
    rows, c = x.shape
    if w.numel() != c or b.numel() != c:
        raise ValueError(f"layernorm: weight {tuple(w.shape)} vs C={c}")
    y = torch.empty_like(x)
    _check(load().sp_layernorm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                y.data_ptr(), rows, c, eps, _stream(x)),
           "sp_layernorm")
    return y


def gemm(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
         gelu: bool = False) -> torch.Tensor:
    """a [M, K] @ w[N, K]^T (+ bias) (-> tanh GELU) (+ residual), bf16
    (TMA + wgmma, csrc/hiera_block.cu)."""
    _need(a, "gemm a", ndim=2)
    _need(w, "gemm weight", ndim=2)
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"gemm: a {tuple(a.shape)} vs weight {tuple(w.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gemm: TMA needs 16-byte aligned operands")
    if bias is not None:
        _need(bias, "gemm bias", ndim=1)
        if bias.numel() != n:
            raise ValueError("gemm: bias length != N")
    if residual is not None:
        _need(residual, "gemm residual", ndim=2)
        if tuple(residual.shape) != (m, n):
            raise ValueError("gemm: residual shape != [M, N]")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _check(load().sp_gemm(a.data_ptr(), w.data_ptr(), _ptr(bias),
                           _ptr(residual), c.data_ptr(), m, n, k,
                           1 if gelu else 0, _stream(a)), "sp_gemm")
    return c


def _attn_checks(qkv, heads, d, l, name):
    _need(qkv, f"{name} qkv", ndim=2)
    rows, ld = qkv.shape
    if d % 8 or d > 128:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 8, <= 128")
    if ld % 8 or ld < 3 * heads * d:
        raise ValueError(f"{name}: row length {ld} vs 3*{heads}*{d}")
    if l % 16 or rows % l:
        raise ValueError(f"{name}: window {l} must be a multiple of 16 dividing "
                         f"{rows} rows")
    return rows, ld


def window_attention(qkv: torch.Tensor, heads: int, d: int, l: int,
                     scale: float) -> torch.Tensor:
    """qkv [rows, >=3*H*d] -> softmax(q k^T * scale) v per window of l
    consecutive rows, [rows, H*d]."""
    rows, ld = _attn_checks(qkv, heads, d, l, "window_attention")
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    _check(load().sp_window_attention(qkv.data_ptr(), out.data_ptr(), rows,
                                       ld, heads, d, l, scale, _stream(qkv)),
           "sp_window_attention")
    return out


# ---------------------------------------------------------------------------
# launchers (csrc/qpool_front.cu)
# ---------------------------------------------------------------------------

def qpool_attention(y: torch.Tensor, heads: int, d: int, l: int,
                    scale: float) -> torch.Tensor:
    """y [rows, >=3*H*d]: q max-pooled over 4 consecutive rows, attending to
    the l rows of its window -> [rows/4, H*d]."""
    rows, ld = _attn_checks(y, heads, d, l, "qpool_attention")
    if rows % 64:
        raise ValueError(f"qpool_attention: {rows} rows must pool to a "
                         "multiple of 16")
    out = torch.empty((rows // 4, heads * d), dtype=y.dtype, device=y.device)
    _check(load().sp_qpool_attention(y.data_ptr(), out.data_ptr(), rows, ld,
                                      heads, d, l, scale, _stream(y)),
           "sp_qpool_attention")
    return out


def pool4_rows(y: torch.Tensor, col0: int, ncols: int) -> torch.Tensor:
    """max over each 4 consecutive rows of y[:, col0:col0+ncols]."""
    _need(y, "pool4_rows y", ndim=2)
    rows, ld = y.shape
    if rows % 4 or col0 % 8 or ncols % 8 or col0 + ncols > ld or ld % 8:
        raise ValueError(f"pool4_rows: rows {rows}, cols [{col0}, "
                         f"{col0 + ncols}) of {ld}")
    out = torch.empty((rows // 4, ncols), dtype=y.dtype, device=y.device)
    _check(load().sp_pool4_rows(y.data_ptr(), out.data_ptr(), rows // 4, ld,
                                 col0, ncols, _stream(y)), "sp_pool4_rows")
    return out


# ---------------------------------------------------------------------------
# launchers (csrc/decoder_block.cu)
# ---------------------------------------------------------------------------

def _conv_params(w, s, t, cin, name):
    _need(w, f"{name} weight", ndim=2)
    _need(s, f"{name} scale", torch.float32, 1)
    _need(t, f"{name} shift", torch.float32, 1)
    if tuple(w.shape) != (9 * cin, 64) or s.numel() != 64 or t.numel() != 64:
        raise ValueError(f"{name}: weight {tuple(w.shape)} vs [9*{cin}, 64]")


def upsample_conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                             t: torch.Tensor) -> torch.Tensor:
    """x [B, S, S, Cin] -> relu(conv3x3(up2x(x)) * s + t), [B, 2S, 2S, 64]."""
    _need(x, "upconv x", ndim=4)
    b, h, w_, cin = x.shape
    if h != w_ or cin % 32:
        raise ValueError(f"upconv: x {tuple(x.shape)} (square, Cin % 32 == 0)")
    _conv_params(w, s, t, cin, "upconv")
    y = torch.empty((b, 2 * h, 2 * h, 64), dtype=x.dtype, device=x.device)
    _check(load().sp_upconv3x3_bn_relu(x.data_ptr(), w.data_ptr(),
                                        s.data_ptr(), t.data_ptr(), y.data_ptr(),
                                        b, h, cin, _stream(x)),
           "sp_upconv3x3_bn_relu")
    return y


def conv3x3_bn_relu_head(y: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                         t: torch.Tensor, head_w: torch.Tensor,
                         head_b: torch.Tensor) -> torch.Tensor:
    """y [B, H, W, 64] -> relu(conv3x3(y) * s + t) . head_w + head_b, [B, H, W]."""
    _need(y, "conv_head y", ndim=4)
    b, h, w_, c = y.shape
    if c != 64:
        raise ValueError(f"conv_head: y {tuple(y.shape)} needs 64 channels")
    _conv_params(w, s, t, 64, "conv_head")
    _need(head_w, "conv_head head weight", torch.float32, 1)
    _need(head_b, "conv_head head bias", torch.float32, 1)
    pred = torch.empty((b, h, w_), dtype=y.dtype, device=y.device)
    _check(load().sp_conv3x3_bn_relu_head(
        y.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
        head_w.data_ptr(), head_b.data_ptr(), pred.data_ptr(), b, h, w_,
        _stream(y)), "sp_conv3x3_bn_relu_head")
    return pred
