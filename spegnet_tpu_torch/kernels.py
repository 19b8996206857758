"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface on first use (a few seconds), cached under
``build/kernels/`` at the repository root by a hash of the sources, and
loaded with ctypes.  Nothing here runs at import time, so the package
imports on machines without CUDA.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and raises if
the C entry returns a CUDA error.  ``launches`` counts the calls of each
model-level wrapper (ops/*) that went through a kernel, and under
``<wrapper>_bwd`` the calls of its kernel backward; ``reset_launches``
clears it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
SOURCES = ("hiera_block.cu", "hiera_block_bwd.cu", "qpool_front.cu",
           "qpool_front_bwd.cu", "decoder_block.cu", "int8_gemm.cu")

launches = {
    "fused_block_t": 0,
    "fused_block": 0,
    "qpool_front": 0,
    "fused_decoder_block": 0,
    "fused_block_t_bwd": 0,
    "fused_block_bwd": 0,
    "qpool_front_bwd": 0,
    "fused_block_t_i8": 0,
    "qpool_front_i8": 0,
    "fused_block_i8": 0,
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
    (skipped when that file exists) and return its path.  Each source is
    compiled to an object by its own nvcc process, all started together,
    then linked.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    register/shared-memory report."""
    digest = _digest()
    so = BUILD_DIR / f"libspegnet_kernels_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    base = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        base += ["-Xptxas", "-v"]
    objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen(base + ["-c", str(CSRC / src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    errors, report = [], []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            errors.append(f"{src} ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", str(tmp)] + [str(o) for o in objs],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print("".join(report), flush=True)
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
        "sp_gemm": [p, p, p, p, p, p, i, i, i, i, p],
        "sp_window_attention": [p, p, p, i, i, i, i, i, f, p],
        "sp_qpool_attention": [p, p, p, i, i, i, i, i, f, p],
        "sp_pool4_rows": [p, p, l, i, i, i, p],
        "sp_attention_bwd": [p, l, p, l, p, l, p, l, p, l, p, p, p, l, p, l, p, l,
                             i, i, i, i, i, f, p],
        "sp_gemm_tn": [p, l, p, l, l, i, i, l, i, p, p, p, p, p],
        "sp_layernorm_bwd": [p, p, p, p, p, p, p, l, i, p, l, i, f, p],
        "sp_pool4_scatter": [p, l, i, p, l, p, l, i, l, i, p],
        "sp_upconv3x3_bn_relu": [p, p, p, p, p, i, i, i, p],
        "sp_conv3x3_bn_relu_head": [p, p, p, p, p, p, p, i, i, i, p],
        "sp_layernorm_q8": [p, p, p, p, p, l, i, f, p],
        "sp_quant_rows": [p, p, p, l, i, p],
        "sp_gemm_i8": [p, p, p, p, p, p, p, i, i, i, i, i, p],
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


_ACT = {"none": 0, "gelu": 1, "gelu_pre": 2, "gelu_grad": 3}


def _gemm(a, w, bias, residual, act, aux=None):
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
    _check(load().sp_gemm(a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(residual),
                           c.data_ptr(), _ptr(aux), m, n, k, _ACT[act], _stream(a)),
           "sp_gemm")
    return c


def gemm(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
         gelu: bool = False) -> torch.Tensor:
    """a [M, K] @ w[N, K]^T (+ bias) (-> tanh GELU) (+ residual), bf16
    (TMA + wgmma, csrc/hiera_block.cu)."""
    return _gemm(a, w, bias, residual, "gelu" if gelu else "none")


def gemm_gelu_pre(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """(z, gelu_tanh(z)) for z = a @ w^T + bias, both rounded from the same
    f32 sum (the forward's GELU epilogue plus its pre-activation)."""
    g = torch.empty((a.shape[0], w.shape[0]), dtype=a.dtype, device=a.device)
    return _gemm(a, w, bias, None, "gelu_pre", aux=g), g


def gemm_gelu_grad(a: torch.Tensor, w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """bf16(a @ w^T) * gelu_tanh'(z): the fc1 gradient dz of the block backward."""
    return _gemm(a, w, None, z, "gelu_grad")


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


def _lse(rows: int, heads: int, like: torch.Tensor, with_lse: bool):
    if not with_lse:
        return None
    return torch.empty((rows, heads), dtype=torch.float32, device=like.device)


def window_attention(qkv: torch.Tensor, heads: int, d: int, l: int,
                     scale: float, with_lse: bool = False):
    """qkv [rows, >=3*H*d] -> softmax(q k^T * scale) v per window of l
    consecutive rows, [rows, H*d] (and, with ``with_lse``, each row's
    log-sum-exp of its scaled scores in log2 units, [rows, H] f32)."""
    rows, ld = _attn_checks(qkv, heads, d, l, "window_attention")
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = _lse(rows, heads, qkv, with_lse)
    _check(load().sp_window_attention(qkv.data_ptr(), out.data_ptr(), _ptr(lse), rows,
                                       ld, heads, d, l, scale, _stream(qkv)),
           "sp_window_attention")
    return (out, lse) if with_lse else out


# ---------------------------------------------------------------------------
# launchers (csrc/qpool_front.cu)
# ---------------------------------------------------------------------------

def qpool_attention(y: torch.Tensor, heads: int, d: int, l: int,
                    scale: float, with_lse: bool = False):
    """y [rows, >=3*H*d]: q max-pooled over 4 consecutive rows, attending to
    the l rows of its window -> [rows/4, H*d] (and the log-sum-exp, as
    :func:`window_attention`)."""
    rows, ld = _attn_checks(y, heads, d, l, "qpool_attention")
    if rows % 64:
        raise ValueError(f"qpool_attention: {rows} rows must pool to a "
                         "multiple of 16")
    out = torch.empty((rows // 4, heads * d), dtype=y.dtype, device=y.device)
    lse = _lse(rows // 4, heads, y, with_lse)
    _check(load().sp_qpool_attention(y.data_ptr(), out.data_ptr(), _ptr(lse), rows, ld,
                                      heads, d, l, scale, _stream(y)),
           "sp_qpool_attention")
    return (out, lse) if with_lse else out


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
# launchers (csrc/hiera_block_bwd.cu, csrc/qpool_front_bwd.cu)
# ---------------------------------------------------------------------------

class Cols(NamedTuple):
    """Columns [col, col + heads * d) of a row-major bf16 matrix."""

    t: torch.Tensor
    col: int = 0

    def ptr(self) -> int:
        return self.t.data_ptr() + 2 * self.col

    @property
    def ld(self) -> int:
        return self.t.shape[1]


def attention_bwd(q: Cols, k: Cols, v: Cols, o: Cols, dout: Cols, lse: torch.Tensor,
                  dq: Cols, dk: Cols, dv: Cols, heads: int, d: int, lq: int, lk: int,
                  scale: float) -> None:
    """Gradients of softmax(q k^T * scale) v for query windows of lq rows
    against key windows of lk rows, written into dq / dk / dv.  ``o`` is the
    forward output and ``lse`` its log-sum-exp ([q rows, heads] f32)."""
    for c, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (dout, "dout"), (dq, "dq"),
                    (dk, "dk"), (dv, "dv")):
        _need(c.t, f"attention_bwd {name}", ndim=2)
        if c.col % 8 or c.ld % 8 or c.col + heads * d > c.ld:
            raise ValueError(f"attention_bwd {name}: columns [{c.col}, "
                             f"{c.col + heads * d}) of {c.ld}")
    q_rows = q.t.shape[0]
    if d % 8 or d > 128 or lk % 16 or q_rows % 16 or q_rows % lq:
        raise ValueError(f"attention_bwd: d={d}, lq={lq}, lk={lk}, {q_rows} query rows")
    k_rows = q_rows // lq * lk
    for c, rows, name in ((o, q_rows, "o"), (dout, q_rows, "dout"), (dq, q_rows, "dq"),
                          (k, k_rows, "k"), (v, k_rows, "v"), (dk, k_rows, "dk"),
                          (dv, k_rows, "dv")):
        if c.t.shape[0] != rows:
            raise ValueError(f"attention_bwd {name}: {c.t.shape[0]} rows, expected {rows}")
    _need(lse, "attention_bwd lse", torch.float32)
    if tuple(lse.shape) != (q_rows, heads):
        raise ValueError(f"attention_bwd: lse {tuple(lse.shape)}")
    dd = torch.empty_like(lse)
    _check(load().sp_attention_bwd(
        q.ptr(), q.ld, k.ptr(), k.ld, v.ptr(), v.ld, o.ptr(), o.ld, dout.ptr(), dout.ld,
        lse.data_ptr(), dd.data_ptr(), dq.ptr(), dq.ld, dk.ptr(), dk.ld, dv.ptr(), dv.ld,
        q_rows, heads, d, lq, lk, scale, _stream(lse)), "sp_attention_bwd")


def gemm_tn(a: torch.Tensor, b: torch.Tensor):
    """(a^T b [N, K] f32, column sums of a [N] f32) for a [M, N], b [M, K]
    bf16: a weight gradient and its bias gradient.  M is split to fill the
    card; the per-split partials are summed in a fixed order."""
    _need(a, "gemm_tn a", ndim=2)
    _need(b, "gemm_tn b", ndim=2)
    m, n = a.shape
    k = b.shape[1]
    if b.shape[0] != m or n % 8 or k % 8:
        raise ValueError(f"gemm_tn: a {tuple(a.shape)}, b {tuple(b.shape)}")
    tiles = -(-n // 64) * -(-k // 64)
    # Four 128-thread blocks on each of the card's SMs.
    target = 4 * torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = max(1, min(-(-target // tiles), -(-m // 256), 4096))
    m_split = -(-m // (32 * splits)) * 32
    splits = -(-m // m_split)
    f32 = dict(dtype=torch.float32, device=a.device)
    part = torch.empty((splits, n, k), **f32)
    cspart = torch.empty((splits, n), **f32)
    out = torch.empty((n, k), **f32)
    cs = torch.empty((n,), **f32)
    _check(load().sp_gemm_tn(a.data_ptr(), n, b.data_ptr(), k, m, n, k, m_split, splits,
                              part.data_ptr(), cspart.data_ptr(), out.data_ptr(),
                              cs.data_ptr(), _stream(a)), "sp_gemm_tn")
    return out, cs


def layernorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float,
                  dres=None):
    """LayerNorm backward on [rows, C] bf16 with f32 weight: (dx bf16, plus
    ``dres`` when given; dweight f32; dbias f32)."""
    _need(x, "layernorm_bwd x", ndim=2)
    _need(dy, "layernorm_bwd dy", ndim=2)
    _need(w, "layernorm_bwd weight", torch.float32, 1)
    rows, c = x.shape
    if tuple(dy.shape) != (rows, c) or w.numel() != c:
        raise ValueError(f"layernorm_bwd: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    if dres is not None:
        _need(dres, "layernorm_bwd dres", ndim=2)
        if tuple(dres.shape) != (rows, c):
            raise ValueError("layernorm_bwd: dres shape")
    r_split = max(64, -(-rows // 1024))
    splits = -(-rows // r_split)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    stats = torch.empty((rows, 2), **f32)
    part = torch.empty((splits, 2 * c), **f32)
    dwb = torch.empty((2 * c,), **f32)
    _check(load().sp_layernorm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), _ptr(dres),
                                    dx.data_ptr(), stats.data_ptr(), part.data_ptr(),
                                    r_split, splits, dwb.data_ptr(), rows, c, eps,
                                    _stream(x)), "sp_layernorm_bwd")
    return dx, dwb[:c], dwb[c:]


def pool4_scatter(y: Cols, g: torch.Tensor, out: Cols) -> None:
    """out rows 4r..4r+3 (g's columns) = g[r] / #ties at the rows where the
    y group of 4 rows takes its max, else 0 (the 2x2 max-pool backward)."""
    _need(y.t, "pool4_scatter y", ndim=2)
    _need(g, "pool4_scatter g", ndim=2)
    _need(out.t, "pool4_scatter out", ndim=2)
    rows_out, ncols = g.shape
    for c, name in ((y, "y"), (out, "out")):
        if (c.t.shape[0] != 4 * rows_out or c.col % 8 or c.ld % 8 or ncols % 8
                or c.col + ncols > c.ld):
            raise ValueError(f"pool4_scatter {name}: {tuple(c.t.shape)} col {c.col} "
                             f"vs g {tuple(g.shape)}")
    _check(load().sp_pool4_scatter(y.t.data_ptr(), y.ld, y.col, g.data_ptr(), ncols,
                                    out.t.data_ptr(), out.ld, out.col, rows_out, ncols,
                                    _stream(g)), "sp_pool4_scatter")


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


# ---------------------------------------------------------------------------
# launchers (csrc/int8_gemm.cu)
# ---------------------------------------------------------------------------

def _codes(rows: int, k: int, like: torch.Tensor):
    return (torch.empty((rows, k), dtype=torch.int8, device=like.device),
            torch.empty((rows,), dtype=torch.float32, device=like.device))


def layernorm_q8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """[rows, C] bf16 -> LayerNorm (f32 weight/bias, rounded to bf16) ->
    (int8 codes [rows, C], f32 row scales [rows])."""
    _need(x, "layernorm_q8 x", ndim=2)
    _need(w, "layernorm_q8 weight", torch.float32, 1)
    _need(b, "layernorm_q8 bias", torch.float32, 1)
    rows, c = x.shape
    if w.numel() != c or b.numel() != c or c % 8:
        raise ValueError(f"layernorm_q8: weight {tuple(w.shape)} vs C={c} (C % 8 == 0)")
    q, s = _codes(rows, c, x)
    _check(load().sp_layernorm_q8(x.data_ptr(), w.data_ptr(), b.data_ptr(), q.data_ptr(),
                                   s.data_ptr(), rows, c, eps, _stream(x)), "sp_layernorm_q8")
    return q, s


def quant_rows(x: torch.Tensor):
    """[rows, K] bf16 -> (int8 codes [rows, K], f32 row scales [rows])."""
    _need(x, "quant_rows x", ndim=2)
    rows, k = x.shape
    if k % 8:
        raise ValueError(f"quant_rows: K={k} must be a multiple of 8")
    q, s = _codes(rows, k, x)
    _check(load().sp_quant_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, k,
                                 _stream(x)), "sp_quant_rows")
    return q, s


def gemm_i8(a: torch.Tensor, sa: torch.Tensor, w: torch.Tensor, sw: torch.Tensor,
            bias: torch.Tensor, residual=None, gelu: bool = False,
            sw_first: bool = True) -> torch.Tensor:
    """a [M, K] int8 (row scales sa [M]) . w [N, K]^T int8 (row scales sw [N])
    -> int32, dequantized (acc * sw * sa with ``sw_first``, else acc * sa *
    sw) + bias [N] f32 (-> tanh GELU) -> bf16 (+ residual [M, N] bf16)."""
    _need(a, "gemm_i8 a", torch.int8, 2)
    _need(w, "gemm_i8 weight", torch.int8, 2)
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k or k % 32 or n % 8:
        raise ValueError(f"gemm_i8: a {tuple(a.shape)} vs weight {tuple(w.shape)} "
                         "(K % 32 == 0, N % 8 == 0)")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gemm_i8: cp.async needs 16-byte aligned operands")
    for t, name, size in ((sa, "row scales", m), (sw, "weight scales", n), (bias, "bias", n)):
        _need(t, f"gemm_i8 {name}", torch.float32, 1)
        if t.numel() != size:
            raise ValueError(f"gemm_i8: {name} length {t.numel()} != {size}")
    if residual is not None:
        _need(residual, "gemm_i8 residual", ndim=2)
        if tuple(residual.shape) != (m, n):
            raise ValueError("gemm_i8: residual shape != [M, N]")
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    _check(load().sp_gemm_i8(a.data_ptr(), sa.data_ptr(), w.data_ptr(), sw.data_ptr(),
                              bias.data_ptr(), _ptr(residual), c.data_ptr(), m, n, k,
                              int(gelu), int(sw_first), _stream(a)), "sp_gemm_i8")
    return c
