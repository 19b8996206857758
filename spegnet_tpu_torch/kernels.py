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
``<wrapper>_bwd`` the calls of its kernel backward (the attention wrappers
of ops/pallas_attention.py and ``fused_block`` on f32 have none: their
backward recomputes through the plain version, as the JAX package's does);
``fused_block_t_res`` / ``fused_block_t_bwd_res`` count the T-block calls
that took the saved-residual pair instead of ``fused_block_t`` /
``fused_block_t_bwd``; ``gemm_launches`` counts the hand-off GEMM's
launches inside them; ``reset_launches`` clears both.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
SOURCES = ("hiera_block.cu", "hiera_block_bwd.cu", "qpool_front.cu",
           "qpool_front_bwd.cu", "decoder_block.cu", "decoder_i8.cu", "int8_gemm.cu",
           "attention_lanes.cu", "block_f32.cu", "attention_f32.cu", "attention_window.cu",
           "attention_window_bwd.cu")

launches = {
    "fused_block_t": 0,
    "fused_block": 0,
    "qpool_front": 0,
    "fused_decoder_block": 0,
    "fused_decoder_block_i8": 0,
    "fused_decoder_block_edge": 0,
    "fused_block_t_bwd": 0,
    "fused_block_bwd": 0,
    "qpool_front_bwd": 0,
    "fused_block_t_i8": 0,
    "qpool_front_i8": 0,
    "fused_block_i8": 0,
    "fused_attention_lanes": 0,
    "fused_attention": 0,
    "fused_block_t_res": 0,
    "fused_block_t_bwd_res": 0,
}

# Launches of the hand-off GEMM (csrc/gemm_handoff.cuh) by :func:`gemm` and
# :func:`gemm_gelu_pre`: a kernel inside the wrappers above, counted apart
# from them.
gemm_launches = {"gemm_handoff": 0}

_lib = None


def reset_launches() -> None:
    for d in (launches, gemm_launches):
        for k in d:
            d[k] = 0


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


def build(verbose: bool = False, echo: bool = True) -> Path:
    """Compile csrc/*.cu into build/kernels/libspegnet_kernels_<hash>.so
    (skipped when that file exists) and return its path.  Each source is
    compiled to an object by its own nvcc process, all started together,
    then linked.  ``verbose`` adds ``-Xptxas -v`` and writes the compiler's
    register/shared-memory report beside the library (``<so>.ptxas.txt``,
    :func:`ptxas_usage`; a library built without one is built again),
    printed unless ``echo`` is False."""
    digest = _digest()
    so = BUILD_DIR / f"libspegnet_kernels_{digest}.so"
    if so.exists() and (not verbose or so.with_suffix(".ptxas.txt").exists()):
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
        so.with_suffix(".ptxas.txt").write_text("".join(report))
        if echo:
            print("".join(report), flush=True)
    os.replace(tmp, so)
    return so


def _template_args(mangled: str, kernel: str) -> tuple:
    """The template arguments of ``kernel`` in an Itanium-mangled name: ints
    and bools as ints, types by name (``float``, ``__nv_bfloat16``)."""
    i = mangled.find(kernel + "I")
    if i < 0:
        return ()
    s, pos, out = mangled, i + len(kernel) + 1, []
    builtin = {"f": "float", "i": "int", "a": "signed char", "h": "unsigned char"}
    while pos < len(s) and s[pos] != "E":
        if s[pos] == "L":
            end = s.index("E", pos)
            out.append(int(s[pos + 2:end]))
            pos = end + 1
        elif s[pos].isdigit():
            j = pos
            while s[j].isdigit():
                j += 1
            n = int(s[pos:j])
            out.append(s[j:j + n])
            pos = j + n
        else:
            out.append(builtin.get(s[pos], s[pos]))
            pos += 1
    return tuple(out)


def ptxas_usage(kernel: str, report: Optional[str] = None):
    """[(template arguments, registers, spill store bytes, spill load bytes)]
    of each instantiation of ``kernel`` in a ptxas report (default: the one
    a verbose :func:`build` of the current sources wrote; empty if none);
    the arguments a tuple of its int / bool values and type names."""
    import re

    if report is None:
        path = BUILD_DIR / f"libspegnet_kernels_{_digest()}.ptxas.txt"
        report = path.read_text() if path.exists() else ""
    out, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((_template_args(name, kernel), int(m.group(1))) + spill)
            name, spill = None, (0, 0)
    return out


def load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
    ll = ctypes.c_longlong
    sigs = {
        "sp_layernorm": [p, p, p, p, l, i, f, p],
        "sp_gemm": [p, p, p, p, p, p, i, i, i, i, i, i, i, p],
        "sp_window_attention": [p, i, p, p, i, i, i, i, ll, f, p],
        "sp_qpool_attention": [p, i, p, p, i, i, i, i, ll, f, p],
        "sp_pool4_rows": [p, p, l, i, i, i, p],
        "sp_attention_bwd": [p, l, p, l, p, l, p, l, p, l, p, p, p, l, p, l, p, l,
                             i, i, i, i, i, ll, f, p],
        "sp_gemm_tn": [p, p, i, i, i, i, i, i, i, p, p, p, p, p],
        "sp_layernorm_bwd": [p, p, p, p, p, p, l, i, i, i, l, i, p, f, p],
        "sp_pool4_scatter": [p, l, i, p, l, p, l, i, l, i, p],
        "sp_dec_upconv": [p, p, p, p, p, i, i, i, i, p],
        "sp_dec_conv_head": [p, p, p, p, p, p, p, i, i, i, i, p],
        "sp_upconv3x3_edge_bn_relu": [p, p, p, p, p, p, p, i, i, i, i, i, i, p],
        "sp_conv3x3_bn_relu_head": [p, p, p, p, p, p, p, i, i, i, i, i, p],
        "sp_conv3x3_bn_relu": [p, p, p, p, p, i, i, i, i, i, p],
        "sp_quant_image_i8": [p, p, p, p, i, i, i, p],
        "sp_dec_strips": [p, p, p, i, i, i, i, p],
        "sp_polyconv1_i8": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p],
        "sp_conv2_i8_head": [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p],
        "sp_layernorm_q8": [p, p, p, p, p, l, i, f, i, i, i, p],
        "sp_quant_rows": [p, p, p, l, i, i, p],
        "sp_gemm_i8": [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
        "sp_lanes_attention": [p, l, l, l, p, l, l, l, p, l, l, l, p, l, l, l,
                               i, i, i, i, i, i, i, i, i, f, p],
        "sp_attention_f32": [p, l, l, l, p, l, l, l, p, l, l, l, p, l, l, l,
                             i, i, i, i, f, p],
        "sp_attention_tf32": [p, l, l, l, p, l, l, l, p, l, l, l, p, l, l, l,
                              i, i, i, i, i, i, i, i, i, f, p],
        "sp_layernorm_f32": [p, p, p, p, l, i, f, p],
        "sp_gemm_f32": [p, p, p, p, p, i, i, i, i, i, i, p],
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


# The current stream's handle without a torch.cuda.Stream object (host
# time on every launch); None on builds of torch without CUDA.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
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


# The persistent TMA + wgmma GEMM (csrc/gemm_persistent.cuh) behind
# :func:`gemm`, :func:`gemm_i8` and :func:`gemm_f32`: 128-row output tiles,
# BN columns of those built for each operand type ("int8_f32": int8 with an
# f32 output, #12 on f32, which stages twice the bytes; "f32": the 3xTF32
# form, whose BN 192 would not fit its registers and shared memory).
GEMM_BM = 128
GEMM_BN = {"bf16": (144, 192), "int8": (144, 192), "int8_f32": (144,), "f32": (144,)}
# The reckoning of :func:`gemm_seconds`: a tile's k-loop at this share of an
# SM's part of the dense tensor-core rate (3xTF32: three TF32 products per
# multiply-add), then its epilogue's output bytes at the SM's part of the HBM
# rate (the stores of all SMs share it).
_GEMM_EFF = 0.75
_GEMM_PEAK = {"bf16": 989e12, "int8": 1979e12, "int8_f32": 1979e12, "f32": 495e12 / 3}
_GEMM_OUT_BYTES = {"bf16": 2, "int8": 2, "int8_f32": 4, "f32": 4}
_HBM = 3.35e12


class GemmPlan(NamedTuple):
    """Launch plan of the forward GEMM for A[M, K] W[N, K]^T: tiles of 128 x
    ``bn``, ``m_tiles`` x ``n_tiles`` of them (N fastest), walked by
    ``grid`` blocks, block b taking tiles b, b + grid, ...; on the
    persistent kernel (csrc/gemm_persistent.cuh), or with
    ``handoff`` on the hand-off kernel (csrc/gemm_handoff.cuh)."""
    bn: int
    m_tiles: int
    n_tiles: int
    grid: int
    handoff: bool = False

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles


def gemm_seconds(m: int, n: int, k: int, bn: int, sms: int, dtype: str = "bf16") -> float:
    """Estimated time of one persistent-GEMM call with 128 x ``bn`` tiles on
    a card of ``sms`` SMs: the tiles of the busiest block (the wave count)
    times one tile's k-loop plus its epilogue, at the rates above."""
    tiles = -(-m // GEMM_BM) * -(-n // bn)
    rounds = -(-tiles // sms)
    mma = 2.0 * GEMM_BM * bn * k / (_GEMM_EFF * _GEMM_PEAK[dtype] / sms)
    epilogue = GEMM_BM * bn * _GEMM_OUT_BYTES[dtype] / (_HBM / sms)
    return rounds * (mma + epilogue)


@functools.lru_cache(maxsize=512)
def gemm_plan(m: int, n: int, k: int, sms: int, dtype: str = "bf16",
              residual: bool = False) -> GemmPlan:
    """The plan of the forward GEMM for ``dtype`` ("bf16", "int8",
    "int8_f32" or "f32"): the tile width of :data:`GEMM_BN` of least
    :func:`gemm_seconds` (within 1e-9 of it, the widest: fewer, larger
    tiles), and min(tiles, ``sms``) blocks.  A bf16 product at width 192
    whose epilogue reads no ``residual`` (fc1 with its GELU, the fronts'
    stacked product) takes the hand-off kernel, whose epilogue warps run
    beside the next tile's MMAs; every other product the persistent
    kernel.  Every output tile is computed by one block; the sums run over
    K in k order whatever the plan, so the results do not depend on it."""
    if m < 1 or n < 1 or k < 1 or m >= 2 ** 31:
        raise ValueError(f"gemm: M={m}, N={n}, K={k}")
    cost = {bn: gemm_seconds(m, n, k, bn, sms, dtype) for bn in GEMM_BN[dtype]}
    best = min(cost.values())
    bn = max(b for b, t in cost.items() if t <= best * (1 + 1e-9))
    m_tiles, n_tiles = -(-m // GEMM_BM), -(-n // bn)
    if m_tiles * n_tiles >= 2 ** 31:
        raise ValueError(f"gemm: M={m}, N={n} needs 2^31 or more tiles")
    return GemmPlan(bn, m_tiles, n_tiles, min(m_tiles * n_tiles, sms),
                    dtype == "bf16" and bn == 192 and not residual)


def _gemm(a, w, bias, residual, act, aux=None):
    _need(a, "gemm a", ndim=2)
    _need(w, "gemm weight", ndim=2)
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"gemm: a {tuple(a.shape)} vs weight {tuple(w.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8")
    plan = gemm_plan(m, n, k, _sm_count(a.device.index), "bf16", residual is not None)
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
                           c.data_ptr(), _ptr(aux), m, n, k, _ACT[act], plan.bn, plan.grid,
                           int(plan.handoff), _stream(a)), "sp_gemm")
    if plan.handoff:
        gemm_launches["gemm_handoff"] += 1
    return c


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias=None, gelu: bool = False,
               pre: bool = False):
    """The plain version of :func:`gemm` without a residual (and, with
    ``pre``, of :func:`gemm_gelu_pre`): the f32 product of the bf16
    operands (+ bias) (-> tanh GELU) rounded to a's dtype."""
    v = a.float() @ w.float().t()
    if bias is not None:
        v = v + bias.float()
    if pre:
        return v.to(a.dtype), torch.nn.functional.gelu(v, approximate="tanh").to(a.dtype)
    return (torch.nn.functional.gelu(v, approximate="tanh") if gelu else v).to(a.dtype)


def gemm(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
         gelu: bool = False) -> torch.Tensor:
    """a [M, K] @ w[N, K]^T (+ bias) (-> tanh GELU) (+ residual), bf16
    (the persistent TMA + wgmma GEMM, csrc/hiera_block.cu, or the hand-off
    GEMM, as :func:`gemm_plan` says)."""
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
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 8, <= {MAX_HEAD_DIM}")
    if ld % 8 or ld < 3 * heads * d or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: row length {ld} vs 3*{heads}*{d} (a multiple of 8, "
                         "16-byte aligned)")
    if l % 16 or rows % l:
        raise ValueError(f"{name}: window {l} must be a multiple of 16 dividing "
                         f"{rows} rows")
    return rows, ld


# csrc/attention_window.cu: the window attention of the T-block, the Q-pool
# front and the gen-1 block (TMA + wgmma, :func:`window_plan`).

class WindowPlan(NamedTuple):
    """Launch plan of csrc/attention_window.cu: ``dv`` the P.V width;
    ``shared`` items of 128 * ``mt`` query rows of one (window, head) whose
    two consumer warpgroups read the same K/V tiles (Lq a multiple of 128,
    Lk of 64, not pooled), else one 64-row m-tile of one head per consumer,
    over the keys of the windows its rows touch, under the block-diagonal
    mask where ``mask`` (a 64-key tile not one window's: Lq or Lk not a
    multiple of 64); ``pool`` queries max-pooled over 4 rows in the kernel
    (the front); ``items`` the work items, ``grid`` the persistent blocks
    that stride over them."""
    dv: int
    shared: bool
    mt: int
    mask: bool
    pool: bool
    items: int
    grid: int
    arg: int   # the plan as the C entries take it: mode | grid << 16 | items << 32

    @property
    def mode(self) -> int:
        """The variant: dv | shared << 9 | (mt - 1) << 10 | mask << 11 |
        pool << 12."""
        return self.arg & 0xFFFF


@functools.lru_cache(maxsize=256)
def window_plan(q_rows: int, heads: int, d: int, lq: int, lk: int, sms: int,
                mt: Optional[int] = None, pool: bool = False) -> WindowPlan:
    """The work list of csrc/attention_window.cu for ``q_rows`` query rows
    in windows of ``lq`` against key windows of ``lk`` rows, ``heads`` heads
    of dim ``d`` (a multiple of 8) on a card of ``sms`` SMs: about one block
    per SM (fewer when there are fewer items).  ``mt`` (m-tiles per consumer
    of a shared item) by default as :func:`attention_plan` picks it;
    ``pool``: the front's pooled queries (lq = lk / 4), always per
    consumer."""
    dv = next(x for x in ATTN_DV if x >= d)
    shared = not pool and lq % (2 * _AW_ROWS) == 0 and lk % _AW_ROWS == 0

    def n_items(m):
        if shared:
            return q_rows // lq * heads * (lq // (2 * m * _AW_ROWS))
        return heads * -(-(-(-q_rows // _AW_ROWS)) // 2)

    if mt is None:
        mt = 1
        if shared and dv <= 80 and lq % (4 * _AW_ROWS) == 0:
            rounds = {m: -(-n_items(m) // sms) for m in (1, 2)}
            mt = 2 if 1.8 * rounds[2] < rounds[1] else 1
    if mt not in (1, 2) or (mt == 2 and (not shared or dv > 80 or lq % (4 * _AW_ROWS))):
        raise ValueError(f"window attention: {mt} m-tiles at Lq {lq}, P.V width {dv}")
    if pool and lk != 4 * lq:
        raise ValueError(f"window attention: pooled query windows of {lq} rows, keys {lk}")
    items = n_items(mt)
    if items >= 2 ** 31 or (q_rows // lq) * lk + 128 * lk >= 2 ** 31:
        raise ValueError(f"window attention: {items} work items, {q_rows} query rows")
    mask = not shared and (lq % _AW_ROWS != 0 or lk % _AW_ROWS != 0)
    grid = min(items, sms)
    mode = dv | shared << 9 | (mt - 1) << 10 | mask << 11 | pool << 12
    return WindowPlan(dv, shared, mt, mask, pool, items, grid, mode | grid << 16 | items << 32)


def window_tmap(rows: int, ld: int, slots: int, d: int):
    """The tensor map csrc/attention_window.cu encodes over a token-major
    [rows, ld] bf16 matrix (``make_rows_tmap``): dims (d, head slots, rows)
    innermost first, byte strides of a head slot and a row, the box; head
    slot h is columns [h * d, (h + 1) * d), and a box past column d, the
    last slot or the last row reads zeros."""
    return (d, slots, rows), (2 * d, 2 * ld), (64, 1, _AW_ROWS)


def _lse(rows: int, heads: int, like: torch.Tensor, with_lse: bool):
    if not with_lse:
        return None
    return torch.empty((rows, heads), dtype=torch.float32, device=like.device)


def window_attention(qkv: torch.Tensor, heads: int, d: int, l: int,
                     scale: float, with_lse: bool = False,
                     plan: Optional[WindowPlan] = None):
    """qkv [rows, >=3*H*d] -> softmax(q k^T * scale) v per window of l
    consecutive rows, [rows, H*d] (and, with ``with_lse``, each row's
    log-sum-exp of its scaled scores in log2 units, [rows, H] f32).
    ``plan``: a :func:`window_plan` of this call in place of its default."""
    rows, ld = _attn_checks(qkv, heads, d, l, "window_attention")
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = _lse(rows, heads, qkv, with_lse)
    if plan is None:
        plan = window_plan(rows, heads, d, l, l, _sm_count(qkv.get_device()))
    _check(load().sp_window_attention(qkv.data_ptr(), ld, out.data_ptr(), _ptr(lse), rows,
                                       heads, d, l, plan.arg, scale, _stream(qkv)),
           "sp_window_attention")
    return (out, lse) if with_lse else out


def qpool_attention(y: torch.Tensor, heads: int, d: int, l: int,
                    scale: float, with_lse: bool = False,
                    plan: Optional[WindowPlan] = None):
    """y [rows, >=3*H*d]: q max-pooled over 4 consecutive rows, attending to
    the l rows of its window -> [rows/4, H*d] (and the log-sum-exp, as
    :func:`window_attention`); the kernel pools q as it builds each query
    tile.  ``plan``: a pooled :func:`window_plan` of this call."""
    rows, ld = _attn_checks(y, heads, d, l, "qpool_attention")
    if rows % 64:
        raise ValueError(f"qpool_attention: {rows} rows must pool to a "
                         "multiple of 16")
    out = torch.empty((rows // 4, heads * d), dtype=y.dtype, device=y.device)
    lse = _lse(rows // 4, heads, y, with_lse)
    if plan is None:
        plan = window_plan(rows // 4, heads, d, l // 4, l, _sm_count(y.get_device()), pool=True)
    _check(load().sp_qpool_attention(y.data_ptr(), ld, out.data_ptr(), _ptr(lse), rows, heads,
                                      d, l, plan.arg, scale, _stream(y)), "sp_qpool_attention")
    return (out, lse) if with_lse else out


# ---------------------------------------------------------------------------
# launchers (csrc/qpool_front.cu)
# ---------------------------------------------------------------------------


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


# csrc/attention_window_bwd.cu: the attention backward of the T-block, the
# gen-1 block's bf16 backward and the Q-pool front (TMA + wgmma,
# :func:`window_bwd_plan`).  Widths of its dK / dV / dQ products: the head
# dim rounds up to one.  A consumer holds dK and dV of 64 keys in registers,
# 2 x 64 f32 a thread at width 128; above it they do not fit beside the
# scores, so the backward takes head dims up to 128.
ATTN_BWD_DV = (16, 32, 48, 64, 72, 80, 96, 128)


class WindowBwdPlan(NamedTuple):
    """Launch plan of csrc/attention_window_bwd.cu.  ``packed``: every key
    window divides a 64-key tile and one tile's windows hold ``qt`` (64 or
    16) query rows: one kernel per call, a unit of 64 keys and their ``qt``
    queries per consumer, dQ inside the unit (``units`` (key tile, head)
    pairs over ``grid_a`` blocks).  Else the split route: the dQ kernel
    (``items_q`` items of two 64-row query tiles, or with ``shared_q`` of 128
    query rows of one window, over ``grid_b`` blocks; it also writes lse and
    Di by head, transposed, for the second kernel's TMA loads),
    then the dK / dV kernel (``items_kv`` pairs of 64-key tiles of one head,
    read against the same query tiles where ``shared_kv``, over ``grid_a``
    blocks).  ``mask``: a tile holds keys or queries of more than one window
    (the block-diagonal mask)."""
    dv: int
    packed: bool
    qt: int
    mask: bool
    shared_kv: bool
    shared_q: bool
    units: int
    items_kv: int
    items_q: int
    grid_a: int
    grid_b: int
    arg: int   # mode | grid_a << 16 | grid_b << 32

    @property
    def mode(self) -> int:
        """dv | packed << 9 | (qt == 16) << 10 | mask << 11 | shared_kv << 12
        | shared_q << 13."""
        return self.arg & 0xFFFF

    @property
    def route(self) -> str:
        return "packed" if self.packed else "split"


@functools.lru_cache(maxsize=256)
def window_bwd_plan(q_rows: int, heads: int, d: int, lq: int, lk: int,
                    sms: int) -> WindowBwdPlan:
    """The work list of csrc/attention_window_bwd.cu for ``q_rows`` query
    rows in windows of ``lq`` against key windows of ``lk`` rows, ``heads``
    heads of dim ``d`` (a multiple of 8, at most 128) on a card of ``sms``
    SMs: about one block per SM.  The packed route where ``lk`` divides 64
    and 64 / lk * lq is 64 or 16 (Hiera's L 16 and 64 blocks, the fronts
    t12 and t23), else the split route (stage 3, the global blocks, t34)."""
    dv = next((x for x in ATTN_BWD_DV if x >= d), None)
    if dv is None or d % 8 or lk % 16 or lk < 16 or lq < 1 or q_rows % lq:
        raise ValueError(f"attention backward: d={d}, lq={lq}, lk={lk}, {q_rows} query rows")
    k_rows = q_rows // lq * lk
    k_tiles = -(-k_rows // _AW_ROWS)
    q_tiles = -(-q_rows // _AW_ROWS)
    packed = _AW_ROWS % lk == 0 and _AW_ROWS // lk * lq in (16, 64)
    if packed:
        qt, mask = _AW_ROWS // lk * lq, lk < _AW_ROWS
        shared_kv = shared_q = False
        units, items_kv, items_q = k_tiles * heads, 0, 0
        grid_a, grid_b = min(-(-units // 2), sms), 0
    else:
        qt, mask = _AW_ROWS, lq % _AW_ROWS != 0 or lk % _AW_ROWS != 0
        shared_kv = lk % (2 * _AW_ROWS) == 0 and not mask
        shared_q = lq % (2 * _AW_ROWS) == 0 and not mask
        units = 0
        items_kv = heads * -(-k_tiles // 2)
        items_q = (q_rows // lq * heads * (lq // (2 * _AW_ROWS)) if shared_q
                   else heads * -(-q_tiles // 2))
        grid_a, grid_b = min(items_kv, sms), min(items_q, sms)
    if max(units, items_kv, items_q) >= 2 ** 31 or k_rows + 2 * _AW_ROWS >= 2 ** 31:
        raise ValueError(f"attention backward: {q_rows} query rows, {k_rows} key rows")
    mode = (dv | packed << 9 | (qt == 16) << 10 | mask << 11 | shared_kv << 12
            | shared_q << 13)
    return WindowBwdPlan(dv, packed, qt, mask, shared_kv, shared_q, units, items_kv, items_q,
                         grid_a, grid_b, mode | grid_a << 16 | grid_b << 32)


def window_bwd_tmap(rows: int, ld: int, heads: int, d: int, box_rows: int):
    """The tensor map csrc/attention_window_bwd.cu encodes over heads * d
    columns of a row-major [rows, ld] bf16 matrix from its first column
    (``bwd_tmap``): dims (d, heads, rows) innermost first, byte strides of a
    head and a row, the box; a box past column d or the last row reads
    zeros."""
    return (d, heads, rows), (2 * d, 2 * ld), (64, 1, box_rows)


def attention_bwd(q: Cols, k: Cols, v: Cols, o: Cols, dout: Cols, lse: torch.Tensor,
                  dq: Cols, dk: Cols, dv: Cols, heads: int, d: int, lq: int, lk: int,
                  scale: float) -> None:
    """Gradients of softmax(q k^T * scale) v for query windows of lq rows
    against key windows of lk rows, written into dq / dk / dv
    (csrc/attention_window_bwd.cu, :func:`window_bwd_plan`).  ``o`` is the
    forward output and ``lse`` its log-sum-exp in log2 units ([q rows,
    heads] f32, as :func:`window_attention` writes it)."""
    checked = set()   # the block passes q, k, v (and dq, dk, dv) in one matrix: check it once
    for c, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (dout, "dout"), (dq, "dq"),
                    (dk, "dk"), (dv, "dv")):
        if id(c.t) not in checked:
            _need(c.t, f"attention_bwd {name}", ndim=2)
            if c.t.data_ptr() % 16:
                raise ValueError(f"attention_bwd {name}: not 16-byte aligned")
            checked.add(id(c.t))
        if c.col % 8 or c.ld % 8 or c.col + heads * d > c.ld:
            raise ValueError(f"attention_bwd {name}: columns [{c.col}, "
                             f"{c.col + heads * d}) of {c.ld}")
    q_rows = q.t.shape[0]
    if d % 8 or d > ATTN_BWD_DV[-1] or lk % 16 or q_rows % 16 or q_rows % lq:
        raise ValueError(f"attention_bwd: d={d} (a multiple of 8, at most "
                         f"{ATTN_BWD_DV[-1]}), lq={lq}, lk={lk}, {q_rows} query rows")
    k_rows = q_rows // lq * lk
    for c, rows, name in ((o, q_rows, "o"), (dout, q_rows, "dout"), (dq, q_rows, "dq"),
                          (k, k_rows, "k"), (v, k_rows, "v"), (dk, k_rows, "dk"),
                          (dv, k_rows, "dv")):
        if c.t.shape[0] != rows:
            raise ValueError(f"attention_bwd {name}: {c.t.shape[0]} rows, expected {rows}")
    _need(lse, "attention_bwd lse", torch.float32)
    if tuple(lse.shape) != (q_rows, heads):
        raise ValueError(f"attention_bwd: lse {tuple(lse.shape)}")
    plan = window_bwd_plan(q_rows, heads, d, lq, lk, _sm_count(lse.get_device()))
    stream = _stream(lse)
    # the split route's lse and Di by head, transposed ([2 heads, q rows] f32)
    dd = None if plan.packed else _scratch(lse, stream, 2 * heads * q_rows)
    _check(load().sp_attention_bwd(
        q.ptr(), q.ld, k.ptr(), k.ld, v.ptr(), v.ld, o.ptr(), o.ld, dout.ptr(), dout.ld,
        lse.data_ptr(), dd, dq.ptr(), dq.ld, dk.ptr(), dk.ld, dv.ptr(), dv.ld,
        q_rows, heads, d, lq, lk, plan.arg, scale, stream), "sp_attention_bwd")


_scratch_bufs = {}


def _scratch(like: torch.Tensor, stream: int, n: int) -> int:
    """The address of an f32 scratch buffer of at least ``n`` elements on
    ``like``'s device, one per stream, kept between calls (host time per
    call; each call's kernels finish with it before the next call's start,
    in stream order)."""
    key = (like.get_device(), stream)
    buf = _scratch_bufs.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=like.device)
        _scratch_bufs[key] = buf
    return buf.data_ptr()


# Output tiles of csrc/hiera_block_bwd.cu's weight-gradient GEMM (the
# instantiations of gemm_tn_kernel): (64-row blocks per consumer warpgroup,
# so 128 * mt rows; columns tk).  Narrower tiles move more operand bytes
# per FLOP and are not built.
TN_TILES = ((1, 192), (1, 256), (2, 192))
TN_BM = 64      # rows of M per stage
# Rows of M one block sums in the tensor cores: their accumulation
# truncates (common.cuh `mma_3xtf32`), a bias that grows with the rows of
# a sum, so a split takes at most this many.
TN_MAX_SPLIT = 8192
# The reckoning's rates, fitted to the kernel's device times at the 19
# weight-gradient shapes of a Hiera-L 512^2 training step under two tile
# sets (utils/gemm_tn_bench.py on an H100 80GB HBM3 at 700 W): a block
# runs its tile's FLOPs at 65% of an SM's share of the dense bf16 peak (989
# TFLOP/s) or draws its operand tiles at 65 GB/s per SM through L2,
# whichever is slower, plus 3 us per wave; operands stream from memory at
# 2.2 TB/s, partials at 3 TB/s.
_PEAK_BF16 = 989e12
_TN_EFF = 0.65
_SM_FEED = 65e9
_WAVE_S = 3e-6
_HBM_STREAM = 2.2e12
_PARTIALS = 3e12


class TnPlan(NamedTuple):
    """Launch plan of :func:`gemm_tn` for a[M, N], b[M, K]: output tiles of
    128 * ``mt`` x ``tk``, ``n_tiles`` x ``k_tiles`` of them, each computed
    by ``splits`` blocks over consecutive ``m_split``-row slices of M."""
    mt: int
    tk: int
    n_tiles: int
    k_tiles: int
    splits: int
    m_split: int


def gemm_tn_seconds(m: int, n: int, k: int, mt: int, tk: int, splits: int, sms: int) -> float:
    """Estimated time of one :func:`gemm_tn` call with 128 * mt x tk tiles
    and ``splits`` splits on a card of ``sms`` SMs: the waves of blocks
    times one block's time, or the operands read once from memory,
    whichever is longer, plus the f32 result (and with more than one split
    the partials, written and read back by the reduce pass), at the rates
    above."""
    bn = 128 * mt
    tiles = -(-n // bn) * -(-k // tk)
    m_split = -(-m // (TN_BM * splits)) * TN_BM
    splits = -(-m // m_split)
    waves = -(-tiles * splits // sms)
    block = max(2.0 * m_split * bn * tk / (_TN_EFF * _PEAK_BF16 / sms),
                2.0 * m_split * (bn + 64 * -(-tk // 64)) / _SM_FEED) + _WAVE_S
    operands = 2.0 * m * (n + k) / _HBM_STREAM
    partials = (2 * splits + 1 if splits > 1 else 1) * n * (k + 1) * 4 / _PARTIALS
    return max(waves * block, operands) + partials


@functools.lru_cache(maxsize=256)
def gemm_tn_plan(m: int, n: int, k: int, sms: int) -> TnPlan:
    """The plan of csrc/hiera_block_bwd.cu's weight-gradient GEMM: the tile
    of :data:`TN_TILES` and the split count of least :func:`gemm_tn_seconds`,
    on a tie the fewer splits, then the earlier tile.  Split counts run from
    the fewest that keep a split within :data:`TN_MAX_SPLIT` rows up to one
    split per TN_BM rows or four blocks per SM (more only add partials),
    and 2^31 - 1 blocks."""
    best = None
    for rank, (mt, tk) in enumerate(TN_TILES):
        tiles = -(-n // (128 * mt)) * -(-k // tk)
        lo = -(-m // TN_MAX_SPLIT)
        hi = min(max(lo, min(-(-m // TN_BM), 4 * sms)), (2 ** 31 - 1) // tiles)
        for s in range(lo, hi + 1):
            key = (gemm_tn_seconds(m, n, k, mt, tk, s, sms), s, rank)
            best = key if best is None else min(best, key)
    if best is None:
        raise ValueError(f"gemm_tn: no tile fits N={n}, K={k} in 2^31 blocks")
    _, s, rank = best
    mt, tk = TN_TILES[rank]
    m_split = -(-m // (TN_BM * s)) * TN_BM
    return TnPlan(mt, tk, -(-n // (128 * mt)), -(-k // tk), -(-m // m_split), m_split)


def gemm_tn(a: torch.Tensor, b: torch.Tensor):
    """(a^T b [N, K] f32, column sums of a [N] f32) for a [M, N], b [M, K]
    bf16: a weight gradient and its bias gradient (TMA + wgmma,
    csrc/hiera_block_bwd.cu).  M is split to fill the card
    (:func:`gemm_tn_plan`); the per-split partials are summed in a fixed
    order, so two calls give the same bits."""
    _need(a, "gemm_tn a", ndim=2)
    _need(b, "gemm_tn b", ndim=2)
    m, n = a.shape
    k = b.shape[1]
    if b.shape[0] != m or n % 8 or k % 8 or m < 1 or m >= 2 ** 31:
        raise ValueError(f"gemm_tn: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("gemm_tn: TMA needs 16-byte aligned operands")
    plan = gemm_tn_plan(m, n, k, _sm_count(a.device.index))
    f32 = dict(dtype=torch.float32, device=a.device)
    out = torch.empty((n, k), **f32)
    cs = torch.empty((n,), **f32)
    part, cspart = out, cs    # one split: the blocks write the result
    if plan.splits > 1:
        part = torch.empty((plan.splits, n, k), **f32)
        cspart = torch.empty((plan.splits, n), **f32)
    _check(load().sp_gemm_tn(a.data_ptr(), b.data_ptr(), m, n, k, plan.tk, plan.mt,
                              plan.m_split, plan.splits, part.data_ptr(), cspart.data_ptr(),
                              out.data_ptr(), cs.data_ptr(), _stream(a)), "sp_gemm_tn")
    return out, cs


# csrc/hiera_block_bwd.cu's LayerNorm backward: a group of lanes a row, each
# lane at most LNB_NV_SHORT of the row's 16-byte vectors where a group of up
# to 32 lanes holds the row so, else 32 lanes of at most LNB_NV (the narrow
# form) or LNB_WIDE_NV (the wide form, its column sums in shared memory); a
# CTA of LNB_THREADS threads walks a strip of at least LNB_PASSES passes of
# its groups, the grid at most LNB_PER_SM CTAs a streaming multiprocessor.
LNB_NV_SHORT = 3
LNB_NV = 5
LNB_WIDE_NV = 16
LNB_THREADS = 128
LNB_PASSES = 2
LNB_PER_SM = 4


class LnBwdPlan(NamedTuple):
    """Launch plan of the LayerNorm backward: ``lanes`` (a power of 2, at
    most 32) serve a row, lane j holding its 16-byte vectors j, j + lanes,
    ... (at most ``nv``); ``wide``: the form with its column sums in shared
    memory; ``ctas`` CTAs, CTA k walking rows [k strip, (k + 1) strip)."""
    lanes: int
    nv: int
    wide: bool
    strip: int
    ctas: int


@functools.lru_cache(maxsize=256)
def layernorm_bwd_plan(rows: int, c: int, sms: int) -> LnBwdPlan:
    """The fewest lanes that hold a bf16 row of ``c`` (a multiple of 8) in
    LNB_NV_SHORT vectors each; else 32 lanes of ceil(vectors / 32) <= LNB_NV
    (the narrow form) or LNB_WIDE_NV (the wide form); rows past 32 *
    LNB_WIDE_NV vectors raise.  Strips: a multiple of a CTA's groups, at
    least LNB_PASSES passes of them where the rows allow, at most ``sms`` *
    LNB_PER_SM CTAs, none empty."""
    if c < 8 or c % 8 or rows < 1:
        raise ValueError(f"layernorm_bwd: C={c} must be a positive multiple of 8, rows {rows}")
    nvec = c // 8
    lanes = next((1 << lg for lg in range(6) if -(-nvec // (1 << lg)) <= LNB_NV_SHORT), 32)
    nv = -(-nvec // lanes)
    if nv > LNB_WIDE_NV:
        raise ValueError(f"layernorm_bwd: C={c} is past {32 * LNB_WIDE_NV * 8}, the longest "
                         "row a warp holds")
    wide = nv > LNB_NV
    if wide:
        nv = LNB_WIDE_NV
    groups = LNB_THREADS // lanes
    ctas = max(1, min(sms * LNB_PER_SM, -(-rows // (groups * LNB_PASSES))))
    strip = -(-(-(-rows // ctas)) // groups) * groups
    return LnBwdPlan(lanes, nv, wide, strip, -(-rows // strip))


def layernorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float,
                  dres=None):
    """LayerNorm backward on [rows, C] bf16 with f32 weight: (dx bf16, plus
    ``dres`` when given; dweight f32; dbias f32), one pass over the rows
    (:func:`layernorm_bwd_plan`); the per-CTA partial sums are added in a
    fixed order, so two calls give the same bits."""
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
    if any(t is not None and t.data_ptr() % 16 for t in (x, dy, dres, w)):
        raise ValueError("layernorm_bwd: 16-byte loads need 16-byte aligned operands")
    plan = layernorm_bwd_plan(rows, c, _sm_count(x.get_device()))
    dx = torch.empty_like(x)
    dwb = torch.empty((2 * c,), dtype=torch.float32, device=x.device)
    part = dwb if plan.ctas == 1 else torch.empty((plan.ctas, 2 * c), dtype=torch.float32,
                                                  device=x.device)
    _check(load().sp_layernorm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), _ptr(dres),
                                    dx.data_ptr(), part.data_ptr(), rows, c,
                                    plan.lanes.bit_length() - 1, plan.nv, plan.strip,
                                    plan.ctas, dwb.data_ptr(), eps, _stream(x)),
           "sp_layernorm_bwd")
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
# launchers (csrc/decoder_block.cu, csrc/decoder_i8.cu)
# ---------------------------------------------------------------------------

# The conv frame of csrc/decoder_conv.cuh: output tiles of two rows of
# DEC_TC pixels times the DEC_CM output channels, walked by a persistent grid.
DEC_TC = 128
DEC_CM = 64
# The int8 conv1 (csrc/decoder_i8.cu polyconv1_i8_kernel): tiles of two
# cell rows of POLY1_TC cells times POLY1_NT of the 4 Cm composed columns,
# on POLY1_CIN input channels (one 128-byte row of codes a cell).
POLY1_TC = 64
POLY1_NT = 128
POLY1_CIN = 128


class DecPlan(NamedTuple):
    """Launch plan of a persistent decoder kernel: ``tiles`` work tiles
    walked by ``grid`` blocks, block b taking tiles b, b + grid, ... (for the
    int8 conv1, block b the tiles b // halves, b // halves + grid // halves,
    ... of column half b % halves)."""
    tiles: int
    grid: int
    halves: int = 1


def dec_conv_plan(b: int, h: int, w: int, sms: int, strip: bool = False) -> DecPlan:
    """The frame's plan on the 2S grid [h, w] of ``b`` images: two output
    rows x DEC_TC pixels a tile (``strip``: one strip row a tile, the four
    strips of an image)."""
    tiles = b * (4 if strip else h // 2) * -(-w // DEC_TC)
    return DecPlan(tiles, max(1, min(tiles, sms)))


def dec_conv_tiles(b: int, h: int, w: int, strip: bool = False):
    """(image, first output row -- with ``strip`` the strip's index in
    (top, bottom, left, right) --, first output column) of each tile in
    walk order, as ``dc_tile`` decodes them."""
    per = 4 if strip else h // 2
    ct = -(-w // DEC_TC)
    for tile in range(b * per * ct):
        c, rest = tile % ct, tile // ct
        r = rest % per
        yield rest // per, (r if strip else 2 * r), c * DEC_TC


def poly1_plan(b: int, s: int, cm: int, sms: int) -> DecPlan:
    """The int8 conv1's plan: tiles of two cell rows x POLY1_TC cells of each
    half of the 4 Cm columns; the grid a multiple of the halves."""
    halves = 4 * cm // POLY1_NT
    tiles = b * (s // 2) * -(-s // POLY1_TC)
    return DecPlan(tiles, halves * max(1, min(tiles, sms // halves)), halves)


def poly1_tiles(b: int, s: int):
    """(image, first cell row, first cell) of each conv1 tile of a half."""
    ct, rows = -(-s // POLY1_TC), s // 2
    for tile in range(b * rows * ct):
        yield tile // ct // rows, 2 * ((tile // ct) % rows), (tile % ct) * POLY1_TC


def _conv_params(w, s, t, cin, cm, name):
    _need(w, f"{name} weight", ndim=2)
    _need(s, f"{name} scale", torch.float32, 1)
    _need(t, f"{name} shift", torch.float32, 1)
    if tuple(w.shape) != (9 * cin, cm) or s.numel() != cm or t.numel() != cm:
        raise ValueError(f"{name}: weight {tuple(w.shape)} vs [9*{cin}, {cm}]")


def _dec_weight(w: torch.Tensor, cin: int, name: str, dtype=torch.bfloat16) -> None:
    _need(w, f"{name} weight", dtype, 2)
    if tuple(w.shape) != (DEC_CM, 9 * cin):
        raise ValueError(f"{name}: weight {tuple(w.shape)} vs [{DEC_CM}, 9*{cin}]")


def _dec_input(x: torch.Tensor, name: str, dtype=torch.bfloat16) -> Tuple[int, int, int]:
    """(B, S, Cin) of a square x [B, S, S, Cin] the conv1 kernels take:
    Cin 64 or 128 (the weights stay in shared memory, in 128-byte rows)."""
    _need(x, f"{name} x", dtype, 4)
    b, s, s_, cin = x.shape
    if s != s_ or cin not in (64, 128):
        raise ValueError(f"{name}: x {tuple(x.shape)} (square, Cin 64 or 128)")
    return b, s, cin


def dec_upconv(x: torch.Tensor, wt: torch.Tensor, s: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Decoder block 2's conv1: x [B, S, S, Cin] bf16, wt [64, 9*Cin] (rows
    the output channels, columns (dy, dx, ci)) -> relu(conv3x3(up2x(x)) * s
    + t), [B, 2S, 2S, 64]."""
    b, h, cin = _dec_input(x, "dec_upconv")
    _dec_weight(wt, cin, "dec_upconv")
    _f32(s, DEC_CM, "dec_upconv scale")
    _f32(t, DEC_CM, "dec_upconv shift")
    y = torch.empty((b, 2 * h, 2 * h, DEC_CM), dtype=x.dtype, device=x.device)
    plan = dec_conv_plan(b, 2 * h, 2 * h, _sm_count(x.get_device()))
    _check(load().sp_dec_upconv(x.data_ptr(), wt.data_ptr(), s.data_ptr(), t.data_ptr(),
                                y.data_ptr(), b, h, cin, plan.grid, _stream(x)),
           "sp_dec_upconv")
    return y


def dec_conv_head(y: torch.Tensor, wt: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                  head_w: torch.Tensor, head_b: torch.Tensor) -> torch.Tensor:
    """Decoder block 2's conv2 and head: y [B, H, W, 64] bf16 (H even), wt
    [64, 576] -> relu(conv3x3(y) * s + t) . head_w + head_b, [B, H, W]."""
    _need(y, "dec_conv_head y", ndim=4)
    b, h, w_, c = y.shape
    if c != DEC_CM or h % 2:
        raise ValueError(f"dec_conv_head: y {tuple(y.shape)} (64 channels, even height)")
    _dec_weight(wt, c, "dec_conv_head")
    for v, n, name in ((s, DEC_CM, "scale"), (t, DEC_CM, "shift"), (head_w, DEC_CM, "head weight"),
                       (head_b, 1, "head bias")):
        _f32(v, n, f"dec_conv_head {name}")
    pred = torch.empty((b, h, w_), dtype=y.dtype, device=y.device)
    plan = dec_conv_plan(b, h, w_, _sm_count(y.get_device()))
    _check(load().sp_dec_conv_head(y.data_ptr(), wt.data_ptr(), s.data_ptr(), t.data_ptr(),
                                   head_w.data_ptr(), head_b.data_ptr(), pred.data_ptr(), b, h,
                                   w_, plan.grid, _stream(y)), "sp_dec_conv_head")
    return pred


# The Cm 128 form of the conv frame (csrc/decoder_block.cu dec128_kernel,
# the edge branch): tiles of two rows of DEC128_TCS pixels times all
# DEC128_CM outputs, the weights streamed a chunk of DEC128_KC input
# channels a stage, packed as the stage holds them.
DEC128_TCS = (128, 96)
DEC128_CM = 128
DEC128_KC = 16


class Dec128Plan(NamedTuple):
    """Launch plan of the Cm 128 conv kernel: tiles of two rows x ``tc``
    pixels, ``tiles`` of them walked by ``grid`` blocks (block b the tiles
    b, b + grid, ...), the tile walk as :func:`dec128_tiles` lists it."""
    tc: int
    tiles: int
    grid: int


def dec128_plan(b: int, h: int, w: int, sms: int) -> Dec128Plan:
    """The tile width of DEC128_TCS that computes the fewest columns of the
    width ``w`` (the wider on a tie), on the [h, w] output grid of ``b``
    images."""
    tc = min(DEC128_TCS, key=lambda c: (-(-w // c) * c, -c))
    tiles = b * (h // 2) * -(-w // tc)
    return Dec128Plan(tc, tiles, max(1, min(tiles, sms)))


def dec128_tiles(b: int, h: int, w: int, tc: int):
    """(image, first output row, first output column) of each tile in walk
    order, as ``dec128_kernel``'s ``tile_of`` decodes them."""
    ct = -(-w // tc)
    for tile in range(b * (h // 2) * ct):
        rest = tile // ct
        yield rest // (h // 2), 2 * (rest % (h // 2)), (tile % ct) * tc


def pack_dec128(w: torch.Tensor) -> torch.Tensor:
    """[128, Cin, 3, 3] conv weights -> [Cin / 16, 9, 2, 128, 8]: per chunk of
    16 input channels, per tap (dy, dx), its two planes of 8 channels, each
    [output channel][8 inputs] -- the weights of one ring stage of the Cm
    128 kernel, in the order it holds them."""
    cm, cin = w.shape[:2]
    if cm != DEC128_CM or cin % DEC128_KC or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"pack_dec128: weight {tuple(w.shape)} vs [128, Cin % 16 == 0, 3, 3]")
    return (w.permute(2, 3, 1, 0).reshape(9, cin // 16, 2, 8, cm)
            .permute(1, 0, 2, 4, 3).contiguous())


def _dec128_weight(w: torch.Tensor, cin: int, name: str) -> None:
    _need(w, f"{name} weight", ndim=5)
    if tuple(w.shape) != (cin // DEC128_KC, 9, 2, DEC128_CM, 8):
        raise ValueError(f"{name}: weight {tuple(w.shape)} vs pack_dec128's for Cin {cin}")


def upsample_conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                             t: torch.Tensor, ef: torch.Tensor,
                             we: torch.Tensor) -> torch.Tensor:
    """The edge branch's conv1: x [B, S, S, Cin], edge features ef [B, S/2,
    S/2, Ce], weights w and we packed by :func:`pack_dec128` ->
    relu((conv3x3(up2x(x)) + conv3x3(up4x(ef))) * s + t), [B, 2S, 2S, 128]."""
    _need(x, "upconv x", ndim=4)
    b, h, w_, cin = x.shape
    if h != w_ or cin % DEC128_KC or h % 2:
        raise ValueError(f"upconv: x {tuple(x.shape)} (square, even, Cin % 16 == 0)")
    _need(ef, "upconv edge features", ndim=4)
    ce = ef.shape[-1]
    if tuple(ef.shape) != (b, h // 2, h // 2, ce) or ce % DEC128_KC or ce < DEC128_KC:
        raise ValueError(f"upconv: ef {tuple(ef.shape)} vs x {tuple(x.shape)} "
                         "(half the side, Ce % 16 == 0)")
    _dec128_weight(w, cin, "upconv")
    _dec128_weight(we, ce, "upconv edge")
    _f32(s, DEC128_CM, "upconv scale")
    _f32(t, DEC128_CM, "upconv shift")
    y = torch.empty((b, 2 * h, 2 * h, DEC128_CM), dtype=x.dtype, device=x.device)
    plan = dec128_plan(b, 2 * h, 2 * h, _sm_count(x.get_device()))
    _check(load().sp_upconv3x3_edge_bn_relu(x.data_ptr(), w.data_ptr(), ef.data_ptr(),
                                             we.data_ptr(), s.data_ptr(), t.data_ptr(),
                                             y.data_ptr(), b, h, cin, ce, plan.tc, plan.grid,
                                             _stream(x)),
           "sp_upconv3x3_edge_bn_relu")
    return y


def _dec128_y(y: torch.Tensor, w: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
              name: str) -> Tuple[int, int, int]:
    _need(y, f"{name} y", ndim=4)
    b, h, w_, c = y.shape
    if c != DEC128_CM or h % 2:
        raise ValueError(f"{name}: y {tuple(y.shape)} (128 channels, even height)")
    _dec128_weight(w, c, name)
    _f32(s, DEC128_CM, f"{name} scale")
    _f32(t, DEC128_CM, f"{name} shift")
    return b, h, w_


def conv3x3_bn_relu_head(y: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                         t: torch.Tensor, head_w: torch.Tensor,
                         head_b: torch.Tensor) -> torch.Tensor:
    """y [B, H, W, 128] (H even), w packed by :func:`pack_dec128` ->
    relu(conv3x3(y) * s + t) . head_w + head_b, [B, H, W] (the edge
    branch's block with a head; Cm 64 is :func:`dec_conv_head`)."""
    b, h, w_ = _dec128_y(y, w, s, t, "conv_head")
    _f32(head_w, DEC128_CM, "conv_head head weight")
    _f32(head_b, 1, "conv_head head bias")
    pred = torch.empty((b, h, w_), dtype=y.dtype, device=y.device)
    plan = dec128_plan(b, h, w_, _sm_count(y.get_device()))
    _check(load().sp_conv3x3_bn_relu_head(
        y.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
        head_w.data_ptr(), head_b.data_ptr(), pred.data_ptr(), b, h, w_, plan.tc, plan.grid,
        _stream(y)), "sp_conv3x3_bn_relu_head")
    return pred


def conv3x3_bn_relu(y: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """y [B, H, W, 128] (H even), w packed by :func:`pack_dec128` ->
    relu(conv3x3(y) * s + t), [B, H, W, 128]."""
    b, h, w_ = _dec128_y(y, w, s, t, "conv")
    out = torch.empty_like(y)
    plan = dec128_plan(b, h, w_, _sm_count(y.get_device()))
    _check(load().sp_conv3x3_bn_relu(y.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
                                      out.data_ptr(), b, h, w_, plan.tc, plan.grid, _stream(y)),
           "sp_conv3x3_bn_relu")
    return out


def _f32(t: torch.Tensor, n: int, name: str) -> None:
    _need(t, name, torch.float32, 1)
    if t.numel() != n:
        raise ValueError(f"{name}: length {t.numel()} != {n}")


def _images(b: int, name: str) -> None:
    """The per-image quant kernels put the image index on a grid axis whose
    limit is 65535."""
    if b > 65535:
        raise ValueError(f"{name}: batch {b} > 65535 (the CUDA grid's y / z limit)")


def quant_image_i8(x: torch.Tensor):
    """x [B, S, S, Cin] bf16 -> (int8 codes [B, S + 2, S + 2, Cin] with the
    border replicated -- the codes are ``[:, 1:-1, 1:-1]`` --, f32 scales
    [B]): one symmetric scale per image, codes round(x / s) by a true
    division."""
    b = x.shape[0]
    _images(b, "quant_image_i8")
    _need(x, "quant_image_i8 x", ndim=4)
    _, s, s_, cin = x.shape
    if s != s_ or s < 2 or cin % 8:
        raise ValueError(f"quant_image_i8: x {tuple(x.shape)} (square, Cin a multiple of 8)")
    q = torch.empty((b, s + 2, s + 2, cin), dtype=torch.int8, device=x.device)
    sx = torch.empty((b,), dtype=torch.float32, device=x.device)
    amax = torch.empty_like(sx)
    _check(load().sp_quant_image_i8(x.data_ptr(), q.data_ptr(), sx.data_ptr(),
                                     amax.data_ptr(), b, s, cin, _stream(x)), "sp_quant_image_i8")
    return q, sx


def dec_strips(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The int8 decoder's border strips: the outermost rows and columns of
    conv3x3(up2x(x)) for x [B, S, S, Cin] bf16 and conv1's weights wt [64,
    9*Cin] (columns (dy, dx, ci)), the sample built as
    ops/fused_upsample_conv.border_strips builds it -> [4, B, 2S, 64] bf16
    (top, bottom, left, right), before conv1's bias and BN."""
    b, s, cin = _dec_input(x, "dec_strips")
    _dec_weight(wt, cin, "dec_strips")
    out = torch.empty((4, b, 2 * s, DEC_CM), dtype=x.dtype, device=x.device)
    plan = dec_conv_plan(b, 2 * s, 2 * s, _sm_count(x.get_device()), strip=True)
    _check(load().sp_dec_strips(x.data_ptr(), wt.data_ptr(), out.data_ptr(), b, s, cin,
                                plan.grid, _stream(x)), "sp_dec_strips")
    return out


def polyconv1_i8(xq: torch.Tensor, sx: torch.Tensor, w1t: torch.Tensor, sw1: torch.Tensor,
                 s1: torch.Tensor, t1: torch.Tensor, strips: torch.Tensor, sh: int):
    """The int8 decoder's conv1 in the polyphase form with the border paste:
    xq [B, S + 2, S + 2, Cin] int8 (:func:`quant_image_i8`'s codes with
    their replicated border; Cin 128, scales sx [B]), w1t [4*Cm, 9*Cin]
    int8 (scales sw1 [4*Cm]), conv1's BN s1, t1 [Cm], the raw strips [4, B,
    2S, Cm] bf16 (activated by s1, t1 as they are pasted) -> (y1 [B, 2S, 2S,
    Cm] bf16, f32 [B, S / sh] maxima of each strip of ``sh`` cell rows with
    one cell row of halo, and of the unpasted rows 0 and 2S-1 in the first
    and last strip: conv2's activation maxima)."""
    _need(xq, "polyconv1_i8 x", torch.int8, 4)
    _need(w1t, "polyconv1_i8 weight", torch.int8, 2)
    _need(strips, "polyconv1_i8 strips", ndim=4)
    b, s, s_, cin = xq.shape
    s, s_ = s - 2, s_ - 2
    n4 = w1t.shape[0]
    cm = n4 // 4
    if s != s_ or cin != POLY1_CIN or tuple(w1t.shape) != (4 * DEC_CM, 9 * cin):
        raise ValueError(f"polyconv1_i8: x {tuple(xq.shape)}, weight {tuple(w1t.shape)} "
                         f"(square, Cin {POLY1_CIN}, Cm {DEC_CM})")
    if s % sh or s % 2:
        raise ValueError(f"polyconv1_i8: S {s} vs strip height {sh}")
    if tuple(strips.shape) != (4, b, 2 * s, cm):
        raise ValueError(f"polyconv1_i8: strips {tuple(strips.shape)}")
    _f32(sx, b, "polyconv1_i8 sx")
    _f32(sw1, n4, "polyconv1_i8 sw1")
    _f32(s1, cm, "polyconv1_i8 s1")
    _f32(t1, cm, "polyconv1_i8 t1")
    y1 = torch.empty((b, 2 * s, 2 * s, cm), dtype=torch.bfloat16, device=xq.device)
    amax = torch.empty((b, s // sh), dtype=torch.float32, device=xq.device)
    plan = poly1_plan(b, s, cm, _sm_count(xq.get_device()))
    _check(load().sp_polyconv1_i8(xq.data_ptr(), sx.data_ptr(), w1t.data_ptr(), sw1.data_ptr(),
                                   s1.data_ptr(), t1.data_ptr(), strips.data_ptr(),
                                   y1.data_ptr(), amax.data_ptr(), b, s, cin, sh, plan.grid,
                                   _stream(xq)),
           "sp_polyconv1_i8")
    return y1, amax


def conv2_i8_head(y1: torch.Tensor, sh: int, w2q: torch.Tensor, sw2: torch.Tensor,
                  t2: torch.Tensor, hw: torch.Tensor, hb: torch.Tensor, *,
                  sa: Optional[torch.Tensor] = None, amax: Optional[torch.Tensor] = None,
                  y2: Optional[torch.Tensor] = None):
    """The int8 decoder's conv2 and head: y1 [B, 2S, 2S, 64] bf16 coded with
    its strip's scale -- ``sa`` [B, S / sh] as given, or that of the maxima
    ``amax`` (:func:`polyconv1_i8`), max(amax * f32(1/127), 1e-12) --, w2q
    [64, 576] int8 (columns (dy, dx, ci), scales sw2 [64]), t2, hw [64], hb
    [1] f32 -> (pred [B, 2S, 2S] bf16, the strip scales).  Given ``y2``
    (bf16, y1's shape), conv2's activated output is stored there too."""
    _need(y1, "conv2_i8 y1", ndim=4)
    _need(w2q, "conv2_i8 weight", torch.int8, 2)
    b, s2, s2_, cm = y1.shape
    if y2 is not None:
        _need(y2, "conv2_i8 y2", ndim=4)
        if y2.shape != y1.shape:
            raise ValueError(f"conv2_i8: y2 {tuple(y2.shape)} != y1 {tuple(y1.shape)}")
    if s2 != s2_ or cm != DEC_CM or tuple(w2q.shape) != (64, 576) or s2 % (2 * sh):
        raise ValueError(f"conv2_i8: y1 {tuple(y1.shape)}, weight {tuple(w2q.shape)}, "
                         f"sh {sh} (Cm 64)")
    if (sa is None) == (amax is None):
        raise ValueError("conv2_i8: give the strip scales or the strip maxima")
    given = sa if sa is not None else amax
    _need(given, "conv2_i8 strip scales", torch.float32, 2)
    if tuple(given.shape) != (b, s2 // (2 * sh)):
        raise ValueError(f"conv2_i8: strip scales {tuple(given.shape)}")
    for v, n, name in ((sw2, 64, "sw2"), (t2, 64, "t2"), (hw, 64, "head weight"),
                       (hb, 1, "head bias")):
        _f32(v, n, f"conv2_i8 {name}")
    pred = torch.empty((b, s2, s2), dtype=torch.bfloat16, device=y1.device)
    out_sa = torch.empty_like(given) if sa is None else sa
    plan = dec_conv_plan(b, s2, s2, _sm_count(y1.get_device()))
    _check(load().sp_conv2_i8_head(y1.data_ptr(), _ptr(amax), _ptr(sa),
                                    out_sa.data_ptr() if sa is None else None,
                                    w2q.data_ptr(), sw2.data_ptr(), t2.data_ptr(), hw.data_ptr(),
                                    hb.data_ptr(), pred.data_ptr(), _ptr(y2), b, s2, sh,
                                    plan.grid, _stream(y1)),
           "sp_conv2_i8_head")
    return pred, out_sa


# ---------------------------------------------------------------------------
# launchers (csrc/int8_gemm.cu)
# ---------------------------------------------------------------------------

def _codes(rows: int, k: int, like: torch.Tensor):
    return (torch.empty((rows, k), dtype=torch.int8, device=like.device),
            torch.empty((rows,), dtype=torch.float32, device=like.device))


_ACTS = (torch.bfloat16, torch.float32)


def _act(x: torch.Tensor, name: str) -> int:
    """1 for f32 activations, 0 for bf16; raises on any other dtype."""
    if x.dtype not in _ACTS:
        raise ValueError(f"{name}: expected bf16 or f32, got {x.dtype}")
    return int(x.dtype == torch.float32)


# csrc/int8_gemm.cu's LayerNorm + quant row pass: the vectors a lane holds
# in its narrow form (bf16 rows of 8 per 16-byte vector, f32 of 4), with
# the LayerNorm weight and bias in registers, and in its wide form (longer
# rows, weight and bias read per row).
LNQ8_NV = {"bf16": 5, "f32": 9}
LNQ8_WIDE_NV = {"bf16": 16, "f32": 12}


class LnQ8Plan(NamedTuple):
    """Launch plan of the LayerNorm + quant row pass: ``lanes`` (a power of
    2, at most 32) serve a row, each holding at most ``nv`` of its 16-byte
    vectors (lane j: vectors j, j + lanes, ...); ``wide``: the form that
    reads the LayerNorm weight and bias per row."""
    lanes: int
    nv: int
    wide: bool


@functools.lru_cache(maxsize=64)
def layernorm_q8_plan(c: int, f32: bool) -> LnQ8Plan:
    """The fewest lanes that hold a row of ``c`` (a multiple of 8) in the
    narrow form's vectors per lane, else in the wide form's; rows past 32
    wide-form vectors a lane (4096 bf16, 1536 f32 values) raise."""
    vec, dt = (4, "f32") if f32 else (8, "bf16")
    if c < 1 or c % 8:
        raise ValueError(f"layernorm_q8: C={c} must be a positive multiple of 8")
    nvec = c // vec
    for nv, wide in ((LNQ8_NV[dt], False), (LNQ8_WIDE_NV[dt], True)):
        for lg in range(6):
            if -(-nvec // (1 << lg)) <= nv:
                return LnQ8Plan(1 << lg, nv, wide)
    raise ValueError(f"layernorm_q8: C={c} is past {32 * LNQ8_WIDE_NV[dt] * vec}, the longest "
                     f"{dt} row a group of 32 lanes holds")


def layernorm_q8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """[rows, C] bf16 or f32 -> LayerNorm (f32 weight/bias, rounded to x's
    dtype) -> (int8 codes [rows, C], f32 row scales [rows]): one pass over
    each row in registers (:func:`layernorm_q8_plan`)."""
    f32 = _act(x, "layernorm_q8 x")
    _need(x, "layernorm_q8 x", x.dtype, 2)
    _need(w, "layernorm_q8 weight", torch.float32, 1)
    _need(b, "layernorm_q8 bias", torch.float32, 1)
    rows, c = x.shape
    if w.numel() != c or b.numel() != c or c % 8:
        raise ValueError(f"layernorm_q8: weight {tuple(w.shape)} vs C={c} (C % 8 == 0)")
    if x.data_ptr() % 16 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("layernorm_q8: 16-byte loads need 16-byte aligned operands")
    plan = layernorm_q8_plan(c, bool(f32))
    q, s = _codes(rows, c, x)
    _check(load().sp_layernorm_q8(x.data_ptr(), w.data_ptr(), b.data_ptr(), q.data_ptr(),
                                   s.data_ptr(), rows, c, eps, f32,
                                   plan.lanes.bit_length() - 1, plan.nv, _stream(x)),
           "sp_layernorm_q8")
    return q, s


def quant_rows(x: torch.Tensor):
    """[rows, K] bf16 or f32 -> (int8 codes [rows, K], f32 row scales [rows])."""
    f32 = _act(x, "quant_rows x")
    _need(x, "quant_rows x", x.dtype, 2)
    rows, k = x.shape
    if k % 8:
        raise ValueError(f"quant_rows: K={k} must be a multiple of 8")
    q, s = _codes(rows, k, x)
    _check(load().sp_quant_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, k, f32,
                                 _stream(x)), "sp_quant_rows")
    return q, s


def gemm_i8(a: torch.Tensor, sa: torch.Tensor, w: torch.Tensor, sw: torch.Tensor,
            bias: torch.Tensor, residual=None, gelu: bool = False,
            sw_first: bool = True, out_dtype: torch.dtype = torch.bfloat16,
            approx_gelu: bool = True) -> torch.Tensor:
    """a [M, K] int8 (row scales sa [M]) . w [N, K]^T int8 (row scales sw [N])
    -> int32, dequantized (acc * sw * sa with ``sw_first``, else acc * sa *
    sw) + bias [N] f32 (-> GELU: tanh with ``approx_gelu``, else erf, which
    needs an f32 output) -> ``out_dtype`` (bf16 or f32) (+ residual [M, N] of
    that dtype).  The persistent TMA + wgmma GEMM on s8 operands
    (csrc/int8_gemm.cu, :func:`gemm_plan`); int32 sums are exact, so the
    result is the plain version's (:func:`ops.fused_block_t_i8.qdot`) bit for
    bit, GELU aside."""
    _need(a, "gemm_i8 a", torch.int8, 2)
    _need(w, "gemm_i8 weight", torch.int8, 2)
    if out_dtype not in _ACTS:
        raise ValueError(f"gemm_i8: output dtype {out_dtype} (bf16 or f32)")
    if gelu and not approx_gelu and out_dtype != torch.float32:
        raise ValueError("gemm_i8: the erf GELU epilogue writes f32")
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k or k % 32 or n % 8:
        raise ValueError(f"gemm_i8: a {tuple(a.shape)} vs weight {tuple(w.shape)} "
                         "(K % 32 == 0, N % 8 == 0)")
    plan = gemm_plan(m, n, k, _sm_count(a.device.index),
                     "int8_f32" if out_dtype == torch.float32 else "int8")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gemm_i8: TMA needs 16-byte aligned operands")
    for t, name, size in ((sa, "row scales", m), (sw, "weight scales", n), (bias, "bias", n)):
        _need(t, f"gemm_i8 {name}", torch.float32, 1)
        if t.numel() != size:
            raise ValueError(f"gemm_i8: {name} length {t.numel()} != {size}")
    if residual is not None:
        _need(residual, "gemm_i8 residual", out_dtype, 2)
        if tuple(residual.shape) != (m, n):
            raise ValueError("gemm_i8: residual shape != [M, N]")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    act = (1 if approx_gelu else 2) if gelu else 0
    _check(load().sp_gemm_i8(a.data_ptr(), sa.data_ptr(), w.data_ptr(), sw.data_ptr(),
                              bias.data_ptr(), _ptr(residual), c.data_ptr(), m, n, k,
                              act, int(sw_first), int(out_dtype == torch.float32), plan.bn,
                              plan.grid, _stream(a)), "sp_gemm_i8")
    return c


# ---------------------------------------------------------------------------
# launchers (csrc/attention_lanes.cu)
# ---------------------------------------------------------------------------

# The largest head dim the attention kernels take (the gate of
# ops/pallas_attention.fused_attention, ``is_supported``, admits up to it; the
# lanes gate, as JAX's, does not look at the head dim, so a wider head
# reaches :func:`attention_head_dim` and is refused there).
MAX_HEAD_DIM = 256
# Widths of the bf16 kernel's P.V product (csrc/attention_lanes.cu
# instantiations): the head dim, padded to a multiple of 8, rounds up to one.
ATTN_DV = (16, 32, 48, 64, 72, 80, 96, 128, 144, 192, 256)
_AW_ROWS = 64   # rows of a box, of an m-tile (query rows) and of a key tile


def attention_head_dim(d: int, dtype: torch.dtype) -> int:
    """The shape rule of the attention kernels: head dim ``d`` runs as the
    next multiple of 8 (bf16) or 4 (f32), the 16-byte vector of each; any
    1 <= d <= :data:`MAX_HEAD_DIM` is taken, a wider one raises."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head_dim {d}; the kernels take 1 <= head_dim <= "
                         f"{MAX_HEAD_DIM}")
    vec = 4 if dtype == torch.float32 else 8
    return -(-d // vec) * vec


class AttnPlan(NamedTuple):
    """Launch plan of the bf16 attention kernel: ``dv`` the P.V width,
    ``solo`` one (problem, head) per consumer warpgroup (L <= 64) instead of
    2 * ``mt`` 64-row m-tiles of one (problem, head) per item (``mt`` 1 or
    2, :func:`attention_plan`), ``items`` the work items, ``grid`` the
    persistent blocks that stride over them."""
    dv: int
    solo: bool
    mt: int
    items: int
    grid: int


@functools.lru_cache(maxsize=256)
def attention_plan(problems: int, heads: int, l: int, d: int, sms: int,
                   mt: Optional[int] = None) -> AttnPlan:
    """The work list of csrc/attention_lanes.cu for [problems, L, heads, d]
    (d already a multiple of 8) on a card of ``sms`` SMs: about one block
    per SM (fewer when there are fewer items).  ``mt`` (m-tiles per
    consumer) by default: 2 up to a P.V width of 80 where 256-row items take
    fewer rounds of the grid's blocks than 128-row ones, a round of 256-row
    items counted 1.8 rounds of 128-row ones (their K/V loads are shared;
    utils/attention_bench.py on an H100 at L 1024 and 4096, where both fill
    their last round alike)."""
    dv = next(x for x in ATTN_DV if x >= d)
    solo = l <= _AW_ROWS

    def n_items(m):
        return (-(-problems * heads // 2) if solo
                else problems * heads * -(-l // (2 * m * _AW_ROWS)))

    if mt is None:
        mt = 1
        if not solo and dv <= 80:
            rounds = {m: -(-n_items(m) // sms) for m in (1, 2)}
            mt = 2 if 1.8 * rounds[2] < rounds[1] else 1
    if mt not in (1, 2) or (mt == 2 and (solo or dv > 80)):
        raise ValueError(f"attention: {mt} m-tiles at L {l}, P.V width {dv}")
    items = n_items(mt)
    if items >= 2 ** 31:
        raise ValueError(f"attention: {items} work items (at most 2^31 - 1)")
    return AttnPlan(dv, solo, mt, items, min(items, sms))


# Widths of the f32 kernel's P.V product (csrc/attention_f32.cu
# attention_tf32_kernel instantiations); a wider head dim runs
# attention_f32_kernel (3xTF32 on mma.sync).
ATTN_F32_DV = (16, 32, 48, 64, 72, 80)
_TF_KT = 32     # keys of the f32 kernel's K / V tile


class F32Plan(NamedTuple):
    """Launch plan of csrc/attention_f32.cu's ``attention_tf32_kernel``:
    ``dv`` the P.V width; ``solo`` (L <= 64) one group of problems per
    consumer warpgroup instead of 128 query rows of one (problem, head) per
    item; ``lg`` log2 L where windows of L dividing 32 are packed 64 / L to an
    m-tile (-1 otherwise); ``items`` the work items, ``grid`` the
    persistent blocks that stride over them."""
    dv: int
    solo: bool
    lg: int
    items: int
    grid: int

    @property
    def pb(self) -> int:
        """Problems per consumer in solo mode."""
        return 64 >> self.lg if self.lg >= 0 else 1

    def key_tiles(self, l: int) -> int:
        """32-key tiles a consumer reads per item."""
        return 2 if self.lg >= 0 else -(-l // _TF_KT)


@functools.lru_cache(maxsize=256)
def attention_f32_plan(problems: int, heads: int, l: int, d: int,
                       sms: int) -> Optional[F32Plan]:
    """The work list of ``attention_tf32_kernel`` for [problems, L, heads, d]
    f32 (d a multiple of 4) on a card of ``sms`` SMs, about one block per
    SM; None where d is wider than its widest P.V product (attention_f32_kernel
    takes it)."""
    dv = next((x for x in ATTN_F32_DV if x >= d), None)
    if dv is None:
        return None
    solo = l <= _AW_ROWS
    lg = l.bit_length() - 1 if solo and _TF_KT % l == 0 else -1
    plan = F32Plan(dv, solo, lg, 0, 0)
    if solo:    # a group of plan.pb problems and one head per consumer
        items = -(-(-(-problems // plan.pb) * heads) // 2)
    else:       # 128 query rows of one (problem, head)
        items = problems * heads * -(-l // (2 * _AW_ROWS))
    if items >= 2 ** 31:
        raise ValueError(f"attention: {items} work items (at most 2^31 - 1)")
    return plan._replace(items=items, grid=min(items, sms))


def _view_strides(t: torch.Tensor, name: str):
    """(problem, token, head) element strides of a [P, L, H, D] bf16 or f32
    view with D contiguous, 16-byte aligned, each stride a multiple of 16
    bytes where its dim is longer than 1; a dim of extent 1 (never stepped)
    reports one 16-byte vector.  The bf16 kernel's tensor maps take them as
    byte strides of a head, a token and a problem, over dims (D, H, L, P),
    which TMA needs to be multiples of 16."""
    vec = 16 // t.element_size()
    st, shape = t.stride(), t.shape
    out = tuple(st[i] if shape[i] > 1 else vec for i in range(3))
    if st[3] != 1 or t.data_ptr() % 16 or out[0] % vec or out[1] % vec or out[2] % vec:
        raise ValueError(f"{name}: strides {st} need D contiguous, 16-byte "
                         f"alignment and the other strides multiples of {vec}")
    return out


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v of every (problem, head) over its L tokens:
    q / k / v [P, L, H, D] views -> contiguous [P, L, H, D] (any L >= 1,
    head dims by :func:`attention_head_dim`).  bf16: csrc/attention_lanes.cu
    (TMA + wgmma, :func:`attention_plan`); f32: csrc/attention_f32.cu (TMA +
    3xTF32 wgmma, :func:`attention_f32_plan`, up to head dim 80; its
    mma.sync kernel above it).  A
    head dim that is not a multiple of the kernel's vector is zero-padded to
    one (one pad of the stacked q / k / v) and the output sliced back."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda" or t.dtype not in _ACTS or t.dim() != 4:
            raise ValueError(f"attention {name}: expected a bf16 or f32 CUDA [P, L, H, D] "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} differ")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: q {q.dtype}, k {k.dtype}, v {v.dtype} differ")
    p, l, h, d = q.shape
    dp = attention_head_dim(d, q.dtype)
    if dp != d:
        q, k, v = torch.nn.functional.pad(torch.stack((q, k, v)), (0, dp - d)).unbind(0)
    qs, ks, vs = (_view_strides(q, "attention q"), _view_strides(k, "attention k"),
                  _view_strides(v, "attention v"))
    if l < 1 or h > 65535 or p * -(-l // 64) >= 2 ** 31:
        raise ValueError(f"attention: [P, L, H, D] = {tuple(q.shape)}")
    out = torch.empty((p, l, h, dp), dtype=q.dtype, device=q.device)
    fplan = (attention_f32_plan(p, h, l, dp, _sm_count(q.device.index))
             if q.dtype == torch.float32 else None)
    if fplan is not None:
        _check(load().sp_attention_tf32(q.data_ptr(), *qs, k.data_ptr(), *ks, v.data_ptr(),
                                         *vs, out.data_ptr(), l * h * dp, h * dp, dp, p, h, l,
                                         dp, fplan.dv, fplan.items, int(fplan.solo), fplan.lg,
                                         fplan.grid, scale, _stream(q)), "attention")
    elif q.dtype == torch.float32:
        _check(load().sp_attention_f32(q.data_ptr(), *qs, k.data_ptr(), *ks, v.data_ptr(),
                                        *vs, out.data_ptr(), l * h * dp, h * dp, dp, p, h, l,
                                        dp, scale, _stream(q)), "attention")
    else:
        plan = attention_plan(p, h, l, dp, _sm_count(q.device.index))
        _check(load().sp_lanes_attention(q.data_ptr(), *qs, k.data_ptr(), *ks, v.data_ptr(),
                                          *vs, out.data_ptr(), l * h * dp, h * dp, dp, p, h, l,
                                          dp, plan.dv, plan.items, int(plan.solo), plan.mt,
                                          plan.grid, scale, _stream(q)), "attention")
    return out if dp == d else out[..., :d].contiguous()


# ---------------------------------------------------------------------------
# launchers (csrc/block_f32.cu)
# ---------------------------------------------------------------------------

def layernorm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """[rows, C] f32 -> LayerNorm over C with f32 weight/bias, f32 out."""
    _need(x, "layernorm_f32 x", torch.float32, 2)
    _need(w, "layernorm_f32 weight", torch.float32, 1)
    _need(b, "layernorm_f32 bias", torch.float32, 1)
    rows, c = x.shape
    if w.numel() != c or b.numel() != c or c % 4:
        raise ValueError(f"layernorm_f32: weight {tuple(w.shape)} vs C={c} (C % 4 == 0)")
    if x.data_ptr() % 16 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("layernorm_f32: float4 loads need 16-byte aligned operands")
    y = torch.empty_like(x)
    _check(load().sp_layernorm_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                    rows, c, eps, _stream(x)), "sp_layernorm_f32")
    return y


_GELU_F32 = {None: 0, "erf": 1, "tanh": 2}


def gemm_f32(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
             gelu: Optional[str] = None) -> torch.Tensor:
    """a [M, K] @ w [N, K]^T (+ bias) (-> GELU, "erf" or "tanh") (+ residual),
    f32, products 3xTF32: the persistent TMA + wgmma GEMM in its 3xTF32 form
    (csrc/gemm_persistent.cuh, csrc/block_f32.cu), planned by
    :func:`gemm_plan` ("f32")."""
    _need(a, "gemm_f32 a", torch.float32, 2)
    _need(w, "gemm_f32 weight", torch.float32, 2)
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k or k % 4 or n % 4:
        raise ValueError(f"gemm_f32: a {tuple(a.shape)} vs weight {tuple(w.shape)} "
                         "(K % 4 == 0, N % 4 == 0)")
    if gelu not in _GELU_F32:
        raise ValueError(f"gemm_f32: gelu {gelu!r} (None, 'erf' or 'tanh')")
    plan = gemm_plan(m, n, k, _sm_count(a.device.index), "f32", residual is not None)
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gemm_f32: TMA needs 16-byte aligned operands")
    if bias is not None:
        _need(bias, "gemm_f32 bias", torch.float32, 1)
        if bias.numel() != n:
            raise ValueError("gemm_f32: bias length != N")
    if residual is not None:
        _need(residual, "gemm_f32 residual", torch.float32, 2)
        if tuple(residual.shape) != (m, n) or residual.data_ptr() % 16:
            raise ValueError("gemm_f32: residual shape != [M, N] or not 16-byte aligned")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _check(load().sp_gemm_f32(a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(residual),
                               c.data_ptr(), m, n, k, _GELU_F32[gelu], plan.bn, plan.grid,
                               _stream(a)), "sp_gemm_f32")
    return c
