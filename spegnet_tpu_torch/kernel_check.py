"""Main-path kernel geometries and kernel-vs-plain comparisons.

Every geometry below is one that bf16 SPEGNet inference with the Hiera-L
trunk at 512^2 hands a kernel wrapper, per image.  A case builds seeded
random inputs and weights on a device and returns the wrapper's call and
its plain PyTorch version on the same inputs; :func:`compare` runs both and
reports the error, :func:`time_ms` times a call with CUDA events.  Used by
the CUDA-only tests and by chip_smoke.py.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from spegnet_tpu_torch.ops import fused_block as fb
from spegnet_tpu_torch.ops import fused_block_t as fbt
from spegnet_tpu_torch.ops import fused_decoder as fd

# name: (wrapper, C, heads, window tokens L, tokens per image); stage 4 runs
# the gen-1 entry (fused_block), the rest fused_block_t.
BLOCKS = {
    "stage1": ("fused_block_t", 144, 2, 64, 16384),
    "stage2": ("fused_block_t", 288, 4, 16, 4096),
    "stage3": ("fused_block_t", 576, 8, 256, 1024),
    "global": ("fused_block_t", 576, 8, 1024, 1024),
    "stage4": ("fused_block", 1152, 16, 64, 256),
}
# name: (Cin, Cout, heads, window tokens L at the input grid, input tokens)
QPOOL = {
    "t12": (144, 288, 4, 64, 16384),
    "t23": (288, 576, 8, 16, 4096),
    "t34": (576, 1152, 16, 256, 1024),
}
# name: (S, Cin, Cm): decoder block 2, x1 [B, S, S, Cin] -> pred [B, 2S, 2S, 1]
DECODER = {"dec2": (256, 128, 64)}

# Blocks of each geometry in one Hiera-L forward (for per-forward totals).
BLOCK_COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3,
               "t12": 1, "t23": 1, "t34": 1, "dec2": 1}

# Kernel-vs-plain limit on max|kernel - plain| / max|plain| in bf16: the two
# round at different points (GELU before vs after the bf16 cast, softmax
# normalized after vs before P.V, f32 vs bf16 BN), a few bf16 ulps (2^-8
# relative) of the largest output.
REL_LIMIT = 2e-2


class Case(NamedTuple):
    wrapper: str
    kernel: Callable[[], object]
    plain: Callable[[], object]


def _w(shape, fan_in, g, device, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g) * fan_in ** -0.5).to(device, dtype)


def _v(shape, g, device, scale=0.02, dtype=torch.bfloat16, offset=0.0):
    return (offset + scale * torch.randn(shape, generator=g)).to(device, dtype)


def block_weights(c: int, heads: int, g, device) -> fbt.BlockWeights:
    f32 = torch.float32
    return fbt.BlockWeights(
        _v((c,), g, device, 0.1, f32, 1.0), _v((c,), g, device, 0.1, f32),
        _w((3 * c, c), c, g, device), _v((3 * c,), g, device),
        _w((c, c), c, g, device), _v((c,), g, device),
        _v((c,), g, device, 0.1, f32, 1.0), _v((c,), g, device, 0.1, f32),
        _w((4 * c, c), c, g, device), _v((4 * c,), g, device),
        _w((c, 4 * c), 4 * c, g, device), _v((c,), g, device))


def block_case(name: str, batch: int, g, device) -> Case:
    wrapper, c, heads, l, n = BLOCKS[name]
    wts = block_weights(c, heads, g, device)
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    scale = (c // heads) ** -0.5
    if wrapper == "fused_block":
        xw = x.reshape(batch * n // l, l, c)
        return Case(wrapper, lambda: fb.fused_block(xw, wts, heads, scale),
                    lambda: fb.block_reference(xw, wts, heads, scale))
    return Case(wrapper, lambda: fbt.fused_block_t(x, wts, heads, l, scale),
                lambda: fbt.block_plain(x, wts, heads, l, scale))


def qpool_case(name: str, batch: int, g, device) -> Case:
    cin, cout, heads, l, n = QPOOL[name]
    f32 = torch.float32
    wts = fbt.QPoolWeights(
        _v((cin,), g, device, 0.1, f32, 1.0), _v((cin,), g, device, 0.1, f32),
        _w((3 * cout, cin), cin, g, device), _v((3 * cout,), g, device),
        _w((cout, cin), cin, g, device), _v((cout,), g, device))
    x = torch.randn((batch, n, cin), generator=g).to(device, torch.bfloat16)
    scale = (cout // heads) ** -0.5
    return Case("qpool_front", lambda: fbt.qpool_front(x, wts, heads, l, scale),
                lambda: fbt.qpool_front_plain(x, wts, heads, l, scale))


def decoder_case(name: str, batch: int, g, device) -> Case:
    return decoder_case_at(*DECODER[name], batch, g, device)


def decoder_case_at(s: int, cin: int, cm: int, batch: int, g, device) -> Case:
    """Decoder block 2 on x [batch, s, s, cin] with cm channels."""
    f32 = torch.float32

    def bn():
        return (_v((cm,), g, device, 0.2, f32, 1.0), _v((cm,), g, device, 0.1, f32),
                _v((cm,), g, device, 0.1, f32), _v((cm,), g, device, 0.2, f32, 1.0).abs(),
                1e-5)

    p = fd.DecoderParams(_w((cm, cin, 3, 3), 9 * cin, g, device), _v((cm,), g, device),
                         bn(), _w((cm, cm, 3, 3), 9 * cm, g, device), _v((cm,), g, device),
                         bn(), _w((1, cm, 1, 1), cm, g, device), _v((1,), g, device))
    x = torch.randn((batch, s, s, cin), generator=g).to(device, torch.bfloat16)
    return Case("fused_decoder_block", lambda: fd.fused_decoder_block(x, p),
                lambda: fd.decoder_block_plain(x, p))


def all_cases() -> Dict[str, Callable]:
    """geometry name -> function (name, batch, generator, device) -> Case."""
    cases = {n: block_case for n in BLOCKS}
    cases.update({n: qpool_case for n in QPOOL})
    cases.update({n: decoder_case for n in DECODER})
    return cases


def compare(case: Case) -> Tuple[float, float]:
    """(max abs error, max abs error / max |plain|) of kernel vs plain."""
    got, want = case.kernel(), case.plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = ref = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs plain {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        err = max(err, (a.float() - b.float()).abs().max().item())
        ref = max(ref, b.float().abs().max().item())
    return err, err / max(ref, 1e-12)


def time_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call on the current CUDA stream (events around `iters`
    back-to-back calls, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
