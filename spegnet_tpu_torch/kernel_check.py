"""Main-path kernel geometries and kernel-vs-plain comparisons.

Every geometry below is one that bf16 SPEGNet inference or training with
the Hiera-L trunk at 512^2 hands a kernel wrapper, per image.  A case
builds seeded random inputs and weights on a device and returns the
wrapper's call and its plain PyTorch version on the same inputs;
:func:`compare` runs both and reports the error, :func:`time_ms` times a
call with CUDA events.  A gradient case (:func:`grad_case`) does the same
for the backward: gradients of the input and of every weight through the
kernel path (the wrappers' autograd Functions) and through autograd of the
plain version, plus the two backward passes alone for timing.
:func:`work` counts each call's FLOPs and bytes for its roofline bound.
Used by the CUDA-only tests and by chip_smoke.py.
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
# Kernel backward vs bf16 autograd of the plain version, same measure: the
# two round their bf16 intermediates (dS, dqkv, dh) at different points and
# sum f32 weight gradients in different orders.  Measured on an H100 at
# batch 2: at most 1.01e-2 (dx of stage 3); the limit keeps 2.5x of that.
BWD_REL_LIMIT = 2.5e-2

# The H100 SXM's dense bf16 tensor-core rate and HBM bandwidth (data sheet),
# for the roofline bound of each call.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


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
    wts = qpool_weights(cin, cout, g, device)
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


def _tie_rows(x: torch.Tensor) -> torch.Tensor:
    """Copy rows inside the aligned 4-row pool groups: groups r % 3 == 0
    take row 0 four times (4-way ties of every pooled value), r % 3 == 1
    repeat row 0 in row 1 (2-way ties where row 0 holds the max)."""
    b, n, c = x.shape
    grp = x.reshape(b, n // 4, 4, c).clone()
    r = torch.arange(n // 4, device=x.device)
    grp[:, r % 3 == 0] = grp[:, r % 3 == 0, :1].expand(-1, -1, 4, -1)
    grp[:, r % 3 == 1, 1] = grp[:, r % 3 == 1, 0]
    return grp.reshape(b, n, c)


def qpool_weights(cin: int, cout: int, g, device) -> fbt.QPoolWeights:
    f32 = torch.float32
    return fbt.QPoolWeights(
        _v((cin,), g, device, 0.1, f32, 1.0), _v((cin,), g, device, 0.1, f32),
        _w((3 * cout, cin), cin, g, device), _v((3 * cout,), g, device),
        _w((cout, cin), cin, g, device), _v((cout,), g, device))


class GradCase(NamedTuple):
    wrapper: str                       # launch counter of the backward
    names: Tuple[str, ...]             # "x" and the weight fields
    kernel: Callable[[], Tuple]        # gradients through the kernel path
    plain: Callable[[], Tuple]         # gradients through plain autograd
    kernel_bwd: Callable[[], object]   # the kernel backward alone
    plain_bwd: Callable[[], object]    # the plain autograd backward alone


def _grad_case(wrapper, names, inputs, cot, kfn, pfn, kbwd) -> GradCase:
    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(out, leaves, cot)

    state = {}

    def plain_bwd():
        if "out" not in state:
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = pfn(*leaves)
            state["out"] = (out if isinstance(out, tuple) else (out,), leaves)
        out, leaves = state["out"]
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)

    return GradCase(wrapper, names, lambda: grads(kfn), lambda: grads(pfn), kbwd, plain_bwd)


# Backward geometries: every block and transition, plus t23 with its pool
# groups forced to tie (:func:`_tie_rows`).
GRAD_CASES = tuple(BLOCKS) + tuple(QPOOL) + ("t23_ties",)


def grad_case(name: str, batch: int, g, device) -> GradCase:
    """Backward case of a geometry of :data:`GRAD_CASES`."""
    ties = name.endswith("_ties")
    name = name[: -len("_ties")] if ties else name
    if name in QPOOL:
        cin, cout, heads, l, n = QPOOL[name]
        wts = qpool_weights(cin, cout, g, device)
        x = torch.randn((batch, n, cin), generator=g).to(device, torch.bfloat16)
        if ties:
            x = _tie_rows(x)
        d = cout // heads
        scale = d ** -0.5
        cot = (_v((batch, n // 4, cout), g, device, 1.0),
               _v((batch, n // 4, cout), g, device, 1.0))
        return _grad_case(
            "qpool_front_bwd", ("x",) + fbt.QPoolWeights._fields, (x, *wts), cot,
            lambda x, *w: fbt.qpool_front(x, fbt.QPoolWeights(*w), heads, l, scale),
            lambda x, *w: fbt.qpool_front_plain(x, fbt.QPoolWeights(*w), heads, l, scale),
            lambda: fbt.qpool_front_cuda_bwd(x, wts, cot[0], cot[1], heads, l, scale, 1e-6))
    wrapper, c, heads, l, n = BLOCKS[name]
    wts = block_weights(c, heads, g, device)
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    cot = (_v((batch, n, c), g, device, 1.0),)
    scale = (c // heads) ** -0.5
    if wrapper == "fused_block":
        win = (batch * n // l, l, c)

        def kfn(x, *w):
            return fb.fused_block(x.reshape(win), fbt.BlockWeights(*w), heads,
                                  scale).reshape(x.shape)

        def pfn(x, *w):
            return fb.block_reference(x.reshape(win), fbt.BlockWeights(*w), heads,
                                      scale).reshape(x.shape)
    else:
        def kfn(x, *w):
            return fbt.fused_block_t(x, fbt.BlockWeights(*w), heads, l, scale)

        def pfn(x, *w):
            return fbt.block_plain(x, fbt.BlockWeights(*w), heads, l, scale)
    return _grad_case(wrapper + "_bwd", ("x",) + fbt.BlockWeights._fields, (x, *wts), cot,
                      kfn, pfn,
                      lambda: fbt.block_cuda_bwd(x, wts, cot[0], heads, l, scale, 1e-6))


def compare_grads(case: GradCase) -> Dict[str, Tuple[float, float]]:
    """name -> (max abs error, max abs error / max |plain|) of each gradient."""
    got, want = case.kernel(), case.plain()
    out = {}
    for nm, a, b in zip(case.names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{nm}: {a.dtype} {tuple(a.shape)} vs plain "
                                 f"{b.dtype} {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{nm}: kernel gradient is not finite")
        err = (a.float() - b.float()).abs().max().item()
        out[nm] = (err, err / max(b.float().abs().max().item(), 1e-12))
    return out


def work(name: str, batch: int, backward: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) one call of geometry ``name`` must do at ``batch``:
    its matrix products (2 per multiply-add) and each input read and each
    output written once.  A backward reads x, the output gradient and the
    weights and writes dx and the weight gradients.  The Q-pool backward
    recomputes its forward and runs two products per forward product: 3x
    the forward FLOPs.  The block backward recomputes every product but
    fc2 (qkv, proj, fc1 and the attention's two), then runs two products per
    linear layer and four per attention product pair (dP, dV, dQ, dK)."""
    bf = 2
    if name in DECODER:
        s, cin, cm = DECODER[name]
        px = batch * (2 * s) ** 2
        flops = 2.0 * px * (9 * cin * cm + 9 * cm * cm + cm)
        wbytes = bf * (9 * cin * cm + 9 * cm * cm + cm)
        return flops, batch * s * s * cin * bf + wbytes + px * bf
    if name in QPOOL:
        cin, cout, heads, l, n = QPOOL[name]
        m = batch * n
        flops = 2.0 * m * cin * 4 * cout + 4.0 * (m // 4) * l * cout
        wbytes = bf * (4 * cout * cin + 4 * cout) + 8 * cin
        act_in, act_out = m * cin * bf, 2 * (m // 4) * cout * bf
    else:
        _, c, heads, l, n = BLOCKS[name]
        m = batch * n
        wbytes = bf * (12 * c * c + 9 * c) + 16 * c
        act_in = act_out = m * c * bf
        if backward:
            flops = (2.0 * m * (3 * c * c + c * c + 4 * c * c) + 4.0 * m * l * c
                     + 2 * 2.0 * m * 12 * c * c + 8.0 * m * l * c)
            return flops, act_in + act_out + act_in + 2 * wbytes
        flops = 2.0 * m * (3 * c * c + c * c + 8 * c * c) + 4.0 * m * l * c
    if backward:
        return 3 * flops, act_in + act_out + act_in + 2 * wbytes
    return flops, act_in + wbytes + act_out


def bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """The roofline bound in ms and which side sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
