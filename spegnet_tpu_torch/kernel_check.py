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
import torch.nn.functional as F

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block as fb
from spegnet_tpu_torch.ops import fused_block_i8 as fb_i8
from spegnet_tpu_torch.ops import fused_block_t as fbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as fbt_i8
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
# The int8 encoder's geometries (model.int8_encoder): each bf16 geometry the
# int8 gates take, as (bf16 geometry, int8 wrapper).
I8 = {"stage2_i8": ("stage2", "fused_block_t_i8"), "stage3_i8": ("stage3", "fused_block_t_i8"),
      "global_i8": ("global", "fused_block_t_i8"), "stage4_i8": ("stage4", "fused_block_i8"),
      "t23_i8": ("t23", "qpool_front_i8"), "t34_i8": ("t34", "qpool_front_i8")}

# Blocks of each geometry in one Hiera-L forward (for per-forward totals).
BLOCK_COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3,
               "t12": 1, "t23": 1, "t34": 1, "dec2": 1}
BLOCK_COUNT.update({n: BLOCK_COUNT[g] for n, (g, _) in I8.items()})

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

# An int8 block or front vs its plain int8 version, in bf16: REL_LIMIT and
# no element more than one dequant step (0.2) apart.  The JAX package's
# element rule (tests/test_int8_block.py:56-61: <1% of elements more than
# 5e-4 apart) holds in f32 on the CPU (tests/test_torch_int8.py) but not
# here: the bf16 attention of the kernel and of the plain version round P
# at different points, which moves some attention outputs by one bf16 step
# and their int8 codes by one across a rounding edge (measured on an H100:
# 64% of the global block's outputs beyond 5e-4, max 0.0625, rel 1.1e-2).
# The share beyond 5e-4 is printed; the int8 pieces are held exactly by
# :func:`i8_parts`.
I8_ATOL, I8_MAX = 5e-4, 0.2
# i8_parts limits: LayerNorm + quant codes (the kernel's rsqrtf vs torch's
# rsqrt may move a LayerNorm output across a bf16 rounding edge, and its
# code by one) and the GELU epilogue (tanhf vs torch's tanh may move an
# output across a bf16 rounding edge): share of elements that differ, and
# by at most one code / one bf16 step.  Row quant and the GEMM without GELU
# must be bit-exact.
I8_PART_FRAC = 1e-3

# The H100 SXM's dense bf16 and int8 tensor-core rates and HBM bandwidth
# (data sheet), for the roofline bound of each call.
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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


def i8_case(name: str, batch: int, g, device) -> Case:
    """An int8 geometry: the bf16 geometry's random weights, packed to W8A8,
    through the int8 wrapper and its plain int8 version."""
    geo, wrapper = I8[name]
    if geo in QPOOL:
        cin, cout, heads, l, n = QPOOL[geo]
        wts = fbt_i8.pack_qpool_i8(qpool_weights(cin, cout, g, device))
        x = torch.randn((batch, n, cin), generator=g).to(device, torch.bfloat16)
        scale = (cout // heads) ** -0.5
        return Case(wrapper, lambda: fbt_i8.qpool_front_i8(x, wts, heads, l, scale),
                    lambda: fbt_i8.qpool_front_i8_plain(x, wts, heads, l, scale))
    _, c, heads, l, n = BLOCKS[geo]
    wts = fbt_i8.pack_i8(block_weights(c, heads, g, device))
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    scale = (c // heads) ** -0.5
    if wrapper == "fused_block_i8":
        xw = x.reshape(batch * n // l, l, c)
        return Case(wrapper, lambda: fb_i8.fused_block_i8(xw, wts, heads, scale),
                    lambda: fb_i8.block_i8_plain(xw, wts, heads, scale))
    return Case(wrapper, lambda: fbt_i8.fused_block_t_i8(x, wts, heads, l, scale),
                lambda: fbt_i8.block_t_i8_plain(x, wts, heads, l, scale))


def compare_i8(case: Case) -> Dict[str, float]:
    """Kernel vs plain int8 version: max abs error, its ratio to max |plain|,
    the share of elements beyond I8_ATOL (``frac_strict``) and beyond I8_ATOL
    plus one bf16 rounding of the output (``frac``)."""
    got, want = case.kernel(), case.plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    diffs, refs = [], []
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs plain {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        d = (a.float() - b.float()).abs().flatten()
        diffs.append(d)
        refs.append(b.float().abs().flatten())
    d, r = torch.cat(diffs), torch.cat(refs)
    err = d.max().item()
    return {"max_abs": err, "rel": err / max(r.max().item(), 1e-12),
            "frac_strict": (d > I8_ATOL).float().mean().item(),
            "frac": (d > I8_ATOL + r * 2.0 ** -8).float().mean().item()}


def i8_ok(res: Dict[str, float]) -> bool:
    return res["max_abs"] <= I8_MAX and res["rel"] <= REL_LIMIT


def _i8_gemms(name: str):
    """(N, K, gelu, residual) of each int8 GEMM of geometry ``name``."""
    geo = I8[name][0]
    if geo in QPOOL:
        cin, cout = QPOOL[geo][:2]
        return [(4 * cout, cin, False, False)]
    c = BLOCKS[geo][1]
    return [(3 * c, c, False, False), (c, c, False, True), (4 * c, c, True, False),
            (c, 4 * c, False, True)]


def i8_parts(name: str, batch: int, g, device) -> Dict[str, float]:
    """The int8 kernels of geometry ``name`` alone, on its shapes, against
    plain PyTorch on the same inputs: LayerNorm + quant (share of codes that
    differ, largest code difference, largest scale difference), the row
    quant of a [rows, 4C] matrix (codes and scales that differ), and each
    int8 GEMM with its epilogue on random codes and scales (share of bf16
    outputs that differ, largest difference in bf16 steps of the plain
    output among differences above 1e-5 of the largest output)."""
    geo, wrapper = I8[name]
    c, n = (QPOOL[geo][0], QPOOL[geo][4]) if geo in QPOOL else (BLOCKS[geo][1], BLOCKS[geo][4])
    m = batch * n
    x = torch.randn((m, c), generator=g).to(device, torch.bfloat16)
    lnw, lnb = _v((c,), g, device, 0.1, torch.float32, 1.0), _v((c,), g, device, 0.1,
                                                                  torch.float32)
    q, s = kernels.layernorm_q8(x, lnw, lnb, 1e-6)
    qp, sp = fbt_i8.quant_tokens(fbt.layer_norm(x, lnw, lnb, 1e-6))
    dq = (q.int() - qp.int()).abs()
    out = {"ln_code_frac": (dq > 0).float().mean().item(), "ln_code_max": dq.max().item(),
           "ln_scale_rel": ((s - sp[:, 0]).abs() / sp[:, 0]).max().item()}
    z = (torch.randn((m, 4 * c), generator=g) * 0.5).to(device, torch.bfloat16)
    qz, sz = kernels.quant_rows(z)
    qzp, szp = fbt_i8.quant_tokens(z)
    out["rowq_diff"] = int((qz != qzp).sum().item() + (sz != szp[:, 0]).sum().item())
    worst_frac, worst_steps = 0.0, 0.0
    exact = True
    for nn_, k, gelu, res in _i8_gemms(name):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(device)
        w = torch.randint(-127, 128, (nn_, k), generator=g, dtype=torch.int8).to(device)
        sa = (torch.rand(m, generator=g) * 0.02).to(device)
        sw = (torch.rand(nn_, generator=g) * 2e-3).to(device)
        bias = _v((nn_,), g, device, 0.1, torch.float32)
        r = torch.randn((m, nn_), generator=g).to(device, torch.bfloat16) if res else None
        for sw_first in (True, False):
            got = kernels.gemm_i8(a, sa, w, sw, bias, residual=r, gelu=gelu,
                                  sw_first=sw_first).float()
            want = fbt_i8.qdot(a, sa[:, None], w, sw, bias, sw_first)
            if gelu:
                want = F.gelu(want, approximate="tanh")
            want = want.to(torch.bfloat16)
            if r is not None:
                want = r + want
            want = want.float()
            differ = got != want
            frac = differ.float().mean().item()
            _, e = torch.frexp(want)
            ulp = torch.ldexp(torch.ones_like(want), e - 8)  # one bf16 step at |want|
            diff = (got - want).abs()
            # GELU of a pre-activation below ~-5 is ~1e-6 with few correct
            # bits in either tanh (1 + tanh cancels): steps there are not
            # counted when the difference is below 1e-5 of the largest output.
            counted = diff > 1e-5 * want.abs().max()
            steps = (diff / ulp)[counted].max().item() if counted.any() else 0.0
            worst_frac, worst_steps = max(worst_frac, frac), max(worst_steps, steps)
            exact = exact and (gelu or not differ.any().item())
    out.update(gemm_frac=worst_frac, gemm_steps=worst_steps, gemm_exact_no_gelu=exact)
    return out


def i8_parts_ok(res: Dict[str, float]) -> bool:
    return (res["ln_code_frac"] <= I8_PART_FRAC and res["ln_code_max"] <= 1
            and res["rowq_diff"] == 0 and res["gemm_exact_no_gelu"]
            and res["gemm_frac"] <= I8_PART_FRAC and res["gemm_steps"] <= 1.0)


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
    if name in I8:
        return work(I8[name][0], batch)
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


def i8_work(name: str, batch: int) -> Tuple[float, float, float]:
    """(int8 operations, bf16 FLOPs, bytes) of one call of int8 geometry
    ``name``: the projections in int8, attention in bf16; bytes as
    :func:`work` with the weights as int8 codes and f32 scales and biases."""
    geo = I8[name][0]
    if geo in QPOOL:
        cin, cout, heads, l, n = QPOOL[geo]
        m = batch * n
        ops, attn = 2.0 * m * cin * 4 * cout, 4.0 * (m // 4) * l * cout
        wbytes = 4 * cout * cin + 8 * 4 * cout + 8 * cin
        return ops, attn, m * cin * 2 + wbytes + 2 * (m // 4) * cout * 2
    _, c, heads, l, n = BLOCKS[geo]
    m = batch * n
    wbytes = 12 * c * c + 8 * 9 * c + 16 * c
    return 2.0 * m * 12 * c * c, 4.0 * m * l * c, 2 * m * c * 2 + wbytes


def bound_ms(flops: float, nbytes: float, int8_ops: float = 0.0) -> Tuple[float, str]:
    """The roofline bound in ms and which side sets it: operations (bf16
    FLOPs at the bf16 peak plus int8 operations at the int8 peak) or bytes."""
    t_ops = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def all_cases() -> Dict[str, Callable]:
    """geometry name -> function (name, batch, generator, device) -> Case."""
    cases = {n: block_case for n in BLOCKS}
    cases.update({n: qpool_case for n in QPOOL})
    cases.update({n: decoder_case for n in DECODER})
    return cases


def i8_cases() -> Dict[str, Callable]:
    """int8 geometry name -> function (name, batch, generator, device) -> Case."""
    return {n: i8_case for n in I8}


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
