"""The Hopper kernels against their plain PyTorch versions, in bf16, at every
main-path geometry of Hiera-L inference and training (batch 1; 512^2, and
the grids of 352^2 / 384^2 / 640^2 / 768^2 that are not 2^k, the attention
kernel at L 64 to 2304, 484 included; the window attention alone at every
kernel_check.WINDOW geometry, head dims 96 / 128 / 256 and L 4096
included, and the attention backward alone at every kernel_check.ATTN_BWD
geometry): the forward kernels against the
plain forward, the backward kernels against bf16 autograd of the plain
forward, for dx and every weight gradient, and the int8 encoder's kernels
against their plain int8 versions (kernel_check.i8_ok); the int8 decoder
block at every main-path size and at one with a partial tile and three
strips, its pieces exact (kernel_check.dec_i8_parts_ok), its border strips
against make_strips (kernel_check.strips_ok); the bf16 decoder's kernels one
by one at every decoder size and two calls bit-equal at every DECODER and
DEC_EDGE geometry; the decoder's edge branch with and without a head, at
both tile widths of its Cm 128 kernels; the LayerNorm backward at every C of
a training step and at other row lengths; the
attention kernel at lengths that are not multiples of 16 and on strided views; the int8 Predictor's and the
384^2 Predictor's launches; the T-block's saved-residual pair bit-equal to
the recompute pair and within the limits of its plain versions (T-block
geometries include the 1024^2 global block, L 4096); the bf16 and int8
GEMMs just past 65535 row tiles; the hand-off GEMM at every product it
takes and on ragged shapes (kernel_check.GEMM_HO).  In f32 (``use_amp: false``): the gen-1
block, both attention wrappers and the int8 gen-1 block at every f32
main-path geometry (kernel_check.F32_REL_LIMIT; the int8 one by the int8
rule), the f32 GEMM, LayerNorm and attention on ragged shapes, the f32 GEMM
at every f32 gen-1 product (kernel_check.gemm_f32_shapes, two calls
bit-equal), the int8 LayerNorm + quant at every kernel_check.LNQ8 geometry
and at other row lengths (kernel_check.lnq8_ok), and the f32 Predictor's
launches (JAX's f32 routes: no T-block, no front).
These need an NVIDIA card with nvcc; elsewhere they skip."""

import pytest
import torch

from spegnet_tpu_torch import kernel_check, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(kernel_check.all_cases()))
def test_kernel_matches_plain(cuda, name):
    g = torch.Generator().manual_seed(0)
    case = kernel_check.all_cases()[name](name, 1, g, cuda)
    before = kernels.launches[case.wrapper]
    err, rel = kernel_check.compare(case)
    torch.cuda.synchronize()
    assert kernels.launches[case.wrapper] == before + 1
    assert rel <= kernel_check.REL_LIMIT, (name, err, rel)


@pytest.mark.parametrize("name", sorted(kernel_check.WINDOW))
def test_window_attention_matches_plain(cuda, name):
    """The window attention alone (csrc/attention_window.cu) at every
    kernel_check.WINDOW geometry: output, log-sum-exp, and the call without
    the log-sum-exp bit-equal (kernel_check.window_ok)."""
    res = kernel_check.compare_window(name, 1, torch.Generator().manual_seed(0), cuda)
    torch.cuda.synchronize()
    assert kernel_check.window_ok(res), (name, res)


@pytest.mark.parametrize("name", sorted(kernel_check.ATTN_BWD))
def test_attention_bwd_matches_plain(cuda, name):
    """The attention backward alone (csrc/attention_window_bwd.cu) at every
    kernel_check.ATTN_BWD geometry: dq, dk, dv against bf16 autograd of the
    plain attention, two calls bit-equal, the columns of dy that are not k
    or v left alone (kernel_check.attn_bwd_ok)."""
    res = kernel_check.compare_attn_bwd(name, 1, torch.Generator().manual_seed(0), cuda)
    torch.cuda.synchronize()
    assert kernel_check.attn_bwd_ok(res), (name, res)


@pytest.mark.parametrize("name", kernel_check.GRAD_CASES)
def test_backward_kernels_match_plain_autograd(cuda, name):
    case = kernel_check.grad_case(name, 1, torch.Generator().manual_seed(0), cuda)
    before = kernels.launches[case.wrapper]
    errs = kernel_check.compare_grads(case)
    torch.cuda.synchronize()
    assert kernels.launches[case.wrapper] == before + 1
    worst = max(errs, key=lambda k: errs[k][1])
    assert errs[worst][1] <= kernel_check.BWD_REL_LIMIT, (name, worst, errs[worst])


def test_decoder_kernel_partial_tiles(cuda):
    """A 2S grid that is not a multiple of the kernel's 128-pixel tile: the
    halo, the tail columns and the stores are all guarded."""
    case = kernel_check.decoder_case_at(20, 64, 64, 2, torch.Generator().manual_seed(0), cuda)
    err, rel = kernel_check.compare(case)
    assert rel <= kernel_check.REL_LIMIT, (err, rel)


@pytest.mark.parametrize("name", sorted(kernel_check.DEC_I8) + ["s24"])
def test_int8_decoder_matches_plain_int8(cuda, name):
    """``s24``: S 24, sh 8 -- one partial 128-cell tile, three strips."""
    geo = (24, 128, 64) if name == "s24" else name
    case = kernel_check.dec_i8_case(geo, 1, torch.Generator().manual_seed(0), cuda)
    before = kernels.launches[case.wrapper]
    err, rel = kernel_check.compare(case)
    torch.cuda.synchronize()
    assert kernels.launches[case.wrapper] == before + 1
    assert rel <= kernel_check.REL_LIMIT, (name, err, rel)
    parts = kernel_check.dec_i8_parts(geo, 1, torch.Generator().manual_seed(1), cuda)
    assert kernel_check.dec_i8_parts_ok(parts), (name, parts)


@pytest.mark.parametrize("name", sorted(kernel_check.DEC_I8))
def test_bf16_decoder_kernels_match_plain(cuda, name):
    """conv1 (the 2x sample built in the kernel) and conv2 + head one by one
    at every decoder size (S 256 / 192 / 176 / 320), two calls bit-equal."""
    res = kernel_check.dec_bf16_parts(name, 1, torch.Generator().manual_seed(0), cuda)
    assert kernel_check.dec_bf16_parts_ok(res), (name, res)


@pytest.mark.parametrize("name", sorted(kernel_check.DECODER) + sorted(kernel_check.DEC_EDGE))
def test_decoder_two_calls_bit_equal(cuda, name):
    make = kernel_check.edge_case if name in kernel_check.DEC_EDGE else kernel_check.decoder_case
    case = make(name, 1, torch.Generator().manual_seed(0), cuda)
    assert torch.equal(case.kernel(), case.kernel()), name


@pytest.mark.parametrize("name", sorted(kernel_check.DEC_I8) + ["s24"])
def test_decoder_strips_match_make_strips(cuda, name):
    """The strip kernel against make_strips (kernel_check.strips_ok), two
    calls bit-equal."""
    from spegnet_tpu_torch.ops import fused_decoder as fd

    geo = (24, 128, 64) if name == "s24" else name
    x, q, _ = kernel_check.dec_i8_inputs(geo, 1, torch.Generator().manual_seed(0), cuda)
    got = kernels.dec_strips(x, q.k1t)
    want = torch.stack(fd.make_strips(x, q.k1, dtype=x.dtype))
    assert kernel_check.strips_ok(kernel_check.strips_apart(got, want)), name
    assert torch.equal(got, kernels.dec_strips(x, q.k1t)), name


def test_int8_decoder_grid_limits(cuda):
    """B * S past 65535 (conv1's grid runs (image, cell row) on its x axis):
    the chain on 4097 images of S 16 gives each image what the plain version
    gives it alone (the scales are per image and per strip); and a batch
    past the y / z grid limit of the other kernels raises before launch."""
    from spegnet_tpu_torch.ops import fused_decoder as fd

    x, q, _ = kernel_check.dec_i8_inputs((16, 128, 64), 4097, torch.Generator().manual_seed(0),
                                         cuda)
    got = fd.i8_parts_cuda(x, q)
    for i in (0, 2048, 4096):
        want = fd.i8_parts_plain(x[i:i + 1], q)
        assert torch.equal(got["sx"][i:i + 1], want["sx"]), i
        assert torch.equal(got["sa"][i:i + 1], want["sa"]), i
        dq = (got["xq"][i:i + 1].int() - want["xq"].int()).abs()
        assert dq.max() <= 1 and (dq > 0).float().mean() <= kernel_check.I8_PART_FRAC, i
        for key in ("y1", "pred"):
            frac, steps = kernel_check.bf16_steps(got[key][i:i + 1], want[key])
            assert frac <= kernel_check.I8_PART_FRAC and steps <= 1.0, (i, key, frac, steps)
    with pytest.raises(ValueError, match="65535"):
        kernels.quant_image_i8(torch.zeros((65536, 8), dtype=torch.bfloat16, device=cuda))


@pytest.mark.parametrize("name", kernel_check.RES)
def test_residual_pair_matches_recompute_and_plain(cuda, name):
    """The saved-residual pair (SAVE_RESIDUALS "1" under autograd) against
    the recompute pair: y, dx and the twelve weight gradients bit-equal,
    through the wrapper and chain by chain; against its plain versions
    within REL_LIMIT / BWD_REL_LIMIT."""
    case = kernel_check.res_case(name, 1, torch.Generator().manual_seed(0), cuda)
    before = {k: kernels.launches[k] for k in ("fused_block_t_res", "fused_block_t_bwd_res",
                                               "fused_block_t", "fused_block_t_bwd")}
    res = kernel_check.compare_res(case)
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - n for k, n in before.items()} == dict.fromkeys(before, 1)
    assert kernel_check.res_ok(res), (name, res)


# M = 65536 * 128 + 128 rows: one 128-row tile past the 65535 of a y grid axis.
M_PAST_Y = 65536 * 128 + 128


def test_gemm_past_65535_row_tiles(cuda):
    g = torch.Generator().manual_seed(0)
    a = torch.randn((M_PAST_Y, 64), generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn((64, 64), generator=g) * 0.125).to(cuda, torch.bfloat16)
    got = kernels.gemm(a, w).float()
    want = (a.float() @ w.float().t()).to(torch.bfloat16).float()
    # f32 sums in another order: one bf16 step of the largest output (an
    # output that nearly cancels may differ by many steps of its own size);
    # the tile past the old limit on its own too
    for rows in (slice(None), slice(-128, None)):
        err = (got[rows] - want[rows]).abs().max() / want[rows].abs().max()
        assert err <= 2.0 ** -8, (rows, err.item())


def test_int8_gemm_past_65535_row_tiles(cuda):
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (M_PAST_Y, 128), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (64, 128), generator=g, dtype=torch.int8).to(cuda)
    sa = (torch.rand(M_PAST_Y, generator=g) * 0.02).to(cuda)
    sw = (torch.rand(64, generator=g) * 2e-3).to(cuda)
    bias = (0.1 * torch.randn(64, generator=g)).to(cuda)
    got = kernels.gemm_i8(a, sa, w, sw, bias)
    acc = torch._int_mm(a, w.t()).float()
    want = (acc * sw * sa[:, None] + bias).to(torch.bfloat16)
    assert torch.equal(got, want)


# The persistent GEMM (csrc/gemm_persistent.cuh) on s8: every forward product
# of the int8 blocks at stages 2-3 (batch 1) and tails of M, N and K (M 1, 31,
# 4099; N 8, 136; K 32, 96, 2304).
I8_GEMM_SHAPES = sorted({(m, n, k) for name, (m, n, k, _, _) in
                         kernel_check.gemm_shapes(1).items()
                         if name.split("_")[0] in ("stage2", "stage3")}
                        | {(1, 8, 32), (31, 136, 96), (4099, 136, 2304)})


@pytest.mark.parametrize("m,n,k", I8_GEMM_SHAPES)
def test_int8_gemm_equals_exact_qdot(cuda, m, n, k):
    """The s8 GEMM against the exact f64 integer sum (ops/fused_block_t_i8.qdot)
    plus the same rounding, bit for bit, for each epilogue (none, residual,
    tanh GELU; the erf GELU on an f32 output to within I8_F32_GELU_REL, as
    erff and torch's erf differ), both dequant orders and both output
    types; the tanh GELU on bf16 to within one bf16 step on <= I8_PART_FRAC
    of the outputs (kernel_check.i8_parts' rule: tanhf vs torch's tanh)."""
    import torch.nn.functional as F

    from spegnet_tpu_torch.ops.fused_block_t_i8 import qdot

    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(cuda)
    sa = (torch.rand(m, generator=g) * 0.02).to(cuda)
    sw = (torch.rand(n, generator=g) * 2e-3).to(cuda)
    bias = (0.1 * torch.randn(n, generator=g)).to(cuda)
    for dt in (torch.bfloat16, torch.float32):
        r = torch.randn((m, n), generator=g).to(cuda, dt)
        gelus = [None, "tanh"] + (["erf"] if dt == torch.float32 else [])
        for sw_first in (True, False):
            acc = qdot(a, sa[:, None], w, sw, bias, sw_first)
            for gelu in gelus:
                for res in (None, r):
                    got = kernels.gemm_i8(a, sa, w, sw, bias, residual=res, gelu=gelu is not None,
                                          sw_first=sw_first, out_dtype=dt,
                                          approx_gelu=gelu != "erf")
                    want = acc if gelu is None else F.gelu(
                        acc, approximate="tanh" if gelu == "tanh" else "none")
                    want = want.to(dt)
                    if res is not None:
                        want = res + want
                    torch.cuda.synchronize()
                    what = (dt, sw_first, gelu, res is None)
                    if gelu is None:
                        assert torch.equal(got, want), what
                    elif dt == torch.float32:
                        rel = (got - want).abs().max() / want.abs().max()
                        assert rel <= kernel_check.I8_F32_GELU_REL, (what, rel.item())
                    else:
                        _, e = torch.frexp(want.float())
                        ulp = torch.ldexp(torch.ones_like(want.float()), e - 8)
                        diff = (got.float() - want.float()).abs()
                        assert (diff <= ulp).all(), what
                        assert (diff > 0).float().mean() <= kernel_check.I8_PART_FRAC, what


@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (31, 136, 72), (4099, 576, 144),
                                   (8192, 1728, 576), (8192, 576, 2304), (2048, 1152, 4608)])
def test_gemm_matches_mm_and_repeats(cuda, m, n, k):
    """The bf16 persistent GEMM within REL_LIMIT of torch.mm in f32 (TF32
    off) on the same bf16 operands, each epilogue, and two calls bit-equal
    (every sum over K in k order, whatever the tile walk)."""
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn((m, k), generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn((n, k), generator=g) * k ** -0.5).to(cuda, torch.bfloat16)
    bias = (0.1 * torch.randn(n, generator=g)).to(cuda, torch.bfloat16)
    r = torch.randn((m, n), generator=g).to(cuda, torch.bfloat16)
    ref = a.float() @ w.float().t() + bias.float()
    calls = {
        "none": (lambda: kernels.gemm(a, w, bias), ref),
        "residual": (lambda: kernels.gemm(a, w, bias, residual=r), ref + r.float()),
        "gelu": (lambda: kernels.gemm(a, w, bias, gelu=True),
                 torch.nn.functional.gelu(ref, approximate="tanh")),
        "gelu_pre": (lambda: torch.cat(kernels.gemm_gelu_pre(a, w, bias), 1),
                     torch.cat([ref, torch.nn.functional.gelu(ref, approximate="tanh")], 1)),
    }
    for what, (call, want) in calls.items():
        got, again = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(got, again), what
        rel = float((got.float() - want).abs().max() / want.abs().max())
        assert rel <= kernel_check.REL_LIMIT, (what, rel)


@pytest.mark.parametrize("name", sorted(kernel_check.GEMM_HO))
def test_handoff_gemm_matches_plain_and_repeats(cuda, name):
    """The hand-off GEMM (csrc/gemm_handoff.cuh) at every product the plan
    sends it in a 512^2 forward (batch 8: each stage's fc1 with its GELU and
    its GELU-pre, the fronts' stacked products) and on ragged shapes (M, N
    and K tails, N not a multiple of 192, an odd M-tile count): within
    REL_LIMIT of kernels.gemm_plain, two calls bit-equal, each a launch of
    the hand-off kernel."""
    res = kernel_check.compare_gemm_ho(name, 8, torch.Generator().manual_seed(0), cuda)
    assert kernel_check.gemm_ho_ok(res), (name, res)


@pytest.mark.parametrize("head", [False, True])
def test_decoder_edge_branch_small(cuda, head):
    case = kernel_check.edge_case((16, 64, 32, 128), 2, torch.Generator().manual_seed(0), cuda,
                                  head=head)
    err, rel = kernel_check.compare(case)
    assert rel <= kernel_check.REL_LIMIT, (head, err, rel)


@pytest.mark.parametrize("geom", [(32, 32, 16, 128), (48, 64, 32, 128), "dec_edge",
                                  "dec_edge_384"])
@pytest.mark.parametrize("head", [False, True])
def test_decoder_edge_branch_tile_widths(cuda, geom, head):
    """The Cm 128 kernels at both tile widths (kernels.dec128_plan: 96 for
    a 2S of 64 (ragged), 96 and 192, 128 for 256) with and without the head,
    within REL_LIMIT, two calls bit-equal."""
    case = kernel_check.edge_case(geom, 1, torch.Generator().manual_seed(0), cuda, head=head)
    err, rel = kernel_check.compare(case)
    a, b = case.kernel(), case.kernel()
    torch.cuda.synchronize()
    assert rel <= kernel_check.REL_LIMIT and torch.equal(a, b), (geom, head, err, rel)


@pytest.mark.parametrize("dres", [False, True])
@pytest.mark.parametrize("name", sorted(kernel_check.LN_BWD))
def test_layernorm_bwd_matches_plain(cuda, name, dres):
    """The LayerNorm backward at each C of a training step against
    ops/fused_block_t._layer_norm_bwd (dx, dw, db within BWD_REL_LIMIT), two
    calls bit-equal."""
    res = kernel_check.compare_ln_bwd(name, 1, dres, torch.Generator().manual_seed(0), cuda)
    torch.cuda.synchronize()
    assert kernel_check.ln_bwd_ok(res), (name, res)


@pytest.mark.parametrize("c,rows", [(8, 5), (144, 1), (1160, 77), (1288, 40), (4096, 33)])
def test_layernorm_bwd_other_widths(cuda, c, rows):
    """One vector up to the wide form's longest row, and row counts that
    leave groups idle."""
    from spegnet_tpu_torch.ops.fused_block_t import _layer_norm_bwd

    g = torch.Generator().manual_seed(c + rows)
    x = torch.randn((rows, c), generator=g).to(cuda, torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    dy = torch.randn((rows, c), generator=g).to(cuda, torch.bfloat16)
    dr = torch.randn((rows, c), generator=g).to(cuda, torch.bfloat16)
    got = kernels.layernorm_bwd(x, w, dy, 1e-6, dres=dr)
    want = list(_layer_norm_bwd(x, w, dy.float(), 1e-6))
    want[0] = want[0] + dr.float()
    for a, b in zip(got, want):
        rel = float((a.float() - b).abs().max() / b.abs().max())
        assert rel <= kernel_check.BWD_REL_LIMIT, (c, rows, rel)


def test_int8_decoder_refuses_non_bf16(cuda):
    """An f32 block on the card has no int8 mode and no f32 kernel: the
    wrapper raises instead of falling back to a plain version."""
    from spegnet_tpu_torch.ops import fused_decoder as fd

    x, q, p = kernel_check.dec_i8_inputs((16, 128, 64), 1, torch.Generator().manual_seed(0),
                                         cuda)
    with pytest.raises(ValueError):
        fd.fused_decoder_block(x.float(), p, int8=True, q=q)
    with pytest.raises(ValueError):
        kernels.quant_image_i8(x.float())


def test_kernel_path_refuses_f32(cuda):
    from spegnet_tpu_torch.ops import fused_block_t as fbt

    g = torch.Generator().manual_seed(0)
    wts = kernel_check.block_weights(64, 2, g, cuda)
    x = torch.randn(1, 256, 64, device=cuda)
    with pytest.raises(ValueError):
        fbt.fused_block_t(x, wts, 2, 64, 32 ** -0.5)


@pytest.mark.parametrize("name", sorted(kernel_check.I8))
def test_int8_kernel_matches_plain_int8(cuda, name):
    case = kernel_check.i8_case(name, 1, torch.Generator().manual_seed(0), cuda)
    before = kernels.launches[case.wrapper]
    res = kernel_check.compare_i8(case)
    torch.cuda.synchronize()
    assert kernels.launches[case.wrapper] == before + 1
    assert kernel_check.i8_ok(res), (name, res)
    parts = kernel_check.i8_parts(name, 1, torch.Generator().manual_seed(1), cuda)
    assert kernel_check.i8_parts_ok(parts), (name, parts)


def test_int8_predictor_launches_int8_kernels(cuda):
    import collections

    import numpy as np

    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16", "int8_encoder": True,
          "image_processing": {"target_size": 512}}
    model = init_weights(SPEGNet(SPEGNetConfig.from_dict(mc)), torch.Generator().manual_seed(0))
    pred = Predictor(None, mc, None, device="cuda", model=model)
    kernels.reset_launches()
    seg, _ = pred.predict_arrays([np.zeros((300, 400, 3), np.uint8)])
    torch.cuda.synchronize()
    routes = collections.Counter(trunk_routes(HIERA_VARIANTS["large"], 128, torch.bfloat16,
                                              True))
    assert routes["fused_block_t_i8"] == 40 and routes["fused_block_i8"] == 3
    for w, n in routes.items():
        assert kernels.launches[w] == n, (w, kernels.launches)
    assert np.isfinite(seg).all()


def test_int8_wrapper_refuses_f32(cuda):
    from spegnet_tpu_torch.ops import fused_block_t_i8 as fbt_i8

    wts = fbt_i8.pack_i8(kernel_check.block_weights(64, 2, torch.Generator().manual_seed(0),
                                                    cuda))
    with pytest.raises(ValueError):
        fbt_i8.fused_block_t_i8(torch.randn(1, 256, 64, device=cuda), wts, 2, 64, 32 ** -0.5)


@pytest.mark.parametrize("l", [1, 20, 63, 65, 100, 127, 129, 484])
def test_attention_kernel_any_length(cuda, l):
    """Query and key tails are masked inside the kernel: any L (one consumer
    per problem up to 64, 128-row items and 128-key tiles above, whose edges
    63 / 65 / 127 / 129 straddle), and q / k / v given as separate
    [B, L, H, D] tensors (one of them a permuted view)."""
    from spegnet_tpu_torch.ops import pallas_attention as pa

    g = torch.Generator().manual_seed(l)
    qkv = torch.randn((3, l, 3 * 2 * 72), generator=g).to(cuda, torch.bfloat16)
    got = pa.fused_attention_lanes(qkv, 2, 72 ** -0.5)
    want = pa.lanes_plain(qkv, 2, 72 ** -0.5)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.REL_LIMIT
    q = torch.randn((3, 2, l, 64), generator=g).to(cuda, torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((3, l, 2, 64), generator=g).to(cuda, torch.bfloat16) for _ in "kv")
    got = pa.fused_attention(q, k, v)
    want = pa.attention_reference(q, k, v)
    assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.REL_LIMIT


@pytest.mark.parametrize("p,h,l", [(300, 3, 100), (301, 3, 20)])
def test_attention_kernel_persistent_grid(cuda, p, h, l):
    """More work items than blocks (the grid is about one block per SM): each
    block walks several items, with an odd (problem, head) count at L <= 64
    leaving one consumer of the last item idle."""
    from spegnet_tpu_torch.ops import pallas_attention as pa

    g = torch.Generator().manual_seed(p)
    qkv = torch.randn((p, l, 3 * h * 72), generator=g).to(cuda, torch.bfloat16)
    plan = kernels.attention_plan(p, h, l, 72, kernels._sm_count(qkv.device.index))
    assert plan.items > plan.grid
    got, want = pa.fused_attention_lanes(qkv, h, 72 ** -0.5), pa.lanes_plain(qkv, h, 72 ** -0.5)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.REL_LIMIT


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("l", [20, 484])
@pytest.mark.parametrize("d", [20, 136, 256])
def test_attention_head_dims_up_to_256(cuda, d, l, dtype):
    """Every head dim up to 256 launches a kernel through both wrappers: 20
    (zero-padded to 24 / the f32 kernel's 20), 136 and 256, within REL_LIMIT
    (bf16) / F32_REL_LIMIT (f32) of the plain version; 264 is refused."""
    from spegnet_tpu_torch.ops import pallas_attention as pa

    dt, limit = ((torch.bfloat16, kernel_check.REL_LIMIT) if dtype == "bf16"
                 else (torch.float32, kernel_check.F32_REL_LIMIT))
    g = torch.Generator().manual_seed(d + l)
    qkv = torch.randn((2, l, 3 * 2 * d), generator=g).to(cuda, dt)
    before = dict(kernels.launches)
    got, want = pa.fused_attention_lanes(qkv, 2, d ** -0.5), pa.lanes_plain(qkv, 2, d ** -0.5)
    q, k, v = pa.split_qkv(qkv, 2)
    got2, want2 = pa.fused_attention(q, k, v), pa.attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["fused_attention_lanes"] == before["fused_attention_lanes"] + 1
    assert kernels.launches["fused_attention"] == before["fused_attention"] + 1
    for a, b in ((got, want), (got2, want2)):
        assert a.shape == b.shape and a.dtype == dt
        assert float((a - b).abs().max() / b.abs().max()) <= limit
    wide = torch.zeros((1, l, 1, 264), device=cuda, dtype=dt)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        kernels.attention(wide, wide, wide, 0.1)


def test_attention_wrappers_run_f32(cuda):
    """f32 attention has its own kernel (csrc/attention_f32.cu): both
    wrappers launch it and match their plain f32 versions."""
    from spegnet_tpu_torch.ops import pallas_attention as pa

    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((2, 64, 3 * 2 * 72), generator=g).to(cuda)
    before = dict(kernels.launches)
    got = pa.fused_attention_lanes(qkv, 2, 72 ** -0.5)
    want = pa.lanes_plain(qkv, 2, 72 ** -0.5)
    q, k, v = pa.split_qkv(qkv, 2)
    got2, want2 = pa.fused_attention(q, k, v), pa.attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["fused_attention_lanes"] == before["fused_attention_lanes"] + 1
    assert kernels.launches["fused_attention"] == before["fused_attention"] + 1
    for a, b in ((got, want), (got2, want2)):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max() / b.abs().max()) <= kernel_check.F32_REL_LIMIT


@pytest.mark.parametrize("name", sorted(kernel_check.f32_cases()))
def test_f32_kernel_matches_plain(cuda, name):
    case = kernel_check.f32_cases()[name](name, 1, torch.Generator().manual_seed(0), cuda)
    before = kernels.launches[case.wrapper]
    err, rel = kernel_check.compare(case)
    torch.cuda.synchronize()
    assert kernels.launches[case.wrapper] == before + 1
    assert rel <= kernel_check.F32_REL_LIMIT, (name, err, rel)


def test_f32_int8_kernel_matches_plain_int8(cuda):
    name = "stage4_i8_f32"
    case = kernel_check.f32_i8_case(name, 1, torch.Generator().manual_seed(0), cuda)
    before = kernels.launches[case.wrapper]
    res = kernel_check.compare_i8(case)
    torch.cuda.synchronize()
    assert kernels.launches[case.wrapper] == before + 1
    assert kernel_check.i8_ok(res), res
    parts = kernel_check.i8_parts(name, 1, torch.Generator().manual_seed(1), cuda)
    assert kernel_check.i8_parts_ok(parts), parts


@pytest.mark.parametrize("gelu", [None, "erf", "tanh"])
def test_f32_gemm_and_layernorm_ragged(cuda, gelu):
    """M, N and K tails (300 x 200 x 100) in the 3xTF32 GEMM and its
    epilogues, and a LayerNorm row of 100, against f32 PyTorch (TF32 off)."""
    import torch.nn.functional as F

    from spegnet_tpu_torch.ops.fused_block_t import layer_norm

    g = torch.Generator().manual_seed(2)
    a, w, bias, res = (torch.randn(shape, generator=g).to(cuda)
                       for shape in ((300, 100), (200, 100), (200,), (300, 200)))
    got = kernels.gemm_f32(a, w, bias, residual=res, gelu=gelu)
    want = F.linear(a, w, bias)
    if gelu:
        want = F.gelu(want, approximate="tanh" if gelu == "tanh" else "none")
    want = res + want
    assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.F32_REL_LIMIT
    lw, lb = torch.randn(100, generator=g).to(cuda), torch.randn(100, generator=g).to(cuda)
    y, yp = kernels.layernorm_f32(a, lw, lb, 1e-6), layer_norm(a, lw, lb, 1e-6)
    assert float((y - yp).abs().max() / yp.abs().max()) <= kernel_check.F32_REL_LIMIT


@pytest.mark.parametrize("name", sorted(kernel_check.gemm_f32_shapes(1)))
def test_f32_gemm_matches_plain_and_repeats(cuda, name):
    """The 3xTF32 GEMM at every product of the f32 gen-1 blocks (512^2 and
    384^2, batch 1) and a ragged shape, with its epilogue, within
    F32_REL_LIMIT of its plain f32 version; two calls bit-equal."""
    res = kernel_check.compare_gemm_f32(name, 1, torch.Generator().manual_seed(0), cuda)
    torch.cuda.synchronize()
    assert kernel_check.gemm_f32_ok(res), (name, res)


@pytest.mark.parametrize("name", sorted(kernel_check.LNQ8))
def test_layernorm_q8_matches_plain(cuda, name):
    """The LayerNorm + quant row pass at each int8 geometry (C 288 / 576 /
    1152, bf16, and 1152 in f32) by the int8 rule against its plain
    version."""
    res = kernel_check.compare_lnq8(name, 1, torch.Generator().manual_seed(0), cuda)
    torch.cuda.synchronize()
    assert kernel_check.lnq8_ok(res, kernel_check.LNQ8[name][2]), (name, res)


@pytest.mark.parametrize("c,f32,rows", [(8, False, 3), (144, False, 1001), (2304, False, 777),
                                        (4096, False, 65), (16, True, 5), (1536, True, 300)])
def test_layernorm_q8_other_widths(cuda, c, f32, rows):
    """Rows of one vector up to the wide form's longest, and row counts that
    leave groups of a warp idle, by the same rule."""
    from spegnet_tpu_torch.ops.fused_block_t import layer_norm
    from spegnet_tpu_torch.ops.fused_block_t_i8 import quant_tokens

    g = torch.Generator().manual_seed(c + rows)
    x = torch.randn((rows, c), generator=g).to(cuda, torch.float32 if f32 else torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    b = (0.1 * torch.randn(c, generator=g)).to(cuda)
    q, s = kernels.layernorm_q8(x, w, b, 1e-6)
    qp, sp = quant_tokens(layer_norm(x, w, b, 1e-6))
    dq = (q.int() - qp.int()).abs()
    res = {"code_frac": float((dq > 0).float().mean()), "code_max": int(dq.max()),
           "scale_rel": float(((s - sp[:, 0]).abs() / sp[:, 0]).max()), "same": True}
    assert kernel_check.lnq8_ok(res, f32), res


@pytest.mark.parametrize("l", [1, 20, 100, 484])
def test_f32_attention_kernel_any_length(cuda, l):
    from spegnet_tpu_torch.ops import pallas_attention as pa

    g = torch.Generator().manual_seed(l)
    qkv = torch.randn((3, l, 3 * 2 * 72), generator=g).to(cuda)
    got, want = pa.fused_attention_lanes(qkv, 2, 72 ** -0.5), pa.lanes_plain(qkv, 2, 72 ** -0.5)
    assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.F32_REL_LIMIT
    q = torch.randn((3, 2, l, 64), generator=g).to(cuda).transpose(1, 2)
    k, v = (torch.randn((3, l, 2, 64), generator=g).to(cuda) for _ in "kv")
    got, want = pa.fused_attention(q, k, v), pa.attention_reference(q, k, v)
    assert float((got - want).abs().max() / want.abs().max()) <= kernel_check.F32_REL_LIMIT


@pytest.mark.parametrize("l", [1, 2, 16, 20, 32, 64, 65, 256, 300, 4096])
@pytest.mark.parametrize("d", [4, 12, 20, 64, 72, 76, 80, 84, 128, 256])
def test_f32_attention_every_head_dim_and_length(cuda, d, l):
    """The f32 kernels against the plain f32 version within F32_REL_LIMIT
    (TF32 off) at head dims 4-256 and L 1-4096: attention_tf32_kernel up to
    80 (packed windows at L 1, 2, 16, 32; one consumer per problem at 20,
    64; 128-row items at 65 and above, the last key tile partial at 65 and
    300), the mma.sync kernel above 80; on 5 problems of 3 heads (an idle consumer
    at L <= 64, a partial group of packed windows)."""
    from spegnet_tpu_torch.ops import pallas_attention as pa

    p = 1 if l == 4096 else 5
    g = torch.Generator().manual_seed(d * 10000 + l)
    qkv = torch.randn((p, l, 3 * 3 * d), generator=g).to(cuda)
    got, want = pa.fused_attention_lanes(qkv, 3, d ** -0.5), pa.lanes_plain(qkv, 3, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= kernel_check.F32_REL_LIMIT, (d, l, rel)


@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (31, 136, 72), (1000, 432, 144), (4099, 264, 1160),
                                   (65536 * 128 + 128, 8, 16)])
def test_gemm_tn_matches_mm(cuda, m, n, k):
    """The weight-gradient GEMM (csrc/hiera_block_bwd.cu) against torch.mm in
    f32 (TF32 off) and in f64 on bf16 operands, at N / K tails (136 = 128 +
    8 rows, K 72 / 1160 past a tile width), M 1, 31 and past 2^23 rows (65536
    x 128 + 128; the 1-D grid, TMA row coordinates past 65535 boxes), the
    column sums against a.sum(0) in f64: max|kernel - ref| / max|ref| <=
    1e-4 (f32 sums over up to 8.4e6 rows in other orders; the tensor cores'
    own accumulation truncates, which over a split of ~6e4 rows biases its
    sum by up to ~5e-5 of it, common.cuh `mma_3xtf32`); and two calls
    bit-equal (fixed split order, no atomics)."""
    g = torch.Generator().manual_seed(m % 1000 + n + k)
    a = torch.randn((m, n), generator=g).to(cuda, torch.bfloat16)
    b = torch.randn((m, k), generator=g).to(cuda, torch.bfloat16)
    out, cs = kernels.gemm_tn(a, b)
    out2, cs2 = kernels.gemm_tn(a, b)
    ref32 = torch.mm(a.float().t(), b.float())
    ref64 = torch.mm(a.double().t(), b.double())
    cs64 = a.double().sum(0)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(cs, cs2)
    for ref in (ref32.double(), ref64):
        assert float((out.double() - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert float((cs.double() - cs64).abs().max() / cs64.abs().max()) <= 1e-4


def test_f32_predictor_launches_follow_the_routes(cuda):
    import collections

    import numpy as np

    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    mc = {"encoder": {"variant": "large"}, "compute_dtype": "float32",
          "image_processing": {"target_size": 512}}
    model = init_weights(SPEGNet(SPEGNetConfig.from_dict(mc)), torch.Generator().manual_seed(0))
    pred = Predictor(None, mc, None, device="cuda", model=model)
    kernels.reset_launches()
    seg, _ = pred.predict_arrays([np.zeros((300, 400, 3), np.uint8)])
    torch.cuda.synchronize()
    routes = collections.Counter(trunk_routes(HIERA_VARIANTS["large"], 128, torch.float32,
                                              False))
    assert routes == {"fused_block": 10, "fused_attention_lanes": 35, "plain": 3}
    routes.pop("plain")
    assert {w: n for w, n in kernels.launches.items() if n} == dict(routes)
    assert seg.shape == (1, 512, 512) and np.isfinite(seg).all()


def test_predictor_384_launches_follow_the_routes(cuda):
    import collections

    import numpy as np

    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
          "image_processing": {"target_size": 384}}
    model = init_weights(SPEGNet(SPEGNetConfig.from_dict(mc)), torch.Generator().manual_seed(0))
    pred = Predictor(None, mc, None, device="cuda", model=model)
    kernels.reset_launches()
    seg, _ = pred.predict_arrays([np.zeros((300, 400, 3), np.uint8)])
    torch.cuda.synchronize()
    routes = collections.Counter(trunk_routes(HIERA_VARIANTS["large"], 96, torch.bfloat16,
                                              False))
    assert routes["fused_attention_lanes"] == 38 and routes["fused_block"] == 5
    routes.pop("plain")
    routes["fused_decoder_block"] = 1
    assert {w: n for w, n in kernels.launches.items() if n} == dict(routes)
    assert seg.shape == (1, 384, 384) and np.isfinite(seg).all()
