"""The Hopper kernels against their plain PyTorch versions, in bf16, at every
main-path geometry of Hiera-L 512^2 inference and training (batch 1): the
forward kernels against the plain forward, the backward kernels against
bf16 autograd of the plain forward, for dx and every weight gradient, and
the int8 encoder's kernels against their plain int8 versions
(kernel_check.i8_ok); the int8 Predictor's launches.
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
