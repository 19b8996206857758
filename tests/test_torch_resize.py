"""The port's resizes (spegnet_tpu_torch/ops/resize.py) against the JAX
package's (spegnet_tpu/ops/resize.py), same inputs from numpy, in f32.

Tolerance 1e-5 absolute on unit-scale data: both sides interpolate in f32
with at most 4 (bilinear) / 16 (bicubic) taps per output, summed in
different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.ops import resize as jr
from spegnet_tpu_torch.ops import resize as tr
from spegnet_tpu_torch.models.hiera import compute_pos_embed

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("in_size,out_size,aa", [
    (37, 64, False), (64, 37, False), (96, 40, True), (40, 96, True), (512, 512, True),
])
def test_resize_matrix_np_identical(in_size, out_size, aa):
    np.testing.assert_array_equal(tr.resize_matrix_np(in_size, out_size, aa),
                                  jr.resize_matrix_np(in_size, out_size, aa))


@pytest.mark.parametrize("shape,out_hw,aa", [
    ((2, 16, 24, 3), (32, 48), False),   # 2x upsample (decoder)
    ((2, 16, 16, 5), (64, 64), False),   # 4x upsample (edge features)
    ((1, 40, 30, 3), (17, 23), False),   # downscale, no antialias
    ((1, 40, 30, 3), (17, 23), True),    # downscale, antialias (input image)
    ((1, 20, 18, 2), (33, 29), True),    # antialias is a no-op when upscaling
])
def test_bilinear_matches_jax(rng, shape, out_hw, aa):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jr.resize_bilinear(jnp.asarray(x), out_hw, antialias=aa))
    got = tr.resize_bilinear(torch.from_numpy(x), out_hw, antialias=aa).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bilinear_2d_map(rng):
    """The predictor resizes [H, W] probability maps to output_size."""
    x = rng.random((64, 64)).astype(np.float32)
    want = np.asarray(jr.resize_bilinear(jnp.asarray(x), (40, 52)))
    got = tr.resize_bilinear(torch.from_numpy(x), (40, 52)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("in_hw,out_hw", [((7, 7), (128, 128)), ((7, 7), (16, 16)),
                                          ((14, 14), (32, 32)), ((7, 7), (7, 7))])
def test_bicubic_matches_jax(rng, in_hw, out_hw):
    x = rng.standard_normal((1, *in_hw, 6)).astype(np.float32)
    want = np.asarray(jr.resize_bicubic(jnp.asarray(x), out_hw))
    got = tr.resize_bicubic(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_position_embedding_matches_jax(rng):
    """F.interpolate(bicubic) background + tiled window embed == the JAX
    compute_pos_embed (Hiera-L: 7x7 background, 8x8 window, 128^2 grid)."""
    from spegnet_tpu.models.hiera import compute_pos_embed as jax_pos

    bkg = rng.standard_normal((7, 7, 12)).astype(np.float32)
    win = rng.standard_normal((8, 8, 12)).astype(np.float32)
    want = np.asarray(jax_pos(jnp.asarray(bkg), jnp.asarray(win), (128, 128)))
    got = compute_pos_embed(torch.from_numpy(bkg.transpose(2, 0, 1)[None]),
                            torch.from_numpy(win.transpose(2, 0, 1)[None]), (128, 128))
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)
