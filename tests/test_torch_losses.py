"""The port's dynamic canvas resize and COD loss (spegnet_tpu_torch/ops/resize.py,
spegnet_tpu_torch/losses.py) against the JAX package, in f32 on the CPU.

The same seeded numpy logits, ragged {0, 1} ground truths and sizes go
through both.  The loss and its gradient w.r.t. every logit map (torch
autograd against jax.grad) must agree to 1e-5 relative: f32 on both sides,
sums over at most 64^2-pixel canvases in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu import losses as jl
from spegnet_tpu.ops.resize import resize_bilinear_dynamic as j_resize_dynamic
from spegnet_tpu_torch import losses as tl
from spegnet_tpu_torch.ops.resize import resize_bilinear_dynamic

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resize_bilinear_dynamic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, h, w = 3, int(rng.integers(4, 40)), int(rng.integers(4, 40))
    canvas = (int(rng.integers(40, 80)), int(rng.integers(40, 80)))
    x = rng.standard_normal((b, h, w)).astype(np.float32)
    oh = rng.integers(1, canvas[0] + 1, b).astype(np.int32)
    ow = rng.integers(1, canvas[1] + 1, b).astype(np.int32)
    got, valid = resize_bilinear_dynamic(torch.from_numpy(x), torch.from_numpy(oh),
                                         torch.from_numpy(ow), canvas)
    want, wvalid = jax.vmap(lambda s, a, c: j_resize_dynamic(s, a, c, canvas))(
        jnp.asarray(x), jnp.asarray(oh), jnp.asarray(ow))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


def test_resize_bilinear_dynamic_is_interpolate_inside_the_canvas():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 12, 3)).astype(np.float32))
    oh, ow = torch.tensor([20, 7]), torch.tensor([9, 30])
    got, _ = resize_bilinear_dynamic(x, oh, ow, (32, 32))
    for i in range(2):
        ref = torch.nn.functional.interpolate(
            x[i:i + 1].permute(0, 3, 1, 2), size=(int(oh[i]), int(ow[i])), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)[0]
        np.testing.assert_allclose(got[i, : oh[i], : ow[i]].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert not got[i, oh[i]:].any() and not got[i, :, ow[i]:].any()


def _loss_inputs(rng, b=3, s=32):
    canvas = (64, 64)
    mask_hw = rng.integers(20, 65, (b, 2)).astype(np.int32)
    edge_hw = rng.integers(20, 65, (b, 2)).astype(np.int32)
    masks = np.zeros((b, *canvas), np.float32)
    edges = np.zeros((b, *canvas), np.float32)
    for i in range(b):
        masks[i, : mask_hw[i, 0], : mask_hw[i, 1]] = rng.random(mask_hw[i]) > 0.6
        edges[i, : edge_hw[i, 0], : edge_hw[i, 1]] = rng.random(edge_hw[i]) > 0.9
    preds = [rng.standard_normal((b, s * f, s * f, 1)).astype(np.float32) * 2
             for f in (1, 2, 4)]
    edge = rng.standard_normal((b, s // 2, s // 2, 1)).astype(np.float32) * 2
    return preds, edge, masks, edges, mask_hw, edge_hw


@pytest.mark.parametrize("weighted", [False, True])
def test_cod_loss_and_grad_match_jax(rng, weighted):
    preds, edge, masks, edges, mask_hw, edge_hw = _loss_inputs(rng)
    sw = np.asarray([1.0, 0.0, 1.0], np.float32) if weighted else None
    cfg_t, cfg_j = tl.LossConfig(), jl.LossConfig()

    leaves = [torch.from_numpy(a).requires_grad_() for a in (*preds, edge)]
    ld = tl.cod_loss(leaves[:3], leaves[3], torch.from_numpy(masks), torch.from_numpy(edges),
                     torch.from_numpy(mask_hw), torch.from_numpy(edge_hw), cfg_t,
                     None if sw is None else torch.from_numpy(sw))
    ld["loss"].backward()

    def jloss(p0, p1, p2, e):
        out = jl.cod_loss([p0, p1, p2], e, jnp.asarray(masks), jnp.asarray(edges),
                          jnp.asarray(mask_hw), jnp.asarray(edge_hw), cfg_j,
                          None if sw is None else jnp.asarray(sw))
        return out["loss"], out

    (jval, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a) for a in (*preds, edge)])
    for k in ("loss", "seg_loss", "edge_loss"):
        np.testing.assert_allclose(ld[k].item(), float(jout[k]), rtol=RTOL, err_msg=k)
    for i, (t, g) in enumerate(zip(leaves, jgrads)):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=RTOL,
                                   atol=RTOL * np.abs(g).max(), err_msg=f"logits {i}")


def test_loss_config_from_dict_keeps_defaults():
    cfg = tl.LossConfig.from_dict({"scale_weights": [0.1, 0.2, 0.7], "edge_weight": 0.5})
    assert cfg.scale_weights == (0.1, 0.2, 0.7) and cfg.edge_weight == 0.5
    assert cfg.bce_weight == jl.LossConfig().bce_weight
