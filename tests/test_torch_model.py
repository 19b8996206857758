"""The whole port (spegnet_tpu_torch SPEGNet) against the JAX SPEGNet in f32.

JAX weights come from ``model.init`` (perturbed so biases, BN statistics and
position embeddings are non-trivial) and are carried across by
``state_dict_from_jax``; both models see the same numpy input.  Both port
compositions are checked: ``kernels=True`` (the trunk on the JAX package's
f32 routes -- gen-1 blocks, lanes attention and the decomposed blocks, no
Morton order, T-block or transition front, which are bf16 only -- through
the kernel wrappers, which take their plain versions on the CPU; and on a
64x96 input, a grid that is not 2^k) and ``kernels=False`` (the decomposed
path).  The bf16 token-major trunk is held against JAX's bf16 model in
tests/test_torch_bf16.py.

Tolerance 1e-4 absolute + 1e-4 relative on logits of magnitude up to ~10:
f32 throughout, differences come from summation order across ~10 layers
of matmuls, convolutions and resizes (observed ~2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.models import hiera as jhiera
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.utils.torch_import import export_spegnet_state_dict
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils.weights import (
    init_weights,
    state_dict_from_jax,
    to_torch,
    trunk_state_dict_from_jax,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)

# A _parity_small-like configuration: every stage shape Hiera-L has (windowed
# stages, a global block inside stage 3, three transitions) at width 8.
_SMALL = dict(embed_dim=8, num_heads=1, stages=(1, 2, 3, 1), global_att_blocks=(4,),
              window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 4, 2))
jhiera.HIERA_VARIANTS["_torch_small"] = jhiera.HieraConfig(**_SMALL)
thiera.HIERA_VARIANTS["_torch_small"] = thiera.HieraConfig(**_SMALL)
SMALL_HEAD = dict(fusion_channels=32, context_channels=16, edge_channels=8,
                  decoder_channels=(16, 8, 4))


def _perturb(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if path[-1] == "var":
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)


@pytest.fixture(scope="module", params=[("test", {}), ("_torch_small", SMALL_HEAD)],
                ids=["test", "small"])
def jax_case(request):
    variant, head = request.param
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    model = JaxSPEGNet(JaxConfig(variant=variant, **head))
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _perturb(variables, rng)
    out = jax.jit(model.apply)(variables, jnp.asarray(x))
    return variant, head, x, variables, jax.device_get(out)


def test_state_dict_from_jax_equals_export(jax_case):
    _, _, _, variables, _ = jax_case
    got = state_dict_from_jax(variables)
    want = export_spegnet_state_dict(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "decomposed"])
def test_spegnet_matches_jax(jax_case, kernels):
    variant, head, x, variables, want = jax_case
    model = SPEGNet(SPEGNetConfig(variant=variant, **head), kernels=kernels).eval()
    model.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got["predictions"]) == 3
    for g, w in zip(got["predictions"], want["predictions"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_allclose(got["edge"].numpy(), want["edge"], **TOL)
    for k in ("context", "fused", "edge_features"):
        np.testing.assert_allclose(got["features"][k].numpy(), want["features"][k], **TOL)


def test_kernel_path_refuses_uncovered_geometry():
    """The kernel path takes any input whose sides are multiples of 32 and
    refuses the rest, as the JAX package does, rather than quietly taking
    another path."""
    model = SPEGNet(SPEGNetConfig(variant="test")).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divisible by 32"):
        with torch.no_grad():
            model(torch.zeros(1, 64, 80, 3))


def test_kernel_path_runs_grid_that_is_not_2k(jax_case):
    """A 64x96 input (patch grid 16x24) runs on the kernel path, its blocks
    routed by JAX's f32 gates (gen-1, lanes and the decomposed blocks, on
    the raster layout), and matches the JAX model."""
    variant, head, _, variables, _ = jax_case
    x = np.random.default_rng(3).standard_normal((2, 64, 96, 3)).astype(np.float32)
    want = jax.device_get(jax.jit(JaxSPEGNet(JaxConfig(variant=variant, **head)).apply)(
        variables, jnp.asarray(x)))
    model = SPEGNet(SPEGNetConfig(variant=variant, **head)).eval()
    model.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    assert not thiera.morton_grid(thiera.HIERA_VARIANTS[variant], 16, 24)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got["predictions"], want["predictions"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_allclose(got["edge"].numpy(), want["edge"], **TOL)


def test_init_weights_is_seeded():
    a = init_weights(SPEGNet(SPEGNetConfig(variant="test")), torch.Generator().manual_seed(3))
    b = init_weights(SPEGNet(SPEGNetConfig(variant="test")), torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.encoder.encoder.blocks[0].attn.qkv.weight.detach()
    assert 0.5 < float(w.std() * w.shape[1] ** 0.5) < 1.5


@pytest.mark.slow
def test_hiera_large_trunk_matches_jax():
    """Hiera-L at full width (C 144 -> 1152, 48 blocks) on a 64^2 input,
    decomposed path (stage-3 windows of 16 exceed the 4x4 grid there)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    jm = jhiera.Hiera(variant="large")
    params = _perturb(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want = jm.apply(params, jnp.asarray(x))
    tm = thiera.Hiera("large").eval()
    tm.load_state_dict(to_torch(trunk_state_dict_from_jax(params["params"])), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), kernels=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=5e-4)
