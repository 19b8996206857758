"""f32 compute (``use_amp: false``) of the port against the JAX package.

In f32 the JAX package takes neither Morton order nor the T-block nor the
transition front (bf16 only, spegnet_tpu/models/hiera.py:806-812, :509-517,
:854-866); its gen-1 block (#7) takes the divisible windows of 16-64
tokens, in its int8 form (#12) where ``int8_encoder`` allows, and
``fused_attention_lanes`` (#9) the rest of the decomposed blocks, all at
dt = f32 with the erf GELU.  On the CPU the port's wrappers run their plain
versions.  The f32 kernel chains (ops/fused_block.block_cuda_f32, and
ops/fused_block_t_i8.block_cuda_i8 on f32) are run here with every launcher
of spegnet_tpu_torch.kernels they call replaced by a plain stand-in that
binds its call to the launcher's signature, so their wiring (which weight,
which residual, which GELU, which output dtype) is held on the CPU; the
kernels themselves are held against the same plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

* The f32 gen-1 autograd Function (forward: the chain; backward: autograd of
  ``block_reference``, as JAX's custom_vjp) against JAX's ``fused_block``
  with its Pallas kernel in interpret mode: the output (atol / rtol 1e-4,
  tests/test_torch_blocks.py) and every gradient (atol 2e-3, rtol 1e-3,
  tests/test_torch_backward.py).
* The int8 gen-1 chain on f32 against the plain int8 version (the same
  plain arithmetic, so bit-equal); the plain version's weight and activation
  codes and scales in f32 bit-equal to JAX's.
* A small SPEGNet in f32 on a 2^k grid (128x128, grid 32), kernels=True,
  against the JAX model in f32 with its gen-1 and lanes gates open (Pallas
  in interpret mode): every block on JAX's f32 route, each wrapper called
  once per block of its route, outputs within atol / rtol 1e-4
  (tests/test_torch_model.py: f32 on both sides, sums in other orders).
* The engines turn TF32 off for cuBLAS and cuDNN in an f32 run and leave
  it as it was in a bf16 run.
"""

import collections
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spegnet_tpu.models import hiera as jhiera
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.ops import fused_block as jfb
from spegnet_tpu.ops import fused_block_i8 as jfb_i8
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import pallas_attention as jpa
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import fused_block as tfb
from spegnet_tpu_torch.ops import fused_block_i8 as tfb_i8
from spegnet_tpu_torch.ops import fused_block_t as tfbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as tfbt_i8
from spegnet_tpu_torch.ops import pallas_attention as tpa
from spegnet_tpu_torch.ops.attention import attention_reference
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax, to_torch
from tests.test_torch_backward import _unpad_rows
from tests.test_torch_blocks import _jax_gen1_weights, _port_block, _weights

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=2e-3, rtol=1e-3)

# Stage 1 on gen-1 (window 8), a global block in stage 2 on the lanes
# kernel (L 256 at grid 16), stages 2-3 on gen-1 (window 4), three plain
# transitions: every f32 route at width 16 on a 128x128 input.
_F32 = dict(embed_dim=16, num_heads=1, stages=(1, 3, 3, 1), global_att_blocks=(2,),
            window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 4, 2))
jhiera.HIERA_VARIANTS["_torch_f32"] = jhiera.HieraConfig(**_F32)
thiera.HIERA_VARIANTS["_torch_f32"] = thiera.HieraConfig(**_F32)
SMALL_HEAD = dict(fusion_channels=32, context_channels=16, edge_channels=8,
                  decoder_channels=(16, 8, 4))


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, its gen-1 gate open on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    yield


def _plain_launchers(monkeypatch):
    """Replace the launchers of the f32 chains with plain PyTorch, each call
    bound to the real launcher's signature; returns the calls per launcher."""
    calls = collections.Counter()

    def stub(name, fn):
        sig = inspect.signature(getattr(kernels, name))

        def launcher(*a, **kw):
            sig.bind(*a, **kw)
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(kernels, name, launcher)

    def gemm_f32(a, w, bias=None, residual=None, gelu=None):
        y = F.linear(a, w, bias)
        if gelu is not None:
            y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none")
        return y if residual is None else residual + y

    def gemm_i8(a, sa, w, sw, bias, residual=None, gelu=False, sw_first=True,
                out_dtype=torch.bfloat16, approx_gelu=True):
        y = tfbt_i8.qdot(a, sa[:, None], w, sw, bias, sw_first)
        if gelu:
            y = F.gelu(y, approximate="tanh" if approx_gelu else "none")
        y = y.to(out_dtype)
        return y if residual is None else residual + y

    def codes(q_s):
        return q_s[0], q_s[1][:, 0]

    stub("layernorm_f32", tfbt.layer_norm)
    stub("gemm_f32", gemm_f32)
    stub("attention", lambda q, k, v, scale: attention_reference(q, k, v, scale).contiguous())
    stub("layernorm_q8", lambda x, w, b, eps: codes(tfbt_i8.quant_tokens(
        tfbt.layer_norm(x, w, b, eps))))
    stub("quant_rows", lambda x: codes(tfbt_i8.quant_tokens(x)))
    stub("gemm_i8", gemm_i8)
    return calls


# ---------------------------------------------------------------------------
# the f32 gen-1 block (#7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,heads,d,l,nw,approx", [
    (32, 2, 16, 16, 8, False),
    (32, 2, 16, 64, 4, True),      # the tanh GELU the chain also takes
    (128, 16, 8, 64, 4, False),    # 16 heads (the stage-4 head count)
])
def test_f32_gen1_function_matches_jax(rng, interpret, monkeypatch, c, heads, d, l, nw,
                                       approx):
    calls = _plain_launchers(monkeypatch)
    w = _weights(rng, c, heads, d)
    x = rng.standard_normal((nw, l, c)).astype(np.float32)
    g = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, *(t.numpy() for t in _port_block(w)))]
    y = tfb.BlockF32Function.apply(leaves[0], heads, d ** -0.5, 1e-6, approx, *leaves[1:])
    y.backward(torch.from_numpy(g))
    assert calls == {"layernorm_f32": 2, "gemm_f32": 4, "attention": 1}

    jw, hp = _jax_gen1_weights(w, heads, d)
    y_j, vjp = jax.vjp(lambda xx, ww: jfb.fused_block(xx, ww, heads, hp, d ** -0.5, 1e-6,
                                                      approx), jnp.asarray(x), jw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    dx, dw = vjp(jnp.asarray(g))
    row = lambda a: np.asarray(a)[0]  # noqa: E731
    ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2 = dw
    wproj = np.asarray(wproj).T.reshape(c, heads, hp)[:, :, :d].reshape(c, heads * d)
    want = [np.asarray(dx), row(ln1s), row(ln1b), _unpad_rows(np.asarray(wqkv).T, heads, d, 3),
            _unpad_rows(row(bqkv), heads, d, 3), wproj, row(bproj), row(ln2s), row(ln2b),
            np.asarray(wfc1).T, row(bfc1), np.asarray(wfc2).T, row(bfc2)]
    for name, leaf, b in zip(("x",) + tfbt.BlockWeights._fields, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), b, err_msg=name, **GRAD_TOL)


def test_f32_gen1_on_cpu_is_the_plain_version(rng):
    """The wrapper takes its plain version for a CPU tensor, launches
    nothing, and autograd differentiates it."""
    c, heads, d, l = 32, 2, 16, 16
    w = _port_block(_weights(rng, c, heads, d))
    x = torch.from_numpy(rng.standard_normal((4, l, c)).astype(np.float32))
    before = dict(kernels.launches)
    got = tfb.fused_block(x, w, heads, d ** -0.5, approx_gelu=False)
    assert torch.equal(got, tfb.block_reference(x, w, heads, d ** -0.5, approx_gelu=False))
    assert kernels.launches == before


# ---------------------------------------------------------------------------
# the int8 gen-1 block in f32 (#12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nw,l,c,heads,d,approx", [
    (8, 64, 128, 2, 64, False),
    (4, 16, 128, 16, 8, False),
    (4, 64, 128, 2, 64, True),
])
def test_f32_int8_gen1_chain_matches_plain(rng, monkeypatch, nw, l, c, heads, d, approx):
    calls = _plain_launchers(monkeypatch)
    w = tfb_i8.pack_i8(_port_block(_weights(rng, c, heads, d)))
    x = torch.from_numpy((rng.standard_normal((nw, l, c)) * 0.5).astype(np.float32))
    got = tfbt_i8.block_cuda_i8(x.reshape(1, nw * l, c), w, heads, l, d ** -0.5, 1e-6,
                                sw_first=False, approx_gelu=approx).reshape(nw, l, c)
    assert calls == {"layernorm_q8": 2, "gemm_i8": 4, "quant_rows": 2, "attention": 1}
    assert got.dtype == torch.float32
    want = tfb_i8.block_i8_plain(x, w, heads, d ** -0.5, 1e-6, approx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_f32_int8_codes_match_jax(rng):
    """f32 weights pack to JAX's codes and scales, and f32 activations (not
    bf16-valued) quantize to JAX's, bit for bit."""
    c, heads, d, hp = 128, 2, 64, 128
    w = _weights(rng, c, heads, d)
    port = tfb_i8.pack_i8(_port_block(w))
    jw, _ = _jax_gen1_weights(w, heads, d)
    jq = jfb_i8.pack_i8(jw)
    row = lambda a: np.asarray(a)[0]  # noqa: E731
    pairs = [
        (port.wqkv, _unpad_rows(np.asarray(jq.wqkv_q).T, heads, d, 3)),
        (port.sqkv, _unpad_rows(row(jq.sqkv), heads, d, 3)),
        (port.bqkv, _unpad_rows(row(jq.bqkv), heads, d, 3)),
        (port.wproj, np.asarray(jq.wproj_q).reshape(heads, hp, c)[:, :d].reshape(
            heads * d, c).T),
        (port.sproj, row(jq.sproj)),
        (port.wfc1, np.asarray(jq.wfc1_q).T), (port.sfc1, row(jq.sfc1)),
        (port.wfc2, np.asarray(jq.wfc2_q).T), (port.sfc2, row(jq.sfc2)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want)
    x = (rng.standard_normal((64, 4 * c)) * rng.uniform(0.01, 30, (64, 1))).astype(np.float32)
    q, s = tfbt_i8.quant_tokens(torch.from_numpy(x))
    jq_x, js = jfb_i8._quant_tokens_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# a small SPEGNet in f32 on a 2^k grid
# ---------------------------------------------------------------------------

def _perturb(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if path[-1] == "var":
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)


def test_spegnet_f32_matches_jax_with_gates_open(interpret, monkeypatch):
    rng = np.random.default_rng(0)
    jax_calls = collections.Counter()
    for mod, name in ((jfb, "fused_block"), (jpa, "fused_attention_lanes")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                            jax_calls.update([_n]) or _fn(*a, **k))
    # JAX's lanes gate without its TPU-backend test: the port's rule
    monkeypatch.setattr(jpa, "lanes_supported", tpa.lanes_supported)
    model = JaxSPEGNet(JaxConfig(variant="_torch_f32", **SMALL_HEAD))
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    variables = _perturb(jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                         rng)
    jax_calls.clear()
    want = jax.device_get(model.apply(variables, jnp.asarray(x)))

    routes = collections.Counter(thiera.trunk_routes(thiera.HIERA_VARIANTS["_torch_f32"], 32,
                                                     torch.float32, False))
    assert routes == {"fused_block": 4, "fused_attention_lanes": 1, "plain": 3}
    assert jax_calls == {"fused_block": 4, "fused_attention_lanes": 1}

    port = SPEGNet(SPEGNetConfig(variant="_torch_f32", **SMALL_HEAD)).eval()
    port.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    calls = collections.Counter()
    for name in ("fused_block_t", "fused_block", "qpool_front", "fused_attention_lanes"):
        fn = getattr(thiera, name)
        monkeypatch.setattr(thiera, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.update([_n]) or _fn(*a, **k))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    routes.pop("plain")
    assert calls == routes
    for g, w in zip(got["predictions"], want["predictions"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_allclose(got["edge"].numpy(), want["edge"], **TOL)
    for k in ("context", "fused", "edge_features"):
        np.testing.assert_allclose(got["features"][k].numpy(), want["features"][k], **TOL)


# ---------------------------------------------------------------------------
# TF32 in the engines
# ---------------------------------------------------------------------------

def _engine(kind, dtype):
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer

    mc = {"encoder": {"variant": "test", "checkpoint_path": None}, "compute_dtype": dtype,
          "image_processing": {"target_size": 64}}
    model = init_weights(SPEGNet(SPEGNetConfig.from_dict(mc)), torch.Generator().manual_seed(0))
    if kind == "predict":
        return Predictor(None, mc, None, device="cpu", model=model)
    if kind == "evaluate":
        return Evaluator(None, None, mc, batch_size=1, canvas_buckets=(64,), device="cpu",
                         model=model)
    return Trainer({"model": mc, "training": {"batch_size": 1, "num_epochs": 1,
                                              "val_ratio": 0}}, None, device="cpu",
                   model=model)


@pytest.mark.parametrize("kind", ["predict", "evaluate", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engines_turn_tf32_off_for_f32(monkeypatch, kind, dtype):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _engine(kind, dtype)
    off = dtype == "float32"
    assert torch.backends.cuda.matmul.allow_tf32 is not off
    assert torch.backends.cudnn.allow_tf32 is not off
