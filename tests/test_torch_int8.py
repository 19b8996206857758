"""The port's W8A8 encoder (spegnet_tpu_torch/ops/fused_block_t_i8.py,
ops/fused_block_i8.py, the int8 routing of models/hiera.py) against the JAX
package's int8 kernels.

* Quantizers: codes and scales bit-identical to JAX's on random bf16
  values and on rows built to land on exact .5 ties (both round half to
  even).
* Each plain version (the wrappers take it for CPU tensors) against the
  JAX Pallas kernel in interpret mode, f32, same numpy weights (the JAX side
  zero-padded to its head widths, including a head_dim < hp case), by the
  JAX package's own rule (tests/test_int8_block.py:56-61): more than 99% of
  elements within 5e-4 and none more than 0.2 apart -- the two sum their
  f32 products in different orders, so a value on a rounding knife-edge may
  take the neighbouring int8 code and move its output by one dequant step.
* The gate table at Hiera-L 512^2: the port's route of every block equals
  the one JAX's gates give (40 int8 T-blocks, 2 int8 fronts, 3 int8 gen-1
  blocks).
* The whole SPEGNet, bf16, on a small Hiera-L-shaped variant, with
  ``int8_encoder`` reaching both models from a config dict: every int8
  kernel runs on both sides, and the port's masks match JAX's int8 masks
  far more closely than JAX's bf16 masks; a train-mode forward ignores the
  flag; the packed weights are cached and dropped on reload.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.models import hiera as jhiera
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.ops import fused_block as jfb
from spegnet_tpu.ops import fused_block_i8 as jfb_i8
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_block_t_i8 as jfbt_i8
from spegnet_tpu_torch.engine.predictor import Predictor
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import fused_block_i8 as tfb_i8
from spegnet_tpu_torch.ops import fused_block_t as tfbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as tfbt_i8
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax, to_torch
from tests.test_torch_blocks import _pad_proj_cols, _pad_qkv_rows, _port_block, _weights

torch.set_num_threads(1)

# Hiera-L's structure at small width: pow2 windows, a global block in stage
# 3, three transitions; C 48 / 96 / 192 / 384 with 2 / 4 / 8 / 16 heads
# (head_dim 24, padded to 32 and 128 on the JAX side), so stage 1 and t12
# miss the int8 gates (C % 32) as Hiera-L's C 144 does, and stage 4 (16
# heads) takes the gen-1 int8 block.
_I8_SMALL = dict(embed_dim=48, num_heads=2, stages=(1, 2, 3, 2), global_att_blocks=(4,),
                 window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 8, 4))
jhiera.HIERA_VARIANTS["_torch_i8_small"] = jhiera.HieraConfig(**_I8_SMALL)
thiera.HIERA_VARIANTS["_torch_i8_small"] = thiera.HieraConfig(**_I8_SMALL)
SMALL_HEAD = dict(fusion_channels=32, context_channels=16, edge_channels=8,
                  decoder_channels=(16, 8, 4))
I8_WRAPPERS = ("fused_block_t_i8", "qpool_front_i8", "fused_block_i8")


@pytest.fixture
def interpret(monkeypatch):
    """JAX's kernels in interpret mode, and its kernel gates open on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    yield


def _close_i8(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert float((diff > 5e-4).mean()) < 0.01, float((diff > 5e-4).mean())
    assert float(diff.max()) < 0.2, float(diff.max())


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def _tie_rows(rng, rows, k):
    """bf16-exact rows whose absmax is 127 * 2^e: the scale is 2^e, so every
    entry k + 0.5 (times 2^e) is an exact rounding tie."""
    out = np.zeros((rows, k), np.float32)
    for r in range(rows):
        e = float(2.0 ** rng.integers(-6, 3))
        vals = (rng.integers(-126, 126, k) + 0.5) * e
        vals[rng.integers(k)] = 127 * e * rng.choice([-1, 1])
        out[r] = vals
    return out


def _bf16_np(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def test_quantizers_match_jax_bitwise(rng):
    w = _bf16_np(rng.standard_normal((48, 96)).astype(np.float32) * 0.3)
    ties = _tie_rows(rng, 16, 96)
    for a in (w, ties, np.zeros((2, 32), np.float32)):
        q, s = tfbt_i8.quantize_rows(torch.from_numpy(a).to(torch.bfloat16))
        jq, js = jfbt_i8.quantize_rows(jnp.asarray(a, jnp.bfloat16))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:, 0])
        qc, sc = tfb_i8.quantize_cols(torch.from_numpy(a.T.copy()))
        jqc, jsc = jfb_i8.quantize_cols(jnp.asarray(a.T))
        np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc)[0])
        qt, st = tfbt_i8.quant_tokens(torch.from_numpy(a))
        jqt, jst = jfbt_i8._quant_tokens_ref(jnp.asarray(a))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(jqt))
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    # ties round half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    q, _ = tfbt_i8.quant_tokens(torch.tensor([[127.0, 0.5, 1.5, -2.5, 3.5]]))
    assert q.tolist() == [[127, 0, 2, -2, 4]]


def test_qdot_is_exact_at_full_scale():
    """All-127 codes over K = 4608 (Hiera-L's fc2) sum to 7.4e7: exact."""
    a = torch.full((2, 4608), 127, dtype=torch.int8)
    acc = tfbt_i8.qdot(a, torch.ones(2, 1), a, torch.ones(2), torch.zeros(2))
    assert acc.tolist() == [[127 * 127 * 4608.0] * 2] * 2


# ---------------------------------------------------------------------------
# plain versions vs the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _jax_t_weights(w, heads, d):
    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    return jfbt.TBlockWeights(
        col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
        jnp.asarray(_pad_proj_cols(w["wproj"], heads, d, hp)), col(w["bproj"]),
        col(w["ln2_w"]), col(w["ln2_b"]), jnp.asarray(w["wfc1"]), col(w["bfc1"]),
        jnp.asarray(w["wfc2"]), col(w["bfc2"])), hp


T_CASES = [  # (C, heads, d, L, tokens)
    (32, 2, 16, 16, 256),     # windows of 16, packed into masked chunks
    (32, 2, 16, 256, 1024),   # windows of 256
    (32, 2, 16, 256, 256),    # global
    (96, 4, 24, 64, 256),     # head_dim 24 < hp 32
]


@pytest.mark.parametrize("c,heads,d,l,n", T_CASES)
def test_block_t_i8_matches_jax_kernel(rng, interpret, c, heads, d, l, n):
    w = _weights(rng, c, heads, d)
    x = (rng.standard_normal((2, n, c)) * 0.5).astype(np.float32)
    got = tfbt_i8.fused_block_t_i8(torch.from_numpy(x), tfbt_i8.pack_i8(_port_block(w)),
                                   heads, l, d ** -0.5, 1e-6, approx_gelu=False).numpy()
    jw, hp = _jax_t_weights(w, heads, d)
    xt = jnp.asarray(x.transpose(0, 2, 1))
    ker = jfbt_i8.fused_block_t_i8(xt, jfbt_i8.pack_i8(jw), heads, hp, l, d ** -0.5, 1e-6,
                                   False)
    _close_i8(got, np.asarray(ker).transpose(0, 2, 1))


@pytest.mark.parametrize("cin,heads,d,l,n", [
    (32, 2, 16, 16, 256),     # t23-like windows
    (32, 2, 16, 256, 1024),   # L 256
    (32, 16, 8, 64, 256),     # 16 heads, head_dim 8 < hp 16 (t34-like)
])
def test_qpool_front_i8_matches_jax_kernel(rng, interpret, cin, heads, d, l, n):
    cout = heads * d
    w = _weights(rng, cin, heads, d, cout=cout)
    x = (rng.standard_normal((2, n, cin)) * 0.5).astype(np.float32)
    wts = tfbt.QPoolWeights(*[torch.from_numpy(w[k]) for k in (
        "ln1_w", "ln1_b", "wqkv", "bqkv", "wsc", "bsc")])
    o, sc = tfbt_i8.qpool_front_i8(torch.from_numpy(x), tfbt_i8.pack_qpool_i8(wts), heads,
                                   l, d ** -0.5)
    hp = jfbt.round_hp(d)
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    col = lambda a: jnp.asarray(a.reshape(-1, 1))  # noqa: E731
    jw = jfbt.QPoolWeights(col(w["ln1_w"]), col(w["ln1_b"]), jnp.asarray(wq), col(bq),
                           jnp.asarray(w["wsc"]), col(w["bsc"]))
    jo, jsc = jfbt_i8.qpool_front_i8(jnp.asarray(x.transpose(0, 2, 1)),
                                     jfbt_i8.pack_qpool_i8(jw), heads, hp, l, d ** -0.5,
                                     1e-6)
    jo = np.asarray(jo).reshape(2, heads, hp, n // 4)[:, :, :d]
    _close_i8(o.numpy(), jo.reshape(2, heads * d, n // 4).transpose(0, 2, 1))
    _close_i8(sc.numpy(), np.asarray(jsc).transpose(0, 2, 1))


@pytest.mark.parametrize("nw,l,c,heads,d", [
    (8, 64, 128, 2, 64),      # head_dim 64 < hp 128
    (4, 16, 128, 16, 8),      # 16 heads: the stage-4 shape class
])
def test_block_i8_matches_jax_gen1_kernel(rng, interpret, nw, l, c, heads, d):
    w = _weights(rng, c, heads, d)
    x = (rng.standard_normal((nw, l, c)) * 0.5).astype(np.float32)
    got = tfb_i8.fused_block_i8(torch.from_numpy(x), tfb_i8.pack_i8(_port_block(w)), heads,
                                d ** -0.5, 1e-6, approx_gelu=False).numpy()
    hp = 128
    wq, bq = _pad_qkv_rows(w["wqkv"], w["bqkv"], heads, d, hp)
    row = lambda a: jnp.asarray(a.reshape(1, -1))  # noqa: E731
    jw = jfb.BlockWeights(
        row(w["ln1_w"]), row(w["ln1_b"]), jnp.asarray(wq.T), row(bq),
        jnp.asarray(_pad_proj_cols(w["wproj"], heads, d, hp).T), row(w["bproj"]),
        row(w["ln2_w"]), row(w["ln2_b"]), jnp.asarray(w["wfc1"].T), row(w["bfc1"]),
        jnp.asarray(w["wfc2"].T), row(w["bfc2"]))
    ker = jfb_i8.fused_block_i8(jnp.asarray(x), jfb_i8.pack_i8(jw), heads, hp, d ** -0.5,
                                1e-6, False)
    _close_i8(got, ker)


def test_i8_wrappers_refuse_other_devices():
    w = tfbt_i8.pack_i8(_port_block(_weights(np.random.default_rng(0), 32, 2, 16)))
    x = torch.zeros((1, 256, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfbt_i8.fused_block_t_i8(x, w, 2, 16, 0.25)
    with pytest.raises(ValueError, match="no kernel"):
        tfb_i8.fused_block_i8(x.reshape(16, 16, 32), w, 2, 0.25)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _jax_routes(cfg, hw):
    """Each Hiera block's kernel under the JAX package's gates (bf16, int8
    on, spegnet_tpu/models/hiera.py:409-421, :488-497, :597-609, :854-935)."""
    bf = jnp.bfloat16
    out = []
    for sp in thiera.block_specs(cfg):
        l = sp.window * sp.window if sp.window else hw * hw
        n = hw * hw
        if sp.q_pool:
            out.append("qpool_front_i8" if jfbt_i8.qpool_supported_i8(
                sp.dim, sp.heads, l, n, bf, batch=2) else "qpool_front")
            hw //= 2
        elif jfbt.supported(sp.dim, sp.heads, l, n, bf, batch=2):
            out.append("fused_block_t_i8" if jfbt_i8.supported_i8(
                sp.dim, sp.heads, l, n, bf, batch=2) else "fused_block_t")
        else:
            out.append("fused_block_i8" if jfb_i8.supported_i8(
                2 * n // l, l, sp.dim, bf, batch_rows=2 * n // l) else "fused_block")
    return out


@pytest.mark.parametrize("variant,hw", [("large", 128), ("_torch_i8_small", 64)])
def test_int8_routes_match_jax_gates(interpret, variant, hw):
    cfg = thiera.HIERA_VARIANTS[variant]
    port = thiera.trunk_routes(cfg, hw, torch.bfloat16, True)
    assert port == _jax_routes(cfg, hw)
    if variant == "large":
        assert collections.Counter(port) == {"fused_block_t_i8": 40, "qpool_front_i8": 2,
                                             "fused_block_i8": 3, "fused_block_t": 2,
                                             "qpool_front": 1}
    assert not any(r.endswith("_i8") for r in thiera.trunk_routes(cfg, hw, torch.bfloat16,
                                                                  False))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _random_variables(shapes, rng):
    """Seeded variables of the JAX model's tree: kernels fan-in scaled,
    norm scales near 1, BN variances in [0.5, 1.5], the rest small."""
    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(a.shape) * np.prod(a.shape[:-1]) ** -0.5).astype(
                np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_int8_case():
    """The JAX SPEGNet with ``int8_encoder`` on the small variant at 256^2,
    bf16, its Pallas kernels in interpret mode (its decoder block 2 on the
    decomposed path, whose parity with the port's is tests/test_torch_decoder's
    business, to keep this under a minute): the input, the variables, the
    output and how often each JAX int8 kernel ran."""
    from spegnet_tpu.ops import fused_decoder as jfd

    mp = pytest.MonkeyPatch()
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    calls = collections.Counter()

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name + "@" + mod.__name__] += 1
            return fn(*a, **kw)
        mp.setattr(mod, name, wrapped)

    mp.setattr(jfbt.pl, "pallas_call", interp)
    mp.setattr(jfbt, "INTERPRET", True)
    mp.setattr(jfd, "decoder_supported", lambda *a, **k: False)
    counting(jfbt_i8, "_forward_i8")
    counting(jfbt_i8, "_qpool_forward_i8")
    counting(jfb_i8, "_forward_i8")
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((1, 256, 256, 3)).astype(np.float32)
        model = JaxSPEGNet(JaxConfig(variant="_torch_i8_small", compute_dtype="bfloat16",
                                     int8_encoder=True, **SMALL_HEAD))
        variables = _random_variables(
            jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
        calls.clear()
        out = model.apply(variables, jnp.asarray(x))
        out = {"fused": np.asarray(out["features"]["fused"], np.float32),
               "mask": np.asarray(jax.nn.sigmoid(out["predictions"][-1].astype(
                   jnp.float32)))}
        yield x, variables, out, dict(calls)
    finally:
        mp.undo()


def _port_config(model_config):
    """The config a user's model section gives (from_dict reads no head
    widths, as in the JAX package), at the small head widths."""
    return dataclasses.replace(SPEGNetConfig.from_dict(model_config), **SMALL_HEAD)


def _port_model(variables, model_config):
    model = SPEGNet(_port_config(model_config)).eval()
    model.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    return model.to_compute()


def _count_calls(monkeypatch, names=I8_WRAPPERS):
    calls = collections.Counter()
    for name in names:
        mod = tfb_i8 if name == "fused_block_i8" else tfbt_i8
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


MODEL_CONFIG = {"encoder": {"variant": "_torch_i8_small"}, "compute_dtype": "bfloat16"}


def test_int8_config_reaches_the_model(monkeypatch):
    """Each flag of the config dict reaches its model: int8_decoder reaches
    decoder block 2's dispatch in eval mode and not in train mode (its
    arithmetic is tests/test_torch_decoder_i8.py's business)."""
    from spegnet_tpu_torch.models.ped import BoundaryAwareDecoder

    cfg = SPEGNetConfig.from_dict({**MODEL_CONFIG, "int8_encoder": True})
    assert cfg.int8_encoder and not cfg.int8_decoder
    cfg = SPEGNetConfig.from_dict({**MODEL_CONFIG, "int8_decoder": True})
    assert cfg.int8_decoder and not cfg.int8_encoder
    seen = []
    orig = BoundaryAwareDecoder.forward
    monkeypatch.setattr(BoundaryAwareDecoder, "forward", lambda self, *a, **k: (
        seen.append(k.get("int8")), orig(self, *a, **k))[1])
    model = SPEGNet(_port_config({**MODEL_CONFIG, "int8_decoder": True}))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 128, 128, 3)).astype(
        np.float32))
    with torch.no_grad():
        model.eval()(x)
        model.train()(x)
    assert seen == [True, False]


def test_spegnet_int8_matches_jax_int8(jax_int8_case, monkeypatch):
    """Same weights and input, bf16, the flag set in a config dict: every
    int8 kernel runs once per block of its kind on both sides, and the
    port's fused stage-2..4 features (CFI output) lie within 3% (mean
    |difference| / mean |JAX|) of JAX's int8 model's and closer to them than
    the port's bf16 model does (the fault the dropped flag caused).  Both
    round bf16 at different points, and a value moved by one bf16 step may
    change its int8 code: measured 1.5% (int8) and 2.2% (bf16) on the CPU."""
    x, variables, want, jax_calls = jax_int8_case
    assert jax_calls == {"_forward_i8@spegnet_tpu.ops.fused_block_t_i8": 3,
                         "_qpool_forward_i8@spegnet_tpu.ops.fused_block_t_i8": 2,
                         "_forward_i8@spegnet_tpu.ops.fused_block_i8": 1}
    calls = _count_calls(monkeypatch)
    rel = {}
    for int8 in (True, False):
        calls.clear()
        model = _port_model(variables, {**MODEL_CONFIG, "int8_encoder": int8})
        with torch.inference_mode():
            out = model(torch.from_numpy(x))
        assert calls == ({"fused_block_t_i8": 3, "qpool_front_i8": 2, "fused_block_i8": 1}
                         if int8 else {})
        fused = out["features"]["fused"].float().numpy()
        mask = torch.sigmoid(out["predictions"][-1].float()).numpy()
        assert np.isfinite(fused).all() and np.isfinite(mask).all()
        rel[int8] = float(np.abs(fused - want["fused"]).mean() / np.abs(want["fused"]).mean())
        if int8:
            assert float(np.abs(mask - want["mask"]).mean()) <= 1e-3
    assert rel[True] <= 0.03, rel
    assert rel[True] < rel[False], rel


def test_int8_is_eval_only_and_cached(jax_int8_case, monkeypatch):
    """A train-mode forward runs no int8 wrapper and equals the model's
    without the flag; in eval mode the packed weights are built once and
    rebuilt after load_state_dict."""
    x, variables, _, _ = jax_int8_case
    xt = torch.from_numpy(x)
    calls = _count_calls(monkeypatch)
    plain = _port_model(variables, MODEL_CONFIG).train()
    flagged = _port_model(variables, {**MODEL_CONFIG, "int8_encoder": True}).train()
    with torch.no_grad():
        want = plain(xt)["predictions"][-1]
        got = flagged(xt)["predictions"][-1]
    assert not calls
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    packs = collections.Counter()
    for mod in (tfbt_i8, tfb_i8):
        monkeypatch.setattr(mod, "pack_i8", lambda w, _f=mod.pack_i8: (
            packs.update(["pack"]), _f(w))[1])
    monkeypatch.setattr(tfbt_i8, "pack_qpool_i8", lambda w, _f=tfbt_i8.pack_qpool_i8: (
        packs.update(["pack"]), _f(w))[1])
    flagged.eval()
    with torch.no_grad():
        a = flagged(xt)["predictions"][-1]
        flagged(xt)
        n_first = packs["pack"]
        assert n_first == 6 and sum(calls.values()) == 12
        flagged.load_state_dict(init_weights(SPEGNet(_port_config(MODEL_CONFIG)),
                                             torch.Generator().manual_seed(1)).state_dict())
        b = flagged(xt)["predictions"][-1]
    assert packs["pack"] == 2 * n_first
    assert not torch.equal(a, b)


def test_predictor_int8_runs_plain_versions_on_cpu(jax_int8_case, monkeypatch):
    _, variables, _, _ = jax_int8_case
    calls = _count_calls(monkeypatch)
    model = SPEGNet(_port_config({**MODEL_CONFIG, "int8_encoder": True}))
    model.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    pred = Predictor(None, {**MODEL_CONFIG, "int8_encoder": True,
                            "image_processing": {"target_size": 256}}, None, batch_size=2,
                     device="cpu", model=model)
    rng = np.random.default_rng(3)
    seg, edge = pred.predict_arrays([rng.integers(0, 256, (200, 240, 3), np.uint8)
                                     for _ in range(2)])
    assert seg.shape == (2, 256, 256) and np.isfinite(seg).all()
    assert calls == {"fused_block_t_i8": 3, "qpool_front_i8": 2, "fused_block_i8": 1}
