"""Patch grids that are not 2^k: the port's window-major layout, its routes
and the whole model against the JAX package.

* The window-major layout (ops/fused_block_t.to_w / from_w): a round trip,
  windows of L consecutive rows holding the tokens of JAX's ``to_t``
  windows, 2x2 pool groups of 4 consecutive rows whose max is the layout at
  the pooled grid, and Morton order for a 2^k grid as one window.
* ``trunk_routes`` of Hiera-L at 352^2, 384^2, 640^2 and 768^2 (and of the
  small variants below) equal to the JAX package's non-Morton gates
  (spegnet_tpu/models/hiera.py:854-866, :509-517, :566-574, :296-300), bf16,
  with and without int8 (a shape computation); and in f32, where JAX takes
  neither Morton order nor the T-block nor the transition front (bf16 only,
  :806-812), at every size from 352^2 to 1024^2.
* A small SPEGNet whose trunk takes the f32 routes (gen-1 block, lanes
  attention on zero-padded windows and on a global block, plain Q-pool
  attention) on a 96x96 input (grid 24) and a non-square 64x96 one (grid
  16x24), kernels=True, against the JAX model in f32 at the tolerance of
  tests/test_torch_model.py; each wrapper called once per block of its
  route.  The routes only bf16 takes (the T-block and the transition front
  on the window-major layout, and Morton order on a 2^k grid) run in bf16
  against the decomposed bf16 trunk here, and against JAX's bf16 model in
  tests/test_torch_bf16.py.
* The engines at such a target size: Predictor, Evaluator and one Trainer
  step at 96^2 on the CPU.
"""

import collections

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
from spegnet_tpu.ops import pallas_attention as jpa
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models import ped as tped
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import fused_block_t as tfbt
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax, to_torch

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)

# Every route of the grid trunk at width 16: on 96x96 (grid 24) stage 1 is
# gen-1, t12 plain, the stage-2 global block (grid 12, L 144) lanes, stage 2
# gen-1 (L 16), t23 plain, stage 3 lanes on windows of 4 padded over a 6x6
# grid, t34 plain; on 64x96 (grid 16x24) stage 1 is a T-block and t12 the
# transition front, on the window-major layout.
_GRID = dict(embed_dim=16, num_heads=1, stages=(1, 3, 3, 1), global_att_blocks=(2,),
             window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 4, 2))
jhiera.HIERA_VARIANTS["_torch_grid"] = jhiera.HieraConfig(**_GRID)
thiera.HIERA_VARIANTS["_torch_grid"] = thiera.HieraConfig(**_GRID)
SMALL_HEAD = dict(fusion_channels=32, context_channels=16, edge_channels=8,
                  decoder_channels=(16, 8, 4))


# ---------------------------------------------------------------------------
# the window-major layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,ws", [(24, 32, 8), (12, 12, 4), (16, 24, 2), (28, 28, 14),
                                    (12, 18, 6), (6, 9, 3)])
def test_window_layout(h, w, ws):
    x = torch.arange(h * w, dtype=torch.float32).reshape(1, h, w, 1)
    xw = tfbt.to_w(x, ws)
    torch.testing.assert_close(tfbt.from_w(xw, ws, (h, w)), x, rtol=0, atol=0)
    l = ws * ws
    want = np.asarray(jfbt.to_t(jnp.asarray(x.numpy()), ws))[0, 0].reshape(-1, l)
    got = xw[0, :, 0].numpy().reshape(-1, l)
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
    if ws % 2 == 0:
        groups = xw[0, :, 0].reshape(-1, 4)
        ys, xs = groups.long() // w, groups.long() % w
        assert bool(((ys.amax(1) - ys.amin(1)) == 1).all() and
                    ((xs.amax(1) - xs.amin(1)) == 1).all())
        assert bool((ys.amin(1) % 2 == 0).all() and (xs.amin(1) % 2 == 0).all())
        pooled = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        torch.testing.assert_close(xw.reshape(1, -1, 4, 1).amax(2), tfbt.to_w(pooled, ws // 2),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("h", [2, 4, 8, 16, 32])
def test_window_layout_of_one_2k_window_is_morton(h):
    x = np.random.default_rng(h).standard_normal((2, h, h, 3)).astype(np.float32)
    want = np.asarray(jfbt.to_z(jnp.asarray(x))).transpose(0, 2, 1)
    np.testing.assert_array_equal(tfbt.to_w(torch.from_numpy(x), h).numpy(), want)


@pytest.mark.parametrize("lay,ws,keeps", [(None, 8, False), (None, 0, False), (0, 0, True),
                                          (0, 8, False), (8, 0, True), (8, 8, True),
                                          (128, 8, True), (128, 16, True), (12, 4, True),
                                          (12, 6, False), (8, 16, False), (14, 7, False)])
def test_keeps_windows(lay, ws, keeps):
    """keeps_windows agrees with the layout: each window of ws is a run of
    consecutive rows exactly when it says so."""
    assert tfbt.keeps_windows(lay, ws) == keeps
    if lay and ws and lay % ws == 0:
        idx = tfbt._window_index(lay, lay, lay).reshape(-1, ws * ws)
        runs = {frozenset(((i // lay) // ws * (lay // ws) + (i % lay) // ws) for i in r)
                for r in idx}
        assert all(len(r) == 1 for r in runs) == keeps


def test_global_layout_is_raster():
    x = torch.randn(2, 6, 10, 4)
    assert torch.equal(tfbt.to_w(x, 0), x.reshape(2, 60, 4))
    assert torch.equal(tfbt.from_w(tfbt.to_w(x, 0), 0, (6, 10)), x)
    with pytest.raises(ValueError, match="do not tile"):
        tfbt.to_w(x, 4)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_gates(monkeypatch):
    """JAX's kernel gates open as on a TPU."""
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _jax_grid_routes(cfg, h, w, int8, batch=8, dt=jnp.bfloat16):
    """Each block's route under the JAX package's non-Morton branch in
    compute dtype ``dt``: the front and the T-block need bf16
    (``self.dtype == jnp.bfloat16``, :514, :863)."""
    bf = dt
    t_ok = dt == jnp.bfloat16
    out = []
    for sp in thiera.block_specs(cfg):
        ws = sp.window
        l, n = (ws * ws if ws else h * w), h * w
        divisible = ws == 0 or (h % ws == 0 and w % ws == 0)
        if sp.q_pool:
            if (t_ok and sp.dim != sp.dim_out and ws > 1 and ws % 2 == 0 and divisible
                    and jfbt.qpool_supported(sp.dim, sp.heads, l, n, bf, batch=batch)):
                i8 = int8 and jfbt_i8.qpool_supported_i8(sp.dim, sp.heads, l, n, bf,
                                                         batch=batch)
                out.append("qpool_front_i8" if i8 else "qpool_front")
            else:
                out.append("plain")
            h, w = h // 2, w // 2
            continue
        rows = batch * n // l if divisible else 0
        if (t_ok and sp.dim == sp.dim_out and divisible
                and jfbt.supported(sp.dim, sp.heads, l, n, bf, batch=batch)):
            i8 = int8 and jfbt_i8.supported_i8(sp.dim, sp.heads, l, n, bf, batch=batch)
            out.append("fused_block_t_i8" if i8 else "fused_block_t")
        elif divisible and jfb.supported(1, l, bf, batch_rows=rows):
            i8 = int8 and jfb_i8.supported_i8(rows, l, sp.dim, bf, batch_rows=rows)
            out.append("fused_block_i8" if i8 else "fused_block")
        elif jpa.lanes_supported(l, sp.dim_out // sp.heads):
            out.append("fused_attention_lanes")
        else:
            out.append("plain")
    return out


# blocks per route of Hiera-L in bf16 at each input size
HIERA_L = {
    352: {"fused_block": 7, "plain": 3, "fused_attention_lanes": 38},
    384: {"fused_block_t": 2, "qpool_front": 1, "fused_block": 5, "plain": 2,
          "fused_attention_lanes": 38},
    640: {"fused_block_t": 2, "qpool_front": 1, "fused_block": 5, "plain": 2,
          "fused_attention_lanes": 38},
    768: {"fused_block_t": 7, "qpool_front": 2, "fused_block": 3, "plain": 1,
          "fused_attention_lanes": 35},
}


@pytest.mark.parametrize("size", sorted(HIERA_L))
def test_hiera_large_routes_match_jax_gates(jax_gates, size):
    cfg = thiera.HIERA_VARIANTS["large"]
    g = size // 4
    for int8 in (False, True):
        port = thiera.trunk_routes(cfg, g, torch.bfloat16, int8)
        assert port == _jax_grid_routes(cfg, g, g, int8), (size, int8)
    assert collections.Counter(thiera.trunk_routes(cfg, g, torch.bfloat16, False)) == \
        HIERA_L[size]


# blocks per route of Hiera-L in f32 at each input size, without and with
# int8_encoder (stage 4's gen-1 blocks, C 1152, take the int8 gen-1 block
# where its windows divide the grid)
HIERA_L_F32 = {
    **{s: ({"fused_block": 10, "fused_attention_lanes": 35, "plain": 3},
           {"fused_block": 7, "fused_block_i8": 3, "fused_attention_lanes": 35, "plain": 3})
       for s in (512, 768, 1024)},
    **{s: ({"fused_block": 7, "fused_attention_lanes": 38, "plain": 3},) * 2
       for s in (352, 384, 640)},
}


@pytest.mark.parametrize("size", sorted(HIERA_L_F32))
def test_hiera_large_f32_routes_match_jax_gates(jax_gates, size):
    cfg = thiera.HIERA_VARIANTS["large"]
    g = size // 4
    for int8 in (False, True):
        port = thiera.trunk_routes(cfg, g, torch.float32, int8)
        assert port == _jax_grid_routes(cfg, g, g, int8, dt=jnp.float32), (size, int8)
        assert collections.Counter(port) == HIERA_L_F32[size][int8], (size, int8)
        assert port == thiera.trunk_routes(cfg, g, torch.float64, int8)
    assert not thiera.takes_morton(cfg, g, g, torch.float32)


@pytest.mark.parametrize("hw", [(24, 24), (16, 24), (24, 16), (12, 20)])
def test_small_grid_routes_match_jax_gates(jax_gates, hw):
    cfg = thiera.HIERA_VARIANTS["_torch_grid"]
    for int8 in (False, True):
        assert thiera.trunk_routes(cfg, hw, torch.bfloat16, int8) == \
            _jax_grid_routes(cfg, *hw, int8)


@pytest.mark.parametrize("hw", [(24, 24), (16, 24), (16, 16), (32, 32)])
def test_small_grid_f32_routes_match_jax_gates(jax_gates, hw):
    cfg = thiera.HIERA_VARIANTS["_torch_grid"]
    for int8 in (False, True):
        port = thiera.trunk_routes(cfg, hw, torch.float32, int8)
        assert port == _jax_grid_routes(cfg, *hw, int8, dt=jnp.float32)
        assert not {"fused_block_t", "qpool_front"} & set(port)


def test_morton_grids_keep_their_routes():
    """2^k grids whose windows fit keep the Morton routes (the 1024^2 global
    blocks included, whose L 4096 the port's T-block takes); a 2^k grid
    whose window exceeds it takes the grid routes."""
    cfg = thiera.HIERA_VARIANTS["large"]
    for g in (128, 256):
        assert thiera.morton_grid(cfg, g, g)
        assert collections.Counter(thiera.trunk_routes(cfg, g, torch.bfloat16, False)) == \
            {"fused_block_t": 42, "qpool_front": 3, "fused_block": 3}
    assert not thiera.morton_grid(cfg, 32, 32)   # 128^2: stage-3 windows of 16 on 8
    assert "fused_attention_lanes" in thiera.trunk_routes(cfg, 32, torch.bfloat16, False)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _perturb(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if path[-1] == "var":
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_grid_case():
    rng = np.random.default_rng(0)
    model = JaxSPEGNet(JaxConfig(variant="_torch_grid", **SMALL_HEAD))
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = _perturb(jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), x0)), rng)
    cases = {}
    for hw in ((96, 96), (64, 96)):
        x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
        cases[hw] = (x, jax.device_get(jax.jit(model.apply)(variables, jnp.asarray(x))))
    return variables, cases


WRAPPERS = ("fused_block_t", "fused_block", "qpool_front", "fused_attention_lanes")


def _count_wrappers(monkeypatch):
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(thiera, name)
        monkeypatch.setattr(thiera, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.update([_n]) or _fn(*a, **k))
    fn = tped.fused_decoder_block
    monkeypatch.setattr(tped, "fused_decoder_block",
                        lambda *a, _fn=fn, **k:
                        calls.update(["fused_decoder_block"]) or _fn(*a, **k))
    return calls


@pytest.mark.parametrize("hw", [(96, 96), (64, 96)], ids=["96x96", "64x96"])
def test_spegnet_on_grid_matches_jax(jax_grid_case, monkeypatch, hw):
    variables, cases = jax_grid_case
    x, want = cases[hw]
    model = SPEGNet(SPEGNetConfig(variant="_torch_grid", **SMALL_HEAD)).eval()
    model.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    calls = _count_wrappers(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    routes = collections.Counter(thiera.trunk_routes(
        thiera.HIERA_VARIANTS["_torch_grid"], (hw[0] // 4, hw[1] // 4), torch.float32, False))
    routes.pop("plain")
    # f32: decoder block 2 runs decomposed, as in the JAX package (its fused
    # block is bf16 only, and square only)
    routes["fused_decoder_block"] = 0
    assert calls == +routes, (calls, routes)
    for g, w in zip(got["predictions"], want["predictions"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_allclose(got["edge"].numpy(), want["edge"], **TOL)
    for k in ("context", "fused", "edge_features"):
        np.testing.assert_allclose(got["features"][k].numpy(), want["features"][k], **TOL)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)], ids=["64x64-morton", "64x96"])
def test_bf16_token_layouts_match_decomposed(monkeypatch, hw):
    """The token-major layouts of bf16 (Morton order on a 2^k grid; the
    window-major layout elsewhere, with the T-block and the transition
    front), which f32 no longer takes, on the CPU against the decomposed
    bf16 trunk: each wrapper called once per block of its route, and every
    pyramid output within two bf16 steps (2^-7) of the largest (a wrong
    layout moves it by O(1))."""
    cfg = thiera.HIERA_VARIANTS["_torch_grid"]
    torch.manual_seed(0)
    trunk = thiera.Hiera("_torch_grid").eval()
    with torch.no_grad():
        for p in trunk.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.randn(2, *hw, 3)
    routes = collections.Counter(thiera.trunk_routes(cfg, (hw[0] // 4, hw[1] // 4),
                                                     torch.bfloat16, False))
    assert {"fused_block_t", "qpool_front"} <= set(routes)
    assert thiera.takes_morton(cfg, hw[0] // 4, hw[1] // 4, torch.bfloat16) == (hw[0] == hw[1])
    calls = _count_wrappers(monkeypatch)
    with torch.no_grad():
        got = trunk(x, kernels=True, dtype=torch.bfloat16)
        want = trunk(x, kernels=False, dtype=torch.bfloat16)
    routes.pop("plain", None)
    assert calls == routes
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= 2 ** -7


# ---------------------------------------------------------------------------
# the engines at a target size whose grid is not 2^k
# ---------------------------------------------------------------------------

MODEL = {"encoder": {"variant": "_torch_grid", "checkpoint_path": None},
         "compute_dtype": "float32", "image_processing": {"target_size": 96}}


def _grid_model():
    return init_weights(SPEGNet(SPEGNetConfig(variant="_torch_grid", **SMALL_HEAD)),
                        torch.Generator().manual_seed(0))


def test_engines_honour_target_size(monkeypatch):
    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch, synthetic_train_batch
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer

    rng = np.random.default_rng(5)
    calls = _count_wrappers(monkeypatch)
    pred = Predictor(None, MODEL, None, batch_size=2, device="cpu", model=_grid_model())
    seg, edge = pred.predict_arrays([rng.integers(0, 256, (70, 130, 3), np.uint8)
                                     for _ in range(3)])
    assert seg.shape == (3, 96, 96) and edge.shape == (3, 12, 12) and np.isfinite(seg).all()
    assert calls["fused_attention_lanes"] == 2 * 3   # two batches x three lanes blocks

    ev = Evaluator(None, None, MODEL, batch_size=2, canvas_buckets=(64, 96, 128),
                   device="cpu", model=_grid_model())
    batch = synthetic_eval_batch(2, rng, size=96, gt_range=(40, 90), buckets=(64, 96, 128))
    means = ev.evaluate(None, "synthetic", loader=[batch])
    assert all(0.0 <= v <= 1.0 for v in means.values()), means

    cfg = {"model": MODEL, "training": {
        "batch_size": 2, "num_epochs": 1, "val_ratio": 0, "gradient_clip": 1.0,
        "canvas_buckets": [96, 128], "optimizer": {"learning_rate": 1e-3}}}
    tr = Trainer(cfg, None, device="cpu", model=_grid_model())
    calls.clear()
    res = tr.train_step(synthetic_train_batch(2, rng, size=96, gt_range=(40, 90)))
    assert np.isfinite(res["metrics"]["loss"])
    assert calls["fused_attention_lanes"] == 3 and calls["fused_block"] == 2
