"""The port's bf16 token-major trunk, put together as the model runs it,
against the JAX SPEGNet in bf16 with its kernel gates open (Pallas in
interpret mode), on the same weights and input.

In bf16 the JAX package runs the trunk in Morton order on a 2^k patch grid
(``to_z`` / ``fused_block_t`` / ``qpool_front`` / ``from_z``) and, on other
grids, the T-block and the transition front on the window-major layout
(spegnet_tpu/models/hiera.py:806-812, :854-866, :509-517); f32 takes none
of these, so the f32 parity tests (tests/test_torch_model.py,
tests/test_torch_geometry.py) no longer reach them.  Here the port's
``kernels=True`` bf16 model (its wrappers take their plain versions on the
CPU) runs a 64x64 input (grid 16, Morton: T-blocks and fronts) and a 64x96
one (grid 16x24: a T-block and the front on the window-major layout, then
gen-1 and lanes blocks); each wrapper is called once per block of its route,
and JAX's model is checked to have run the same kinds of kernel.

Tolerance: both sides compute in bf16 but round at other points (the JAX
kernels keep f32 accumulators and cast per their tiles), so each output is
held to mean |difference| / mean |JAX| <= 3% and max |difference| / max |JAX|
<= 8% (measured on the CPU: at most 2.1% and 3.4%).  The Morton layout
taken on the transposed grid moves the CFI features to 38% and the context
features to 8.8% (mean), so the check sees a wrong layout; a block's own
arithmetic is held tighter against JAX's kernels block by block
(tests/test_torch_blocks.py, tests/test_torch_int8.py).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import pallas_attention as jpa
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import pallas_attention as tpa
from spegnet_tpu_torch.utils.weights import state_dict_from_jax, to_torch
from tests.test_torch_geometry import SMALL_HEAD, _count_wrappers, _perturb  # registers _torch_grid

torch.set_num_threads(1)
MEAN_REL, MAX_REL = 0.03, 0.08
SIZES = ((64, 64), (64, 96))
# the JAX functions whose calls show which layout and kernels its trunk took
JAX_TRACED = ("to_z", "from_z", "fused_block_t", "qpool_front")


@pytest.fixture(scope="module")
def jax_bf16_case():
    """The JAX SPEGNet on ``_torch_grid`` in bf16, its gates open and its
    Pallas kernels in interpret mode: the variables and, per input size,
    the input, the output and the calls of JAX_TRACED."""
    import jax.experimental.pallas as pl

    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    calls = collections.Counter()
    mp.setattr(jfbt.pl, "pallas_call", interp)
    mp.setattr(jfbt, "INTERPRET", True)
    # JAX's lanes gate without its TPU-backend test: the port's rule
    mp.setattr(jpa, "lanes_supported", tpa.lanes_supported)
    for name in JAX_TRACED:
        fn = getattr(jfbt, name)
        mp.setattr(jfbt, name, lambda *a, _fn=fn, _n=name, **k: calls.update([_n]) or _fn(*a, **k))
    try:
        rng = np.random.default_rng(0)
        model = JaxSPEGNet(JaxConfig(variant="_torch_grid", compute_dtype="bfloat16",
                                     **SMALL_HEAD))
        x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
        variables = _perturb(jax.device_get(model.init(jax.random.PRNGKey(0), x0)), rng)
        cases = {}
        for hw in SIZES:
            x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
            calls.clear()
            out = jax.device_get(model.apply(variables, jnp.asarray(x)))
            cases[hw] = (x, out, dict(calls))
        yield variables, cases
    finally:
        mp.undo()


def _rel(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all()
    d = np.abs(g - w)
    return float(d.mean() / np.abs(w).mean()), float(d.max() / np.abs(w).max())


@pytest.mark.parametrize("hw", SIZES, ids=["64x64-morton", "64x96"])
def test_bf16_trunk_matches_jax_with_gates_open(jax_bf16_case, monkeypatch, hw):
    variables, cases = jax_bf16_case
    x, want, jax_calls = cases[hw]
    cfg = thiera.HIERA_VARIANTS["_torch_grid"]
    morton = hw[0] == hw[1]
    assert thiera.takes_morton(cfg, hw[0] // 4, hw[1] // 4, torch.bfloat16) == morton
    assert set(jax_calls) == ({"to_z", "from_z", "fused_block_t", "qpool_front"} if morton
                              else {"fused_block_t", "qpool_front"}), jax_calls

    port = SPEGNet(SPEGNetConfig(variant="_torch_grid", compute_dtype="bfloat16",
                                 **SMALL_HEAD)).eval()
    port.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    port.to_compute()
    routes = collections.Counter(thiera.trunk_routes(cfg, (hw[0] // 4, hw[1] // 4),
                                                     torch.bfloat16, False))
    assert {"fused_block_t", "qpool_front"} <= set(routes)
    calls = _count_wrappers(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    routes.pop("plain", None)
    # decoder block 2 takes its fused block in bf16 on a square input, as in JAX
    routes["fused_decoder_block"] = int(morton)
    assert calls == +routes, (calls, routes)

    outs = [(f"prediction {i}", g, w) for i, (g, w) in
            enumerate(zip(got["predictions"], want["predictions"]))]
    outs.append(("edge", got["edge"], want["edge"]))
    outs += [(k, got["features"][k], want["features"][k])
             for k in ("context", "fused", "edge_features")]
    for name, g, w in outs:
        mean_rel, max_rel = _rel(g, w)
        assert mean_rel <= MEAN_REL and max_rel <= MAX_REL, (name, mean_rel, max_rel)
