"""The port's int8 decoder block (spegnet_tpu_torch/ops/fused_decoder.py,
``int8=True``, ``model.int8_decoder``) against the JAX package's TPU kernel
``_dec_kernel`` with ``int8=True`` in interpret mode, on the CPU.

* Pieces, bit-equal to what JAX's kernel is handed (its pallas_call inputs
  are captured): the composed and packed weights in f32 and bf16, their
  int8 codes and column scales, the per-image x codes and scales (with .5
  ties), and the activated border strips; the raw strips equal, or one
  bf16 step apart on <= 1e-3 of elements (an f32 conv sums in another
  order and may land on the other side of a bf16 rounding edge).
* pack_w2's two column halves hold one output channel's values, so their
  scales are per output channel and the phase-space sums equal a plain
  SAME conv's on the 2S grid.
* The plain int8 block against JAX's int8 kernel at four strips (first,
  two interior, last): conv2's output and the head equal, or one bf16 step
  apart on <= 1e-3 of elements (the head's f32 dot sums in another order);
  and a case where an unpasted halo value that conv2 never reads is the
  first strip's maximum.
* The int8 gate against JAX's hardware branch (Cin % 128, edge) and its
  model gate (train, dtype).
* A small SPEGNet with int8_encoder + int8_decoder against the JAX int8
  model.
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
from spegnet_tpu.ops import fused_block_i8 as jfb_i8
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import fused_decoder as jfd
from spegnet_tpu.ops.fused_upsample_conv import d2s_nhwc
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import fused_decoder as tfd
from spegnet_tpu_torch.ops.fused_upsample_conv import compose_kernel
from spegnet_tpu_torch.utils.weights import state_dict_from_jax, to_torch

torch.set_num_threads(1)
BF = torch.bfloat16


@pytest.fixture
def jax_bn(monkeypatch):
    """The port folds BN with torch.rsqrt; XLA's rsqrt on the CPU is not
    correctly rounded (one f32 step off on ~14% of values), and a scale one
    step apart can move a folded bf16 weight and then its code.  The fold
    itself is held to JAX's within 1e-6 (tests/test_torch_decoder.py); the
    tests that hold everything after it bit for bit hand the port JAX's
    folded (s, t)."""
    def fold(bias, gamma, beta, mean, var, eps=1e-5):
        s, t = jfd.fold_bn(*(None if a is None else jnp.asarray(a.detach().float().numpy())
                             for a in (bias, gamma, beta, mean, var)), eps)
        return torch.from_numpy(np.array(s)), torch.from_numpy(np.array(t))

    monkeypatch.setattr(tfd, "fold_bn", fold)


@pytest.fixture
def capture(monkeypatch):
    """JAX's kernels in interpret mode; records the inputs of every
    pallas_call."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    calls = []

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        run = orig(*args, **kwargs)

        def recorded(*inputs):
            calls.append([np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in inputs])
            return run(*inputs)
        return recorded

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    yield calls


def _case(rng, b=2, s=32, cin=16, cm=8, ce=8, edge=False, top=None):
    """Seeded block parameters (JAX layouts, f32) and a bf16-exact input."""
    def n(*shape, s_=1.0):
        return (rng.standard_normal(shape) * s_).astype(np.float32)

    def bn():
        return dict(gamma=rng.uniform(0.5, 1.5, cm).astype(np.float32),
                    beta=n(cm, s_=0.1), mean=n(cm, s_=0.1),
                    var=rng.uniform(0.5, 2.0, cm).astype(np.float32))

    x = n(b, s, s, cin)
    k1 = n(3, 3, cin, cm, s_=0.3 * (9 * cin) ** -0.5)
    if top is not None:      # large input on cell row 0, conv1's top taps positive
        x[:, 0] = top
        k1[0] = np.abs(k1[0]) * 4
    c = dict(x=_bf(x), k1=k1, b1=n(cm, s_=0.1), bn1=bn(),
             k2=n(3, 3, cm, cm, s_=(9 * cm) ** -0.5), b2=n(cm, s_=0.1), bn2=bn(),
             head_w=n(cm, 1, s_=0.3), head_b=n(1, s_=0.1))
    if edge:
        c.update(k_edge=n(3, 3, ce, cm, s_=(9 * ce) ** -0.5), ef=_bf(n(b, s // 2, s // 2, ce)))
    return c


def _bf(a):
    return torch.from_numpy(a).to(BF).float().numpy()


def _jx(c, key, dtype=jnp.float32):
    v = c[key]
    return {k: jnp.asarray(a) for k, a in v.items()} if isinstance(v, dict) else \
        jnp.asarray(v, dtype)


def _port(c, head=True):
    t = torch.from_numpy

    def bn(d):
        return (t(d["gamma"]), t(d["beta"]), t(d["mean"]), t(d["var"]), 1e-5)

    def oihw(k):
        return t(k.transpose(3, 2, 0, 1).copy())

    return tfd.DecoderParams(
        oihw(c["k1"]), t(c["b1"]), bn(c["bn1"]), oihw(c["k2"]), t(c["b2"]), bn(c["bn2"]),
        t(c["head_w"].T.reshape(1, -1, 1, 1).copy()) if head else None,
        t(c["head_b"]) if head else None,
        oihw(c["k_edge"]) if "k_edge" in c else None)


def _jax_block(c, dtype, capture, int8=False, sh=8, edge=False, head=True):
    """JAX's fused block in interpret mode: (out NHWC, pred [B, 2S, 2S] or
    None, the kernel's inputs)."""
    params = jfd.pack_params(_jx(c, "k1"), _jx(c, "b1"), _jx(c, "bn1"), _jx(c, "k2"),
                             _jx(c, "b2"), _jx(c, "bn2"),
                             k_edge=_jx(c, "k_edge") if edge else None,
                             head_w=_jx(c, "head_w") if head else None,
                             head_b=_jx(c, "head_b") if head else None, dtype=dtype)
    x = _jx(c, "x", dtype)
    ef = _jx(c, "ef", dtype) if edge else None
    strips = jfd.make_strips(x, _jx(c, "k1"), k_edge=_jx(c, "k_edge") if edge else None,
                             ef=ef, dtype=dtype)
    n0 = len(capture)
    out, pred = jfd.fused_decoder_block(x, params, strips, ef=ef, sh=sh, int8=int8,
                                        interpret=True)
    b, s = x.shape[:2]
    pred = None if pred is None else np.asarray(pred.astype(jnp.float32)).reshape(b, 2 * s, 2 * s)
    return np.asarray(d2s_nhwc(out).astype(jnp.float32)), pred, capture[n0]


def _steps_apart(got, want):
    """(share of elements that differ, largest difference in bf16 steps of
    |want|) of two bf16-valued arrays."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    differ = got != want
    _, e = np.frexp(np.where(want == 0, 1.0, want))
    ulp = np.ldexp(1.0, e - 8)
    steps = float((np.abs(got - want) / ulp)[differ].max()) if differ.any() else 0.0
    return float(differ.mean()), steps


def _near(got, want, frac=1e-3):
    share, steps = _steps_apart(got, want)
    assert share <= frac and steps <= 1.0, (share, steps)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin,cm", [(16, 8), (128, 64)])
def test_packed_weights_match_jax_bitwise(rng, jax_bn, cin, cm):
    c = _case(rng, cin=cin, cm=cm)
    k1, k2 = torch.from_numpy(c["k1"]), torch.from_numpy(c["k2"])
    np.testing.assert_array_equal(
        compose_kernel(k1).numpy(),
        np.asarray(jfd._compose_kernel(jnp.asarray(c["k1"]))))
    for dt, jdt in ((torch.float32, jnp.float32), (BF, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tfd.pack_w1(k1, dt).float().numpy(),
            np.asarray(jfd.pack_w1(jnp.asarray(c["k1"]), jdt).astype(jnp.float32)))
        np.testing.assert_array_equal(
            tfd.pack_w2(k2, dt).float().numpy(),
            np.asarray(jfd.pack_w2(jnp.asarray(c["k2"]), jdt).astype(jnp.float32)))
    jp = jfd.pack_params(_jx(c, "k1"), _jx(c, "b1"), _jx(c, "bn1"), _jx(c, "k2"), _jx(c, "b2"),
                         _jx(c, "bn2"), head_w=_jx(c, "head_w"), head_b=_jx(c, "head_b"))
    tp = tfd.pack_params(_port(c))
    for name in ("w1", "w2", "s1t1", "s2t2", "h2", "hb"):
        np.testing.assert_array_equal(getattr(tp, name).float().numpy(),
                                      np.asarray(getattr(jp, name).astype(jnp.float32)),
                                      err_msg=name)
    for name in ("w1", "w2"):
        q, s = tfd.quantize_cols(getattr(tp, name))
        jq, js = jfb_i8.quantize_cols(getattr(jp, name))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])


def test_w2_scales_are_per_output_channel(rng):
    """Each column (px', co) of pack_w2 holds the 9 x Cm values of output
    channel co (and zeros), so the two halves' scales and codes agree, and
    the phase-space contraction of the TPU kernel gives a plain SAME conv's
    integer sums on the 2S grid."""
    cm, s = 8, 6
    c = _case(rng, cm=cm)
    pk = tfd.pack_params(_port(c))
    q, sw = tfd.quantize_cols(pk.w2)
    np.testing.assert_array_equal(sw[:cm].numpy(), sw[cm:].numpy())
    w = q.reshape(3, 4, cm, 2, cm).numpy().astype(np.int64)
    np.testing.assert_array_equal(w[:, 0:3, :, 0], w[:, 1:4, :, 1])
    assert not w[:, 3, :, 0].any() and not w[:, 0, :, 1].any()
    qi8 = tfd.pack_i8(_port(c))
    np.testing.assert_array_equal(qi8.sw2.numpy(), sw[:cm].numpy())
    # phase space (pack_w2's patch buffer, :512-540) vs SAME conv on codes
    a = rng.integers(-127, 128, (2 * s, 2 * s, cm))
    ap = np.pad(a, ((1, 1), (1, 1), (0, 0)))
    same = np.zeros((2 * s, 2 * s, cm), np.int64)
    k = qi8.w2q.reshape(cm, 3, 3, cm).numpy().astype(np.int64)
    for dy in range(3):
        for dx in range(3):
            same += np.einsum("hwc,oc->hwo", ap[dy:dy + 2 * s, dx:dx + 2 * s], k[:, dy, dx])
    w12 = q.numpy().astype(np.int64)
    for i in range(s):
        for j in range(s):
            for pyo in (0, 1):
                patch = []
                for off, py in ((0, 1), (1, 0), (1, 1), (2, 0)):
                    r = 2 * (i - 1 + off) + py
                    for cj, px in ((j - 1, 1), (j, 0), (j, 1), (j + 1, 0)):
                        col = 2 * cj + px
                        ok = 0 <= r < 2 * s and 0 <= col < 2 * s
                        patch.append(a[r, col] if ok else np.zeros(cm, np.int64))
                patch = np.concatenate(patch)
                lo = 4 * cm * pyo
                out = patch[lo:lo + 12 * cm] @ w12
                np.testing.assert_array_equal(out[:cm], same[2 * i + pyo, 2 * j])
                np.testing.assert_array_equal(out[cm:], same[2 * i + pyo, 2 * j + 1])


def _ties(rng, b, s, cin):
    """bf16 images whose absmax is 127 * 2^e: every entry k + 0.5 (times
    2^e) is an exact rounding tie of the division."""
    x = np.zeros((b, s, s, cin), np.float32)
    for i in range(b):
        e = float(2.0 ** rng.integers(-4, 2))
        x[i] = (rng.integers(-126, 126, (s, s, cin)) + 0.5) * e
        x[i, 0, 0, 0] = 127 * e * rng.choice([-1, 1])
    return x


def test_pieces_match_the_jax_kernel_inputs(rng, jax_bn, capture):
    """x codes and scales (random and with .5 ties), weight codes and
    scales, and the activated strips are what JAX's int8 kernel is handed,
    bit for bit; the raw strips as JAX's make_strips."""
    c = _case(rng, cin=128, cm=8)
    for x in (c["x"], _ties(rng, 2, 32, 128)):
        c["x"] = _bf(x)
        _, _, inp = _jax_block(c, jnp.bfloat16, capture, int8=True)
        xt = torch.from_numpy(c["x"]).to(BF)
        xq, sx = tfd.quantize_image(xt)
        np.testing.assert_array_equal(xq.numpy(), inp[0])
        np.testing.assert_array_equal(sx.numpy(), inp[11])
        q = tfd.pack_i8(_port(c))
        np.testing.assert_array_equal(q.w1t.t().numpy(), inp[5])
        np.testing.assert_array_equal(q.sw1.numpy(), inp[9][0])
        cm = 8
        w2 = inp[6].reshape(3, 4, cm, 2, cm)[:, 0:3, :, 0].transpose(3, 0, 1, 2)
        np.testing.assert_array_equal(q.w2q.numpy(), w2.reshape(cm, 9 * cm))
        np.testing.assert_array_equal(q.sw2.numpy(), inp[10][0, :cm])
        act = tfd.activate_strips(tfd.make_strips(xt, q.k1), q.s1, q.t1, BF).float().numpy()
        b, s = 2, 32
        np.testing.assert_array_equal(act[0], inp[1][:, :, :2 * cm].reshape(b, 2 * s, cm))
        np.testing.assert_array_equal(act[1], inp[2][:, :, 2 * cm:].reshape(b, 2 * s, cm))
        for k, j in ((2, 3), (3, 4)):
            lr = inp[j][:, 1:-1, 0].reshape(b, s, 2, 2, cm)[:, :, :, j - 3].reshape(b, 2 * s, cm)
            np.testing.assert_array_equal(act[k], lr)
    assert not np.any(np.abs(xq.numpy().astype(np.int32)) > 127)
    for dt, jdt in ((torch.float32, jnp.float32), (BF, jnp.bfloat16)):
        got = tfd.make_strips(torch.from_numpy(c["x"]).to(dt), torch.from_numpy(c["k1"]),
                              dtype=dt)
        want = jfd.make_strips(jnp.asarray(c["x"], jdt), jnp.asarray(c["k1"]), dtype=jdt)
        b, s, cm = 2, 32, 8
        pairs = ((got[0], np.asarray(want[0], np.float32)[:, :, :2 * cm]),
                 (got[1], np.asarray(want[1], np.float32)[:, :, :2 * cm]),
                 (got[2], np.asarray(want[2], np.float32)[:, :, 0].reshape(b, s, 2, 2, cm)[:, :, :, 0]),
                 (got[3], np.asarray(want[3], np.float32)[:, :, 0].reshape(b, s, 2, 2, cm)[:, :, :, 1]))
        for g, w in pairs:
            g = g.float().numpy()
            w = w.reshape(g.shape)
            if dt == BF:
                _near(g, w)
            else:   # f32 sums of 6 Cin terms in another order
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the int8 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin", [16, 128])
def test_int8_block_matches_jax_kernel(rng, jax_bn, capture, cin):
    """b 2, s 32, sh 8: four strips, first, two interior, last."""
    c = _case(rng, cin=cin, cm=8)
    out, pred, _ = _jax_block(c, jnp.bfloat16, capture, int8=True)
    parts = tfd.i8_parts_plain(torch.from_numpy(c["x"]).to(BF), tfd.pack_i8(_port(c)))
    assert parts["sa"].shape == (2, 4)
    _near(parts["y2"].float().numpy(), out)
    _near(parts["pred"].float().numpy(), pred)
    if cin % 128 == 0:   # the wrapper's gate; Cin 16 runs the int8 mode in interpret mode only
        got = tfd.fused_decoder_block(torch.from_numpy(c["x"]).to(BF), _port(c), int8=True)
        np.testing.assert_array_equal(got[..., 0].float().numpy(),
                                      parts["pred"].float().numpy())


def test_int8_halo_maximum_enters_the_first_strip_scale(rng, jax_bn, capture):
    """Large input on cell row 0 with positive top taps: conv1's unpasted
    row 0 (the first strip's halo slot, which conv2 never reads) is larger
    than anything the strip's pasted rows hold, so it alone sets the first
    strip's scale; JAX's outputs must still be matched."""
    c = _case(rng, cin=128, cm=8, top=6.0)
    q = tfd.pack_i8(_port(c))
    parts = tfd.i8_parts_plain(torch.from_numpy(c["x"]).to(BF), q)
    y1 = parts["y1"].float()
    read = y1[:, :2 * 8 + 2].amax((1, 2, 3))
    np.testing.assert_array_less(tfd._scale(read).numpy(), parts["sa"][:, 0].numpy())
    out, pred, _ = _jax_block(c, jnp.bfloat16, capture, int8=True)
    _near(parts["y2"].float().numpy(), out)
    _near(parts["pred"].float().numpy(), pred)


@pytest.mark.parametrize("cm", [8, 64])
def test_int8_head_sums_in_the_kernel_order(rng, cm):
    """The plain int8 block's head sums in csrc/decoder_i8.cu's order, so the
    card's logits can be held bit for bit: for channels c = 8k + 2t + e, each
    pair's products, then the pairs over k in turn, then a tree over t, then
    + hb -- here one f32 operation at a time in numpy, against the port, on
    bf16 values held in f32 so that the f32 sum is compared before its
    rounding."""
    y2 = torch.from_numpy(rng.standard_normal((32, 32, cm), dtype=np.float32)).to(BF).float()
    hw = torch.from_numpy(rng.standard_normal(cm, dtype=np.float32))
    hb = torch.from_numpy(rng.standard_normal(1, dtype=np.float32))
    pr = y2.numpy() * hw.numpy()
    part = [np.zeros((32, 32), np.float32) for _ in range(4)]
    for k in range(cm // 8):
        for t in range(4):
            part[t] = part[t] + (pr[..., 8 * k + 2 * t] + pr[..., 8 * k + 2 * t + 1])
    want = ((part[0] + part[1]) + (part[2] + part[3])) + hb.numpy()
    np.testing.assert_array_equal(tfd._head_i8(y2, hw, hb).numpy(), want)


def test_int8_gate_matches_jax_hardware_branch(rng, monkeypatch):
    """JAX's fused_decoder_block outside interpret mode takes int8 only
    without an edge branch and with Cin % 128 == 0; the model takes its
    fused path (and so int8) only in bf16 eval mode."""
    import jax.experimental.pallas as pl

    seen = []

    def fake(kernel, *, out_shape, **kw):
        seen.append(kernel.args[0][-1])   # the cfg tuple's int8 flag
        return lambda *a: [jnp.zeros(o.shape, o.dtype) for o in out_shape]

    monkeypatch.setattr(pl, "pallas_call", fake)
    for cin in (64, 128, 192, 256):
        for edge in (False, True):
            c = _case(rng, b=1, s=16, cin=cin, cm=8, edge=edge)
            params = jfd.pack_params(_jx(c, "k1"), _jx(c, "b1"), _jx(c, "bn1"), _jx(c, "k2"),
                                     _jx(c, "b2"), _jx(c, "bn2"),
                                     k_edge=_jx(c, "k_edge") if edge else None,
                                     head_w=_jx(c, "head_w"), head_b=_jx(c, "head_b"),
                                     dtype=jnp.bfloat16)
            x = _jx(c, "x", jnp.bfloat16)
            ef = _jx(c, "ef", jnp.bfloat16) if edge else None
            strips = jfd.make_strips(x, _jx(c, "k1"), k_edge=_jx(c, "k_edge") if edge else None,
                                     ef=ef)
            jfd.fused_decoder_block(x, params, strips, ef=ef, sh=8, int8=True, interpret=False)
            assert seen.pop() == tfd.int8_supported(cin, edge, BF), (cin, edge)
    for dt in (torch.float32, torch.float64):
        assert not tfd.int8_supported(128, False, dt)


def test_int8_wrapper_paths(rng, monkeypatch):
    """The wrapper takes the plain int8 version on the CPU where the gate
    holds, the bf16 block where it does not (f32, Cin % 128, edge), and
    refuses a device it has no kernel for."""
    c = _case(rng, b=1, s=16, cin=128, cm=8)
    calls = collections.Counter()
    for name in ("decoder_block_i8_plain", "decoder_block_plain"):
        fn = getattr(tfd, name)
        monkeypatch.setattr(tfd, name, lambda *a, _f=fn, _n=name, **k: (
            calls.update([_n]), _f(*a, **k))[1])
    x = torch.from_numpy(c["x"])
    tfd.fused_decoder_block(x.to(BF), _port(c), int8=True)
    tfd.fused_decoder_block(x, _port(c), int8=True)
    tfd.fused_decoder_block(x.to(BF), _port(c))
    assert calls == {"decoder_block_i8_plain": 1, "decoder_block_plain": 2}
    c16 = _case(rng, b=1, s=16, cin=16, cm=8)
    calls.clear()
    tfd.fused_decoder_block(torch.from_numpy(c16["x"]).to(BF), _port(c16), int8=True)
    assert calls == {"decoder_block_plain": 1}
    with pytest.raises(ValueError):
        tfd.fused_decoder_block(x.to(BF).to("meta"), _port(c), int8=True)
    with pytest.raises(ValueError):
        tfd.pack_i8(_port(c, head=False))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# Block 2's input has 128 channels, so the port's gate and JAX's
# interpret-mode kernel both take int8 (the TPU's Cin % 128 rule).
I8_HEAD = dict(fusion_channels=32, context_channels=16, edge_channels=8,
               decoder_channels=(16, 128, 8))
I8_CONFIG = {"encoder": {"variant": "_torch_i8_small"}, "compute_dtype": "bfloat16",
             "int8_encoder": True, "int8_decoder": True}


@pytest.fixture(scope="module")
def jax_i8_model():
    """The JAX SPEGNet with int8_encoder and int8_decoder on the small
    variant at 128^2, bf16, its Pallas kernels in interpret mode: the
    input, the variables, the logits, and (int8 flag, input) of each call of
    its fused decoder block."""
    from tests.test_torch_int8 import _random_variables   # registers _torch_i8_small

    mp = pytest.MonkeyPatch()
    import jax.experimental.pallas as pl

    orig, calls = pl.pallas_call, []

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    fdb = jfd.fused_decoder_block

    def recorded(*a, **kw):
        calls.append((kw.get("int8", False), a[0]))
        return fdb(*a, **kw)

    mp.setattr(jfbt.pl, "pallas_call", interp)
    mp.setattr(jfbt, "INTERPRET", True)
    mp.setattr(jfd, "fused_decoder_block", recorded)
    try:
        rng = np.random.default_rng(5)
        x = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
        model = JaxSPEGNet(JaxConfig(variant="_torch_i8_small", compute_dtype="bfloat16",
                                     int8_encoder=True, int8_decoder=True, **I8_HEAD))
        variables = _random_variables(
            jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
        # No offsets in the decoder, so its small random-weight activations
        # are not swamped by the BN shifts and head bias (the mask would not
        # see block 2 at all).
        variables = jax.tree_util.tree_map_with_path(
            lambda path, a: np.zeros_like(a) if (
                any(getattr(k, "key", None) == "decoder" for k in path)
                and path[-1].key in ("bias", "mean")) else a, variables)
        calls.clear()
        out = model.apply(variables, jnp.asarray(x))
        mask = np.asarray(out["predictions"][-1].astype(jnp.float32))
        yield x, variables, mask, calls
    finally:
        mp.undo()


def test_spegnet_int8_decoder_matches_jax_int8(jax_i8_model, monkeypatch):
    """Same weights and input, both flags set in a config dict: block 2
    runs the plain int8 version once (and the bf16 block not at all), as
    JAX runs its int8 kernel once.  The port's logits lie within 2% (mean
    |difference| / mean |JAX|) of the JAX int8 model's: upstream, bf16
    rounds at other points, and a value moved by one bf16 step may change
    its int8 code (measured 0.75% on the CPU).  On JAX's own block-2 input
    the port's int8 block, packed from the model's f32 block-2 weights as
    JAX packs its parameters, gives JAX's logits within 0.2% (measured:
    equal), much closer than the port's bf16 block does (0.94%)."""
    x, variables, want, jax_calls = jax_i8_model
    assert [flag for flag, _ in jax_calls] == [True]
    calls = collections.Counter()
    for name in ("decoder_block_i8_plain", "decoder_block_plain"):
        fn = getattr(tfd, name)
        monkeypatch.setattr(tfd, name, lambda *a, _f=fn, _n=name, **k: (
            calls.update([_n]), _f(*a, **k))[1])
    cfg = dataclasses.replace(SPEGNetConfig.from_dict(I8_CONFIG), **I8_HEAD)
    model = SPEGNet(cfg).eval()
    model.load_state_dict(to_torch(state_dict_from_jax(variables)), strict=True)
    model.to_compute()
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert calls == {"decoder_block_i8_plain": 1}, calls
    got = out["predictions"][-1].float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()

    def rel(a):
        return float(np.abs(a - want).mean() / np.abs(want).mean())

    assert rel(got) <= 2e-2, rel(got)
    blk, head = model.decoder.decoder_blocks[2], model.decoder.pred_heads[2]
    x1 = torch.from_numpy(np.asarray(jax_calls[0][1].astype(jnp.float32))).to(BF)
    with torch.inference_mode():
        i8 = tfd.fused_decoder_block(x1, blk.params(head), int8=True,
                                     q=blk.i8_params(head, BF)).float().numpy()
        bf = tfd.fused_decoder_block(x1, blk.params(head)).float().numpy()
    assert rel(i8) <= 2e-3 and rel(i8) < 0.5 * rel(bf), (rel(i8), rel(bf))
    assert kernels.launches["fused_decoder_block_i8"] == 0   # no kernel on the CPU


def test_cli_predict_and_evaluate_honour_int8_decoder(tmp_path, monkeypatch):
    """``python -m spegnet_tpu_torch predict`` / ``evaluate`` on the CPU with
    ``model.int8_decoder`` (and ``int8_encoder``) in the user's YAML over a
    checkpoint whose embedded model section has neither: each forward runs
    the plain int8 decoder block, and the outputs are written."""
    import yaml
    from PIL import Image

    from spegnet_tpu.utils.torch_import import save_torch_checkpoint
    from spegnet_tpu_torch.__main__ import main

    rng = np.random.default_rng(0)
    embedded = {"encoder": {"variant": "test"}, "compute_dtype": "bfloat16",
                "image_processing": {"target_size": 64}}
    model = JaxSPEGNet(JaxConfig(variant="test"))
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    ckpt = tmp_path / "model.pth"
    save_torch_checkpoint(str(ckpt), variables, config={"model": embedded})
    imgs = tmp_path / "data" / "test" / "Imgs"
    gts = tmp_path / "data" / "test" / "GT"
    imgs.mkdir(parents=True)
    gts.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 70, 3), dtype=np.uint8)).save(imgs / f"s{i}.png")
        Image.fromarray((rng.random((60, 70)) > 0.5).astype(np.uint8) * 255).save(
            gts / f"s{i}.png")
    cfg = yaml.safe_load(open("configs/default.yaml").read())
    cfg["model"].update(int8_encoder=True, int8_decoder=True)
    cfg["evaluation"].update(datasets=[str(tmp_path / "data")], batch_size=2,
                             save_visualizations=False)
    cfg["training"]["canvas_buckets"] = [64, 128]
    (tmp_path / "my.yaml").write_text(yaml.safe_dump(cfg))
    calls = collections.Counter()
    fn = tfd.decoder_block_i8_plain
    monkeypatch.setattr(tfd, "decoder_block_i8_plain", lambda *a, **k: (
        calls.update(["i8"]), fn(*a, **k))[1])
    monkeypatch.chdir(tmp_path)
    main(["predict", "--model", str(ckpt), "--input", str(imgs), "--config", "my.yaml",
          "--device", "cpu"])
    n_predict = calls["i8"]
    assert n_predict >= 1
    assert len(list((tmp_path / "results" / "prediction").rglob("s0.png"))) >= 1
    main(["evaluate", "--model", str(ckpt), "--config", "my.yaml", "--device", "cpu"])
    assert calls["i8"] > n_predict
    assert list((tmp_path / "results" / "evaluation").rglob("metrics_summary.json"))
