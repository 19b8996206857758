"""The head (CFI, EFE, PED) on row bands under a spatial axis
(models/spegnet.py ``SPEGNet.head``, parallel/sharding.py's band
primitives), in one process: the S ranks of a spatial group are S threads
whose collectives (``sharding._all_gather`` / ``_all_reduce``) meet in
memory, so each band's program runs as a rank's would, forward and
backward, and is held against the whole tensor sliced:

* the band primitives at S 2 and 4: :func:`sharding.halo` (widths up to
  wider than a band, zero rows outside the map, the backward's cotangents
  added on the rank that owns the row), :func:`sharding.gather_rows`,
  :func:`sharding.spatial_mean` (bit-equal to the whole map's mean in
  f32), :func:`sharding.sum_stats`;
* ``ops/fused_upsample_conv.upsample_rows``: the 2x and 4x resizes of a
  band with its source rows bit-equal to the whole resize's rows (f32,
  bf16, f64), on the fusion's and the decoder's row ranges;
* the band gate (``models/hiera.head_bands``);
* the banded head against the whole head: f64 training mode (BatchNorm on
  batch statistics) within 1e-12 relative, every output, every parameter's
  gradient (the copies' gradients summed over the group: S times the whole
  head's, the trainer's rule), the stage outputs' gradients and the
  running statistics; f32 eval bit-equal;
* JAX's ``test`` SPEGNet under {data: 1, sp: 2} on the CPU mesh: its head's
  outputs come out H-sharded over ``sp``, the parity target of the bands."""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.parallel import mesh as jmesh
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops.fused_upsample_conv import source_rows, upsample_rows
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.utils.weights import init_weights

torch.set_num_threads(1)


# -- a spatial group of threads -----------------------------------------------------

class ThreadGroup:
    """S threads as the ranks of a group: a collective waits for all S."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=120)
        self.slots = [None] * size
        self.local = threading.local()

    def exchange(self, t: torch.Tensor):
        self.slots[self.local.rank] = t.detach().clone()
        self.barrier.wait()
        out = [s.clone() for s in self.slots]
        self.barrier.wait()
        return out


def _thread_gather(t, group):
    return group.exchange(t)


def _thread_reduce(t, group):
    parts = group.exchange(t)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return t.copy_(total)


@pytest.fixture(autouse=True)
def thread_collectives(monkeypatch):
    monkeypatch.setattr(sharding, "_all_gather", _thread_gather)
    monkeypatch.setattr(sharding, "_all_reduce", _thread_reduce)


def run_bands(size: int, fn, grad: bool = True):
    """``fn(band)`` on S threads, rank s on its RowBand (its BatchNorm
    statistics summed over the same S threads); their results in order."""
    group = ThreadGroup(size)
    out, errors = [None] * size, []

    def body(s):
        group.local.rank = s
        try:
            with torch.set_grad_enabled(grad):
                out[s] = fn(sharding.RowBand(group, s, size, group))
        except BaseException as e:   # the others then fail at the barrier
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(s,)) for s in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _band(x, band):
    n = x.shape[2] // band.size
    a, b = band.span(n)
    return x[:, :, a:b]


# -- the band primitives ------------------------------------------------------------

HALOS = [(1, 1), (0, 2), (2, 0), (3, 3), (6, 6), (18, 18)]


@pytest.mark.parametrize("before,after", HALOS)
@pytest.mark.parametrize("size,n", [(2, 1), (2, 5), (4, 2), (4, 8)])
def test_halo_is_the_sliced_map(size, n, before, after):
    """Rows [a - before, b + after) of the whole map, cut at its border
    (zero beyond it through ``Rows.padded``), whatever the width against
    the band; the backward adds each row's cotangent on the rank that owns
    it: the whole map's gradient of the sum of every rank's loss."""
    g = torch.Generator().manual_seed(size * 100 + n)
    whole = torch.randint(-8, 8, (2, 3, size * n, 5), generator=g).double().requires_grad_()
    cots = torch.randint(-8, 8, (size, 2, 3, n + before + after, 5), generator=g).double()

    def fn(band):
        rows = sharding.halo(_band(whole, band), band, before, after)
        a, b = band.span(n)
        got = rows.padded(a - before, b + after)
        (got * cots[band.index]).sum().backward()
        return rows.lo, rows.t.detach(), got.detach()

    res = run_bands(size, fn)
    grad_bands = whole.grad.clone()
    whole.grad = None
    padded = F.pad(whole, (0, 0, before, after))
    loss = 0
    for s, (lo, t, got) in enumerate(res):
        a, b = s * n, (s + 1) * n
        assert lo == max(a - before, 0)
        assert torch.equal(t, whole[:, :, lo:min(b + after, size * n)])
        want = padded[:, :, a:b + before + after]
        assert torch.equal(got, want)
        loss = loss + (want * cots[s]).sum()
    loss.backward()
    assert torch.equal(grad_bands, whole.grad)


@pytest.mark.parametrize("size", [2, 4])
def test_gather_rows(size):
    """The bands of several maps joined along H in index order, on every
    rank; the backward sums the ranks' cotangents and keeps the band."""
    g = torch.Generator().manual_seed(size)
    maps = [torch.randn(2, c, size * n, w, generator=g, dtype=torch.float64)
            for c, n, w in ((1, 3, 6), (4, 2, 3), (2, 1, 7))]
    leaves = [m.clone().requires_grad_() for m in maps]
    cots = [torch.randn(size, *m.shape, generator=g, dtype=torch.float64) for m in maps]

    def fn(band):
        out = sharding.gather_rows([_band(m, band) for m in leaves], band)
        sum((o * c[band.index]).sum() for o, c in zip(out, cots)).backward()
        return [o.detach() for o in out]

    for out in run_bands(size, fn):
        for o, m in zip(out, maps):
            assert torch.equal(o, m)
    for leaf, c in zip(leaves, cots):
        torch.testing.assert_close(leaf.grad, c.sum(0), rtol=1e-14, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("size", [2, 4])
def test_spatial_mean(size, dtype):
    """The group's mean of its bands equals the whole map's mean, bit for
    bit in f32 and bf16 (f64 sums rounded once), within 1e-15 in f64; its
    gradient is the whole mean's on each band."""
    g = torch.Generator().manual_seed(7)
    whole = (torch.randn(2, 8, 4 * size, 12, generator=g, dtype=torch.float64) * 3 + 1
             ).to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    want = sharding.spatial_mean(whole)
    (want.double() ** 2).sum().backward()
    gwant, whole.grad = whole.grad.clone(), None
    assert want.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)

    def fn(band):
        m = sharding.spatial_mean(_band(whole, band), band)
        (m.double() ** 2).sum().backward()
        return m.detach()

    for got in run_bands(size, fn):
        if dtype == torch.float64:
            torch.testing.assert_close(got, want.detach(), rtol=1e-15, atol=0)
        else:
            assert torch.equal(got, want.detach())
    # each rank's loss is the whole one, so the bands' gradient is S times
    torch.testing.assert_close(whole.grad.double(), size * gwant.double(), rtol=1e-2 if
                               dtype == torch.bfloat16 else 1e-6, atol=0)


@pytest.mark.parametrize("size", [2, 4])
def test_sum_stats(size):
    """BatchNorm's sums over ``band.stats``, differentiable."""
    vals = torch.arange(size * 3, dtype=torch.float64).view(size, 3)

    def fn(band):
        t = vals[band.index].clone().requires_grad_()
        s = sharding.sum_stats(t, band)
        (s * (band.index + 1)).sum().backward()
        return s.detach(), t.grad

    for s, g in run_bands(size, fn):
        assert torch.equal(s, vals.sum(0))
        assert torch.equal(g, torch.full((3,), size * (size + 1) / 2, dtype=torch.float64))


# -- the band resizes ---------------------------------------------------------------

RESIZES = [(2, 2), (2, 4), (4, 2), (4, 4), (2, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("scale,size", RESIZES)
def test_fusion_resize_is_bit_equal(scale, size, dtype):
    """The fusion's resize of a whole stage output onto a band: the band's
    source rows resized, bit-equal to the rows of the whole resize."""
    h = 4 * size // scale   # the output holds 4 rows a band
    src = torch.randn(2, 6, h, 5, generator=torch.Generator().manual_seed(scale),
                      dtype=torch.float64).to(dtype)
    src = src.contiguous(memory_format=torch.channels_last)
    whole = F.interpolate(src, size=(scale * h, scale * 5), mode="bilinear",
                          align_corners=False)
    n = scale * h // size
    for s in range(size):
        a, b = s * n, (s + 1) * n
        r0, r1 = source_rows(a, b, scale, h)
        got = upsample_rows(sharding.Rows(src[:, :, r0:r1], r0, h), scale, a, b)
        assert torch.equal(got, whole[:, :, a:b]), (s, r0, r1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("scale,size", RESIZES)
def test_decoder_resize_is_bit_equal(scale, size, dtype):
    """The decoder's 2x upsample (and the edge features' 2x / 4x resize) of
    a band with a halo of one source row: the output band with one row on
    each side, bit-equal to the whole resize's rows, zero beyond the map."""
    n_src = 3
    h = size * n_src
    src = torch.randn(1, 4, h, 6, generator=torch.Generator().manual_seed(size),
                      dtype=torch.float64).to(dtype)
    src = src.contiguous(memory_format=torch.channels_last)
    whole = F.pad(F.interpolate(src, size=(scale * h, scale * 6), mode="bilinear",
                                align_corners=False), (0, 0, 1, 1))
    n = scale * n_src
    for s in range(size):
        lo, hi = max(s * n_src - 1, 0), min((s + 1) * n_src + 1, h)
        rows = sharding.Rows(src[:, :, lo:hi], lo, h)
        got = upsample_rows(rows, scale, s * n - 1, (s + 1) * n + 1)
        assert torch.equal(got, whole[:, :, s * n:(s + 1) * n + 2]), s


def test_upsample_rows_refuses_missing_source_rows():
    src = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="read source rows"):
        upsample_rows(sharding.Rows(src[:, :, 2:6], 2, 8), 2, 4, 12)


# -- the gate -----------------------------------------------------------------------

@pytest.mark.parametrize("hw,sp,want", [
    (1024, 2, 64), (512, 2, 32), (512, 4, 16), ((512, 384), 4, 16), (384, 2, 24),
    (352, 4, 11), (352, 8, None), (64, 2, 4), (64, 4, 2), (64, 16, None), (640, 4, 20),
    (1024, 1, None), (1024, None, None), (96, 8, None),
])
def test_head_bands(hw, sp, want):
    """Banded where S divides H / 8, at any dtype and grid."""
    assert thiera.head_bands(hw, sp) == want


# -- the banded head against the whole head -----------------------------------------

def _head_case(size: int, dtype: torch.dtype, train: bool):
    """A ``test`` SPEGNet (seeded weights, perturbed running statistics),
    its stage 2-4 outputs at ``size`` and cotangents of its
    outputs."""
    model = init_weights(SPEGNet(SPEGNetConfig(variant="test", compute_dtype="float32"),
                                 kernels=False), torch.Generator().manual_seed(1)).to(dtype)
    rng = np.random.default_rng(size)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if "running_mean" in name:
                b.copy_(torch.from_numpy(rng.standard_normal(b.shape) * 0.1))
            elif "running_var" in name:
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape)))
        x = torch.from_numpy(rng.standard_normal((2, size, size, 3))).to(dtype)
        feats = [f.permute(0, 3, 1, 2).detach()
                 for f in model.encoder.encoder(x, kernels=False, dtype=dtype)[1:4]]
        out = model.eval().head(feats)
    cots = {k: torch.from_numpy(rng.standard_normal(t.shape)).to(dtype)
            for k, t in _flat(out).items()}
    return model.train(train), feats, cots


def _flat(out):
    d = {f"prediction {i}": p for i, p in enumerate(out["predictions"])}
    d["edge"] = out["edge"]
    d.update(out["features"])
    return d


def _objective(flat, cots):
    return sum((t * cots[k]).sum() for k, t in flat.items())


# The banded head's f64 gradients against the whole head's.  The e-ASPP
# global branch's BatchNorm normalizes two 1x1 maps of near-equal means, so
# the bands' mean, summed in another order (a difference of 1e-16), moves
# the gradient through it by up to 5e-11 of a tensor's max and, through
# context.reduce and the fusion, the whole flattened gradient by 1.5e-12 /
# 1.9e-12 relative L2 at 64^2 (S 2 / 4); 1.2e-14 / 2.4e-14 at 128^2
# (tests/test_torch_train.py notes the same conditioning).  So the whole
# flattened gradient (every head parameter and the stage outputs) is held
# to 5e-12 relative L2, each tensor to 1e-10 of its max, and the conv
# biases that feed a batch-statistics BatchNorm, whose gradient is 0 in
# exact arithmetic, to 1e-12 of the largest gradient.
HEAD_GRAD_L2_RTOL = 5e-12
HEAD_GRAD_TENSOR_RTOL = 1e-10


@pytest.mark.parametrize("size,sp", [(64, 2), (64, 4), (128, 2), (128, 4)])
def test_banded_head_f64_train_equals_whole(size, sp):
    """f64, training mode: the outputs and the running statistics within
    1e-12 relative, the gradients within HEAD_GRAD_*: every parameter's
    gradient summed over the ranks' copies is S times the whole head's
    (each rank's loss is the whole one, the trainer's rule), as are the
    stage outputs'.  e-ASPP's dilations reach past the neighbour's band
    here (H/8 of 8 or 16 rows over S ranks)."""
    model, feats, cots = _head_case(size, torch.float64, train=True)
    leaves = [f.clone().requires_grad_() for f in feats]
    whole_model = copy.deepcopy(model)
    want = _flat(whole_model.head(leaves))
    _objective(want, cots).backward()
    wants = {f"stage {i + 2}": sp * f.grad for i, f in enumerate(leaves)}
    for f in leaves:
        f.grad = None
    copies = [copy.deepcopy(model) for _ in range(sp)]

    def fn(band):
        out = _flat(copies[band.index].head(leaves, band))
        _objective(out, cots).backward()
        return {k: t.detach() for k, t in out.items()}

    for got in run_bands(sp, fn):
        for k, w in want.items():
            torch.testing.assert_close(got[k], w.detach(), rtol=1e-12,
                                       atol=1e-12 * float(w.detach().abs().max()), msg=k)
    gots = {f"stage {i + 2}": f.grad for i, f in enumerate(leaves)}
    for name, p in whole_model.named_parameters():
        if p.grad is not None:
            wants[name] = sp * p.grad
            gots[name] = sum(dict(c.named_parameters())[name].grad for c in copies)
    gmax = max(float(w.abs().max()) for w in wants.values())
    diff2 = ref2 = 0.0
    for name, w in wants.items():
        g, wmax = gots[name], float(w.abs().max())
        diff2 += float(((g - w) ** 2).sum())
        ref2 += float((w ** 2).sum())
        if wmax <= 1e-12 * gmax:
            assert float(g.abs().max()) <= 1e-12 * gmax, name
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=HEAD_GRAD_TENSOR_RTOL * wmax, msg=name)
    assert (diff2 / ref2) ** 0.5 <= HEAD_GRAD_L2_RTOL
    for name, b in whole_model.named_buffers():
        for c in copies:
            torch.testing.assert_close(dict(c.named_buffers())[name], b, rtol=1e-12, atol=1e-14,
                                       msg=name)


@pytest.mark.parametrize("size,sp", [(64, 2), (128, 4)])
def test_banded_head_f32_eval_is_bit_equal(size, sp):
    """f32, eval mode: the bands' outputs equal the whole head's bit for bit
    (the convolutions' rows and the resizes are the same sums, the means
    are rounded from f64), so a banded run writes the same mask bytes as
    one process."""
    model, feats, _ = _head_case(size, torch.float32, train=False)
    with torch.no_grad():
        want = _flat(model.head(feats))
    for got in run_bands(sp, lambda band: _flat(model.head(feats, band)), grad=False):
        for k, w in want.items():
            assert torch.equal(got[k], w), k


def test_band_shapes_and_halos():
    """Each rank's convolutions run on h / S rows plus their halos at every
    head resolution: e-ASPP's branches on 2 d more rows, the 3x3
    convolutions on 2 more, the 1x1 ones on the band."""
    model, feats, _ = _head_case(128, torch.float32, train=False)
    seen = {}

    def hook(name):
        def record(mod, args, out):
            seen.setdefault(threading.current_thread().name, []).append(
                (name, args[0].shape[2], out.shape[2]))
        return record

    handles = [dict(model.named_modules())[n].register_forward_hook(hook(n))
               for n in _head_convs(model)]
    try:
        run_bands(4, lambda band: model.head(feats, band), grad=False)
    finally:
        for h in handles:
            h.remove()
    modules = dict(model.named_modules())
    assert len(seen) == 4
    for calls in seen.values():
        assert sorted(n for n, _, _ in calls) == sorted(_head_convs(model))
        for name, rows_in, rows_out in calls:
            if "global_branch" in name:
                assert rows_in == rows_out == 1, name
                continue
            # H/8 is 16 rows; decoder block i and its head work at 2^(i + 1) x
            scale = 2 ** (int(name.split(".")[2]) + 1) if name.startswith("decoder.") else 1
            # the conv runs on the band and its halo, with its own padding,
            # and the band's rows are cut from its output
            assert rows_in == rows_out == 16 * scale // 4 + 2 * modules[name].padding[0], name


def _head_convs(model):
    return [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d) and not n.startswith("encoder")
            and n != "fusion.conv1x1"]


# -- the parity target: JAX's head is H-sharded -------------------------------------

def test_jax_head_outputs_are_h_sharded():
    """JAX's ``test`` SPEGNet under {data: 1, sp: 2} (f32, eval, 128^2): every
    head output leaves the jitted program split along H over ``sp``
    (GSPMD carries the trunk's P("data", sp) constraint through CFI, EFE and
    PED) -- what the port's bands compute."""
    mesh = jmesh.create_mesh({"data": 1, "sp": 2}, jax.devices()[:2])
    x = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(np.float32)
    variables = jax.jit(JaxSPEGNet(JaxConfig(variant="test")).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3), jnp.float32))
    model = JaxSPEGNet(JaxConfig(variant="test", spatial_axis="sp"))
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
        vs = jax.device_put(variables, NamedSharding(mesh, P()))
        out = jax.jit(model.apply)(vs, xs)
    heads = {f"prediction {i}": p for i, p in enumerate(out["predictions"])}
    heads["edge"] = out["edge"]
    heads.update(out["features"])
    for name, t in heads.items():
        spec = tuple(t.sharding.spec) + (None,) * (4 - len(t.sharding.spec))
        assert spec[1] == "sp" and spec[2:] == (None, None), (name, t.sharding.spec)
