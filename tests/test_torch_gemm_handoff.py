"""The hand-off GEMM's launch plan, barrier protocol and dataflow
(csrc/gemm_handoff.cuh, kernels.gemm_plan) on the CPU.

The kernel computes C[M, N] = A[M, K] W[N, K]^T in 128 x 192 output tiles
for the bf16 products of width 192 without a residual.  Block b walks the
tiles b, b + grid, ... (N fastest); one producer thread fills a ring of
three stages (HO_STAGES), two MMA warpgroups take rows 0-63 / 64-127 of
each tile and hand their f32 sums through a buffer of their own to seven
epilogue warps, which take the two buffers in turn, add the bias, apply
the GELU, round to bf16 and store.

- The plan: every output tile is computed by exactly one block's walk, at
  every product of the kernel at 512^2, 384^2, 352^2, 640^2 and 1024^2
  (batch 8) and on ragged shapes (M, N and K tails, odd M-tile counts).
- The barriers: a simulation of the kernel's mbarriers (parity waits,
  arrival counts, the transaction bytes of the A and W loads landing in
  any order) over several tiles of 1-9 k-steps in random interleavings:
  every MMA warp reads the stage of its own (tile, k-step), no stage or
  hand-off buffer is overwritten before it is read, the epilogue warps
  read each tile's sums once, and nothing deadlocks; and a fault it must
  catch.
- The dataflow: the MMA threads' fragment stores and the epilogue lanes'
  float4 reads (the kernel's index expressions) cover the hand-off buffer
  once, without a bank conflict; through them, f32 sums in 64-deep k-steps
  give outputs bit-equal to the plain version's bias, GELU and rounding of
  the same sums (tests/test_torch_gemm_plan.bf16_epilogue), the sums
  within 1e-6 of torch.mm in f64; put in place of block_plain_res's fc1
  (ops/fused_block_t.py), the block holds against JAX's ``_kernel``
  (spegnet_tpu/ops/fused_block_t.py:349) interpreted, with
  tests/test_torch_blocks.py's tolerance.  The emulation takes the exact
  tanh: the kernel's exponential on the SFU (ex2.approx, rcp.approx) is
  not reproducible bit for bit here, and its share of differing GELU
  outputs is measured on the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_blocks import TOL, _jax_t_weights, _port_block, _weights
from test_torch_gemm_plan import bf16_epilogue, walks

from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block_t as tfbt

torch.set_num_threads(1)
SMS = 132
BM, BN, P = 128, 192, 200   # tile rows, tile columns, hand-off pitch (HO_P)
STAGES = 3                  # HO_STAGES
SIZES = (512, 384, 352, 640, 1024)
# the products the hand-off kernel takes at 512^2: each stage's fc1 and each
# transition front's stacked qkv + shortcut product, (N, K) by channels
PRODUCTS = {f"fc1_s{s + 1}": (s, 4 * (144 << s), 144 << s) for s in range(4)}
PRODUCTS.update({"t12": (0, 1152, 144), "t23": (1, 2304, 288), "t34": (2, 4608, 576)})
# M / N / K tails and odd M-tile counts (the first three the plan sends to
# the hand-off kernel; the last two as handoff_plan launches them)
RAGGED = [(4099, 1160, 200), (17000, 384, 72), (33001, 2304, 200), (1, 8, 8), (129, 200, 72)]


def product_shapes(batch=8):
    """name -> (M, N, K) of each product at each size of SIZES."""
    out = {}
    for size in SIZES:
        g = size // 4
        for name, (s, n, k) in PRODUCTS.items():
            side = -(-g // (1 << s))
            out[f"{name}_{size}"] = (batch * side * side, n, k)
    return out


SHAPES = {**product_shapes(), **{f"ragged_{m}_{n}_{k}": (m, n, k) for m, n, k in RAGGED}}


def handoff_plan(m, n, k):
    """The plan's hand-off launch for (M, N, K), or, where the plan takes
    the persistent kernel, the hand-off kernel's launch at the same shape
    (the kernel takes any M and N % 8 == 0)."""
    plan = kernels.gemm_plan(m, n, k, SMS)
    if plan.handoff:
        return plan
    tiles = -(-m // BM) * -(-n // BN)
    return kernels.GemmPlan(BN, -(-m // BM), -(-n // BN), min(tiles, SMS), True)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_handoff_plan_covers_every_output_once(name):
    """Every output tile lies in exactly one block's walk; the grid is
    min(tiles, SMs) and the busiest block takes ceil(tiles / grid)."""
    m, n, k = SHAPES[name]
    plan = handoff_plan(m, n, k)
    assert plan.bn == BN and plan.handoff
    assert plan.grid == min(plan.tiles, SMS)
    seen = np.zeros((plan.m_tiles, plan.n_tiles), np.int64)
    for walk in walks(plan):
        for m0, n0 in walk:
            assert m0 < m and n0 < n and m0 % BM == 0 and n0 % BN == 0
            seen[m0 // BM, n0 // BN] += 1
    assert (seen == 1).all()
    assert max(map(len, walks(plan))) == -(-plan.tiles // plan.grid)


def test_plan_sends_the_products_to_the_handoff_kernel():
    """At 512^2 batch 8 every fc1 and stacked product takes the hand-off
    kernel; qkv, proj, fc2 and the backward's products the persistent one
    (its residual epilogues or width 144)."""
    for name, (m, n, k) in product_shapes().items():
        if name.endswith("_512"):
            assert kernels.gemm_plan(m, n, k, SMS).handoff, name
    for s in range(4):
        c, m = 144 << s, 8 * (128 >> s) ** 2
        for n, k, res in ((3 * c, c, False), (c, c, True), (c, 4 * c, True),   # qkv proj fc2
                          (c, 4 * c, False), (c, 3 * c, False), (4 * c, c, True)):  # dX, dz
            assert not kernels.gemm_plan(m, n, k, SMS, "bf16", res).handoff


# ---------------------------------------------------------------------------
# the barrier protocol
# ---------------------------------------------------------------------------

class Bar:
    """An mbarrier: ``count`` arrivals and the transaction bytes of the
    phase complete it; ``phases`` counts completed phases."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phases = count, count, 0, 0

    def passes(self, parity):   # try_wait.parity
        return self.phases % 2 != parity

    def _maybe_complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phases += 1
            self.pending = self.count

    def arrive(self, tx=0):
        assert self.pending > 0
        self.pending -= 1
        self.tx += tx
        self._maybe_complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._maybe_complete()


EPI_WARPS = 7   # HO_EPI_WARPS


def simulate(tiles, nk, seed, empty_count=8):
    """Run one block of the hand-off kernel on ``tiles`` tiles of ``nk``
    k-steps each, choosing at random among the actors whose next action is
    enabled: the producer, the 8 MMA warps, the epilogue warps (each
    buffer in turn), and each TMA load in flight (A and W land apart).
    ``empty_count`` is the stages' empty-barrier count (the kernel's: one
    arrival per MMA warp).  Returns the (buffer, tile) hand-offs read, in
    order."""
    rnd = np.random.default_rng(seed)
    a_bytes, w_bytes = BM * 128, BN * 128
    full = [Bar(1) for _ in range(STAGES)]
    empty = [Bar(empty_count) for _ in range(STAGES)]
    hfull = [Bar(4) for _ in range(2)]             # arrivals counted per MMA warp
    hempty = [Bar(EPI_WARPS) for _ in range(2)]    # and per epilogue warp
    stage = [[None, None] for _ in range(STAGES)]  # the k-step of its A and W boxes
    readers = [set(range(8)) for _ in range(STAGES)]
    hand = [[None] * 4 for _ in range(2)]          # the tile in each MMA warp's rows
    hand_read = [set(range(EPI_WARPS)) for _ in range(2)]
    steps = tiles * nk
    prod = 0
    mma, mma_tiles = [0] * 8, [0] * 8              # steps consumed, tiles handed off
    epi = [0] * EPI_WARPS                          # buffers read (2 per tile)
    inflight, got = [], []

    def prod_action():
        it = prod
        if it >= steps:
            return None
        s, ph = it % STAGES, (it // STAGES) & 1
        if it >= STAGES and not empty[s].passes(ph ^ 1):
            return None

        def act():
            nonlocal prod
            full[s].arrive(tx=a_bytes + w_bytes)
            inflight.extend([(0, it, s, a_bytes), (1, it, s, w_bytes)])
            prod += 1
        return act

    def land(i):
        part, it, s, nbytes = inflight.pop(i)
        assert readers[s] == set(range(8)), "stage overwritten before every warp read it"
        stage[s][part] = it
        full[s].complete_tx(nbytes)
        if stage[s] == [it, it]:
            readers[s] = set()

    def mma_action(w):
        it, t, wg = mma[w], mma_tiles[w], w // 4
        if t >= tiles:
            return None
        if it == (t + 1) * nk:
            # the tile's k-loop is done: hand its sums off
            if t > 0 and not hempty[wg].passes((t - 1) & 1):
                return None

            def handoff():
                assert hand_read[wg] == set(range(EPI_WARPS)), "hand-off overwritten before read"
                hand[wg][w % 4] = t
                if hand[wg] == [t] * 4:
                    hand_read[wg] = set()
                mma_tiles[w] += 1
                hfull[wg].arrive()
            return handoff
        s, ph = it % STAGES, (it // STAGES) & 1
        if not full[s].passes(ph):
            return None

        def consume():
            assert stage[s] == [it, it], "wrong stage"
            readers[s].add(w)
            empty[s].arrive()   # lane 0, once the warp's MMAs that read it retired
            mma[w] += 1
        return consume

    def epi_action(e):
        t, h = divmod(epi[e], 2)
        if t >= tiles or not hfull[h].passes(t & 1):
            return None

        def read():
            assert hand[h] == [t] * 4, "hand-off read before its tile was written"
            hand_read[h].add(e)
            if e == 0:
                got.append((h, t))
            epi[e] += 1
            hempty[h].arrive()
        return read

    while True:
        acts = [prod_action()] + [mma_action(w) for w in range(8)]
        acts += [epi_action(e) for e in range(EPI_WARPS)]
        acts = [a for a in acts if a is not None]
        acts += [(lambda i=i: land(i)) for i in range(len(inflight))]
        if not acts:
            break
        acts[rnd.integers(len(acts))]()
    assert all(n == 2 * tiles for n in epi) and not inflight, "deadlock"
    return got


@pytest.mark.parametrize("tiles,nk", [(1, 1), (3, 1), (2, 2), (4, 3), (3, 9), (5, 4)])
def test_barriers_cross_tile_boundaries(tiles, nk):
    """In random interleavings (four seeds), each MMA warp reads its own
    (tile, k-step) from every stage, the stages and the hand-off buffers
    are refilled only once read, the epilogue warps read each tile's sums
    of each buffer once and in order, and the walk ends."""
    for seed in range(4):
        got = simulate(tiles, nk, seed)
        for h in range(2):
            assert [t for b, t in got if b == h] == list(range(tiles))


def test_barrier_fault_is_caught():
    """The simulation catches a protocol fault: an empty barrier counting
    one MMA warpgroup's warps only lets the producer overwrite a stage the
    other warpgroup has not read."""
    with pytest.raises(AssertionError):
        for seed in range(20):
            simulate(4, 3, seed, empty_count=4)


# ---------------------------------------------------------------------------
# the dataflow
# ---------------------------------------------------------------------------

def fragment_offsets():
    """[128, 96] hand-off buffer offsets of each MMA thread's 96 sums (as
    the kernel stores them: hb = (16w + g) P + 2t, then + 8j and + 8P for
    the row 8 below) and the [128, 96] (row, column) of the 64 x 192 tile
    each sum holds (wgmma's accumulator layout, common.cuh)."""
    tid = np.arange(128)[:, None]
    w, lane = tid // 32, tid % 32
    g, t = lane >> 2, lane & 3
    i = np.arange(96)[None, :]
    j, hh, e = i // 4, (i % 4) // 2, i % 2
    off = (16 * w + g) * P + 2 * t + 8 * j + 8 * P * hh + e
    row, col = 16 * w + g + 8 * hh, 8 * j + 2 * t + e
    return off, row * np.ones_like(i), col * np.ones_like(tid)


def epilogue_reads():
    """[EPI_WARPS * 32, pairs, 3] (row, chunk) of the float4 each epilogue
    lane reads of a buffer: warp e takes row pairs q = e, e + EPI_WARPS, ...
    of the 32, lane l the chunks flat = 32j + l (chunk flat % 48 of row 2q +
    flat / 48)."""
    pairs = -(-32 // EPI_WARPS)
    tid = np.arange(32 * EPI_WARPS)[:, None, None]
    ew, lane = tid // 32, tid % 32
    q = ew + EPI_WARPS * np.arange(pairs)[None, :, None]
    j = np.arange(3)[None, None, :]
    flat = 32 * j + lane
    rl, ch = 2 * q + flat // 48, flat % 48 + 0 * q
    keep = np.broadcast_to(q < 32, rl.shape)
    return rl, ch, keep


def test_handoff_layout_covers_the_tile_once():
    """The MMA threads' stores put sum (row, col) at row * P + col, each
    once; the epilogue lanes read each (row, 4-column chunk) of the 64 x 192
    tile once; the pad columns are never read."""
    off, row, col = fragment_offsets()
    assert (off == row * P + col).all()
    assert sorted(off.ravel()) == sorted((r * P + c) for r in range(64) for c in range(BN))
    rl, c, keep = epilogue_reads()
    pairs = sorted(zip(rl[keep], c[keep]))
    assert pairs == [(r, ch) for r in range(64) for ch in range(BN // 4)]


def banks(addr_bytes, width):
    """The 4-byte banks a lane's access of ``width`` bytes touches."""
    return [(addr_bytes + 4 * i) // 4 % 32 for i in range(width // 4)]


def test_handoff_buffer_has_no_bank_conflicts():
    """Each phase of a warp's shared-memory access (16 lanes of 8 bytes, 8
    lanes of 16 bytes) touches 32 distinct banks: the float2 stores of the
    MMA warps and the float4 reads of the epilogue warps."""
    off, _, _ = fragment_offsets()
    for w in range(4):
        for i in range(0, 96, 2):   # one float2 store: d[i], d[i + 1]
            lanes = off[32 * w:32 * w + 32, i] * 4
            for ph in range(2):
                b = [x for a in lanes[16 * ph:16 * ph + 16] for x in banks(int(a), 8)]
                assert len(set(b)) == 32, (w, i, ph)
    rl, c, _ = epilogue_reads()
    addr = (rl * P + 4 * c) * 4
    for ew in range(EPI_WARPS):
        for p in range(rl.shape[1]):
            for j in range(3):
                lanes = addr[32 * ew:32 * ew + 32, p, j]
                for ph in range(4):
                    b = [x for a in lanes[8 * ph:8 * ph + 8] for x in banks(int(a), 16)]
                    assert len(set(b)) == 32, (ew, p, j, ph)


def emulate_handoff(a, w, bias=None, act="none"):
    """The hand-off kernel by its dataflow: per tile of its walk, f32 sums
    in 64-deep k-steps (zero-filled tails), stored by the MMA threads into
    the two 64-row hand-off buffers, read by the epilogue lanes as float4
    chunks, + bias, -> tanh GELU, rounded to a's dtype, stored where the
    row and column lie in the matrix (each output once).  Returns the f32
    sums and the output (a pair for "gelu_pre")."""
    m, k = a.shape
    n = w.shape[0]
    plan = handoff_plan(m, n, k)
    kp = -(-k // 64) * 64
    mp, np_ = plan.m_tiles * BM, plan.n_tiles * BN
    ap = F.pad(a.float(), (0, kp - k, 0, mp - m))
    wp = F.pad(w.float(), (0, kp - k, 0, np_ - n))
    bp = F.pad(bias.float(), (0, np_ - n)) if bias is not None else torch.zeros(np_)
    off, frow, fcol = fragment_offsets()
    off, frow, fcol = (torch.from_numpy(x.ravel()) for x in (off, frow, fcol))
    rl, ch, keep = epilogue_reads()
    rl, ch = (torch.from_numpy(np.ascontiguousarray(x[keep])) for x in (rl, ch))
    quad = torch.arange(4)
    sums = torch.full((m, n), float("nan"))
    outs = [torch.full((m, n), float("nan"), dtype=a.dtype)
            for _ in range(2 if act == "gelu_pre" else 1)]
    written = torch.zeros((m, n), dtype=torch.int64)
    for walk in walks(plan):
        for m0, n0 in walk:
            s = torch.zeros((BM, BN))
            for k0 in range(0, kp, 64):
                s = s + ap[m0:m0 + BM, k0:k0 + 64] @ wp[n0:n0 + BN, k0:k0 + 64].T
            for half in range(2):
                buf = torch.full((64 * P,), float("nan"))
                buf[off] = s[half * 64:half * 64 + 64][frow, fcol]
                buf = buf.reshape(64, P)
                rows, cols = m0 + half * 64 + rl, n0 + 4 * ch
                keep = (rows < m) & (cols < n)
                rows, cols, r_, c_ = rows[keep], cols[keep], rl[keep], ch[keep]
                h = buf[r_[:, None], 4 * c_[:, None] + quad]       # [reads, 4] float4s
                cq = cols[:, None] + quad
                v = h + bp[cq]
                g = F.gelu(v, approximate="tanh")
                res = (v, g) if act == "gelu_pre" else (g if act == "gelu" else v,)
                rq = rows[:, None].expand_as(cq)
                sums[rq, cq] = h
                for o, x in zip(outs, res):
                    o[rq, cq] = x.to(a.dtype)
                written.index_put_((rq, cq), torch.ones_like(cq), accumulate=True)
    assert (written == 1).all()
    return sums, (tuple(outs) if act == "gelu_pre" else outs[0])


@pytest.mark.parametrize("act", ["none", "gelu", "gelu_pre"])
@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (129, 200, 72), (300, 392, 200)])
def test_emulated_handoff_matches_plain_rounding(rng, m, n, k, act):
    """bf16 operands with M / N / K tails: the emulated outputs bit-equal to
    the plain version's bias, GELU and rounding of the same f32 sums, with
    and without a bias; the sums within 1e-6 of torch.mm in f64."""
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()  # noqa: E731
    a, w, bias = bf(m, k), bf(n, k), bf(n)
    for b in (bias, None):
        s, out = emulate_handoff(a, w, b, act)
        want = bf16_epilogue(s, b, None, act, torch.bfloat16)
        for got, exp in zip(out if act == "gelu_pre" else (out,),
                            want if act == "gelu_pre" else (want,)):
            assert torch.equal(got, exp), (act, b is None)
    ref = a.double() @ w.double().T
    assert float((s.double() - ref).abs().max() / ref.abs().max()) <= 1e-6


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    yield


@pytest.mark.parametrize("c,heads,d,l,n", [(32, 2, 16, 16, 256), (64, 2, 32, 64, 256)])
def test_emulated_fc1_in_block_matches_jax_kernel(rng, interpret, monkeypatch, c, heads, d, l,
                                                  n):
    """block_plain_res with its fc1 and GELU (z, g) from the emulated
    GELU-pre epilogue against JAX's ``_kernel`` in interpret mode; z and g
    equal the plain version's rounding of the same sums."""
    w = _weights(rng, c, heads, d)
    wts = _port_block(w)
    made = {}

    def linear(x, wt, b=None):
        if wt is not wts.wfc1:
            return F.linear(x, wt, b)
        s, (z, g) = emulate_handoff(x.reshape(-1, x.shape[-1]), wt, b, "gelu_pre")
        assert all(torch.equal(u, v) for u, v in
                   zip((z, g), bf16_epilogue(s, b, None, "gelu_pre", x.dtype)))
        z = z.reshape(*x.shape[:-1], -1)
        made[z.data_ptr()] = g.reshape(z.shape)
        return z

    def gelu(z, approximate="none"):
        assert approximate == "tanh"
        return made.pop(z.data_ptr())

    funcs = {k: getattr(F, k) for k in dir(F) if not k.startswith("_")}
    funcs.update(linear=linear, gelu=gelu)
    monkeypatch.setattr(tfbt, "F", types.SimpleNamespace(**funcs))
    x = (rng.standard_normal((2, n, c)) * 0.5).astype(np.float32)
    got, res = tfbt.block_plain_res(torch.from_numpy(x), wts, heads, l, d ** -0.5, 1e-6,
                                    approx_gelu=True)
    assert not made and res.z.shape == (2 * n, 4 * c)
    jw, hp = _jax_t_weights(w, heads, d)
    ker = np.asarray(jfbt._forward(jnp.asarray(x.transpose(0, 2, 1)), jw, heads=heads, hp=hp,
                                   l=l, scale=d ** -0.5, eps=1e-6, approx_gelu=True,
                                   interpret=True)).transpose(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), ker, **TOL)
