"""Batch sharding, replication, the model axis's parameter partition and the
collectives of data, sequence and tensor parallelism (port of
spegnet_tpu/parallel/sharding.py).

Under pjit the JAX package writes the global program and shards the batch's
leading axis over ``data`` (``batch_sharding``: ``P("data", ...)``); XLA
then inserts the all-reduces.  Here every rank runs the same program on its
own rows and the collectives are explicit:

* :func:`pad_batch` / :func:`shard_batch`: the global batch padded to a
  multiple of the data axis (the JAX trainer's ``_pad_batch``), then data
  index d's contiguous rows [d B / n, (d + 1) B / n), the split ``P("data")``
  gives (every rank of a spatial group takes the rows of its data index);
* :func:`replicated`: parameters and buffers broadcast from rank 0;
* :func:`all_reduce`: a sum over the ranks that autograd differentiates (its
  backward sums the gradients over the ranks), for statistics of the global
  batch inside the forward (models/cfi.BatchNorm2d);
* :func:`gather_tokens`: the token shards of a spatial group joined on
  every rank of it (models/hiera.py), differentiable; :func:`all_reduce_sum`
  over a sub-group (the data group's sample weights and losses);
* :func:`gather_in_order`: per-sample records of every rank, in dataset
  order, on every rank (pickled through the host, which gloo needs for
  anything but all-reduce and broadcast of CUDA tensors);
* the head's row bands (models/spegnet.py): :class:`RowBand`, a rank's band
  of rows of every head map; :func:`halo`, its band with the rows of its
  neighbours that a convolution or a resize reads (:class:`Rows`);
  :func:`spatial_mean`, a per-sample spatial mean over the group's bands;
  :func:`gather_rows`, the bands joined along H; :func:`sum_stats`, the
  BatchNorm statistics' sum;
* the model (tensor-parallel) axis: :func:`param_spec`, JAX's
  ``_param_spec`` over the reference state-dict names; :func:`shard_param` /
  :func:`join_shards` / :func:`gather_param` between a full tensor and a
  rank's shard; :func:`gather_weights`, a block's weights all-gathered over
  the model group for the kernels that take full weights; and
  :func:`reduce_partial`, the all-reduce of a row-parallel product's partial
  sums (models/hiera.py).

The gradient rule of the collectives (engine/trainer.py): every
collective's backward is that of the global program whose objective is the
sum of every rank's loss, so an all-reduce's and an all-gather's backward
both sum the cotangents over the ranks they joined.  Each rank of a spatial
or a model group computes the same loss, so that sum counts every sample S
M times, and the trainer divides it back.

Under both axes a rank runs collectives on five groups (parallel/mesh.py):
the token gathers on its spatial group, the weight gathers and row-parallel
sums on its model group, the sample weights and losses on its data group,
DDP's buckets on its replica group, and the BatchNorm statistics on the
whole group; the head's halos, means and row gathers run on its spatial
group.  Every rank runs the same program, so it calls them in the
same order on every group (the recompute of a checkpointed block runs its
forward's again, in the forward's order), and no two ranks wait for each
other on different groups, which under gloo would hang rather than fail.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.parallel.mesh import ModelShard, TokenShard, grouped


def active_world() -> int:
    """The number of ranks of the active process group (1 without one)."""
    return dist.get_world_size() if grouped() else 1


def pad_batch(batch: Any, n: int) -> Tuple[Any, np.ndarray]:
    """(batch padded to a multiple of ``n`` rows, sample weights): every
    array field of the batch dataclass repeats its row 0 for the padding
    rows, whose weight is 0 (``Trainer._pad_batch``,
    spegnet_tpu/engine/trainer.py:423-446).  Losses and metric means leave
    the padding out; train-mode BatchNorm counts it, as in JAX."""
    b = batch.images.shape[0]
    target = -(-b // n) * n
    w = np.ones((target,), np.float32)
    if target == b:
        return batch, w
    w[b:] = 0.0
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            fields[k] = np.concatenate([v, np.repeat(v[:1], target - b, axis=0)])
    return type(batch)(**fields), w


def rows_of(rank: int, n: int, rows: int) -> slice:
    """Data index ``rank``'s rows of a batch of ``rows`` (a multiple of
    ``n``, the data axis)."""
    if rows % n:
        raise ValueError(f"{rows} rows do not divide over {n} ranks")
    per = rows // n
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Any, rank: int, n: int) -> Any:
    """Data index ``rank``'s contiguous rows of every array and list field of a
    batch dataclass whose leading size is a multiple of ``n``."""
    rows = batch.images.shape[0]
    sl = rows_of(rank, n, rows)
    fields = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, (np.ndarray, list)) and len(v) == rows:
            v = v[sl]
        fields[f.name] = v
    return type(batch)(**fields)


def replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 (a no-op
    without a group of more than one rank)."""
    if active_world() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0)
    return module


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks, differentiable: the backward sums the
    cotangents over the ranks, as the global program's does."""
    from torch.distributed.nn.functional import all_reduce as _all_reduce

    return _all_reduce(t)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of a tensor that needs no gradient over the ranks of ``group``
    (default: every rank), a copy."""
    t = t.detach().clone()
    if active_world() > 1:
        dist.all_reduce(t, group=group)
    return t


class _GatherTokens(torch.autograd.Function):
    """All-gather along dim 1 over ``group``; the backward sums the
    cotangents over the group (an all-reduce) and keeps this rank's slice.
    Built from all_gather and all_reduce, which gloo (CPU and CUDA tensors)
    and NCCL both run."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.group, ctx.index, ctx.size = group, index, size
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        n = g.shape[1] // ctx.size
        return g[:, ctx.index * n:(ctx.index + 1) * n], None, None, None


def gather_tokens(x: torch.Tensor, shard: TokenShard) -> torch.Tensor:
    """[B, n, C] token shards of the S ranks of a spatial group (mesh.py
    ``TokenShard``) -> [B, S n, C] on each, in index order.  The backward sums
    the cotangents over the group and keeps this rank's rows: the K / V
    gather of a global block, where each rank's queries give a part of
    every key's gradient, and the gather of the trunk's stage outputs, whose
    consumers every rank of the group computes alike (the trainer divides
    that S-fold sum back; module docstring).  A group of one gathers
    nothing."""
    if shard.size == 1:
        return x
    return _GatherTokens.apply(x, shard.group, shard.index, shard.size)


def gather_in_order(records: Iterable[Tuple[int, Any]]) -> List[Any]:
    """Every rank's (global index, record) pairs, on every rank, as the
    records sorted by index."""
    mine = list(records)
    if active_world() > 1:
        parts: List[Sequence[Tuple[int, Any]]] = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        mine = [r for part in parts for r in part]
    return [r for _, r in sorted(mine, key=lambda p: p[0])]


# -- the model (tensor-parallel) axis ------------------------------------------

# Reference state-dict suffixes of the encoder's block parameters that the
# model axis splits (spegnet_tpu/parallel/sharding.py:39-63): qkv and fc1 by
# output features (a torch weight's rows, JAX's kernel columns) with their
# biases, attn.proj and fc2 by input features (a torch weight's columns).
_BY_OUT = (".attn.qkv.weight", ".attn.qkv.bias", ".mlp.layers.0.weight",
           ".mlp.layers.0.bias")
_BY_IN = (".attn.proj.weight", ".mlp.layers.1.weight")


def param_spec(name: str) -> Tuple[Optional[str], ...]:
    """The partition of the parameter ``name`` (a reference state-dict key)
    over the model axis, in the torch tensor's own dims: ("model", None) for
    the qkv and fc1 weights, ("model",) for their biases, (None, "model") for
    the attention's proj and fc2 weights, () (replicated) for everything
    else -- the transition blocks' own proj, the fc2 and proj biases, the
    norms, the decoder, the BatchNorm statistics.  JAX's rule on its [in,
    out] kernels, transposed."""
    if not name.startswith("encoder.") or ".blocks." not in name:
        return ()
    if name.endswith(_BY_OUT):
        return ("model",) if name.endswith("bias") else ("model", None)
    if name.endswith(_BY_IN):
        return (None, "model")
    return ()


def shard_dim(name: str) -> Optional[int]:
    """The dim that the model axis splits in ``name``'s tensor, None if it
    is replicated."""
    spec = param_spec(name)
    return spec.index("model") if spec else None


def _split_dim(name: str) -> Optional[int]:
    """The split dim from a parameter name's suffix alone (a block-relative
    name like "attn.qkv.weight" will do), None for a replicated one."""
    name = "." + name
    return 0 if name.endswith(_BY_OUT) else 1 if name.endswith(_BY_IN) else None


def _parts(name: str) -> int:
    """qkv's rows are q, k and v: a shard holds its slice of each, so that
    it holds whole heads where the axis divides them."""
    return 3 if "attn.qkv." in name else 1


def shard_param(name: str, full: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Rank ``index``'s shard of the full tensor of parameter ``name`` over a
    model axis of ``size`` (a copy; the tensor itself if it is replicated).
    A split dim takes contiguous chunks, except qkv's, which takes the
    ``index``-th chunk of each of q, k and v: rank i holds heads [i H / M,
    (i + 1) H / M) where M divides H.  JAX splits the 3C columns
    contiguously instead; what is held equal is the full tensor that
    :func:`join_shards` rebuilds."""
    dim = shard_dim(name)
    if dim is None or size == 1:
        return full
    parts, n = _parts(name), full.shape[dim]
    if n % (parts * size):
        raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} does not split "
                         f"into {parts} x {size} shards")
    view = full.unflatten(dim, (parts, size, n // (parts * size)))
    return view.select(dim + 1, index).flatten(dim, dim + 1).contiguous()


def join_shards(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The full tensor of parameter ``name`` (its reference key, or its
    name in its block) from every rank's shard, in model index order
    (differentiable); a replicated one is any rank's."""
    dim = _split_dim(name)
    if dim is None or len(shards) == 1:
        return shards[0]
    parts = _parts(name)
    stacked = torch.stack([s.unflatten(dim, (parts, -1)) for s in shards], dim + 1)
    return stacked.flatten(dim, dim + 2)


def gather_param(name: str, shard: torch.Tensor, group: ModelShard) -> torch.Tensor:
    """The full tensor of parameter ``name`` on every rank of the model
    group from each rank's ``shard`` (no gradient: checkpoints, reports)."""
    if shard_dim(name) is None or group.size == 1:
        return shard
    parts = [torch.empty_like(shard) for _ in range(group.size)]
    dist.all_gather(parts, shard.detach().contiguous(), group=group.group)
    return join_shards(name, parts)


class _GatherFlat(torch.autograd.Function):
    """All-gather of a flat tensor over ``group`` into [size, n]; the
    backward sums the cotangents over the group (an all-reduce) and keeps
    this rank's row: a reduce-scatter, built from the two collectives that
    gloo (CPU and CUDA tensors) and NCCL both run."""

    @staticmethod
    def forward(ctx, flat, group, index, size):
        ctx.group, ctx.index = group, index
        out = flat.new_empty((size, flat.numel()))
        dist.all_gather(list(out.unbind(0)), flat.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


def gather_weights(named: Sequence[Tuple[str, torch.Tensor]],
                   group: ModelShard) -> List[torch.Tensor]:
    """The full tensors of a block's sharded parameters, (name in the block,
    shard) pairs of one dtype, from one all-gather over the model group.  The
    backward is a reduce-scatter: each shard's gradient summed over the
    group's ranks (the module docstring's rule: every rank of the group ran
    the block on the same rows, and the trainer divides that M-fold sum
    back)."""
    if group.size == 1:
        return [t for _, t in named]
    flat = torch.cat([t.reshape(-1) for _, t in named])
    rows = _GatherFlat.apply(flat, group.group, group.index, group.size).unbind(0)
    full, off = [], 0
    for n, t in named:
        full.append(join_shards(n, [r[off:off + t.numel()].view(t.shape) for r in rows]))
        off += t.numel()
    return full


def reduce_partial(t: torch.Tensor, group: ModelShard) -> torch.Tensor:
    """The sum over the model group of a row-parallel product's partial sums
    (taken in the accumulation dtype, before the cast to the compute
    dtype), differentiable: the backward sums the cotangents over the
    group."""
    from torch.distributed.nn.functional import all_reduce as _all_reduce

    return _all_reduce(t, group=group.group)


# -- the head's row bands -------------------------------------------------------
#
# Under a spatial axis JAX constrains the trunk's NHWC outputs to P("data",
# sp, None, None) (spegnet_tpu/models/hiera.py:710-724) and GSPMD carries
# that H-sharding through CFI, EFE and PED.  Here rank s of a spatial group
# of S computes the head on rows [s h / S, (s + 1) h / S) of every map of h
# rows (H/8, H/4, H/2, H), and fetches from the other ranks the rows its
# convolutions and resizes read beyond its band.  Each primitive below is
# differentiated as the global program (module docstring): its backward
# sums the cotangents over the ranks it joined.  They run on two
# collectives, all-gather and all-reduce, which gloo (CPU and CUDA tensors)
# and NCCL both run, through :func:`_all_gather` and :func:`_all_reduce`.


class RowBand(NamedTuple):
    """Rank ``index`` of the ``size`` ranks of the process group ``group``
    (a spatial group): its band of every head map, rows [index n, (index +
    1) n) of a map of ``size`` n rows; ``stats``: the process group that the
    BatchNorm statistics sum over (None: every rank, as without bands)."""

    group: Any
    index: int
    size: int
    stats: Any = None

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's rows [a, b) of a map whose bands hold ``n`` rows."""
        return self.index * n, (self.index + 1) * n


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank of ``group``), in index
    order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (None: every rank), in place."""
    dist.all_reduce(t, group=group)
    return t


class _SumOver(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents over it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def sum_stats(t: torch.Tensor, band: Optional[RowBand] = None) -> torch.Tensor:
    """A BatchNorm's sums of x, x^2 and its count over the ranks
    (models/cfi.BatchNorm2d): over every rank (:func:`all_reduce`), or over
    ``band.stats``, differentiable."""
    if band is None:
        return all_reduce(t)
    return _SumOver.apply(t, band.stats)


def spatial_mean(x: torch.Tensor, band: Optional[RowBand] = None) -> torch.Tensor:
    """[B, C] per-sample mean over H and W of an NCHW map, or with ``band``
    of the map whose bands the group holds (``x``: this rank's): the band's
    sums, summed over the group, over h w.  The sums are taken in f64 and
    the mean returned in the accumulation dtype (f32, f64 for f64), so that
    the bands' mean rounds as the whole map's does: summed in f32, the two
    orders of the sum differ in the last bits."""
    s = x.sum((2, 3), dtype=torch.float64)
    if band is not None:
        s = _SumOver.apply(s, band.group)
    n = x.shape[2] * x.shape[3] * (1 if band is None else band.size)
    return (s / n).to(wide(x).dtype)


class Rows(NamedTuple):
    """Rows [lo, lo + t.shape[2]) of an NCHW map of ``h`` rows: a band with
    the rows around it that :func:`halo` fetched, cut at the map's
    border."""

    t: torch.Tensor
    lo: int
    h: int

    def padded(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of the map, zero outside it (a convolution's
        padding); they must lie in these rows where they lie in the map."""
        a, b = max(lo, 0), min(hi, self.h)
        if a < self.lo or b > self.lo + self.t.shape[2]:
            raise ValueError(f"rows [{lo}, {hi}) are not in rows [{self.lo}, "
                             f"{self.lo + self.t.shape[2]}) of {self.h}")
        t = self.t[:, :, a - self.lo:b - self.lo]
        return F.pad(t, (0, 0, a - lo, hi - b)) if (a - lo or hi - b) else t


def _halo_pieces(n: int, k: int, lo: int, hi: int, index: int):
    """(owner, its rows [l0, l1), the first row's place in its export; None
    for rank ``index``'s own) of rows [lo, hi) of a map whose bands hold
    ``n`` rows each, where every rank exports its band (k = n) or its first
    and last k rows."""
    for o in range(lo // n, (hi - 1) // n + 1):
        l0, l1 = max(lo, o * n) - o * n, min(hi, (o + 1) * n) - o * n
        if o == index:
            yield o, l0, l1, None
        elif k == n or l1 <= k:
            yield o, l0, l1, l0
        else:
            assert l0 >= n - k, (n, k, lo, hi)
            yield o, l0, l1, k + l0 - (n - k)


def _as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` in ``like``'s memory format (channels-last where the head's
    maps are)."""
    if like.dim() == 4 and like.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


class _Halo(torch.autograd.Function):
    """Rows [lo, hi) of the map whose bands (dim 2, n rows each) the group
    holds, from this rank's band ``x``: every rank exports its band, or its
    first and last k rows where k < n, and the exports are all-gathered.
    The backward puts each fetched row's cotangent in its owner's export,
    all-reduces the exports and adds this rank's to its band: the
    cotangent goes back to the rank that owns the row."""

    @staticmethod
    def forward(ctx, x, group, index, size, lo, hi, k):
        n = x.shape[2]
        ctx.meta = (group, index, size, lo, hi, k, n)
        exp = x if k == n else torch.cat([x[:, :, :k], x[:, :, n - k:]], 2)
        parts = _all_gather(exp.contiguous(), group)
        pieces = [x[:, :, l0:l1] if o == index else parts[o][:, :, e0:e0 + l1 - l0]
                  for o, l0, l1, e0 in _halo_pieces(n, k, lo, hi, index)]
        return _as(torch.cat(pieces, 2), x)

    @staticmethod
    def backward(ctx, g):
        group, index, size, lo, hi, k, n = ctx.meta
        b, c, _, w = g.shape
        gx = g.new_zeros((b, c, n, w))
        buf = g.new_zeros((size, b, c, n if k == n else 2 * k, w))
        off = 0
        for o, l0, l1, e0 in _halo_pieces(n, k, lo, hi, index):
            piece = g[:, :, off:off + l1 - l0]
            off += l1 - l0
            if o == index:
                gx[:, :, l0:l1] += piece
            else:
                buf[o][:, :, e0:e0 + l1 - l0] += piece
        mine = _all_reduce(buf, group)[index]
        if k == n:
            gx += mine
        else:
            gx[:, :, :k] += mine[:, :, :k]
            gx[:, :, n - k:] += mine[:, :, k:]
        return gx, None, None, None, None, None, None


def halo(x: torch.Tensor, band: RowBand, before: int, after: int) -> Rows:
    """This rank's band ``x`` (NCHW, n rows) with the ``before`` rows above
    it and the ``after`` rows below it, of any width (a neighbour's band is
    n rows; wider halos reach further ranks), cut at the map's border:
    rows [max(a - before, 0), min(b + after, S n)).  One all-gather; every
    rank of the group calls it with the same widths."""
    n = x.shape[2]
    a, b = band.span(n)
    lo, hi = max(a - before, 0), min(b + after, band.size * n)
    k = min(n, max(before, after))
    return Rows(_Halo.apply(x, band.group, band.index, band.size, lo, hi, k), lo,
                band.size * n)


class _GatherRows(torch.autograd.Function):
    """Bands of several maps joined along H on every rank, in index order,
    from one all-gather of their flattened values; the backward sums the
    cotangents over the group (an all-reduce) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, group, index, *xs):
        ctx.group, ctx.index = group, index
        ctx.shapes = [x.shape for x in xs]
        parts = _all_gather(torch.cat([x.reshape(-1) for x in xs]), group)
        out, off = [], 0
        for x in xs:
            m = x.numel()
            out.append(_as(torch.cat([p[off:off + m].view(x.shape) for p in parts], 2), x))
            off += m
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        out, off = [], 0
        for g, shape in zip(gs, ctx.shapes):
            n = shape[2]
            whole = flat[off:off + g.numel()].view(g.shape)
            out.append(whole[:, :, ctx.index * n:(ctx.index + 1) * n])
            off += g.numel()
        return (None, None, *out)


def gather_rows(xs: Sequence[torch.Tensor], band: RowBand) -> List[torch.Tensor]:
    """The whole maps, on every rank of the group, from this rank's bands
    ``xs`` (NCHW, one dtype), in one all-gather."""
    return list(_GatherRows.apply(band.group, band.index, *xs))
