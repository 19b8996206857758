"""Batch sharding, replication and the collectives of data and sequence
parallelism (port of spegnet_tpu/parallel/sharding.py).

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
  anything but all-reduce and broadcast of CUDA tensors).

The gradient rule of the collectives (engine/trainer.py): every collective's
backward is that of the global program whose objective is the sum of every
rank's loss, so an all-reduce's and an all-gather's backward both sum the
cotangents over the ranks they joined.  Each rank of a spatial group
computes the same loss, so that sum counts every sample S times, and the
trainer's average over the D S ranks divides it back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spegnet_tpu_torch.parallel.mesh import TokenShard, grouped


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
