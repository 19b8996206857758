"""Batch sharding, replication and the collectives of data parallelism
(port of spegnet_tpu/parallel/sharding.py, data axis only).

Under pjit the JAX package writes the global program and shards the batch's
leading axis over ``data`` (``batch_sharding``: ``P("data", ...)``); XLA
then inserts the all-reduces.  Here every rank runs the same program on its
own rows and the collectives are explicit:

* :func:`pad_batch` / :func:`shard_batch`: the global batch padded to a
  multiple of the data axis (the JAX trainer's ``_pad_batch``), then rank r's
  contiguous rows [r B / n, (r + 1) B / n), the split ``P("data")`` gives;
* :func:`replicated`: parameters and buffers broadcast from rank 0;
* :func:`all_reduce`: a sum over the ranks that autograd differentiates (its
  backward sums the gradients over the ranks), for statistics of the global
  batch inside the forward (models/cfi.BatchNorm2d);
* :func:`gather_in_order`: per-sample records of every rank, in dataset
  order, on every rank (pickled through the host, which gloo needs for
  anything but all-reduce and broadcast of CUDA tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spegnet_tpu_torch.parallel.mesh import grouped


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
    """Rank ``rank``'s rows of a batch of ``rows`` (a multiple of ``n``)."""
    if rows % n:
        raise ValueError(f"{rows} rows do not divide over {n} ranks")
    per = rows // n
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Any, rank: int, n: int) -> Any:
    """Rank ``rank``'s contiguous rows of every array and list field of a
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


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of a tensor that needs no gradient over the ranks (a copy)."""
    t = t.detach().clone()
    if active_world() > 1:
        dist.all_reduce(t)
    return t


def gather_in_order(records: Iterable[Tuple[int, Any]]) -> List[Any]:
    """Every rank's (global index, record) pairs, on every rank, as the
    records sorted by index."""
    mine = list(records)
    if active_world() > 1:
        parts: List[Sequence[Tuple[int, Any]]] = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        mine = [r for part in parts for r in part]
    return [r for _, r in sorted(mine, key=lambda p: p[0])]
