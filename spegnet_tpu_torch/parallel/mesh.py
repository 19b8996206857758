"""The device mesh over the processes of a torch.distributed group (port of
spegnet_tpu/parallel/mesh.py).

The JAX package lays its chips out as a ``jax.sharding.Mesh`` with a
``data`` axis (batch parallelism), an optional ``model`` axis
(tensor-parallel encoder matmuls) and, for sequence parallelism, the axis
that ``model.spatial_axis`` names (the token dim of the Morton trunk split
over it, spegnet_tpu/models/hiera.py:720-744).  Here the "devices" of the
mesh are the processes of the torch.distributed group, one card (or the
CPU) each: ``WORLD_SIZE`` under ``torchrun``, 1 without it.  Ranks are laid
out as JAX lays out its devices, ``devices[:total].reshape(sizes)`` in the
spec's order, so for ``{"data": D, "sp": S}`` rank = d S + s (:func:`layout`).

Three axes are ported, alone or together: ``data``, DistributedDataParallel
over the ranks that hold the same parameters (each data index takes its
rows of the batch); the spatial axis, whose S processes of one data index
take the same rows and split the trunk's tokens (models/hiera.py); and
``model``, whose M processes of one data index take the same rows and hold
1/M of the encoder's four large matmuls each (parallel/sharding.param_spec,
JAX's ``_param_spec``).  Under ``{"data": D, "sp": S, "model": M}`` the D S M
processes are laid out in the spec's order, whatever it is, and each holds
its index along each axis and the sub-groups of the torch.distributed group
that its collectives run on:

* ``sp_group``: the S ranks that differ in their spatial index only (the
  token gathers);
* ``model_group``: the M ranks that differ in their model index only (the
  weight gathers and the row-parallel sums);
* ``data_group``: the D ranks that differ in their data index only, one
  rank per data index (the sample weights and the reported losses, which
  are summed once per data index);
* ``replica_group``: the D S ranks of one model index, which hold the same
  shards (DDP's group: its gradient average never mixes two shards).

A group that the mesh does not need is None (an axis of 1 has no group of
its own; without a model axis above 1 DDP runs over every rank).  Any other
axis above 1 raises NotImplementedError, as does a mesh that would leave a
process out, since each process runs the same program on its share.

:func:`init_distributed` joins the group that ``torchrun`` describes in the
environment (or the one its arguments give) and picks the backend: NCCL
where every process of a host has a card of its own, gloo where processes
share a card (NCCL refuses two ranks on one device) or run on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, in the spec's order), this process's rank, the
    spatial axis (``model.spatial_axis``, None without one) and, in a process
    group, this process's sub-groups (module docstring; None where the mesh
    needs no such group)."""

    shape: Dict[str, int]
    rank: int = 0
    spatial_axis: Optional[str] = None
    sp_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    replica_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def data(self) -> int:
        return int(self.shape.get("data", 1))

    @property
    def model(self) -> int:
        """The model (tensor-parallel) axis's size M (1 without one)."""
        return int(self.shape.get("model", 1))

    @property
    def model_index(self) -> int:
        return self.coords().get("model", 0)

    @property
    def lead(self) -> bool:
        """Whether this rank is index 0 on every axis but ``data``: the one
        rank of its data index that writes its rows' files and records."""
        return self.sp_index == 0 and self.model_index == 0

    @property
    def sp(self) -> int:
        """The spatial axis's size S (1 without one)."""
        return int(self.shape.get(self.spatial_axis, 1)) if self.spatial_axis else 1

    def coords(self) -> Dict[str, int]:
        """This process's index along each axis."""
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.shape, idx)}

    @property
    def data_index(self) -> int:
        return self.coords().get("data", 0)

    @property
    def sp_index(self) -> int:
        return self.coords().get(self.spatial_axis, 0) if self.spatial_axis else 0

    @property
    def token_shard(self) -> Optional["TokenShard"]:
        """What the model needs of the spatial group (models/spegnet.py
        ``SPEGNet.shard_tokens``), None for S = 1."""
        if self.sp == 1:
            return None
        return TokenShard(self.sp_group, self.sp_index, self.sp)

    @property
    def model_shard(self) -> Optional["ModelShard"]:
        """What the model needs of the model group (models/spegnet.py
        ``SPEGNet.shard_model``), None for M = 1."""
        if self.model == 1:
            return None
        return ModelShard(self.model_group, self.model_index, self.model)


class TokenShard(NamedTuple):
    """A spatial group as the model sees it: the process group of the S
    ranks that split the trunk's tokens, this rank's index in it and S."""

    group: Any
    index: int
    size: int


class ModelShard(NamedTuple):
    """A model group as the model sees it: the process group of the M ranks
    that split the encoder's matmul weights, this rank's index in it and M."""

    group: Any
    index: int
    size: int


def layout(shape: Dict[str, int]) -> np.ndarray:
    """The ranks arranged as the mesh's axes: JAX's device order,
    ``devices[:total].reshape(sizes)`` (spegnet_tpu/parallel/mesh.py:40)."""
    return np.arange(math.prod(shape.values())).reshape(tuple(shape.values()))


def world_size() -> int:
    """The processes of the active group, else ``WORLD_SIZE`` (1 without
    ``torchrun``)."""
    if grouped():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def create_mesh(axes: Optional[Dict[str, int]] = None,
                world: Optional[int] = None, spatial_axis: Optional[str] = None) -> Mesh:
    """A mesh from an axis spec like {"data": -1} or {"data": 2, "sp": 2}
    over ``world`` processes (default :func:`world_size`), by the JAX
    package's rules: one -1 axis absorbs the processes the fixed axes leave;
    two -1 axes, fixed axes that do not divide the processes, or a mesh
    larger than them raise ValueError.  Besides ``data``, ``model`` and the
    axis ``spatial_axis`` names (the model's ``spatial_axis``) may exceed 1,
    together too.  Under a spatial or a model axis above 1 the sub-groups
    the mesh needs (module docstring) are made here: every process must make
    the same meshes in the same order."""
    n = world_size() if world is None else int(world)
    axes = dict(axes or {"data": -1})
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[sizes.index(-1)] = n // fixed
    shape = dict(zip(axes, (int(s) for s in sizes)))
    total = math.prod(shape.values())
    if total > n:
        raise ValueError(f"Mesh {shape} needs {total} devices, have {n}")
    if spatial_axis == "data":
        raise ValueError("model.spatial_axis names the data axis: the spatial axis splits "
                         "tokens over processes that share their rows, so it must be an "
                         "axis of its own (e.g. parallel.mesh {data: D, sp: S})")
    others = {a: s for a, s in shape.items() if a not in ("data", "model") and s > 1}
    for name, size in others.items():
        if name != spatial_axis:
            raise NotImplementedError(
                f"parallel.mesh axis {name!r} = {size}: no part of the port splits over it "
                f"(the data and model axes, and the spatial axis model.spatial_axis names, "
                f"{spatial_axis!r}, are the axes ported)")
    if total != n:
        raise ValueError(
            f"parallel.mesh {shape} covers {total} processes but the torch.distributed world "
            f"has {n} processes: every process takes a share of the batch (set data to "
            f"{n // max(total // shape.get('data', 1), 1)} or -1, or launch that many "
            "processes)")
    mesh = Mesh(shape, dist.get_rank() if grouped() else 0,
                spatial_axis if spatial_axis in shape else None)
    if grouped() and (mesh.sp > 1 or mesh.model > 1):
        groups = {"data_group": _subgroup(mesh, ("data",))}
        if mesh.sp > 1:
            groups["sp_group"] = _subgroup(mesh, (mesh.spatial_axis,))
        if mesh.model > 1:
            groups["model_group"] = _subgroup(mesh, ("model",))
            groups["replica_group"] = (groups["data_group"] if mesh.sp == 1 else
                                       _subgroup(mesh, tuple(a for a in shape if a != "model")))
        mesh = dataclasses.replace(mesh, **groups)
    return mesh


def axis_groups(shape: Dict[str, int], axis) -> List[List[int]]:
    """The ranks of each group along ``axis``, an axis name or a tuple of
    them (the ranks that differ in those axes' indices only), each group in
    index order (the later axis of a tuple fastest): the lines of
    :func:`layout`; each rank alone when the mesh has none of the axes."""
    axes = [a for a in ((axis,) if isinstance(axis, str) else axis) if a in shape]
    ranks = layout(shape)
    if not axes:
        return ranks.reshape(-1, 1).tolist()
    names = list(shape)
    ranks = np.moveaxis(ranks, [names.index(a) for a in axes], range(-len(axes), 0))
    return ranks.reshape(-1, math.prod(shape[a] for a in axes)).tolist()


def _subgroup(mesh: Mesh, axes: Tuple[str, ...]):
    """This process's process group along ``axes``; every process makes
    every group of them, in the same order, as new_group requires."""
    mine, _ = dist.new_subgroups_by_enumeration(axis_groups(mesh.shape, axes))
    return mine


def grouped() -> bool:
    """Whether this process is in a torch.distributed group."""
    return dist.is_available() and dist.is_initialized()


def require_group(mesh: Mesh) -> None:
    """A data, spatial or model axis above 1 runs only in the process group
    that divides the work: without it every process would take itself for
    rank 0."""
    for name, size in (("data", mesh.data), ("spatial", mesh.sp), ("model", mesh.model)):
        if size > 1 and not grouped():
            raise RuntimeError(f"a {name} axis of {size} needs a torch.distributed group: "
                               "launch with torchrun (parallel/mesh.init_distributed)")


def mesh_from_config(parallel_cfg: Optional[Dict] = None,
                     world: Optional[int] = None,
                     spatial_axis: Optional[str] = None) -> Mesh:
    """The mesh of the config's ``parallel.mesh`` (default {"data": -1});
    ``spatial_axis``: the config's ``model.spatial_axis``."""
    spec = (parallel_cfg or {}).get("mesh", {"data": -1})
    return create_mesh(spec, world, spatial_axis)


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None, world: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    The arguments default to ``torchrun``'s environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE; the store at MASTER_ADDR:MASTER_PORT
    unless ``init_method`` names one, e.g. ``file:///path``).  ``device``
    "cuda" gives each rank ``cuda:LOCAL_RANK`` over NCCL when the host has a
    card per local rank, else the ranks share the cards (LOCAL_RANK modulo
    their count) over gloo; "cpu" runs gloo on the CPU.  A failed
    initialisation raises: there is no retry on another backend."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    local_world = (int(os.environ.get("LOCAL_WORLD_SIZE", world)) if local_world is None
                   else local_world)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' "
                               "(--device cpu) to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= cards else "gloo"
        why = (f"{local_world} local ranks on {cards} cards"
               + ("" if backend == "nccl" else ": NCCL refuses two ranks on one card"))
    else:
        dev, backend, why = torch.device("cpu"), "gloo", "CPU ranks"
    kwargs = {} if init_method is None else {"init_method": init_method}
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    logger.info(f"rank {rank} of {world} on {dev}, backend {backend} ({why})")
    return dev


def destroy_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if grouped():
        dist.destroy_process_group()
