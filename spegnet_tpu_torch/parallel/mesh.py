"""The device mesh over the processes of a torch.distributed group (port of
spegnet_tpu/parallel/mesh.py).

The JAX package lays its chips out as a ``jax.sharding.Mesh`` with a
``data`` axis (batch parallelism) and an optional ``model`` axis
(tensor-parallel encoder matmuls).  Here the "devices" of the mesh are the
processes of the torch.distributed group, one card (or the CPU) each:
``WORLD_SIZE`` under ``torchrun``, 1 without it.  Only the ``data`` axis is
ported: it is DistributedDataParallel over every process.  A ``model`` axis
larger than 1 raises NotImplementedError, as does ``model.spatial_axis``
(models/spegnet.SPEGNetConfig); so does a ``data`` axis that would leave a
process out, since each process runs the same program on its own rows.

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
from typing import Dict, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, in the spec's order) and this process's rank."""

    shape: Dict[str, int]
    rank: int = 0

    @property
    def data(self) -> int:
        return int(self.shape.get("data", 1))


def world_size() -> int:
    """The processes of the active group, else ``WORLD_SIZE`` (1 without
    ``torchrun``)."""
    if grouped():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def create_mesh(axes: Optional[Dict[str, int]] = None,
                world: Optional[int] = None) -> Mesh:
    """A mesh from an axis spec like {"data": -1} over ``world`` processes
    (default :func:`world_size`), by the JAX package's rules: one -1 axis
    absorbs the processes the fixed axes leave; two -1 axes, fixed axes
    that do not divide the processes, or a mesh larger than them raise
    ValueError."""
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
    for name, size in shape.items():
        if name != "data" and size > 1:
            raise NotImplementedError(
                f"parallel.mesh axis {name!r} = {size}: the port runs data parallelism only; "
                "tensor-parallel ('model') and spatial axes are not ported")
    if shape.get("data", 1) != n:
        raise ValueError(
            f"parallel.mesh data = {shape.get('data', 1)} but the torch.distributed world "
            f"has {n} processes: every process takes a share of the batch (set data to "
            f"{n} or -1, or launch that many processes)")
    return Mesh(shape, dist.get_rank() if grouped() else 0)


def grouped() -> bool:
    """Whether this process is in a torch.distributed group."""
    return dist.is_available() and dist.is_initialized()


def require_group(mesh: Mesh) -> None:
    """A data axis above 1 runs only in the process group that divides the
    batch: without it every process would take itself for rank 0."""
    if mesh.data > 1 and not grouped():
        raise RuntimeError(f"a data axis of {mesh.data} needs a torch.distributed group: "
                           "launch with torchrun (parallel/mesh.init_distributed)")


def mesh_from_config(parallel_cfg: Optional[Dict] = None,
                     world: Optional[int] = None) -> Mesh:
    """The mesh of the config's ``parallel.mesh`` (default {"data": -1})."""
    spec = (parallel_cfg or {}).get("mesh", {"data": -1})
    return create_mesh(spec, world)


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
