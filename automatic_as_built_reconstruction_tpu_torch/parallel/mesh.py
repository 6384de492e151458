"""A 1-D data-parallel mesh of ranks, and the helpers that move a batch,
the weights and the results across it.

The port of the JAX package's ``parallel/mesh.py``.  There one program
runs over a ``Mesh`` of devices and XLA inserts the collectives; here each
rank is a process with one device, and :class:`Mesh` is that rank's view:
its rank, the world size, its ``torch.device`` and the process groups.

The backend follows from the devices, chosen explicitly and logged:
``nccl`` where every rank has a card of its own, ``gloo`` on the CPU and
where ranks share a card (NCCL refuses two ranks on one device; gloo
reduces and broadcasts CUDA tensors through the host).  Only
``all_reduce`` and ``broadcast`` touch device tensors; host objects (a
batch, detections) travel through a gloo group by pickling.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel mesh."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any               # the device tensors' collectives
    host_group: Any          # pickled host objects (a gloo group)

    @property
    def is_main(self) -> bool:
        """Rank 0: it reads the data, logs and writes checkpoints."""
        return self.rank == 0


def rank_devices(num_devices: int, devices: Optional[Sequence] = None,
                 device="cuda") -> List[torch.device]:
    """The device of each rank: ``devices`` as given (several ranks may
    share one), else the first ``num_devices`` cards for a ``cuda``
    ``device`` (fewer visible is refused) or the CPU for each rank."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != num_devices:
            raise ValueError(f"{len(devs)} devices given for {num_devices} "
                             f"ranks")
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * num_devices
    else:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_devices))
        visible = torch.cuda.device_count()
        if visible < local:
            raise ValueError(f"requested {num_devices} devices, only "
                             f"{visible} visible")
        devs = [torch.device("cuda", i % local) for i in range(num_devices)]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"ranks on the CPU and on cards at once: {devs}")
    if devs[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"devices {devs} requested but "
                           f"torch.cuda.is_available() is false")
    return devs


def choose_backend(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    cards = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def data_parallel_mesh(num_devices: int, devices: Optional[Sequence] = None,
                       *, device="cuda", init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """This rank's :class:`Mesh` over ``num_devices`` ranks, joining the
    process group first where this process has not (``init_method`` and
    ``rank`` explicit, or torchrun's variables).  ``devices``: each
    rank's device (see :func:`rank_devices`)."""
    devs = rank_devices(num_devices, devices, device)
    backend = choose_backend(devs)
    if not distributed.ensure_initialized(init_method, num_devices, rank,
                                          backend=backend, timeout=timeout):
        raise RuntimeError(
            f"a mesh of {num_devices} ranks needs a process group: start "
            f"the ranks with torchrun, or call train / evaluate with "
            f"num_devices={num_devices}, which start them")
    if dist.get_world_size() != num_devices:
        raise ValueError(f"mesh of {num_devices} ranks in a process group "
                         f"of {dist.get_world_size()}")
    r = dist.get_rank()
    dev = devs[r]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.group.WORLD
    host = group if dist.get_backend() == "gloo" else dist.new_group(
        backend="gloo")
    if r == 0:
        why = ("every rank has a card of its own" if backend == "nccl"
               else "ranks share a device or run on the CPU")
        print(f"data-parallel mesh: {num_devices} ranks on "
              f"{[str(d) for d in devs]}, backend {dist.get_backend()} "
              f"({why})", flush=True)
    return Mesh(r, num_devices, dev, dist.get_backend(), group, host)


def rank_rows(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s contiguous rows of ``n`` split over ``size`` ranks
    (equal parts where ``n`` divides; the earlier ranks take fewer
    otherwise)."""
    return slice(n * rank // size, n * (rank + 1) // size)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array of a batch with the batch axis
    first (numpy stays numpy, a tensor stays a tensor)."""
    n = len(next(iter(batch.values())))
    rows = rank_rows(n, mesh.rank, mesh.size)
    return {k: v[rows] for k, v in batch.items()}


def scatter_batch(batch: Optional[dict], mesh: Mesh) -> Optional[dict]:
    """Rank 0 cuts ``batch`` (a dict of numpy arrays with the batch axis
    first; None on the other ranks) into each rank's rows and sends them;
    every rank gets its own.  ``batch=None`` on rank 0 sends None to every
    rank (the end of a stream)."""
    parts = None
    if mesh.is_main:
        parts = [None] * mesh.size
        if batch is not None:
            n = len(next(iter(batch.values())))
            parts = [{k: v[rank_rows(n, r, mesh.size)]
                      for k, v in batch.items()} for r in range(mesh.size)]
    out = [None]
    dist.scatter_object_list(out, parts, src=0, group=mesh.host_group)
    return out[0]


def gather_objects(obj, mesh: Mesh) -> Optional[list]:
    """Every rank's ``obj`` in rank order on rank 0, None elsewhere."""
    out = [None] * mesh.size if mesh.is_main else None
    dist.gather_object(obj, out, dst=0, group=mesh.host_group)
    return out


def all_gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` in rank order, on every rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers copied into every rank's
    ``module``, in place."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.group)
    return module


def all_reduce_sum(tensors: List[torch.Tensor], mesh: Mesh
                   ) -> List[torch.Tensor]:
    """The sums over the ranks of same-typed tensors, in one flattened
    all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return [s.view_as(t) for s, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def concat_rows(parts: list) -> dict:
    """Dicts of numpy arrays with the batch axis first (None for a rank
    that had no rows) -> one dict, in rank order."""
    parts = [p for p in parts if p is not None]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
