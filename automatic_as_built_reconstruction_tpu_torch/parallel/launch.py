"""Start the ranks of a data-parallel run from one process.

``train`` / ``evaluate`` with ``num_devices > 1``, called outside a
process group, start their ranks here: ``torch.multiprocessing`` in
``spawn`` mode (CUDA does not survive ``fork``), a ``file://``
rendezvous in a fresh temporary directory, and :func:`run_rank` as the
target of every child.  A child imports the function it runs, so that
function must be importable without JAX.  The kernels are built in the
parent first, so that the ranks do not build them at once.
"""
from __future__ import annotations

import datetime
import pickle
import tempfile
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from . import mesh as mesh_mod
from .distributed import multi_host_env


def spawn(fn: Callable, num_devices: int, devices: Sequence, args=(),
          timeout: Optional[datetime.timedelta] = None):
    """Run ``fn(mesh, *args)`` on ``num_devices`` new ranks, rank ``r`` on
    ``devices[r]``, and return rank 0's result.  A rank that raises ends
    the run: the other ranks are stopped and its exception is raised
    here."""
    devices = [str(torch.device(d)) for d in devices]
    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops import _build
        _build.build_all()
    threads = max(1, torch.get_num_threads() // num_devices)
    with tempfile.TemporaryDirectory(prefix="abr_ranks_") as tmp:
        init = Path(tmp, "rendezvous").as_uri()
        try:
            mp.spawn(run_rank, nprocs=num_devices, join=True,
                     args=(fn, num_devices, devices, init, timeout,
                           threads, tmp, args))
        except ProcessException:
            # the first rank to fail; the others may only have lost it
            errors = sorted(Path(tmp).glob("error.*"),
                            key=lambda p: p.stat().st_mtime_ns)
            if errors:
                with open(errors[0], "rb") as f:
                    raise pickle.load(f) from None
            raise
        with open(Path(tmp, "result"), "rb") as f:
            return pickle.load(f)


def run_rank(rank: int, fn: Callable, num_devices: int, devices: list,
             init_method: str, timeout, threads: int, tmp: str, args):
    """The target of every spawned rank: join the group, run ``fn``, leave
    the group; rank 0's result (or any rank's exception) goes to ``tmp``
    for the parent."""
    torch.set_num_threads(threads)
    try:
        mesh = mesh_mod.data_parallel_mesh(
            num_devices, devices, init_method=init_method, rank=rank,
            timeout=timeout)
        try:
            result = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
    except BaseException as e:
        path = Path(tmp, f"error.{rank}")
        try:
            with open(path, "wb") as f:
                pickle.dump(e, f)
        except Exception:       # an exception that does not pickle
            path.unlink(missing_ok=True)
        raise
    if rank == 0:
        with open(Path(tmp, "result"), "wb") as f:
            pickle.dump(result, f)


def in_process_group() -> bool:
    """Whether this process is already one rank of a group (spawned, or
    started by torchrun)."""
    return dist.is_initialized() or multi_host_env() is not None

