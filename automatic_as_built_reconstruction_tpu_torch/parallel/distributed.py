"""The process group of a data-parallel run.

The port of the JAX package's ``parallel/distributed.py``.  Where the
reference reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` and calls ``jax.distributed.initialize``, this module
reads torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and calls
``torch.distributed.init_process_group`` once, with an explicit timeout:
a rank that is lost fails every collective that waits for it, and so the
run, instead of hanging it.

Usage (the same program on every rank):

    torchrun --nproc_per_node 2 -m automatic_as_built_reconstruction_tpu_torch.cli \
        train --config_path ... --model_dir ... --num_devices 2
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

# how long a collective waits for the slowest rank before the run fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def multi_host_env() -> Optional[dict]:
    """torchrun's settings from the environment, or None for one
    process."""
    world = os.environ.get("WORLD_SIZE")
    if not world or int(world) <= 1:
        return None
    return {
        "init_method": (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}"
                        f":{os.environ.get('MASTER_PORT', '29500')}"),
        "world_size": int(world),
        "rank": int(os.environ.get("RANK", "0")),
        "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
    }


def ensure_initialized(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None, *,
                       backend: str = "gloo",
                       timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group once; True if this process is one rank of
    several.

    Explicit arguments > torchrun's variables > one process (a no-op that
    returns False).  ``timeout`` (``DEFAULT_TIMEOUT`` if None) bounds
    every collective of the group."""
    if dist.is_initialized():
        return True
    if init_method is None:
        env = multi_host_env()
        if env is None:
            return False
        init_method, world_size, rank = (env["init_method"],
                                         env["world_size"], env["rank"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout or DEFAULT_TIMEOUT)
    return True


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a global batch that every rank slices (each
    rank trains on its own part of every global batch)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    i = dist.get_rank() if dist.is_initialized() else 0
    return slice(i * per, (i + 1) * per)
