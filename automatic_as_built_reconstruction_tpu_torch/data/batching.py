"""Batch collation: stack fixed-capacity examples into device-ready arrays.

Every example is already padded to static capacity by ``prep_pointcloud``,
so batching is a plain stack.  The port's copy of the JAX package's
``data/batching.py``: ``merge_batch``, ``device_example`` (both carry the
host-built rulebooks, keys ``rb*``) and the bucketed shrinking
(``pick_bucket``, ``shrink_to_bucket``).  The host-rulebook padding to a
bucket's plan (``pad_rulebooks_to_plan``) is not ported: no config pairs
host rulebooks with ``static_shape_buckets``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_STACK_KEYS = (
    "voxels", "num_points", "coordinates", "num_voxels", "anchors",
    "anchors_mask", "labels", "reg_targets", "importance",
)
_LIST_KEYS = ("metadata", "calib", "gt_boxes", "gt_names")


def merge_batch(examples: List[Dict[str, np.ndarray]]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k in examples[0].keys():
        if k in _STACK_KEYS or k.startswith("rb"):
            # rb* = host-built sparse-conv rulebooks (ops/rulebook_host.py)
            out[k] = np.stack([e[k] for e in examples])
        elif k in _LIST_KEYS:
            out[k] = [e[k] for e in examples]
    return out


_VOXEL_CAP_KEYS = ("voxels", "num_points", "coordinates")


def pick_bucket(num_voxels: int, buckets) -> int:
    """Smallest bucket >= the example's active voxel count (last bucket =
    full capacity catches overflow)."""
    for b in buckets:
        if num_voxels <= b:
            return int(b)
    return int(buckets[-1])


def shrink_to_bucket(example: Dict[str, np.ndarray],
                     bucket: int) -> Dict[str, np.ndarray]:
    """Slice the voxel-capacity arrays down to ``bucket`` rows.

    Valid voxels are stored first, so slicing drops only padding (or, for
    overflowing scans, the FCFS tail: the same semantics as a smaller
    ``max_voxels``; ``num_voxels`` is clamped so downstream masks
    agree)."""
    out = dict(example)
    for k in _VOXEL_CAP_KEYS:
        if k in out and out[k].shape[0] > bucket:
            out[k] = out[k][:bucket]
    if "num_voxels" in out:
        out["num_voxels"] = np.minimum(out["num_voxels"],
                                       bucket).astype(np.int32)
    return out


def device_example(batch: Dict[str, object]) -> Dict[str, np.ndarray]:
    """The array-only subset that is shipped to the device."""
    keys = ("voxels", "num_points", "coordinates", "anchors", "anchors_mask",
            "labels", "reg_targets", "importance")
    out = {k: batch[k] for k in keys if k in batch}
    out.update({k: v for k, v in batch.items() if k.startswith("rb")})
    return out
