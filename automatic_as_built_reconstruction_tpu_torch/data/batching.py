"""Batch collation: stack fixed-capacity examples into device-ready arrays.

Every example is already padded to static capacity by ``prep_pointcloud``,
so batching is a plain stack.  The port's copy of the JAX package's
``data/batching.py``: ``merge_batch``, ``device_example`` (both carry the
host-built rulebooks, keys ``rb*``) and the bucketed shrinking
(``pick_bucket``, ``shrink_to_bucket``), and the host rulebooks of an
example built at its own bucket's plan padded up to the batch bucket's
(``pad_rulebooks_to_plan``).
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


def _pad_rows(a: np.ndarray, rows: int, fill) -> np.ndarray:
    if a.shape[0] >= rows:
        return a[:rows]
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _pad_cols(a: np.ndarray, cols: int, fill) -> np.ndarray:
    if a.shape[1] >= cols:
        return a[:, :cols]
    pad = np.full((a.shape[0], cols - a.shape[1]) + a.shape[2:], fill,
                  a.dtype)
    return np.concatenate([a, pad], axis=1)


def pad_rulebooks_to_plan(example: Dict[str, np.ndarray],
                          plan) -> Dict[str, np.ndarray]:
    """Pad an example's host rulebooks (built at its own bucket's plan) up
    to the shapes of ``plan`` (the batch bucket's plan).  The padding
    changes nothing: extra rulebook columns have ``found`` False, extra
    output sites ``out_valid`` False and coords -1, and the gather
    indices stay valid in the larger feature table."""
    out = dict(example)
    for i, blk in enumerate(plan):
        if f"rb{i}_subm_idx" not in out:
            break
        for key, size, fill, pad in (
                ("subm_idx", blk.in_cap, 0, _pad_cols),
                ("subm_found", blk.in_cap, False, _pad_cols),
                ("out_coords", blk.out_cap, -1, _pad_rows),
                ("out_valid", blk.out_cap, False, _pad_rows),
                ("down_idx", blk.out_cap, 0, _pad_cols),
                ("down_found", blk.out_cap, False, _pad_cols)):
            out[f"rb{i}_{key}"] = pad(out[f"rb{i}_{key}"], size, fill)
    return out


def device_example(batch: Dict[str, object]) -> Dict[str, np.ndarray]:
    """The array-only subset that is shipped to the device."""
    keys = ("voxels", "num_points", "coordinates", "anchors", "anchors_mask",
            "labels", "reg_targets", "importance")
    out = {k: batch[k] for k in keys if k in batch}
    out.update({k: v for k, v in batch.items() if k.startswith("rb")})
    return out
