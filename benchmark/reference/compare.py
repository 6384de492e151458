"""The numbers that decide ``correct``, each between the program's output
and the reference's."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BOX_ATOL = 1e-3      # metres and radians
SCORE_ATOL = 1e-4


def voxel_mismatch(got, ref) -> int:
    """Voxel rows whose points, count or coordinates differ (every row
    when the shapes differ)."""
    g_vox, g_n, g_c = (t.to(r.device) for t, r in zip(got, ref))
    if (g_vox.shape != ref.voxels.shape or g_n.shape != ref.num_points.shape
            or g_c.shape != ref.coords.shape):
        return int(np.prod(ref.num_points.shape))
    bad = ((g_vox != ref.voxels).flatten(2).any(-1)
           | (g_n != ref.num_points) | (g_c != ref.coords).any(-1))
    return int(bad.sum())


def head_gap(got: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> float:
    """The largest |program - reference| of each head map over the map's
    largest |reference|, the worst head."""
    worst = 0.0
    for name, r in ref.items():
        g = got.get(name)
        if g is None or g.shape != r.shape:
            return float("inf")
        g = g.to(r.device).float()
        scale = float(r.abs().max())
        diff = float((g - r).abs().max())
        if not np.isfinite(diff):
            return float("inf")
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


def unmatched(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
              num_class: int) -> Tuple[int, int]:
    """Detections matched one to one per (scan, class), box values within
    BOX_ATOL and scores within SCORE_ATOL.  -> (detections of either side
    left without a partner, detections of both sides)."""
    left = total = 0
    for b in range(ref["valid"].shape[0]):
        for c in range(num_class):
            sel_g = got["valid"][b] & (got["label_preds"][b] == c)
            sel_r = ref["valid"][b] & (ref["label_preds"][b] == c)
            gb, gs = got["box3d_lidar"][b][sel_g], got["scores"][b][sel_g]
            rb, rs = ref["box3d_lidar"][b][sel_r], ref["scores"][b][sel_r]
            used = np.zeros(len(rb), bool)
            for box, score in zip(gb, gs):
                ok = (~used & (np.abs(rb - box) <= BOX_ATOL).all(-1)
                      & (np.abs(rs - score) <= SCORE_ATOL))
                if ok.any():
                    used[np.flatnonzero(ok)[0]] = True
            paired = int(used.sum())
            left += (len(gb) - paired) + (len(rb) - paired)
            total += len(gb) + len(rb)
    return left, total
