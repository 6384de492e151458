"""Training metrics: thresholded precision / recall of the class head.

The port of the JAX package's ``train/metrics.py``:
``precision_recall_counts`` (:17, torch, on the device, no host sync) and
the host-side accumulator ``PrecisionRecall`` (:40).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.9)


def precision_recall_counts(cls_preds: torch.Tensor, labels: torch.Tensor,
                            thresholds: Sequence[float] = THRESHOLDS
                            ) -> Dict[str, torch.Tensor]:
    """Counts for thresholded PR over the sigmoid cls head.

    cls_preds: [B, A, C] logits (background encoded as all-zeros).
    labels: [B, A] int (-1 ignore, 0 background, >0 class).

    Returns a dict of [T] int64 tensors: tp, fp, fn (summable across
    steps).
    """
    scores = torch.sigmoid(torch.amax(cls_preds, dim=-1))
    cared = labels >= 0
    positive = labels > 0
    th = torch.as_tensor(thresholds, dtype=scores.dtype,
                         device=scores.device)[:, None, None]
    pred_pos = (scores[None] >= th) & cared[None]
    tp = torch.sum(pred_pos & positive[None], dim=(1, 2))
    fp = torch.sum(pred_pos & ~positive[None] & cared[None], dim=(1, 2))
    fn = torch.sum(~pred_pos & positive[None] & cared[None], dim=(1, 2))
    return {"tp": tp, "fp": fp, "fn": fn}


class PrecisionRecall:
    """Host-side accumulator over :func:`precision_recall_counts`."""

    def __init__(self, thresholds: Sequence[float] = THRESHOLDS):
        self.thresholds = tuple(thresholds)
        self.clear()

    def clear(self):
        n = len(self.thresholds)
        self._tp = np.zeros(n)
        self._fp = np.zeros(n)
        self._fn = np.zeros(n)

    def update(self, counts: Dict[str, np.ndarray]):
        self._tp += np.asarray(counts["tp"])
        self._fp += np.asarray(counts["fp"])
        self._fn += np.asarray(counts["fn"])

    @property
    def value(self) -> Dict[str, np.ndarray]:
        prec = self._tp / np.maximum(self._tp + self._fp, 1)
        rec = self._tp / np.maximum(self._tp + self._fn, 1)
        return {"precision": prec, "recall": rec,
                "thresholds": np.asarray(self.thresholds)}

    def summary(self) -> str:
        v = self.value
        parts = [f"@{t:.1f} P={p:.3f} R={r:.3f}"
                 for t, p, r in zip(v["thresholds"], v["precision"],
                                    v["recall"])]
        return "PR " + " | ".join(parts)

