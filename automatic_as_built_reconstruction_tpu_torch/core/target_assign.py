"""Anchor target assignment — vectorized NumPy (no per-anchor loops).

Produces per-anchor classification labels (-1 = ignore, 0 = background,
k>0 = class k) and encoded regression targets.  The port's copy of the
JAX package's ``core/target_assign.py`` (``create_targets`` :22 and
``TargetAssigner`` with ``generate_anchors`` and ``assign`` :178): the
same numpy in the same order, so the targets equal the reference's bit
for bit.  The training reader runs it on the host for every example.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from . import box_coders as box_coders_mod
from . import region_similarity


def create_targets(anchors: np.ndarray,
                   gt_boxes: np.ndarray,
                   similarity_fn,
                   box_encoding_fn,
                   gt_classes: Optional[np.ndarray] = None,
                   matched_threshold=0.6,
                   unmatched_threshold=0.45,
                   bbox_inside_weight=None,
                   norm_by_num_examples: bool = False,
                   box_code_size: int = 7,
                   anchor_mask: Optional[np.ndarray] = None):
    """Assign gt boxes to anchors (argmax matching with force-match).

    Args:
        anchors: [A, 7] all anchors.
        gt_boxes: [G, 7].
        similarity_fn: (anchors_bev, gt_bev) -> [A, G] similarity.
        box_encoding_fn: (gt[7], anchors[7]) -> [*, code] residuals.
        gt_classes: [G] int (1-based); defaults to all 1.
        matched_threshold / unmatched_threshold: scalar or [A].
        anchor_mask: optional [A] bool — anchors outside the mask are ignored
            (label -1, zero weights) and never matched.

    Returns dict with labels [A], bbox_targets [A, code], bbox_outside_weights
    [A], assigned_gt_inds [A] (−1 when unassigned).
    """
    num_anchors = anchors.shape[0]
    num_gt = gt_boxes.shape[0]
    if gt_classes is None:
        gt_classes = np.ones(num_gt, dtype=np.int32)
    matched_threshold = np.broadcast_to(
        np.asarray(matched_threshold, np.float32), (num_anchors,))
    unmatched_threshold = np.broadcast_to(
        np.asarray(unmatched_threshold, np.float32), (num_anchors,))

    labels = -np.ones((num_anchors,), dtype=np.int32)
    gt_ids = -np.ones((num_anchors,), dtype=np.int32)

    if num_gt > 0 and num_anchors > 0:
        if anchor_mask is not None:
            valid = np.asarray(anchor_mask, bool)
        else:
            valid = np.ones(num_anchors, dtype=bool)
        bev_a = anchors[:, [0, 1, 3, 4, 6]]
        bev_g = gt_boxes[:, [0, 1, 3, 4, 6]]
        sim = np.full((num_anchors, num_gt), -1e6, dtype=np.float32)
        sim[valid] = similarity_fn(bev_a[valid], bev_g).astype(np.float32)

        anchor_to_gt_argmax = sim.argmax(axis=1)
        anchor_to_gt_max = sim[np.arange(num_anchors), anchor_to_gt_argmax]

        gt_to_anchor_max = sim.max(axis=0)
        # gts with no positive overlap never force-match
        empty_gt = gt_to_anchor_max <= 0
        gt_to_anchor_max = np.where(empty_gt, -1.0, gt_to_anchor_max)

        # force match: every anchor achieving a gt's max similarity gets it
        anchors_with_max_overlap, gt_inds_force = np.where(
            sim == gt_to_anchor_max[None, :])
        labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]
        gt_ids[anchors_with_max_overlap] = gt_inds_force.astype(np.int32)

        # threshold matches (may overwrite force matches with the argmax gt —
        # same behavior as the lineage, which applies pos_inds after force)
        pos = anchor_to_gt_max >= matched_threshold
        labels[pos] = gt_classes[anchor_to_gt_argmax[pos]]
        gt_ids[pos] = anchor_to_gt_argmax[pos].astype(np.int32)

        bg = anchor_to_gt_max < unmatched_threshold
        # anchors below unmatched and not force-matched are background
        fg_now = labels > 0
        labels[bg & ~fg_now] = 0
        # anchors in the dead zone [unmatched, matched) stay -1 (ignore)
        if anchor_mask is not None:
            labels[~valid] = -1
            gt_ids[~valid] = -1
    else:
        labels[:] = 0

    bbox_targets = np.zeros((num_anchors, box_code_size), dtype=np.float32)
    fg = labels > 0
    if num_gt > 0 and fg.any():
        bbox_targets[fg] = box_encoding_fn(
            gt_boxes[gt_ids[fg]], anchors[fg]).astype(np.float32)

    bbox_outside_weights = np.zeros((num_anchors,), dtype=np.float32)
    if norm_by_num_examples:
        num_examples = max(int((labels >= 0).sum()), 1)
        bbox_outside_weights[labels > 0] = 1.0 / num_examples
    else:
        bbox_outside_weights[labels > 0] = 1.0

    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "bbox_outside_weights": bbox_outside_weights,
        "assigned_gt_inds": gt_ids,
    }


@dataclasses.dataclass
class TargetAssigner:
    """Multi-class assigner: per-class anchor generators concatenated over
    the feature map's anchor axis."""

    box_coder: box_coders_mod.BoxCoder
    anchor_generators: Sequence
    classes: Sequence[str]
    region_similarity_calculator: region_similarity.RegionSimilarityCalculator = None
    positive_fraction: Optional[float] = None
    sample_size: int = 512

    def __post_init__(self):
        if self.region_similarity_calculator is None:
            self.region_similarity_calculator = (
                region_similarity.NearestIouSimilarity())

    @property
    def num_anchors_per_location(self) -> int:
        return sum(g.num_anchors_per_localization
                   for g in self.anchor_generators)

    @property
    def box_code_size(self) -> int:
        return self.box_coder.code_size

    def class_id(self, name: str) -> int:
        return self.classes.index(name) + 1

    def generate_anchors(self, feature_map_size):
        """Returns dict with anchors [A,7], matched/unmatched thresholds [A].

        Per-location layout: [class0 anchors..., class1 anchors...] — i.e.
        generators interleave per spatial location (lineage concatenates on
        the anchors-per-location axis, axis=-2).
        """
        anchors_list, match_list, unmatch_list = [], [], []
        for gen in self.anchor_generators:
            anchors = gen.generate(feature_map_size)  # [D,H,W,S*R,7]
            anchors_list.append(anchors)
            n_per = gen.num_anchors_per_localization
            num_loc = anchors.shape[0] * anchors.shape[1] * anchors.shape[2]
            match_list.append(
                np.full((num_loc, n_per), gen.match_threshold, np.float32))
            unmatch_list.append(
                np.full((num_loc, n_per), gen.unmatch_threshold, np.float32))
        anchors = np.concatenate(anchors_list, axis=-2).reshape(-1, 7)
        matched = np.concatenate(match_list, axis=-1).reshape(-1)
        unmatched = np.concatenate(unmatch_list, axis=-1).reshape(-1)
        return {
            "anchors": anchors,
            "matched_thresholds": matched,
            "unmatched_thresholds": unmatched,
        }

    def assign(self, anchors, gt_boxes, anchors_mask=None, gt_classes=None,
               matched_thresholds=None, unmatched_thresholds=None,
               importance=None):
        """Single joint assignment over all classes (lineage `assign`)."""
        return create_targets(
            anchors, gt_boxes,
            similarity_fn=self.region_similarity_calculator.compare,
            box_encoding_fn=self.box_coder.encode,
            gt_classes=gt_classes,
            matched_threshold=(matched_thresholds
                               if matched_thresholds is not None else 0.6),
            unmatched_threshold=(unmatched_thresholds
                                 if unmatched_thresholds is not None else 0.45),
            box_code_size=self.box_coder.code_size,
            anchor_mask=anchors_mask,
        )
