"""Detection AP evaluation.

- :func:`evaluate_lidar_ap`: rotated-box AP (BEV + 3D) in the lidar
  frame, 41-point interpolation, greedy matching per scene; what
  ``BuildingDataset`` reports.
- :func:`get_official_eval_result`: the KITTI protocol (``KittiDataset``):
  per-class IoU thresholds, easy / moderate / hard gating (image-box
  height, occlusion, truncation), ignored and DontCare handling, bbox /
  BEV / 3D / AOS at 11 and 40 recall points.

Host NumPy throughout; rotated overlaps use the exact polygon clip of
``core/geometry.py``.  The port's copy of the JAX package's
``utils/eval.py``; where the reference takes its C++ statistics kernel
(``eval_statistics`` / ``eval_tp_scores``) this copy runs the Python
statistics, which the reference's own tests hold equal to it.
"""
from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import box_ops, geometry


# ---------------------------------------------------------------------------
# shared: greedy matching + AP
# ---------------------------------------------------------------------------


def _ap_interp(recalls: np.ndarray, precisions: np.ndarray,
               num_points: int = 41) -> float:
    """N-point interpolated AP (KITTI uses 41; older protocol 11)."""
    ap = 0.0
    for t in np.linspace(0, 1, num_points):
        mask = recalls >= t
        p = float(precisions[mask].max()) if mask.any() else 0.0
        ap += p / num_points
    return ap


def _match_class(gt_list, det_list, overlap_fn, iou_threshold):
    """Greedy per-scene matching.

    gt_list/det_list: per-scene arrays ([G,7], ([D,7], [D] scores)).
    Returns (scores sorted desc, tp flags, num_gt).
    """
    all_scores, all_tp = [], []
    num_gt = sum(len(g) for g in gt_list)
    for gts, (dets, scores) in zip(gt_list, det_list):
        if len(dets) == 0:
            continue
        order = np.argsort(-scores)
        dets, scores = dets[order], scores[order]
        if len(gts) == 0:
            all_scores.append(scores)
            all_tp.append(np.zeros(len(dets), bool))
            continue
        iou = overlap_fn(dets, gts)  # [D, G]
        taken = np.zeros(len(gts), bool)
        tp = np.zeros(len(dets), bool)
        for d in range(len(dets)):
            g = int(np.argmax(np.where(taken, -1.0, iou[d])))
            if iou[d, g] >= iou_threshold and not taken[g]:
                taken[g] = True
                tp[d] = True
        all_scores.append(scores)
        all_tp.append(tp)
    if not all_scores:
        return np.zeros(0), np.zeros(0, bool), num_gt
    scores = np.concatenate(all_scores)
    tp = np.concatenate(all_tp)
    order = np.argsort(-scores)
    return scores[order], tp[order], num_gt


def _pr_ap(tp_sorted: np.ndarray, num_gt: int, num_points=41) -> float:
    if num_gt == 0 or len(tp_sorted) == 0:
        return 0.0
    tp_cum = np.cumsum(tp_sorted)
    fp_cum = np.cumsum(~tp_sorted)
    recalls = tp_cum / num_gt
    precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    return _ap_interp(recalls, precisions, num_points)


# ---------------------------------------------------------------------------
# generic lidar-frame AP (building scans)
# ---------------------------------------------------------------------------


def _bev_overlap(dets, gts):
    return geometry.rotate_iou_matrix(
        dets[:, [0, 1, 3, 4, 6]], gts[:, [0, 1, 3, 4, 6]])


def _3d_overlap(dets, gts):
    return geometry.d3_box_overlap(dets, gts)


def evaluate_lidar_ap(gt_annos: List[dict], detections: List[dict],
                      class_names: Sequence[str],
                      iou_thresholds: Dict[str, float],
                      num_points: int = 41) -> dict:
    """AP per class, BEV + 3D, in the lidar frame.

    gt_annos[i]: {"boxes": [G,7], "names": [G] str}.
    detections[i]: {"box3d_lidar": [D,7], "scores": [D],
                    "label_preds": [D] int 0-based}.
    """
    results = {}
    for ci, cname in enumerate(class_names):
        thr = iou_thresholds.get(cname, 0.5)
        gt_list, det_list = [], []
        for gt, det in zip(gt_annos, detections):
            gmask = np.asarray(gt["names"]) == cname
            gt_list.append(np.asarray(gt["boxes"], np.float64)[gmask])
            dmask = np.asarray(det["label_preds"]) == ci
            det_list.append((
                np.asarray(det["box3d_lidar"], np.float64)[dmask],
                np.asarray(det["scores"], np.float64)[dmask]))
        for metric, fn in (("bev", _bev_overlap), ("3d", _3d_overlap)):
            scores, tp, num_gt = _match_class(gt_list, det_list, fn, thr)
            results[f"{cname}.{metric}.ap"] = _pr_ap(tp, num_gt, num_points)
            results[f"{cname}.{metric}.num_gt"] = num_gt
    aps_bev = [results[f"{c}.bev.ap"] for c in class_names]
    aps_3d = [results[f"{c}.3d.ap"] for c in class_names]
    results["mAP.bev"] = float(np.mean(aps_bev))
    results["mAP.3d"] = float(np.mean(aps_3d))
    return results


# ---------------------------------------------------------------------------
# KITTI official protocol
# ---------------------------------------------------------------------------

# difficulty gates: [min bbox height px, max occlusion, max truncation]
MIN_HEIGHT = (40, 25, 25)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
DIFFICULTY_NAMES = ("easy", "moderate", "hard")

# class -> (bbox/bev/3d) min overlaps, moderate protocol
OVERLAPS = {
    "Car": (0.7, 0.7, 0.7),
    "Pedestrian": (0.5, 0.5, 0.5),
    "Cyclist": (0.5, 0.5, 0.5),
    "Van": (0.7, 0.7, 0.7),
    "Truck": (0.7, 0.7, 0.7),
}
SIMILAR = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}


def kitti_difficulty(anno: dict) -> np.ndarray:
    """Per-object difficulty (0/1/2; -1 = harder than 'hard')."""
    heights = anno["bbox"][:, 3] - anno["bbox"][:, 1]
    occ = anno["occluded"]
    trunc = anno["truncated"]
    n = len(heights)
    diff = np.full(n, -1, np.int32)
    for d in (2, 1, 0):
        ok = ((heights >= MIN_HEIGHT[d]) & (occ <= MAX_OCCLUSION[d])
              & (trunc <= MAX_TRUNCATION[d]))
        diff[ok] = d
    return diff


def clean_data(gt_anno, dt_anno, cls_name, difficulty):
    """Devkit cleanData: per-object codes + DontCare boxes.

    Returns (ignored_gt [G] int8, ignored_det [D] int8, dc_bboxes,
    num_valid_gt) with devkit codes: 0 = counted, 1 = ignored (absorbs
    matches without TP/FP), -1 = other class (plays no role).
    """
    cls_lower = cls_name.lower()
    similar = tuple(s.lower() for s in SIMILAR.get(cls_name, ()))
    heights = gt_anno["bbox"][:, 3] - gt_anno["bbox"][:, 1]
    ignored_gt = np.empty(len(gt_anno["name"]), np.int8)
    num_valid_gt = 0
    for i, name in enumerate(gt_anno["name"]):
        name = name.lower()
        if name == cls_lower:
            valid_class = 1
        elif name in similar:
            valid_class = 0
        else:
            valid_class = -1
        # devkit: gt too small uses <=, occl/trunc use >
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or heights[i] <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt[i] = 0
            num_valid_gt += 1
        elif valid_class == 0 or (valid_class == 1 and ignore):
            ignored_gt[i] = 1
        else:
            ignored_gt[i] = -1
    dc_bboxes = gt_anno["bbox"][gt_anno["name"] == "DontCare"]

    dt_heights = dt_anno["bbox"][:, 3] - dt_anno["bbox"][:, 1]
    ignored_det = np.empty(len(dt_anno["name"]), np.int8)
    for i, name in enumerate(dt_anno["name"]):
        valid_class = 1 if name.lower() == cls_lower else -1
        if dt_heights[i] < MIN_HEIGHT[difficulty]:
            ignored_det[i] = 1     # too small: ignored regardless of class
        elif valid_class == 1:
            ignored_det[i] = 0
        else:
            ignored_det[i] = -1
    return ignored_gt, ignored_det, dc_bboxes, num_valid_gt


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = 41) -> np.ndarray:
    """Devkit getThresholds: score cutoffs at ~evenly spaced recall steps.

    ``scores`` are the scores of all matched TPs (any order); at most
    ``num_sample_pts`` thresholds come back, descending.
    """
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.asarray(thresholds, np.float32)


_NO_DETECTION = -10000000.0


def compute_statistics_py(overlaps, ignored_gt, ignored_det, dt_scores,
                          dc_overlap, gt_alpha, dt_alpha, compute_aos,
                          min_overlap, thresh, compute_fp):
    """Pure-Python devkit computeStatistics.  (The reference runs its C++
    twin where its library built; its own tests hold the two equal.)"""
    D, G = overlaps.shape
    assigned = np.zeros(D, bool)
    ignored_threshold = np.zeros(D, bool)
    if compute_fp:
        ignored_threshold = np.asarray(dt_scores) < thresh
    tp = fp = fn = 0
    sim = 0.0
    tp_scores = []
    for i in range(G):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(D):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and score > valid_detection):
                det_idx, valid_detection = j, score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap, det_idx = overlap, j
                valid_detection, assigned_ignored_det = 1.0, False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == _NO_DETECTION
                  and ignored_det[j] == 1):
                det_idx, valid_detection = j, 1.0
                assigned_ignored_det = True
        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != _NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            tp_scores.append(dt_scores[det_idx])
            if compute_aos:
                sim += 0.5 * (1.0 + np.cos(gt_alpha[i] - dt_alpha[det_idx]))
            assigned[det_idx] = True
    if compute_fp:
        for j in range(D):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        NDC = dc_overlap.shape[1] if dc_overlap.size else 0
        for k in range(NDC):
            for j in range(D):
                if (assigned[j] or ignored_det[j] in (-1, 1)
                        or ignored_threshold[j]):
                    continue
                if dc_overlap[j, k] > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
    if not (tp > 0 or fp > 0):
        sim = 0.0
    return tp, fp, fn, sim, np.asarray(tp_scores, np.float32)


def _dc_overlap_matrix(dt_bboxes: np.ndarray, dc_bboxes: np.ndarray):
    """Criterion-0 image overlap (intersection / detection area) between
    detection 2D boxes and DontCare regions — devkit FP absorption."""
    D = len(dt_bboxes)
    NDC = len(dc_bboxes)
    out = np.zeros((D, NDC), np.float32)
    if D == 0 or NDC == 0:
        return out
    iw = (np.minimum(dt_bboxes[:, None, 2], dc_bboxes[None, :, 2])
          - np.maximum(dt_bboxes[:, None, 0], dc_bboxes[None, :, 0]))
    ih = (np.minimum(dt_bboxes[:, None, 3], dc_bboxes[None, :, 3])
          - np.maximum(dt_bboxes[:, None, 1], dc_bboxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area = ((dt_bboxes[:, 2] - dt_bboxes[:, 0])
            * (dt_bboxes[:, 3] - dt_bboxes[:, 1]))
    return (inter / np.maximum(area[:, None], 1e-12)).astype(np.float32)


def _overlap_matrix(gt_anno, dt_anno, metric: int) -> np.ndarray:
    """[D, G] overlaps for metric 0=bbox(2D image) 1=bev 2=3d (camera)."""
    if metric == 0:
        return box_ops.iou_2d(dt_anno["bbox"], gt_anno["bbox"])
    # camera frame: x right, y down, z forward; BEV plane is (x, z).
    # 'dimensions' are stored (l, h, w) — l along the box z axis.
    def to_bev(a):
        return np.stack([a["location"][:, 0], a["location"][:, 2],
                         a["dimensions"][:, 2], a["dimensions"][:, 0],
                         -a["rotation_y"]], axis=1)

    bev_d, bev_g = to_bev(dt_anno), to_bev(gt_anno)
    if metric == 1:
        return geometry.rotate_iou_matrix(bev_d, bev_g)
    # 3d: add y-extent (camera y grows downward; box spans [y-h, y])
    inter2d = np.zeros((len(bev_d), len(bev_g)), np.float32)
    for i in range(len(bev_d)):
        for j in range(len(bev_g)):
            inter2d[i, j] = geometry.rotated_box_intersection_area(
                bev_d[i], bev_g[j])
    yd1 = dt_anno["location"][:, 1]
    yd0 = yd1 - dt_anno["dimensions"][:, 1]
    yg1 = gt_anno["location"][:, 1]
    yg0 = yg1 - gt_anno["dimensions"][:, 1]
    hi = (np.minimum(yd1[:, None], yg1[None, :])
          - np.maximum(yd0[:, None], yg0[None, :]))
    inter3d = inter2d * np.clip(hi, 0, None)
    vol_d = np.prod(dt_anno["dimensions"], axis=1)
    vol_g = np.prod(gt_anno["dimensions"], axis=1)
    union = vol_d[:, None] + vol_g[None, :] - inter3d
    return np.where(union > 0, inter3d / np.maximum(union, 1e-12), 0.0)


def _image_statistics(overlaps, gt, dt, ignored_gt, ignored_det, dc_bboxes,
                      min_overlap, thresholds, compute_aos,
                      tp, fp, fn, sim):
    """Run the per-threshold statistics pass for one image, accumulating
    into tp/fp/fn/sim [T]."""
    dc_overlap = _dc_overlap_matrix(np.asarray(dt["bbox"], np.float64),
                                    np.asarray(dc_bboxes, np.float64))
    gt_alpha = np.asarray(gt.get("alpha", np.zeros(len(gt["name"]))),
                          np.float32)
    dt_alpha = np.asarray(dt.get("alpha", np.zeros(len(dt["name"]))),
                          np.float32)
    # float32 scores on BOTH paths: thresholds are f32 TP scores, and the
    # devkit keeps dets with score == threshold — mixed precision here
    # would flip that equality.
    scores = np.asarray(dt["score"], np.float32)
    for t, thresh in enumerate(thresholds):
        r = compute_statistics_py(
            overlaps, ignored_gt, ignored_det, scores,
            dc_overlap, gt_alpha, dt_alpha, compute_aos, min_overlap,
            thresh, compute_fp=True)
        tp[t] += r[0]
        fp[t] += r[1]
        fn[t] += r[2]
        sim[t] += r[3]


def eval_class(gt_annos: List[dict], dt_annos: List[dict], cls_name: str,
               difficulty: int, metric: int, min_overlap: float,
               compute_aos: bool = False, num_sample_pts: int = 41,
               overlaps: Optional[List[np.ndarray]] = None) -> dict:
    """One (class, difficulty, metric) AP — the exact devkit algorithm.

    Two passes: (1) match with no score cutoff to collect TP scores, from
    which ``get_thresholds`` picks ≤41 recall-spaced score thresholds;
    (2) re-match per threshold accumulating tp/fp/fn (+AOS similarity),
    then right-max the precision curve.  Returns a dict with the raw
    ``precision``/``aos`` curves ([41], zero-padded), ``thresholds``,
    ``num_valid_gt``, and the 11-point (``ap``) and 40-point (``ap_R40``)
    interpolated APs in percent.
    """
    n_img = len(gt_annos)
    if overlaps is None:
        overlaps = [
            _overlap_matrix(gt, dt, metric)
            if len(gt["name"]) and len(dt["name"])
            else np.zeros((len(dt["name"]), len(gt["name"])), np.float32)
            for gt, dt in zip(gt_annos, dt_annos)]

    cleaned = [clean_data(gt, dt, cls_name, difficulty)
               for gt, dt in zip(gt_annos, dt_annos)]
    total_num_valid_gt = sum(c[3] for c in cleaned)

    # pass 1: thresholds from matched-TP scores
    all_tp_scores = []
    for i in range(n_img):
        ignored_gt, ignored_det, _, _ = cleaned[i]
        ov = np.ascontiguousarray(overlaps[i], np.float32)
        scores = np.asarray(dt_annos[i]["score"], np.float32)
        s = compute_statistics_py(
            ov, ignored_gt, ignored_det, scores,
            np.zeros((len(scores), 0), np.float32),
            np.zeros(len(ignored_gt), np.float32),
            np.zeros(len(scores), np.float32),
            False, min_overlap, 0.0, compute_fp=False)[4]
        all_tp_scores.append(s)
    tp_scores = (np.concatenate(all_tp_scores) if all_tp_scores
                 else np.zeros(0, np.float32))

    out = {
        "precision": np.zeros(num_sample_pts),
        "aos": np.zeros(num_sample_pts),
        "recall": np.zeros(num_sample_pts),
        "num_valid_gt": total_num_valid_gt,
        "thresholds": np.zeros(0, np.float32),
        "ap": 0.0, "ap_R40": 0.0, "aos_ap": 0.0, "aos_ap_R40": 0.0,
    }
    if total_num_valid_gt == 0 or len(tp_scores) == 0:
        return out
    thresholds = get_thresholds(tp_scores, total_num_valid_gt,
                                num_sample_pts)
    T = len(thresholds)

    # pass 2: per-threshold statistics over all images
    tp = np.zeros(T, np.int32)
    fp = np.zeros(T, np.int32)
    fn = np.zeros(T, np.int32)
    sim = np.zeros(T, np.float32)
    for i in range(n_img):
        ignored_gt, ignored_det, dc_bboxes, _ = cleaned[i]
        _image_statistics(np.ascontiguousarray(overlaps[i], np.float32),
                          gt_annos[i], dt_annos[i], ignored_gt, ignored_det,
                          dc_bboxes, min_overlap, thresholds, compute_aos,
                          tp, fp, fn, sim)

    precision = np.zeros(num_sample_pts)
    aos = np.zeros(num_sample_pts)
    recall = np.zeros(num_sample_pts)
    denom = np.maximum(tp + fp, 1)
    precision[:T] = tp / denom
    recall[:T] = tp / np.maximum(tp + fn, 1)
    if compute_aos:
        aos[:T] = sim / denom
    for i in range(num_sample_pts):     # devkit right-max smoothing
        precision[i] = precision[i:].max()
        aos[i] = aos[i:].max()
    out.update(precision=precision, aos=aos, recall=recall,
               thresholds=thresholds,
               ap=float(precision[::4].sum() / 11 * 100),
               ap_R40=float(precision[1:].sum() / 40 * 100),
               aos_ap=float(aos[::4].sum() / 11 * 100),
               aos_ap_R40=float(aos[1:].sum() / 40 * 100))
    return out


def get_official_eval_result(gt_annos: List[dict], dt_annos: List[dict],
                             current_classes,
                             compute_aos: Optional[bool] = None) -> dict:
    """KITTI AP table: classes x (bbox, bev, 3d) x (easy, mod, hard).

    Reports both the 11-point (``.R11``-era default, the protocol the
    lineage README tables use) and 40-point interpolated APs.
    """
    if isinstance(current_classes, str):
        current_classes = [current_classes]
    if compute_aos is None:
        compute_aos = all(
            "alpha" in dt and len(dt["alpha"]) == len(dt["name"])
            for dt in dt_annos)
    # overlap matrices are class-independent: compute once per metric
    overlap_cache = {}

    def overlaps_for(metric):
        if metric not in overlap_cache:
            overlap_cache[metric] = [
                _overlap_matrix(gt, dt, metric)
                if len(gt["name"]) and len(dt["name"])
                else np.zeros((len(dt["name"]), len(gt["name"])),
                              np.float32)
                for gt, dt in zip(gt_annos, dt_annos)]
        return overlap_cache[metric]

    results = {}
    buf = io.StringIO()
    for cls_name in current_classes:
        ov = OVERLAPS.get(cls_name, (0.5, 0.5, 0.5))
        buf.write(f"{cls_name} AP@{ov[0]:.2f}, {ov[1]:.2f}, {ov[2]:.2f}:\n")
        for metric, mname in ((0, "bbox"), (1, "bev"), (2, "3d")):
            aps, aps40, aoss = [], [], []
            for diff in range(3):
                r = eval_class(gt_annos, dt_annos, cls_name, diff, metric,
                               ov[metric],
                               compute_aos=compute_aos and metric == 0,
                               overlaps=overlaps_for(metric))
                aps.append(r["ap"])
                aps40.append(r["ap_R40"])
                aoss.append(r["aos_ap"])
                key = f"{cls_name}.{mname}.{DIFFICULTY_NAMES[diff]}"
                results[key] = r["ap"]
                results[key + ".R40"] = r["ap_R40"]
            buf.write(f"{mname} AP: {aps[0]:.2f}, {aps[1]:.2f}, "
                      f"{aps[2]:.2f}\n")
            buf.write(f"{mname} AP_R40: {aps40[0]:.2f}, {aps40[1]:.2f}, "
                      f"{aps40[2]:.2f}\n")
            if metric == 0 and compute_aos:
                buf.write(f"aos  AP: {aoss[0]:.2f}, {aoss[1]:.2f}, "
                          f"{aoss[2]:.2f}\n")
                for diff in range(3):
                    results[f"{cls_name}.aos.{DIFFICULTY_NAMES[diff]}"] = (
                        aoss[diff])
    results["result_str"] = buf.getvalue()
    return results
