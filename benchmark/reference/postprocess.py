"""Anchors, box decoding, score threshold, top-k and per-class rotated
NMS, in plain PyTorch.

For each scan and class: sigmoid scores, those under the threshold
dropped, the ``pre_max`` best kept (ties to the lower anchor), their
boxes decoded from the anchors (SECOND's residual coding: centre offsets
over the anchor's diagonal, log sizes, yaw difference), the yaw put in
the half turn the direction classifier picks, centres outside
``center_limit_range`` dropped, then greedy NMS by rotated BEV IoU, the
first ``post_max`` kept, then (where a radius is set) greedy suppression
by centre distance.  The IoUs and distances are computed in float64; a
decision within ``IOU_TOL`` (``DIST_TOL``) of its threshold is a tie of
rounding, which a judge resolves as the judged answer does.  Output: ``box3d_lidar [B, C*post_max, 7]``,
``scores``, ``label_preds``, ``valid`` (host numpy).

``decode_dtype=torch.bfloat16`` decodes in bfloat16 (the lower-precision
control).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .compare import BOX_ATOL, SCORE_ATOL
from .voxelize import grid_size

# a rotated IoU or a centre distance this close to its threshold is a tie
# of float32 rounding (a clip in world coordinates rounds the IoU by some
# 1e-6; ten times more is allowed), metres for the distance
IOU_TOL = 1e-4
DIST_TOL = 1e-4


def anchors(model: dict) -> np.ndarray:
    """[H * W * A, 7] anchors, (y, x, anchor) order, anchor fastest; per
    location the classes in order, each size's rotations in order.
    Centres evenly spaced over each class's range, end excluded."""
    gx, gy, _ = grid_size(model["voxel"]["pc_range"],
                          model["voxel"]["voxel_size"])
    df = int(model["middle"]["downsample_factor"])
    H, W = int(gy) // df, int(gx) // df
    per_class = []
    for a in model["anchors"]:
        r = np.asarray(a["range"], np.float32)
        ys = np.linspace(r[1], r[4], H, endpoint=False, dtype=np.float32)
        xs = np.linspace(r[0], r[3], W, endpoint=False, dtype=np.float32)
        z = np.linspace(r[2], r[5], 1, endpoint=False, dtype=np.float32)[0]
        rots = np.asarray(a["rotations"], np.float32)
        out = np.zeros((H, W, len(rots), 7), np.float32)
        out[..., 0] = xs[None, :, None]
        out[..., 1] = ys[:, None, None]
        out[..., 2] = z
        out[..., 3:6] = np.asarray(a["sizes"], np.float32)
        out[..., 6] = rots
        per_class.append(out)
    return np.concatenate(per_class, axis=2).reshape(-1, 7)


def _flat(t: torch.Tensor, c: int) -> torch.Tensor:
    """NCHW [B, A*c, H, W] -> [B, H*W*A, c]."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, c)


def decode(res: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    xa, ya, za, wa, la, ha, ra = anc.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = res.unbind(-1)
    diag = torch.sqrt(la * la + wa * wa)
    h = torch.exp(ht) * ha
    return torch.stack([xt * diag + xa, yt * diag + ya,
                        zt * ha + za + ha / 2 - h / 2,
                        torch.exp(wt) * wa, torch.exp(lt) * la, h,
                        rt + ra], -1)


def _corners(b: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, w, l, yaw) -> [..., 4, 2] corners, counter-clockwise;
    w along the box's own x axis."""
    x, y, w, l, yaw = b.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    u = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=b.dtype, device=b.device)
    v = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=b.dtype, device=b.device)
    lx, ly = u * w[..., None], v * l[..., None]
    return torch.stack([lx * c[..., None] - ly * s[..., None] + x[..., None],
                        lx * s[..., None] + ly * c[..., None] + y[..., None]],
                       -1)


def _clip_area(poly: torch.Tensor, n: torch.Tensor, clip: torch.Tensor
               ) -> torch.Tensor:
    """Area of convex polygons ``poly`` [P, 8, 2] (``n`` [P] vertices)
    clipped by the convex quads ``clip`` [P, 4, 2] (Sutherland-Hodgman)."""
    P = poly.shape[0]
    slots = torch.arange(8, device=poly.device)
    for e in range(4):
        a, b = clip[:, e], clip[:, (e + 1) % 4]                   # [P, 2]
        edge = b - a
        side = (edge[:, None, 0] * (poly[..., 1] - a[:, None, 1])
                - edge[:, None, 1] * (poly[..., 0] - a[:, None, 0]))
        nxt = torch.where(slots[None] + 1 < n[:, None],
                          slots[None] + 1, torch.zeros_like(slots[None]))
        pn = torch.gather(poly, 1, nxt[..., None].expand(P, 8, 2))
        sn = torch.gather(side, 1, nxt)
        live = slots[None] < n[:, None]
        keep = live & (side >= 0)
        cross = live & ((side >= 0) != (sn >= 0))
        den = side - sn
        t = torch.where(den.abs() > 1e-12, side / torch.where(
            den == 0, torch.ones_like(den), den), torch.zeros_like(den))
        inter = poly + t[..., None] * (pn - poly)
        cand = torch.stack([poly, inter], 2).reshape(P, 16, 2)
        emit = torch.stack([keep, cross], 2).reshape(P, 16)
        pos = torch.cumsum(emit.long(), 1) - 1
        pos = torch.where(emit & (pos < 8), pos, torch.full_like(pos, 8))
        out = torch.zeros((P, 9, 2), dtype=poly.dtype, device=poly.device)
        out.scatter_(1, pos[..., None].expand(P, 16, 2), cand)
        poly, n = out[:, :8], emit.sum(1).clamp(max=8)
    nxt = torch.where(slots[None] + 1 < n[:, None], slots[None] + 1,
                      torch.zeros_like(slots[None]))
    pn = torch.gather(poly, 1, nxt[..., None].expand(P, 8, 2))
    cr = poly[..., 0] * pn[..., 1] - pn[..., 0] * poly[..., 1]
    cr = torch.where(slots[None] < n[:, None], cr, torch.zeros_like(cr))
    return torch.clamp(0.5 * cr.sum(1), min=0.0)


def rotated_iou(boxes: torch.Tensor, chunk: int = 1 << 18) -> torch.Tensor:
    """[K, 5] -> [K, K] IoU of every pair of rotated BEV boxes, in float64
    about the boxes' mean centre (so that the shoelace sum does not
    cancel large coordinates)."""
    K = boxes.shape[0]
    b = boxes.double()
    b = torch.cat([b[:, :2] - b[:, :2].mean(0), b[:, 2:]], 1)
    corners = _corners(b)
    area = b[:, 2] * b[:, 3]
    ii, jj = torch.meshgrid(torch.arange(K, device=boxes.device),
                            torch.arange(K, device=boxes.device),
                            indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    inter = torch.zeros(K * K, dtype=b.dtype, device=boxes.device)
    for s in range(0, K * K, chunk):
        i, j = ii[s:s + chunk], jj[s:s + chunk]
        poly = torch.zeros((len(i), 8, 2), dtype=b.dtype,
                           device=boxes.device)
        poly[:, :4] = corners[i]
        n = torch.full((len(i),), 4, dtype=torch.long, device=boxes.device)
        inter[s:s + chunk] = _clip_area(poly, n, corners[j])
    inter = inter.reshape(K, K)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros_like(inter))


def greedy_keep(value: torch.Tensor, threshold: float, tol: float,
                follow=None):
    """Greedy suppression of score-sorted boxes: box i goes when an
    earlier kept box j has ``value[j, i] > threshold``.  A decision within
    ``tol`` of the threshold (no kept box above ``threshold + tol``, one
    above ``threshold - tol``) is a tie of rounding: it goes as ``follow``
    (the indices the program kept) has it, else by the exact comparison.
    -> (keep [K] bool numpy, ties met)."""
    v = value.cpu().numpy()
    keep = np.zeros(v.shape[0], bool)
    ties = 0
    for i in range(v.shape[0]):
        col = v[:i, i][keep[:i]]
        if (col > threshold + tol).any():
            continue
        if (col > threshold - tol).any():
            ties += 1
            keep[i] = (i in follow if follow is not None
                       else not (col > threshold).any())
        else:
            keep[i] = True
    return keep, ties


def _program_rows(answer, b: int, c: int, boxes, scores) -> set:
    """The candidates (``boxes``, ``scores``) that the program's answer
    holds for scan b, class c: box values within BOX_ATOL, score within
    SCORE_ATOL."""
    sel = answer["valid"][b] & (answer["label_preds"][b] == c)
    cb, cs = boxes.cpu().numpy(), scores.cpu().numpy()
    out = set()
    for box, score in zip(answer["box3d_lidar"][b][sel],
                          answer["scores"][b][sel]):
        hit = np.flatnonzero((np.abs(cb - box) <= BOX_ATOL).all(-1)
                             & (np.abs(cs - score) <= SCORE_ATOL))
        out.update(hit[:1].tolist())
    return out


def _inputs(preds: Dict[str, torch.Tensor], model: dict):
    """Head maps -> per anchor the box codes, sigmoid class scores and
    direction logits ([B, A, .]), and the anchors [A, 7]."""
    head = model["head"]
    box = _flat(preds["box_preds"].float(), head["box_code_size"])
    cls = _flat(preds["cls_preds"].float(), head["num_class"])
    dirs = _flat(preds["dir_cls_preds"].float(), head["num_direction_bins"])
    anc = torch.as_tensor(anchors(model), device=box.device)
    if anc.shape[0] != box.shape[1]:
        raise ValueError(f"{box.shape[1]} anchors in the heads, "
                         f"{anc.shape[0]} in the model")
    return box, torch.sigmoid(cls), dirs, anc


def _candidates(s, box, dirs, anc, model: dict,
                decode_dtype=torch.float32):
    """One scan and class (scores ``s`` [A], codes ``box`` [A, 7],
    direction logits ``dirs``) -> the scores and decoded boxes that NMS
    weighs, best first: those at or over the threshold, the best
    ``nms_pre_max_size``, inside the centre limits where set."""
    head, post = model["head"], model["post"]
    thr = float(np.float32(post["score_threshold"]))
    period = 2 * math.pi / head["num_direction_bins"]
    offset = float(np.float32(head.get("direction_offset", 0.0)))
    lim = post.get("center_limit_range")
    pre = min(int(post["nms_pre_max_size"]), s.shape[0])
    s = torch.where(s >= thr, s, torch.full_like(s, -math.inf))
    top, idx = torch.sort(s, descending=True, stable=True)
    top, idx = top[:pre], idx[:pre]
    ok = top > -math.inf
    top, idx = top[ok], idx[ok]
    boxes = decode(box[idx].to(decode_dtype),
                   anc[idx].to(decode_dtype)).float()
    label = torch.argmax(dirs[idx], -1).float()
    r = boxes[:, 6] - offset
    r = r - torch.floor(r / period) * period
    boxes[:, 6] = r + offset + period * label
    if lim is not None:
        lim = torch.tensor([float(np.float32(v)) for v in lim],
                           device=boxes.device)
        inside = ((boxes[:, :3] >= lim[:3])
                  & (boxes[:, :3] <= lim[3:])).all(1)
        top, boxes = top[inside], boxes[inside]
    return top, boxes


def candidate_counts(preds: Dict[str, torch.Tensor], model: dict) -> list:
    """Per scan and class (scan-major), the number of candidates NMS
    weighs: the work the rotated IoU needs (``roofline.k2_bytes``)."""
    box, scores, dirs, anc = _inputs(preds, model)
    return [len(_candidates(scores[b, :, c], box[b], dirs[b], anc,
                            model)[0])
            for b in range(box.shape[0])
            for c in range(model["head"]["num_class"])]


def predict(preds: Dict[str, torch.Tensor], model: dict,
            decode_dtype=torch.float32, follow=None,
            stats=None) -> Dict[str, np.ndarray]:
    """-> the detections.  With ``follow`` (the program's answer for the
    same request) the ties of rounding go as the program has them;
    ``stats["ties"]`` counts them."""
    post = model["post"]
    C, D = model["head"]["num_class"], int(post["nms_post_max_size"])
    box, scores_all, dirs, anc = _inputs(preds, model)
    B = box.shape[0]
    iou_thr = float(np.float32(post["iou_threshold"]))
    radius = float(np.float32(post.get("center_suppress_radius", 0.0)))
    out = {"box3d_lidar": np.zeros((B, C * D, 7), np.float32),
           "scores": np.zeros((B, C * D), np.float32),
           "label_preds": np.repeat(np.arange(C, dtype=np.int32), D)[None]
           .repeat(B, 0),
           "valid": np.zeros((B, C * D), bool)}
    for b in range(B):
        for c in range(C):
            top, boxes = _candidates(scores_all[b, :, c], box[b], dirs[b],
                                     anc, model, decode_dtype)
            if len(boxes) == 0:
                continue
            kept_by_program = (None if follow is None else
                               _program_rows(follow, b, c, boxes, top))
            iou = rotated_iou(boxes[:, [0, 1, 3, 4, 6]])
            keep, ties = greedy_keep(iou, iou_thr, IOU_TOL, kept_by_program)
            kept = np.flatnonzero(keep)[:D]
            kb, ks = boxes[kept], top[kept]
            valid = np.ones(len(kept), bool)
            if radius > 0:
                centres = kb[:, :2].double()
                dist = torch.cdist(centres, centres)
                pos = (None if kept_by_program is None else
                       {j for j, i in enumerate(kept)
                        if i in kept_by_program})
                valid, t = greedy_keep(-dist, -radius, DIST_TOL, pos)
                ties += t
            if stats is not None:
                stats["ties"] = stats.get("ties", 0) + ties
            sl = slice(c * D, c * D + len(kept))
            out["box3d_lidar"][b, sl] = kb.cpu().numpy()
            out["scores"][b, sl] = np.where(valid, ks.cpu().numpy(), 0.0)
            out["valid"][b, sl] = valid
    return out
