"""Detections -> as-built model export (JSON + SVG floor plan).

The port's copy of the JAX package's ``utils/asbuilt_export.py``.  The
detector emits one rotated box per element instance: long walls arrive
as chains of fixed-length segments (the scene generator splits them,
``data/building.py::_wall_with_door``, and detectors do the same at
anchor granularity).  An as-built model wants the architectural elements
back: continuous wall runs with their openings, column footprints, and
door leaves attached to their host wall.  This module reconstructs that
structure from raw detections:

- walls:   greedy collinear merge (pi-symmetric axis agreement,
           lateral-offset and endpoint-gap gates) -> runs with
           start/end points and mean thickness/height,
- doors:   attached to the nearest wall run (perpendicular-distance
           gate), recorded as openings at their along-run position,
- columns: footprints passed through.

Host code in numpy: detections given as tensors (on the card or not)
come to the host once, in :func:`build_asbuilt_model`.  The same
detections give the reference's JSON model and SVG text, character for
character.

Box convention throughout: [x, y, z, w, l, h, yaw] lidar frame, length
``l`` along the box axis ``(-sin yaw, cos yaw)`` (see
``core/box_ops.py``); building elements are pi-symmetric in yaw.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _host(x):
    """A detection field as a host array: tensors leave their device."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def _canon_axis(yaw: np.ndarray):
    """Pi-symmetric unit axis of the box l-dimension, angle in [0, pi)."""
    ax = np.stack([-np.sin(yaw), np.cos(yaw)], axis=-1)
    flip = ax[..., 1] < 0
    # resolve the ax_y == 0 boundary toward +x so (1,0) and (-1,0) agree
    flip = flip | ((ax[..., 1] == 0) & (ax[..., 0] < 0))
    return np.where(flip[..., None], -ax, ax)


def _pi_mean_angle(angles: np.ndarray) -> float:
    """Mean of pi-periodic angles via angle doubling."""
    d = 2.0 * angles
    return float(np.arctan2(np.sin(d).mean(), np.cos(d).mean()) / 2.0)


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, i: int) -> int:
        while self.p[i] != i:
            self.p[i] = self.p[self.p[i]]
            i = self.p[i]
        return i

    def union(self, i: int, j: int) -> None:
        self.p[self.find(i)] = self.find(j)


def merge_wall_runs(boxes: np.ndarray, scores: Optional[np.ndarray] = None,
                    angle_tol: float = np.deg2rad(8.0),
                    lateral_tol: float = 0.25,
                    gap_tol: float = 0.5) -> List[dict]:
    """Merge collinear wall segment boxes [N, 7] into wall runs.

    Two segments join when their axes agree within ``angle_tol``
    (mod pi), each center sits within ``lateral_tol`` of the other's
    infinite line, and their along-axis intervals overlap or gap by
    less than ``gap_tol``.  Transitive closure via union-find.
    """
    n = len(boxes)
    if n == 0:
        return []
    scores = (np.ones(n, np.float32) if scores is None
              else np.asarray(scores, np.float32))
    b = np.asarray(boxes, np.float64)
    centers = b[:, :2]
    axes = _canon_axis(b[:, 6])
    angles = np.arctan2(axes[:, 1], axes[:, 0]) % np.pi
    half = b[:, 4] / 2.0

    uf = _UnionFind(n)
    for i in range(n):
        for j in range(i + 1, n):
            da = abs(angles[i] - angles[j])
            da = min(da, np.pi - da)
            if da > angle_tol:
                continue
            d = centers[j] - centers[i]
            if abs(d[0] * axes[i][1] - d[1] * axes[i][0]) > lateral_tol:
                continue
            if abs(d[0] * axes[j][1] - d[1] * axes[j][0]) > lateral_tol:
                continue
            t = float(d @ axes[i])
            gap = abs(t) - (half[i] + half[j])
            if gap > gap_tol:
                continue
            uf.union(i, j)

    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(uf.find(i), []).append(i)

    runs = []
    for members in groups.values():
        m = np.asarray(members)
        ang = _pi_mean_angle(angles[m]) % np.pi
        axis = np.array([np.cos(ang), np.sin(ang)])
        origin = centers[m].mean(0)
        # endpoints of every member segment projected on the run axis
        t_lo, t_hi = np.inf, -np.inf
        for i in members:
            for sgn in (-1.0, 1.0):
                p = centers[i] + sgn * half[i] * axes[i]
                t = float((p - origin) @ axis)
                t_lo, t_hi = min(t_lo, t), max(t_hi, t)
        start = origin + t_lo * axis
        end = origin + t_hi * axis
        z0 = float((b[m, 2] - b[m, 5] / 2).mean())
        runs.append({
            "start": [float(start[0]), float(start[1])],
            "end": [float(end[0]), float(end[1])],
            "length": float(t_hi - t_lo),
            "thickness": float(b[m, 3].mean()),
            "height": float(b[m, 5].mean()),
            "z0": z0,
            "n_segments": int(len(members)),
            "score": float(scores[m].mean()),
        })
    runs.sort(key=lambda r: -r["length"])
    return runs


def _attach_doors(door_boxes: np.ndarray, door_scores: np.ndarray,
                  walls: List[dict], attach_tol: float = 0.6
                  ) -> List[dict]:
    doors = []
    for box, score in zip(np.asarray(door_boxes, np.float64),
                          np.asarray(door_scores, np.float64)):
        c = box[:2]
        best, best_d, best_t = None, np.inf, 0.0
        for wi, w in enumerate(walls):
            a = np.asarray(w["start"])
            bb = np.asarray(w["end"])
            ab = bb - a
            ln = float(np.hypot(*ab))
            if ln < 1e-6:
                continue
            t = float(np.clip((c - a) @ ab / (ln * ln), 0.0, 1.0))
            d = float(np.hypot(*(a + t * ab - c)))
            if d < best_d:
                best, best_d, best_t = wi, d, t * ln
        entry = {
            "center": [float(c[0]), float(c[1])],
            "width": float(box[4]),      # leaf length = opening width
            "height": float(box[5]),
            "z0": float(box[2] - box[5] / 2),
            "yaw": float(box[6]),
            "score": float(score),
            "wall_index": None,
            "along_wall_m": None,
        }
        if best is not None and best_d <= attach_tol:
            entry["wall_index"] = int(best)
            entry["along_wall_m"] = round(best_t, 3)
        doors.append(entry)
    return doors


def build_asbuilt_model(detections: dict, class_names: Sequence[str],
                        score_threshold: float = 0.3,
                        angle_tol: float = np.deg2rad(8.0),
                        lateral_tol: float = 0.25,
                        gap_tol: float = 0.5) -> dict:
    """Raw detections -> structured as-built model dict.

    detections: {"box3d_lidar" [N,7], "scores" [N], "label_preds" [N]}
    (0-based labels into ``class_names``; padding rows may carry
    score 0 / validity via threshold), numpy arrays or tensors.
    """
    boxes = np.asarray(_host(detections["box3d_lidar"]),
                       np.float64).reshape(-1, 7)
    scores = np.asarray(_host(detections["scores"]), np.float64).reshape(-1)
    labels = np.asarray(_host(detections["label_preds"]),
                        np.int64).reshape(-1)
    keep = scores >= score_threshold
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]

    def of(cls):
        if cls not in class_names:
            return boxes[:0], scores[:0]
        m = labels == list(class_names).index(cls)
        return boxes[m], scores[m]

    wall_b, wall_s = of("wall")
    walls = merge_wall_runs(wall_b, wall_s, angle_tol=angle_tol,
                            lateral_tol=lateral_tol, gap_tol=gap_tol)
    door_b, door_s = of("door")
    doors = _attach_doors(door_b, door_s, walls)
    col_b, col_s = of("column")
    columns = [{
        "center": [float(b[0]), float(b[1])],
        "size": [float(b[3]), float(b[4])],
        "height": float(b[5]),
        "z0": float(b[2] - b[5] / 2),
        "yaw": float(b[6]),
        "score": float(s),
    } for b, s in zip(col_b, col_s)]

    return {
        "format": "abr-asbuilt-v1",
        "class_names": list(class_names),
        "walls": walls,
        "columns": columns,
        "doors": doors,
        "stats": {
            "num_detections": int(keep.sum()),
            "num_wall_segments": int(len(wall_b)),
            "num_wall_runs": len(walls),
            "num_columns": len(columns),
            "num_doors": len(doors),
        },
    }


# ---------------------------------------------------------------------------
# SVG floor plan (stdlib only)
# ---------------------------------------------------------------------------


def render_svg(model: dict, size: int = 900, margin: float = 1.0) -> str:
    """Top-down floor plan: walls as thick strokes, columns as rects,
    doors as circles on their opening."""
    pts = [p for w in model["walls"] for p in (w["start"], w["end"])]
    pts += [c["center"] for c in model["columns"]]
    pts += [d["center"] for d in model["doors"]]
    if not pts:
        return ("<svg xmlns='http://www.w3.org/2000/svg' "
                f"width='{size}' height='{size}'/>")
    arr = np.asarray(pts)
    lo = arr.min(0) - margin
    hi = arr.max(0) + margin
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    sc = size / span

    def xy(p):
        return ((p[0] - lo[0]) * sc, size - (p[1] - lo[1]) * sc)

    out = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{size}' "
           f"height='{size}' viewBox='0 0 {size} {size}'>",
           f"<rect width='{size}' height='{size}' fill='white'/>"]
    for w in model["walls"]:
        (x1, y1), (x2, y2) = xy(w["start"]), xy(w["end"])
        sw = max(w["thickness"] * sc, 1.5)
        out.append(
            f"<line x1='{x1:.1f}' y1='{y1:.1f}' x2='{x2:.1f}' "
            f"y2='{y2:.1f}' stroke='#444' stroke-width='{sw:.1f}' "
            "stroke-linecap='square'/>")
    for c in model["columns"]:
        (x, y) = xy(c["center"])
        wpx = max(c["size"][0] * sc, 2)
        lpx = max(c["size"][1] * sc, 2)
        deg = -np.degrees(c["yaw"])
        out.append(
            f"<rect x='{x - wpx / 2:.1f}' y='{y - lpx / 2:.1f}' "
            f"width='{wpx:.1f}' height='{lpx:.1f}' fill='#1565c0' "
            f"transform='rotate({deg:.1f} {x:.1f} {y:.1f})'/>")
    for d in model["doors"]:
        (x, y) = xy(d["center"])
        r = max(d["width"] * sc / 2, 2)
        out.append(
            f"<circle cx='{x:.1f}' cy='{y:.1f}' r='{r:.1f}' "
            "fill='none' stroke='#e65100' stroke-width='2'/>")
    out.append("</svg>")
    return "\n".join(out)


def export_asbuilt(detections: dict, class_names: Sequence[str],
                   json_path: Optional[str] = None,
                   svg_path: Optional[str] = None,
                   score_threshold: float = 0.3) -> dict:
    """Build the model and optionally write JSON + SVG files."""
    model = build_asbuilt_model(detections, class_names,
                                score_threshold=score_threshold)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(model, f, indent=1)
    if svg_path:
        with open(svg_path, "w") as f:
            f.write(render_svg(model))
    return model
