"""Real-scan ingestion: PLY / PCD point-cloud readers (and writers for
tooling and tests) and JSON box annotations, in numpy.

The port's copy of the JAX package's ``data/scan_io.py``: ``read_ply``
(ascii or binary little-endian vertex elements), ``write_ply``,
``read_pcd`` (v0.7 ascii or binary), ``read_scan`` (dispatch on
``.ply`` / ``.pcd`` / ``.bin`` / ``.npz`` / ``.npy``),
``read_annotations`` and ``write_annotations``.  Reading gives the same
arrays bit for bit, and writing the same bytes.  Non-finite points are
dropped; the first intensity channel name present is kept.

Annotation sidecars are JSON: ``{"boxes": [[x, y, z, w, l, h, yaw], ...],
"names": ["wall", ...]}`` in the scan's own (lidar) frame.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}

# point channels we keep, in output order (first hit wins per channel)
_INTENSITY_NAMES = ("intensity", "scalar_intensity", "reflectance", "i")


def read_ply(path) -> np.ndarray:
    """PLY (ascii or binary_little_endian) -> [N, 3 or 4] float32
    (x, y, z[, intensity]).  Only the vertex element is read; faces and
    other trailing elements are ignored."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = None
        props = []          # (name, dtype) of the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError(
                        f"{path}: list property on vertex element")
                props.append((tokens[2], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if n_vertex is None:
            raise ValueError(f"{path}: no vertex element")
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append([float(v) for v in
                             f.readline().split()[: len(props)]])
            rec = np.asarray(rows, np.float64)
            data = {name: rec[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + t) for name, t in props])
            rec = np.frombuffer(f.read(dt.itemsize * n_vertex), dt,
                                count=n_vertex)
            data = {name: rec[name] for name, _ in props}
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
    return _assemble(data, path)


def write_ply(points: np.ndarray, path, binary: bool = True) -> None:
    """[N, 3 or 4] points -> PLY (float32 x/y/z[/intensity])."""
    points = np.asarray(points, np.float32)
    names = ["x", "y", "z"] + (["intensity"] if points.shape[1] >= 4
                               else [])
    fmt = "binary_little_endian" if binary else "ascii"
    header = ["ply", f"format {fmt} 1.0",
              f"element vertex {points.shape[0]}"]
    header += [f"property float {n}" for n in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        body = np.ascontiguousarray(points[:, : len(names)], "<f4")
        if binary:
            f.write(body.tobytes())
        else:
            np.savetxt(f, body, fmt="%.6f")


def read_pcd(path) -> np.ndarray:
    """PCD v0.7 (ascii or binary) -> [N, 3 or 4] float32."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        fields = sizes = types = counts = None
        n_points = None
        data_mode = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PCD header")
            t = line.decode("ascii", "replace").split()
            if not t or t[0].startswith("#"):
                continue
            key = t[0].upper()
            if key == "FIELDS":
                fields = t[1:]
            elif key == "SIZE":
                sizes = [int(v) for v in t[1:]]
            elif key == "TYPE":
                types = t[1:]
            elif key == "COUNT":
                counts = [int(v) for v in t[1:]]
            elif key == "POINTS":
                n_points = int(t[1])
            elif key == "DATA":
                data_mode = t[1].lower()
                break
        if None in (fields, sizes, types) or n_points is None:
            raise ValueError(f"{path}: incomplete PCD header")
        counts = counts or [1] * len(fields)
        if any(c != 1 for c in counts):
            raise ValueError(f"{path}: COUNT != 1 unsupported")
        np_types = [f"<{t.lower()}{s}" for t, s in zip(types, sizes)]
        if data_mode == "ascii":
            rows = []
            for _ in range(n_points):
                rows.append([float(v) for v in
                             f.readline().split()[: len(fields)]])
            rec = np.asarray(rows, np.float64)
            data = {name: rec[:, i] for i, name in enumerate(fields)}
        elif data_mode == "binary":
            dt = np.dtype(list(zip(fields, np_types)))
            rec = np.frombuffer(f.read(dt.itemsize * n_points), dt,
                                count=n_points)
            data = {name: rec[name] for name in fields}
        else:
            raise ValueError(
                f"{path}: unsupported PCD data mode {data_mode!r} "
                "(binary_compressed needs LZF)")
    return _assemble(data, path)


def _assemble(data: Dict[str, np.ndarray], path) -> np.ndarray:
    for axis in ("x", "y", "z"):
        if axis not in data:
            raise ValueError(f"{path}: missing point channel {axis!r}")
    cols = [data["x"], data["y"], data["z"]]
    for name in _INTENSITY_NAMES:
        if name in data:
            cols.append(data[name])
            break
    pts = np.stack([np.asarray(c, np.float64) for c in cols],
                   1).astype(np.float32)
    # drop non-finite points (scanners emit NaN returns)
    return pts[np.isfinite(pts).all(axis=1)]


def read_scan(path) -> np.ndarray:
    """Dispatch on extension: .ply / .pcd / .bin (KITTI float32 Nx4) /
    .npz (``points`` key) / .npy."""
    path = pathlib.Path(path)
    ext = path.suffix.lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".pcd":
        return read_pcd(path)
    if ext == ".bin":
        return np.fromfile(str(path), np.float32).reshape(-1, 4)
    if ext == ".npz":
        return np.asarray(np.load(path)["points"], np.float32)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)
    raise ValueError(f"unsupported scan format: {path}")


def read_annotations(path) -> Tuple[np.ndarray, np.ndarray]:
    """JSON sidecar -> (boxes [M, 7] float32, names [M] str)."""
    with open(path) as f:
        obj = json.load(f)
    boxes = np.asarray(obj.get("boxes", []), np.float32).reshape(-1, 7)
    names = np.asarray([str(n) for n in obj.get("names", [])])
    if len(names) != len(boxes):
        raise ValueError(f"{path}: {len(boxes)} boxes vs "
                         f"{len(names)} names")
    return boxes, names


def write_annotations(path, boxes: np.ndarray, names) -> None:
    with open(path, "w") as f:
        json.dump({"boxes": np.asarray(boxes, np.float64).reshape(
            -1, 7).tolist(), "names": [str(n) for n in names]}, f)
