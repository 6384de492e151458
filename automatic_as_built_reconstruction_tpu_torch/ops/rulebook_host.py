"""Host-side sparse-conv rulebooks, built in the input pipeline.

The port of the JAX package's ``ops/rulebook_host.py``: voxel coords come
from the host voxelizer, so every rulebook and strided layout of the
sparse middle stack is known before the batch ships to the device.  The
host-rulebook configs (``second/people.fhd``, ``second/car/car.lite``,
``second/car/car.fhd.mixed``) build them here, per example, and the
middle receives them with the batch instead of building them on the
device.

Two implementations with identical outputs:

- the native builder (``csrc/rulebook_host.cpp``, the port's copy of the
  reference's C++ entry points), built with g++ at first use
  (``ops/_build.py::load_host``) and called through ``ctypes``, which
  releases the GIL, so the loader's threads overlap;
- numpy twins (:func:`subm_rulebook_np`, :func:`strided_layout_np`),
  reached only through ``numpy=True``: the tests' oracle.

There is no quiet fallback: when the native library cannot be built or
loaded, the call raises.  Both are bit-identical to the device merge
builders in ``ops.sparse_conv`` (same tap order, sorted-unique output
sites, ``max_out`` truncation).

Transport format: a flat ``{str: np.ndarray}`` dict (keys ``rb{i}_*``),
so examples stack through ``data.batching`` unchanged; :func:`unflatten`
rebuilds the ``(SubmanifoldRulebook, StridedSparseLayout)`` pairs the
middle consumes, as torch tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import _build
from . import sparse_conv as sc

K333 = 27


@functools.cache
def native() -> ctypes.CDLL:
    """The native builder, built and loaded at first use, its three entry
    points typed as the reference's ``native/__init__.py:_load`` types
    them.  Raises (``_build.KernelBuildError``, ``OSError``) when it
    cannot be built or loaded."""
    lib = _build.load_host("rulebook_host")
    i64 = ctypes.c_int64
    ip32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    up = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.abr_subm_rulebook.restype = None
    lib.abr_subm_rulebook.argtypes = [ip32, i64, ip32, ip32, ip32, up]
    lib.abr_strided_layout.restype = ctypes.c_int
    lib.abr_strided_layout.argtypes = [ip32, i64, ip32, ip32, ip32, ip32,
                                       i64, ip32, up, ip32, up]
    lib.abr_block_rulebooks.restype = ctypes.c_int
    lib.abr_block_rulebooks.argtypes = [ip32, i64, ip32, ip32, ip32, ip32,
                                        i64, ip32, up, ip32, up, ip32, up]
    return lib


def _i32(values) -> np.ndarray:
    return np.ascontiguousarray(values, np.int32)


# --------------------------------------------------------------------------
# single-block builders: numpy twins (the tests' oracle) and native calls
# --------------------------------------------------------------------------

def _coord_table(coords: np.ndarray, grid) -> Dict[int, int]:
    D, H, W = grid
    table: Dict[int, int] = {}
    for i in range(coords.shape[0]):
        z, y, x = (int(coords[i, 0]), int(coords[i, 1]), int(coords[i, 2]))
        if z < 0 or z >= D or y < 0 or y >= H or x < 0 or x >= W:
            continue
        key = (y * W + x) * D + z    # depth-minor (sparse_conv.linearize)
        table.setdefault(key, i)   # first wins (device parity)
    return table


def _offsets(kernel) -> np.ndarray:
    kz, ky, kx = kernel
    return np.stack(np.meshgrid(
        np.arange(kz) - kz // 2,
        np.arange(ky) - ky // 2,
        np.arange(kx) - kx // 2, indexing="ij"), -1).reshape(-1, 3)


def subm_rulebook_np(coords: np.ndarray, grid, kernel=(3, 3, 3)):
    """[N,3] int32 (z,y,x; -1 pad) -> (gather_idx [K,N] i32, found [K,N])."""
    N = coords.shape[0]
    D, H, W = grid
    table = _coord_table(coords, grid)
    offs = _offsets(kernel)
    K = offs.shape[0]
    gather_idx = np.zeros((K, N), np.int32)
    found = np.zeros((K, N), bool)
    valid = coords[:, 0] >= 0
    for k in range(K):
        q = coords + offs[k][None, :]
        ok = valid & (q >= 0).all(-1) & (q[:, 0] < D) & (q[:, 1] < H) \
            & (q[:, 2] < W)
        for i in np.nonzero(ok)[0]:
            key = (int(q[i, 1]) * W + int(q[i, 2])) * D + int(q[i, 0])
            j = table.get(key)
            if j is not None:
                gather_idx[k, i] = j
                found[k, i] = True
    return gather_idx, found


def strided_layout_np(coords: np.ndarray, grid, kernel, stride, pad,
                      max_out: int):
    """Numpy twin of the native ``abr_strided_layout``: (out_coords [M,3],
    out_valid [M], gather_idx [T,M], found [T,M], num_out)."""
    D, H, W = grid
    s, p, k = np.asarray(stride), np.asarray(pad), np.asarray(kernel)
    out_grid = tuple(int((g + 2 * pp - kk) // ss + 1)
                     for g, pp, kk, ss in zip(grid, p, k, s))
    valid = coords[:, 0] >= 0
    cand = set()
    for i in np.nonzero(valid)[0]:
        rng = []
        for d in range(3):
            ip = int(coords[i, d]) + int(p[d])
            lo = max(0, -((-(ip - int(k[d]) + 1)) // int(s[d])))
            hi = min(ip // int(s[d]), out_grid[d] - 1)
            rng.append(range(lo, hi + 1))
        for oz in rng[0]:
            for oy in rng[1]:
                for ox in rng[2]:
                    cand.add((oy * out_grid[2] + ox) * out_grid[0] + oz)
    keys = sorted(cand)[:max_out]
    num_out = len(keys)
    out_coords = np.full((max_out, 3), -1, np.int32)
    for o, key in enumerate(keys):
        out_coords[o] = (key % out_grid[0],
                         key // (out_grid[2] * out_grid[0]),
                         (key // out_grid[0]) % out_grid[2])
    out_valid = np.arange(max_out) < num_out

    table = _coord_table(coords, grid)
    taps = np.stack(np.meshgrid(*[np.arange(int(kk)) for kk in k],
                                indexing="ij"), -1).reshape(-1, 3)
    T = taps.shape[0]
    gather_idx = np.zeros((T, max_out), np.int32)
    found = np.zeros((T, max_out), bool)
    for t in range(T):
        ic = out_coords * s[None, :] + taps[t][None, :] - p[None, :]
        ok = out_valid & (ic >= 0).all(-1) & (ic[:, 0] < D) \
            & (ic[:, 1] < H) & (ic[:, 2] < W)
        for o in np.nonzero(ok)[0]:
            key = (int(ic[o, 1]) * W + int(ic[o, 2])) * D + int(ic[o, 0])
            j = table.get(key)
            if j is not None:
                gather_idx[t, o] = j
                found[t, o] = True
    return out_coords, out_valid, gather_idx, found, num_out


def subm_rulebook(coords: np.ndarray, grid, kernel=(3, 3, 3)):
    """The native submanifold rulebook: (gather_idx [K,N] i32, found
    [K,N] bool)."""
    coords = _i32(coords)
    N = coords.shape[0]
    K = int(np.prod(kernel))
    gather_idx = np.empty((K, N), np.int32)
    found = np.empty((K, N), np.uint8)
    native().abr_subm_rulebook(coords, N, _i32(grid), _i32(kernel),
                               gather_idx, found)
    return gather_idx, found.astype(bool)


def strided_layout(coords: np.ndarray, grid, kernel, stride, pad,
                   max_out: int):
    """The native strided layout + rulebook (as :func:`strided_layout_np`)."""
    coords = _i32(coords)
    N = coords.shape[0]
    T = int(np.prod(kernel))
    out_coords = np.empty((max_out, 3), np.int32)
    out_valid = np.empty((max_out,), np.uint8)
    gather_idx = np.empty((T, max_out), np.int32)
    found = np.empty((T, max_out), np.uint8)
    num_out = native().abr_strided_layout(
        coords, N, _i32(grid), _i32(kernel), _i32(stride), _i32(pad),
        max_out, out_coords, out_valid, gather_idx, found)
    return (out_coords, out_valid.astype(bool), gather_idx,
            found.astype(bool), num_out)


# --------------------------------------------------------------------------
# full middle-stack precompute + flat transport format
# --------------------------------------------------------------------------

def block_rulebooks(coords: np.ndarray, blk: sc.BlockPlan,
                    numpy: bool = False):
    """One block's (subm idx, subm found, out_coords, out_valid, down idx,
    down found).

    When the submanifold and strided kernels agree (the 3x3x3 case) both
    come from one native call that shares the sorted key table; a z-only
    strided kernel (3,1,1), or a block with no submanifold layers, takes
    separate calls, and ``n_subm == 0`` gives zero-tap submanifold arrays
    (the transport format stays fixed).  ``numpy=True`` takes the numpy
    twins instead of the native builder."""
    N = coords.shape[0]
    same_kernel = tuple(blk.subm_kernel) == tuple(blk.kernel)
    if numpy or not same_kernel or blk.n_subm == 0:
        subm = subm_rulebook_np if numpy else subm_rulebook
        strided = strided_layout_np if numpy else strided_layout
        if blk.n_subm > 0:
            gi, fo = subm(coords, blk.grid, blk.subm_kernel)
        else:
            gi = np.zeros((0, N), np.int32)
            fo = np.zeros((0, N), bool)
        oc, ov, dgi, dfo, _ = strided(coords, blk.grid, blk.kernel,
                                      blk.stride, blk.pad, blk.out_cap)
        return gi, fo, oc, ov, dgi, dfo
    coords = _i32(coords)
    K = int(np.prod(blk.kernel))
    M = blk.out_cap
    gi = np.empty((K, N), np.int32)
    fo = np.empty((K, N), np.uint8)
    oc = np.empty((M, 3), np.int32)
    ov = np.empty((M,), np.uint8)
    dgi = np.empty((K, M), np.int32)
    dfo = np.empty((K, M), np.uint8)
    native().abr_block_rulebooks(
        coords, N, _i32(blk.grid), _i32(blk.kernel), _i32(blk.stride),
        _i32(blk.pad), M, gi, fo, oc, ov, dgi, dfo)
    return gi, fo.astype(bool), oc, ov.astype(bool), dgi, dfo.astype(bool)


def build_middle_rulebooks(coords: np.ndarray,
                           plan: Sequence[sc.BlockPlan],
                           numpy: bool = False) -> Dict[str, np.ndarray]:
    """coords [V,3] (z,y,x; -1 pad) -> flat per-block rulebook dict.

    Keys per block i: ``rb{i}_subm_idx`` [27,N] i32, ``rb{i}_subm_found``
    [27,N] bool, ``rb{i}_out_coords`` [M,3] i32, ``rb{i}_out_valid`` [M]
    bool, ``rb{i}_down_idx`` [27,M] i32, ``rb{i}_down_found`` [27,M] bool.
    """
    out: Dict[str, np.ndarray] = {}
    cur = _i32(coords)
    for i, blk in enumerate(plan):
        gi, fo, oc, ov, dgi, dfo = block_rulebooks(cur, blk, numpy)
        out[f"rb{i}_subm_idx"] = gi
        out[f"rb{i}_subm_found"] = fo
        out[f"rb{i}_out_coords"] = oc
        out[f"rb{i}_out_valid"] = ov
        out[f"rb{i}_down_idx"] = dgi
        out[f"rb{i}_down_found"] = dfo
        cur = oc
    return out


def rulebook_keys(num_blocks: int) -> Tuple[str, ...]:
    keys = []
    for i in range(num_blocks):
        keys += [f"rb{i}_subm_idx", f"rb{i}_subm_found",
                 f"rb{i}_out_coords", f"rb{i}_out_valid",
                 f"rb{i}_down_idx", f"rb{i}_down_found"]
    return tuple(keys)


def unflatten(flat: Dict[str, object], num_blocks: int, device=None):
    """Flat (possibly batch-stacked) dict of numpy arrays or tensors ->
    per-block ``(SubmanifoldRulebook, StridedSparseLayout)`` pairs of
    tensors on ``device`` (where the arrays are, if None), as
    ``models.middle.SparseMiddle`` consumes them."""
    def t(key):
        return torch.as_tensor(flat[key], device=device)

    books = []
    for i in range(num_blocks):
        rb = sc.SubmanifoldRulebook(gather_idx=t(f"rb{i}_subm_idx"),
                                    found=t(f"rb{i}_subm_found"))
        out_valid = t(f"rb{i}_out_valid")
        layout = sc.StridedSparseLayout(
            out_coords=t(f"rb{i}_out_coords"), out_valid=out_valid,
            gather_idx=t(f"rb{i}_down_idx"), found=t(f"rb{i}_down_found"),
            num_out=out_valid.sum(-1).to(torch.int32))
        books.append((rb, layout))
    return tuple(books)


def split_example(example: Dict[str, object]):
    """Split an example/batch dict into (non-rulebook, rulebook) parts."""
    rb = {k: v for k, v in example.items() if k.startswith("rb")}
    rest = {k: v for k, v in example.items() if not k.startswith("rb")}
    return rest, rb


__all__ = ["block_rulebooks", "build_middle_rulebooks", "native",
           "rulebook_keys", "split_example", "strided_layout",
           "strided_layout_np", "subm_rulebook", "subm_rulebook_np",
           "unflatten"]
