"""Pillar scatter into a dense BEV canvas and its gradient: CUDA kernels +
plain versions.

Replaces the TPU kernel
``automatic_as_built_reconstruction_tpu/ops/pallas/pillar_scatter.py::
scatter_sorted_to_canvas`` (one-hot matmul per canvas tile).  The forward
takes one of two routes by the canvas's size (:func:`scatter_plan`): the
tiles (``pillar_scatter_kernel``, one launch into an uninitialised canvas:
each block streams its tile's zeros while its cluster reads the scan's
ids into the blocks' maps, then copies its rows over them) or, for a large
canvas, a zero fill and ``pillar_rows_kernel``; both are the
``abr::pillar_scatter`` op of ``ops/library.py`` (its CUDA body is
:func:`_scatter_cuda`).  With grad recorded the call is a
``torch.autograd.Function`` whose backward is
``pillar_gather_kernel`` (the transpose: each row reads the canvas
gradient at its cell, :func:`gather_plan`); the JAX package has no Pallas
backward here, XLA transposes its training scatter.  The kernels copy
rows as 16-byte chunks whatever their type, so they take float32 rows and
the bfloat16 rows of ``compute_dtype="bfloat16"`` alike, and give the
plain version's bits.  All are bound by bytes; see the source note for
what the design does about it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, library

# the C launch functions: (in, in, out pointers, ints, stream); the rows
# kernel's takes the gather's
_SCATTER_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p,)
_GATHER_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)


def scatter_sorted_to_canvas_plain(feats: torch.Tensor, lin: torch.Tensor,
                                   hw: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_sorted_to_canvas` (autograd
    differentiates it itself)."""
    B, V, C = feats.shape
    lin = lin.long()
    ok = (lin >= 0) & (lin < hw)
    canvas = torch.zeros((B, hw + 1, C), dtype=feats.dtype,
                         device=feats.device)
    bidx = torch.arange(B, device=feats.device)[:, None].expand(B, V)
    canvas[bidx[ok], lin[ok]] = feats[ok]
    return canvas[:, :hw]


def pillar_gather_plain(dcanvas: torch.Tensor,
                        lin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pillar_gather`."""
    B, hw, C = dcanvas.shape
    lin = lin.long()
    ok = (lin >= 0) & (lin < hw)
    rows = torch.gather(dcanvas, 1, torch.where(ok, lin, 0)[..., None]
                        .expand(*lin.shape, C))
    return torch.where(ok[..., None], rows,
                       torch.zeros((), dtype=dcanvas.dtype,
                                   device=dcanvas.device))


KERNEL_DTYPES = (torch.float32, torch.bfloat16)
CHUNK_BYTES = 16                 # what one thread of the kernels copies
INT32_CHUNKS = 2 ** 31           # the kernels index chunks in 32 bits
# the launch plans.  The forward takes one of two routes by the canvas's
# size: up to SCATTER_TILES_MAX_BYTES the tiles (one launch into an
# uninitialised canvas), above it a zero fill and the rows kernel
# (pillar_scatter_ablation.py: the tiles beat the fill and the rows on the
# served 13 MB canvas and lose on the KITTI ones of 55-439 MB, whose zeros
# the fill's many small blocks stream at the card's write rate).  Threads
# a block (csrc/pillar_scatter.cu's SCATTER_THREADS, ROWS_THREADS and
# GATHER_THREADS), the tiles' blocks a cluster (SCATTER_CLUSTER) and cells
# a granule (SCATTER_GRANULE: a scan's granules are dealt to its tiles in
# turn); the tiles a plan gives each SM (one, measured against two: fewer
# blocks read the ids fewer times), and the least and most cells a tile
# holds (its map and list: 6 bytes a cell of shared memory, within the 48
# KB a block has without asking for more)
SCATTER_TILES_MAX_BYTES = 32 << 20
SCATTER_THREADS = 512
SCATTER_CLUSTER = 2
SCATTER_GRANULE = 16
SCATTER_BLOCKS_PER_SM = 1
SCATTER_MIN_TILE, SCATTER_MAX_TILE = 64, 8000
ROWS_THREADS = 256
GATHER_THREADS = 256


class ScatterPlan(NamedTuple):
    route: str      # "tiles" or "rows"
    tile: int       # tiles: the most canvas cells a block owns (its map)
    tiles: int      # tiles: a scan's, a multiple of SCATTER_CLUSTER
    blocks: int     # tiles: B * tiles; rows: a thread a chunk of a row


def scatter_plan(B: int, V: int, hw: int, cw: int, sms: int) -> ScatterPlan:
    """The forward's route and grid for B scans of V rows of ``cw`` 16-byte
    chunks onto hw cells, on a card of ``sms`` SMs: the tiles
    (:func:`tile_plan`) for a canvas of at most SCATTER_TILES_MAX_BYTES,
    else a zero fill and the rows kernel, a thread a chunk."""
    if B * hw * cw * CHUNK_BYTES > SCATTER_TILES_MAX_BYTES:
        blocks = max(1, -(-B * V * cw // ROWS_THREADS))
        return ScatterPlan("rows", 0, 0, blocks)
    return tile_plan(B, hw, sms)


def tile_plan(B: int, hw: int, sms: int,
              per_sm: int = SCATTER_BLOCKS_PER_SM,
              cluster: int = SCATTER_CLUSTER) -> ScatterPlan:
    """The tiles' grid for B scans onto hw cells on a card of ``sms`` SMs.
    A scan's cells fall in granules of SCATTER_GRANULE, dealt to its tiles
    in turn (tile t owns granules t, t + tiles, ...), so that a dense part
    of a scan spreads over many blocks; the tiles go in clusters of
    ``cluster``.  As many tiles as make the grid about ``per_sm`` blocks
    an SM, but none under SCATTER_MIN_TILE cells (a scan's ids are read
    once a cluster) or over SCATTER_MAX_TILE where hw allows it, and none
    without a granule."""
    k, g = cluster, SCATTER_GRANULE
    granules = -(-hw // g)
    tiles = max(k, per_sm * sms // B // k * k)
    tiles = min(tiles, max(k, hw // SCATTER_MIN_TILE // k * k),
                max(k, granules // k * k))
    tiles = max(tiles, -(-granules * g // (SCATTER_MAX_TILE * k)) * k)
    return ScatterPlan("tiles", -(-granules // tiles) * g, tiles, B * tiles)


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, as the plans take them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def gather_plan(B: int, V: int, cw: int) -> int:
    """The backward kernel's blocks for B scans of V rows of ``cw``
    16-byte chunks: a thread a chunk, GATHER_THREADS a block."""
    return max(1, -(-B * V * cw // GATHER_THREADS))


def _check_kernel_args(x: torch.Tensor, lin: torch.Tensor, rows: int,
                       cells: int, what: str) -> None:
    if x.dtype not in KERNEL_DTYPES or lin.dtype != torch.int32:
        raise TypeError(f"{what} takes float32 or bfloat16 values and int32 "
                        f"ids, got {x.dtype} / {lin.dtype}")
    if lin.device != x.device:
        raise ValueError(f"{what}: values and ids on different devices")
    if lin.shape[0] * lin.shape[1] != rows:
        raise ValueError(f"{what}: ids {tuple(lin.shape)} do not match")
    per_chunk = CHUNK_BYTES // x.element_size()
    if x.shape[-1] % per_chunk or x.data_ptr() % CHUNK_BYTES:
        raise ValueError(f"{what} copies 16-byte chunks: C = {x.shape[-1]} "
                         f"must be a multiple of {per_chunk} ({x.dtype}) "
                         f"and the values 16-byte aligned")
    cw = x.shape[-1] // per_chunk
    if max(cells, rows) * cw >= INT32_CHUNKS:
        raise ValueError(f"{what}: {max(cells, rows)} rows of {cw} chunks "
                         f"exceed the kernels' 32-bit chunk index")


def _launch(symbol: str, argtypes, src: torch.Tensor, lin: torch.Tensor,
            out: torch.Tensor, *ints: int) -> None:
    fn = _build.function("pillar_scatter", symbol, argtypes)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), lin.data_ptr(), out.data_ptr(), *ints,
                 stream)
    _build.check(err, symbol)


def _scatter_cuda(feats: torch.Tensor, lin: torch.Tensor,
                  hw: int) -> torch.Tensor:
    """The CUDA body of the ``abr::pillar_scatter`` op
    (``ops/library.py``): checks, a launch of :func:`scatter_plan`'s
    route, its count."""
    feats = feats.contiguous()
    lin = lin.contiguous()
    B, V, C = feats.shape
    hw = int(hw)
    _check_kernel_args(feats, lin, B * V, B * hw, "pillar_scatter")
    cw = C * feats.element_size() // CHUNK_BYTES
    plan = scatter_plan(B, V, hw, cw, sm_count(feats.device))
    if plan.route == "rows":
        canvas = torch.zeros((B, hw, C), dtype=feats.dtype,
                             device=feats.device)
        _launch("pillar_rows_launch", _GATHER_ARGTYPES, feats, lin, canvas,
                B, V, cw, hw, plan.blocks)
    else:
        if -(-hw // SCATTER_GRANULE) * plan.tiles >= 2 ** 32:
            raise ValueError(f"pillar_scatter: {hw} cells in {plan.tiles} "
                             f"tiles exceed the kernel's 32-bit granule "
                             f"arithmetic")
        # the kernel writes every chunk of the canvas: no fill
        canvas = torch.empty((B, hw, C), dtype=feats.dtype,
                             device=feats.device)
        _launch("pillar_scatter_launch", _SCATTER_ARGTYPES, feats, lin,
                canvas, B, V, cw, hw, plan.tile, plan.tiles)
    scatter_sorted_to_canvas.launches += 1
    return canvas


class _ScatterToCanvas(torch.autograd.Function):
    """K1 with its gradient: forward the scatter op, backward
    :func:`pillar_gather` (the gather kernel on the card)."""

    @staticmethod
    def forward(ctx, feats, lin, hw):
        ctx.save_for_backward(lin)
        return library.pillar_scatter(feats, lin, int(hw))

    @staticmethod
    def backward(ctx, dcanvas):
        (lin,) = ctx.saved_tensors
        return pillar_gather(dcanvas, lin), None, None


def scatter_sorted_to_canvas(feats: torch.Tensor, lin: torch.Tensor,
                             hw: int) -> torch.Tensor:
    """[B, V, C] pillar features + linear cell ids [B, V] -> canvas
    [B, hw, C] (the JAX function's [hw, C] layout per scan).

    ``lin`` holds each scan's unique cell ids ``y * W + x`` in any order
    (key order from the device voxelizer, first-appearance order from the
    host one: the kernels map each cell to its row and need unique ids,
    not ascending ones; the name is the JAX function's, whose TPU kernel
    does need them sorted).  Rows whose id lies outside
    ``[0, hw)`` are dropped and cells with no pillar are 0.  Duplicate
    ids within a scan are not an accepted input: no voxelizer makes
    them, and the kernel would keep an arbitrary one.

    Runs the ``abr::pillar_scatter`` op: on CPU tensors the plain
    version, on CUDA tensors a kernel of :func:`scatter_plan`'s route
    (float32 with C a multiple of 4, or bfloat16 with C a multiple of 8;
    int32 ids) or it raises.  With grad recorded the gradient to
    ``feats`` is :func:`pillar_gather` (its kernel on the card).  The
    canvas has the features' type.
    """
    if feats.dim() != 3 or lin.shape != feats.shape[:2]:
        raise ValueError(f"feats {tuple(feats.shape)} / lin "
                         f"{tuple(lin.shape)}: want [B,V,C] / [B,V]")
    if torch.is_grad_enabled() and feats.requires_grad:
        return _ScatterToCanvas.apply(feats, lin, hw)
    return library.pillar_scatter(feats, lin, int(hw))


def pillar_gather(dcanvas: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """Canvas gradient [B, hw, C] + the forward's cell ids [B, V] -> the
    pillar rows' gradient [B, V, C]: ``dcanvas[b, lin[b, v]]`` where
    ``0 <= lin < hw``, else 0 (the transpose of
    :func:`scatter_sorted_to_canvas` for unique ids).

    CPU tensors take the plain version; CUDA tensors launch
    ``pillar_gather_kernel`` (as the forward: float32 or bfloat16, rows of
    16-byte chunks, int32 ids) or raise.
    """
    if dcanvas.dim() != 3 or lin.dim() != 2 or lin.shape[0] != \
            dcanvas.shape[0]:
        raise ValueError(f"dcanvas {tuple(dcanvas.shape)} / lin "
                         f"{tuple(lin.shape)}: want [B,hw,C] / [B,V]")
    if not dcanvas.is_cuda:
        return pillar_gather_plain(dcanvas, lin)
    dcanvas = dcanvas.contiguous()
    lin = lin.contiguous()
    B, hw, C = dcanvas.shape
    V = lin.shape[1]
    _check_kernel_args(dcanvas, lin, B * V, B * hw, "pillar_gather")
    dfeats = torch.empty((B, V, C), dtype=dcanvas.dtype,
                         device=dcanvas.device)
    cw = C * dcanvas.element_size() // CHUNK_BYTES
    _launch("pillar_gather_launch", _GATHER_ARGTYPES, dcanvas, lin, dfeats,
            B, V, cw, hw, gather_plan(B, V, cw))
    pillar_gather.launches += 1
    return dfeats


scatter_sorted_to_canvas.launches = 0
pillar_gather.launches = 0
