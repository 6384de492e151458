"""Pillar scatter into a dense BEV canvas and its gradient: CUDA kernels +
plain versions.

Replaces the TPU kernel
``automatic_as_built_reconstruction_tpu/ops/pallas/pillar_scatter.py::
scatter_sorted_to_canvas`` (one-hot matmul per canvas tile).  The CUDA
kernel (``csrc/pillar_scatter.cu``) stores each pillar row at its cell
directly.  On a CUDA tensor the call is a ``torch.autograd.Function``
whose backward is the second kernel of that source,
``pillar_gather_kernel`` (the transpose: each row reads the canvas
gradient at its cell); the JAX package has no Pallas backward here, XLA
transposes its training scatter.  Both kernels are bound by bytes; see
the source note for what the design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# (in, in, out pointers, four ints, stream) of the C launch functions
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


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


def _check_kernel_args(x: torch.Tensor, lin: torch.Tensor, rows: int,
                       what: str) -> None:
    if x.dtype != torch.float32 or lin.dtype != torch.int32:
        raise TypeError(f"{what} takes float32 values and int32 ids, got "
                        f"{x.dtype} / {lin.dtype}")
    if lin.device != x.device:
        raise ValueError(f"{what}: values and ids on different devices")
    if lin.shape[0] * lin.shape[1] != rows:
        raise ValueError(f"{what}: ids {tuple(lin.shape)} do not match")
    if x.shape[-1] % 4 or x.data_ptr() % 16:
        raise ValueError(f"{what} copies float4s: C = {x.shape[-1]} must be "
                         f"a multiple of 4 and the values 16-byte aligned")


def _launch(symbol: str, src: torch.Tensor, lin: torch.Tensor,
            out: torch.Tensor, B: int, V: int, C: int, hw: int) -> None:
    fn = _build.function("pillar_scatter", symbol, _ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), lin.data_ptr(), out.data_ptr(),
                 B, V, C, int(hw), stream)
    _build.check(err, symbol)


def _scatter_kernel(feats: torch.Tensor, lin: torch.Tensor,
                    hw: int) -> torch.Tensor:
    feats = feats.contiguous()
    lin = lin.contiguous()
    B, V, C = feats.shape
    _check_kernel_args(feats, lin, B * V, "pillar_scatter")
    canvas = torch.zeros((B, hw, C), dtype=feats.dtype, device=feats.device)
    _launch("pillar_scatter_launch", feats, lin, canvas, B, V, C, hw)
    scatter_sorted_to_canvas.launches += 1
    return canvas


class _ScatterToCanvas(torch.autograd.Function):
    """K1 with its gradient: forward the scatter kernel, backward the
    gather kernel."""

    @staticmethod
    def forward(ctx, feats, lin, hw):
        ctx.save_for_backward(lin)
        return _scatter_kernel(feats, lin, hw)

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
    host one: the kernel stores each row at its cell and needs unique
    ids, not ascending ones; the name is the JAX function's, whose TPU
    kernel does need them sorted).  Rows whose id lies outside
    ``[0, hw)`` are dropped and cells with no pillar are 0.  Duplicate
    ids within a scan are not an accepted input: no voxelizer makes
    them, and the kernel would keep an arbitrary one.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, C a multiple of 4, int32 ids) or raise, and the gradient to
    ``feats`` launches :func:`pillar_gather`'s kernel.
    """
    if feats.dim() != 3 or lin.shape != feats.shape[:2]:
        raise ValueError(f"feats {tuple(feats.shape)} / lin "
                         f"{tuple(lin.shape)}: want [B,V,C] / [B,V]")
    if not feats.is_cuda:
        return scatter_sorted_to_canvas_plain(feats, lin, hw)
    return _ScatterToCanvas.apply(feats, lin, hw)


def pillar_gather(dcanvas: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """Canvas gradient [B, hw, C] + the forward's cell ids [B, V] -> the
    pillar rows' gradient [B, V, C]: ``dcanvas[b, lin[b, v]]`` where
    ``0 <= lin < hw``, else 0 (the transpose of
    :func:`scatter_sorted_to_canvas` for unique ids).

    CPU tensors take the plain version; CUDA tensors launch
    ``pillar_gather_kernel`` (fp32, C a multiple of 4, int32 ids) or
    raise.
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
    _check_kernel_args(dcanvas, lin, B * V, "pillar_gather")
    dfeats = torch.empty((B, V, C), dtype=dcanvas.dtype,
                         device=dcanvas.device)
    _launch("pillar_gather_launch", dcanvas, lin, dfeats, B, V, C, hw)
    pillar_gather.launches += 1
    return dfeats


scatter_sorted_to_canvas.launches = 0
pillar_gather.launches = 0
