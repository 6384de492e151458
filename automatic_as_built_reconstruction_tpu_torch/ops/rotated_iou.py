"""Pairwise rotated BEV IoU: CUDA kernel + plain version.

Replaces the TPU kernel ``automatic_as_built_reconstruction_tpu/ops/
pallas/rotated_iou_pallas.py::rotate_iou_matrix_pallas`` (Sutherland–
Hodgman clip in 8-slot vertex buffers, shoelace area, IoU by criterion
-1/0/1), which also computes the XLA ``ops/rotated_iou.py`` function that
``ops/nms_jax.py`` calls.  The CUDA kernel (``csrc/rotated_iou.cu``) first
rejects the pairs that are disjoint by a margin (bounding circles, then
separating axes: :func:`disjoint_pairs` is its plain mirror), and clips
only the others, one pair a thread, with the plain version's arithmetic.
Bound: the larger of the fp32 arithmetic the inputs need
(:func:`clip_flops`) and the bytes (boxes read once, IoUs written once).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# (in, in, out pointers, four ints, stream) of the C launch function
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)

# fp32 arithmetic (add, sub, mul, div) of the clip, per unit of work the
# data asks for.  Not counted: the kernel's rejection tests, compares and
# slot bookkeeping (its way to the work, not arithmetic the clip needs)
# and the per-box corners and edge vectors (amortized over a row or
# column of pairs).
SIDE_FLOPS = 5       # s = ex*(py - aye) - ey*(px - axe): per held vertex, edge
CROSS_FLOPS = 8      # denom, t = s/denom, x and y (sub, mul, add): per crossing
SHOELACE_FLOPS = 4   # 2 mul, sub, add: per vertex of the clipped polygon
IOU_FLOPS = 4        # 0.5 * sum, union (add, sub), division: per pair


def _corners(boxes: torch.Tensor):
    """[..., 5] -> (xs, ys), each [4, ...]: the CCW corners (-,-) (+,-)
    (+,+) (-,+), computed as the TPU kernel's ``_corner_cols`` does."""
    x, y, w, l, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([-0.5 * w, 0.5 * w, 0.5 * w, -0.5 * w])
    ly = torch.stack([-0.5 * l, -0.5 * l, 0.5 * l, 0.5 * l])
    return lx * c - ly * s + x, lx * s + ly * c + y


def _successor(a: torch.Tensor, n: torch.Tensor, idx8: torch.Tensor):
    """Slot i's cyclic successor among the n valid slots: i+1, or 0."""
    return torch.where(idx8 + 1 < n, torch.roll(a, -1, 0), a[0:1])


def _clip(boxes: torch.Tensor, qboxes: torch.Tensor, tally: bool = False):
    """[R, N, 5] x [R, K, 5] -> ([R, N, K] rotated intersection areas,
    and with ``tally`` the total held vertices over the 4 clip steps, the
    total crossings and the vertices of the clipped polygons, else None)."""
    R, N, K = boxes.shape[0], boxes.shape[1], qboxes.shape[1]
    dev = boxes.device
    ax, ay = _corners(boxes.float())            # [4, R, N]
    bx, by = _corners(qboxes.float())           # [4, R, K]
    zeros = torch.zeros((4, R, N, K), dtype=torch.float32, device=dev)
    px = torch.cat([ax[..., None].expand(4, R, N, K), zeros])   # [8,R,N,K]
    py = torch.cat([ay[..., None].expand(4, R, N, K), zeros])
    n = torch.full((R, N, K), 4, dtype=torch.int32, device=dev)
    idx8 = torch.arange(8, device=dev).view(8, 1, 1, 1)
    held = crossings = 0
    for e in range(4):
        axe, aye = bx[e][:, None, :], by[e][:, None, :]          # [R,1,K]
        ex = bx[(e + 1) % 4][:, None, :] - axe
        ey = by[(e + 1) % 4][:, None, :] - aye
        s = ex * (py - aye) - ey * (px - axe)
        nx, ny, sn = (_successor(px, n, idx8), _successor(py, n, idx8),
                      _successor(s, n, idx8))
        active = idx8 < n
        cur_in = s >= 0
        denom = s - sn
        t = torch.where(denom.abs() > 1e-12, s / denom,
                        torch.zeros((), device=dev))
        emit = torch.stack([active & cur_in,
                            active & (cur_in != (sn >= 0))], 1)
        cand_x = torch.stack([px, px + t * (nx - px)], 1)  # [8,2,R,N,K]
        cand_y = torch.stack([py, py + t * (ny - py)], 1)
        if tally:
            held += int(n.sum())
            crossings += int(emit[:, 1].sum())
        emit = emit.reshape(16, R, N, K)
        pos = torch.cumsum(emit.int(), 0) - 1
        pos = torch.where(emit & (pos < 8), pos, 8).long()
        px = torch.zeros((9, R, N, K), device=dev).scatter_(
            0, pos, cand_x.reshape(16, R, N, K))[:8]
        py = torch.zeros((9, R, N, K), device=dev).scatter_(
            0, pos, cand_y.reshape(16, R, N, K))[:8]
        n = emit.sum(0, dtype=torch.int32)
    nx, ny = _successor(px, n, idx8), _successor(py, n, idx8)
    cross = torch.where(idx8 < n, px * ny - nx * py,
                        torch.zeros((), device=dev))
    area = torch.zeros((R, N, K), device=dev)
    for i in range(8):                  # the kernel's summation order
        area = area + cross[i]
    area = torch.clamp_min(0.5 * area, 0.0)
    return area, ((held, crossings, int(n.sum())) if tally else None)


def intersection_area_matrix_plain(boxes: torch.Tensor,
                                   qboxes: torch.Tensor) -> torch.Tensor:
    """[R, N, 5] x [R, K, 5] -> [R, N, K] rotated intersection areas."""
    return _clip(boxes, qboxes)[0]


def clip_flops(boxes: torch.Tensor, qboxes: torch.Tensor) -> int:
    """fp32 arithmetic the rotated IoU of ``[R, N, 5] x [R, K, 5]`` needs
    on these boxes: side values of the vertices each clip step holds,
    crossing points where an edge is crossed, the shoelace over the
    clipped polygon's vertices, and the IoU of every pair."""
    _, (held, crossings, final) = _clip(boxes, qboxes, tally=True)
    pairs = boxes.shape[0] * boxes.shape[1] * qboxes.shape[1]
    return (SIDE_FLOPS * held + CROSS_FLOPS * crossings
            + SHOELACE_FLOPS * final + IOU_FLOPS * pairs)


# The kernel's rejection margin of a box (csrc/rotated_iou.cu):
# REJECT_TOL_REL * mag + REJECT_TOL_MIN with mag = |x| + |y| + r.  A pair is
# rejected only when its boxes are apart by more than the sum of their
# margins, hundreds of times the fp32 rounding of the clip.  A degenerate
# box (a value not finite, mag above REJECT_HUGE, or w or l not above
# REJECT_TOL_REL * mag: zero, negative, or thin enough for its fp32 corners
# to collapse) gets NaN: never rejected.
REJECT_TOL_REL = 2.0 ** -14
REJECT_TOL_MIN = 1e-6
REJECT_HUGE = 1e15


def _reject_params(boxes: torch.Tensor):
    """[..., 5] -> centre, w axis (cos, sin), half sizes, circumradius and
    margin of each box, as the kernel's prologue computes them."""
    x, y, w, l, yaw = boxes.float().unbind(-1)
    r = 0.5 * torch.sqrt(w * w + l * l)
    mag = (x.abs() + y.abs()) + r
    ok = ((w > REJECT_TOL_REL * mag) & (l > REJECT_TOL_REL * mag)
          & (mag <= REJECT_HUGE) & torch.isfinite(yaw))
    tol = torch.where(ok, REJECT_TOL_REL * mag + REJECT_TOL_MIN,
                      torch.full_like(x, float("nan")))
    return x, y, torch.cos(yaw), torch.sin(yaw), 0.5 * w, 0.5 * l, r, tol


def reject_stages(boxes: torch.Tensor, qboxes: torch.Tensor):
    """The kernel's two rejection tests on ``[R, N, 5] x [R, K, 5]`` ->
    (by the bounding circles, by the separating axes of the 4 edge
    normals), each ``[R, N, K]`` bool and each on its own (the kernel
    tries the axes only where the circles do not reject)."""
    ax, ay, ac, as_, ahw, ahl, ar, atol = (
        t[:, :, None] for t in _reject_params(boxes))
    bx, by, bc, bs, bhw, bhl, br, btol = (
        t[:, None, :] for t in _reject_params(qboxes))
    m = atol + btol
    dx, dy = bx - ax, by - ay
    reach = (ar + br) + m
    circles = dx * dx + dy * dy > reach * reach
    cab = ac * bc + as_ * bs                    # ua . ub
    sab = as_ * bc - ac * bs                    # ua . vb
    acab, asab = cab.abs(), sab.abs()
    axes = (((dx * ac + dy * as_).abs()
             > ((ahw + acab * bhw) + asab * bhl) + m)
            | ((dy * ac - dx * as_).abs()
               > ((ahl + asab * bhw) + acab * bhl) + m)
            | ((dx * bc + dy * bs).abs()
               > ((bhw + acab * ahw) + asab * ahl) + m)
            | ((dy * bc - dx * bs).abs()
               > ((bhl + asab * ahw) + acab * ahl) + m))
    return circles, axes


def disjoint_pairs(boxes: torch.Tensor, qboxes: torch.Tensor) -> torch.Tensor:
    """``[R, N, K]`` bool: the pairs the kernel rejects without clipping
    (and writes 0.0 for), by the same tests and margins."""
    circles, axes = reject_stages(boxes, qboxes)
    return circles | axes

def _iou_from_inter(inter, boxes, qboxes, criterion: int):
    area_a = (boxes[..., 2] * boxes[..., 3]).float()[:, :, None]
    area_b = (qboxes[..., 2] * qboxes[..., 3]).float()[:, None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = area_a.expand_as(inter)
    else:
        denom = area_b.expand_as(inter)
    return torch.where(denom > 0, inter / torch.clamp_min(denom, 1e-12),
                       torch.zeros((), device=inter.device))


def rotate_iou_matrix_plain(boxes: torch.Tensor, qboxes: torch.Tensor,
                            criterion: int = -1) -> torch.Tensor:
    """Plain PyTorch version of :func:`rotate_iou_matrix` ([R,N,5] x
    [R,K,5] -> [R,N,K])."""
    inter = intersection_area_matrix_plain(boxes, qboxes)
    return _iou_from_inter(inter, boxes, qboxes, criterion)


def rotate_iou_matrix(boxes: torch.Tensor, qboxes: torch.Tensor,
                      criterion: int = -1) -> torch.Tensor:
    """Rotated IoU of (x, y, w, l, yaw) BEV boxes, fp32.

    ``[R, N, 5] x [R, K, 5] -> [R, N, K]``: one IoU matrix per row r.
    ``criterion``: -1 = IoU over the union, 0 = over area A, 1 = over
    area B.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if criterion not in (-1, 0, 1):
        raise ValueError(f"criterion must be -1, 0 or 1, got {criterion}")
    if (boxes.dim() != 3 or qboxes.dim() != 3 or boxes.shape[-1] != 5
            or qboxes.shape[-1] != 5 or boxes.shape[0] != qboxes.shape[0]):
        raise ValueError(f"boxes {tuple(boxes.shape)} / qboxes "
                         f"{tuple(qboxes.shape)}: want [R,N,5] / [R,K,5]")
    if not boxes.is_cuda:
        return rotate_iou_matrix_plain(boxes, qboxes, criterion)
    if boxes.dtype != torch.float32 or qboxes.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 boxes, got {boxes.dtype} / "
                        f"{qboxes.dtype}")
    if qboxes.device != boxes.device:
        raise ValueError("boxes and qboxes on different devices")
    boxes = boxes.contiguous()
    qboxes = qboxes.contiguous()
    R, N, K = boxes.shape[0], boxes.shape[1], qboxes.shape[1]
    out = torch.empty((R, N, K), dtype=torch.float32, device=boxes.device)
    fn = _build.function("rotated_iou", "rotated_iou_launch", _ARGTYPES)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), qboxes.data_ptr(), out.data_ptr(),
                 R, N, K, int(criterion), stream)
    _build.check(err, "rotated_iou_launch")
    rotate_iou_matrix.launches += 1
    return out


rotate_iou_matrix.launches = 0
