"""The sparse-convolution joins: gather-GEMM and key-match GEMM, each a
CUDA kernel with its plain version.

Replaces the TPU kernels of ``automatic_as_built_reconstruction_tpu/ops/
pallas/sparse_gather_gemm.py``: ``gather_gemm`` (:331; Pallas bodies
``_pallas_gather_gemm`` and ``_pallas_gather_gemm_shared``) and
``keymatch_gemm`` (:1098; bodies ``_pallas_keymatch_gemm``, ``_shared``,
``_subwin`` and ``_grouped``).  The bodies of one family compute one
function and differ only in how a TPU tile finds the window of feature
rows it copies into VMEM; a GPU thread reads any row, so
``csrc/sparse_gather_gemm.cu`` runs both families on one tile.  The
functions keep the JAX signatures: ``interpret``, ``tile``, ``window``,
``shared``, ``subwindow`` and ``group`` are accepted and change nothing
(with ``group > 1`` the caller has permuted ``q_keys`` and ``weights``
alike with :func:`group_perm`, and a sum over taps does not depend on
their order).  The window-sizing helpers of the JAX module tune the TPU
windows and have no counterpart here.

The kernel's tile: ``TILE_R`` output rows, the source rows of all taps
looked up first, the gathered rows and ``W[k]`` of the non-empty taps
copied by ``cp.async`` through a two-stage ring, the products on the
tensor cores as ``mma.sync`` TF32 with a 3xTF32 split, which is as
accurate as fp32 (see the source note).  Each tile adds its taps in
ascending order: no atomics, the same bits run after run and batched or
not.  Bound: operations at the 3xTF32 rate (495 / 3 TFLOP/s on an H100)
for the 27-tap joins at 32 and 64 channels; :func:`tile_occupancy` says
what share of the tensor-core work the data needs.

Both take an optional leading batch dimension on everything but the
weights (the JAX package maps the kernel over the batch; here the batch
is the launch grid's second axis).  No gradient yet: with grad mode on,
the wrappers refuse inputs that require grad.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .sparse_conv import _merge_lookup, gathered_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
# feats, idx, found, W, out | B, N, R, K, Cin, Cout | stream
_GATHER_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# feats, in_keys, q_keys, sorted_flag, W, out | B, N, R, K, Cin, Cout | stream
_KEYMATCH_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
KERNEL_COUTS = (8, 16, 32, 64, 128)
MAX_SMEM_BYTES = 232448          # what one block may use on an H100
TILE_R = 64                      # output rows per block of the kernel


def group_perm(kernel_size) -> np.ndarray:
    """Tap permutation that makes dz-groups contiguous: tap enumeration is
    z-major (``k = (dz*ky + dy)*kx + dx``); the grouped form wants
    (dy, dx)-major with dz minor — ``ky*kx`` groups of ``kz`` taps each.
    Applied to both the query-key rows and the weight taps
    (``qk[perm], w[perm]``) it leaves the result unchanged."""
    kz, ky, kx = (int(k) for k in kernel_size)
    g, i = np.meshgrid(np.arange(ky * kx), np.arange(kz), indexing="ij")
    return (i * (ky * kx) + g).reshape(-1)


def gather_gemm_plain(features: torch.Tensor, gather_idx: torch.Tensor,
                      found: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_gemm`: a masked gather into
    ``[R, K*Cin]`` and one matmul."""
    return gathered_matmul(features, gather_idx, found.bool(), weights)


def keymatch_gemm_plain(features: torch.Tensor, in_keys: torch.Tensor,
                        q_keys: torch.Tensor, weights: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`keymatch_gemm`: a lookup of every
    query key (exact for ``in_keys`` in any order) and the same masked
    gather + matmul."""
    K, R = q_keys.shape[-2:]
    idx, hit = _merge_lookup(in_keys, q_keys.flatten(-2))
    return gathered_matmul(features, idx.unflatten(-1, (K, R)),
                           hit.unflatten(-1, (K, R)), weights)


def _check_common(features, table, weights, what: str):
    """Shapes shared by both wrappers; ``table`` is idx or q_keys."""
    if weights.dim() != 3:
        raise ValueError(f"weights {tuple(weights.shape)}: want "
                         f"[K, Cin, Cout]")
    if features.dim() not in (2, 3) or table.dim() != features.dim():
        raise ValueError(
            f"features {tuple(features.shape)} / {what} "
            f"{tuple(table.shape)}: want [N, Cin] / [K, R], or both with "
            f"one leading batch dimension")
    K, Cin, _ = weights.shape
    if (features.shape[-1] != Cin or table.shape[-2] != K
            or table.shape[:-2] != features.shape[:-2]):
        raise ValueError(
            f"features {tuple(features.shape)}, {what} "
            f"{tuple(table.shape)} and weights {tuple(weights.shape)} do "
            f"not fit together")


def _check_cuda(features, weights, others: dict):
    """What the kernels take: fp32 features and weights, the stated
    integer types, one device, no gradient, a supported width."""
    for name, (t, dtype) in others.items():
        if t.dtype != dtype:
            raise TypeError(f"kernel takes {dtype} {name}, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"features and {name} on different devices")
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 features and weights, got "
                        f"{features.dtype} / {weights.dtype}")
    if weights.device != features.device:
        raise ValueError("features and weights on different devices")
    if torch.is_grad_enabled() and (features.requires_grad
                                    or weights.requires_grad):
        raise NotImplementedError(
            "the sparse GEMM kernels have no backward yet: call them under "
            "torch.no_grad(), or on tensors that do not require grad")
    K, Cin, Cout = weights.shape
    if Cout not in KERNEL_COUTS:
        raise ValueError(f"kernel takes Cout in {KERNEL_COUTS}, got {Cout}")
    if Cin < 1 or K < 1:
        raise ValueError(f"weights {tuple(weights.shape)}: empty")


def _check_smem(K: int, Cin: int, Cout: int) -> None:
    fn = _build.function("sparse_gather_gemm", "sparse_gemm_smem_bytes",
                         (_I, _I, _I))
    if fn(K, Cin, Cout) > MAX_SMEM_BYTES:
        raise ValueError(f"K {K}, Cin {Cin}, Cout {Cout} need more shared "
                         f"memory than a block has ({MAX_SMEM_BYTES} bytes)")


def gather_gemm(features: torch.Tensor, gather_idx: torch.Tensor,
                found: torch.Tensor, weights: torch.Tensor,
                interpret=None, tile: int = 256, window: int = 768,
                shared: bool = True) -> torch.Tensor:
    """features [N, Cin] x rulebook ([K, R] idx + found) x weights
    [K, Cin, Cout] -> [R, Cout] float32:
    ``out[r] = sum_k found[k, r] * features[idx[k, r]] @ W[k]`` (no bias,
    no validity mask: the caller applies them).  An entry whose index lies
    outside ``[0, N)`` counts as not found.  With one leading batch
    dimension on features, idx and found: [B, R, Cout].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 features and weights, int32 idx, bool found, Cout in
    ``KERNEL_COUTS``) or raise.  ``interpret``, ``tile``, ``window`` and
    ``shared`` select among the TPU kernel's forms and are ignored.
    """
    _check_common(features, gather_idx, weights, "gather_idx")
    if found.shape != gather_idx.shape:
        raise ValueError(f"found {tuple(found.shape)} != gather_idx "
                         f"{tuple(gather_idx.shape)}")
    if not features.is_cuda:
        return gather_gemm_plain(features, gather_idx, found, weights)
    _check_cuda(features, weights, {"gather_idx": (gather_idx, torch.int32),
                                    "found": (found, torch.bool)})
    K, Cin, Cout = weights.shape
    _check_smem(K, Cin, Cout)
    batched = features.dim() == 3
    B = features.shape[0] if batched else 1
    N, R = features.shape[-2], gather_idx.shape[-1]
    features, gather_idx = features.contiguous(), gather_idx.contiguous()
    found, weights = found.contiguous(), weights.contiguous()
    out = torch.empty((B, R, Cout) if batched else (R, Cout),
                      dtype=torch.float32, device=features.device)
    fn = _build.function("sparse_gather_gemm", "gather_gemm_launch",
                         _GATHER_ARGTYPES)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), gather_idx.data_ptr(),
                 found.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 B, N, R, K, Cin, Cout, stream)
    _build.check(err, "gather_gemm_launch")
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0


def keymatch_gemm(features: torch.Tensor, in_keys: torch.Tensor,
                  q_keys: torch.Tensor, weights: torch.Tensor,
                  interpret=None, tile: int = 256, window: int = 768,
                  shared: bool = True, subwindow: int = 0,
                  group: int = 1) -> torch.Tensor:
    """features [N, Cin] x keys [N] x query keys [K, M] x weights
    [K, Cin, Cout] -> [M, Cout] float32:
    ``out[m] = sum_k (exists j: in_keys[j] == q_keys[k, m])
    * features[j] @ W[k]`` — a submanifold or strided sparse conv with
    the rulebook join inside the kernel.  Valid keys are unique;
    INT32_MAX marks a row with no key and a tap with no query, and never
    matches.  With one leading batch dimension on features, in_keys and
    q_keys: [B, M, Cout].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 features and weights, int32 keys, Cout in ``KERNEL_COUTS``)
    or raise.  The kernel searches ascending ``in_keys`` (what the
    key-order voxelizer and the sorted strided sites give) by bisection;
    a check on the device, with no host synchronisation, tells it when
    they are not ascending, and it then scans them, which is exact for any
    order and slow.  ``interpret``, ``tile``, ``window``, ``shared``,
    ``subwindow`` and ``group`` select among the TPU kernel's forms and are
    ignored, except that ``group`` must divide K as there.
    """
    _check_common(features, q_keys, weights, "q_keys")
    if in_keys.shape != features.shape[:-1]:
        raise ValueError(f"in_keys {tuple(in_keys.shape)}: want "
                         f"{tuple(features.shape[:-1])}")
    K, Cin, Cout = weights.shape
    if int(group) > 1 and K % int(group):
        raise ValueError(f"group={group} must divide K={K}")
    if not features.is_cuda:
        return keymatch_gemm_plain(features, in_keys, q_keys, weights)
    _check_cuda(features, weights, {"in_keys": (in_keys, torch.int32),
                                    "q_keys": (q_keys, torch.int32)})
    _check_smem(K, Cin, Cout)
    batched = features.dim() == 3
    B = features.shape[0] if batched else 1
    N, M = features.shape[-2], q_keys.shape[-1]
    features, in_keys = features.contiguous(), in_keys.contiguous()
    q_keys, weights = q_keys.contiguous(), weights.contiguous()
    ascending = (in_keys[..., 1:] >= in_keys[..., :-1]).all()   # on device
    out = torch.empty((B, M, Cout) if batched else (M, Cout),
                      dtype=torch.float32, device=features.device)
    fn = _build.function("sparse_gather_gemm", "keymatch_gemm_launch",
                         _KEYMATCH_ARGTYPES)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), in_keys.data_ptr(), q_keys.data_ptr(),
                 ascending.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 B, N, M, K, Cin, Cout, stream)
    _build.check(err, "keymatch_gemm_launch")
    keymatch_gemm.launches += 1
    return out


keymatch_gemm.launches = 0


def keymatch_found(in_keys: torch.Tensor, q_keys: torch.Tensor
                   ) -> torch.Tensor:
    """Which (tap, output row) pairs of a key-match join have a source
    row: bool, the shape of ``q_keys``."""
    return _merge_lookup(in_keys, q_keys.flatten(-2))[1].view(q_keys.shape)


def count_hits(in_keys: torch.Tensor, q_keys: torch.Tensor) -> int:
    """How many (tap, output row) pairs of a key-match join have a source
    row: the arithmetic the join needs is ``2 * hits * Cin * Cout``."""
    return int(keymatch_found(in_keys, q_keys).sum())


def tile_occupancy(found: torch.Tensor):
    """``found`` [..., K, R] (which rows have a source at which tap) ->
    (hits, non-empty (tile, tap) pairs, occupancy): the kernel multiplies
    the ``TILE_R`` rows of a tile for every tap that any of them finds,
    and the occupancy ``hits / (pairs * TILE_R)`` is the share of that
    work the data needs.  Tiles are ``TILE_R`` consecutive rows of one
    batch element, the last one ragged."""
    R = found.shape[-1]
    pad = torch.nn.functional.pad(found.to(torch.uint8), (0, -R % TILE_R))
    pairs = int(pad.unflatten(-1, (-1, TILE_R)).any(-1).sum())
    hits = int(found.sum())
    return hits, pairs, hits / (pairs * TILE_R) if pairs else 0.0


__all__ = ["KERNEL_COUTS", "TILE_R", "count_hits", "gather_gemm",
           "gather_gemm_plain", "group_perm", "keymatch_found",
           "keymatch_gemm", "keymatch_gemm_plain", "tile_occupancy"]
