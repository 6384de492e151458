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
is the launch grid's second axis).

Both are differentiable in features and weights, as the JAX package's
``custom_vjp`` makes them (``_gather_gemm_bwd`` :411, ``_keymatch_bwd``
:1237): with grad recorded they run as autograd Functions whose
backward takes the join's rulebook (key-match: through
``ops.sparse_conv._merge_lookup``, as the reference does) into
``csrc/sparse_join_grad.cu``: ``dfeatures`` as the forward gather-GEMM
kernel over the inverted rulebook (:func:`rulebook_inverse`, then
:func:`join_grad_features`) and ``dW`` by a per-tap reduction kernel
(:func:`join_grad_weights`), neither computed where it is not needed.
On the CPU the Functions run the plain forward and
:func:`join_backward_plain`, which mirrors the reference's backward line
for line.
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
# idx, found, inv, inv_found, collisions | B, K, R, N | stream
_INVERSE_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
# feats, idx, found, dout, partial, dW | B, N, R, K, Cin, Cout | stream
_TAP_GRAD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
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


def _launch_gather(features, gather_idx, found, weights) -> torch.Tensor:
    """The gather-GEMM kernel on checked CUDA tensors (no count)."""
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
    return out


def _gather_forward(features, gather_idx, found, weights) -> torch.Tensor:
    if not features.is_cuda:
        return gather_gemm_plain(features, gather_idx, found, weights)
    _check_cuda(features, weights, {"gather_idx": (gather_idx, torch.int32),
                                    "found": (found, torch.bool)})
    out = _launch_gather(features, gather_idx, found, weights)
    gather_gemm.launches += 1
    return out


def _keymatch_forward(features, in_keys, q_keys, weights) -> torch.Tensor:
    if not features.is_cuda:
        return keymatch_gemm_plain(features, in_keys, q_keys, weights)
    _check_cuda(features, weights, {"in_keys": (in_keys, torch.int32),
                                    "q_keys": (q_keys, torch.int32)})
    K, Cin, Cout = weights.shape
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


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _join_grads(ctx, features, idx, found, weights, dout):
    """(dfeatures or None, dW or None) of a join with rulebook (idx,
    found), each only where the Function's input needs it."""
    need_f, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
    dout = dout.contiguous().to(features.dtype)
    dfeats = (join_grad_features(dout, idx, found, weights,
                                 features.shape[-2]) if need_f else None)
    dW = join_grad_weights(features, idx, found, dout) if need_w else None
    return dfeats, dW


class _GatherGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, gather_idx, found, weights):
        ctx.save_for_backward(features, gather_idx, found, weights)
        return _gather_forward(features, gather_idx, found, weights)

    @staticmethod
    def backward(ctx, dout):
        features, idx, found, weights = ctx.saved_tensors
        dfeats, dW = _join_grads(ctx, features, idx, found, weights, dout)
        return dfeats, None, None, dW


class _KeymatchGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, in_keys, q_keys, weights):
        ctx.save_for_backward(features, in_keys, q_keys, weights)
        return _keymatch_forward(features, in_keys, q_keys, weights)

    @staticmethod
    def backward(ctx, dout):
        features, in_keys, q_keys, weights = ctx.saved_tensors
        K, R = q_keys.shape[-2:]
        idx, hit = _merge_lookup(in_keys, q_keys.flatten(-2))
        dfeats, dW = _join_grads(ctx, features,
                                 idx.unflatten(-1, (K, R)).contiguous(),
                                 hit.unflatten(-1, (K, R)).contiguous(),
                                 weights, dout)
        return dfeats, None, None, dW


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
    ``KERNEL_COUTS``) or raise.  Differentiable in features and weights
    (the module docstring).  ``interpret``, ``tile``, ``window`` and
    ``shared`` select among the TPU kernel's forms and are ignored.
    """
    _check_common(features, gather_idx, weights, "gather_idx")
    if found.shape != gather_idx.shape:
        raise ValueError(f"found {tuple(found.shape)} != gather_idx "
                         f"{tuple(gather_idx.shape)}")
    if _records_grad(features, weights):
        return _GatherGemm.apply(features, gather_idx, found, weights)
    return _gather_forward(features, gather_idx, found, weights)


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
    order and slow.  Differentiable in features and weights (the module
    docstring); a row with no key gets no gradient.  ``interpret``,
    ``tile``, ``window``, ``shared``, ``subwindow`` and ``group`` select
    among the TPU kernel's forms and are ignored, except that ``group``
    must divide K as there.
    """
    _check_common(features, q_keys, weights, "q_keys")
    if in_keys.shape != features.shape[:-1]:
        raise ValueError(f"in_keys {tuple(in_keys.shape)}: want "
                         f"{tuple(features.shape[:-1])}")
    K = weights.shape[0]
    if int(group) > 1 and K % int(group):
        raise ValueError(f"group={group} must divide K={K}")
    if _records_grad(features, weights):
        return _KeymatchGemm.apply(features, in_keys, q_keys, weights)
    return _keymatch_forward(features, in_keys, q_keys, weights)


keymatch_gemm.launches = 0


# ---- the backward ---------------------------------------------------------

def grad_features_plain(dout, gather_idx, found, weights, N: int):
    """dfeatures [..., N, Cin] of a join, as the reference's
    ``_gather_gemm_bwd`` computes it: ``dfeats[idx[k, r]] += found[k, r]
    * dout[r] @ W[k]^T`` (an einsum and a scatter-add), idx clipped to
    ``[0, N)``, in dout's type."""
    K, R = gather_idx.shape[-2:]
    lead = dout.shape[:-2]
    n_lead = int(np.prod(lead, dtype=np.int64))
    Cin = weights.shape[1]
    mask = found.to(dout.dtype)
    idx = gather_idx.long().clamp(0, N - 1)
    contrib = (torch.einsum("...ro,kio->...kri", dout, weights.to(dout.dtype))
               * mask[..., None])
    base = (torch.arange(n_lead, device=idx.device) * N).view(*lead, 1, 1)
    dfeats = torch.zeros((n_lead * N, Cin), dtype=dout.dtype,
                         device=dout.device)
    dfeats.index_add_(0, (idx + base).reshape(-1), contrib.reshape(-1, Cin))
    return dfeats.view(*lead, N, Cin)


def grad_weights_plain(features, gather_idx, found, dout):
    """dW [K, Cin, Cout] of a join, as the reference computes it: ``dW[k] =
    (found * feats[idx[k]])^T @ dout`` (a gather and an einsum, summed over
    the batch), idx clipped to ``[0, N)``, in the features' type."""
    N, Cin = features.shape[-2:]
    K, R = gather_idx.shape[-2:]
    lead = features.shape[:-2]
    idx = gather_idx.long().clamp(0, N - 1).flatten(-2)
    gathered = torch.gather(features, -2, idx[..., None].expand(
        *lead, K * R, Cin)).unflatten(-2, (K, R))
    gathered = gathered * found.to(features.dtype)[..., None]
    return torch.einsum("...kri,...ro->kio", gathered,
                        dout.to(features.dtype))


def join_backward_plain(features, gather_idx, found, weights, dout,
                        need_features: bool = True,
                        need_weights: bool = True):
    """Plain PyTorch backward of a join, line for line the reference's
    ``_gather_gemm_bwd``: features [..., N, Cin], idx / found [..., K, R],
    weights [K, Cin, Cout], dout [..., R, Cout] -> (dfeatures [..., N,
    Cin] or None, dW [K, Cin, Cout] or None), in the features' type.  A
    batch element's rows take its own features; dW sums over the batch."""
    dout = dout.to(features.dtype)
    dfeats = (grad_features_plain(dout, gather_idx, found, weights,
                                  features.shape[-2])
              if need_features else None)
    dW = (grad_weights_plain(features, gather_idx, found, dout)
          if need_weights else None)
    return dfeats, dW


def rulebook_inverse_plain(gather_idx: torch.Tensor, found: torch.Tensor,
                           N: int):
    """Plain PyTorch version of :func:`rulebook_inverse`: (inv [..., K, N]
    int32, -1 where no entry; inv_found bool).  Where two entries of a tap
    take one slot, one of them wins here; the kernel counts them."""
    R = gather_idx.shape[-1]
    idx = torch.where(found, gather_idx.long().clamp(0, N - 1), N)
    rows = torch.arange(R, dtype=torch.int32, device=idx.device)
    inv = torch.full((*idx.shape[:-1], N + 1), -1, dtype=torch.int32,
                     device=idx.device)
    inv.scatter_(-1, idx, rows.expand(idx.shape).contiguous())
    inv = inv[..., :N].contiguous()
    return inv, inv >= 0


_COLLISIONS: dict = {}


def rulebook_collisions(device) -> int:
    """How many rulebook entries the inverse kernel found in a slot another
    entry of their tap already held, summed over every call on ``device``
    so far (0 for a convolution's rulebooks).  Synchronises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _COLLISIONS.get(dev)
    return 0 if t is None else int(t)


def rulebook_inverse(gather_idx: torch.Tensor, found: torch.Tensor, N: int):
    """The inverse of a join's rulebook: idx / found [..., K, R] (int32,
    bool) -> (inv [..., K, N] int32, inv_found [..., K, N] bool) with
    ``inv[k, idx[k, r]] = r`` where ``found`` (idx clipped to ``[0, N)``).
    CUDA tensors launch ``rulebook_inverse_kernel``; CPU tensors take the
    plain version."""
    if not gather_idx.is_cuda:
        return rulebook_inverse_plain(gather_idx, found, N)
    if gather_idx.dtype != torch.int32 or found.dtype != torch.bool:
        raise TypeError(f"kernel takes int32 idx and bool found, got "
                        f"{gather_idx.dtype} / {found.dtype}")
    K, R = gather_idx.shape[-2:]
    B = int(np.prod(gather_idx.shape[:-2], dtype=np.int64))
    gather_idx, found = gather_idx.contiguous(), found.contiguous()
    dev = gather_idx.device
    inv = torch.empty((*gather_idx.shape[:-1], N), dtype=torch.int32,
                      device=dev)
    inv_found = torch.empty(inv.shape, dtype=torch.bool, device=dev)
    if dev not in _COLLISIONS:
        _COLLISIONS[dev] = torch.zeros((), dtype=torch.int32, device=dev)
    fn = _build.function("sparse_join_grad", "rulebook_inverse_launch",
                         _INVERSE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gather_idx.data_ptr(), found.data_ptr(), inv.data_ptr(),
                 inv_found.data_ptr(), _COLLISIONS[dev].data_ptr(), B, K, R,
                 N, stream)
    _build.check(err, "rulebook_inverse_launch")
    rulebook_inverse.launches += 1
    return inv, inv_found


rulebook_inverse.launches = 0


def join_grad_features(dout: torch.Tensor, gather_idx: torch.Tensor,
                       found: torch.Tensor, weights: torch.Tensor,
                       N: int) -> torch.Tensor:
    """dfeatures [..., N, Cin] of a join: dout [..., R, Cout], rulebook
    [..., K, R], weights [K, Cin, Cout].  CUDA tensors: the rulebook's
    inverse (:func:`rulebook_inverse`), then the gather-GEMM kernel on
    (dout, inverse, W[k]^T), which needs Cin in ``KERNEL_COUTS``; CPU
    tensors take :func:`join_backward_plain`."""
    if not dout.is_cuda:
        return grad_features_plain(dout, gather_idx, found, weights, N)
    _check_cuda(dout, weights, {"gather_idx": (gather_idx, torch.int32),
                                "found": (found, torch.bool)})
    Cin = weights.shape[1]
    if Cin not in KERNEL_COUTS:
        raise ValueError(f"the features' gradient takes Cin in "
                         f"{KERNEL_COUTS}, got {Cin}")
    inv, inv_found = rulebook_inverse(gather_idx, found, N)
    wt = weights.transpose(1, 2).contiguous()        # [K, Cout, Cin]
    out = _launch_gather(dout, inv, inv_found, wt)
    join_grad_features.launches += 1
    return out


join_grad_features.launches = 0


def join_grad_weights(features: torch.Tensor, gather_idx: torch.Tensor,
                      found: torch.Tensor, dout: torch.Tensor
                      ) -> torch.Tensor:
    """dW [K, Cin, Cout] of a join: features [..., N, Cin], rulebook [...,
    K, R], dout [..., R, Cout].  CUDA tensors launch the per-tap reduction
    kernels (partials, then their sum in a fixed order); CPU tensors take
    :func:`join_backward_plain`."""
    if not features.is_cuda:
        return grad_weights_plain(features, gather_idx, found, dout)
    for name, (t, dtype) in {"features": (features, torch.float32),
                             "dout": (dout, torch.float32),
                             "gather_idx": (gather_idx, torch.int32),
                             "found": (found, torch.bool)}.items():
        if t.dtype != dtype:
            raise TypeError(f"kernel takes {dtype} {name}, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"features and {name} on different devices")
    K = gather_idx.shape[-2]
    N, Cin = features.shape[-2:]
    R, Cout = dout.shape[-2:]
    if max(Cin, Cout) > 128:
        raise ValueError(f"the weights' gradient takes Cin and Cout up to "
                         f"128, got {Cin} and {Cout}")
    B = int(np.prod(features.shape[:-2], dtype=np.int64))
    features, dout = features.contiguous(), dout.contiguous()
    gather_idx, found = gather_idx.contiguous(), found.contiguous()
    parts = _build.function("sparse_join_grad", "tap_grad_parts",
                            (_I, _I, _I))(B, R, K)
    dev = features.device
    partial = torch.empty((K, parts, Cin, Cout), dtype=torch.float32,
                          device=dev)
    dW = torch.empty((K, Cin, Cout), dtype=torch.float32, device=dev)
    fn = _build.function("sparse_join_grad", "tap_grad_launch",
                         _TAP_GRAD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), gather_idx.data_ptr(), found.data_ptr(),
                 dout.data_ptr(), partial.data_ptr(), dW.data_ptr(), B, N, R,
                 K, Cin, Cout, stream)
    _build.check(err, "tap_grad_launch")
    join_grad_weights.launches += 1
    return dW


join_grad_weights.launches = 0


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
           "gather_gemm_plain", "grad_features_plain", "grad_weights_plain",
           "group_perm", "join_backward_plain",
           "join_grad_features", "join_grad_weights", "keymatch_found",
           "keymatch_gemm", "keymatch_gemm_plain", "rulebook_collisions",
           "rulebook_inverse", "rulebook_inverse_plain", "tile_occupancy"]
