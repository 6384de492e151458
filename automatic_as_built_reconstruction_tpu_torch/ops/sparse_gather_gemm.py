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

Each forward is an operator of ``ops/library.py`` (``abr::gather_gemm``,
``abr::keymatch_gemm``), dispatched by device: the kernel on the card
(:func:`_gather_cuda`, :func:`_keymatch_cuda`), the plain version on the
CPU.

Both take an optional leading batch dimension on everything but the
weights (the JAX package maps the kernel over the batch; here the batch
is the launch grid's second axis).

Both joins also take bfloat16 features and weights (the middle of
``compute_dtype="bfloat16"``: ``car.fhd.mixed``'s gather joins, the
key-match joins of ``car.fhd`` and ``car.fhd.serving`` with
``enable_mixed_precision``): a second tile, designed for Hopper, with
either lookup: 128 output rows a block and two warpgroups, a ring of
three stages on mbarriers into which ``W[k]`` comes by the tensor memory
accelerator and each warpgroup copies its own rows with ``cp.async``,
two taps ahead of the products, which run on ``wgmma`` (bf16 x bf16 ->
float32, each tap's partial added to the sums in tap order; a product of
two bfloat16 values is exact in float32); it gives float32
(:func:`bf16_tile` reports its rows, stages, shared memory and blocks an
SM at a shape), and its launches count on :func:`gather_gemm_bf16` and
:func:`keymatch_gemm_bf16`.  The plain
versions, :func:`gather_gemm_plain` and :func:`keymatch_gemm_plain`,
multiply the bfloat16 inputs upcast to float32.  The backward kernels
take float32 only and raise on anything else.

Both are differentiable in features and weights, as the JAX package's
``custom_vjp`` makes them (``_gather_gemm_bwd`` :411, ``_keymatch_bwd``
:1237): with grad recorded they run as autograd Functions whose
backward takes the join's rulebook (key-match: :func:`keymatch_rulebook`,
a hash table lookup of the join's keys, where the reference runs
``ops.sparse_conv._merge_lookup``) into
``csrc/sparse_join_grad.cu``: ``dW`` as the hits of each tap
(:func:`rulebook_hits`), then a reduction GEMM per tap on the tensor
cores (:func:`join_grad_weights`); ``dfeatures`` as the rulebook's inverse
(:func:`rulebook_inverse`), then a kernel that multiplies only the rows
each tap hits by ``W[k]^T`` (:func:`join_grad_features`); neither half
computed where it is not needed.  Each step has a plain version here
(:func:`rulebook_hits_plain`, :func:`grad_weights_from_hits_plain`,
:func:`rulebook_inverse_plain`, :func:`grad_features_from_inverse_plain`)
that the tests hold against the plain backward.
On the CPU the Functions run the plain forward and
:func:`join_backward_plain`, which mirrors the reference's backward line
for line.  As there, a bfloat16 join's backward runs in float32 (``dout``,
the features and the weights upcast) and casts ``dfeatures`` and ``dW``
back to their inputs' types.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, library
from .sparse_conv import _merge_lookup, gathered_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
# feats, idx, found, W, out | B, N, R, K, Cin, Cout | stream
_GATHER_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# feats, in_keys, q_keys, sorted_flag, W, out | B, N, R, K, Cin, Cout | stream
_KEYMATCH_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# in_keys, q_keys, table_keys, table_rows, idx, found | B, N, R, K | stream
_RULEBOOK_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
# idx, found, inv, collisions | B, K, R, N | stream
_INVERSE_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _P)
# idx, found, chunk_counts, hits, counts | B, K, R, N | stream
_HITS_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
# feats, dout, hits, counts, partial, dW | B, N, R, K, Cin, Cout | stream
_TAP_GRAD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# dout, inv, W, dfeats | B, N, R, K, Cin, Cout | stream
_GRAD_F_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
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


def _check_cuda(features, weights, others: dict,
                dtypes=(torch.float32,)):
    """What the kernels take: features and weights of one type among
    ``dtypes`` (float32; the gather join also bfloat16), the stated
    integer types, one device, no gradient, a supported width."""
    for name, (t, dtype) in others.items():
        if t.dtype != dtype:
            raise TypeError(f"kernel takes {dtype} {name}, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"features and {name} on different devices")
    if features.dtype not in dtypes or weights.dtype != features.dtype:
        raise TypeError(f"kernel takes features and weights both of one "
                        f"type in {[str(d) for d in dtypes]}, got "
                        f"{features.dtype} / {weights.dtype}")
    if weights.device != features.device:
        raise ValueError("features and weights on different devices")
    K, Cin, Cout = weights.shape
    if Cout not in KERNEL_COUTS:
        raise ValueError(f"kernel takes Cout in {KERNEL_COUTS}, got {Cout}")
    if Cin < 1 or K < 1:
        raise ValueError(f"weights {tuple(weights.shape)}: empty")


def bf16_tile(K: int, Cin: int, Cout: int) -> dict:
    """The bfloat16 tile at a join's shape: {"rows": output rows a block,
    "stages": the depth of its ring, "smem_bytes": its shared memory,
    "blocks_per_sm": how many of its blocks fit an SM at once} (builds the
    library; needs a GPU for the last; no launch)."""
    fn = _build.function("sparse_gather_gemm", "sparse_gemm_bf16_tile",
                         (_I, _I, _I, _P))
    out = (ctypes.c_int * 4)()
    _build.check(fn(K, Cin, Cout, ctypes.addressof(out)),
                 "sparse_gemm_bf16_tile")
    return {"rows": out[0], "stages": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3]}


def _check_smem(K: int, Cin: int, Cout: int,
                symbol: str = "sparse_gemm_smem_bytes") -> None:
    fn = _build.function("sparse_gather_gemm", symbol, (_I, _I, _I))
    if fn(K, Cin, Cout) > MAX_SMEM_BYTES:
        raise ValueError(f"K {K}, Cin {Cin}, Cout {Cout} need more shared "
                         f"memory than a block has ({MAX_SMEM_BYTES} bytes)")


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` contiguous at an ``nbytes``-aligned address (the bf16 tile's
    narrowest ``cp.async`` of the features copies 4 bytes; its weights
    come by the tensor memory accelerator, which wants 16)."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _kernel_operands(features, weights):
    """(features, weights) as the tile takes them, its shared memory
    checked: the float32 tile, or for bfloat16 the tile's bfloat16 form
    (an even Cin, 4-byte aligned features, 16-byte aligned weights)."""
    K, Cin, Cout = weights.shape
    if features.dtype != torch.bfloat16:
        _check_smem(K, Cin, Cout)
        return features, weights
    if Cin % 2:
        raise ValueError(f"the bfloat16 kernel takes an even Cin, got {Cin}")
    _check_smem(K, Cin, Cout, "sparse_gemm_bf16_smem_bytes")
    return _aligned(features, 4), _aligned(weights, 16)


def _launch_gather(features, gather_idx, found, weights) -> torch.Tensor:
    """The gather-GEMM kernel on checked CUDA tensors (no count): the
    float32 tile, or its bfloat16 form for bfloat16 features and
    weights."""
    K, Cin, Cout = weights.shape
    bf16 = features.dtype == torch.bfloat16
    features, weights = _kernel_operands(features, weights)
    batched = features.dim() == 3
    B = features.shape[0] if batched else 1
    N, R = features.shape[-2], gather_idx.shape[-1]
    features, gather_idx = features.contiguous(), gather_idx.contiguous()
    found, weights = found.contiguous(), weights.contiguous()
    out = torch.empty((B, R, Cout) if batched else (R, Cout),
                      dtype=torch.float32, device=features.device)
    fn = _build.function("sparse_gather_gemm",
                         "gather_gemm_bf16_launch" if bf16
                         else "gather_gemm_launch", _GATHER_ARGTYPES)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), gather_idx.data_ptr(),
                 found.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 B, N, R, K, Cin, Cout, stream)
    _build.check(err, "gather_gemm_launch")
    return out


def _gather_cuda(features, gather_idx, found, weights) -> torch.Tensor:
    """The CUDA body of the ``abr::gather_gemm`` op (``ops/library.py``):
    checks, the launch, its count on the float32 or bfloat16 counter."""
    _check_cuda(features, weights, {"gather_idx": (gather_idx, torch.int32),
                                    "found": (found, torch.bool)},
                (torch.float32, torch.bfloat16))
    out = _launch_gather(features, gather_idx, found, weights)
    if features.dtype == torch.bfloat16:
        gather_gemm_bf16.launches += 1
    else:
        gather_gemm.launches += 1
    return out


def _keymatch_cuda(features, in_keys, q_keys, weights) -> torch.Tensor:
    """The CUDA body of the ``abr::keymatch_gemm`` op
    (``ops/library.py``): checks, the launch, its count on the float32 or
    bfloat16 counter."""
    _check_cuda(features, weights, {"in_keys": (in_keys, torch.int32),
                                    "q_keys": (q_keys, torch.int32)},
                (torch.float32, torch.bfloat16))
    K, Cin, Cout = weights.shape
    bf16 = features.dtype == torch.bfloat16
    features, weights = _kernel_operands(features, weights)
    batched = features.dim() == 3
    B = features.shape[0] if batched else 1
    N, M = features.shape[-2], q_keys.shape[-1]
    features, in_keys = features.contiguous(), in_keys.contiguous()
    q_keys, weights = q_keys.contiguous(), weights.contiguous()
    ascending = _ascending(in_keys)
    out = torch.empty((B, M, Cout) if batched else (M, Cout),
                      dtype=torch.float32, device=features.device)
    symbol = "keymatch_gemm_bf16_launch" if bf16 else "keymatch_gemm_launch"
    fn = _build.function("sparse_gather_gemm", symbol, _KEYMATCH_ARGTYPES)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), in_keys.data_ptr(), q_keys.data_ptr(),
                 ascending.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 B, N, M, K, Cin, Cout, stream)
    _build.check(err, symbol)
    if bf16:
        keymatch_gemm_bf16.launches += 1
    else:
        keymatch_gemm.launches += 1
    return out


def _ascending(in_keys: torch.Tensor) -> torch.Tensor:
    """Whether every scan's keys ascend, as a one-byte flag on the device
    (no host synchronisation): the kernels' key lookup searches them if
    so, and scans them otherwise."""
    return (in_keys[..., 1:] >= in_keys[..., :-1]).all()


def keymatch_rulebook_plain(in_keys: torch.Tensor, q_keys: torch.Tensor):
    """Plain PyTorch version of :func:`keymatch_rulebook`:
    ``ops.sparse_conv._merge_lookup`` (a sort and a search), as the
    reference's ``_keymatch_bwd`` runs it."""
    K, R = q_keys.shape[-2:]
    idx, hit = _merge_lookup(in_keys, q_keys.flatten(-2))
    return (idx.unflatten(-1, (K, R)).contiguous(),
            hit.unflatten(-1, (K, R)).contiguous())


def keymatch_rulebook(in_keys: torch.Tensor, q_keys: torch.Tensor):
    """The rulebook of a key-match join, what its backward joins on:
    in_keys [..., N], q_keys [..., K, R] (int32) -> (idx [..., K, R]
    int32, found bool); ``idx`` is the row of ``in_keys`` that holds the
    query key, and means something only where ``found``.  CUDA tensors
    launch ``keymatch_rulebook_kernel`` (a lookup of every query key in a
    hash table of the keys that ``keymatch_table_kernel`` builds, in any
    order of the keys; idx 0 where not found); CPU tensors take the plain
    version."""
    if not in_keys.is_cuda:
        return keymatch_rulebook_plain(in_keys, q_keys)
    if in_keys.dtype != torch.int32 or q_keys.dtype != torch.int32:
        raise TypeError(f"kernel takes int32 keys, got {in_keys.dtype} / "
                        f"{q_keys.dtype}")
    if q_keys.device != in_keys.device:
        raise ValueError("in_keys and q_keys on different devices")
    K, R = q_keys.shape[-2:]
    N = in_keys.shape[-1]
    B = int(np.prod(in_keys.shape[:-1], dtype=np.int64))
    in_keys, q_keys = in_keys.contiguous(), q_keys.contiguous()
    dev = q_keys.device
    idx = torch.empty(q_keys.shape, dtype=torch.int32, device=dev)
    found = torch.empty(q_keys.shape, dtype=torch.bool, device=dev)
    bits = _build.function("sparse_gather_gemm", "keymatch_table_bits",
                           (_I,))(N)
    table = torch.empty((2, B, 1 << bits), dtype=torch.int32, device=dev)
    fn = _build.function("sparse_gather_gemm", "keymatch_rulebook_launch",
                         _RULEBOOK_ARGTYPES)
    with torch.cuda.device(in_keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(in_keys.data_ptr(), q_keys.data_ptr(), table[0].data_ptr(),
                 table[1].data_ptr(), idx.data_ptr(), found.data_ptr(), B, N,
                 R, K, stream)
    _build.check(err, "keymatch_rulebook_launch")
    keymatch_rulebook.launches += 1
    return idx, found


keymatch_rulebook.launches = 0


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _join_grads(ctx, features, idx, found, weights, dout):
    """(dfeatures or None, dW or None) of a join with rulebook (idx,
    found), each only where the Function's input needs it.  A bfloat16
    join's backward runs in float32, as the reference's does: ``dout``,
    the features and the weights upcast (never ``dout`` rounded to
    bfloat16), the results cast back to the inputs' types."""
    need_f, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
    ct = torch.promote_types(features.dtype, torch.float32)
    dout = dout.contiguous().to(ct)
    dfeats = (join_grad_features(dout, idx, found, weights.to(ct),
                                 features.shape[-2]).to(features.dtype)
              if need_f else None)
    dW = (join_grad_weights(features.to(ct), idx, found,
                            dout).to(weights.dtype) if need_w else None)
    return dfeats, dW


class _GatherGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, gather_idx, found, weights):
        ctx.save_for_backward(features, gather_idx, found, weights)
        return library.gather_gemm(features, gather_idx, found, weights)

    @staticmethod
    def backward(ctx, dout):
        features, idx, found, weights = ctx.saved_tensors
        dfeats, dW = _join_grads(ctx, features, idx, found, weights, dout)
        return dfeats, None, None, dW


class _KeymatchGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, in_keys, q_keys, weights):
        ctx.save_for_backward(features, in_keys, q_keys, weights)
        return library.keymatch_gemm(features, in_keys, q_keys, weights)

    @staticmethod
    def backward(ctx, dout):
        features, in_keys, q_keys, weights = ctx.saved_tensors
        idx, hit = keymatch_rulebook(in_keys, q_keys)
        dfeats, dW = _join_grads(ctx, features, idx, hit, weights, dout)
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

    Runs the ``abr::gather_gemm`` op: on CPU tensors the plain version,
    on CUDA tensors the kernel (features and weights both float32, or
    both bfloat16 with an even Cin, which the tile's bfloat16 form
    takes; int32 idx, bool found,
    Cout in ``KERNEL_COUTS``) or raise.  The output is float32 either
    way.  Differentiable in features and weights (the module docstring).
    ``interpret``, ``tile``, ``window`` and ``shared`` select among the
    TPU kernel's forms and are ignored.
    """
    _check_common(features, gather_idx, weights, "gather_idx")
    if found.shape != gather_idx.shape:
        raise ValueError(f"found {tuple(found.shape)} != gather_idx "
                         f"{tuple(gather_idx.shape)}")
    if _records_grad(features, weights):
        return _GatherGemm.apply(features, gather_idx, found, weights)
    return library.gather_gemm(features, gather_idx, found, weights)


gather_gemm.launches = 0


def gather_gemm_bf16(features: torch.Tensor, gather_idx: torch.Tensor,
                     found: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """:func:`gather_gemm` on bfloat16 features and weights (raises on any
    other type): the form ``car.fhd.mixed`` runs.  Its ``launches``
    count every launch of the tile's bfloat16 form, through either
    name."""
    if features.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"gather_gemm_bf16 takes bfloat16 features and "
                        f"weights, got {features.dtype} / {weights.dtype}")
    return gather_gemm(features, gather_idx, found, weights)


gather_gemm_bf16.launches = 0


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

    Runs the ``abr::keymatch_gemm`` op: on CPU tensors the plain
    version, on CUDA tensors the kernel (features and weights both
    float32, or both bfloat16 with an even Cin, which the tile's bfloat16
    form takes; int32 keys, Cout in
    ``KERNEL_COUTS``) or raise.  The output is float32 either way.  The
    kernel searches ascending ``in_keys`` (what the
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
    return library.keymatch_gemm(features, in_keys, q_keys, weights)


keymatch_gemm.launches = 0


def keymatch_gemm_bf16(features: torch.Tensor, in_keys: torch.Tensor,
                       q_keys: torch.Tensor, weights: torch.Tensor,
                       *args) -> torch.Tensor:
    """:func:`keymatch_gemm` on bfloat16 features and weights (raises on
    any other type): the form the key-match middle runs under
    ``enable_mixed_precision``.  Its ``launches`` count every launch of
    the tile's bfloat16 form with the key lookup, through either name."""
    if features.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"keymatch_gemm_bf16 takes bfloat16 features and "
                        f"weights, got {features.dtype} / {weights.dtype}")
    return keymatch_gemm(features, in_keys, q_keys, weights, *args)


keymatch_gemm_bf16.launches = 0


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


def rulebook_hits_plain(gather_idx: torch.Tensor, found: torch.Tensor,
                        N: int):
    """Plain PyTorch version of :func:`rulebook_hits`: the row-ordered
    ``nonzero`` of each tap's ``found``.  -> (hits [K, B * R, 2] int32,
    counts [K] int32): the hits of tap k at ``hits[k, :counts[k]]``, each
    (feature row ``b * N + j``, dout row ``b * R + r``) with j the entry
    clipped to ``[0, N)``, in ascending dout row; -1 past them."""
    K, R = gather_idx.shape[-2:]
    idx = gather_idx.reshape(-1, K, R).transpose(0, 1).long()   # [K, B, R]
    hit = found.reshape(-1, K, R).transpose(0, 1)
    B = idx.shape[1]
    hits = torch.full((K, B * R, 2), -1, dtype=torch.int32,
                      device=idx.device)
    counts = torch.zeros(K, dtype=torch.int32, device=idx.device)
    for k in range(K):
        b, r = hit[k].nonzero(as_tuple=True)      # row order: b, then r
        n = b.numel()
        hits[k, :n, 0] = (b * N + idx[k, b, r].clamp(0, N - 1)).int()
        hits[k, :n, 1] = (b * R + r).int()
        counts[k] = n
    return hits, counts


def rulebook_hits(gather_idx: torch.Tensor, found: torch.Tensor, N: int):
    """The hits of each tap of a join's rulebook: idx / found [..., K, R]
    (int32, bool) -> (hits [K, B * R, 2] int32, counts [K] int32) as
    :func:`rulebook_hits_plain` gives them (past ``counts[k]`` a tap's
    rows are left as they were).  CUDA tensors launch the compaction of
    ``csrc/sparse_join_grad.cu`` (a count kernel and a write kernel; the
    counts stay on the device); CPU tensors take the plain version."""
    if not gather_idx.is_cuda:
        return rulebook_hits_plain(gather_idx, found, N)
    if gather_idx.dtype != torch.int32 or found.dtype != torch.bool:
        raise TypeError(f"kernel takes int32 idx and bool found, got "
                        f"{gather_idx.dtype} / {found.dtype}")
    K, R = gather_idx.shape[-2:]
    B = int(np.prod(gather_idx.shape[:-2], dtype=np.int64))
    if max(B * R, B * N) >= 2 ** 31:
        raise ValueError(f"B * R = {B * R} and B * N = {B * N} must stay "
                         f"below 2^31")
    gather_idx, found = gather_idx.contiguous(), found.contiguous()
    dev = gather_idx.device
    chunks = _build.function("sparse_join_grad", "tap_hits_chunks",
                             (_I, _I))(B, R)
    chunk_counts = torch.empty((K, chunks), dtype=torch.int32, device=dev)
    hits = torch.empty((K, B * R, 2), dtype=torch.int32, device=dev)
    counts = torch.empty(K, dtype=torch.int32, device=dev)
    fn = _build.function("sparse_join_grad", "tap_hits_launch",
                         _HITS_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gather_idx.data_ptr(), found.data_ptr(),
                 chunk_counts.data_ptr(), hits.data_ptr(), counts.data_ptr(),
                 B, K, R, N, stream)
    _build.check(err, "tap_hits_launch")
    rulebook_hits.launches += 1
    return hits, counts


rulebook_hits.launches = 0


def grad_weights_from_hits_plain(features, dout, hits, counts):
    """Plain PyTorch version of the dW kernel's step: ``dW[k] = A^T D``
    over the hits of tap k (:func:`rulebook_hits`), A the feature rows and
    D the dout rows they name (features [..., N, Cin], dout [..., R,
    Cout] with their batch rows flattened)."""
    Cin, Cout = features.shape[-1], dout.shape[-1]
    rows_f = features.reshape(-1, Cin)
    rows_d = dout.reshape(-1, Cout).to(features.dtype)
    dW = torch.zeros((hits.shape[0], Cin, Cout), dtype=features.dtype,
                     device=features.device)
    for k in range(hits.shape[0]):
        pairs = hits[k, :int(counts[k])].long()
        dW[k] = rows_f[pairs[:, 0]].T @ rows_d[pairs[:, 1]]
    return dW


def rulebook_inverse_plain(gather_idx: torch.Tensor, found: torch.Tensor,
                           N: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`rulebook_inverse`: inv [..., K, N]
    int32, -1 where no entry.  Where two entries of a tap take one slot,
    one of them wins here; the kernel counts them."""
    R = gather_idx.shape[-1]
    idx = torch.where(found, gather_idx.long().clamp(0, N - 1), N)
    rows = torch.arange(R, dtype=torch.int32, device=idx.device)
    inv = torch.full((*idx.shape[:-1], N + 1), -1, dtype=torch.int32,
                     device=idx.device)
    inv.scatter_(-1, idx, rows.expand(idx.shape).contiguous())
    return inv[..., :N].contiguous()


def grad_features_from_inverse_plain(dout, inv, weights):
    """Plain PyTorch version of the dfeatures kernel: dout [..., R, Cout],
    the rulebook's inverse inv [..., K, N] (-1: no source), weights [K,
    Cin, Cout] -> [..., N, Cin], each input row's sum of ``dout[inv[k, j]]
    @ W[k]^T`` over the taps that hit it, in ascending tap order."""
    K, N = inv.shape[-2:]
    lead = dout.shape[:-2]
    dfeats = torch.zeros((*lead, N, weights.shape[1]), dtype=dout.dtype,
                         device=dout.device)
    w = weights.to(dout.dtype)
    for k in range(K):
        src = inv[..., k, :].long()
        rows = torch.gather(dout, -2, src.clamp(min=0)[..., None].expand(
            *src.shape, dout.shape[-1]))
        dfeats += torch.where(src[..., None] >= 0, rows @ w[k].T, 0.0)
    return dfeats


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


def rulebook_inverse(gather_idx: torch.Tensor, found: torch.Tensor,
                     N: int) -> torch.Tensor:
    """The inverse of a join's rulebook: idx / found [..., K, R] (int32,
    bool) -> inv [..., K, N] int32 with ``inv[k, idx[k, r]] = r`` where
    ``found`` (idx clipped to ``[0, N)``), -1 elsewhere.  CUDA tensors
    launch ``rulebook_inverse_kernel``, which counts the entries that find
    their slot taken (:func:`rulebook_collisions`); CPU tensors take the
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
    if dev not in _COLLISIONS:
        _COLLISIONS[dev] = torch.zeros((), dtype=torch.int32, device=dev)
    fn = _build.function("sparse_join_grad", "rulebook_inverse_launch",
                         _INVERSE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gather_idx.data_ptr(), found.data_ptr(), inv.data_ptr(),
                 _COLLISIONS[dev].data_ptr(), B, K, R, N, stream)
    _build.check(err, "rulebook_inverse_launch")
    rulebook_inverse.launches += 1
    return inv


rulebook_inverse.launches = 0


def join_grad_features(dout: torch.Tensor, gather_idx: torch.Tensor,
                       found: torch.Tensor, weights: torch.Tensor,
                       N: int) -> torch.Tensor:
    """dfeatures [..., N, Cin] of a join: dout [..., R, Cout], rulebook
    [..., K, R], weights [K, Cin, Cout].  CUDA tensors: the rulebook's
    inverse (``rulebook_inverse_kernel``), then ``grad_features_kernel``
    over the rows each tap hits, which needs Cin in ``KERNEL_COUTS``; CPU
    tensors take :func:`grad_features_plain`."""
    if not dout.is_cuda:
        return grad_features_plain(dout, gather_idx, found, weights, N)
    _check_cuda(dout, weights, {"gather_idx": (gather_idx, torch.int32),
                                "found": (found, torch.bool)})
    K, Cin, Cout = weights.shape
    if Cin not in KERNEL_COUTS:
        raise ValueError(f"the features' gradient takes Cin in "
                         f"{KERNEL_COUTS}, got {Cin}")
    smem = _build.function("sparse_join_grad", "grad_features_smem_bytes",
                           (_I, _I, _I))(K, Cin, Cout)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K {K}, Cin {Cin}, Cout {Cout}: the features' "
                         f"gradient needs more shared memory than a block "
                         f"has ({smem} > {MAX_SMEM_BYTES} bytes)")
    R = gather_idx.shape[-1]
    B = int(np.prod(gather_idx.shape[:-2], dtype=np.int64))
    inv = rulebook_inverse(gather_idx, found, N)
    dout, weights = dout.contiguous(), weights.contiguous()
    out = torch.empty((*dout.shape[:-2], N, Cin), dtype=torch.float32,
                      device=dout.device)
    fn = _build.function("sparse_join_grad", "grad_features_launch",
                         _GRAD_F_ARGTYPES)
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dout.data_ptr(), inv.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), B, N, R, K, Cin, Cout, stream)
    _build.check(err, "grad_features_launch")
    join_grad_features.launches += 1
    return out


join_grad_features.launches = 0


def join_grad_weights(features: torch.Tensor, gather_idx: torch.Tensor,
                      found: torch.Tensor, dout: torch.Tensor
                      ) -> torch.Tensor:
    """dW [K, Cin, Cout] of a join: features [..., N, Cin], rulebook [...,
    K, R], dout [..., R, Cout].  CUDA tensors: the hits of each tap
    (:func:`rulebook_hits`), then the per-tap reduction GEMM (partials on
    the tensor cores, then their sum in a fixed order); CPU tensors take
    :func:`grad_weights_plain`."""
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
    hits, counts = rulebook_hits(gather_idx, found, N)
    parts = _build.function("sparse_join_grad", "tap_grad_parts",
                            (_I, _I, _I, _I, _I))(B, R, K, Cin, Cout)
    dev = features.device
    partial = torch.empty((K, parts, Cin, Cout), dtype=torch.float32,
                          device=dev)
    dW = torch.empty((K, Cin, Cout), dtype=torch.float32, device=dev)
    fn = _build.function("sparse_join_grad", "tap_grad_launch",
                         _TAP_GRAD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), dout.data_ptr(), hits.data_ptr(),
                 counts.data_ptr(), partial.data_ptr(), dW.data_ptr(), B, N,
                 R, K, Cin, Cout, stream)
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
           "gather_gemm_bf16", "gather_gemm_plain",
           "grad_features_from_inverse_plain", "grad_features_plain",
           "grad_weights_from_hits_plain", "grad_weights_plain",
           "group_perm", "join_backward_plain",
           "join_grad_features", "join_grad_weights", "keymatch_found",
           "keymatch_gemm", "keymatch_gemm_bf16", "keymatch_gemm_plain",
           "keymatch_rulebook", "keymatch_rulebook_plain",
           "rulebook_collisions", "rulebook_hits", "rulebook_hits_plain",
           "rulebook_inverse", "rulebook_inverse_plain", "tile_occupancy"]
