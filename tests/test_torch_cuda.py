"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip where there is no GPU.  On a machine
with one (and no JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from automatic_as_built_reconstruction_tpu_torch.ops import (
    pillar_scatter, rotated_iou, sparse_conv, sparse_gather_gemm as sgg)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("C", [64, 32])     # the pillar configs' widths
def test_pillar_scatter_kernel_equals_plain(cuda, C):
    g = torch.Generator().manual_seed(C)
    B, V, hw = 2, 3000, 80 * 80
    feats = torch.randn(B, V, C, generator=g)
    lin = torch.full((B, V), hw, dtype=torch.int32)
    for b, n in enumerate((3000, 1234)):
        lin[b, :n] = torch.randperm(hw, generator=g)[:n].sort().values
    feats, lin = feats.to(cuda), lin.to(cuda)
    before = pillar_scatter.scatter_sorted_to_canvas.launches
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    torch.cuda.synchronize()
    assert pillar_scatter.scatter_sorted_to_canvas.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_kernel_equals_plain(cuda, criterion):
    g = torch.Generator().manual_seed(3)
    R, N, K = 3, 70, 45
    def boxes(n):
        b = torch.cat([torch.rand(R, n, 2, generator=g) * 8,
                       0.5 + torch.rand(R, n, 2, generator=g) * 2.5,
                       (torch.rand(R, n, 1, generator=g) - 0.5) * 2 * math.pi],
                      -1)
        b[:, 1] = b[:, 0]
        b[:, 2] = torch.tensor([0.3, 0.3, 0.05, 2.5, math.pi / 2])
        return b
    a, q = boxes(N).to(cuda), boxes(K).to(cuda)
    before = rotated_iou.rotate_iou_matrix.launches
    got = rotated_iou.rotate_iou_matrix(a, q, criterion)
    ref = rotated_iou.rotate_iou_matrix_plain(a, q, criterion)
    torch.cuda.synchronize()
    assert rotated_iou.rotate_iou_matrix.launches == before + 1
    assert got.shape == (R, N, K)
    assert float((got - ref).abs().max()) <= 1e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    feats = torch.zeros(1, 4, 8, dtype=torch.float64, device=cuda)
    lin = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pillar_scatter.scatter_sorted_to_canvas(feats, lin, 16)
    with pytest.raises(ValueError):     # C % 4 != 0
        pillar_scatter.scatter_sorted_to_canvas(
            torch.zeros(1, 4, 30, device=cuda), lin, 16)
    with pytest.raises(ValueError):     # not 16-byte aligned
        pillar_scatter.scatter_sorted_to_canvas(
            torch.zeros(1, 4 * 8 + 1, device=cuda)[:, 1:].view(1, 4, 8),
            lin, 16)
    with pytest.raises(TypeError):
        rotated_iou.rotate_iou_matrix(
            torch.zeros(1, 4, 5, dtype=torch.float64, device=cuda),
            torch.zeros(1, 4, 5, dtype=torch.float64, device=cuda))


def _sparse_join(device, K, cin, cout, sort_keys=True, B=2, n=700, pad=68):
    """Random sites in a 12 x 40 x 40 grid -> (feats [B,N,cin], coords,
    valid, in_keys, q_keys [B,K,N], weights), on ``device``."""
    g = torch.Generator().manual_seed(K * 1000 + cin * 10 + cout)
    grid = (12, 40, 40)
    kernel = (3, 3, 3) if K == 27 else (3, 1, 1)
    coords = torch.full((B, n + pad, 3), -1, dtype=torch.int32)
    for b in range(B):
        lin = torch.randperm(12 * 40 * 40, generator=g)[:n]
        zyx = torch.stack([lin // 1600, (lin // 40) % 40, lin % 40], 1)
        if sort_keys:
            key = (zyx[:, 1] * 40 + zyx[:, 2]) * 12 + zyx[:, 0]
            zyx = zyx[torch.argsort(key)]
        coords[b, :n] = zyx.to(torch.int32)
    valid = coords[..., 0] >= 0
    feats = torch.randn(B, n + pad, cin, generator=g) * valid[..., None]
    w = torch.randn(K, cin, cout, generator=g)
    coords, valid = coords.to(device), valid.to(device)
    in_keys = sparse_conv.linearize(coords, grid)
    q_keys = sparse_conv.subm_tap_keys(coords, valid, grid, kernel)
    return (feats.to(device), coords, valid, in_keys, q_keys, w.to(device),
            grid, kernel)


@pytest.mark.parametrize("K,cin,cout", [
    (27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 64), (27, 64, 64),
    (3, 64, 64), (27, 8, 8), (27, 24, 128)])
def test_keymatch_gemm_kernel_equals_plain(cuda, K, cin, cout):
    feats, _, _, in_keys, q_keys, w, _, _ = _sparse_join(cuda, K, cin, cout)
    before = sgg.keymatch_gemm.launches
    got = sgg.keymatch_gemm(feats, in_keys, q_keys, w)
    ref = sgg.keymatch_gemm_plain(feats, in_keys, q_keys, w)
    torch.cuda.synchronize()
    assert sgg.keymatch_gemm.launches == before + 1
    assert got.shape == ref.shape == (2, 768, cout)
    assert float((got - ref).abs().max()) <= 1e-4
    assert float(ref.abs().max()) > 1.0
    # unbatched, and the JAX call forms: one result
    one = sgg.keymatch_gemm(feats[1], in_keys[1], q_keys[1], w, None, 64,
                            128, False, 0, 1)
    assert torch.equal(one, got[1])
    if K == 27:
        perm = torch.as_tensor(sgg.group_perm((3, 3, 3)), device=cuda)
        grouped = sgg.keymatch_gemm(feats, in_keys, q_keys[:, perm], w[perm],
                                    None, 256, 768, True, 384, 3)
        # the taps are summed in another order: values reach ~10 here
        assert float((grouped - got).abs().max()) <= 1e-4


def test_keymatch_gemm_unsorted_keys_and_sentinels(cuda):
    """Keys in any order give the sorted keys' answer (the kernel scans
    instead of bisecting), and all-sentinel queries give zeros."""
    feats, _, _, in_keys, q_keys, w, _, _ = _sparse_join(
        cuda, 27, 16, 32, sort_keys=False)
    assert bool((in_keys[:, 1:] < in_keys[:, :-1]).any())
    got = sgg.keymatch_gemm(feats, in_keys, q_keys, w)
    ref = sgg.keymatch_gemm_plain(feats, in_keys, q_keys, w)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4
    assert float(ref.abs().max()) > 1.0
    none = sgg.keymatch_gemm(feats, in_keys, torch.full_like(
        q_keys, sparse_conv.INT32_MAX), w)
    assert bool((none == 0).all())


@pytest.mark.parametrize("K,cin,cout", [(27, 16, 16), (27, 64, 64),
                                        (3, 64, 64), (27, 4, 16)])
def test_gather_gemm_kernel_equals_plain(cuda, K, cin, cout):
    feats, coords, valid, _, _, w, grid, kernel = _sparse_join(cuda, K, cin,
                                                               cout)
    rb = sparse_conv.build_submanifold_rulebook_merge(coords, valid, grid,
                                                      kernel)
    before = sgg.gather_gemm.launches
    got = sgg.gather_gemm(feats, rb.gather_idx, rb.found, w)
    ref = sgg.gather_gemm_plain(feats, rb.gather_idx, rb.found, w)
    torch.cuda.synchronize()
    assert sgg.gather_gemm.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-4
    assert float(ref.abs().max()) > 1.0
    # the per-tap-window form of the JAX function is the same function
    assert torch.equal(sgg.gather_gemm(feats, rb.gather_idx, rb.found, w,
                                       None, 64, 128, False), got)
    # an index outside [0, N) counts as not found
    bad = rb.gather_idx.clone()
    bad[~rb.found] = 10 ** 6
    assert torch.equal(sgg.gather_gemm(feats, bad, rb.found, w), got)
    # strided join, unbatched
    layout = sparse_conv.build_strided_layout_merge(
        coords[0], valid[0], grid, (3, 3, 3), (2, 2, 2), (1, 1, 1), 1024)
    w27 = torch.randn(27, cin, cout, device=cuda)
    got = sgg.gather_gemm(feats[0], layout.gather_idx, layout.found, w27)
    ref = sgg.gather_gemm_plain(feats[0], layout.gather_idx, layout.found,
                                w27)
    assert got.shape == (1024, cout)
    assert float((got - ref).abs().max()) <= 1e-4


def test_sparse_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    feats, _, _, in_keys, q_keys, w, _, _ = _sparse_join(cuda, 27, 16, 16)
    found = q_keys != sparse_conv.INT32_MAX
    with pytest.raises(TypeError):       # fp64 features
        sgg.keymatch_gemm(feats.double(), in_keys, q_keys, w)
    with pytest.raises(TypeError):       # int64 keys
        sgg.keymatch_gemm(feats, in_keys.long(), q_keys, w)
    with pytest.raises(TypeError):       # found must be bool
        sgg.gather_gemm(feats, q_keys, found.to(torch.int8), w)
    with pytest.raises(ValueError):      # Cout the kernel has no tile for
        sgg.keymatch_gemm(feats, in_keys, q_keys, w[..., :12].contiguous())
    with pytest.raises(ValueError):      # weights on another device
        sgg.gather_gemm(feats, q_keys, found, w.cpu())
    with pytest.raises(NotImplementedError):     # no backward yet
        sgg.keymatch_gemm(feats, in_keys, q_keys, w.requires_grad_())
    with torch.no_grad():                # fine where no grad is recorded
        sgg.keymatch_gemm(feats, in_keys, q_keys, w)
    torch.cuda.synchronize()
