"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip where there is no GPU.  On a machine
with one (and no JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math

import pytest
import torch

import chip_smoke
from automatic_as_built_reconstruction_tpu_torch.ops import (
    pillar_scatter, rotated_iou, sparse_conv, sparse_gather_gemm as sgg,
    voxel_mean)

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


def test_pillar_scatter_kernel_takes_ids_in_any_order(cuda):
    """Unique ids, unsorted (pillars in first-appearance order, as the
    host voxelizer numbers them), padding rows in between."""
    g = torch.Generator().manual_seed(5)
    B, V, C, hw = 2, 3000, 64, 80 * 80
    feats = torch.randn(B, V, C, generator=g)
    lin = torch.full((B, V), hw, dtype=torch.int32)
    for b, n in enumerate((3000, 1234)):
        rows = torch.randperm(V, generator=g)[:n]
        lin[b, rows] = torch.randperm(hw, generator=g)[:n].int()
    assert bool((lin[:, 1:] < lin[:, :-1]).any())
    feats, lin = feats.to(cuda), lin.to(cuda)
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int((got != 0).any(-1).sum()) == 3000 + 1234


def _iou_sets(name):
    """(A boxes, B boxes) [R, N, 5] / [R, K, 5] on the CPU."""
    if name == "random":
        g = torch.Generator().manual_seed(3)
        R = 3

        def boxes(n):
            b = torch.cat([torch.rand(R, n, 2, generator=g) * 8,
                           0.5 + torch.rand(R, n, 2, generator=g) * 2.5,
                           (torch.rand(R, n, 1, generator=g) - 0.5) * 2
                           * math.pi], -1)
            b[:, 1] = b[:, 0]
            b[:, 2] = torch.tensor([0.3, 0.3, 0.05, 2.5, math.pi / 2])
            return b
        return boxes(70), boxes(45)
    b = torch.from_numpy((chip_smoke.iou_cases if name == "degenerate"
                          else chip_smoke.near_touching_cases)(2, 300))
    return b, b


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("case", ["random", "degenerate", "near-touching"])
@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_kernel_equals_plain(cuda, criterion, case, ragged):
    """Kernel == plain within 1e-5 (the rejected pairs 0.0, the clipped
    ones the same arithmetic) on random, degenerate and near-touching
    boxes; ``ragged``: N and K off the 32 x 128 tile and K % 4 != 0 (the
    scalar stores).  Criterion -1 against a zero-area B is 0/0 (rounding
    noise on both sides, tests/test_torch_ops.py): those columns are held
    to criteria 0 and 1, where a zero-area B gives 1.0 over area A."""
    a, q = _iou_sets(case)
    if ragged:
        a, q = a[:, :a.shape[1] - 1], q[:, :q.shape[1] - 3 - q.shape[1] % 4]
    if case == "random" and not ragged:
        q = q[:, :44]
    a, q = a.to(cuda), q.to(cuda)
    R, N, K = a.shape[0], a.shape[1], q.shape[1]
    assert (K % 4 != 0) == ragged
    before = rotated_iou.rotate_iou_matrix.launches
    got = rotated_iou.rotate_iou_matrix(a, q, criterion)
    ref = rotated_iou.rotate_iou_matrix_plain(a, q, criterion)
    torch.cuda.synchronize()
    assert rotated_iou.rotate_iou_matrix.launches == before + 1
    assert got.shape == (R, N, K)
    zero_b = (q[..., 2] * q[..., 3] == 0)[:, None, :].expand_as(got)
    held = ~zero_b if criterion == -1 else torch.ones_like(zero_b)
    assert float((got - ref).abs()[held].max()) <= 1e-5
    assert bool(torch.isfinite(got[held]).all())
    rejected = rotated_iou.disjoint_pairs(a, q)
    assert bool((got[rejected] == 0).all())
    pad_b = ((q[..., 2] == 0) & (q[..., 3] == 0))[:, None, :].expand_as(got)
    # A with an area, near the origin (far out the shoelace's rounding on
    # absolute coordinates moves a small box's area by more than 1 %)
    some_a = ((a[..., 2] * a[..., 3] > 0) & (a[..., :2].abs().amax(-1) < 100)
              )[:, :, None].expand_as(got)
    if criterion == 0 and bool(pad_b.any()):
        assert bool((got[pad_b & some_a] > 0.99).all())


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
    (3, 64, 64), (27, 8, 8), (27, 24, 128), (27, 3, 16), (27, 6, 32),
    (27, 64, 128)])
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
                                        (3, 64, 64), (27, 4, 16),
                                        (27, 3, 16), (27, 6, 8),
                                        (27, 24, 128)])
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


@pytest.mark.parametrize("family", ["keymatch", "gather"])
def test_sparse_gemm_ragged_rows_empty_tile_and_repeatable(cuda, family):
    """R = 731 (not a multiple of the 64-row tile); rows 64-127 find no
    source at any tap (half of them query keys that are absent, half
    query nothing); the same call twice gives the same bits, and the
    batch's second element equals its unbatched call."""
    feats, coords, valid, in_keys, q_keys, w, grid, kernel = _sparse_join(
        cuda, 27, 32, 64, pad=31)
    assert feats.shape[1] % sgg.TILE_R != 0
    if family == "keymatch":
        q_keys = q_keys.clone()
        q_keys[..., 64:96] = 12 * 40 * 40 + 7     # outside the grid's keys
        q_keys[..., 96:128] = sparse_conv.INT32_MAX
        args = (feats, in_keys, q_keys, w)
        kernel_fn, plain = sgg.keymatch_gemm, sgg.keymatch_gemm_plain
        found = sgg.keymatch_found(in_keys, q_keys)
    else:
        rb = sparse_conv.build_submanifold_rulebook_merge(coords, valid,
                                                          grid, kernel)
        found = rb.found.clone()
        found[..., 64:128] = False
        args = (feats, rb.gather_idx, found, w)
        kernel_fn, plain = sgg.gather_gemm, sgg.gather_gemm_plain
    assert not bool(found[..., 64:128].any()) and bool(found.any())
    got = kernel_fn(*args)
    ref = plain(*args)
    again = kernel_fn(*args)
    one = kernel_fn(*(a[1] if a is not w else a for a in args))
    torch.cuda.synchronize()
    assert got.shape == (2, 731, 64)
    assert float((got - ref).abs().max()) <= 1e-4
    assert float(ref.abs().max()) > 1.0
    assert bool((got[:, 64:128] == 0).all())
    assert torch.equal(got, again)
    assert torch.equal(one, got[1])


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
    with pytest.raises(ValueError):      # more shared memory than a block has
        sgg.keymatch_gemm(torch.zeros(2, feats.shape[1], 256, device=cuda),
                          in_keys, q_keys,
                          torch.zeros(27, 256, 128, device=cuda))
    with pytest.raises(ValueError):      # dfeatures: Cin the tile lacks
        sgg.keymatch_gemm(feats[..., :12].contiguous().requires_grad_(),
                          in_keys, q_keys, w[:, :12].contiguous()
                          ).sum().backward()
    with torch.no_grad():                # nothing recorded without grad
        assert sgg.keymatch_gemm(feats, in_keys, q_keys,
                                 w.requires_grad_()).grad_fn is None
    torch.cuda.synchronize()


def _join_grad_launches():
    return (sgg.rulebook_inverse.launches, sgg.join_grad_features.launches,
            sgg.join_grad_weights.launches)


@pytest.mark.parametrize("family", ["keymatch", "gather", "strided"])
@pytest.mark.parametrize("K,cin,cout", [
    (27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 64), (27, 64, 64),
    (3, 64, 64)])
def test_sparse_join_backward_kernels_equal_plain(cuda, family, K, cin,
                                                  cout):
    """The gradients of a join on the card (the rulebook's inverse and the
    gather-GEMM kernel for dfeatures, the per-tap reduction for dW)
    against the plain backward on the same rulebook: rtol and atol
    chip_smoke.JOIN_GRAD_TOL of max|g|; pad rows get exactly 0; dfeatures
    only where the input needs it (Cin = 4: the voxel means); the same
    bits twice; no rulebook collision."""
    if family == "strided" and K != 27:
        pytest.skip("the strided joins are 27-tap")
    feats, coords, valid, in_keys, q_keys, w, grid, kernel = _sparse_join(
        cuda, K, cin, cout)
    feats = feats + (~valid[..., None]) * torch.randn_like(feats)  # pads
    need_f = cin != 4
    if family == "strided":
        layout = sparse_conv.build_strided_layout_merge(
            coords, valid, grid, (3, 3, 3), (2, 2, 2), (1, 1, 1), 1024)
        idx, found = layout.gather_idx, layout.found
    elif family == "gather":
        rb = sparse_conv.build_submanifold_rulebook_merge(coords, valid, grid,
                                                          kernel)
        idx, found = rb.gather_idx, rb.found
    else:
        i, h = sparse_conv._merge_lookup(in_keys, q_keys.flatten(-2))
        idx, found = i.view(q_keys.shape), h.view(q_keys.shape)
    g = torch.randn(*idx.shape[:-2], idx.shape[-1], cout, device=cuda)

    def grads():
        f = feats.clone().requires_grad_(need_f)
        wt = w.clone().requires_grad_()
        if family == "keymatch":
            out = sgg.keymatch_gemm(f, in_keys, q_keys, wt)
        else:
            out = sgg.gather_gemm(f, idx, found, wt)
        out.backward(g)
        return f.grad, wt.grad

    before = _join_grad_launches()
    df, dw = grads()
    torch.cuda.synchronize()
    after = _join_grad_launches()
    assert after == (before[0] + need_f, before[1] + need_f, before[2] + 1)
    ref_f, ref_w = sgg.join_backward_plain(feats, idx, found, w, g)
    tol = chip_smoke.JOIN_GRAD_TOL
    torch.testing.assert_close(dw, ref_w, rtol=tol,
                               atol=tol * float(ref_w.abs().max()))
    if need_f:
        torch.testing.assert_close(df, ref_f, rtol=tol,
                                   atol=tol * float(ref_f.abs().max()))
        assert bool((df[~valid] == 0).all()) and float(ref_f.abs().max()) > 0
    else:
        assert df is None
    df2, dw2 = grads()
    assert torch.equal(dw2, dw) and (df is None or torch.equal(df2, df))
    assert sgg.rulebook_collisions(cuda) == 0


def test_rulebook_inverse_kernel_counts_collisions(cuda):
    """A rulebook that is no convolution's (two rows of a tap read one
    input row): the inverse kernel counts the entry it cannot place;
    elsewhere it equals the plain inverse."""
    idx = torch.tensor([[[0, 1, 2, 3], [3, 3, 0, 1]]], dtype=torch.int32,
                       device=cuda)
    found = torch.tensor([[[1, 1, 0, 1], [1, 1, 1, 0]]], dtype=torch.bool,
                         device=cuda)
    before = sgg.rulebook_collisions(cuda)
    inv, inv_found = sgg.rulebook_inverse(idx, found, 5)
    assert sgg.rulebook_collisions(cuda) == before + 1
    ref, ref_found = sgg.rulebook_inverse_plain(idx, found, 5)
    assert torch.equal(inv_found, ref_found)
    assert torch.equal(inv[0, 0], ref[0, 0])
    assert int(inv[0, 1, 3]) in (0, 1) and int(inv[0, 1, 0]) == 2


# --------------------------------------------------------------------------
# K5: fused voxelize + mean
# --------------------------------------------------------------------------

def _scans(P, n_valid, extent, seed, voxel_size, C=4):
    """[B, P, C] points over ``extent`` (with a crowded cell, points out
    of range, points on cell faces, NaN coordinates and junk in the
    padding) + num_valid."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor(extent[:3])
    hi = torch.tensor(extent[3:])
    B = len(n_valid)
    pts = torch.rand(B, P, C, generator=g)
    pts[..., :3] = lo - 1 + pts[..., :3] * (hi - lo + 2)
    pts[:, : P // 10, :3] = lo + torch.rand(B, P // 10, 3, generator=g) * 0.3
    # faces: (p - r0) / vs a whole number
    n = P // 20
    cells = torch.floor(torch.rand(B, n, 3, generator=g)
                        * ((hi - lo) / torch.tensor(voxel_size) + 1))
    pts[:, P // 10: P // 10 + n, :3] = lo + cells * torch.tensor(voxel_size)
    pts[:, 0, :3] = math.nan       # cell (0, 0, 0), in range, first there
    pts[:, 1:4, 0] = math.nan
    pts[:, 4, 1] = math.inf
    return pts, torch.tensor(n_valid, dtype=torch.int32)


K5_CASES = {
    # SECOND serving: B = 2, 18 000 points, V = 17 000, T = 5
    "second": dict(P=18000, n_valid=(18000, 17000), V=17000, T=5,
                   voxel_size=(0.05, 0.05, 0.1),
                   pc_range=(0, -40, -3, 70.4, 40, 1),
                   grid_size=(1408, 1600, 40)),
    # a pillar-sized input: 89 297 points, V = 25 600, T = 24
    "pillars": dict(P=89297, n_valid=(89297, 63336), V=25600, T=24,
                    voxel_size=(0.1, 0.1, 4.0),
                    pc_range=(0, 0, -0.5, 16, 16, 3.5),
                    grid_size=(160, 160, 1)),
    # B = 4 pillar-sized scans: 4 x 175 segment blocks of 512 threads,
    # more than the card holds at once (132 SMs x 4), so tiles wait on
    # tiles of blocks that started in another wave
    "pillars_b4": dict(P=89297, n_valid=(89297, 63336, 89297, 40000),
                       V=25600, T=24, voxel_size=(0.1, 0.1, 4.0),
                       pc_range=(0, 0, -0.5, 16, 16, 3.5),
                       grid_size=(160, 160, 1)),
    # the voxel cap below the occupied cells
    "truncated": dict(P=18000, n_valid=(18000, 9000), V=500, T=5,
                      voxel_size=(0.5, 0.5, 0.5),
                      pc_range=(0, -8, -2, 16, 8, 2), grid_size=(32, 32, 8)),
    # runs longer than a tile's halo (the crowded cell holds ~1800)
    "t64": dict(P=18000, n_valid=(18000, 9000), V=6000, T=64,
                voxel_size=(0.5, 0.5, 0.5), pc_range=(0, -8, -2, 16, 8, 2),
                grid_size=(32, 32, 8)),
    "t1": dict(P=18000, n_valid=(18000, 9000), V=6000, T=1,
               voxel_size=(0.5, 0.5, 0.5), pc_range=(0, -8, -2, 16, 8, 2),
               grid_size=(32, 32, 8)),
    # more slots than points, P not a multiple of any block size
    "v_over_p": dict(P=3001, n_valid=(3001, 2000), V=4096, T=5,
                     voxel_size=(0.2, 0.2, 0.2),
                     pc_range=(0, -8, -2, 16, 8, 2), grid_size=(80, 80, 20)),
    "empty": dict(P=4096, n_valid=(0, 0), V=256, T=4,
                  voxel_size=(0.5, 0.5, 0.5), pc_range=(0, -8, -2, 16, 8, 2),
                  grid_size=(32, 32, 8)),
}
K5_COUNTERS = (voxel_mean.point_keys, voxel_mean.segment_mean,
               voxel_mean.mean_from_table)


def _launches():
    return [fn.launches for fn in K5_COUNTERS]


def _same_floats(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("first_appearance", [True, False],
                         ids=["first_appearance", "key_order"])
@pytest.mark.parametrize("case", list(K5_CASES))
def test_voxel_mean_kernel_equals_plain(cuda, case, first_appearance):
    """Both routes against the plain function: integers exact, features
    rtol 1e-6 + atol 1e-6 (the kernels add in t order, torch.sum in its
    own), NaN where a voxel holds one.  The key route's kernels against
    their own plain mirrors (keys exact, the segment kernel bit for bit)
    and against the table route (bit for bit)."""
    k = dict(K5_CASES[case])
    pts, nv = _scans(k.pop("P"), k.pop("n_valid"), k["pc_range"], 1,
                     k["voxel_size"])
    kw = dict(max_points=k.pop("T"), max_voxels=k.pop("V"),
              first_appearance=first_appearance, **k)
    pts, nv = pts.to(cuda), nv.to(cuda)
    before = _launches()
    got = voxel_mean.fused_voxelize_mean(pts, nv, **kw)
    per_call = [0, 0, 1] if first_appearance else [1, 1, 0]
    assert [a - b for a, b in zip(_launches(), before)] == per_call
    ref = voxel_mean.fused_voxelize_mean_plain(pts, nv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.coords, ref.coords)
    assert torch.equal(got.num_points, ref.num_points)
    assert torch.equal(got.num_voxels, ref.num_voxels)
    assert torch.allclose(got.features, ref.features, rtol=1e-6, atol=1e-6,
                          equal_nan=True)
    assert bool((got.features[got.num_points == 0] == 0).all())
    if case == "empty":
        assert int(got.num_voxels.sum()) == 0
    else:
        assert int(got.num_voxels.min()) > 100
        assert int(got.num_points.max()) == kw["max_points"]
        assert bool(torch.isnan(got.features).any())
    if case == "truncated":
        assert got.num_voxels.tolist() == [500, 500]
    if case == "v_over_p":
        assert int(got.num_voxels.max()) < kw["max_voxels"]
    # the CPU run of the same request: the same integers
    cpu = voxel_mean.fused_voxelize_mean(pts.cpu(), nv.cpu(), **kw)
    assert torch.equal(got.coords.cpu(), cpu.coords)
    assert torch.equal(got.num_points.cpu(), cpu.num_points)
    if first_appearance:
        return
    geo = dict(voxel_size=k["voxel_size"], pc_range=k["pc_range"],
               grid_size=k["grid_size"])
    keys = voxel_mean.point_keys(pts, nv, **geo)
    assert torch.equal(keys, voxel_mean.point_keys_plain(pts, nv, **geo))
    srt = torch.sort(keys, dim=1).values
    seg_kw = dict(grid_size=k["grid_size"], max_points=kw["max_points"],
                  max_voxels=kw["max_voxels"])
    seg = voxel_mean.segment_mean(pts, srt, **seg_kw)
    plain = voxel_mean.segment_mean_plain(pts, srt, **seg_kw)
    for name in ("coords", "num_points", "num_voxels"):
        assert torch.equal(getattr(seg, name), getattr(plain, name))
        assert torch.equal(getattr(seg, name), getattr(got, name))
    assert _same_floats(seg.features, plain.features)
    assert _same_floats(seg.features, got.features)
    cell, tab = voxel_mean.slot_table(pts, nv, max_voxels=kw["max_voxels"],
                                      first_appearance=False, **geo)
    table = voxel_mean.mean_from_table(pts, cell, tab, kw["max_points"])
    assert _same_floats(table.features, got.features)


def test_voxel_mean_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    k = dict(K5_CASES["empty"])
    kw = dict(max_points=k.pop("T"), max_voxels=k.pop("V"),
              voxel_size=k["voxel_size"], pc_range=k["pc_range"],
              grid_size=k["grid_size"])
    pts = torch.zeros(1, 64, 4, device=cuda)
    nv = torch.tensor([64], dtype=torch.int32, device=cuda)
    for fa in (True, False):
        with pytest.raises(TypeError):          # fp64 points
            voxel_mean.fused_voxelize_mean(pts.double(), nv,
                                           first_appearance=fa, **kw)
        with pytest.raises(ValueError):         # num_valid on another device
            voxel_mean.fused_voxelize_mean(pts, nv.cpu(),
                                           first_appearance=fa, **kw)
        with pytest.raises(ValueError):         # no batch axis
            voxel_mean.fused_voxelize_mean(pts[0], nv, first_appearance=fa,
                                           **kw)
        with pytest.raises(ValueError):         # 2^31 cells: no int32 key
            voxel_mean.fused_voxelize_mean(
                pts, nv, first_appearance=fa,
                **(kw | {"grid_size": (2**16, 2**15, 1)}))
    with pytest.raises(ValueError):             # keys not int64
        voxel_mean.segment_mean(pts, nv[:, None].expand(1, 64),
                                grid_size=kw["grid_size"], max_points=4,
                                max_voxels=16)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# the entry points as a caller gets them
# --------------------------------------------------------------------------

def test_serving_from_the_default_flags_is_fp32(cuda):
    """One pillar and one SECOND request served from the process's
    default flags (cuDNN TF32 on): every module of the network sees TF32
    off inside ``heads()`` and ``__call__``, heads within HEAD_TOL of the
    CPU run, and the caller's flags the same afterwards."""
    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
        make_scene)
    from automatic_as_built_reconstruction_tpu_torch.parallel import (
        pod_inference_from_checkpoint)

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    default = flags()
    assert default[0]              # PyTorch's default: TF32 convolutions
    pillar = dict(config_path=chip_smoke.CONFIG,
                  checkpoint_pkl=chip_smoke.CHECKPOINT,
                  max_voxels=chip_smoke.MAX_VOXELS,
                  max_points_per_voxel=chip_smoke.MAX_POINTS)
    second = dict(config_path=chip_smoke.SECOND_CONFIG, checkpoint_pkl=None,
                  seed=chip_smoke.SECOND_SEED,
                  max_voxels=chip_smoke.SECOND_MAX_VOXELS,
                  max_points_per_voxel=chip_smoke.SECOND_MAX_POINTS,
                  voxelization="fused_mean")
    for kw, request in (
            (pillar, pad_batch([generate_building_scene(s) for s in (0, 1)])),
            (second, pad_batch([make_scene(s) for s in (1000, 1001)]))):
        gpu = pod_inference_from_checkpoint(device="cuda", **kw)
        with chip_smoke.flags_in_modules() as seen:
            got = {k: v.float().cpu()
                   for k, v in gpu.heads(*request).items()}
            assert flags() == default
            out = gpu(*request)
            assert flags() == default
        assert seen == {(False, False)}
        cpu = pod_inference_from_checkpoint(device="cpu", **kw)
        ref = cpu.heads(*request)
        for name in ref:
            assert torch.allclose(got[name], ref[name],
                                  **chip_smoke.HEAD_TOL), name
        assert out["valid"].any()


def test_flat_pfn_is_the_same_bits_on_every_run(cuda):
    """The flat pillar path on a served request: canvas and heads equal
    bit for bit over three runs."""
    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.device import fp32_math
    from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import (
        voxelize_flat)
    from automatic_as_built_reconstruction_tpu_torch.parallel import (
        pod_inference_from_checkpoint)

    pod = pod_inference_from_checkpoint(
        chip_smoke.CONFIG, chip_smoke.CHECKPOINT, device="cuda",
        max_voxels=chip_smoke.MAX_VOXELS,
        max_points_per_voxel=chip_smoke.MAX_POINTS)
    pts, nv = (torch.as_tensor(a, device=cuda) for a in
               pad_batch([generate_building_scene(s) for s in (0, 1)]))
    cfg = pod.cfg
    flat = voxelize_flat(pts, nv, voxel_size=cfg.voxel_size,
                         pc_range=cfg.pc_range, grid_size=cfg.grid_size,
                         max_points=pod.max_points_per_voxel,
                         max_voxels=pod.max_voxels)
    runs = []
    with torch.no_grad(), fp32_math():
        for _ in range(3):
            preds, stages = pod.model(None, flat.num_points, flat.coords,
                                      flat_points=flat.points,
                                      flat_slot=flat.slot,
                                      return_stages=True)
            runs.append({"canvas": stages["spatial_features"], **preds})
    torch.cuda.synchronize()
    for again in runs[1:]:
        for name, t in runs[0].items():
            assert torch.equal(t, again[name]), name


def _served_pillar_ids(cuda, seeds):
    """Cell ids [B, V] of the pillar path's device voxelizer on synthetic
    scans at the served width (V = 25 600, 160 x 160 cells)."""
    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import (
        voxelize)
    from automatic_as_built_reconstruction_tpu_torch.parallel.inference \
        import build_from_config

    _, cfg, _ = build_from_config(chip_smoke.CONFIG)
    pts, nv = (torch.as_tensor(a, device=cuda) for a in
               pad_batch([generate_building_scene(s) for s in seeds]))
    vox = voxelize(pts, nv, voxel_size=cfg.voxel_size, pc_range=cfg.pc_range,
                   grid_size=cfg.grid_size, max_points=chip_smoke.MAX_POINTS,
                   max_voxels=chip_smoke.MAX_VOXELS)
    H, W = cfg.bev_shape
    valid = vox.coords[..., 1] >= 0
    lin = torch.where(valid, vox.coords[..., 1] * W + vox.coords[..., 2],
                      H * W)
    return lin.int(), H * W


def test_pillar_gather_kernel_equals_plain(cuda):
    """K1's backward on the served pillar ids (B = 4), as they come, with
    the rows shuffled, and with negative ids among them: equal to the
    plain version bit for bit, one launch a call."""
    lin, hw = _served_pillar_ids(cuda, (0, 1, 2, 3))
    B, V = lin.shape
    g = torch.Generator(device=cuda).manual_seed(0)
    dcanvas = torch.randn(B, hw, 64, device=cuda, generator=g)
    shuffled = lin[:, torch.randperm(V, device=cuda, generator=g)]
    negative = torch.where(torch.arange(V, device=cuda) % 5 == 0,
                           -1 - torch.arange(V, device=cuda) % 4, lin).int()
    assert int((lin < hw).sum()) > 1000 and bool((lin == hw).any())
    for ids in (lin, shuffled.contiguous(), negative):
        before = pillar_scatter.pillar_gather.launches
        got = pillar_scatter.pillar_gather(dcanvas, ids)
        ref = pillar_scatter.pillar_gather_plain(dcanvas, ids)
        torch.cuda.synchronize()
        assert pillar_scatter.pillar_gather.launches == before + 1
        assert torch.equal(got, ref)
    # a non-contiguous incoming gradient (the NCHW view's strides)
    nchw = dcanvas.view(B, 160, 160, 64).permute(0, 3, 1, 2).contiguous()
    strided = nchw.permute(0, 2, 3, 1).view(B, hw, 64)
    assert not strided.is_contiguous()
    assert torch.equal(pillar_scatter.pillar_gather(strided, lin),
                       pillar_scatter.pillar_gather_plain(dcanvas, lin))


def test_pillar_scatter_has_a_gradient_on_the_card(cuda):
    """The repair: on the card K1's canvas carries a grad_fn whose backward
    is the gather kernel, and after one backward() every PFN parameter
    has a nonzero gradient."""
    from automatic_as_built_reconstruction_tpu_torch.train import train

    bundle = train.Bundle(chip_smoke.CONFIG)
    state = train.init_state(bundle, rng_seed=0, total_steps=10,
                             device=cuda)
    _, loader = bundle.input_reader(training=True, seed=0)
    example = train.to_device(next(iter(loader)), cuda)
    lin = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    feats = torch.zeros(2, 8, 64, device=cuda, requires_grad=True)
    assert pillar_scatter.scatter_sorted_to_canvas(
        feats, lin, 16).grad_fn is not None
    before = pillar_scatter.pillar_gather.launches
    metrics = train.make_train_step(bundle)(state, example)
    torch.cuda.synchronize()
    assert pillar_scatter.pillar_gather.launches == before + 1
    assert math.isfinite(float(metrics["loss"]))
    _, grads = chip_smoke.step_grads(bundle, state, example)
    pfn = [n for n in grads if n.startswith("voxel_feature_extractor")]
    assert len(pfn) == 3                    # linear, BN scale and bias
    for n in pfn:
        assert float(grads[n].abs().max()) > 0, n


def test_full_width_train_step_matches_cpu(cuda):
    """One training step of asbuilt_pillars at full width on the card
    against the port's CPU step, from the same seeded weights and batch:
    loss terms, gradients (each device against a float64 step), the
    float64 steps of the two devices, parameters after the update and
    BatchNorm statistics, held as chip_smoke.train_step_mismatch says."""
    from automatic_as_built_reconstruction_tpu_torch.train import train

    bundle = train.Bundle(chip_smoke.CONFIG)
    _, loader = bundle.input_reader(training=True, seed=3)
    summary, bad = chip_smoke.train_step_mismatch(
        chip_smoke.CONFIG, next(iter(loader)), chip_smoke.TRAIN_STEPS)
    print(summary)
    assert bad is None, bad
