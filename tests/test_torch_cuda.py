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


def _k1_ids(case, B, V, hw, g):
    """[B, V] int32 cell ids of one K1 edge case (unique per scan)."""
    lin = torch.full((B, V), hw, dtype=torch.int32)
    n = min(V, hw) * 3 // 4
    for b in range(B):
        lin[b, :n] = torch.randperm(hw, generator=g)[:n].sort().values
    if case == "tile edges":        # both sides of every granule's edge
        step = pillar_scatter.SCATTER_GRANULE
        edges = sorted({c for k in range(1, hw // step + 1)
                        for c in (k * step - 1, k * step) if c < hw}
                       | {0, hw - 1})
        lin[:, :len(edges)] = torch.tensor(edges, dtype=torch.int32)
        lin[:, len(edges):] = hw
    elif case == "every id dropped":
        lin[:, ::2] = -1
        lin[:, 1::2] = hw + torch.arange(V)[1::2].int()
    elif case == "negative ids":
        lin[:, ::5] = -1 - torch.arange(V)[::5].int() % 7
    elif case == "shuffled":
        lin = lin[:, torch.randperm(V, generator=g)]
    return lin.contiguous()


# (case, B, V, hw): the granules' edges (each of a tile that the next
# one is not); hw not a multiple of the granule; V above hw; V below a
# tile; B = 3
K1_CASES = [("tile edges", 2, 3000, 80 * 80), ("tile edges", 2, 700, 601),
            ("hw off the tile", 2, 3000, 80 * 80 + 37),
            ("V above hw", 2, 2000, 1500), ("V below a tile", 2, 100, 4100),
            ("every id dropped", 2, 1000, 3000),
            ("negative ids", 2, 3000, 80 * 80), ("B = 3", 3, 700, 601),
            ("shuffled", 2, 3000, 80 * 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 32, 48])    # 48: the untemplated width
@pytest.mark.parametrize("case,B,V,hw", K1_CASES, ids=lambda x: str(x))
def test_pillar_scatter_kernels_on_edge_cases(cuda, case, B, V, hw, C,
                                              dtype):
    """K1's forward and backward equal their plain versions bit for bit,
    one launch each, on ids at tile edges, hw off the tiles, V above hw
    and below a tile, every id dropped, negative ids, B = 3 and shuffled
    ids, in float32 and bfloat16."""
    g = torch.Generator().manual_seed(hw + V + C)
    lin = _k1_ids(case, B, V, hw, g).to(cuda)
    feats = torch.randn(B, V, C, generator=g).to(cuda, dtype)
    dcanvas = torch.randn(B, hw, C, generator=g).to(cuda, dtype)
    before = (pillar_scatter.scatter_sorted_to_canvas.launches,
              pillar_scatter.pillar_gather.launches)
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    back = pillar_scatter.pillar_gather(dcanvas, lin)
    torch.cuda.synchronize()
    assert (pillar_scatter.scatter_sorted_to_canvas.launches,
            pillar_scatter.pillar_gather.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert torch.equal(got, pillar_scatter.scatter_sorted_to_canvas_plain(
        feats, lin, hw))
    assert torch.equal(back, pillar_scatter.pillar_gather_plain(dcanvas,
                                                                lin))
    occupied = int(((lin >= 0) & (lin < hw)).sum())
    assert int((got != 0).any(-1).sum()) == occupied
    if case == "every id dropped":
        assert occupied == 0 and not bool(back.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["sorted", "shuffled", "negative ids"])
def test_pillar_scatter_rows_route_equals_plain(cuda, case, dtype):
    """A canvas above SCATTER_TILES_MAX_BYTES (a KITTI training batch:
    B = 2, 496 x 432 cells, 64 channels) takes the zero fill and the rows
    kernel: equal to the plain version bit for bit, one counted launch."""
    B, V, hw, C = 2, 12000, 496 * 432, 64
    cw = C * torch.tensor([], dtype=dtype).element_size() // 16
    assert pillar_scatter.scatter_plan(
        B, V, hw, cw, pillar_scatter.sm_count(cuda)).route == "rows"
    g = torch.Generator().manual_seed(11)
    lin = _k1_ids("shuffled" if case == "shuffled" else "sorted", B, V, hw,
                  g)
    if case == "negative ids":
        lin[:, ::3] = -1 - torch.arange(V)[::3].int() % 5
    lin = lin.contiguous().to(cuda)
    feats = torch.randn(B, V, C, generator=g).to(cuda, dtype)
    before = pillar_scatter.scatter_sorted_to_canvas.launches
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    torch.cuda.synchronize()
    assert pillar_scatter.scatter_sorted_to_canvas.launches == before + 1
    assert torch.equal(got, pillar_scatter.scatter_sorted_to_canvas_plain(
        feats, lin, hw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pillar_scatter_writes_every_cell_of_a_dirty_canvas(cuda, dtype):
    """The canvas comes from torch.empty: a same-sized tensor of NaN freed
    just before the call hands the kernel its memory (the caching
    allocator), and every empty cell must still be exactly 0; the same
    for the backward's rows."""
    lin, hw = _served_pillar_ids(cuda, (0, 1))
    B, V = lin.shape
    g = torch.Generator(device=cuda).manual_seed(3)
    feats = torch.randn(B, V, 64, device=cuda, generator=g).to(dtype)
    dcanvas = torch.randn(B, hw, 64, device=cuda, generator=g).to(dtype)
    for call, ref, shape in (
            (lambda: pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw),
             pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw),
             (B, hw, 64)),
            (lambda: pillar_scatter.pillar_gather(dcanvas, lin),
             pillar_scatter.pillar_gather_plain(dcanvas, lin), (B, V, 64))):
        dirty = torch.full(shape, float("nan"), dtype=dtype, device=cuda)
        ptr = dirty.data_ptr()
        del dirty
        got = call()
        torch.cuda.synchronize()
        assert got.data_ptr() == ptr          # the NaN block, reused
        assert torch.equal(got, ref)
    empty = (lin < 0) | (lin >= hw)
    assert bool(empty.any())
    canvas = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    assert int((canvas == 0).all(-1).sum()) == B * hw - int((~empty).sum())


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


# the joins of car.fhd.mixed's SpMiddleFHD (Cin -> Cout), its z-only
# strided kernel, Cin = 6 (the 4-byte copies), and the widths the tile
# takes beyond them: Cin = 48 (padded to 64), Cin = 128 (A in two 64-value
# blocks), Cout = 128 (W in two boxes, one block an SM)
BF16_JOINS = [(27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 32),
              (27, 32, 64), (27, 64, 64), (3, 64, 64), (27, 6, 8),
              (27, 48, 32), (27, 64, 128), (27, 128, 64), (27, 128, 128)]


def _bf16_rulebook(cuda, K, cin, cout, case):
    """bf16 feats / weights and a rulebook: ``random`` sites, rows 64-127
    with no source at any tap (``empty``: the second half of the tile's
    first block), rows 128-191 likewise (``half_miss``: the first half of
    its second block), three scans of 776 rows (``ragged_b3``: the last
    block holds 8 rows), or a dense 6 x 10 x 10 cube of sites whose inner
    ones find every tap (``full``)."""
    B, pad = (3, 76) if case == "ragged_b3" else (2, 68)
    feats, coords, valid, _, _, w, grid, kernel = _sparse_join(
        cuda, K, cin, cout, B=B, pad=pad)
    if case == "full":
        z, y, x = torch.meshgrid(torch.arange(6), torch.arange(10),
                                 torch.arange(10), indexing="ij")
        cube = torch.stack([z, y, x], -1).reshape(-1, 3).to(torch.int32)
        coords = torch.full_like(coords, -1)
        coords[:, :cube.shape[0]] = cube.to(cuda)
        valid = coords[..., 0] >= 0
        feats = feats * valid[..., None]
    rb = sparse_conv.build_submanifold_rulebook_merge(coords, valid, grid,
                                                      kernel)
    found = rb.found.clone()
    if case == "empty":
        found[..., 64:128] = False
    if case == "half_miss":
        found[..., 128:192] = False
    if case == "full":
        assert bool(found.all(-2).any())          # some row finds every tap
    return feats.bfloat16(), rb.gather_idx, found, w.bfloat16()


@pytest.mark.parametrize("case", ["random", "empty", "full", "half_miss",
                                  "ragged_b3"])
@pytest.mark.parametrize("K,cin,cout", BF16_JOINS)
def test_gather_gemm_bf16_kernel_equals_plain(cuda, K, cin, cout, case):
    """The tile's bfloat16 form against its plain version (the bf16
    inputs upcast to float32, one matmul) within 1e-4 of max |out|: the
    products are exact in float32, the two differ in the order of their
    sums only.  Rows with no source give zeros, also where one 64-row
    half of a 128-row block misses every tap and the other hits."""
    feats, idx, found, w = _bf16_rulebook(cuda, K, cin, cout, case)
    before = (sgg.gather_gemm.launches, sgg.gather_gemm_bf16.launches)
    got = sgg.gather_gemm(feats, idx, found, w)
    ref = sgg.gather_gemm_plain(feats, idx, found, w)
    torch.cuda.synchronize()
    assert (sgg.gather_gemm.launches,
            sgg.gather_gemm_bf16.launches) == (before[0], before[1] + 1)
    assert got.dtype == ref.dtype == torch.float32
    assert got.shape == ref.shape == (feats.shape[0], idx.shape[-1], cout)
    scale = float(ref.abs().max())
    assert scale > 1.0
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    if case == "empty":
        assert bool((got[:, 64:128] == 0).all())
    if case == "half_miss":
        assert bool((got[:, 128:192] == 0).all())
        assert bool((got[:, 192:256] != 0).any())
    # the same bits again, and the last scan unbatched
    assert torch.equal(sgg.gather_gemm(feats, idx, found, w), got)
    one = sgg.gather_gemm_bf16(feats[-1], idx[-1], found[-1], w)
    assert torch.equal(one, got[-1])


def test_gather_gemm_bf16_backward_upcasts(cuda):
    """A bfloat16 join's backward runs the float32 kernels on the upcast
    dout, features and weights and casts back: dfeatures in bfloat16, dW
    in bfloat16, equal to the plain float32 backward of the same values
    rounded once."""
    feats, idx, found, w = _bf16_rulebook(cuda, 27, 32, 64, "random")
    feats.requires_grad_()
    w.requires_grad_()
    dout = torch.randn(feats.shape[0], feats.shape[1], 64, device=cuda)
    launches = _join_grad_launches()
    sgg.gather_gemm(feats, idx, found, w).backward(dout)
    torch.cuda.synchronize()
    assert _join_grad_launches() == tuple(n + 1 for n in launches)
    df, dw = sgg.join_backward_plain(feats.detach().float(), idx, found,
                                     w.detach().float(), dout)
    assert feats.grad.dtype == w.grad.dtype == torch.bfloat16
    for got, want in ((feats.grad, df), (w.grad, dw)):
        err = float((got.float() - want).abs().max())
        assert err <= 2 ** -8 * float(want.abs().max()), err


def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    feats, idx, found, w = _bf16_rulebook(cuda, 27, 16, 16, "random")
    with pytest.raises(TypeError):       # mixed: bf16 features, fp32 W
        sgg.gather_gemm(feats, idx, found, w.float())
    with pytest.raises(TypeError):       # the named form takes bf16 only
        sgg.gather_gemm_bf16(feats.float(), idx, found, w.float())
    with pytest.raises(ValueError):      # odd Cin
        sgg.gather_gemm(feats[..., :15].contiguous(), idx, found,
                        w[:, :15].contiguous())
    in_keys = sparse_conv.linearize(torch.zeros(2, feats.shape[1], 3,
                                                dtype=torch.int32,
                                                device=cuda), (12, 40, 40))
    with pytest.raises(TypeError):       # key-match: bf16 features, fp32 W
        sgg.keymatch_gemm(feats, in_keys, idx, w.float())
    with pytest.raises(TypeError):       # the named form takes bf16 only
        sgg.keymatch_gemm_bf16(feats.float(), in_keys, idx, w.float())
    with pytest.raises(ValueError):      # key-match: odd Cin
        sgg.keymatch_gemm(feats[..., :15].contiguous(), in_keys, idx,
                          w[:, :15].contiguous())
    with pytest.raises(TypeError):       # the backward kernels: fp32 only
        sgg.join_grad_weights(feats, idx, found,
                              torch.zeros(2, feats.shape[1], 16,
                                          dtype=torch.bfloat16,
                                          device=cuda))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["random", "unsorted", "sentinels",
                                  "half_miss", "ragged_b3"])
@pytest.mark.parametrize("K,cin,cout", BF16_JOINS)
def test_keymatch_gemm_bf16_kernel_equals_plain(cuda, K, cin, cout, case):
    """The tile's bfloat16 form with the key lookup (K4 in bfloat16)
    against its plain version (the bf16 inputs upcast to float32, one
    matmul) within 1e-4 of max |out|: on key-sorted sites, on unsorted
    keys (the scan), with rows 64-127 querying absent keys or nothing
    (zeros), with rows 128-191 (the first half of the second 128-row
    block) querying nothing while rows 192-255 hit, and on three scans of
    776 rows (the last block holds 8); the same bits twice, a scan equal
    to its unbatched call; the JAX function's call forms give one
    result."""
    B, pad = (3, 76) if case == "ragged_b3" else (2, 68)
    feats, _, _, in_keys, q_keys, w, _, _ = _sparse_join(
        cuda, K, cin, cout, sort_keys=case != "unsorted", B=B, pad=pad)
    feats, w = feats.bfloat16(), w.bfloat16()
    if case == "unsorted":
        assert bool((in_keys[:, 1:] < in_keys[:, :-1]).any())
    if case == "sentinels":
        q_keys = q_keys.clone()
        q_keys[..., 64:96] = 12 * 40 * 40 + 7     # outside the grid's keys
        q_keys[..., 96:128] = sparse_conv.INT32_MAX
    if case == "half_miss":
        q_keys = q_keys.clone()
        q_keys[..., 128:192] = sparse_conv.INT32_MAX
    before = (sgg.keymatch_gemm.launches, sgg.keymatch_gemm_bf16.launches)
    got = sgg.keymatch_gemm(feats, in_keys, q_keys, w)
    ref = sgg.keymatch_gemm_plain(feats, in_keys, q_keys, w)
    torch.cuda.synchronize()
    assert (sgg.keymatch_gemm.launches,
            sgg.keymatch_gemm_bf16.launches) == (before[0], before[1] + 1)
    assert got.dtype == ref.dtype == torch.float32
    scale = float(ref.abs().max())
    assert scale > 1.0
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    assert got.shape == (B, q_keys.shape[-1], cout)
    if case == "sentinels":
        assert bool((got[:, 64:128] == 0).all())
    if case == "half_miss":
        assert bool((got[:, 128:192] == 0).all())
        assert bool((got[:, 192:256] != 0).any())
    assert torch.equal(sgg.keymatch_gemm(feats, in_keys, q_keys, w), got)
    one = sgg.keymatch_gemm_bf16(feats[-1], in_keys[-1], q_keys[-1], w, None,
                                 64, 128, False, 0, 1)
    assert torch.equal(one, got[-1])
    if K == 27:
        perm = torch.as_tensor(sgg.group_perm((3, 3, 3)), device=cuda)
        grouped = sgg.keymatch_gemm(feats, in_keys, q_keys[:, perm],
                                    w[perm], None, 256, 768, True, 384, 3)
        assert float((grouped - ref).abs().max()) <= 1e-4 * scale


def test_keymatch_gemm_bf16_backward_upcasts(cuda):
    """A bfloat16 key-match join's backward runs the float32 kernels on
    the upcast dout, features and weights over the join's rulebook, and
    casts back: bf16 gradients equal to the plain float32 backward of the
    same values rounded once."""
    feats, _, _, in_keys, q_keys, w, _, _ = _sparse_join(cuda, 27, 32, 64)
    feats = feats.bfloat16().requires_grad_()
    w = w.bfloat16().requires_grad_()
    dout = torch.randn(feats.shape[0], q_keys.shape[-1], 64, device=cuda)
    launches = _join_grad_launches()
    sgg.keymatch_gemm(feats, in_keys, q_keys, w).backward(dout)
    torch.cuda.synchronize()
    assert _join_grad_launches() == tuple(n + 1 for n in launches)
    idx, hit = sparse_conv._merge_lookup(in_keys, q_keys.flatten(-2))
    df, dw = sgg.join_backward_plain(
        feats.detach().float(), idx.view(q_keys.shape), hit.view(
            q_keys.shape), w.detach().float(), dout)
    assert feats.grad.dtype == w.grad.dtype == torch.bfloat16
    for got, want in ((feats.grad, df), (w.grad, dw)):
        err = float((got.float() - want).abs().max())
        assert err <= 2 ** -8 * float(want.abs().max()), err


@pytest.mark.parametrize("C", [64, 32])     # the pillar configs' widths
def test_pillar_scatter_bf16_kernels_equal_plain(cuda, C):
    """K1 and its backward on bfloat16 rows (8 or 4 chunks of 16 bytes a
    row): equal to the plain versions bit for bit, on the served pillar
    ids, shuffled and with negative ids, one launch a call."""
    lin, hw = _served_pillar_ids(cuda, (0, 1))
    B, V = lin.shape
    g = torch.Generator(device=cuda).manual_seed(C)
    feats = torch.randn(B, V, C, device=cuda, generator=g).bfloat16()
    dcanvas = torch.randn(B, hw, C, device=cuda, generator=g).bfloat16()
    shuffled = torch.randperm(V, device=cuda, generator=g)
    negative = torch.where(torch.arange(V, device=cuda) % 5 == 0,
                           -1 - torch.arange(V, device=cuda) % 4, lin).int()
    for f, ids in ((feats, lin),
                   (feats[:, shuffled].contiguous(),
                    lin[:, shuffled].contiguous()),
                   (feats, negative)):
        before = (pillar_scatter.scatter_sorted_to_canvas.launches,
                  pillar_scatter.pillar_gather.launches)
        canvas = pillar_scatter.scatter_sorted_to_canvas(f, ids, hw)
        ref = pillar_scatter.scatter_sorted_to_canvas_plain(f, ids, hw)
        back = pillar_scatter.pillar_gather(dcanvas, ids)
        back_ref = pillar_scatter.pillar_gather_plain(dcanvas, ids)
        torch.cuda.synchronize()
        assert (pillar_scatter.scatter_sorted_to_canvas.launches,
                pillar_scatter.pillar_gather.launches) == (
                    before[0] + 1, before[1] + 1)
        assert canvas.dtype == back.dtype == torch.bfloat16
        assert torch.equal(canvas, ref) and torch.equal(back, back_ref)
    # through autograd: the gradient of the bf16 rows is the gather
    f = feats.clone().requires_grad_()
    pillar_scatter.scatter_sorted_to_canvas(f, lin, hw).backward(dcanvas)
    assert torch.equal(f.grad, pillar_scatter.pillar_gather_plain(dcanvas,
                                                                  lin))
    with pytest.raises(ValueError):     # a bf16 row of 12 values: 24 bytes
        pillar_scatter.scatter_sorted_to_canvas(
            feats[..., :12].contiguous(), lin, hw)


def _join_grad_launches():
    return (sgg.rulebook_hits.launches, sgg.rulebook_inverse.launches,
            sgg.join_grad_features.launches, sgg.join_grad_weights.launches)


@pytest.mark.parametrize("family", ["keymatch", "gather", "strided"])
@pytest.mark.parametrize("K,cin,cout", [
    (27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 64), (27, 64, 64),
    (3, 64, 64)])
def test_sparse_join_backward_kernels_equal_plain(cuda, family, K, cin,
                                                  cout):
    """The gradients of a join on the card (the rulebook's inverse and the
    kernel over the rows each tap hits for dfeatures, the hits of each tap
    and the per-tap reduction GEMM for dW) against the plain backward on
    the same rulebook: rtol and atol
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
    lookups = sgg.keymatch_rulebook.launches
    df, dw = grads()
    torch.cuda.synchronize()
    after = _join_grad_launches()
    assert after == (before[0] + 1, before[1] + need_f, before[2] + need_f,
                     before[3] + 1)
    assert sgg.keymatch_rulebook.launches == lookups + (family == "keymatch")
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


def _gather_join(cuda, K, cin, cout, B=2, n=700, pad=68):
    """A submanifold gather join: (feats, idx, found, w, valid)."""
    feats, coords, valid, _, _, w, grid, kernel = _sparse_join(
        cuda, K, cin, cout, B=B, n=n, pad=pad)
    rb = sparse_conv.build_submanifold_rulebook_merge(coords, valid, grid,
                                                      kernel)
    return feats, rb.gather_idx, rb.found.clone(), w, valid


def _hold_join_grads(feats, idx, found, w, dout, need_f=True):
    """Both backward kernels against the plain backward (JOIN_GRAD_TOL of
    max |g|), the same bits twice.  -> (dfeatures, dW)."""
    N = feats.shape[-2]
    got = [(sgg.join_grad_features(dout, idx, found, w, N) if need_f
            else None, sgg.join_grad_weights(feats, idx, found, dout))
           for _ in range(2)]
    ref_f, ref_w = sgg.join_backward_plain(feats, idx, found, w, dout,
                                           need_f)
    torch.cuda.synchronize()
    tol = chip_smoke.JOIN_GRAD_TOL
    for g, ref in ((got[0][0], ref_f), (got[0][1], ref_w)):
        if ref is None:
            continue
        torch.testing.assert_close(g, ref, rtol=tol,
                                   atol=tol * float(ref.abs().max()))
    assert torch.equal(got[0][1], got[1][1])
    assert not need_f or torch.equal(got[0][0], got[1][0])
    return got[0]


@pytest.mark.parametrize("case", ["tap_without_hits", "many_parts",
                                  "one_element", "unbatched"])
def test_sparse_join_backward_edge_cases(cuda, case):
    """A tap that no row hits (its dW is exactly 0) and rows that hit
    nothing; a join whose taps' hits span many parts of the dW reduction
    (6000 sites in each 12 x 40 x 40 grid: every tap's hits in every part,
    and the centre tap's parts of more chunks than the ring has stages);
    B = 1; the unbatched call form."""
    B, n = (2, 6000) if case == "many_parts" else (2, 700)
    if case == "one_element":
        B = 1
    feats, idx, found, w, valid = _gather_join(cuda, 27, 32, 64, B=B, n=n)
    if case == "tap_without_hits":
        found[:, 5] = False
        found[:, :, 64:128] = False
    dout = torch.randn(B, idx.shape[-1], 64, device=cuda)
    df, dw = _hold_join_grads(feats, idx, found, w, dout)
    hits, counts = sgg.rulebook_hits(idx, found, feats.shape[-2])
    assert bool((df[~valid] == 0).all())
    if case == "tap_without_hits":
        assert int(counts[5]) == 0 and bool((dw[5] == 0).all())
    if case == "many_parts":
        fn = sgg._build.function("sparse_join_grad", "tap_grad_parts",
                                 (sgg._I,) * 5)
        parts = fn(B, idx.shape[-1], 27, 32, 64)
        assert parts > 1 and int(counts.min()) >= 2 * parts
        assert int(counts.max()) > 2 * 32 * parts
    if case == "unbatched":
        # an element alone: its dfeatures bit for bit the batched call's
        one_f, _ = _hold_join_grads(feats[1], idx[1], found[1], w, dout[1])
        assert torch.equal(one_f, df[1])


@pytest.mark.parametrize("K,cin,cout,need_f", [
    (27, 128, 128, True), (27, 8, 128, True), (27, 128, 8, True),
    (27, 3, 6, False), (27, 24, 40, False)])
def test_sparse_join_backward_other_widths(cuda, K, cin, cout, need_f):
    """Widths beyond the SECOND joins: two output tiles along Cin and
    Cout (128), the narrowest tiles, and rows that copy as 4-byte chunks
    (dW only where Cin is not a width of the dfeatures kernel)."""
    feats, idx, found, w, _ = _gather_join(cuda, K, cin, cout)
    dout = torch.randn(idx.shape[0], idx.shape[-1], cout, device=cuda)
    _hold_join_grads(feats, idx, found, w, dout, need_f)


@pytest.mark.parametrize("family", ["gather", "strided"])
def test_rulebook_hits_kernel_equals_plain(cuda, family):
    """The compaction: each tap's hits (feature row, dout row) in
    ascending dout row and their count, equal to the row-ordered
    ``nonzero`` of ``found`` (the plain version); entries out of range
    clipped where found."""
    feats, coords, valid, _, _, w, grid, kernel = _sparse_join(cuda, 27, 16,
                                                               16)
    if family == "strided":
        layout = sparse_conv.build_strided_layout_merge(
            coords, valid, grid, (3, 3, 3), (2, 2, 2), (1, 1, 1), 1024)
        idx, found = layout.gather_idx, layout.found
    else:
        rb = sparse_conv.build_submanifold_rulebook_merge(coords, valid, grid,
                                                          kernel)
        idx, found = rb.gather_idx.clone(), rb.found
        idx[:, :, ::7] = -5                      # clipped where found
    N = feats.shape[1]
    before = sgg.rulebook_hits.launches
    hits, counts = sgg.rulebook_hits(idx, found, N)
    ref, ref_counts = sgg.rulebook_hits_plain(idx.cpu(), found.cpu(), N)
    torch.cuda.synchronize()
    assert sgg.rulebook_hits.launches == before + 1
    assert torch.equal(counts.cpu(), ref_counts)
    assert int(counts.sum()) == int(found.sum()) > 0
    for k in range(27):
        n = int(counts[k])
        assert torch.equal(hits[k, :n].cpu(), ref[k, :n])


@pytest.mark.parametrize("case", ["sorted", "unsorted", "sentinels",
                                  "one_element", "unbatched", "strided"])
def test_keymatch_rulebook_kernel_equals_plain(cuda, case):
    """The key-match backward's rulebook by its hash table lookup
    against ``_merge_lookup`` (the plain version): ``found`` equal, ``idx``
    equal where found; key-sorted sites, unsorted keys, absent keys and
    sentinel queries, B = 1, the unbatched form, a strided join's query
    keys."""
    feats, coords, valid, in_keys, q_keys, w, grid, kernel = _sparse_join(
        cuda, 27, 16, 16, sort_keys=case != "unsorted",
        B=1 if case == "one_element" else 2)
    if case == "sentinels":
        q_keys = q_keys.clone()
        q_keys[..., 64:96] = 12 * 40 * 40 + 7      # outside the grid's keys
        q_keys[..., 96:128] = sparse_conv.INT32_MAX
    if case == "strided":
        sites = sparse_conv.build_strided_sites(coords, valid, grid,
                                                (3, 3, 3), (2, 2, 2),
                                                (1, 1, 1), 1024)
        q_keys = sparse_conv.strided_tap_keys(sites, grid, (3, 3, 3),
                                              (2, 2, 2), (1, 1, 1))
    if case == "unbatched":
        in_keys, q_keys = in_keys[1], q_keys[1]
    before = sgg.keymatch_rulebook.launches
    idx, found = sgg.keymatch_rulebook(in_keys, q_keys)
    ref_idx, ref_found = sgg.keymatch_rulebook_plain(in_keys, q_keys)
    torch.cuda.synchronize()
    assert sgg.keymatch_rulebook.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == q_keys.shape
    assert torch.equal(found, ref_found) and bool(found.any())
    assert torch.equal(idx[found], ref_idx[found])
    if case == "sentinels":
        assert not bool(found[..., 64:128].any())


def test_rulebook_inverse_kernel_counts_collisions(cuda):
    """A rulebook that is no convolution's (two rows of a tap read one
    input row): the inverse kernel counts the entry it cannot place;
    elsewhere it equals the plain inverse."""
    idx = torch.tensor([[[0, 1, 2, 3], [3, 3, 0, 1]]], dtype=torch.int32,
                       device=cuda)
    found = torch.tensor([[[1, 1, 0, 1], [1, 1, 1, 0]]], dtype=torch.bool,
                         device=cuda)
    before = sgg.rulebook_collisions(cuda)
    inv = sgg.rulebook_inverse(idx, found, 5)
    assert sgg.rulebook_collisions(cuda) == before + 1
    ref = sgg.rulebook_inverse_plain(idx, found, 5)
    assert torch.equal(inv >= 0, ref >= 0)
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


# --------------------------------------------------------------------------
# KITTI PointPillars
# --------------------------------------------------------------------------

@pytest.mark.parametrize("V", chip_smoke.PP_BUCKETS)
def test_pillar_scatter_at_the_kitti_buckets(cuda, V):
    """K1 at pointpillars/car/xyres_16's shapes (a 496 x 432 canvas, 64
    channels, each bucket's V, B = 2, rows past a scan's pillars padded):
    the canvas equals the plain version's, and its autograd backward (the
    gather kernel) gives the plain version's gradient, bit for bit."""
    g = torch.Generator().manual_seed(V)
    B, C, hw = 2, 64, 496 * 432
    lin = torch.full((B, V), hw, dtype=torch.int32)
    for b, n in enumerate((V, V - 777)):
        lin[b, :n] = torch.randperm(hw, generator=g)[:n].sort().values
    feats = torch.randn(B, V, C, generator=g).to(cuda).requires_grad_()
    plain_feats = feats.detach().clone().requires_grad_()
    lin = lin.to(cuda)
    dcanvas = torch.randn(B, hw, C, generator=g).to(cuda)
    before = (pillar_scatter.scatter_sorted_to_canvas.launches,
              pillar_scatter.pillar_gather.launches)
    with torch.enable_grad():
        got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
        ref = pillar_scatter.scatter_sorted_to_canvas_plain(plain_feats,
                                                            lin, hw)
        got.backward(dcanvas)
        ref.backward(dcanvas)
    torch.cuda.synchronize()
    assert (pillar_scatter.scatter_sorted_to_canvas.launches,
            pillar_scatter.pillar_gather.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert torch.equal(got, ref)
    assert torch.equal(feats.grad, plain_feats.grad)
    assert int((feats.grad[1, V - 777:] != 0).sum()) == 0


def test_kitti_pillar_request_at_b8_matches_cpu(cuda, tmp_path):
    """pointpillars/car/xyres_16.config at full width through PodInference
    at B = 8 with the trainer's seed-0 initial weights
    (``chip_smoke.kitti_pod``) on eight validation frames of a synthetic
    KITTI clone: detections equal the CPU run's as sets, heads within
    HEAD_TOL."""
    from automatic_as_built_reconstruction_tpu_torch.data import synth_kitti
    from automatic_as_built_reconstruction_tpu_torch.parallel.inference \
        import detections_mismatch

    synth_kitti.write_clone(tmp_path, 2, 8, seed=0)
    request = chip_smoke.kitti_requests(tmp_path, 1, 8)[0]
    gpu, cpu = chip_smoke.kitti_pod("cuda"), chip_smoke.kitti_pod("cpu")
    before = pillar_scatter.scatter_sorted_to_canvas.launches
    out = gpu(*request)
    assert pillar_scatter.scatter_sorted_to_canvas.launches == before + 1
    ref = cpu(*request)
    assert out["valid"].shape[0] == 8 and ref["valid"].any(-1).all()
    assert detections_mismatch(out, ref, 1, chip_smoke.BOX_ATOL,
                               chip_smoke.SCORE_ATOL) is None
    got, want = gpu.heads(*request), cpu.heads(*request)
    for name in want:
        assert torch.allclose(got[name].float().cpu(), want[name],
                              **chip_smoke.HEAD_TOL), name


def test_exported_pillar_pod_launches_the_kernels(cuda):
    """A served program exported on the card (``utils/serving_export.py``,
    the tiny as-built config with seeded weights), saved to bytes and
    reloaded, launches K1 and K2 on the wrappers' counters and gives the
    eager pod's detections; the caller's TF32 flags stay as they were."""
    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.parallel import (
        pod_inference_from_checkpoint)
    from automatic_as_built_reconstruction_tpu_torch.parallel.inference \
        import detections_mismatch
    from automatic_as_built_reconstruction_tpu_torch.utils import (
        serving_export)

    config = chip_smoke.CONFIG.parent / "asbuilt_pillars_tiny.config"
    pod = pod_inference_from_checkpoint(config, None, device="cuda",
                                        max_voxels=2048,
                                        max_points_per_voxel=16)
    pts, nv = pad_batch([generate_building_scene(s)["points"][::4]
                         for s in (5, 6)])
    flags = chip_smoke.tf32_flags()
    art = serving_export.load_serving(serving_export.export_serving(
        pod, *pts.shape[:2]))
    assert art.meta["platforms"] == ["cuda"]
    want = pod(pts, nv)
    chip_smoke.zero_counts()
    got = art(pts, nv)
    torch.cuda.synchronize()
    counts = chip_smoke.launch_counts()
    assert counts["pillar_scatter"] == 1 and counts["rotated_iou"] >= 1
    assert chip_smoke.tf32_flags() == flags
    assert detections_mismatch(got, want, pod.cfg.num_class,
                               chip_smoke.BOX_ATOL,
                               chip_smoke.SCORE_ATOL) is None
    assert want["valid"].any()


def test_two_train_runs_give_equal_parameters(cuda, tmp_path):
    """Two 3-step ``train()`` runs of ``asbuilt_pillars.config`` from one
    seed and one batch stream give the same parameters and losses, bit
    for bit (the training step runs cuDNN's deterministic algorithms)."""
    from automatic_as_built_reconstruction_tpu_torch.train import (
        train as train_mod)

    runs = []
    for name in ("a", "b"):
        state = train_mod.train(chip_smoke.CONFIG, tmp_path / name,
                                max_steps=3, display_step=1, device="cuda")
        runs.append(({k: v.cpu() for k, v in
                      state.model.state_dict().items()},
                     chip_smoke.train_losses(tmp_path / name)))
    (a, la), (b, lb) = runs
    assert la == lb and len(la) == 3
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.backends.cudnn.deterministic
