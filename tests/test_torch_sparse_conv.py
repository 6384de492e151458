"""Port vs JAX package: ``ops/sparse_conv.py`` — keys, plans, strided
sites, tap keys, the merge rulebook builders (all integer exact),
``scatter_to_bev``, and the plain sparse convs against the densified
``dense_conv3d`` oracle (atol 1e-4: a 27-tap x 8-channel fp32 sum in
another order).  Inputs are made with numpy from seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.models import (
    middle_plans as jax_plans)
from automatic_as_built_reconstruction_tpu.ops import sparse_conv as jsc
from automatic_as_built_reconstruction_tpu_torch.models import middle_plans
from automatic_as_built_reconstruction_tpu_torch.ops import sparse_conv as sc
from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import voxelize

GRID = (8, 12, 10)
INT32_MAX = np.iinfo(np.int32).max


def random_sites(rng, grid=GRID, n_active=60, n_pad=20, sort_keys=True):
    """coords [N, 3] int32 (z, y, x; -1 pad), valid [N]."""
    D, H, W = grid
    lin = rng.choice(D * H * W, n_active, replace=False)
    zyx = np.stack([lin // (H * W), (lin // W) % H, lin % W], 1)
    if sort_keys:
        zyx = zyx[np.argsort((zyx[:, 1] * W + zyx[:, 2]) * D + zyx[:, 0])]
    coords = np.concatenate([zyx, np.full((n_pad, 3), -1)]).astype(np.int32)
    valid = np.arange(n_active + n_pad) < n_active
    return coords, valid


def t(a):
    return torch.from_numpy(np.array(a))


def test_linearize_matches_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2, 14, (3, 50, 3)).astype(np.int32)
    got = sc.linearize(t(coords), GRID)
    ref = np.asarray(jsc.linearize(jnp.asarray(coords), GRID))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == INT32_MAX).any() and (ref != INT32_MAX).any()


def test_voxelizer_order_ascends_under_the_middle_key():
    """The voxelizer keys with gz = D; the middle with D + Z_PAD.  Both
    orders agree because z < D: the voxelizer's coords ascend strictly
    under the middle's key, as the key-match search needs."""
    rng = np.random.default_rng(1)
    pts = rng.uniform([0, -8, -2, 0], [16, 8, 2, 1], (2, 3000, 4)).astype(
        np.float32)
    vox = voxelize(t(pts), torch.tensor([3000, 2000]),
                   voxel_size=(1.0, 1.0, 0.5), pc_range=(0, -8, -2, 16, 8, 2),
                   grid_size=(16, 16, 8), max_points=4, max_voxels=2048)
    keys = sc.linearize(vox.coords, (8 + middle_plans.Z_PAD, 16, 16)).long()
    for b in range(2):
        n = int(vox.num_voxels[b])
        assert 100 < n < 2048
        assert (keys[b, 1:n] > keys[b, :n - 1]).all()
        assert (keys[b, n:] == INT32_MAX).all()


PLAN_CASES = {
    "fhd_caps": dict(grid=(41, 1600, 1408), v_cap=17000,
                     specs=jax_plans._FHD,
                     out_caps=(52096, 61184, 40320, 35328)),
    "fhd_heuristic": dict(grid=(41, 1600, 1408), v_cap=16384,
                          specs=jax_plans._FHD),
    "fhd_shrink": dict(grid=(41, 1600, 1408), v_cap=16384,
                       specs=jax_plans._FHD, capacity_shrink=0.6),
    "d4hd_tiny_grid": dict(grid=(41, 64, 64), v_cap=3000,
                           specs=jax_plans._D4HD),
    "caps_unrounded": dict(grid=(41, 64, 64), v_cap=1000,
                           specs=jax_plans._FHD_LITE,
                           out_caps=(1000, 777, 130, 129)),
}


@pytest.mark.parametrize("case", PLAN_CASES, ids=list(PLAN_CASES))
def test_plan_from_specs_matches_jax(case):
    kw = dict(PLAN_CASES[case])
    grid, v_cap, specs = kw.pop("grid"), kw.pop("v_cap"), kw.pop("specs")
    ref = jsc.plan_from_specs(grid, v_cap, specs, **kw)
    got = sc.plan_from_specs(grid, v_cap,
                             tuple(sc.BlockSpec(*s) for s in specs), **kw)
    assert got == ref            # tuples of equal fields
    assert [b.subm_channels for b in got] == [b.subm_channels for b in ref]
    assert sc.respec(got) == jsc.respec(ref)


def test_make_plan_and_plans_module_match_jax():
    args = ((8, 16, 16), 128, (8, 16), (1, 2), (2, 2), (1, 2))
    assert sc.make_plan(*args) == jsc.make_plan(*args)
    assert sc.make_plan(*args, out_caps=(1024, 128)) == jsc.make_plan(
        *args, out_caps=(1024, 128))
    with pytest.raises(ValueError):
        sc.make_plan(*args, out_caps=(1024,))
    with pytest.raises(ValueError):
        sc.plan_from_specs((2, 4, 4), 64, middle_plans._FHD)
    assert middle_plans.MIDDLE_PLANS == jax_plans.MIDDLE_PLANS
    for name in ("SpMiddleFHD", "SpMiddle2K", "nope"):
        for grid in ((40, 1600, 1408), (8, 16, 16)):
            assert (middle_plans.lookup(name, grid)
                    == jax_plans.lookup(name, grid))
    assert middle_plans.bev_channels(middle_plans._FHD,
                                     (40, 1600, 1408)) == 128
    assert middle_plans.xy_downsample(middle_plans._FHD) == 8


def test_measure_site_caps_matches_jax():
    rng = np.random.default_rng(2)
    grid = (41, 32, 32)
    scans = [random_sites(rng, grid, 300, 30)[0] for _ in range(3)]
    specs = jax_plans._FHD
    assert (sc.measure_site_caps(scans, grid, specs, safety=1.1)
            == jsc.measure_site_caps(scans, grid, specs, safety=1.1))


def _fhd_blocks_on(grid0):
    """(grid, kernel, stride, pad) of each _FHD block from grid0 down."""
    out, grid = [], grid0
    for s in jax_plans._FHD:
        out.append((grid, s.kernel, s.stride, s.pad))
        grid = jsc._out_grid(grid, s.pad, s.kernel, s.stride)
    return out


SITE_CASES = {f"fhd_block{i}": dict(zip(("grid", "kernel", "stride", "pad"),
                                        blk), max_out=1024)
              for i, blk in enumerate(_fhd_blocks_on((41, 24, 24)))}
SITE_CASES["overflow"] = dict(grid=GRID, kernel=(3, 3, 3), stride=(2, 2, 2),
                              pad=(1, 1, 1), max_out=48)
SITE_CASES["z_only_3x3x3"] = dict(grid=GRID, kernel=(3, 3, 3),
                                  stride=(2, 1, 1), pad=(1, 1, 1),
                                  max_out=512)


@pytest.mark.parametrize("case", SITE_CASES, ids=list(SITE_CASES))
def test_strided_sites_tap_keys_and_layout_match_jax(case):
    """Output sites (incl. truncation at max_out in key order), their tap
    query keys and the merge-built rulebook, integer exact, on a batch of
    two scans at once against the JAX functions scan by scan."""
    c = SITE_CASES[case]
    grid, geo = c["grid"], (c["kernel"], c["stride"], c["pad"])
    rng = np.random.default_rng(3)
    cells = int(np.prod(grid))
    scans = [random_sites(rng, grid, min(200, cells // 3), 24)
             for _ in range(2)]
    coords = np.stack([s[0] for s in scans])
    valid = np.stack([s[1] for s in scans])
    got_sites = sc.build_strided_sites(t(coords), t(valid), grid, *geo,
                                       c["max_out"])
    got_q = sc.strided_tap_keys(got_sites, grid, *geo)
    got_lay = sc.build_strided_layout_merge(t(coords), t(valid), grid, *geo,
                                            c["max_out"])
    for b in range(2):
        jc, jv = jnp.asarray(coords[b]), jnp.asarray(valid[b])
        ref = jsc.build_strided_sites(jc, jv, grid, *geo, c["max_out"])
        np.testing.assert_array_equal(got_sites.out_coords[b].numpy(),
                                      np.asarray(ref.out_coords))
        np.testing.assert_array_equal(got_sites.out_valid[b].numpy(),
                                      np.asarray(ref.out_valid))
        assert int(got_sites.num_out[b]) == int(ref.num_out)
        np.testing.assert_array_equal(
            got_q[b].numpy(),
            np.asarray(jsc.strided_tap_keys(ref, grid, *geo)))
        lay = jsc.build_strided_layout_merge(jc, jv, grid, *geo,
                                             c["max_out"])
        found = np.asarray(lay.found)
        np.testing.assert_array_equal(got_lay.found[b].numpy(), found)
        np.testing.assert_array_equal(got_lay.gather_idx[b].numpy()[found],
                                      np.asarray(lay.gather_idx)[found])
        np.testing.assert_array_equal(got_lay.out_coords[b].numpy(),
                                      np.asarray(lay.out_coords))
        assert found.any()
    if case == "overflow":
        exact = len(jsc.strided_out_sites_np(
            coords[0], grid, *geo, jsc._out_grid(grid, geo[2], geo[0],
                                                 geo[1])))
        assert exact > c["max_out"] == int(got_sites.num_out[0])
    else:
        assert (got_sites.num_out < c["max_out"]).all()


@pytest.mark.parametrize("sort_keys", [True, False],
                         ids=["key_order", "any_order"])
def test_subm_tap_keys_and_rulebook_match_jax(sort_keys):
    rng = np.random.default_rng(4)
    coords, valid = random_sites(rng, sort_keys=sort_keys)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    for kernel in ((3, 3, 3), (3, 1, 1)):
        got_q = sc.subm_tap_keys(t(coords), t(valid), GRID, kernel)
        np.testing.assert_array_equal(
            got_q.numpy(), np.asarray(jsc.subm_tap_keys(jc, jv, GRID,
                                                        kernel)))
        got = sc.build_submanifold_rulebook_merge(t(coords), t(valid), GRID,
                                                  kernel)
        ref = jsc.build_submanifold_rulebook_merge(jc, jv, GRID, kernel)
        found = np.asarray(ref.found)
        np.testing.assert_array_equal(got.found.numpy(), found)
        np.testing.assert_array_equal(got.gather_idx.numpy()[found],
                                      np.asarray(ref.gather_idx)[found])
        # the centre tap finds every valid site itself
        centre = int(np.prod(kernel)) // 2
        np.testing.assert_array_equal(got.gather_idx.numpy()[centre][valid],
                                      np.flatnonzero(valid))


def test_scatter_to_bev_and_densify_match_jax():
    rng = np.random.default_rng(5)
    coords, valid = random_sites(rng)
    feats = rng.normal(size=(len(valid), 6)).astype(np.float32)
    got = sc.scatter_to_bev(t(feats), t(coords), t(valid), GRID)
    ref = jsc.scatter_to_bev(jnp.asarray(feats), jnp.asarray(coords),
                             jnp.asarray(valid), GRID)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # channel d*C + c of cell (y, x) is feature c of site (d, y, x)
    z, y, x = coords[7]
    np.testing.assert_array_equal(got[y, x, z * 6:(z + 1) * 6].numpy(),
                                  feats[7])
    dense = sc.densify(t(feats), t(coords), t(valid), GRID)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jsc.densify(
            jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
            GRID)))
    # batched: the same scan twice
    both = sc.scatter_to_bev(t(np.stack([feats, feats])),
                             t(np.stack([coords, coords])),
                             t(np.stack([valid, valid])), GRID)
    np.testing.assert_array_equal(both[1].numpy(), np.asarray(ref))


def test_submanifold_conv_matches_dense_oracle_and_jax():
    rng = np.random.default_rng(6)
    coords, valid = random_sites(rng)
    feats = rng.normal(size=(len(valid), 8)).astype(np.float32)
    feats[~valid] = 0
    w = rng.normal(size=(27, 8, 16)).astype(np.float32)
    rb = sc.build_submanifold_rulebook_merge(t(coords), t(valid), GRID)
    got = sc.submanifold_conv(t(feats), rb, t(w), valid=t(valid))
    dense = sc.dense_conv3d(sc.densify(t(feats), t(coords), t(valid), GRID),
                            t(w), (3, 3, 3))
    z, y, x = coords[valid].T
    np.testing.assert_allclose(got.numpy()[valid], dense.numpy()[z, y, x],
                               rtol=1e-4, atol=1e-4)
    assert (got.numpy()[~valid] == 0).all()
    jrb = jsc.build_submanifold_rulebook_merge(
        jnp.asarray(coords), jnp.asarray(valid), GRID)
    ref = jsc.submanifold_conv(jnp.asarray(feats), jrb, jnp.asarray(w),
                               valid=jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kernel,stride,pad", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0))],
    ids=["k3s2p1", "k3s2_padz0", "z_collapse"])
def test_strided_conv_matches_dense_oracle_and_jax(kernel, stride, pad):
    rng = np.random.default_rng(7)
    coords, valid = random_sites(rng)
    feats = rng.normal(size=(len(valid), 8)).astype(np.float32)
    feats[~valid] = 0
    T = int(np.prod(kernel))
    w = rng.normal(size=(T, 8, 16)).astype(np.float32)
    layout = sc.build_strided_layout_merge(t(coords), t(valid), GRID, kernel,
                                           stride, pad, 512)
    got = sc.strided_sparse_conv(t(feats), layout, t(w))
    dense = sc.dense_conv3d(sc.densify(t(feats), t(coords), t(valid), GRID),
                            t(w), kernel, stride, pad)
    ov = layout.out_valid.numpy()
    z, y, x = layout.out_coords.numpy()[ov].T
    np.testing.assert_allclose(got.numpy()[ov], dense.numpy()[z, y, x],
                               rtol=1e-4, atol=1e-4)
    # every non-zero dense output cell is one of the sparse output sites
    assert int((np.abs(dense.numpy()).sum(-1) > 0).sum()) <= int(ov.sum())
    assert (got.numpy()[~ov] == 0).all()
    jl = jsc.build_strided_layout_merge(
        jnp.asarray(coords), jnp.asarray(valid), GRID, kernel, stride, pad,
        512)
    ref = jsc.strided_sparse_conv(jnp.asarray(feats), jl, jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jsc.dense_conv3d(
            jsc.densify(jnp.asarray(feats), jnp.asarray(coords),
                        jnp.asarray(valid), GRID),
            jnp.asarray(w), kernel, stride, [p for p in pad])),
        rtol=1e-4, atol=1e-4)
