"""Port vs JAX package: the fused voxelize+mean.  On the CPU the port's
``fused_voxelize_mean`` takes its plain version; it is held against the
JAX ``fused_voxelize_mean(..., interpret=True)`` on that kernel's own test
cases (tests/test_pallas_voxel_mean.py) and, bit for bit, against the
port's ``SimpleVoxel(voxelize(...))``.  The plain mirrors of the key
route's two kernels (``point_keys_plain``, ``segment_mean_plain``) are
held against ``slot_table`` and the JAX function; the kernels themselves
run only on the card (tests/test_torch_cuda.py).

Integers exact.  Features rtol 1e-6 + atol 1e-6 against JAX, as the JAX
test holds its kernel to its own unfused path: the Pallas body adds the T
points as one-hot matmuls, the plain version as one fp32 sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.ops.pallas import (
    voxel_mean as jax_voxel_mean)
from automatic_as_built_reconstruction_tpu_torch.models.voxel_encoder import (
    SimpleVoxel)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    voxel_mean, voxelize)
from automatic_as_built_reconstruction_tpu_torch.ops.voxel_mean import (
    FusedVoxelMeanResult)

from test_pallas_voxel_mean import KW
from test_torch_ops import _bits

CASES = [(5, 64), (8, 128), (1, 32)]


def scan_np(rng, p=800):
    """tests/test_pallas_voxel_mean.py::scan, as numpy."""
    return np.concatenate([
        rng.uniform(-1, 9, (p, 1)), rng.uniform(-5, 5, (p, 1)),
        rng.uniform(-3, 3, (p, 1)), rng.random((p, 1))],
        axis=1).astype(np.float32)


def _both(pts, n, T, V, first_appearance, **jax_kw):
    """One scan through the JAX kernel (interpret mode) and the port."""
    ref = jax_voxel_mean.fused_voxelize_mean(
        jnp.asarray(pts), jnp.int32(n), max_points=T, max_voxels=V,
        first_appearance=first_appearance, interpret=True, **jax_kw, **KW)
    before = voxel_mean.mean_from_table.launches
    got = voxel_mean.fused_voxelize_mean(
        torch.from_numpy(pts)[None], torch.tensor([n], dtype=torch.int32),
        max_points=T, max_voxels=V, first_appearance=first_appearance,
        **jax_kw, **KW)
    assert voxel_mean.mean_from_table.launches == before   # CPU: no kernel
    return got, ref


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.coords[0].numpy(),
                                  np.asarray(ref.coords))
    np.testing.assert_array_equal(got.num_points[0].numpy(),
                                  np.asarray(ref.num_points))
    assert int(got.num_voxels[0]) == int(ref.num_voxels)
    np.testing.assert_allclose(got.features[0].numpy(),
                               np.asarray(ref.features), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("first_appearance", [True, False],
                         ids=["first_appearance", "key_order"])
@pytest.mark.parametrize("T,V", CASES)
def test_plain_matches_jax_kernel(first_appearance, T, V):
    pts = scan_np(np.random.default_rng(T * 100 + V))
    got, ref = _both(pts, 600, T, V, first_appearance)
    _assert_same(got, ref)
    assert int(got.num_voxels[0]) == V          # the voxel cap truncates
    # (these scans are thin: two points in a cell at most)
    assert int(got.num_points.max()) == min(T, 2)


def test_empty_input_matches_jax_kernel():
    got, ref = _both(np.zeros((32, 4), np.float32), 0, 4, 16, True)
    _assert_same(got, ref)
    assert int(got.num_voxels[0]) == 0
    assert bool((got.features == 0).all()) and bool((got.coords == -1).all())


def test_tile_and_window_are_accepted_and_change_nothing():
    pts = scan_np(np.random.default_rng(42))
    got, ref = _both(pts, 600, 5, 64, False, tile=8, window=128)
    _assert_same(got, ref)
    base, _ = _both(pts, 600, 5, 64, False)
    assert torch.equal(got.features, base.features)


@pytest.mark.parametrize("first_appearance", [True, False],
                         ids=["first_appearance", "key_order"])
@pytest.mark.parametrize("T,V", CASES + [(24, 300)])
def test_plain_is_simple_voxel_of_voxelize_bit_for_bit(first_appearance, T,
                                                       V):
    """The contract, on a batch of two scans with different num_valid."""
    rng = np.random.default_rng(T + V)
    pts = np.stack([scan_np(rng), scan_np(rng)])
    # a cell over T: first in the scan and lowest in key order, so that
    # the voxel cap keeps it in both numberings
    pts[:, :60, :3] = rng.uniform([0, -4, -2], [0.5, -3.5, -1.5], (2, 60, 3))
    pts = torch.from_numpy(pts)
    nv = torch.tensor([800, 350], dtype=torch.int32)
    kw = dict(max_points=T, max_voxels=V, first_appearance=first_appearance,
              **KW)
    got = voxel_mean.fused_voxelize_mean_plain(pts, nv, **kw)
    vox = voxelize.voxelize(pts, nv, **kw)
    mean = SimpleVoxel(4)(vox.voxels, vox.num_points)
    np.testing.assert_array_equal(_bits(got.features.numpy()),
                                  _bits(mean.numpy()))
    assert torch.equal(got.coords, vox.coords)
    assert torch.equal(got.num_points, vox.num_points)
    assert torch.equal(got.num_voxels, vox.num_voxels)
    assert got.features.shape == (2, V, 4)
    assert int(got.num_points.max()) == T
    assert bool((got.features[got.num_points == 0] == 0).all())
    # fed to SimpleVoxel as one mean point per voxel it is the identity
    again = SimpleVoxel(4)(got.features[:, :, None, :],
                           got.num_points.clamp(max=1))
    np.testing.assert_array_equal(_bits(again.numpy()),
                                  _bits(got.features.numpy()))


def test_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError):
        voxel_mean.fused_voxelize_mean(
            torch.zeros(8, 4), torch.tensor([8]), max_points=2, max_voxels=4,
            **KW)
    with pytest.raises(ValueError):
        voxel_mean.fused_voxelize_mean(
            torch.zeros(1, 8, 2), torch.tensor([8]), max_points=2,
            max_voxels=4, **KW)


# --------------------------------------------------------------------------
# the key route's plain mirrors
# --------------------------------------------------------------------------

def awkward_batch(rng, T=5):
    """Two scans over KW's grid with a crowded cell, points on cell faces
    and on the grid's faces, NaN and inf coordinates, and another
    num_valid each.  -> (points [2, 800, 4], num_valid [2])."""
    pts = np.stack([scan_np(rng), scan_np(rng)])
    pts[:, 0, :3] = np.nan                # NaN -> cell 0: in range, first
    pts[:, 1:4, 0] = np.nan
    pts[:, 4:7, 1] = np.nan
    pts[:, 7:10, 2] = np.nan
    pts[:, 10:13, 0] = np.inf
    pts[:, 13:16, 1] = -np.inf
    pts[:, 16:56, :3] = rng.uniform([0, -4, -2], [0.5, -3.5, -1.5], (2, 40, 3))
    # faces: (p - r0) / vs is a whole number (0.5 m cells from (0, -4, -2))
    pts[:, 56:116, :3] = rng.integers(0, 17, (2, 60, 3)) * 0.5 + [0, -4, -2]
    return (torch.from_numpy(pts.astype(np.float32)),
            torch.tensor([800, 500], dtype=torch.int32))


def _sorted_keys(pts, nv):
    packed = voxel_mean.point_keys_plain(pts, nv, **KW)
    return torch.sort(packed, dim=1).values


def test_point_keys_sorted_give_the_slot_table_order_and_keys():
    """Sorting the packed values gives ``slot_table``'s stable order, and
    their high halves its keys (INT32_MAX for invalid points), exactly:
    NaN, inf, faces and the num_valid cut included."""
    pts, nv = awkward_batch(np.random.default_rng(7))
    before = voxel_mean.point_keys.launches
    packed = voxel_mean.point_keys(pts, nv, **KW)
    assert voxel_mean.point_keys.launches == before       # CPU: no kernel
    assert torch.equal(packed, voxel_mean.point_keys_plain(pts, nv, **KW))
    assert packed.dtype == torch.int64 and bool((packed >= 0).all())
    srt = torch.sort(packed, dim=1).values
    cell, tab = voxelize.slot_table(pts, nv, max_voxels=64,
                                    first_appearance=False, **KW)
    assert torch.equal(srt & 0xFFFFFFFF, tab.order)
    gx, _, gz = KW["grid_size"]
    c = torch.gather(cell, 1, tab.order[..., None].expand(-1, -1, 3)).long()
    key = torch.where(tab.svalid, (c[..., 1] * gx + c[..., 0]) * gz
                      + c[..., 2], voxelize.INT32_MAX)
    assert torch.equal(srt >> 32, key)
    # the batch exercises what it claims: an all-NaN point in cell
    # (0, 0, 0), inf out of range, points beyond num_valid cut
    assert (packed[:, 0] >> 32).eq(0).all()
    assert (packed[:, 10:16] >> 32).eq(voxelize.INT32_MAX).all()
    assert int(tab.svalid[1].sum()) < int(tab.svalid[0].sum())


@pytest.mark.parametrize("T,V", CASES + [(24, 300), (5, 2000)],
                         ids=lambda x: str(x))
def test_segment_mean_plain_coords_from_the_key_equal_slot_coords(T, V):
    """The sorted keys' segments give ``slot_table``'s counts, voxel
    count and, decoded from the key, ``_slot_coords``; the means equal
    ``fused_voxelize_mean_plain``'s (key order) within rtol = atol =
    1e-6 (t-order sums against torch.sum), NaN where a voxel holds one.
    V = 2000 is more slots than points."""
    pts, nv = awkward_batch(np.random.default_rng(T * 10 + V))
    srt = _sorted_keys(pts, nv)
    before = voxel_mean.segment_mean.launches
    got = voxel_mean.segment_mean(pts, srt, grid_size=KW["grid_size"],
                                  max_points=T, max_voxels=V)
    assert voxel_mean.segment_mean.launches == before     # CPU: no kernel
    cell, tab = voxelize.slot_table(pts, nv, max_voxels=V,
                                    first_appearance=False, **KW)
    assert torch.equal(got.coords, voxelize._slot_coords(cell, tab))
    assert torch.equal(got.num_points, tab.count.clamp(max=T))
    assert torch.equal(got.num_voxels, tab.num_voxels)
    ref = voxel_mean.fused_voxelize_mean_plain(
        pts, nv, max_points=T, max_voxels=V, first_appearance=False, **KW)
    assert torch.allclose(got.features, ref.features, rtol=1e-6, atol=1e-6,
                          equal_nan=True)
    assert bool(torch.isnan(got.features).any())
    assert bool((got.features[got.num_points == 0] == 0).all())
    assert int(got.num_points.max()) == T
    if V <= 128:
        assert got.num_voxels.tolist() == [V, V]     # the voxel cap cuts
    else:
        assert int(got.num_voxels.max()) < V


@pytest.mark.parametrize("T,V", CASES + [(24, 300)], ids=lambda x: str(x))
def test_segment_mean_plain_matches_jax_kernel(T, V):
    """The key route's plain mirrors against the JAX kernel (key order,
    interpret mode) scan by scan: integers exact, features rtol = atol =
    1e-6; faces and num_valid cuts included (no NaN: the JAX body's
    one-hot products spread a NaN over its whole tile)."""
    rng = np.random.default_rng(T * 7 + V)
    pts = np.stack([scan_np(rng), scan_np(rng)])
    pts[:, :40, :3] = rng.uniform([0, -4, -2], [0.5, -3.5, -1.5], (2, 40, 3))
    pts[:, 40:100, :3] = rng.integers(0, 17, (2, 60, 3)) * 0.5 + [0, -4, -2]
    nv = [800, 450]
    got = voxel_mean.segment_mean_plain(
        torch.from_numpy(pts), _sorted_keys(torch.from_numpy(pts),
                                            torch.tensor(nv)),
        grid_size=KW["grid_size"], max_points=T, max_voxels=V)
    for b in range(2):
        ref = jax_voxel_mean.fused_voxelize_mean(
            jnp.asarray(pts[b]), jnp.int32(nv[b]), max_points=T,
            max_voxels=V, first_appearance=False, interpret=True, **KW)
        _assert_same(FusedVoxelMeanResult(*(t[b:b + 1] for t in got)), ref)
    assert int(got.num_points.max()) == T


def test_ablation_variants_follow_the_kernel_source():
    """``voxel_mean_ablation.py``'s text substitutions each apply exactly
    once to ``csrc/voxel_mean.cu``, and each changes the source."""
    import voxel_mean_ablation

    sources = voxel_mean_ablation.variant_sources()
    base = sources["kernel"]
    assert base == voxel_mean_ablation.SOURCE.read_text()
    for name, (_, _, subs) in voxel_mean_ablation.VARIANTS.items():
        assert (sources[name] != base) == bool(subs), name
