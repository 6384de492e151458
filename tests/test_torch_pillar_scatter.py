"""K1 on the CPU: the port's ``PointPillarsScatter`` against the JAX
module (both of its lowerings; the Pallas one in interpret mode) with
padding rows that carry NaN and 1e30 features, its gradient against the
JAX ``vjp``, the kernels' launch plans at the shapes the main paths give
them, and ``pillar_scatter_ablation.py``'s substitutions.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).

Every comparison is exact: the scatter and its gradient are copies.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.models.pointpillars import (
    PointPillarsScatter as JaxScatter)
from automatic_as_built_reconstruction_tpu_torch.models.pointpillars import (
    PointPillarsScatter)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, pillar_scatter)

H, W, F = 40, 45, 32          # hw = 1800: two Pallas tiles of 1024 cells
H100_SMS = 132


def padded_pillars(seed: int, sort: bool):
    """voxel_features [2, V, F] float32 and coords [2, V, 3] int32: each
    scan's occupied cells (unique; ascending where ``sort``, as the Pallas
    lowering needs), then -1 padding rows whose features are NaN and
    1e30."""
    rng = np.random.default_rng(seed)
    V = 1300
    vf = rng.standard_normal((2, V, F)).astype(np.float32)
    coords = np.full((2, V, 3), -1, np.int32)
    for b, n in enumerate((1200, 700)):
        cells = rng.choice(H * W, n, replace=False)
        if sort:
            cells.sort()
        coords[b, :n, 0] = 0
        coords[b, :n, 1] = cells // W
        coords[b, :n, 2] = cells % W
        vf[b, n::2] = np.nan
        vf[b, n + 1::2] = 1e30
    if not sort:
        perm = rng.permutation(V)          # padding rows in between
        vf, coords = vf[:, perm], coords[:, perm]
    return vf, coords


def port_canvas(vf, coords):
    """The port module's canvas (as [B, H, W, F]) and the gradient of
    sum(canvas * cotangent) to ``vf``, for a cotangent from a seed."""
    feats = torch.from_numpy(vf).requires_grad_(True)
    canvas = PointPillarsScatter((H, W))(feats, torch.from_numpy(coords))
    assert canvas.shape == (2, F, H, W)
    nhwc = canvas.permute(0, 2, 3, 1)
    cot = np.random.default_rng(9).standard_normal(nhwc.shape).astype(
        np.float32)
    (nhwc * torch.from_numpy(cot)).sum().backward()
    return nhwc.detach().numpy(), feats.grad.numpy(), cot


@pytest.mark.parametrize("lowering", ["xla", "pallas"])
def test_scatter_module_equals_jax_with_nan_padding_rows(lowering):
    """Padding rows holding NaN and 1e30 reach neither the port's canvas
    nor the JAX module's; the canvases are equal bit for bit."""
    vf, coords = padded_pillars(0, sort=True)
    module = JaxScatter(output_shape=(H, W), num_input_features=F,
                        sorted_pallas=lowering == "pallas")
    ref = np.asarray(module.apply({}, jnp.asarray(vf), jnp.asarray(coords)))
    got, _, _ = port_canvas(vf, coords)
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)
    assert int((got != 0).any(-1).sum()) == 1200 + 700


@pytest.mark.parametrize("sort", [True, False])
def test_scatter_module_gradient_equals_jax_vjp(sort):
    """The gradient to the features, against the JAX module's ``vjp``
    (its XLA lowering, which training uses): exact, and exactly 0 on the
    padding rows that hold NaN and 1e30; in key order and with the rows
    shuffled."""
    vf, coords = padded_pillars(1, sort)
    module = JaxScatter(output_shape=(H, W), num_input_features=F)
    got, grad, cot = port_canvas(vf, coords)
    out, vjp = jax.vjp(lambda x: module.apply({}, x, jnp.asarray(coords)),
                       jnp.asarray(vf))
    np.testing.assert_array_equal(got, np.asarray(out))
    (ref,) = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(grad, np.asarray(ref))
    padding = coords[..., 1] < 0
    assert padding.sum() == 2 * 1300 - 1200 - 700
    assert (grad[padding] == 0).all() and np.isfinite(grad).all()
    assert (np.abs(grad[~padding]).sum(-1) > 0).all()


def test_cpu_tensors_take_the_plain_version():
    vf, coords = padded_pillars(2, sort=False)
    before = (pillar_scatter.scatter_sorted_to_canvas.launches,
              pillar_scatter.pillar_gather.launches)
    port_canvas(vf, coords)
    assert (pillar_scatter.scatter_sorted_to_canvas.launches,
            pillar_scatter.pillar_gather.launches) == before


def tile_cells(hw: int, plan) -> list:
    """The cells each tile of a scan owns under ``plan``, as
    csrc/pillar_scatter.cu counts them: whole granules dealt in turn, the
    scan's last one possibly short."""
    g = pillar_scatter.SCATTER_GRANULE
    granules = -(-hw // g)
    cells = []
    for t in range(plan.tiles):
        owned = (granules - 1 - t) // plan.tiles + 1 if t < granules else 0
        last = owned and (granules - 1) % plan.tiles == t
        cells.append(owned * g - (granules * g - hw if last else 0))
    return cells


# (B, V, hw): the served as-built request; the KITTI buckets at training's
# B = 2 and serving's B = 8; the card tests' shapes (hw off the tiles, V
# above hw, V below a tile, B = 3); a canvas smaller than a tile
PLAN_SHAPES = [(2, 25600, 160 * 160), (2, 4000, 496 * 432),
               (2, 8000, 496 * 432), (2, 12000, 496 * 432),
               (8, 12000, 496 * 432), (2, 3000, 80 * 80),
               (2, 3000, 80 * 80 + 37), (3, 700, 601), (2, 2000, 1500),
               (2, 100, 4100), (1, 8, 16)]


@pytest.mark.parametrize("B,V,hw", PLAN_SHAPES)
def test_launch_plans_cover_the_canvas_and_the_rows(B, V, hw):
    """The tiles, granules dealt in turn, hold every cell of a scan once in
    whole clusters; each map holds its tile; no tile is empty (where the
    scan has a granule for each tile of a cluster); the tile of the scan's
    last granule is ragged where hw is not a multiple of the granule; the
    grid stays within a block an SM unless a map's size forces more.  The
    rows kernel and the backward give a thread to each chunk of a row.
    The plan takes the tiles up to SCATTER_TILES_MAX_BYTES of canvas."""
    ps = pillar_scatter
    plan = ps.tile_plan(B, hw, H100_SMS)
    cells = tile_cells(hw, plan)
    assert plan.route == "tiles" and plan.blocks == B * plan.tiles
    assert plan.tiles % ps.SCATTER_CLUSTER == 0
    assert sum(cells) == hw
    assert 0 <= plan.tile - max(cells) < ps.SCATTER_GRANULE
    assert plan.tile <= ps.SCATTER_MAX_TILE
    granules = -(-hw // ps.SCATTER_GRANULE)
    if granules >= ps.SCATTER_CLUSTER:
        assert min(cells) > 0                          # no empty tile
    last = cells[(granules - 1) % plan.tiles]          # owns the last one
    assert (last % ps.SCATTER_GRANULE) == (hw % ps.SCATTER_GRANULE)
    fewest = -(-granules * ps.SCATTER_GRANULE // ps.SCATTER_MAX_TILE)
    assert plan.blocks <= max(ps.SCATTER_BLOCKS_PER_SM * H100_SMS,
                              B * max(ps.SCATTER_CLUSTER, fewest + 1))
    for cw in (4, 8, 16):              # 64 bf16 or 32 float32; 64 float32
        route = ps.scatter_plan(B, V, hw, cw, H100_SMS)
        if B * hw * cw * 16 <= ps.SCATTER_TILES_MAX_BYTES:
            assert route == plan
        else:
            assert route.route == "rows"
            assert route.blocks * ps.ROWS_THREADS >= B * V * cw
            assert (route.blocks - 1) * ps.ROWS_THREADS < B * V * cw
        blocks = ps.gather_plan(B, V, cw)
        assert blocks * ps.GATHER_THREADS >= B * V * cw     # a thread a chunk
        assert (blocks - 1) * ps.GATHER_THREADS < B * V * cw


def test_plans_at_the_main_paths_shapes():
    """The served as-built request (a 13 MB canvas in float32, 6.5 MB in
    bfloat16) takes the tiles, 66 a scan of 24 or 25 granules (132 blocks,
    one an SM); a KITTI request of B = 8 (439 / 219 MB) and a KITTI
    training batch of B = 2 (110 / 55 MB) the fill and the rows kernel.
    The plans read the source's block, cluster and granule."""
    ps = pillar_scatter
    for cw in (16, 8):
        assert ps.scatter_plan(2, 25600, 25600, cw, H100_SMS) == (
            "tiles", 400, 66, 132)
    assert ps.scatter_plan(8, 12000, 214272, 16, H100_SMS) == (
        "rows", 0, 0, 6000)
    assert ps.scatter_plan(2, 12000, 214272, 8, H100_SMS).route == "rows"
    src = (_build.CSRC_DIR / "pillar_scatter.cu").read_text()
    for name, value in (("SCATTER_THREADS", ps.SCATTER_THREADS),
                        ("SCATTER_CLUSTER", ps.SCATTER_CLUSTER),
                        ("SCATTER_GRANULE", ps.SCATTER_GRANULE),
                        ("ROWS_THREADS", ps.ROWS_THREADS),
                        ("GATHER_THREADS", ps.GATHER_THREADS)):
        (found,) = re.findall(rf"#define {name} (\d+)", src)
        assert int(found) == value, name


def test_ablation_variants_follow_the_kernel_source():
    """``pillar_scatter_ablation.py``'s text substitutions each apply as
    often as they say to ``csrc/pillar_scatter.cu``, and each changes
    the source."""
    import pillar_scatter_ablation as ab

    sources = ab.variant_sources()
    base = sources["kernel"]
    assert base == ab.SOURCE.read_text()
    for name, (_, subs) in ab.VARIANTS.items():
        assert (sources[name] != base) == bool(subs), name
    assert set(ab.PROBES) < set(ab.VARIANTS)
    assert set(ab.SORTED_ONLY) < set(ab.VARIANTS)
