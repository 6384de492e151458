"""The sparse builders and operators of the port that no shipped config
runs, against the JAX package's ``ops/sparse_conv.py``: the binary-search
and dense-LUT rulebook builders (submanifold and strided),
``sparse_max_pool``, ``inverse_sparse_conv``; and the host rulebooks of
``static_shape_buckets`` (``pad_rulebooks_to_plan``, the loader's merge
with per-bucket plans).

Sites are seeded random coordinates on small grids, with padding rows,
and batched (a leading axis) on the port's side.  Integers (sites, keep
sets, gather indices) must be equal exactly; float outputs rtol = atol =
1e-5 (float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.ops import (
    rulebook_host as jax_rulebook_host, sparse_conv as jsc)
from automatic_as_built_reconstruction_tpu.train import (
    input_pipeline as jax_input_pipeline)
from automatic_as_built_reconstruction_tpu_torch.data import batching
from automatic_as_built_reconstruction_tpu_torch.ops import (
    rulebook_host, sparse_conv as sc)
from automatic_as_built_reconstruction_tpu_torch.train import input_pipeline

GRID = (6, 10, 12)
TOL = dict(rtol=1e-5, atol=1e-5)
STRIDED = [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
           ((3, 3, 3), (2, 1, 1), (1, 1, 1)),
           ((3, 1, 1), (2, 1, 1), (0, 0, 0))]


def random_sites(seed: int, n_active: int = 90, n_pad: int = 14):
    """``n_active`` distinct sites of GRID in a random order, then padding
    rows (-1): (coords [N, 3] int32, valid [N] bool)."""
    rng = np.random.default_rng(seed)
    D, H, W = GRID
    lin = rng.choice(D * H * W, n_active, replace=False)
    zyx = np.stack([lin // (H * W), (lin // W) % H, lin % W], 1)
    coords = np.concatenate([zyx, np.full((n_pad, 3), -1)]).astype(np.int32)
    return coords, coords[:, 0] >= 0


def batched(seeds):
    """Port tensors of several scans stacked on a leading axis, and each
    scan's numpy arrays."""
    scans = [random_sites(s) for s in seeds]
    return (torch.from_numpy(np.stack([c for c, _ in scans])),
            torch.from_numpy(np.stack([v for _, v in scans])), scans)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("builder", ["binary", "lut"])
def test_submanifold_builders_match_jax(builder):
    """Every entry of ``gather_idx`` and ``found``, for each scan of a
    batch, against the JAX builder of the same kind; ``found`` equal to
    the port's merge builder's and ``gather_idx`` equal where found."""
    port_fn = {"binary": sc.build_submanifold_rulebook,
               "lut": sc.build_submanifold_rulebook_lut}[builder]
    jax_fn = {"binary": jsc.build_submanifold_rulebook,
              "lut": jsc.build_submanifold_rulebook_lut}[builder]
    coords, valid, scans = batched([0, 1, 2])
    got = port_fn(coords, valid, GRID)
    merge = sc.build_submanifold_rulebook_merge(coords, valid, GRID)
    for b, (c, v) in enumerate(scans):
        want = jax_fn(jnp.asarray(c), jnp.asarray(v), GRID)
        np.testing.assert_array_equal(got.found[b].numpy(), _np(want.found))
        np.testing.assert_array_equal(got.gather_idx[b].numpy(),
                                      _np(want.gather_idx))
    np.testing.assert_array_equal(got.found.numpy(), merge.found.numpy())
    hit = got.found.numpy()
    np.testing.assert_array_equal(got.gather_idx.numpy()[hit],
                                  merge.gather_idx.numpy()[hit])
    assert 100 < hit.sum() < hit.size
    assert got.gather_idx.dtype == torch.int32


@pytest.mark.parametrize("max_out", [400, 60], ids=["room", "truncated"])
@pytest.mark.parametrize("case", range(len(STRIDED)))
@pytest.mark.parametrize("builder", ["binary", "lut"])
def test_strided_builders_match_jax(builder, case, max_out):
    """Output sites (key order, truncated at ``max_out``), their count and
    every rulebook entry against the JAX builder of the same kind; the
    same sites and keep set as the port's merge builder."""
    kernel, stride, pad = STRIDED[case]
    port_fn = {"binary": sc.build_strided_layout,
               "lut": sc.build_strided_layout_lut}[builder]
    jax_fn = {"binary": jsc.build_strided_layout,
              "lut": jsc.build_strided_layout_lut}[builder]
    coords, valid, scans = batched([3, 4])
    got = port_fn(coords, valid, GRID, kernel, stride, pad, max_out)
    merge = sc.build_strided_layout_merge(coords, valid, GRID, kernel,
                                          stride, pad, max_out)
    for b, (c, v) in enumerate(scans):
        want = jax_fn(jnp.asarray(c), jnp.asarray(v), GRID, kernel, stride,
                      pad, max_out)
        for f in ("out_coords", "out_valid", "found", "gather_idx",
                  "num_out"):
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                          _np(getattr(want, f)), err_msg=f)
    for f in ("out_coords", "out_valid", "found", "num_out"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(merge, f).numpy(), err_msg=f)
    if max_out == 60:
        assert (got.num_out == 60).all()


def _layout_pair(seed):
    coords, valid, scans = batched([seed, seed + 1])
    kernel, stride, pad = STRIDED[0]
    got = sc.build_strided_layout(coords, valid, GRID, kernel, stride, pad,
                                  200)
    want = [jsc.build_strided_layout(jnp.asarray(c), jnp.asarray(v), GRID,
                                     kernel, stride, pad, 200)
            for c, v in scans]
    return got, want


def test_sparse_max_pool_matches_jax():
    """The max over each output site's active inputs (empty cells count
    for nothing, not 0); 0 at sites outside the layout."""
    got_layout, want_layouts = _layout_pair(5)
    rng = np.random.default_rng(5)
    feats = -np.abs(rng.normal(size=(2, 104, 6))).astype(np.float32) - 0.5
    got = sc.sparse_max_pool(torch.from_numpy(feats), got_layout)
    for b, layout in enumerate(want_layouts):
        want = jsc.sparse_max_pool(jnp.asarray(feats[b]), layout)
        np.testing.assert_array_equal(got[b].numpy(), _np(want))
    # the inputs are all negative: a max that took an empty cell as 0
    # would show
    valid = got_layout.out_valid.numpy()
    assert (got.numpy()[valid] < 0).all()
    assert (got.numpy()[~valid] == 0).all()


def test_inverse_sparse_conv_matches_jax():
    """The transpose of the strided conv through its saved layout, with
    and without a bias; and it is the strided conv's adjoint:
    <conv(x), y> == <x, inverse(y)>."""
    got_layout, want_layouts = _layout_pair(7)
    rng = np.random.default_rng(7)
    T = got_layout.found.shape[-2]
    down = rng.normal(size=(2, 200, 5)).astype(np.float32)
    w = rng.normal(size=(T, 5, 3)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    for b_arg in (None, bias):
        got = sc.inverse_sparse_conv(
            torch.from_numpy(down), got_layout, torch.from_numpy(w), 104,
            None if b_arg is None else torch.from_numpy(b_arg))
        for b, layout in enumerate(want_layouts):
            want = jsc.inverse_sparse_conv(
                jnp.asarray(down[b]), layout, jnp.asarray(w), 104,
                None if b_arg is None else jnp.asarray(b_arg))
            np.testing.assert_allclose(got[b].numpy(), _np(want), **TOL)
    x = torch.from_numpy(rng.normal(size=(2, 104, 3))).double()
    wt = torch.from_numpy(w).double().transpose(1, 2)        # [T, 3, 5]
    y = torch.from_numpy(down).double()
    y = torch.where(got_layout.out_valid[..., None], y, 0.0)
    fwd = sc.strided_sparse_conv(x, got_layout, wt)
    inv = sc.inverse_sparse_conv(y, got_layout, torch.from_numpy(w).double(),
                                 104)
    assert float((fwd * y).sum()) == pytest.approx(float((x * inv).sum()),
                                                   rel=1e-12)


# --------------------------------------------------------------------------
# host rulebooks with static_shape_buckets
# --------------------------------------------------------------------------

def _bucket_examples():
    """Two examples with host rulebooks at their own bucket's plan (one
    small, one large) and the plans of buckets 64 / 128 (both packages)."""
    grid = (9, 16, 16)
    specs = (sc.BlockSpec(1, 8, 8, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
             sc.BlockSpec(1, 8, 8, (3, 3, 3), (2, 1, 1), (1, 1, 1)))
    jspecs = tuple(jsc.BlockSpec(*s) for s in specs)
    buckets = (64, 128)
    plans = {b: sc.plan_from_specs(grid, b, specs) for b in buckets}
    jplans = {b: jsc.plan_from_specs(grid, b, jspecs) for b in buckets}
    rng = np.random.default_rng(11)
    examples = []
    for n in (40, 100):
        D, H, W = grid
        lin = rng.choice(D * H * W, n, replace=False)
        zyx = np.stack([lin // (H * W), (lin // W) % H, lin % W], 1)
        coords = np.full((128, 3), -1, np.int32)
        coords[:n] = zyx
        ex = {"voxels": rng.normal(size=(128, 5, 4)).astype(np.float32),
              "num_points": np.full((128,), 5, np.int32),
              "coordinates": coords, "num_voxels": np.asarray(n, np.int32)}
        bucket = batching.pick_bucket(n, buckets)
        ex.update(rulebook_host.build_middle_rulebooks(coords[:bucket],
                                                       plans[bucket]))
        want = jax_rulebook_host.build_middle_rulebooks(coords[:bucket],
                                                        jplans[bucket])
        for k, v in want.items():
            np.testing.assert_array_equal(ex[k], v, err_msg=k)
        examples.append(ex)
    return examples, plans, jplans


def test_pad_rulebooks_to_plan_matches_jax():
    """The small example's rulebooks padded to the large bucket's plan:
    the JAX package's arrays, key for key, and neutral padding."""
    examples, plans, jplans = _bucket_examples()
    got = batching.pad_rulebooks_to_plan(examples[0], plans[128])
    want = jax_batching.pad_rulebooks_to_plan(examples[0], jplans[128])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for i, blk in enumerate(plans[128]):
        assert got[f"rb{i}_subm_idx"].shape[-1] == blk.in_cap
        assert got[f"rb{i}_out_valid"].shape == (blk.out_cap,)
        n = examples[0][f"rb{i}_out_valid"].shape[0]
        assert not got[f"rb{i}_out_valid"][n:].any()
        assert (got[f"rb{i}_out_coords"][n:] == -1).all()


def test_loader_merges_bucketed_rulebooks_as_jax():
    """A batch of both examples through the loaders' merge with
    ``bucket_plans``: shrunk to the larger member's bucket, the smaller
    member's rulebooks padded to that bucket's plan, equal to the JAX
    loader's batch; without ``bucket_plans`` host-rulebook batches keep
    their full capacity, as the JAX loader keeps them."""
    examples, plans, jplans = _bucket_examples()

    class Queue(list):
        put = list.append

    # without bucket_plans the examples' rulebooks are the full plan's
    full = [batching.pad_rulebooks_to_plan(e, plans[128]) for e in examples]
    for tp, jp, exs in ((plans, jplans, examples), (None, None, full)):
        loader = input_pipeline.BatchLoader(None, 2, False,
                                            buckets=(64, 128),
                                            bucket_plans=tp)
        jloader = jax_input_pipeline.BatchLoader(None, 2, False,
                                                 buckets=(64, 128),
                                                 bucket_plans=jp)
        got = loader._merge([dict(e) for e in exs])
        q = Queue()
        jloader._emit(q, [dict(e) for e in exs])
        want = q[0]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got["voxels"].shape[1] == 128
    small = [examples[0], dict(examples[0])]
    got = input_pipeline.BatchLoader(None, 2, False, buckets=(64, 128),
                                     bucket_plans=plans)._merge(small)
    assert got["voxels"].shape[1] == 64
    assert got["rb0_subm_idx"].shape[-1] == plans[64][0].in_cap
