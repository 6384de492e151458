"""Port vs JAX package: ``gather_gemm`` and ``keymatch_gemm`` in every
call form of the JAX functions.

On the CPU the port's wrappers take their plain versions.  The JAX
functions run their Pallas kernels in interpret mode: ``window`` equals
the padded table (80 rows at tile 8), so every tile's span fits and the
kernel body really runs (as ``tests/test_pallas_keymatch.py`` arranges).
atol 1e-5: a 27-tap x 8-channel fp32 sum taken in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.ops import sparse_conv as jsc
from automatic_as_built_reconstruction_tpu.ops.pallas import (
    sparse_gather_gemm as jsgg)
from automatic_as_built_reconstruction_tpu_torch.ops import sparse_conv as sc
from automatic_as_built_reconstruction_tpu_torch.ops import (
    sparse_gather_gemm as sgg)

from test_torch_sparse_conv import GRID, INT32_MAX, random_sites, t

ATOL = 1e-5
TILE, WINDOW = 8, 80          # 60 sites + 20 pad rows = one 80-row table
STRIDED = ((3, 3, 3), (2, 2, 2), (1, 1, 1), 48)


def problem(seed, kernel=(3, 3, 3), sort_keys=True, strided=False):
    """numpy (feats, coords, valid, in_keys, q_keys, weights) of one join."""
    rng = np.random.default_rng(seed)
    coords, valid = random_sites(rng, sort_keys=sort_keys)
    feats = rng.normal(size=(len(valid), 8)).astype(np.float32)
    feats[~valid] = 0
    tc, tv = t(coords), t(valid)
    in_keys = sc.linearize(tc, GRID).numpy()
    if strided:
        k, s, p, cap = STRIDED
        sites = sc.build_strided_sites(tc, tv, GRID, k, s, p, cap)
        q_keys = sc.strided_tap_keys(sites, GRID, k, s, p).numpy()
    else:
        q_keys = sc.subm_tap_keys(tc, tv, GRID, kernel).numpy()
    w = rng.normal(size=(q_keys.shape[0], 8, 16)).astype(np.float32)
    return feats, coords, valid, in_keys, q_keys, w


GATHER_CASES = {
    "shared_k27": dict(shared=True),
    "per_tap_k27": dict(shared=False),
    "shared_k3": dict(shared=True, kernel=(3, 1, 1)),
    "per_tap_k3": dict(shared=False, kernel=(3, 1, 1)),
    "shared_strided": dict(shared=True, strided=True),
    "xla_fallback_small_window": dict(shared=True, window=48),
}


@pytest.mark.parametrize("case", GATHER_CASES, ids=list(GATHER_CASES))
def test_gather_gemm_matches_jax(case):
    c = dict(GATHER_CASES[case])
    shared, window = c.pop("shared"), c.pop("window", WINDOW)
    feats, coords, valid, _, q_keys, w = problem(20, **c)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    if c.get("strided"):
        k, s, p, cap = STRIDED
        rb = jsc.build_strided_layout_merge(jc, jv, GRID, k, s, p, cap)
    else:
        rb = jsc.build_submanifold_rulebook_merge(
            jc, jv, GRID, c.get("kernel", (3, 3, 3)))
    idx, found = np.asarray(rb.gather_idx), np.asarray(rb.found)
    ref = jsgg.gather_gemm(jnp.asarray(feats), rb.gather_idx, rb.found,
                           jnp.asarray(w), True, TILE, window, shared)
    got = sgg.gather_gemm(t(feats), t(idx), t(found), t(w), None, TILE,
                          window, shared)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert found.any() and np.abs(np.asarray(ref)).max() > 1.0
    # batched form: the same join twice
    both = sgg.gather_gemm(t(np.stack([feats, feats])),
                           t(np.stack([idx, idx])),
                           t(np.stack([found, found])), t(w))
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())


KEYMATCH_CASES = {
    # the four JAX call forms, at K = 27 and K = 3
    "per_tap_k27": dict(form=dict(shared=False)),
    "shared_k27": dict(form=dict(shared=True)),
    "subwindow_k27": dict(form=dict(subwindow=WINDOW)),
    "grouped_k27": dict(form=dict(subwindow=WINDOW, group=3)),
    "per_tap_k3": dict(form=dict(shared=False), kernel=(3, 1, 1)),
    "shared_k3": dict(form=dict(shared=True), kernel=(3, 1, 1)),
    "subwindow_k3": dict(form=dict(subwindow=WINDOW), kernel=(3, 1, 1)),
    "grouped_k3": dict(form=dict(subwindow=WINDOW, group=3),
                       kernel=(3, 1, 1)),
    "shared_strided": dict(form=dict(shared=True), strided=True),
    "grouped_strided": dict(form=dict(subwindow=WINDOW, group=3),
                            strided=True),
    # JAX falls back to its exact XLA path; the port's answer is the same
    "subwindow_over_span": dict(form=dict(subwindow=32)),
    "unsorted_in_keys": dict(form=dict(shared=True), sort_keys=False),
    "all_sentinel_queries": dict(form=dict(shared=True), no_queries=True),
}


@pytest.mark.parametrize("case", KEYMATCH_CASES, ids=list(KEYMATCH_CASES))
def test_keymatch_gemm_matches_jax(case):
    c = dict(KEYMATCH_CASES[case])
    form, no_queries = c.pop("form"), c.pop("no_queries", False)
    feats, _, valid, in_keys, q_keys, w = problem(21, **c)
    if no_queries:
        q_keys = np.full_like(q_keys, INT32_MAX)
    group = form.get("group", 1)
    if group > 1:        # the caller permutes query keys and taps alike
        kernel = STRIDED[0] if c.get("strided") else c.get("kernel",
                                                           (3, 3, 3))
        perm = sgg.group_perm(kernel)
        np.testing.assert_array_equal(perm, jsgg.group_perm(kernel))
        q_keys, w = q_keys[perm], w[perm]
    args = (TILE, WINDOW, form.get("shared", True),
            form.get("subwindow", 0), group)
    ref = jsgg.keymatch_gemm(jnp.asarray(feats), jnp.asarray(in_keys),
                             jnp.asarray(q_keys), jnp.asarray(w), True,
                             *args)
    got = sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys), t(w), None,
                            *args)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    if no_queries:
        assert (got == 0).all()
    else:
        assert np.abs(np.asarray(ref)).max() > 1.0
    if case == "unsorted_in_keys":
        assert (np.diff(in_keys.astype(np.int64)) < 0).any()
    both = sgg.keymatch_gemm(t(np.stack([feats, feats])),
                             t(np.stack([in_keys, in_keys])),
                             t(np.stack([q_keys, q_keys])), t(w))
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())


def test_the_call_forms_give_one_result():
    """shared / per-tap / subwindow / grouped (with group_perm) are one
    function: equal to each other and to the rulebook join."""
    feats, coords, valid, in_keys, q_keys, w = problem(22)
    base = sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys), t(w))
    perm = sgg.group_perm((3, 3, 3))
    forms = [
        sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys), t(w), None, 64,
                          128, False),
        sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys), t(w), None, 256,
                          768, True, 384),
        sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys[perm]), t(w[perm]),
                          None, 256, 768, True, 384, 3)]
    for out in forms:
        np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=0,
                                   atol=ATOL)
    rb = sc.build_submanifold_rulebook_merge(t(coords), t(valid), GRID)
    np.testing.assert_allclose(
        sgg.gather_gemm(t(feats), rb.gather_idx, rb.found, t(w)).numpy(),
        base.numpy(), rtol=0, atol=ATOL)
    assert sgg.count_hits(t(in_keys), t(q_keys)) == int(rb.found.sum())


def test_wrappers_refuse_bad_shapes():
    feats, _, _, in_keys, q_keys, w = problem(23)
    with pytest.raises(ValueError):          # K of q_keys != K of weights
        sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys[:5]), t(w))
    with pytest.raises(ValueError):          # in_keys of another length
        sgg.keymatch_gemm(t(feats), t(in_keys[:-1]), t(q_keys), t(w))
    with pytest.raises(ValueError):          # group must divide K
        sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys), t(w), None, 8, 80,
                          True, 80, 4)
    with pytest.raises(ValueError):          # Cin of feats != Cin of weights
        sgg.gather_gemm(t(feats[:, :4]), t(q_keys), t(q_keys > 0), t(w))
    with pytest.raises(ValueError):          # found of another shape
        sgg.gather_gemm(t(feats), t(q_keys), t(q_keys[:, :-1] > 0), t(w))


# --------------------------------------------------------------------------
# The CUDA kernel's arithmetic, modelled on the CPU
# --------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives for finite x, and what the
    kernel computes for a split's big part."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by dropping the low 13 bits: how the tensor core reads
    an fp32 operand, the kernel's small parts."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_tf32_round_is_cvt_rna():
    one = 2.0 ** -10                 # a TF32 ulp at 1
    x = torch.tensor([1 + one / 2, 1 + 3 * one / 2, -(1 + one / 2),
                      1 + one / 2 - 2 ** -23, 3.0, -0.0], dtype=torch.float32)
    want = [1 + one, 1 + 2 * one, -(1 + one), 1.0, 3.0, -0.0]
    assert tf32_round(x).tolist() == want
    assert tf32_trunc(x).tolist() == [1.0, 1 + one, -1.0, 1.0, 3.0, -0.0]


def rz_to_fp32(s: torch.Tensor) -> torch.Tensor:
    """fp64 -> fp32 rounded toward zero: how the tensor core rounds the
    sum of an mma."""
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3,
                      partials: bool = True) -> torch.Tensor:
    """``a @ b`` as the kernel computes it on the tensor cores: k-steps of
    8 in ascending order, each mma adding its exact TF32 products to its
    input and rounding toward zero.  ``terms=3`` is the 3xTF32 split
    (a_small @ b_big, a_big @ b_small, then a_big @ b_big; big rounded to
    nearest, small truncated), ``terms=1`` single TF32 (a_big @ b_big).  With ``partials`` (the kernel) each
    k-step's mmas start from zero and their partial is added into the fp32
    accumulator with a round-to-nearest add; without, one accumulator is
    carried through every mma."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_trunc(a - a_big), tf32_trunc(b - b_big)
    pairs = [(a_small, b_big), (a_big, b_small), (a_big, b_big)][-terms:]
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        d = torch.zeros_like(acc) if partials else acc
        for x, y in pairs:
            d = rz_to_fp32(d.double() + x[:, s].double() @ y[s].double())
        acc = acc + d if partials else d
    return acc


def test_3xtf32_split_is_as_accurate_as_fp32():
    """The accuracy behind chip_smoke.py's GEMM_ATOL: at K = 27 taps of
    Cin = Cout = 64, order-1 values, the kernel's arithmetic stays within
    2e-6 of the fp64 product relative to its largest value, as an fp32
    matmul does; single TF32 does not (0.06 absolute), nor does 3xTF32
    with one accumulator carried through every mma, whose rounding toward
    zero drifts."""
    rng = np.random.default_rng(0)
    K, cin, cout, rows = 27, 64, 64, 256
    a = rng.normal(size=(rows, K * cin)).astype(np.float32)
    b = rng.normal(size=(K * cin, cout)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def rel_err(got):
        return np.abs(got.numpy().astype(np.float64) - exact).max() / scale

    kernel = rel_err(split_tf32_matmul(ta, tb))
    fp32 = rel_err(ta @ tb)
    single = rel_err(split_tf32_matmul(ta, tb, terms=1))
    carried = rel_err(split_tf32_matmul(ta, tb, partials=False))
    assert kernel <= 2e-6 and fp32 <= 2e-6
    assert single > 2e-6 and single * scale > 1e-4
    assert carried > 2e-6


def wgmma_bf16_matmul(a: torch.Tensor, b: torch.Tensor, K: int,
                      partials: bool = True) -> torch.Tensor:
    """``a @ b`` as the bfloat16 tile computes it on wgmma: ``a`` [rows,
    K * cin] and ``b`` [K * cin, cout] hold bf16 values (in float32), so
    every product is exact; per tap, k-steps of 16 in ascending order, each
    wgmma adding its exact products to its input and rounding toward
    zero.  With ``partials`` (the kernel) each tap's first k-step starts
    from zero and the tap's partial is added into the fp32 sums with a
    round-to-nearest add, taps in ascending order; without, one
    accumulator is carried through every k-step of every tap."""
    rows, cout = a.shape[0], b.shape[1]
    cin = a.shape[1] // K
    acc = torch.zeros(rows, cout)
    ad, bd = a.double(), b.double()
    for k in range(K):
        d = torch.zeros(rows, cout) if partials else acc
        for k0 in range(k * cin, (k + 1) * cin, 16):
            d = rz_to_fp32(d.double() + ad[:, k0:k0 + 16] @ bd[k0:k0 + 16])
        acc = acc + d if partials else d
    return acc


def test_bf16_tile_sums_stay_inside_the_bf16_tolerance():
    """The accuracy behind chip_smoke.py's BF16_GEMM_RTOL (1e-4 of max
    |out|) for the wgmma tile: at K = 27 taps of Cin = Cout = 64, order-1
    bf16 values, its per-tap partials (four truncating k-steps each,
    added to the sums rounded to nearest) lie within 5e-7 of the fp64
    product relative to its largest value (2.2e-7 here), as close as a
    float32 matmul (1.7e-7), 200 times inside the tolerance; one
    accumulator carried through all 27 taps drifts ten times as far
    (3.5e-6)."""
    rng = np.random.default_rng(0)
    K, cin, cout, rows = 27, 64, 64, 256
    a = torch.from_numpy(rng.normal(size=(rows, K * cin)).astype(
        np.float32)).bfloat16().float()
    b = torch.from_numpy(rng.normal(size=(K * cin, cout)).astype(
        np.float32)).bfloat16().float()
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())

    def rel_err(got):
        return float((got.double() - exact).abs().max()) / scale

    kernel = rel_err(wgmma_bf16_matmul(a, b, K))
    fp32 = rel_err(a @ b)
    carried = rel_err(wgmma_bf16_matmul(a, b, K, partials=False))
    assert kernel <= 5e-7 and fp32 <= 5e-7
    assert kernel * 200 <= 1e-4
    assert carried > 2e-6 and carried > 10 * kernel


def test_tile_occupancy_matches_a_brute_force_count():
    rng = np.random.default_rng(3)
    B, K, R, tile = 2, 27, 200, sgg.TILE_R   # R ragged: 3 tiles + 8 rows
    found = rng.random((B, K, R)) < 0.02
    found[0, :, 64:128] = False          # a tile where every tap misses
    hits, pairs, occ = sgg.tile_occupancy(torch.from_numpy(found))
    want_pairs = sum(bool(found[b, k, r0:r0 + tile].any())
                     for b in range(B) for k in range(K)
                     for r0 in range(0, R, tile))
    assert (hits, pairs) == (int(found.sum()), want_pairs)
    assert occ == pytest.approx(hits / (want_pairs * tile))
    # unbatched, and the key-match form of the same count
    assert sgg.tile_occupancy(torch.from_numpy(found[1]))[:2] == (
        int(found[1].sum()), sum(bool(found[1, k, r0:r0 + tile].any())
                                 for k in range(K)
                                 for r0 in range(0, R, tile)))
    feats, _, _, in_keys, q_keys, _ = problem(24)
    hit = sgg.keymatch_found(t(in_keys), t(q_keys))
    assert hit.shape == q_keys.shape
    assert int(hit.sum()) == sgg.count_hits(t(in_keys), t(q_keys)) > 0
    assert sgg.tile_occupancy(torch.zeros(27, 5, dtype=torch.bool)) == (
        0, 0, 0.0)


def test_ablation_variants_follow_the_kernel_source():
    """``sparse_gemm_ablation.py`` derives its timing variants of the
    float32 tile and of the bfloat16 tile from
    ``csrc/sparse_gather_gemm.cu`` by text substitution: each must still
    apply exactly once, and change the source."""
    import sparse_gemm_ablation

    shipped = sparse_gemm_ablation.SOURCE.read_text()
    for variants, unchanged in ((sparse_gemm_ablation.VARIANTS, "kernel"),
                                (sparse_gemm_ablation.BF16_VARIANTS,
                                 "bf16_kernel")):
        sources = sparse_gemm_ablation.variant_sources(variants)
        assert sources.pop(unchanged) == shipped
        assert sources and all(src != shipped for src in sources.values())
