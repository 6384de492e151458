"""Port vs JAX package: the gradients of ``gather_gemm`` and
``keymatch_gemm`` against ``jax.grad`` of the reference's ``custom_vjp``
(its Pallas kernels in interpret mode, as ``test_torch_sparse_gemm.py``
runs them), in every call form, batched, with unsorted keys, sentinel
rows, a strided join and an input that needs no gradient.

On the CPU the port's wrappers run as autograd Functions over the plain
forward and ``join_backward_plain``.  The card's routes are held here to
the plain backward and to the JAX package's backward through the plain
versions of their steps: dfeatures as the rulebook's inverse, then each
input row's sum over the taps that hit it of ``dout[inv] @ W[k]^T``; dW
as the hits of each tap (the row-ordered ``nonzero`` of ``found``), then
``A^T D`` over them.

Tolerance: rtol 1e-5, atol 1e-5 x max|g| of the gradient (a 27-tap sum of
8- and 16-channel fp32 products taken in another order).
"""
import jax
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

from test_torch_sparse_conv import GRID, t
from test_torch_sparse_gemm import STRIDED, TILE, WINDOW, problem

RTOL, ATOL_SHARE = 1e-5, 1e-5


def assert_grad(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL_SHARE * scale, err_msg=what)


def padded_problem(seed, **kw):
    """``problem`` with nonzero features on the sentinel (pad) rows too:
    their gradient must still be the reference's."""
    feats, coords, valid, in_keys, q_keys, w = problem(seed, **kw)
    rng = np.random.default_rng(seed + 100)
    feats = np.where(valid[:, None], feats,
                     rng.normal(size=feats.shape)).astype(np.float32)
    return feats, coords, valid, in_keys, q_keys, w


def cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def port_grads(fn, feats, w, g, feats_grad=True):
    f = t(feats).requires_grad_(feats_grad)
    wt = t(w).requires_grad_()
    out = fn(f, wt)
    out.backward(t(g))
    return out, f.grad, wt.grad


KEYMATCH_FORMS = {
    "per_tap": dict(shared=False),
    "shared": dict(shared=True),
    "subwindow": dict(subwindow=WINDOW),
    "grouped": dict(subwindow=WINDOW, group=3),
}
KEYMATCH_CASES = {
    **{f"{k}_k27": dict(form=v) for k, v in KEYMATCH_FORMS.items()},
    "shared_strided": dict(form=dict(shared=True), strided=True),
    "grouped_strided": dict(form=dict(subwindow=WINDOW, group=3),
                            strided=True),
    "unsorted_in_keys": dict(form=dict(shared=True), sort_keys=False),
}


@pytest.mark.parametrize("case", KEYMATCH_CASES, ids=list(KEYMATCH_CASES))
def test_keymatch_gemm_grad_matches_jax(case):
    c = dict(KEYMATCH_CASES[case])
    form = c.pop("form")
    feats, _, valid, in_keys, q_keys, w = padded_problem(31, **c)
    group = form.get("group", 1)
    if group > 1:        # the caller permutes query keys and taps alike
        perm = sgg.group_perm(STRIDED[0] if c.get("strided")
                              else (3, 3, 3))
        q_keys, w = q_keys[perm], w[perm]
    args = (TILE, WINDOW, form.get("shared", True), form.get("subwindow", 0),
            group)
    g = cotangent((q_keys.shape[1], w.shape[2]), 32)
    ik, qk = jnp.asarray(in_keys), jnp.asarray(q_keys)

    def loss(f, wj):
        return jnp.sum(jsgg.keymatch_gemm(f, ik, qk, wj, True, *args) * g)

    jf, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                            jnp.asarray(w))
    _, df, dw = port_grads(lambda f, wt: sgg.keymatch_gemm(
        f, t(in_keys), t(q_keys), wt, None, *args), feats, w, g)
    assert_grad(df, jf, "dfeatures")
    assert_grad(dw, jw, "dW")
    # sentinel rows: exactly the reference's gradient (no key, no gradient)
    np.testing.assert_array_equal(df.numpy()[~valid], np.asarray(jf)[~valid])
    assert not df.numpy()[~valid].any() and df.numpy()[valid].any()
    if case == "unsorted_in_keys":
        assert (np.diff(in_keys.astype(np.int64)) < 0).any()


GATHER_CASES = {
    "shared_k27": dict(shared=True),
    "per_tap_k27": dict(shared=False),
    "shared_strided": dict(shared=True, strided=True),
}


def rulebook(coords, valid, strided):
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    if strided:
        k, s, p, cap = STRIDED
        return jsc.build_strided_layout_merge(jc, jv, GRID, k, s, p, cap)
    return jsc.build_submanifold_rulebook_merge(jc, jv, GRID, (3, 3, 3))


@pytest.mark.parametrize("case", GATHER_CASES, ids=list(GATHER_CASES))
def test_gather_gemm_grad_matches_jax(case):
    c = dict(GATHER_CASES[case])
    shared = c.pop("shared")
    feats, coords, valid, _, _, w = padded_problem(33, **c)
    rb = rulebook(coords, valid, c.get("strided", False))
    idx, found = np.asarray(rb.gather_idx), np.asarray(rb.found)
    g = cotangent((idx.shape[1], w.shape[2]), 34)

    def loss(f, wj):
        return jnp.sum(jsgg.gather_gemm(f, rb.gather_idx, rb.found, wj, True,
                                        TILE, WINDOW, shared) * g)

    jf, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                            jnp.asarray(w))
    _, df, dw = port_grads(lambda f, wt: sgg.gather_gemm(
        f, t(idx), t(found), wt, None, TILE, WINDOW, shared), feats, w, g)
    assert_grad(df, jf, "dfeatures")
    assert_grad(dw, jw, "dW")
    np.testing.assert_array_equal(df.numpy()[~valid], np.asarray(jf)[~valid])


@pytest.mark.parametrize("family", ["keymatch", "gather"])
def test_batched_grad_matches_jax_vmap(family):
    """Two different joins in one batched call against the reference
    mapped over the batch (the weights shared: dW sums the two)."""
    probs = [padded_problem(s) for s in (35, 36)]
    feats = np.stack([p[0] for p in probs])
    w = probs[0][5]
    g = cotangent((2, probs[0][4].shape[1], w.shape[2]), 37)
    if family == "keymatch":
        a = np.stack([p[3] for p in probs])
        b = np.stack([p[4] for p in probs])
        jfn = jax.vmap(lambda f, x, y, wj: jsgg.keymatch_gemm(
            f, x, y, wj, True, TILE, WINDOW), in_axes=(0, 0, 0, None))
        port = sgg.keymatch_gemm
    else:
        rbs = [rulebook(p[1], p[2], False) for p in probs]
        a = np.stack([np.asarray(r.gather_idx) for r in rbs])
        b = np.stack([np.asarray(r.found) for r in rbs])
        jfn = jax.vmap(lambda f, x, y, wj: jsgg.gather_gemm(
            f, x, y, wj, True, TILE, WINDOW), in_axes=(0, 0, 0, None))
        port = sgg.gather_gemm
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jf, jw = jax.grad(lambda f, wj: jnp.sum(jfn(f, ja, jb, wj) * g),
                      argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    _, df, dw = port_grads(lambda f, wt: port(f, t(a), t(b), wt), feats, w,
                           g)
    assert_grad(df, jf, "dfeatures")
    assert_grad(dw, jw, "dW")


def test_no_features_gradient_where_none_is_needed(monkeypatch):
    """The first join's input (the voxel means) needs no gradient: the
    backward computes dW only, equal to the reference's."""
    feats, _, _, in_keys, q_keys, w = padded_problem(38)
    g = cotangent((q_keys.shape[1], w.shape[2]), 39)
    ik, qk = jnp.asarray(in_keys), jnp.asarray(q_keys)
    jw = jax.grad(lambda wj: jnp.sum(jsgg.keymatch_gemm(
        jnp.asarray(feats), ik, qk, wj, True, TILE, WINDOW) * g))(
            jnp.asarray(w))

    def refuse(*args, **kwargs):
        raise AssertionError("dfeatures computed for an input that needs "
                             "no gradient")

    monkeypatch.setattr(sgg, "grad_features_plain", refuse)
    _, df, dw = port_grads(lambda f, wt: sgg.keymatch_gemm(
        f, t(in_keys), t(q_keys), wt), feats, w, g, feats_grad=False)
    assert df is None
    assert_grad(dw, jw, "dW")
    # and nothing is recorded where nothing requires grad
    out = sgg.keymatch_gemm(t(feats), t(in_keys), t(q_keys), t(w))
    assert out.grad_fn is None


def batched_rulebook(strided, seeds=(40, 41)):
    """Two problems' rulebooks stacked (the port's builders), their
    features, one weight set and a cotangent: (feats, idx, found, w, dout,
    the JAX rulebooks)."""
    probs = [padded_problem(s, strided=strided) for s in seeds]
    idx, found, jrb = [], [], []
    for feats, coords, valid, *_ in probs:
        tc, tv = t(coords), t(valid)
        if strided:
            k, s_, p, cap = STRIDED
            rb = sc.build_strided_layout_merge(tc, tv, GRID, k, s_, p, cap)
        else:
            rb = sc.build_submanifold_rulebook_merge(tc, tv, GRID)
        idx.append(rb.gather_idx)
        found.append(rb.found)
        jrb.append(rulebook(coords, valid, strided))
    idx, found = torch.stack(idx), torch.stack(found)
    feats = t(np.stack([p[0] for p in probs]))
    w = t(probs[0][5])
    dout = t(cotangent((2, idx.shape[-1], w.shape[2]), seeds[0] + 2))
    return feats, idx, found, w, dout, jrb


def jax_backward(feats, jrb, w, dout, shared=True):
    """(dfeatures, dW) of the JAX package's ``_gather_gemm_bwd`` mapped
    over the batch element by element (dW summed)."""
    dfs, dws = [], []
    for b, rb in enumerate(jrb):
        res = (jnp.asarray(feats[b].numpy()), rb.gather_idx, rb.found,
               jnp.asarray(w.numpy()))
        jf, _, _, jw = jsgg._gather_gemm_bwd(True, TILE, WINDOW, shared, res,
                                             jnp.asarray(dout[b].numpy()))
        dfs.append(np.asarray(jf))
        dws.append(np.asarray(jw))
    return np.stack(dfs), sum(dws)


@pytest.mark.parametrize("strided", [False, True], ids=["subm", "strided"])
def test_the_card_route_for_dfeatures_is_the_plain_backward(strided):
    """dfeatures as the card computes it, through the plain versions of
    its steps: the rulebook's inverse (each input row at most once per
    tap, for a submanifold and a strided join alike), then each input
    row's sum of ``dout[inv[k, j]] @ W[k]^T`` over the taps that hit it,
    in tap order, batched; against the plain backward and the JAX
    package's ``custom_vjp`` backward."""
    feats, idx, found, w, dout, jrb = batched_rulebook(strided)
    N = feats.shape[1]
    inv = sgg.rulebook_inverse_plain(idx, found, N)
    # a convolution's rulebook: the inverse holds every found entry once
    assert int((inv >= 0).sum()) == int(found.sum()) > 0
    rows = torch.gather(inv.long().clamp(min=0), -1,
                        idx.long().clamp(0, N - 1))
    r = torch.arange(idx.shape[-1]).expand(idx.shape)
    assert bool((rows == r)[found].all())
    via_inverse = sgg.grad_features_from_inverse_plain(dout, inv, w)
    want = sgg.grad_features_plain(dout, idx, found, w, N)
    np.testing.assert_allclose(via_inverse.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL_SHARE * float(want.abs().max()))
    assert_grad(via_inverse, jax_backward(feats, jrb, w, dout)[0],
                "dfeatures through the inverse")
    assert torch.equal(sgg.join_grad_features(dout, idx, found, w, N), want)


@pytest.mark.parametrize("strided", [False, True], ids=["subm", "strided"])
def test_the_card_route_for_dw_is_the_plain_backward(strided):
    """dW as the card computes it, through the plain versions of its
    steps: each tap's hits, which are the row-ordered ``nonzero`` of its
    ``found`` (feature row ``b N + j`` with j clipped, dout row ``b R +
    r``), then ``A^T D`` over them; against the plain backward and the
    JAX package's ``custom_vjp`` backward."""
    feats, idx, found, w, dout, jrb = batched_rulebook(strided)
    B, K, R = idx.shape
    N = feats.shape[1]
    hits, counts = sgg.rulebook_hits_plain(idx, found, N)
    assert hits.shape == (K, B * R, 2) and int(counts.sum()) == int(
        found.sum()) > 0
    for k in range(K):
        b, r = np.nonzero(found[:, k].numpy())
        n = int(counts[k])
        assert n == b.size
        j = np.clip(idx[:, k].numpy()[b, r], 0, N - 1)
        np.testing.assert_array_equal(hits[k, :n, 0].numpy(), b * N + j)
        np.testing.assert_array_equal(hits[k, :n, 1].numpy(), b * R + r)
        assert bool((hits[k, n:] == -1).all())
    via_hits = sgg.grad_weights_from_hits_plain(feats, dout, hits, counts)
    want = sgg.grad_weights_plain(feats, idx, found, dout)
    np.testing.assert_allclose(via_hits.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL_SHARE * float(want.abs().max()))
    assert_grad(via_hits, jax_backward(feats, jrb, w, dout)[1],
                "dW through the hits")
    assert torch.equal(sgg.join_grad_weights(feats, idx, found, dout), want)


def test_the_card_routes_clip_and_skip_like_the_reference():
    """Entries out of range are clipped to [0, N) where found and an entry
    not found adds nothing, in the hits and the inverse alike; a tap with
    no hit has an empty list and a zero dW."""
    rng = np.random.default_rng(44)
    B, N, K, R, ci, co = 2, 12, 4, 9, 4, 8
    feats = t(rng.normal(size=(B, N, ci)).astype(np.float32))
    idx = rng.integers(-3, N + 3, (B, K, R)).astype(np.int32)
    found = rng.random((B, K, R)) < 0.7
    found[:, 2] = False                            # a tap with no hit
    dout = t(rng.normal(size=(B, R, co)).astype(np.float32))
    hits, counts = sgg.rulebook_hits_plain(t(idx), t(found), N)
    assert int(counts[2]) == 0
    assert bool(((hits[..., 0] >= -1) & (hits[..., 0] < B * N)).all())
    dw = sgg.grad_weights_from_hits_plain(feats, dout, hits, counts)
    want = sgg.grad_weights_plain(feats, t(idx), t(found), dout)
    assert bool((dw[2] == 0).all())
    np.testing.assert_allclose(dw.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL_SHARE * float(want.abs().max()))
    # the inverse of a rulebook with one row a tap read at most once
    perm = np.stack([np.stack([rng.permutation(N)[:R] - 2 * (k == 0)
                               for k in range(K)]) for _ in range(B)])
    pidx = t(perm.astype(np.int32))
    pfound = t(found & (perm >= 0))
    inv = sgg.rulebook_inverse_plain(pidx, pfound, N)
    w = t(rng.normal(size=(K, ci, co)).astype(np.float32))
    np.testing.assert_allclose(
        sgg.grad_features_from_inverse_plain(dout, inv, w).numpy(),
        sgg.grad_features_plain(dout, pidx, pfound, w, N).numpy(),
        rtol=RTOL, atol=ATOL_SHARE * 10)


def test_keymatch_backward_looks_up_its_rulebook_once(monkeypatch):
    """The key-match backward joins on ``keymatch_rulebook`` (on the CPU
    its plain version, ``_merge_lookup``, as the reference's
    ``_keymatch_bwd`` looks it up): one lookup a backward, the rulebook
    the backward functions get."""
    feats, _, _, in_keys, q_keys, w = padded_problem(45)
    g = cotangent((q_keys.shape[1], w.shape[2]), 46)
    looked, joined = [], []
    lookup, grad_w = sgg.keymatch_rulebook, sgg.join_grad_weights

    def spy_lookup(*args):
        looked.append(lookup(*args))
        return looked[-1]

    def spy_grad_w(features, idx, found, dout):
        joined.append((idx, found))
        return grad_w(features, idx, found, dout)

    monkeypatch.setattr(sgg, "keymatch_rulebook", spy_lookup)
    monkeypatch.setattr(sgg, "join_grad_weights", spy_grad_w)
    port_grads(lambda f, wt: sgg.keymatch_gemm(f, t(in_keys), t(q_keys), wt),
               feats, w, g)
    assert len(looked) == len(joined) == 1
    assert joined[0][0] is looked[0][0] and joined[0][1] is looked[0][1]
    idx, hit = sc._merge_lookup(t(in_keys), t(q_keys).flatten())
    assert torch.equal(looked[0][1], hit.view(q_keys.shape))
    assert torch.equal(looked[0][0][looked[0][1]],
                       idx.view(q_keys.shape)[looked[0][1]])


def test_join_backward_plain_clips_and_masks_like_the_reference():
    """Entries out of range are clipped to [0, N) where found, and an
    entry not found adds nothing (``_gather_gemm_bwd``'s own lines)."""
    rng = np.random.default_rng(43)
    N, K, R, ci, co = 12, 3, 9, 4, 8
    feats = rng.normal(size=(N, ci)).astype(np.float32)
    idx = rng.integers(-3, N + 3, (K, R)).astype(np.int32)
    found = rng.random((K, R)) < 0.7
    w = rng.normal(size=(K, ci, co)).astype(np.float32)
    dout = rng.normal(size=(R, co)).astype(np.float32)
    res = (jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(found),
           jnp.asarray(w))
    jf, _, _, jw = jsgg._gather_gemm_bwd(True, TILE, WINDOW, True, res,
                                         jnp.asarray(dout))
    df, dw = sgg.join_backward_plain(t(feats), t(idx), t(found), t(w),
                                     t(dout))
    assert_grad(df, jf, "dfeatures")
    assert_grad(dw, jw, "dW")


def test_ablation_variants_follow_the_kernel_source():
    """``join_grad_ablation.py`` derives its timing variants from
    ``csrc/sparse_join_grad.cu``: a leave-out probe by text substitution,
    which must still apply exactly once and change the source; an
    alternative by a -D flag, which must name a tuning constant that the
    source guards with ``#ifndef`` and set it to another value than its
    default."""
    import re

    import join_grad_ablation as ablation

    sources = ablation.variant_sources()
    shipped = ablation.SOURCE.read_text()
    assert sources.pop("kernels") == shipped
    assert sources
    for name, src in sources.items():
        _, subs, defines = ablation.VARIANTS[name]
        assert bool(subs) != bool(defines), name
        if subs:
            assert src != shipped, name
        for macro, value in defines.items():
            default = re.search(rf"#ifndef {macro}\n#define {macro} (\d+)\n",
                                shipped)
            assert default and int(default.group(1)) != value, name
