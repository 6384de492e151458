"""Port vs JAX package: the gradients of ``gather_gemm`` and
``keymatch_gemm`` against ``jax.grad`` of the reference's ``custom_vjp``
(its Pallas kernels in interpret mode, as ``test_torch_sparse_gemm.py``
runs them), in every call form, batched, with unsorted keys, sentinel
rows, a strided join and an input that needs no gradient.

On the CPU the port's wrappers run as autograd Functions over the plain
forward and ``join_backward_plain``.  The card's route (the rulebook's
inverse, then the forward gather-GEMM on ``W[k]^T``) is held here to the
plain backward through the plain versions of its two steps.

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


@pytest.mark.parametrize("strided", [False, True], ids=["subm", "strided"])
def test_the_card_route_for_dfeatures_is_the_plain_backward(strided):
    """dfeatures as the card computes it, through the plain versions of
    its steps: the rulebook's inverse (each input row at most once per
    tap, for a submanifold and a strided join alike), then the forward
    gather-GEMM on (dout, inverse, W[k]^T), batched."""
    probs = [padded_problem(s, strided=strided) for s in (40, 41)]
    idx, found = [], []
    for feats, coords, valid, *_ in probs:
        tc, tv = t(coords), t(valid)
        if strided:
            k, s, p, cap = STRIDED
            rb = sc.build_strided_layout_merge(tc, tv, GRID, k, s, p, cap)
        else:
            rb = sc.build_submanifold_rulebook_merge(tc, tv, GRID)
        idx.append(rb.gather_idx)
        found.append(rb.found)
    idx, found = torch.stack(idx), torch.stack(found)
    N = probs[0][0].shape[0]
    w = t(probs[0][5])
    dout = t(cotangent((2, idx.shape[-1], w.shape[2]), 42))
    inv, inv_found = sgg.rulebook_inverse_plain(idx, found, N)
    # a convolution's rulebook: the inverse holds every found entry once
    assert int(inv_found.sum()) == int(found.sum()) > 0
    rows = torch.gather(inv.long().clamp(min=0), -1,
                        idx.long().clamp(0, N - 1))
    r = torch.arange(idx.shape[-1]).expand(idx.shape)
    assert bool((rows == r)[found].all())
    # (the kernel reads inv = -1 as no source; the plain gather needs an
    # index in range where inv_found is false)
    via_inverse = sgg.gather_gemm_plain(dout, inv.clamp(min=0), inv_found,
                                        w.transpose(1, 2))
    want = sgg.grad_features_plain(dout, idx, found, w, N)
    np.testing.assert_allclose(via_inverse.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL_SHARE * float(want.abs().max()))
    assert torch.equal(sgg.join_grad_features(dout, idx, found, w, N), want)


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
