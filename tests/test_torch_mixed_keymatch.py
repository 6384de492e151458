"""bfloat16 key-match SECOND (``car.fhd.config`` / ``car.fhd.serving
.config`` with ``enable_mixed_precision``): K4 on bfloat16 operands and the
port's bfloat16 key-match network, held to the JAX package on the CPU.

- K4 in bfloat16: the port's plain version (the bf16 inputs upcast, one
  float32 matmul) against the JAX package's ``keymatch_gemm`` on bf16
  features and weights with its Pallas kernels in interpret mode, in each
  call form (per-tap windows, shared window, subwindows, grouped taps with
  ``group_perm``, the XLA fallback, unsorted keys, no queries), within
  1e-4 of max |out|: the products are exact in float32 on both sides, the
  sums are taken in another order.
- The network: the micro twin of ``tests/test_torch_second_train.py``
  (car.fhd cut in the voxels' xy size, 3 000 voxels, B = 2) with the flag,
  one training forward + backward.  The port runs key-match mode; the JAX
  package runs the same network in its exact XLA mode (rulebooks merged on
  the device), which compiles about five times faster on a CPU than its
  key-match kernels in interpret mode (those are held above).  Each head
  and the gradients (worst and median tensor, as a share of the tensor's
  max |g| in the JAX float32 step) within ``BF16_MARGIN`` = twice the JAX
  package's own bf16-vs-float32 distance, as ``tests/test_torch_mixed.py``
  holds car.fhd.mixed; each loss term on each of the first eight batches
  within twice the JAX package's own bf16-vs-float32 distance at its
  largest over those batches (and so in root mean square), the float32
  terms equal (rtol 1e-4), as ``tests/test_torch_mixed_pillars.py``'s
  ``hold_loss_terms`` explains.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.ops.pallas import (
    sparse_gather_gemm as jsgg)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu_torch.data import batching
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, voxelnet)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    sparse_conv as sc, sparse_gather_gemm as sgg)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.train import train

from test_torch_mixed import (BF16_MARGIN, HEADS, _grad_distances,
                              _head_distance, _np_tree)
from test_torch_mixed_pillars import (hold_loss_terms, mixed,
                                      port_and_jax_steps)
from test_torch_second_train import micro_cfg  # noqa: F401 (a fixture)
from test_torch_sparse_gemm import (INT32_MAX, KEYMATCH_CASES, STRIDED,
                                    TILE, WINDOW, problem, t)
from test_torch_sparse_middle import tiny_twin

GEMM_RTOL = 1e-4
# batches whose loss terms are held (half the pillar test's: a key-match
# batch costs about six seconds on a CPU)
LOSS_BATCHES = 8


@pytest.mark.parametrize("case", KEYMATCH_CASES, ids=list(KEYMATCH_CASES))
def test_keymatch_gemm_bf16_matches_jax(case):
    """K4 on bf16 features and weights, float32 out, in the JAX
    function's call form ``case``, and batched: within 1e-4 of max |out|
    of the JAX package's bf16 ``keymatch_gemm`` (interpret mode)."""
    c = dict(KEYMATCH_CASES[case])
    form, no_queries = c.pop("form"), c.pop("no_queries", False)
    feats, _, _, in_keys, q_keys, w = problem(31, **c)
    if no_queries:
        q_keys = np.full_like(q_keys, INT32_MAX)
    group = form.get("group", 1)
    if group > 1:        # the caller permutes query keys and taps alike
        kernel = STRIDED[0] if c.get("strided") else c.get("kernel",
                                                           (3, 3, 3))
        perm = sgg.group_perm(kernel)
        q_keys, w = q_keys[perm], w[perm]
    args = (TILE, WINDOW, form.get("shared", True),
            form.get("subwindow", 0), group)
    ref = np.asarray(jsgg.keymatch_gemm(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(in_keys),
        jnp.asarray(q_keys), jnp.asarray(w, jnp.bfloat16), True, *args))
    tf, tw = t(feats).bfloat16(), t(w).bfloat16()
    got = sgg.keymatch_gemm(tf, t(in_keys), t(q_keys), tw, None, *args)
    assert ref.dtype == np.float32
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert float(np.abs(got.numpy() - ref).max()) <= GEMM_RTOL * max(
        scale, 1e-30)
    if no_queries:
        assert (got == 0).all()
    else:
        assert scale > 1.0
    both = sgg.keymatch_gemm_bf16(tf.expand(2, -1, -1),
                                  t(np.stack([in_keys, in_keys])),
                                  t(np.stack([q_keys, q_keys])), tw)
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())


def test_keymatch_bf16_join_backward_upcasts_dout(monkeypatch):
    """The key-match join on bf16 features and weights: the backward
    hands float32 ``dout``, features and weights (never rounded to bf16)
    to the backward functions over the join's rulebook, and returns bf16
    gradients equal to the float32 backward of the same values, rounded
    once."""
    feats, _, _, in_keys, q_keys, w = problem(32)
    tf = t(feats).bfloat16().requires_grad_()
    tw = t(w).bfloat16().requires_grad_()
    dout = torch.randn(q_keys.shape[-1], w.shape[-1],
                       generator=torch.Generator().manual_seed(0))
    seen = []
    for name in ("join_grad_features", "join_grad_weights"):
        fn = getattr(sgg, name)

        def spy(*args, _fn=fn):
            seen.append(tuple(a.dtype for a in args
                              if isinstance(a, torch.Tensor)
                              and a.is_floating_point()))
            return _fn(*args)
        monkeypatch.setattr(sgg, name, spy)
    out = sgg.keymatch_gemm(tf, t(in_keys), t(q_keys), tw)
    assert out.dtype == torch.float32
    out.backward(dout)
    assert len(seen) == 2 and all(d == torch.float32
                                  for s in seen for d in s), seen
    idx, hit = sc._merge_lookup(t(in_keys), t(q_keys).flatten())
    df, dw = sgg.join_backward_plain(tf.detach().float(),
                                     idx.view(q_keys.shape),
                                     hit.view(q_keys.shape),
                                     tw.detach().float(), dout)
    assert tf.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert torch.equal(tf.grad, df.bfloat16())
    assert torch.equal(tw.grad, dw.bfloat16())


# --------------------------------------------------------------------------
# the bf16 key-match network, one training forward + backward
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def configs(micro_cfg, tmp_path_factory):  # noqa: F811
    """(port bf16 key-match, port float32 key-match, JAX bf16 exact, JAX
    float32 exact) micro twins."""
    tmp = tmp_path_factory.mktemp("mixed_keymatch")
    port, exact = micro_cfg
    out = []
    for name, src, flag in (("port.mixed", port, True),
                            ("port.f32", port, False),
                            ("exact.mixed", exact, True),
                            ("exact.f32", exact, False)):
        path = tmp / f"{name}.config"
        text = src.read_text()
        path.write_text(mixed(text) if flag else text)
        out.append(path)
    return out


@pytest.fixture(scope="module")
def runs(configs):
    """The first LOSS_BATCHES training batches (B = 2) of the bf16
    key-match twin, as ``tests/test_torch_mixed_pillars.py``'s ``runs``
    steps them: the port in key-match mode, the JAX package in exact
    mode."""
    port_bf16, port_f32, jax_bf16, jax_f32 = configs
    bundle = train.Bundle(port_bf16)
    cfg = bundle.model_cfg
    assert cfg.compute_dtype == "bfloat16" and cfg.sparse_keymatch
    prep_ds, loader = bundle.input_reader(training=True)
    stream = loader._index_stream()
    batches = [batching.merge_batch(
        [prep_ds.example(*next(stream)) for _ in range(2)])
        for _ in range(LOSS_BATCHES)]
    jmodel = jax_train.Bundle(jax_bf16).model
    init = _np_tree(jax.jit(functools.partial(jmodel.init, train=True))(
        jax.random.key(0), np.zeros((1, 64, 5, 4), np.float32),
        np.zeros((1, 64), np.int32), np.full((1, 64, 3), -1, np.int32)))
    return port_and_jax_steps((port_bf16, port_f32), (jax_bf16, jax_f32),
                              init, batches)


def test_mixed_keymatch_heads_match_jax_bf16(runs):
    """Each head of the port's bf16 key-match forward (train mode)
    against the JAX package's bf16 forward, within twice the JAX
    bf16-vs-float32 distance; heads back in float32."""
    port, jbf, j32 = (runs[k][0] for k in ("port_bf16", "jax_bf16",
                                            "jax_f32"))
    for k in HEADS:
        assert runs["preds", "port_bf16"][k].dtype == torch.float32
        got, own = _head_distance(port, jbf, k), _head_distance(jbf, j32, k)
        print(f"{k}: port bf16 vs JAX bf16 {got:.4g}; JAX bf16 vs JAX "
              f"float32 {own:.4g}")
        assert np.isfinite(port[k]).all()
        assert 0 < got <= BF16_MARGIN * own, (k, got, own)


def test_mixed_keymatch_step_matches_jax_bf16(runs):
    """One bf16 key-match step: the gradients (worst and median tensor;
    every middle gradient nonzero) within twice the JAX bf16-vs-float32
    distance of the JAX bf16 step; the loss terms as
    ``tests/test_torch_mixed_pillars.py``'s ``hold_loss_terms`` holds
    them."""
    _, _, gp = runs["port_bf16"]
    _, _, gb = runs["jax_bf16"]
    _, _, g32 = runs["jax_f32"]
    hold_loss_terms(runs)
    assert set(gp) <= set(gb)
    got = _grad_distances(gp, gb, {n: g32[n] for n in gp})
    own = _grad_distances(gb, g32, {n: g32[n] for n in gp})
    print(f"gradients (worst, median share of max |g|): port bf16 vs JAX "
          f"bf16 {got}; JAX bf16 vs JAX float32 {own}")
    assert got[0] <= BF16_MARGIN * own[0]
    assert got[1] <= BF16_MARGIN * own[1]
    assert all(np.isfinite(g).all() for g in gp.values())
    assert all(np.abs(g).max() > 0 for n, g in gp.items()
               if n.startswith("middle_feature_extractor.middle_conv")
               and n.endswith("weight"))


def test_mixed_keymatch_middle_joins_in_bf16(configs, monkeypatch):
    """The key-match middle under the flag hands every join bfloat16
    features and bfloat16 weights (the weights cast after the tap
    permutation, as the JAX package's ``_keymatch_impl`` casts them); the
    canvas is bfloat16 and every head float32."""
    seen = []
    fn = middle.keymatch_gemm

    def spy(feats, in_keys, q_keys, w, *args):
        seen.append((feats.dtype, w.dtype, args[-1]))
        return fn(feats, in_keys, q_keys, w, *args)
    monkeypatch.setattr(middle, "keymatch_gemm", spy)
    bundle = train.Bundle(configs[0])
    model = bundle.model.eval()
    _, loader = bundle.input_reader(training=False)
    ex = train.to_device(next(iter(loader)), "cpu")
    with torch.no_grad():
        preds, stages = model(ex["voxels"], ex["num_points"],
                              ex["coordinates"], return_stages=True)
    plan = bundle.model_cfg
    assert seen and all(f == w == torch.bfloat16 for f, w, _ in seen), seen
    assert len(seen) == sum(b.n_subm + 1 for b in voxelnet.middle_plan(
        plan, ex["voxels"].shape[1]))
    assert stages["spatial_features"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in preds.values())


def test_mixed_keymatch_trains_evaluates_and_serves(configs, tmp_path):
    """``train`` (two steps) and ``evaluate`` of the bf16 key-match micro
    twin, and ``pod_inference_from_checkpoint`` of car.fhd.serving's tiny
    twin with the flag (grouped taps, the dense tail), on the CPU: the
    loss finite, the KITTI table back, the served heads finite float32."""
    state = train.train(configs[0], tmp_path / "m", max_steps=2,
                        display_step=1, device="cpu")
    assert state.step == 2
    result = train.evaluate(configs[0], tmp_path / "m", device="cpu")
    assert "Car" in result["result_str"]
    serving = tmp_path / "serving.mixed.config"
    serving.write_text(mixed(tiny_twin(tmp_path).read_text()))
    pod = pod_inference_from_checkpoint(serving, None, device="cpu",
                                        max_voxels=3000,
                                        max_points_per_voxel=5)
    assert pod.cfg.compute_dtype == "bfloat16" and pod.cfg.sparse_keymatch
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform([0, -6.4, -3], [12.8, 6.4, 1],
                                      (4000, 3)),
                          rng.uniform(0, 1, (4000, 1))], 1).astype(
                              np.float32)
    heads = pod.heads(pts[None], np.array([len(pts)], np.int32))
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in heads.values())
    out = pod(pts[None], np.array([len(pts)], np.int32))
    assert out["box3d_lidar"].shape[0] == 1
