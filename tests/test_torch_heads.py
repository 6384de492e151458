"""The heads and options of the port that no shipped config sets, against
the JAX package: the yaw-quality head, softmax class scores
(``encode_background_as_zeros: false``), a model without the direction
classifier, fractional upsample strides, nearest (axis-aligned) NMS, and
the pillar VFE's ``with_distance`` and radius variant, padded and flat.

The models are ``tests/test_model.py``'s tiny pillar config (a 32 x 32
grid, RPN 16 / 32, 512 anchors) with flax-init weights made non-trivial
(``_model_variables``) on its synthetic two-car scene.  Tolerances: heads
and loss terms rtol = atol = 1e-4 (sums in another order on oneDNN than
on XLA); detections as sets (boxes 1e-3, scores 1e-4); NMS keep sets and
indices exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.models import (
    pointpillars as jax_pp, rpn as jax_rpn, voxelnet as jvn)
from automatic_as_built_reconstruction_tpu.ops import nms_jax, voxelize_jax
from automatic_as_built_reconstruction_tpu_torch.models import (
    pointpillars, rpn, voxelnet as tvn)
from automatic_as_built_reconstruction_tpu_torch.ops import nms, voxelize
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_model import make_example, tiny_cfg
from test_torch_voxelnet_dense import _model_variables

TOL = dict(rtol=1e-4, atol=1e-4)


def port_cfg(jcfg) -> tvn.VoxelNetConfig:
    return tvn.VoxelNetConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(
                                     tvn.VoxelNetConfig)})


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def run_both(jcfg, seed=0):
    """(JAX heads, port heads (NCHW), JAX example, port example, port
    model, the variables) of one config on the tiny scene, same
    weights."""
    ex, _ = make_example(jcfg)
    variables = _model_variables(jcfg, seed=seed)
    want = jax.jit(lambda v, *a: jvn.VoxelNet(cfg=jcfg).apply(v, *a))(
        variables, ex["voxels"], ex["num_points"], ex["coordinates"])
    model = tvn.VoxelNet(port_cfg(jcfg))
    weight_import.load_variables(model, variables)
    tex = {k: _t(v) for k, v in ex.items()}
    with torch.no_grad():
        got = model.eval()(tex["voxels"], tex["num_points"],
                           tex["coordinates"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)
    return want, got, ex, tex, model, variables


def assert_same_loss_and_detections(jcfg, want, got, ex, tex):
    _, jterms = jax.jit(lambda p, e: jvn.compute_loss(p, e, jcfg))(want, ex)
    _, terms = tvn.compute_loss(got, tex, port_cfg(jcfg))
    assert sorted(terms) == sorted(jterms)
    for k in jterms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    ref = {k: np.asarray(v) for k, v in jax.jit(
        lambda p, a: jvn.predict(p, a, jcfg))(want, ex["anchors"]).items()}
    det = {k: v.numpy() for k, v in
           tvn.predict(got, tex["anchors"], port_cfg(jcfg)).items()}
    assert ref["valid"].sum() > 0
    assert detections_mismatch(det, ref, jcfg.num_class) is None
    return jterms


# --------------------------------------------------------------------------
# the heads
# --------------------------------------------------------------------------

def test_yaw_quality_head_matches_jax():
    """``tests/test_model.py:103``: the quality map's shape, its loss term
    and detections against the JAX package, then the ranking case: a
    forged anchor with the higher class score and a quality logit of -8
    loses to its good-yaw rival (0.73)."""
    jcfg = tiny_cfg(use_yaw_quality_head=True, nms_score_threshold=0.05,
                    yaw_quality_weight=0.5, yaw_quality_predict_power=2.0)
    want, got, ex, tex, model, variables = run_both(jcfg, seed=1)
    assert got["quality_preds"].shape == (1, 2, 16, 16)
    assert "conv_quality" not in str(sorted(
        weight_import.to_torch_state_dict(variables)))
    terms = assert_same_loss_and_detections(jcfg, want, got, ex, tex)
    assert np.isfinite(terms["loss_quality"]) and terms["loss_quality"] > 0

    # the ranking case, on the port alone
    cfg = port_cfg(tiny_cfg(use_yaw_quality_head=True))
    A = 16 * 16 * 2
    hi, lo = 5, 6
    cls = np.full((1, A, 1), -6.0, np.float32)
    cls[0, hi, 0] = 3.0
    cls[0, lo, 0] = 1.0
    qual = np.full((1, A), 8.0, np.float32)
    qual[0, hi] = -8.0
    forged = {"box_preds": got["box_preds"],
              "cls_preds": _t(cls.reshape(1, 16, 16, 2)).permute(0, 3, 1, 2),
              "dir_cls_preds": got["dir_cls_preds"],
              "quality_preds": _t(qual.reshape(1, 16, 16, 2)).permute(
                  0, 3, 1, 2)}
    det = tvn.predict(forged, tex["anchors"], cfg)
    scores = det["scores"][0].numpy()
    valid = det["valid"][0].numpy()
    assert valid.any()
    assert abs(scores[valid].max() - 0.73) < 0.02


def test_fresh_quality_head_bias_is_two():
    """The trainer's flax-default start: the quality head's bias 2.0 (a
    fresh head leaves the scores nearly as they are)."""
    from automatic_as_built_reconstruction_tpu_torch.utils import (
        seeded_init)
    model = tvn.VoxelNet(port_cfg(tiny_cfg(use_yaw_quality_head=True)))
    seeded_init.load_flax_init(model, 0)
    assert bool((model.rpn.conv_quality.bias == 2.0).all())
    assert float(model.rpn.conv_cls.bias[0].detach()) == pytest.approx(
        -4.5951199)


def test_softmax_scores_match_jax():
    """``encode_background_as_zeros: false``: a background column in the
    class map, the one-hot over num_class + 1 kept, softmax scores."""
    jcfg = tiny_cfg(encode_background_as_zeros=False, num_class=2,
                    nms_score_threshold=0.05)
    want, got, ex, tex, _, _ = run_both(jcfg, seed=2)
    assert got["cls_preds"].shape[1] == 2 * 3
    assert_same_loss_and_detections(jcfg, want, got, ex, tex)


def test_no_direction_classifier_matches_jax():
    """No direction head: no ``dir_cls_preds``, no direction term, no
    direction fix of the yaw."""
    jcfg = tiny_cfg(use_direction_classifier=False,
                    nms_score_threshold=0.05)
    want, got, ex, tex, model, _ = run_both(jcfg, seed=3)
    assert "dir_cls_preds" not in got
    assert not hasattr(model.rpn, "conv_dir_cls")
    terms = assert_same_loss_and_detections(jcfg, want, got, ex, tex)
    assert "loss_dir" not in terms


def test_nearest_nms_in_predict_matches_jax():
    """``use_rotate_nms: false``: predict's nearest NMS."""
    jcfg = tiny_cfg(use_rotate_nms=False, nms_score_threshold=0.05,
                    nms_iou_threshold=0.1)
    want, got, ex, tex, _, _ = run_both(jcfg, seed=4)
    assert_same_loss_and_detections(jcfg, want, got, ex, tex)


def test_fractional_upsample_matches_jax():
    """A fractional upsample stride (a 2 x 2 conv of stride 2) in the
    model, and on an odd map in the RPN alone (flax's SAME padding)."""
    jcfg = tiny_cfg(rpn_layer_strides=(1, 2), rpn_upsample_strides=(0.5, 1),
                    nms_score_threshold=0.05)
    want, got, ex, tex, model, variables = run_both(jcfg, seed=5)
    assert isinstance(model.rpn.deblocks[0][0], rpn.SameConv2d)
    keys = weight_import.to_torch_state_dict(variables)
    assert keys["rpn.deblocks.0.0.weight"].shape == (16, 16, 2, 2)
    assert_same_loss_and_detections(jcfg, want, got, ex, tex)

    kw = dict(layer_nums=(1, 1), layer_strides=(1, 2), num_filters=(8, 8),
              upsample_strides=(0.5, 1), num_upsample_filters=(8, 8),
              num_anchor_per_loc=2)
    x = np.random.default_rng(6).normal(size=(1, 15, 15, 4)).astype(
        np.float32)
    jmod = jax_rpn.RPN(**kw)
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x))
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = rpn.RPN(num_input_features=4, **kw)
    sd = weight_import.to_torch_state_dict(
        {c: {"RPN_0": variables[c]} for c in variables})
    state = {k[len("rpn."):]: _t(v) for k, v in sd.items()}
    state.update({k: v for k, v in port.state_dict().items()
                  if k.endswith("num_batches_tracked")})
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = port.eval()(_t(x).permute(0, 3, 1, 2))
    assert out["box_preds"].shape[-2:] == (8, 8)
    for k in ref:
        np.testing.assert_allclose(out[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref[k]), err_msg=k, **TOL)


# --------------------------------------------------------------------------
# nearest NMS
# --------------------------------------------------------------------------

def _bev_boxes(rng, n):
    xy = rng.uniform(0, 12, (n, 2))
    wl = rng.uniform(0.5, 3.0, (n, 2))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xy, wl, yaw], -1).astype(np.float32)


def test_rbbox_to_near_bbox_matches_jax():
    rng = np.random.default_rng(7)
    boxes = _bev_boxes(rng, 64)
    boxes[:8, 4] = np.pi / 4 * np.array([1, -1, 3, -3, 0, 2, -2, 4])
    want = nms_jax.rbbox_to_near_bbox(jnp.asarray(boxes))
    got = nms.rbbox_to_near_bbox(_t(boxes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_valid", [40, 300], ids=["compact", "full"])
def test_nearest_nms_presorted_matches_jax(n_valid):
    """Rows of 320 score-sorted boxes with 40 (under the 256 cap: the
    compact branch) or 300 valid ones (the full width): indices and
    validity exactly."""
    rng = np.random.default_rng(8 + n_valid)
    R, K = 3, 320
    near = np.stack([np.asarray(nms_jax.rbbox_to_near_bbox(jnp.asarray(
        _bev_boxes(rng, K)))) for _ in range(R)])
    scores = -np.sort(-rng.random((R, K)), axis=1).astype(np.float32)
    scores[:, n_valid:] = -np.inf
    want_idx, want_ok = nms_jax.nearest_nms_presorted(
        jnp.asarray(near), jnp.asarray(scores), 0.2, post_max_size=50)
    idx, ok = nms.nearest_nms_presorted(_t(near), _t(scores), 0.2,
                                        post_max_size=50)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert 5 < int(ok.sum()) < R * 50 or n_valid > 256


def test_nearest_nms_matches_jax():
    """Unsorted scores with ties and -inf entries: the top-k (ties to the
    lower index), the greedy keep set and the indices into the input."""
    rng = np.random.default_rng(9)
    near = np.asarray(nms_jax.rbbox_to_near_bbox(jnp.asarray(
        _bev_boxes(rng, 200))))
    scores = np.round(rng.random(200), 2).astype(np.float32)
    scores[rng.random(200) < 0.2] = -np.inf
    for pre, post in ((150, 40), (500, 300)):
        want_idx, want_ok = nms_jax.nearest_nms(
            jnp.asarray(near), jnp.asarray(scores), 0.1, pre_max_size=pre,
            post_max_size=post)
        idx, ok = nms.nearest_nms(_t(near), _t(scores), 0.1, pre, post)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        assert int(ok.sum()) > 10


# --------------------------------------------------------------------------
# the pillar VFE's options
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flat", [False, True], ids=["padded", "flat"])
@pytest.mark.parametrize("option", ["with_distance", "radius", "both"])
def test_pillar_vfe_options_match_jax(option, flat):
    """``with_distance`` (|p| appended) and ``PillarFeatureNetRadius`` (x,
    y folded into the BEV radius) in the padded and the flat PFN."""
    radius = option in ("radius", "both")
    kw = dict(num_input_features=4, num_filters=(16,),
              voxel_size=(0.5, 0.5), pc_range=(0.0, -8.0),
              with_distance=option in ("with_distance", "both"))
    ex, _ = make_example(tiny_cfg())
    pts = np.asarray(ex["voxels"]).reshape(1, -1, 4)
    nv = np.array([int((np.asarray(ex["num_points"])).sum())], np.int32)
    pts = np.concatenate([pts[:, np.asarray(ex["voxels"]).reshape(
        -1, 4)[:, 3] != 0]], 1)[:, :nv[0]]
    vkw = dict(voxel_size=(0.5, 0.5, 4.0), pc_range=tiny_cfg().pc_range,
               grid_size=(32, 32, 1), max_points=8, max_voxels=512,
               first_appearance=False)
    jmod = jax_pp.PillarFeatureNet(radius=radius, **kw)
    port = pointpillars.PillarFeatureNet(radius=radius, **kw)
    assert port.pfn_layers[0].linear.in_features == (
        9 + kw["with_distance"] - radius)
    if flat:
        v = jax.vmap(lambda p, n: voxelize_jax.voxelize_flat(p, n, **vkw))(
            jnp.asarray(pts), jnp.asarray(nv))
        jargs = (None, v.num_points, v.coords)
        jkw = dict(flat_points=v.points, flat_slot=v.slot)
        tv = voxelize.voxelize_flat(_t(pts), _t(nv), **vkw)
        targs = (None, tv.num_points, tv.coords)
        tkw = dict(flat_points=tv.points, flat_slot=tv.slot)
    else:
        v = jax.vmap(lambda p, n: voxelize_jax.voxelize(p, n, **vkw))(
            jnp.asarray(pts), jnp.asarray(nv))
        jargs = (v.voxels, v.num_points, v.coords)
        jkw = {}
        tv = voxelize.voxelize(_t(pts), _t(nv), **vkw)
        targs = (tv.voxels, tv.num_points, tv.coords)
        tkw = {}
    init_args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 8), jnp.int32),
                 jnp.full((1, 8, 3), -1, jnp.int32))
    variables = jax.jit(jmod.init)(jax.random.key(1), *init_args)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(10)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    want = jmod.apply(variables, *jargs, train=False, **jkw)
    sd = weight_import.to_torch_state_dict(
        {c: {"PillarFeatureNet_0": variables[c]} for c in variables})
    state = {k[len("voxel_feature_extractor."):]: _t(v)
             for k, v in sd.items()}
    state.update({k: v for k, v in port.state_dict().items()
                  if k.endswith("num_batches_tracked")})
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port.eval()(*targs, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
