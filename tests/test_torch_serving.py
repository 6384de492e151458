"""The serving slice as a whole: the port's ``PodInference`` against the
JAX ``PodInference`` (hard key-order voxelization, the Pallas pillar
scatter in interpret mode, rotated NMS).

Detections are compared as sets per (scan, class): equal counts, and
each port detection matches one JAX detection with boxes within atol
1e-3 and scores within atol 1e-4 (fp32 convolution sums run in another
order on oneDNN than on XLA; box sizes pass through exp()).
"""
import dataclasses

import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import building as jax_building
from automatic_as_built_reconstruction_tpu.models.voxelnet import VoxelNet
from automatic_as_built_reconstruction_tpu.parallel.inference import (
    PodInference as JaxPodInference)
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    PodInference, build_from_config, detections_mismatch,
    load_checkpoint_variables, pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_models import CKPT, PORT_CFG, jax_model_cfg, random_variables

from test_torch_sparse_middle import (jax_bundle, second_variables,
                                      tiny_scans, tiny_twin)

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4


def assert_same_detections(got, ref, num_class):
    diff = detections_mismatch(got, ref, num_class, BOX_ATOL, SCORE_ATOL)
    assert diff is None, diff


def _jax_pod(cfg, variables, anchors, max_voxels, max_points):
    return JaxPodInference(VoxelNet(cfg=cfg), cfg, variables, anchors,
                           mesh=None, max_voxels=max_voxels,
                           max_points_per_voxel=max_points)


def test_tiny_config_random_weights_match_jax():
    """Flax-init weights (perturbed BN, spread class logits),
    nms_score_threshold 0 and post_max_size = pre_max_size, so every row
    sends all its boxes to NMS and the output shows what it kept."""
    jcfg, _, jta, fmap = jax_model_cfg("asbuilt_pillars_tiny")
    serve = dict(nms_score_threshold=0.0,
                 nms_post_max_size=jcfg.nms_pre_max_size)
    jcfg = dataclasses.replace(jcfg, pillar_scatter_sorted=True, **serve)
    variables = random_variables(jcfg, seed=2)
    anchors = jta.generate_anchors(fmap)["anchors"].reshape(-1, 7)
    pts, nv = pad_batch([generate_building_scene(s)["points"][::4]
                         for s in (5, 6)])
    V, T = 2048, 16
    ref = _jax_pod(jcfg, variables, anchors, V, T)(pts, nv)

    model, tcfg, t_anchors = build_from_config(
        PORT_CFG / "asbuilt_pillars_tiny.config")
    weight_import.load_variables(model, variables)
    pod = PodInference(model, dataclasses.replace(tcfg, **serve), t_anchors,
                       device="cpu", max_voxels=V, max_points_per_voxel=T)
    got = pod(pts, nv)
    assert_same_detections(got, {k: np.asarray(v) for k, v in ref.items()},
                           jcfg.num_class)
    # NMS had work: full rows in, fewer boxes out in every row
    kept = got["valid"].reshape(2, jcfg.num_class, -1).sum(-1)
    assert (kept > 0).all() and (kept < jcfg.nms_pre_max_size).all()


def test_full_config_trained_checkpoint_matches_jax():
    """asbuilt_pillars.config at full width with the trained
    asbuilt_r2_step8000.pkl on two synthetic scans in one request."""
    jcfg, _, jta, fmap = jax_model_cfg("asbuilt_pillars")
    jcfg = dataclasses.replace(jcfg, pillar_scatter_sorted=True)
    variables = load_checkpoint_variables(CKPT)
    anchors = jta.generate_anchors(fmap)["anchors"].reshape(-1, 7)
    pts, nv = pad_batch([generate_building_scene(s) for s in (0, 1)])
    assert list(nv) == [89297, 63336]
    V, T = 25600, 24
    ref = _jax_pod(jcfg, variables, anchors, V, T)(pts, nv)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    pod = pod_inference_from_checkpoint(
        PORT_CFG / "asbuilt_pillars.config", CKPT, device="cpu",
        max_voxels=V, max_points_per_voxel=T)
    got = pod(pts, nv)
    assert_same_detections(got, ref, jcfg.num_class)
    counts = [np.bincount(d["label_preds"], minlength=3).tolist()
              for d in pod.detections_list(got)]
    assert counts == [[34, 1, 6], [35, 6, 10]]
    assert all(np.isfinite(d["box3d_lidar"]).all()
               for d in pod.detections_list(got))


def test_scene_generator_matches_jax():
    """The port's copy of the synthetic scan generator gives the JAX
    package's scans exactly (chip_smoke.py serves these)."""
    for seed in (0, 7):
        got = generate_building_scene(seed)
        ref = jax_building.generate_building_scene(seed)
        np.testing.assert_array_equal(got["points"], ref["points"])
        np.testing.assert_array_equal(got["gt_boxes"], ref["gt_boxes"])
        np.testing.assert_array_equal(got["gt_names"], ref["gt_names"])


# --------------------------------------------------------------------------
# the three voxelization modes (SECOND tiny twin)
# --------------------------------------------------------------------------

SECOND_V, SECOND_T = 2048, 5


@pytest.fixture(scope="module")
def second_twin(tmp_path_factory):
    """(config path, JAX cfg, anchors, variables, request) of the SECOND
    tiny twin with seeded variables."""
    path = tiny_twin(tmp_path_factory.mktemp("twin"))
    jcfg, anchors = jax_bundle(path)
    return path, jcfg, anchors, second_variables(jcfg, 1), tiny_scans()


def _second_pod(path, variables, voxelization):
    model, tcfg, t_anchors = build_from_config(path)
    weight_import.load_variables(model, variables)
    return PodInference(model, tcfg, t_anchors, device="cpu",
                        max_voxels=SECOND_V, max_points_per_voxel=SECOND_T,
                        voxelization=voxelization)


def test_fused_mean_serving_equals_hard(second_twin):
    """K5's contract seen from the entry point: the same detections, to
    the bit (on the CPU the fused stage is SimpleVoxel of voxelize, and
    SimpleVoxel of one mean point divides by exactly 1)."""
    path, jcfg, _, variables, (pts, nv) = second_twin
    hard = _second_pod(path, variables, "hard")(pts, nv)
    fused = _second_pod(path, variables, "fused_mean")(pts, nv)
    for k in hard:
        np.testing.assert_array_equal(fused[k], hard[k], err_msg=k)
    assert (hard["valid"].sum(-1) > 3).all()


def test_dynamic_serving_matches_jax(second_twin):
    """``voxelization="dynamic"`` against the JAX PodInference in the same
    mode: detections as sets (boxes atol 1e-3, scores atol 1e-4)."""
    path, jcfg, anchors, variables, (pts, nv) = second_twin
    jpod = JaxPodInference(VoxelNet(cfg=jcfg), jcfg, variables, anchors,
                           mesh=None, max_voxels=SECOND_V,
                           max_points_per_voxel=SECOND_T,
                           voxelization="dynamic")
    ref = {k: np.asarray(v) for k, v in jpod(pts, nv).items()}
    got = _second_pod(path, variables, "dynamic")(pts, nv)
    assert_same_detections(got, ref, jcfg.num_class)
    assert (got["valid"].sum(-1) > 3).all()


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("model", ["pillars", "second"])
def test_entry_points_run_the_network_with_tf32_off(second_twin, model):
    """Inside ``heads()`` and ``__call__`` every module of the network
    sees cuDNN and matmul TF32 off, though the caller turned both on; the
    caller's flags are the same afterwards."""
    if model == "pillars":
        net, tcfg, anchors = build_from_config(
            PORT_CFG / "asbuilt_pillars_tiny.config")
        pod = PodInference(net, tcfg, anchors, device="cpu")
        request = pad_batch([generate_building_scene(s) for s in (0, 1)])
    else:
        path, _, _, variables, request = second_twin
        pod = _second_pod(path, variables, "fused_mean")
    caller = _tf32_flags()
    seen = set()
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda *_: seen.add(_tf32_flags()))
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        pod.heads(*request)
        out = pod(*request)
        assert _tf32_flags() == (True, True)
    finally:
        hook.remove()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = caller
    assert seen == {(False, False)}
    assert set(out) >= {"box3d_lidar", "valid"}


@pytest.mark.parametrize("voxelization", ["dynamic", "fused_mean"])
def test_mean_modes_refuse_a_pillar_model(voxelization):
    model, tcfg, anchors = build_from_config(
        PORT_CFG / "asbuilt_pillars_tiny.config")
    with pytest.raises(ValueError, match="SimpleVoxel"):
        PodInference(model, tcfg, anchors, device="cpu",
                     voxelization=voxelization)


def test_unknown_voxelization_is_refused():
    model, tcfg, anchors = build_from_config(
        PORT_CFG / "asbuilt_pillars_tiny.config")
    with pytest.raises(ValueError, match="voxelization"):
        PodInference(model, tcfg, anchors, device="cpu", voxelization="soft")
    with pytest.raises(ValueError, match="voxelization"):
        pod_inference_from_checkpoint(
            PORT_CFG / "asbuilt_pillars_tiny.config", None, device="cpu",
            voxelization="soft")
