"""Port vs JAX package, model by model: the weight converter (same keys,
same arrays as the JAX ``to_torch_state_dict``) and the PFN / scatter /
RPN outputs of the tiny as-built config against ``VoxelNet.apply``.

Float tolerance: rtol 1e-4, atol 1e-4 — fp32 convolution and matmul sums
run in another order on oneDNN than on XLA's CPU backend, and eleven
stacked conv + BN layers carry that rounding forward.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.builder import (
    box_coder_builder, config_io as jax_config_io, second_builder,
    target_assigner_builder, voxel_builder)
from automatic_as_built_reconstruction_tpu.models.voxelnet import VoxelNet
from automatic_as_built_reconstruction_tpu.ops import voxelize_jax
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet as tvn
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    build_from_config, load_checkpoint_variables)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

REPO = Path(__file__).resolve().parents[1]
JAX_CFG = REPO / "automatic_as_built_reconstruction_tpu" / "configs" / "building"
PORT_CFG = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
            / "building")
CKPT = REPO / "artifacts" / "asbuilt_r2_step8000.pkl"
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_model_cfg(name):
    m = jax_config_io.load_config(JAX_CFG / f"{name}.config").model.second
    vg = voxel_builder.build(m.voxel_generator)
    ta = target_assigner_builder.build(m.target_assigner,
                                       box_coder_builder.build(m.box_coder))
    _, cfg, fmap = second_builder.build(m, vg, ta)
    return cfg, vg, ta, fmap


def random_variables(cfg, seed=0):
    """flax-init weights with BN statistics and head weights made
    non-trivial (numpy, from a seed)."""
    model = VoxelNet(cfg=cfg)
    T = 4
    variables = model.init(
        jax.random.key(seed), jnp.zeros((1, 8, T, 4)),
        jnp.zeros((1, 8), jnp.int32), jnp.full((1, 8, 3), -1, jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def perturb(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, path + (k,))
            elif k == "mean":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("scale", "bias") and "BatchNorm" in path[-1]:
                base = 1.0 if k == "scale" else 0.0
                tree[k] = (base + rng.normal(0, 0.1, v.shape)).astype(
                    np.float32)
            elif path and path[-1] == "conv_cls" and k == "kernel":
                # spread the class logits so scores are far apart
                tree[k] = (v * 20).astype(np.float32)
    perturb(variables)
    return variables


def _assert_same_state_dict(variables):
    ref = jax_weight_import.to_torch_state_dict(variables)
    got = weight_import.to_torch_state_dict(variables)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_weight_converter_matches_jax_tiny():
    cfg, *_ = jax_model_cfg("asbuilt_pillars_tiny")
    _assert_same_state_dict(random_variables(cfg))


def test_weight_converter_matches_jax_checkpoint():
    variables = load_checkpoint_variables(CKPT)
    _assert_same_state_dict(variables)
    model, _, _ = build_from_config(PORT_CFG / "asbuilt_pillars.config")
    weight_import.load_variables(model, variables)    # strict=True
    n_params = sum(p.numel() for p in model.parameters())
    n_ref = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n_params == n_ref


@pytest.mark.parametrize("variant", [
    {"pillar_scatter_sorted": True},
    {"pillar_scatter_sorted": False},
], ids=["pallas_scatter", "xla_scatter"])
def test_stages_match_jax_tiny(variant):
    """PFN, scatter canvas and RPN maps of the tiny config (flax-init
    weights, perturbed BN) on voxels of two synthetic scans."""
    cfg, vg, _, _ = jax_model_cfg("asbuilt_pillars_tiny")
    cfg = dataclasses.replace(cfg, **variant)
    variables = random_variables(cfg, seed=1)
    pts, nv = pad_batch([generate_building_scene(s)["points"][::8]
                         for s in (3, 4)])
    V, T = 1024, 8
    vox = jax.vmap(lambda p, n: voxelize_jax.voxelize(
        p, n, voxel_size=cfg.voxel_size, pc_range=cfg.pc_range,
        grid_size=cfg.grid_size, max_points=T, max_voxels=V,
        first_appearance=False))(jnp.asarray(pts), jnp.asarray(nv))
    preds, stages = VoxelNet(cfg=cfg).apply(
        variables, vox.voxels, vox.num_points, vox.coords, train=False,
        return_stages=True)

    _, tcfg, _ = build_from_config(PORT_CFG / "asbuilt_pillars_tiny.config")
    tcfg = dataclasses.replace(tcfg, **{
        k: v for k, v in variant.items() if k != "pillar_scatter_sorted"})
    model = tvn.VoxelNet(tcfg)
    weight_import.load_variables(model, variables)
    model.eval()
    with torch.no_grad():
        tpreds, tstages = model(
            torch.from_numpy(np.asarray(vox.voxels)),
            torch.from_numpy(np.asarray(vox.num_points)),
            torch.from_numpy(np.asarray(vox.coords)), return_stages=True)
    np.testing.assert_allclose(tstages["voxel_features"].numpy(),
                               np.asarray(stages["voxel_features"]), **TOL)
    np.testing.assert_allclose(
        tstages["spatial_features"].permute(0, 2, 3, 1).numpy(),
        np.asarray(stages["spatial_features"]), **TOL)
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(tpreds[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(preds[k]), err_msg=k, **TOL)
    assert float(np.abs(np.asarray(preds["cls_preds"])).max()) > 1.0


@pytest.mark.parametrize("variant", [
    {"vfe_name": "PillarFeatureNetRadius"},
    {"with_distance": True},
    {"rpn_layer_strides": (1, 2), "rpn_upsample_strides": (0.5, 1.0)},
    {"middle_name": "SpMiddleFHD", "compute_dtype": "bfloat16"},
    {"use_yaw_quality_head": True},
    {"encode_background_as_zeros": False},
    {"use_direction_classifier": False},
    {"middle_name": "DenseMiddle"},
    {"vfe_name": "SimpleVoxelRadius"},
], ids=["radius", "with_distance", "frac_upsample", "sparse_middle",
        "yaw_quality", "softmax_scores", "no_direction_head",
        "dense_middle", "simple_voxel_radius"])
def test_unported_options_raise(variant):
    """Options that are not ported (the sparse middle in bfloat16 among
    them) are refused, not served."""
    _, tcfg, _ = build_from_config(PORT_CFG / "asbuilt_pillars_tiny.config")
    with pytest.raises(NotImplementedError):
        tvn.VoxelNet(dataclasses.replace(tcfg, **variant))
