"""Port vs JAX package: ``MaskedBatchNorm``, ``SimpleVoxel``, the
``SparseMiddle`` stack in its three modes and with a dense tail, and the
SECOND serving slice as a whole (``PodInference`` on a tiny twin of
``car.fhd.serving.config``).

Weights go from the flax variables through the port's
``to_torch_state_dict`` and load with ``strict=True``.  Float tolerance:
rtol = atol = 1e-4 — every sparse conv sums up to 27 x 64 fp32 products
tap by tap where XLA takes one dot, and eleven conv + BN layers (then the
RPN's six) carry that rounding forward.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.builder import (
    box_coder_builder, config_io as jax_config_io, second_builder,
    target_assigner_builder, voxel_builder)
from automatic_as_built_reconstruction_tpu.models import (
    middle as jax_middle, middle_plans as jax_plans, voxel_encoder as jax_ve)
from automatic_as_built_reconstruction_tpu.models.voxelnet import VoxelNet
from automatic_as_built_reconstruction_tpu.parallel.inference import (
    PodInference as JaxPodInference)
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
    make_scene)
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    pad_batch)
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, voxelnet as tvn)
from automatic_as_built_reconstruction_tpu_torch.models.voxel_encoder import (
    SimpleVoxel)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    rulebook_host, sparse_conv as sc, sparse_gather_gemm as sgg)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    PodInference, build_from_config, detections_mismatch,
    pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_sparse_conv import random_sites, t

REPO = Path(__file__).resolve().parents[1]
PORT_SECOND = (REPO / "automatic_as_built_reconstruction_tpu_torch"
               / "configs" / "second" / "car")
TOL = dict(rtol=1e-4, atol=1e-4)


def seeded_variables(module, seed, *init_args, **init_kwargs):
    """A flax module's variables drawn with numpy from a seed (the tree's
    shapes come from ``jax.eval_shape``, so nothing is compiled): weights
    N(0, 2 / fan_in) over the leading axes, sparse conv taps counted at a
    half (many find no neighbour), biases N(0, .1); every BatchNorm
    non-trivial: scale 1 + N(0, .1), bias and mean N(0, .1), var
    U(.5, 1.5)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *init_args, **init_kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, n = path[-1].key, leaf.shape
        if name == "var":
            out = rng.uniform(.5, 1.5, n)
        elif name == "scale":
            out = 1 + rng.normal(0, .1, n)
        elif len(n) == 1:                    # bias, mean
            out = rng.normal(0, .1, n)
        else:
            fan_in = np.prod(n[:-1]) * (0.5 if name.endswith("_w") else 1)
            out = rng.normal(0, (2.0 / fan_in) ** 0.5, n)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def japply(module, variables, *args):
    """``module.apply`` under jit (op-by-op dispatch of a sparse stack
    takes ten times as long), with the sown intermediates."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a,
                                            mutable=["intermediates"]))
    return fn(variables, *[jnp.asarray(a) for a in args])


def load_middle(mod: middle.SparseMiddle, variables) -> None:
    """flax SparseMiddle variables -> the port's module, strict."""
    sd = weight_import.to_torch_state_dict(
        {"params": {"SparseMiddle_0": variables["params"]},
         "batch_stats": {"SparseMiddle_0": variables["batch_stats"]}})
    prefix = "middle_feature_extractor."
    mod.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)


def sparse_batch(rng, grid, V, n_active, B=2, F=4):
    sites = [random_sites(rng, grid, n_active, V - n_active)
             for _ in range(B)]
    coords = np.stack([s[0] for s in sites])
    feats = rng.normal(size=(B, V, F)).astype(np.float32)
    feats[coords[..., 0] < 0] = 0
    return feats, coords


# --------------------------------------------------------------------------
# MaskedBatchNorm, SimpleVoxel
# --------------------------------------------------------------------------


def test_masked_batchnorm_eval_and_train_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 40, 6)).astype(np.float32)
    mask = rng.random((2, 40)) < 0.6
    x[~mask] = 1e6                      # poison: padding must not count
    jbn = jax_middle.MaskedBatchNorm()
    v = seeded_variables(jbn, 1, jnp.asarray(x), jnp.asarray(mask),
                         train=False)
    bn = middle.MaskedBatchNorm(6)
    bn.load_state_dict({"weight": t(v["params"]["scale"]),
                        "bias": t(v["params"]["bias"]),
                        "running_mean": t(v["batch_stats"]["mean"]),
                        "running_var": t(v["batch_stats"]["var"])})
    # eval: running statistics
    ref = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), train=False)
    got = bn.eval()(t(x), t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    assert (got.detach().numpy()[~mask] == 0).all()
    # train: masked batch statistics, and the running ones move by
    # flax momentum 0.99 with the *biased* masked variance
    ref, upd = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), train=True,
                         mutable=["batch_stats"])
    got = bn.train()(t(x), t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    xm = x[mask]
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.99 * v["batch_stats"]["var"] + 0.01 * xm.var(0), rtol=1e-5)


def test_simple_voxel_matches_jax():
    rng = np.random.default_rng(2)
    voxels = rng.normal(size=(2, 30, 5, 4)).astype(np.float32)
    nump = rng.integers(0, 6, (2, 30)).astype(np.int32)
    ref = jax_ve.SimpleVoxel(num_input_features=4).apply(
        {}, jnp.asarray(voxels), jnp.asarray(nump))
    got = SimpleVoxel(4)(t(voxels), t(nump))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert not list(SimpleVoxel(4).parameters())


# --------------------------------------------------------------------------
# SparseMiddle
# --------------------------------------------------------------------------

MODES = {
    "plain": dict(),
    "gather_gemm": dict(use_pallas_gemm=True, pallas_tile=64,
                        pallas_window=128),
    "keymatch": dict(use_pallas_gemm=True, use_keymatch=True,
                     pallas_tile=64, pallas_window=((128, 256), (128, 128)),
                     keymatch_subwindow=((128, 128), (64, 128)),
                     keymatch_group=True),
}
SMALL = dict(grid_dhw=(8, 16, 16), num_input_features=4, num_filters=(8, 16),
             layers_per_block=(1, 2), z_strides=(2, 2), xy_strides=(1, 2),
             out_caps=(1024, 128))      # ample: nothing is truncated


@pytest.mark.parametrize("mode,tail", [
    ("plain", 0), ("gather_gemm", 0), ("keymatch", 0), ("gather_gemm", 1),
    ("keymatch", 1), ("keymatch", 2)])
def test_sparse_middle_matches_jax(mode, tail):
    """8 x 16 x 16 grid, two blocks, each mode against the JAX module in
    the same mode (its Pallas kernels in interpret mode or, where a
    tile's span exceeds the window, its exact XLA path)."""
    rng = np.random.default_rng(3)
    feats, coords = sparse_batch(rng, (8, 16, 16), V=128, n_active=64)
    jmod = jax_middle.SparseMiddle(dense_tail_blocks=tail, **SMALL,
                                   **MODES[mode])
    variables = seeded_variables(jmod, 4, jnp.asarray(feats),
                                 jnp.asarray(coords))
    ref, inter = japply(jmod, variables, feats, coords)
    mod = middle.SparseMiddle(dense_tail_blocks=tail, **SMALL, **MODES[mode])
    load_middle(mod, variables)
    launches = (sgg.gather_gemm.launches, sgg.keymatch_gemm.launches)
    with torch.no_grad():
        got = mod.eval()(t(feats), t(coords))
    assert got.shape == (2, 32, 8, 8)                 # NCHW, C = D' * 16
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    assert float(np.abs(np.asarray(ref)).max()) > 0.3
    # CPU tensors take the plain versions: no launch is counted
    assert launches == (sgg.gather_gemm.launches,
                        sgg.keymatch_gemm.launches)
    sat = {k: int(v) for k, v in mod.capacity_saturated.items()}
    assert sat == {f"b{i}": int(inter["intermediates"]
                                [f"b{i}_capacity_saturated"][0])
                   for i in range(2)} == {"b0": 0, "b1": 0}


def test_sparse_middle_capacity_truncation_matches_jax():
    """Caps below the true site counts: both truncate the same sites in
    key order and count the saturated scans."""
    rng = np.random.default_rng(5)
    feats, coords = sparse_batch(rng, (8, 16, 16), V=128, n_active=100)
    kw = dict(SMALL, out_caps=(128, 128))
    jmod = jax_middle.SparseMiddle(**kw)
    variables = seeded_variables(jmod, 6, jnp.asarray(feats),
                                 jnp.asarray(coords))
    ref, inter = japply(jmod, variables, feats, coords)
    mod = middle.SparseMiddle(**kw, **MODES["keymatch"])
    load_middle(mod, variables)
    with torch.no_grad():
        got = mod.eval()(t(feats), t(coords))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    assert int(mod.capacity_saturated["b0"]) == 2 == int(
        inter["intermediates"]["b0_capacity_saturated"][0])
    # host-built rulebooks of the same plan: the gather-GEMM join on them
    # (the key-match mode takes rulebooks when it is given them, as the
    # JAX module does) truncates the same sites and counts the same scans
    flat = [rulebook_host.build_middle_rulebooks(c, mod.plan(128))
            for c in coords]
    books = rulebook_host.unflatten(
        {k: np.stack([f[k] for f in flat]) for k in flat[0]}, 2)
    with torch.no_grad():
        host = mod(t(feats), t(coords), rulebooks=books)
    np.testing.assert_allclose(host.numpy(), got.numpy(), **TOL)
    assert int(mod.capacity_saturated["b0"]) == 2
    with pytest.raises(ValueError):          # books of another plan
        mod(t(feats), t(coords), rulebooks=rulebook_host.unflatten(
            {k: np.stack([rulebook_host.build_middle_rulebooks(
                c, middle.SparseMiddle(**SMALL).plan(128))[k]
                for c in coords]) for k in flat[0]}, 2))


def test_fhd_plan_full_channel_widths_matches_jax():
    """The exact _FHD plan (16/32/64/64 channels, depths 41 -> 21 -> 11 ->
    5 -> 2) on a 41 x 64 x 64 grid (xy cut only), the port in the serving
    config's mode (key-match, grouped taps, dense tail 1) against the JAX
    module's plain path with the same variables."""
    rng = np.random.default_rng(7)
    grid = (41, 64, 64)
    feats, coords = sparse_batch(rng, (40, 64, 64), V=768, n_active=600,
                                 B=1)
    caps = sc.measure_site_caps(list(coords), grid, jax_plans._FHD,
                                safety=1.1)
    kw = dict(grid_dhw=grid, num_input_features=4, blocks=jax_plans._FHD,
              out_caps=caps)
    jmod = jax_middle.SparseMiddle(**kw)
    variables = seeded_variables(jmod, 8, jnp.asarray(feats),
                                 jnp.asarray(coords))
    ref, inter = japply(jmod, variables, feats, coords)
    # (block 3's 2 x 8 x 8 output grid is full, which counts as saturated)
    assert [int(inter["intermediates"][f"b{i}_capacity_saturated"][0])
            for i in range(3)] == [0, 0, 0]
    mod = middle.SparseMiddle(
        **kw, use_pallas_gemm=True, use_keymatch=True, keymatch_group=True,
        pallas_window=((512, 384), (768, 768), (1024, 1536), (1024, 512)),
        keymatch_subwindow=((384, 256), (512, 512), (512, 1024), (512, 512)),
        dense_tail_blocks=1)
    load_middle(mod, variables)
    assert mod.out_channels == 128
    assert [tuple(m.weight.shape) for m in mod.middle_conv[::3]] == [
        (3, 3, 3, 4, 16), (3, 3, 3, 16, 16), (3, 3, 3, 16, 32),
        (3, 3, 3, 32, 32), (3, 3, 3, 32, 32), (3, 3, 3, 32, 64),
        (3, 3, 3, 64, 64), (3, 3, 3, 64, 64), (3, 3, 3, 64, 64),
        (3, 3, 3, 64, 64), (3, 3, 3, 64, 64), (3, 3, 3, 64, 64),
        (3, 3, 3, 64, 64), (3, 1, 1, 64, 64)]
    with torch.no_grad():
        got = mod.eval()(t(feats), t(coords))
    assert got.shape == (1, 128, 8, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1, caps


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

TINY_RANGE = "[0.0, -6.4, -3.0, 12.8, 6.4, 1.0]"


def tiny_twin(tmp_path) -> Path:
    """car.fhd.serving.config cut in xy only: 256 x 256 x 40 voxels (the
    depth-41 _FHD plan still applies), BEV 32 x 32, site caps to match."""
    text = (PORT_SECOND / "car.fhd.serving.config").read_text()
    for old, new in [
            ("point_cloud_range: [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]",
             f"point_cloud_range: {TINY_RANGE}"),
            ("anchor_ranges: [0.0, -40.0, -1.78, 70.4, 40.0, -1.78]",
             "anchor_ranges: [0.0, -6.4, -1.78, 12.8, 6.4, -1.78]"),
            ("post_center_limit_range: [0.0, -40.0, -2.2, 70.4, 40.0, 0.8]",
             "post_center_limit_range: [0.0, -6.4, -2.2, 12.8, 6.4, 0.8]"),
            ("out_site_caps: [52096, 61184, 40320, 35328]",
             "out_site_caps: [6144, 6144, 3072, 2048]"),
            ("nms_score_threshold: 0.3", "nms_score_threshold: 0.05")]:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / "car.fhd.tiny.config"
    path.write_text(text)
    return path


def jax_bundle(path):
    m = jax_config_io.load_config(path).model.second
    vg = voxel_builder.build(m.voxel_generator)
    ta = target_assigner_builder.build(m.target_assigner,
                                       box_coder_builder.build(m.box_coder))
    _, cfg, fmap = second_builder.build(m, vg, ta)
    return cfg, ta.generate_anchors(fmap)["anchors"].reshape(-1, 7)


def second_variables(cfg, seed):
    """SECOND variables from a seed, with the class logits spread and the
    box residuals small."""
    variables = seeded_variables(
        VoxelNet(cfg=cfg), seed, jnp.zeros((1, 8, 5, 4)),
        jnp.zeros((1, 8), jnp.int32), jnp.full((1, 8, 3), -1, jnp.int32))
    head = variables["params"]["RPN_0"]["conv_cls"]
    head["kernel"] = (head["kernel"] * 3).astype(np.float32)
    head["bias"] = np.full_like(head["bias"], -1.0)
    box = variables["params"]["RPN_0"]["conv_box"]
    box["kernel"] = (box["kernel"] * 0.2).astype(np.float32)
    return variables


def tiny_scans():
    """Two scans inside the tiny range: the 18 000-point synthetic scene
    squeezed into it (x / 5.5, y / 6.25)."""
    scans = []
    for seed in (1000, 1001):
        pts = make_scene(seed, 1500)
        pts[:, 0] /= 5.5
        pts[:, 1] /= 6.25
        scans.append(pts)
    return pad_batch(scans)


def test_weight_converter_matches_jax_second(tmp_path):
    """Key for key and array for array against the JAX mapping on a SECOND
    tree, and a strict load into the port's model."""
    path = tiny_twin(tmp_path)
    jcfg, _ = jax_bundle(path)
    variables = second_variables(jcfg, 0)
    ref = jax_weight_import.to_torch_state_dict(variables)
    got = weight_import.to_torch_state_dict(variables)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert sum(bool(re.fullmatch(
        r"middle_feature_extractor\.middle_conv\.\d+\.weight", k))
        for k in ref) == 28                     # 14 convs + 14 BN scales
    model, tcfg, _ = build_from_config(path)
    weight_import.load_variables(model, variables)        # strict=True
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(v).size
        for v in jax.tree_util.tree_leaves(variables["params"]))
    # a one-stage RPN with upsample stride 1.0 read as a float
    assert tcfg.rpn_upsample_strides == (1.0,)
    assert model.rpn.deblocks[0][0].kernel_size == (1, 1)
    assert tvn.num_middle_blocks(tcfg) == 4
    assert tvn.middle_plan(tcfg, 2048)[-1].out_grid == (2, 32, 32)


def test_second_pod_inference_matches_jax(tmp_path):
    """PodInference on the tiny twin, the same seeded variables on both
    sides: head outputs rtol = atol = 1e-4, detections as sets (boxes atol
    1e-3, scores atol 1e-4)."""
    path = tiny_twin(tmp_path)
    jcfg, anchors = jax_bundle(path)
    assert (jcfg.sparse_keymatch and jcfg.sparse_keymatch_group
            and jcfg.sparse_dense_tail_blocks == 1 and jcfg.middle_zpad == 1)
    variables = second_variables(jcfg, 1)
    pts, nv = tiny_scans()
    V, T = 2048, 5
    jpod = JaxPodInference(VoxelNet(cfg=jcfg), jcfg, variables, anchors,
                           mesh=None, max_voxels=V, max_points_per_voxel=T)
    ref = {k: np.asarray(v) for k, v in jpod(pts, nv).items()}

    model, tcfg, t_anchors = build_from_config(path)
    np.testing.assert_array_equal(t_anchors, anchors.astype(np.float32))
    weight_import.load_variables(model, variables)
    pod = PodInference(model, tcfg, t_anchors, device="cpu", max_voxels=V,
                       max_points_per_voxel=T)
    got = pod(pts, nv)
    diff = detections_mismatch(got, ref, jcfg.num_class, 1e-3, 1e-4)
    assert diff is None, diff
    kept = got["valid"].sum(-1)
    assert (kept > 3).all() and (kept < tcfg.nms_post_max_size).all()
    sat = pod.model.middle_feature_extractor.capacity_saturated
    assert {k: int(v) for k, v in sat.items()} == {
        "b0": 0, "b1": 0, "b2": 0, "b3": 0}

    # head outputs on the voxels of the same request
    from automatic_as_built_reconstruction_tpu.ops import voxelize_jax
    from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import (
        voxelize)
    vox = voxelize(t(pts), t(nv), voxel_size=tcfg.voxel_size,
                   pc_range=tcfg.pc_range, grid_size=tcfg.grid_size,
                   max_points=T, max_voxels=V, first_appearance=False)
    jvox = jax.vmap(lambda p, n: voxelize_jax.voxelize(
        p, n, voxel_size=jcfg.voxel_size, pc_range=jcfg.pc_range,
        grid_size=jcfg.grid_size, max_points=T, max_voxels=V,
        first_appearance=False))(jnp.asarray(pts), jnp.asarray(nv))
    np.testing.assert_array_equal(vox.coords.numpy(),
                                  np.asarray(jvox.coords))
    assert 1000 < int(vox.num_voxels.min()) and int(vox.num_voxels.max()) < V
    # (the JAX network through its plain sparse convs: the same function
    # and variables as the key-match mode, a third of its compile time)
    plain = dataclasses.replace(jcfg, sparse_use_pallas_gemm=False,
                                sparse_keymatch=False)
    jpreds = jax.jit(lambda v, *a: VoxelNet(cfg=plain).apply(
        v, *a, train=False))(variables, jvox.voxels, jvox.num_points,
                             jvox.coords)
    with torch.no_grad():
        preds = pod.model(vox.voxels, vox.num_points, vox.coords)
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(preds[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jpreds[k]), err_msg=k, **TOL)
    assert float(np.abs(np.asarray(jpreds["cls_preds"])).std()) > 0.3


def test_gather_gemm_mode_and_seeded_serving(tmp_path):
    """``sparse_keymatch=False`` (the gather-GEMM mode) gives the key-match
    mode's answer, and the no-checkpoint entry point serves the same
    seeded state every time."""
    path = tiny_twin(tmp_path)
    pts, nv = tiny_scans()
    pod = pod_inference_from_checkpoint(path, None, device="cpu",
                                        max_voxels=2048,
                                        max_points_per_voxel=5, seed=3)
    out_km = pod(pts, nv)
    assert out_km["valid"].any()
    gg = PodInference(
        tvn.VoxelNet(dataclasses.replace(pod.cfg, sparse_keymatch=False)),
        pod.cfg, pod.anchors.numpy(), device="cpu", max_voxels=2048,
        max_points_per_voxel=5)
    gg.model.load_state_dict(pod.model.state_dict(), strict=True)
    assert not gg.model.middle_feature_extractor.use_keymatch
    assert detections_mismatch(gg(pts, nv), out_km, 1, 1e-3, 1e-4) is None
    again = pod_inference_from_checkpoint(path, None, device="cpu",
                                          max_voxels=2048,
                                          max_points_per_voxel=5, seed=3)
    for k, v in pod.model.state_dict().items():
        assert torch.equal(v, again.model.state_dict()[k]), k
