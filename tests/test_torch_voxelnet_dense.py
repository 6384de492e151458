"""The VoxelNet family of the port against the JAX package: the VFEs
(``VoxelFeatureExtractor``, ``VoxelFeatureExtractorV2``, ``with_distance``,
``SimpleVoxelRadius``), ``scatter_to_dense`` and ``DenseMiddle``, a whole
dense VoxelNet (forward, ``compute_loss``, ``predict``), a float64
training step under SGD with a manual-stepping learning rate, and
``car.voxelnet.config`` built by both packages.

Micro widths: a 32 x 32 x 8 grid of 0.5 m voxels, T = 5 points a voxel,
VFE filters (8, 16), middle filters (8, 16).  Inputs are seeded scans
voxelized by the JAX package's host voxelizer.  Tolerances: float32
rtol = atol = 1e-4 (the port's model tests' tolerance: sums in another
order on oneDNN than on XLA); BatchNorm statistics after a training
forward rtol 1e-5, atol 1e-7; the float64 step rtol 1e-10; detections as
sets, boxes within 1e-3, scores within 1e-4 (``detections_mismatch``).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from google.protobuf import text_format

from automatic_as_built_reconstruction_tpu.builder import (
    box_coder_builder, config_io as jax_config_io,
    optimizer_builder as jax_optimizer_builder, second_builder as jax_sb,
    target_assigner_builder, voxel_builder)
from automatic_as_built_reconstruction_tpu.core import (
    anchors as jax_anchors, box_coders, region_similarity, target_assign,
    voxelize as jax_voxelize)
from automatic_as_built_reconstruction_tpu.models import (
    middle as jax_middle, rpn as jax_rpn, voxel_encoder as jax_ve,
    voxelnet as jvn)
from automatic_as_built_reconstruction_tpu.protos import optimizer_pb2
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu_torch.builder import (
    optimizer_builder)
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, voxel_encoder, voxelnet as tvn)
from automatic_as_built_reconstruction_tpu_torch.ops import pillar_scatter
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    build_from_config, detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.train import train
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_model import make_scene
from test_torch_kitti_pillars import _Float64Numpy

REPO = Path(__file__).resolve().parents[1]
VOXELNET_CFG = (REPO / "automatic_as_built_reconstruction_tpu_torch"
                / "configs" / "second" / "car" / "car.voxelnet.config")
TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-5, atol=1e-7)
F64_TOL = dict(rtol=1e-10, atol=0)

PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL_SIZE = (0.5, 0.5, 0.5)
T = 5
DENSE_MICRO = dict(
    num_class=1, num_input_features=4, vfe_name="VoxelFeatureExtractor",
    vfe_num_filters=(8, 16), middle_name="DenseMiddle",
    grid_size=(32, 32, 8), voxel_size=VOXEL_SIZE, pc_range=PC_RANGE,
    middle_num_filters=(8, 16), middle_layers_per_block=(1, 1),
    middle_z_strides=(2, 2), middle_xy_strides=(1, 2),
    rpn_layer_nums=(1,), rpn_layer_strides=(1,), rpn_num_filters=(16,),
    rpn_upsample_strides=(1,), rpn_num_upsample_filters=(16,),
    num_anchor_per_loc=2, nms_pre_max_size=64, nms_post_max_size=8,
    nms_score_threshold=0.05, direction_offset=0.78539816339)
# the paper's SGD: momentum (the proto default 0.9) and a manual step
SGD_TEXT = """momentum_optimizer { learning_rate {
  manual_stepping_learning_rate { boundaries: [1] rates: [0.01, 0.001] }
} }"""
SGD_DICT = {"momentum_optimizer": {"learning_rate": {
    "manual_stepping_learning_rate": {"boundaries": [1],
                                      "rates": [0.01, 0.001]}}}}
F64_MODULES = [jvn, jax_middle, jax_rpn, jax_ve]
# float64 training steps held to the JAX package's
STEPS64 = 1


def dense_example(seed=0, batch=2, max_voxels=400):
    """Seeded scans with two cars each, voxelized (0.5 m cubes, T = 5) by
    the JAX package's voxelizer, with anchors on the 16 x 16 map and their
    targets: the example dict both packages train on (numpy)."""
    rng = np.random.default_rng(seed)
    gen = jax_voxelize.VoxelGenerator(VOXEL_SIZE, PC_RANGE, T, max_voxels)
    agen = jax_anchors.AnchorGeneratorRange(
        anchor_ranges=(0, -8, -1.78, 16, 8, -1.78),
        sizes=((1.6, 3.9, 1.56),), rotations=(0, np.pi / 2),
        match_threshold=0.5, unmatch_threshold=0.35)
    anchors = agen.generate((1, 16, 16)).reshape(-1, 7).astype(np.float32)
    out = {k: [] for k in ("voxels", "num_points", "coordinates", "anchors",
                           "labels", "reg_targets")}
    for _ in range(batch):
        gt = np.array([[rng.uniform(3, 13), rng.uniform(-5, 5), -1.7, 1.6,
                        3.9, 1.56, rng.uniform(-np.pi, np.pi)]
                       for _ in range(2)], np.float32)
        voxels, coords, num_points = gen.generate(make_scene(rng, gt))
        pad = max_voxels - len(voxels)
        res = target_assign.create_targets(
            anchors, gt, region_similarity.NearestIouSimilarity().compare,
            box_coders.GroundBox3dCoder().encode,
            gt_classes=np.array([1, 1]), matched_threshold=0.5,
            unmatched_threshold=0.35)
        out["voxels"].append(np.pad(voxels, ((0, pad), (0, 0), (0, 0))))
        out["coordinates"].append(np.pad(coords, ((0, pad), (0, 0)),
                                         constant_values=-1))
        out["num_points"].append(np.pad(num_points, (0, pad)))
        out["anchors"].append(anchors)
        out["labels"].append(res["labels"])
        out["reg_targets"].append(res["bbox_targets"])
    ex = {k: np.stack(v) for k, v in out.items()}
    assert (ex["labels"] > 0).sum() >= 2
    assert len(np.unique(ex["coordinates"][0][:, 0])) > 3
    return ex


def port_cfg(jcfg) -> tvn.VoxelNetConfig:
    return tvn.VoxelNetConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(
                                     tvn.VoxelNetConfig)})


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _sub_state(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: _t(v) for k, v in sd.items()
            if k.startswith(prefix)}


def _load_submodule(module: torch.nn.Module, sd: dict, prefix: str):
    state = {k: v.float() for k, v in _sub_state(sd, prefix).items()}
    for name, mod in module.named_modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            state[f"{name}.num_batches_tracked".lstrip(".")] = torch.zeros(
                (), dtype=torch.long)
    module.load_state_dict(state, strict=True)
    return module


def _perturbed(variables, seed):
    """A module's flax variables with BatchNorm made non-trivial."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "mean":
                t[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                t[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("scale", "bias") and path and "BatchNorm" in path[-1]:
                base = 1.0 if k == "scale" else 0.0
                t[k] = (base + rng.normal(0, 0.1, v.shape)).astype(
                    np.float32)
    walk(tree)
    return tree


# --------------------------------------------------------------------------
# the VFEs
# --------------------------------------------------------------------------

VFES = {
    "v1": (jax_ve.VoxelFeatureExtractor, voxel_encoder.VoxelFeatureExtractor,
           {}),
    "v2": (jax_ve.VoxelFeatureExtractorV2,
           voxel_encoder.VoxelFeatureExtractorV2, {}),
    "v1_with_distance": (jax_ve.VoxelFeatureExtractor,
                         voxel_encoder.VoxelFeatureExtractor,
                         {"with_distance": True}),
    "v2_three_layers": (jax_ve.VoxelFeatureExtractorV2,
                        voxel_encoder.VoxelFeatureExtractorV2,
                        {"num_filters": (8, 12, 16)}),
}


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(VFES))
def test_vfe_matches_jax(kind, train_mode):
    """Features of each VFE, and in training the BatchNorm statistics
    (taken over every [B, V, T] row, padded ones included), from the same
    variables on the same voxels."""
    jcls, tcls, kw = VFES[kind]
    kw = {"num_input_features": 4, "num_filters": (8, 16), **kw}
    ex = dense_example(seed=1)
    args = [jnp.asarray(ex[k]) for k in ("voxels", "num_points",
                                         "coordinates")]
    jmod = jcls(**kw)
    variables = _perturbed(jax.jit(jmod.init)(jax.random.key(0), *args),
                           seed=2)
    wrapped = {c: {f"{jcls.__name__}_0": variables[c]} for c in variables}
    sd = weight_import.to_torch_state_dict(wrapped)
    port = _load_submodule(tcls(**kw), sd, "voxel_feature_extractor.")
    port.train(train_mode)
    if train_mode:
        want, mut = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    else:
        want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
            variables, *args)
    with torch.no_grad():
        got = port(*(_t(x) for x in (ex["voxels"], ex["num_points"],
                                     ex["coordinates"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    assert (got.numpy()[ex["num_points"] == 0] == 0).all()
    if train_mode:
        new = weight_import.to_torch_state_dict(
            {"params": wrapped["params"],
             "batch_stats": {f"{jcls.__name__}_0": mut["batch_stats"]}})
        stats = port.state_dict()
        for k, w in _sub_state(new, "voxel_feature_extractor.").items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(stats[k].numpy(), w.numpy(),
                                           **STAT_TOL, err_msg=k)


def test_vfe_training_gradient_is_the_eager_jax_gradient():
    """In training the VFE's parameter gradients (float64) equal the JAX
    package's eager ``jax.grad`` and a central difference of the loss;
    the JAX gradient under ``jax.jit`` on XLA's CPU backend is not that
    function's gradient (the float64 step test holds the port to the
    eager one)."""
    ex = dense_example(seed=9)
    kw = dict(num_input_features=4, num_filters=(8, 16))
    rng = np.random.default_rng(9)
    ct = rng.normal(size=ex["voxels"].shape[:2] + (16,))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in F64_MODULES:
            mp.setattr(module, "jnp", _Float64Numpy())
        args = [jnp.asarray(ex["voxels"], jnp.float64),
                jnp.asarray(ex["num_points"]),
                jnp.asarray(ex["coordinates"])]
        jmod = jax_ve.VoxelFeatureExtractor(**kw)
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            _perturbed(jax.jit(jmod.init)(jax.random.key(0), *args),
                       seed=10))

        def loss(params):
            out, _ = jmod.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                *args, train=True, mutable=["batch_stats"])
            return (out * ct).sum()

        want = jax.tree_util.tree_map(np.asarray,
                                      jax.grad(loss)(variables["params"]))
        bias = variables["params"]["BatchNorm_0"]["bias"]
        h = 1e-6
        # the loss alone is compiled correctly: its central difference
        # under jit
        loss_j = jax.jit(loss)
        central = [float(loss_j({**variables["params"], "BatchNorm_0": {
            **variables["params"]["BatchNorm_0"],
            "bias": bias.at[i].add(h)}}) - loss_j({
                **variables["params"], "BatchNorm_0": {
                    **variables["params"]["BatchNorm_0"],
                    "bias": bias.at[i].add(-h)}})) / (2 * h)
            for i in range(2)]
    wrapped = {c: {"VoxelFeatureExtractor_0": variables[c]}
               for c in variables}
    sd = weight_import.to_torch_state_dict(wrapped)
    port = _load_submodule(voxel_encoder.VoxelFeatureExtractor(**kw), sd,
                           "voxel_feature_extractor.").double().train()
    out = port(_t(ex["voxels"]).double(), _t(ex["num_points"]),
               _t(ex["coordinates"]))
    (out * _t(ct)).sum().backward()
    got = dict(port.named_parameters())
    grads = weight_import.to_torch_state_dict(
        {"params": {"VoxelFeatureExtractor_0": want},
         "batch_stats": wrapped["batch_stats"]})
    # float64 sums in another order, and flax's one-pass variance against
    # the port's two-pass one: within 1e-7 of each tensor's max |g|
    for k, w in _sub_state(grads, "voxel_feature_extractor.").items():
        if k in got:
            w = w.double().numpy()
            np.testing.assert_allclose(got[k].grad.numpy(), w, rtol=1e-7,
                                       atol=1e-7 * np.abs(w).max(),
                                       err_msg=k)
    np.testing.assert_allclose(got["norm.bias"].grad.numpy()[:2], central,
                               rtol=1e-6)


def test_simple_voxel_radius_matches_jax():
    """The radius mean-of-points VFE (no parameters): C - 1 channels."""
    ex = dense_example(seed=3)
    want = jax_ve.SimpleVoxelRadius(num_input_features=4).apply(
        {}, jnp.asarray(ex["voxels"]), jnp.asarray(ex["num_points"]))
    got = voxel_encoder.SimpleVoxelRadius(num_input_features=4)(
        _t(ex["voxels"]), _t(ex["num_points"]))
    assert got.shape[-1] == 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# the dense middle
# --------------------------------------------------------------------------

def test_scatter_to_dense_is_k1s_function():
    """The dense canvas through the pillar scatter's plain version equals
    the JAX ``scatter_to_dense`` (padded voxels dropped), and its
    gradient is the gather."""
    ex = dense_example(seed=4)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=ex["voxels"].shape[:2] + (8,)).astype(
        np.float32)
    grid = (8, 32, 32)
    want = jax_middle.scatter_to_dense(jnp.asarray(feats),
                                       jnp.asarray(ex["coordinates"]), grid)
    f = _t(feats).requires_grad_()
    before = pillar_scatter.scatter_sorted_to_canvas.launches
    got = middle.dense_canvas(f, _t(ex["coordinates"]), grid)
    assert pillar_scatter.scatter_sorted_to_canvas.launches == before
    assert got.shape == (2, 8, 8, 32, 32)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        middle.scatter_to_dense(_t(feats), _t(ex["coordinates"]),
                                grid).numpy(), np.asarray(want))
    w = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    (got * w).sum().backward()
    valid = ex["coordinates"][..., 0] >= 0
    z, y, x = (ex["coordinates"][..., i].clip(0) for i in range(3))
    b = np.arange(2)[:, None].repeat(z.shape[1], 1)
    want_g = np.where(valid[..., None],
                      w.numpy()[b, :, z, y, x], 0)
    np.testing.assert_array_equal(f.grad.numpy(), want_g)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_dense_middle_matches_jax(train_mode):
    """DenseMiddle's BEV map (depth outside the channels) and, in
    training, its BatchNorm statistics over every dense site."""
    ex = dense_example(seed=5)
    rng = np.random.default_rng(5)
    feats = np.abs(rng.normal(size=ex["voxels"].shape[:2] + (8,))).astype(
        np.float32)
    kw = dict(grid_dhw=(8, 32, 32), num_input_features=8,
              num_filters=(8, 16), layers_per_block=(1, 1),
              z_strides=(2, 2), xy_strides=(1, 2))
    jmod = jax_middle.DenseMiddle(**kw)
    args = (jnp.asarray(feats), jnp.asarray(ex["coordinates"]))
    variables = _perturbed(jax.jit(jmod.init)(jax.random.key(1), *args),
                           seed=6)
    wrapped = {c: {"DenseMiddle_0": variables[c]} for c in variables}
    assert weight_import.to_torch_state_dict(wrapped) == {}   # no slot
    sd = weight_import.port_only_state(wrapped)
    port = _load_submodule(middle.DenseMiddle(**kw), sd,
                           "middle_feature_extractor.")
    assert port.out_channels == 32
    port.train(train_mode)
    if train_mode:
        want, mut = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    else:
        want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
            variables, *args)
    with torch.no_grad():
        got = port(_t(feats), _t(ex["coordinates"]))
    assert got.shape == (2, 32, 16, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)
    if train_mode:
        new = weight_import.port_only_state(
            {"params": wrapped["params"],
             "batch_stats": {"DenseMiddle_0": mut["batch_stats"]}})
        stats = port.state_dict()
        for k, w in _sub_state(new, "middle_feature_extractor.").items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(stats[k].numpy(), w.numpy(),
                                           **STAT_TOL, err_msg=k)


# --------------------------------------------------------------------------
# the whole dense VoxelNet
# --------------------------------------------------------------------------

def _model_variables(jcfg, seed):
    """flax-init variables of the JAX VoxelNet (``init`` under jit) with
    BatchNorm made non-trivial and the class logits spread, as
    ``tests/test_torch_models.py::random_variables`` makes them."""
    ex = dense_example(seed=seed)
    args = [jnp.asarray(ex[k]) for k in ("voxels", "num_points",
                                         "coordinates")]
    variables = _perturbed(jax.jit(jvn.VoxelNet(cfg=jcfg).init)(
        jax.random.key(seed), *args), seed)
    head = variables["params"]["RPN_0"]["conv_cls"]
    head["kernel"] = (head["kernel"] * 20).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def dense_model():
    """(JAX cfg, variables, port model with them, example)."""
    jcfg = jvn.VoxelNetConfig(**DENSE_MICRO)
    variables = _model_variables(jcfg, seed=7)
    model = tvn.VoxelNet(port_cfg(jcfg))
    weight_import.load_variables(model, variables)
    return jcfg, variables, model.eval(), dense_example(seed=8)


def test_dense_voxelnet_forward_loss_and_predict_match_jax(dense_model):
    """Heads, loss terms and detections of the dense VoxelNet in eval
    mode."""
    jcfg, variables, model, ex = dense_model
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    preds = jax.jit(lambda v, *a: jvn.VoxelNet(cfg=jcfg).apply(v, *a))(
        variables, jex["voxels"], jex["num_points"], jex["coordinates"])
    with torch.no_grad():
        got = model(_t(ex["voxels"]), _t(ex["num_points"]),
                    _t(ex["coordinates"]))
    assert sorted(got) == sorted(preds)
    for k in preds:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(preds[k]), err_msg=k, **TOL)
    assert float(np.abs(np.asarray(preds["cls_preds"])).max()) > 0.1
    _, jterms = jax.jit(lambda p, e: jvn.compute_loss(p, e, jcfg))(
        preds, jex)
    tex = {k: _t(v) for k, v in ex.items()}
    _, terms = tvn.compute_loss(got, tex, model.cfg)
    assert sorted(terms) == sorted(jterms)
    for k in jterms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want = {k: np.asarray(v) for k, v in jax.jit(
        lambda p, a: jvn.predict(p, a, jcfg))(preds, jex["anchors"]).items()}
    det = {k: v.numpy() for k, v in
           tvn.predict(got, tex["anchors"], model.cfg).items()}
    assert want["valid"].sum() > 0
    assert detections_mismatch(det, want, 1) is None


@pytest.fixture(scope="module")
def sgd_reference(dense_model):
    """The JAX package's float64 training step of the dense VoxelNet
    (forward in train mode, ``compute_loss``, the trainer's clip, the
    config's SGD over a manual-stepping rate) and its loss terms."""
    jcfg, variables, _, ex = dense_model
    msg = text_format.Parse(SGD_TEXT, optimizer_pb2.Optimizer())
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in F64_MODULES:
            mp.setattr(module, "jnp", _Float64Numpy())
        def f64(x):
            x = np.asarray(x)
            return jnp.asarray(x, jnp.float64 if x.dtype == np.float32
                               else x.dtype)

        state = jax.tree_util.tree_map(f64, variables)
        jex = {k: f64(v) for k, v in ex.items()}
        tx = jax_optimizer_builder.build(msg, 100)
        opt = tx.init(state["params"])

        # XLA's CPU compilation of the VFE's gradient in training is wrong
        # (BatchNorm, then the -inf mask and the max over the points:
        # test_vfe_training_gradient_is_the_eager_jax_gradient), so the
        # VFE's vector-Jacobian product runs eagerly and the middle, the
        # RPN and the loss under jit: the stages of VoxelNet.__call__ for
        # this config, each with its own variables
        vfe = jax_ve.VoxelFeatureExtractor(
            num_input_features=jcfg.num_input_features,
            num_filters=jcfg.vfe_num_filters)
        mid = jax_middle.DenseMiddle(
            grid_dhw=(jcfg.grid_size[2], jcfg.grid_size[1],
                      jcfg.grid_size[0]),
            num_input_features=jcfg.vfe_num_filters[-1],
            num_filters=jcfg.middle_num_filters,
            layers_per_block=jcfg.middle_layers_per_block,
            z_strides=jcfg.middle_z_strides,
            xy_strides=jcfg.middle_xy_strides)
        rpn = jax_rpn.RPN(
            layer_nums=jcfg.rpn_layer_nums,
            layer_strides=jcfg.rpn_layer_strides,
            num_filters=jcfg.rpn_num_filters,
            upsample_strides=jcfg.rpn_upsample_strides,
            num_upsample_filters=jcfg.rpn_num_upsample_filters,
            num_anchor_per_loc=jcfg.num_anchor_per_loc,
            num_class=jcfg.num_class, box_code_size=jcfg.box_code_size,
            dtype=jnp.float64)
        names = ("VoxelFeatureExtractor_0", "DenseMiddle_0", "RPN_0")
        assert sorted(state["params"]) == sorted(names)

        @jax.jit
        def rest(p_mid, p_rpn, feats, bs_mid, bs_rpn):
            def loss_fn(p_mid, p_rpn, feats):
                spatial, m1 = mid.apply(
                    {"params": p_mid, "batch_stats": bs_mid}, feats,
                    jex["coordinates"], train=True, mutable=["batch_stats"])
                preds, m2 = rpn.apply(
                    {"params": p_rpn, "batch_stats": bs_rpn}, spatial,
                    train=True, mutable=["batch_stats"])
                loss, metrics = jvn.compute_loss(preds, jex, jcfg)
                return loss, (metrics, m1["batch_stats"], m2["batch_stats"])
            return jax.grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
                p_mid, p_rpn, feats)

        def grads_fn(params, batch_stats):
            def vfe_fn(p):
                out, mut = vfe.apply(
                    {"params": p, "batch_stats": batch_stats[names[0]]},
                    jex["voxels"], jex["num_points"], jex["coordinates"],
                    train=True, mutable=["batch_stats"])
                return out, mut["batch_stats"]
            feats, vjp_fn, s_vfe = jax.vjp(vfe_fn, params[names[0]],
                                           has_aux=True)
            (g_mid, g_rpn, g_feats), (terms, s_mid, s_rpn) = rest(
                params[names[1]], params[names[2]], feats,
                batch_stats[names[1]], batch_stats[names[2]])
            grads = dict(zip(names, (vjp_fn(g_feats)[0], g_mid, g_rpn)))
            stats = dict(zip(names, (s_vfe, s_mid, s_rpn)))
            return (jax_train.clip_by_global_norm(grads, 10.0),
                    (terms, stats))

        out = []
        for _ in range(STEPS64):
            grads, (terms, stats) = grads_fn(state["params"],
                                             state["batch_stats"])
            updates, opt = tx.update(grads, opt, state["params"])
            state = {"params": optax.apply_updates(state["params"], updates),
                     "batch_stats": stats}
            out.append(({k: float(v) for k, v in terms.items()},
                        jax.tree_util.tree_map(np.asarray, state)))
    return out


def test_float64_sgd_steps_match_jax(dense_model, sgd_reference):
    """A float64 ``make_train_step`` update of the port (SGD with
    momentum, a manual-stepping rate) against the JAX float64 step: loss
    terms, then every parameter and BatchNorm statistic after it, to rtol
    1e-10 (the schedules at their boundaries:
    ``tests/test_torch_optimizers.py``)."""
    jcfg, variables, _, ex = dense_model
    model = tvn.VoxelNet(port_cfg(jcfg))
    weight_import.load_variables(model, variables)
    model = model.double().train()
    opt, schedule = optimizer_builder.build(SGD_DICT, 100,
                                            model.parameters())
    assert isinstance(opt, optimizer_builder.MomentumSGD)
    assert (schedule(0), schedule(1)) == pytest.approx((0.01, 0.001),
                                                       rel=1e-7)
    state = train.TrainState(model, opt, schedule)
    bundle = type("B", (), {"model": model, "model_cfg": model.cfg})()
    step = train.make_train_step(bundle)
    example = {k: _t(v).double() if v.dtype == np.float32 else _t(v)
               for k, v in ex.items()}
    for i, (terms, after) in enumerate(sgd_reference):
        metrics = step(state, example)
        for k, want in terms.items():
            np.testing.assert_allclose(float(metrics[k]), want, **F64_TOL,
                                       err_msg=f"step {i} {k}")
        want = {**weight_import.to_torch_state_dict(after),
                **weight_import.port_only_state(after)}
        got = state.model.state_dict()
        assert sorted(want) == sorted(k for k in got
                                      if "num_batches" not in k)
        for k, w in want.items():
            assert got[k].dtype == torch.float64, k
            np.testing.assert_allclose(got[k].numpy(), w, **F64_TOL,
                                       err_msg=f"step {i} {k}")


# --------------------------------------------------------------------------
# the car.voxelnet config
# --------------------------------------------------------------------------

def test_car_voxelnet_config_builds_the_same_model_config():
    """``car.voxelnet.config`` through both packages' builders: the same
    VoxelNetConfig field for field, the paper's grid and 70 400 anchors,
    and the port's model at full width with the trainer's optimizer."""
    m = jax_config_io.load_config(VOXELNET_CFG).model.second
    vg = voxel_builder.build(m.voxel_generator)
    ta = target_assigner_builder.build(m.target_assigner,
                                       box_coder_builder.build(m.box_coder))
    _, jcfg, jfmap = jax_sb.build(m, vg, ta)
    model, cfg, anchors = build_from_config(VOXELNET_CFG)
    for f in dataclasses.fields(tvn.VoxelNetConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.grid_size == (352, 400, 10) and tuple(jfmap) == (1, 200, 176)
    assert anchors.shape == (70400, 7)
    assert cfg.vfe_name == "VoxelFeatureExtractor"
    assert cfg.middle_name == "DenseMiddle"
    assert model.middle_feature_extractor.out_channels == 128
    first = model.voxel_feature_extractor.vfe1.linear
    assert first.in_features == 7 and first.out_features == 16
    bundle = train.Bundle(VOXELNET_CFG)
    state = train.init_state(bundle, total_steps=None, device="cpu")
    assert isinstance(state.optimizer, optimizer_builder.MomentumSGD)
    assert state.optimizer.param_groups[0]["momentum"] == 0.9
    assert state.schedule(92849) == pytest.approx(0.01, rel=1e-7)
    assert state.schedule(92850) == pytest.approx(0.001, rel=1e-6)
