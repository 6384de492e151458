"""Lineage torch checkpoints into the port: ``utils/weight_import.py``
(``import_spconv``, ``from_torch_state_dict``, ``load_torch_checkpoint``),
``train.import_torch_weights`` and its cli verb, against the JAX
package's own import of the same state_dict.

The lineage state_dict is made here from seeded JAX variables through the
JAX package's ``to_torch_state_dict``, at micro widths: the pillar and
SECOND configs of ``tests/test_serving_export.py`` (``tiny_pod``,
``sparse_km_pod``).  Imported weights must be equal exactly; forwards on
one voxelized scan agree to rtol = atol = 1e-4 (fp32 sums in another
order on oneDNN than on XLA).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.models import voxelnet as jvn
from automatic_as_built_reconstruction_tpu.ops import voxelize_jax
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch import cli
from automatic_as_built_reconstruction_tpu_torch.core import point_refine
from automatic_as_built_reconstruction_tpu_torch.data import building
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet as tvn
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint as ckpt_mod, train)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_eval import (BOX_ATOL, SCORE_ATOL, assert_same_ap, padded,
                             recorded, shortened_val_split)
from test_torch_models import JAX_CFG, PORT_CFG, jax_model_cfg, \
    random_variables

from automatic_as_built_reconstruction_tpu.core import (
    point_refine as jax_point_refine)
from automatic_as_built_reconstruction_tpu.data import (
    building as jax_building)

TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_serving_export.py's tiny_pod and sparse_km_pod configs
PILLAR_MICRO = dict(
    num_input_features=4, vfe_name="PillarFeatureNet",
    vfe_num_filters=(8,), middle_name="PointPillarsScatter",
    grid_size=(16, 16, 1), voxel_size=(0.5, 0.5, 4.0),
    pc_range=(0.0, -4.0, -3.0, 8.0, 4.0, 1.0),
    rpn_layer_nums=(1,), rpn_layer_strides=(1,),
    rpn_num_filters=(8,), rpn_upsample_strides=(1,),
    rpn_num_upsample_filters=(8,),
    num_class=1, num_anchor_per_loc=2, nms_pre_max_size=64,
    nms_post_max_size=8, nms_score_threshold=0.0)
SPARSE_MICRO = dict(
    num_input_features=4, vfe_name="SimpleVoxel",
    vfe_num_filters=(4,), middle_name="SpMiddleFHDLite",
    grid_size=(16, 16, 8), voxel_size=(0.5, 0.5, 0.5),
    pc_range=(0.0, -4.0, -3.0, 8.0, 4.0, 1.0),
    middle_num_filters=(8, 8), middle_xy_strides=(2, 2),
    rpn_layer_nums=(1,), rpn_layer_strides=(1,),
    rpn_num_filters=(8,), rpn_upsample_strides=(1,),
    rpn_num_upsample_filters=(8,),
    sparse_use_pallas_gemm=True, sparse_keymatch=True,
    sparse_keymatch_group=True, sparse_dense_tail_blocks=1,
    sparse_pallas_window=128, sparse_out_caps=(128, 128),
    num_class=1, num_anchor_per_loc=2, nms_pre_max_size=64,
    nms_post_max_size=8, nms_score_threshold=0.0)
MICRO = {"pillar": PILLAR_MICRO, "sparse": SPARSE_MICRO}
SPCONV = "middle_feature_extractor.middle_conv"


def port_cfg(jcfg) -> tvn.VoxelNetConfig:
    """The port's config of the same fields as a JAX ``VoxelNetConfig``."""
    return tvn.VoxelNetConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(
                                     tvn.VoxelNetConfig)})


def scan(seed, b=2, n=300):
    """``tests/test_serving_export.py``'s seeded scans in the micro
    range."""
    r = np.random.default_rng(seed)
    pts = np.concatenate([
        r.uniform([0, -4, -2.5], [8, 4, 0.5], (b, n, 3)),
        r.random((b, n, 1))], -1).astype(np.float32)
    return pts, np.full((b,), n, np.int32)


def lineage_state_dict(variables, spconv_v2=True) -> dict:
    """The lineage state_dict of ``variables``: the JAX package's export,
    every other spconv weight rewritten in the 2.x ``(O, kz, ky, kx, I)``
    layout (``spconv_v2``), BatchNorm ``num_batches_tracked`` counters
    added, every other value a torch tensor."""
    sd = {k: np.array(v, order="C") for k, v in
          jax_weight_import.to_torch_state_dict(variables).items()}
    spconv = [k for k in sd if k.startswith(SPCONV) and sd[k].ndim == 5]
    for k in spconv[::2] if spconv_v2 else ():
        sd[k] = np.array(sd[k].transpose(4, 0, 1, 2, 3), order="C")
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(
            7, dtype=torch.long)
    return {k: torch.from_numpy(v) if i % 2 and isinstance(v, np.ndarray)
            else v for i, (k, v) in enumerate(sorted(sd.items()))}


@functools.cache
def micro_variables(kind: str):
    """Seeded JAX variables of a micro config (numpy leaves, never written
    to: the imports build new trees)."""
    return random_variables(jvn.VoxelNetConfig(**MICRO[kind]), seed=3)


def other_variables(kind: str):
    """A tree of the same structure and other values, to import into."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + 1,
                                  micro_variables(kind))


@pytest.fixture(scope="module", params=["pillar", "sparse"])
def micro(request):
    """(kind, JAX cfg, lineage state_dict, the JAX package's import of it
    into a tree of other values)."""
    jcfg = jvn.VoxelNetConfig(**MICRO[request.param])
    sd = lineage_state_dict(micro_variables(request.param))
    imported = jax_weight_import.from_torch_state_dict(
        sd, other_variables(request.param))
    return request.param, jcfg, sd, imported


def port_model(jcfg) -> tvn.VoxelNet:
    return tvn.VoxelNet(port_cfg(jcfg))


def test_import_gives_the_jax_packages_weights(micro):
    """The port's import of the lineage state_dict (both spconv layouts,
    torch and numpy values, extra counters) equals the port's mapping of
    the JAX package's import, key for key, exactly."""
    kind, jcfg, sd, imported = micro
    model = weight_import.from_torch_state_dict(sd, port_model(jcfg))
    got = model.state_dict()
    ref = weight_import.to_torch_state_dict(imported)
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) \
        == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the lineage counters are ignored: the model keeps its own
    assert all(int(v) == 0 for k, v in got.items()
               if k.endswith("num_batches_tracked"))
    if kind == "sparse":
        v2 = [k for k, v in sd.items() if k.startswith(SPCONV)
              and v.ndim == 5 and v.shape[0] != 3]
        assert len(v2) >= 2


def test_imported_forward_matches_jax(micro):
    """The imported models' heads on one voxelized scan."""
    kind, jcfg, sd, imported = micro
    pts, nv = scan(11)
    vox = jax.vmap(lambda p, n: voxelize_jax.voxelize(
        p, n, voxel_size=jcfg.voxel_size, pc_range=jcfg.pc_range,
        grid_size=jcfg.grid_size, max_points=4, max_voxels=64,
        first_appearance=False))(jnp.asarray(pts), jnp.asarray(nv))
    ref = jax.jit(lambda v, *a: jvn.VoxelNet(cfg=jcfg).apply(
        v, *a, train=False))(imported, vox.voxels, vox.num_points,
                             vox.coords)
    model = weight_import.from_torch_state_dict(sd, port_model(jcfg)).eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.array(x)) for x in (
            vox.voxels, vox.num_points, vox.coords)))
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref[k]), err_msg=k, **TOL)
    assert float(np.abs(np.asarray(ref["cls_preds"])).max()) > 0.1


def test_strict_import_names_missing_keys_as_the_reference():
    """A missing key: the reference's ``KeyError`` with its wording, word
    for word; ``strict=False`` keeps the model's own value."""
    jcfg = jvn.VoxelNetConfig(**SPARSE_MICRO)
    sd = lineage_state_dict(micro_variables("sparse"))
    del sd["rpn.conv_box.weight"]
    with pytest.raises(KeyError) as got:
        weight_import.from_torch_state_dict(sd, port_model(jcfg))
    with pytest.raises(KeyError) as ref:
        jax_weight_import.from_torch_state_dict(
            sd, other_variables("sparse"))
    assert str(got.value) == str(ref.value)
    assert "state_dict missing 1 expected keys" in str(got.value)
    assert "rpn.conv_box.weight" in str(got.value)
    model = port_model(jcfg)
    before = model.rpn.conv_box.weight.detach().clone()
    weight_import.from_torch_state_dict(sd, model, strict=False)
    assert torch.equal(model.rpn.conv_box.weight, before)
    np.testing.assert_array_equal(model.rpn.conv_cls.bias.detach().numpy(),
                                  np.asarray(sd["rpn.conv_cls.bias"]))


def test_bad_shapes_raise_value_error():
    """A spconv weight in neither layout: the reference's message; a
    converted shape that does not fit its module names the key."""
    jcfg = jvn.VoxelNetConfig(**SPARSE_MICRO)
    sd = lineage_state_dict(micro_variables("sparse"))
    key = f"{SPCONV}.3.weight"
    bad = dict(sd, **{key: np.zeros((3, 3, 3, 9, 8), np.float32)})
    with pytest.raises(ValueError) as got:
        weight_import.from_torch_state_dict(bad, port_model(jcfg))
    with pytest.raises(ValueError) as ref:
        jax_weight_import.from_torch_state_dict(
            bad, other_variables("sparse"))
    assert str(got.value) == str(ref.value)
    assert "matches neither" in str(got.value)
    with pytest.raises(ValueError, match="spconv weight must be 5D"):
        weight_import.import_spconv(np.zeros((27, 8, 8)), (3, 3, 3), 8, 8)
    bad = dict(sd, **{"rpn.conv_cls.weight": np.zeros((3, 8, 1, 1))})
    with pytest.raises(ValueError, match="rpn.conv_cls.weight: converted"):
        weight_import.from_torch_state_dict(bad, port_model(jcfg))


def test_import_spconv_layouts():
    """1.x as it is (its taps refactored to the kernel), 2.x transposed."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 1, 1, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        weight_import.import_spconv(w, (3, 1, 1), 4, 5), w)
    np.testing.assert_array_equal(
        weight_import.import_spconv(w.reshape(1, 3, 1, 4, 5), (3, 1, 1),
                                    4, 5), w)
    np.testing.assert_array_equal(
        weight_import.import_spconv(torch.from_numpy(
            w.transpose(4, 0, 1, 2, 3).copy()), (3, 1, 1), 4, 5), w)


def test_load_torch_checkpoint_unwraps_state_dict(tmp_path, micro):
    """A ``.pt`` file of ``torch.save({"state_dict": ...})``."""
    _, jcfg, sd, imported = micro
    path = tmp_path / "voxelnet-100.tckpt"
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v))
                               for k, v in sd.items()}}, path)
    model = weight_import.load_torch_checkpoint(path, port_model(jcfg))
    for k, v in weight_import.to_torch_state_dict(imported).items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_cli_import_then_evaluate_matches_jax(tmp_path, capsys):
    """``import_torch_weights`` (the cli verb) writes step 0 and
    ``pipeline.config``; the port's ``evaluate`` of that model directory
    gives the detections and AP of the JAX package's ``evaluate`` after
    its own ``import_torch_weights`` of the same file (the tiny as-built
    config, the first two val scenes)."""
    name = "asbuilt_pillars_tiny"
    jcfg, *_ = jax_model_cfg(name)
    sd = lineage_state_dict(random_variables(jcfg, seed=2))
    ckpt = tmp_path / "voxelnet.tckpt"
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v))
                               for k, v in sd.items()}}, ckpt)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    cli.main(["import_torch_weights", "--config_path",
              str(PORT_CFG / f"{name}.config"), "--model_dir", str(port_dir),
              "--torch_ckpt", str(ckpt)])
    assert f"imported {ckpt} -> {port_dir} (step 0)" in capsys.readouterr().out
    assert ckpt_mod.CheckpointManager(port_dir).all_steps() == [0]
    assert (port_dir / "pipeline.config").read_text() == (
        PORT_CFG / f"{name}.config").read_text()
    jax_train.import_torch_weights(JAX_CFG / f"{name}.config", jax_dir, ckpt)
    with shortened_val_split(2):
        with recorded(point_refine, building.BuildingDataset) as port:
            got = train.evaluate(PORT_CFG / f"{name}.config", port_dir,
                                 device="cpu")
        with recorded(jax_point_refine, jax_building.BuildingDataset) as ref:
            want = jax_train.evaluate(JAX_CFG / f"{name}.config", jax_dir)
    diff = detections_mismatch(padded(port["final"]), padded(ref["final"]),
                               jcfg.num_class, BOX_ATOL, SCORE_ATOL)
    assert diff is None, diff
    assert sum(len(d["scores"]) for d in port["final"]) > 0
    assert_same_ap(got, want)
    # resume fine-tunes from step 0 with init_state's optimizer state
    state = train.init_state(train.Bundle(PORT_CFG / f"{name}.config"),
                             device="cpu")
    assert ckpt_mod.CheckpointManager(port_dir).restore(state) is state
    assert state.step == 0 and not state.optimizer.state


# the VoxelNet family: the paper's VFE (or its V2), the dense middle, a
# fractional upsample stride and the yaw-quality head
VOXELNET_MICRO = dict(
    num_input_features=4, vfe_name="VoxelFeatureExtractor",
    vfe_num_filters=(8, 16), middle_name="DenseMiddle",
    grid_size=(16, 16, 8), voxel_size=(0.5, 0.5, 0.5),
    pc_range=(0.0, -4.0, -3.0, 8.0, 4.0, 1.0),
    middle_num_filters=(8, 8), middle_layers_per_block=(1, 1),
    middle_z_strides=(2, 2), middle_xy_strides=(1, 2),
    rpn_layer_nums=(1, 1), rpn_layer_strides=(1, 2),
    rpn_num_filters=(8, 8), rpn_upsample_strides=(0.5, 1),
    rpn_num_upsample_filters=(8, 8), use_yaw_quality_head=True,
    num_class=1, num_anchor_per_loc=2)


@pytest.mark.parametrize("vfe", ["VoxelFeatureExtractor",
                                 "VoxelFeatureExtractorV2"])
def test_voxelnet_lineage_keys_match_jax(vfe):
    """The VoxelNet VFEs' lineage keys (``vfe{i}.linear`` / ``.norm`` from
    1, the trailing ``linear`` / ``norm``) and a fractional upsample's
    conv, key for key and value for value as the JAX package's mapping
    gives them.  The JAX mapping has no slot for ``DenseMiddle`` or
    ``conv_quality``, and neither has the port's lineage mapping or
    import: importing a lineage state_dict keeps the model's own values
    there, as the JAX import keeps the variables' own; the port's
    ``load_variables`` carries them under the port's names besides."""
    jcfg = jvn.VoxelNetConfig(**dict(VOXELNET_MICRO, vfe_name=vfe))
    variables = random_variables(jcfg, seed=4)
    ref = jax_weight_import.to_torch_state_dict(variables)
    got = weight_import.to_torch_state_dict(variables)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    vfe_keys = sorted(k for k in got
                      if k.startswith("voxel_feature_extractor."))
    n_vfe = 2 if vfe == "VoxelFeatureExtractor" else 1
    assert [k for k in vfe_keys if ".vfe" in k] == sorted(
        f"voxel_feature_extractor.vfe{i + 1}.{m}"
        for i in range(n_vfe) for m in (
            "linear.weight", "norm.bias", "norm.running_mean",
            "norm.running_var", "norm.weight"))
    assert "voxel_feature_extractor.linear.weight" in got
    assert "voxel_feature_extractor.norm.running_var" in got
    assert got["rpn.deblocks.0.0.weight"].shape == (8, 8, 2, 2)
    assert not any(k.startswith("middle_feature_extractor") or
                   "conv_quality" in k for k in got)

    # load_variables: the whole tree, the port-only part included
    model = port_model(jcfg)
    weight_import.load_variables(model, variables)
    port_only = weight_import.port_only_state(variables)
    assert sorted(port_only) == sorted(
        k for k in model.state_dict() if (k.startswith(
            "middle_feature_extractor") or "conv_quality" in k)
        and not k.endswith("num_batches_tracked"))
    w = np.asarray(variables["params"]["DenseMiddle_0"]["Conv_1"]["kernel"])
    np.testing.assert_array_equal(
        model.state_dict()["middle_feature_extractor.middle_conv.3.weight"]
        .numpy(), w.transpose(4, 3, 0, 1, 2))

    # a lineage import: the JAX package's import of the same state_dict
    sd = lineage_state_dict(variables)
    other = jax.tree_util.tree_map(lambda x: np.asarray(x) + 1, variables)
    imported = jax_weight_import.from_torch_state_dict(sd, other)
    fresh = port_model(jcfg)
    kept = {k: v.clone() for k, v in fresh.state_dict().items()}
    model = weight_import.from_torch_state_dict(sd, fresh)
    for k, v in weight_import.to_torch_state_dict(imported).items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v,
                                      err_msg=k)
    np.testing.assert_array_equal(
        np.asarray(imported["params"]["DenseMiddle_0"]["Conv_0"]["kernel"]),
        np.asarray(other["params"]["DenseMiddle_0"]["Conv_0"]["kernel"]))
    for k in port_only:
        assert torch.equal(model.state_dict()[k], kept[k]), k
