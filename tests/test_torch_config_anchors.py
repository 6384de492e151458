"""Port vs JAX package: the config text-format reader against protobuf's
parse, the built model configs, and the anchors (exact)."""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
from google.protobuf import descriptor as pb_descriptor

from automatic_as_built_reconstruction_tpu.builder import (
    box_coder_builder, config_io as jax_config_io, second_builder,
    target_assigner_builder, voxel_builder)
from automatic_as_built_reconstruction_tpu_torch.builder import (
    config_io, second_builder as t_second_builder,
    target_assigner_builder as t_target_assigner_builder,
    voxel_builder as t_voxel_builder)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    build_from_config)

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = sorted((REPO / "automatic_as_built_reconstruction_tpu"
                      / "configs").rglob("*.config"))
PORT_CONFIGS = REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"

FD = pb_descriptor.FieldDescriptor


def _scalar_equal(field, mine, theirs) -> bool:
    if field.type == FD.TYPE_ENUM:
        if isinstance(mine, str):
            mine = field.enum_type.values_by_name[mine].number
        return mine == theirs
    if field.type == FD.TYPE_FLOAT:
        mine = config_io.f32(mine)
    if isinstance(theirs, float) and math.isnan(theirs):
        return math.isnan(mine)
    return mine == theirs


def _compare(msg, d: dict, path: str = ""):
    """Every field of the parsed dict equals protobuf's parse, and every
    field protobuf holds a non-default value for is in the dict."""
    set_fields = {f.name for f, _ in msg.ListFields()}
    assert set_fields <= set(d), (path, set_fields - set(d))
    for name, mine in d.items():
        field = msg.DESCRIPTOR.fields_by_name[name]
        theirs = getattr(msg, name)
        where = f"{path}.{name}"
        if field.type == FD.TYPE_MESSAGE and \
                field.message_type.GetOptions().map_entry:
            entries = config_io.as_list(mine)
            assert {e["key"]: e["value"] for e in entries} == dict(theirs), \
                where
        elif field.type == FD.TYPE_MESSAGE:
            if field.is_repeated:
                mine = config_io.as_list(mine)
                assert len(mine) == len(theirs), where
                for i, (m, t) in enumerate(zip(mine, theirs)):
                    _compare(t, m, f"{where}[{i}]")
            else:
                _compare(theirs, mine, where)
        elif field.is_repeated:
            mine = config_io.as_list(mine)
            assert len(mine) == len(theirs), where
            for m, t in zip(mine, theirs):
                assert _scalar_equal(field, m, t), (where, m, t)
        else:
            assert _scalar_equal(field, mine, theirs), (where, mine, theirs)


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=lambda p: p.stem)
def test_reader_matches_protobuf(path):
    _compare(jax_config_io.load_config(path), config_io.load_config(path))


def _jax_bundle(path):
    m = jax_config_io.load_config(path).model.second
    vg = voxel_builder.build(m.voxel_generator)
    ta = target_assigner_builder.build(m.target_assigner,
                                       box_coder_builder.build(m.box_coder))
    _, cfg, fmap = second_builder.build(m, vg, ta)
    return vg, ta, cfg, fmap


def _port_bundle(path):
    m = config_io.load_config(path)["model"]["second"]
    vg = t_voxel_builder.build(m["voxel_generator"])
    ta = t_target_assigner_builder.build(m["target_assigner"],
                                         m.get("box_coder", {}))
    cfg = t_second_builder.build_config(m, vg, ta)
    fmap = t_second_builder.feature_map_size_from(m, vg.grid_size)
    return vg, ta, cfg, fmap


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=lambda p: p.stem)
def test_built_config_matches(path):
    jvg, jta, jcfg, jfmap = _jax_bundle(path)
    tvg, tta, tcfg, tfmap = _port_bundle(path)
    np.testing.assert_array_equal(tvg.grid_size, jvg.grid_size)
    assert tvg.max_num_points == jvg.max_num_points
    assert tvg.max_voxels == jvg.max_voxels
    assert list(tta.classes) == list(jta.classes)
    assert tta.num_anchors_per_location == jta.num_anchors_per_location
    assert tta.box_code_size == jta.box_code_size
    assert tfmap == jfmap
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for tg, jg in zip(tta.anchor_generators, jta.anchor_generators):
        assert type(tg).__name__ == type(jg).__name__
        assert tg.match_threshold == jg.match_threshold
        assert tg.unmatch_threshold == jg.unmatch_threshold
    anchors_t = tta.generate_anchors(tfmap)
    anchors_j = jta.generate_anchors(jfmap)
    for k in ("anchors", "matched_thresholds", "unmatched_thresholds"):
        assert anchors_t[k].dtype == anchors_j[k].dtype
        np.testing.assert_array_equal(anchors_t[k], anchors_j[k])


@pytest.mark.parametrize("name,num_anchors", [
    ("asbuilt_pillars", 80 * 80 * 5), ("asbuilt_pillars_tiny", 32 * 32 * 5)])
def test_port_configs_and_anchors_exact(name, num_anchors):
    """The port's shipped configs equal the JAX package's, and the
    serving anchors equal ``TargetAssigner.generate_anchors`` exactly."""
    port_path = PORT_CONFIGS / "building" / f"{name}.config"
    jax_path = (REPO / "automatic_as_built_reconstruction_tpu" / "configs"
                / "building" / f"{name}.config")
    assert port_path.read_text() == jax_path.read_text()
    _, _, anchors = build_from_config(port_path)
    jvg, jta, jcfg, jfmap = _jax_bundle(jax_path)
    ref = jta.generate_anchors(jfmap)["anchors"].reshape(-1, 7)
    assert anchors.shape == (num_anchors, 7)
    np.testing.assert_array_equal(anchors, ref.astype(np.float32))


@pytest.mark.parametrize("name", ["car.fhd.serving", "car.fhd"])
def test_port_second_configs_and_anchors_exact(name):
    """The port's copies of the SECOND car configs equal the JAX
    package's, every field reads as protobuf reads it (``{}`` messages,
    the ``database_sampler`` block, comments after values), the built
    config carries the sparse-middle fields, and the 70 400 serving
    anchors are exact."""
    port_path = PORT_CONFIGS / "second" / "car" / f"{name}.config"
    jax_path = (REPO / "automatic_as_built_reconstruction_tpu" / "configs"
                / "second" / "car" / f"{name}.config")
    assert port_path.read_text() == jax_path.read_text()
    parsed = config_io.load_config(port_path)
    _compare(jax_config_io.load_config(jax_path), parsed)
    assigner = parsed["model"]["second"]["target_assigner"]
    assert assigner["class_settings"]["region_similarity_calculator"] == {
        "nearest_iou_similarity": {}}
    assert parsed["train_config"]["steps"] == 99040
    sampler = parsed["train_input_reader"]["preprocess"]["database_sampler"]
    assert sampler["sample_groups"]["name_to_max_num"] == {"key": "Car",
                                                           "value": 15}
    _, tcfg, anchors = build_from_config(port_path)
    jvg, jta, jcfg, jfmap = _jax_bundle(jax_path)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.middle_blocks is not None and tcfg.middle_zpad == 1
    assert tcfg.sparse_keymatch and tcfg.sparse_use_pallas_gemm
    if name == "car.fhd.serving":
        assert tcfg.sparse_out_caps == (52096, 61184, 40320, 35328)
        assert tcfg.sparse_dense_tail_blocks == 1
        assert tcfg.sparse_keymatch_group
        assert tcfg.sparse_keymatch_subwindow == (
            (384, 256), (512, 512), (512, 1024), (512, 512))
    ref = jta.generate_anchors(jfmap)["anchors"].reshape(-1, 7)
    assert anchors.shape == (200 * 176 * 2, 7)
    np.testing.assert_array_equal(anchors, ref.astype(np.float32))


def test_sparse_window_fields_are_checked():
    """Unequal per-block window lists are refused as the JAX builder
    refuses them."""
    m = config_io.load_config(PORT_CONFIGS / "second" / "car"
                              / "car.fhd.serving.config")["model"]["second"]
    m["middle_feature_extractor"]["keymatch_subwindow_strided"] = [256, 512]
    vg = t_voxel_builder.build(m["voxel_generator"])
    ta = t_target_assigner_builder.build(m["target_assigner"],
                                         m.get("box_coder", {}))
    with pytest.raises(ValueError, match="one pair per middle block"):
        t_second_builder.build_config(m, vg, ta)


def test_reader_syntax():
    text = """
    # comment
    a { b: 1 c: [1.5, -2e-3, inf] }  # trailing comment
    a: < b: 2; s: "x\\"y" 'z' >
    e: ENUM_NAME
    t: true, f: false
    r: 1
    r: 2
    """
    d = config_io.parse_text(text)
    assert d["a"][0] == {"b": 1, "c": [1.5, -2e-3, float("inf")]}
    assert d["a"][1] == {"b": 2, "s": 'x"yz'}
    assert d["e"] == "ENUM_NAME"
    assert d["t"] is True and d["f"] is False
    assert d["r"] == [1, 2]
    assert config_io.as_list(d["e"]) == ["ENUM_NAME"]
    assert config_io.as_list(None) == []
    with pytest.raises(config_io.ConfigSyntaxError):
        config_io.parse_text("a { b: 1")
    with pytest.raises(config_io.ConfigSyntaxError):
        config_io.parse_text("a: @")
