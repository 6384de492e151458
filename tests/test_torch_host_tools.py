"""The port's copies of three host modules that only the JAX package's
tests reach, held to the JAX package on the same inputs:

- ``core/bev_ops.py::points_to_bev``: the maps bit for bit;
- ``core/nms.py``: ``nms`` and ``rotate_nms`` keep the same indices;
- ``utils/config_tool.py`` over the port's config reader (no protobuf):
  on every shipped config, ``change_detection_range`` applied on both
  sides gives the same config (the JAX message written by protobuf's
  ``text_format`` and read by the port's reader, against the port's dict,
  both taken as protobuf holds them: proto3 defaults left out, ``float``
  fields in single precision, map entries in no order), ``save_config``
  writes text that the port's reader reads back to an equal dict and
  protobuf parses to the JAX message, and ``get_downsample_factor``
  agrees.
"""
from pathlib import Path

import numpy as np
import pytest
from google.protobuf import descriptor, text_format

from automatic_as_built_reconstruction_tpu.core import (
    bev_ops as jax_bev_ops, nms as jax_nms)
from automatic_as_built_reconstruction_tpu.protos import pipeline_pb2
from automatic_as_built_reconstruction_tpu.utils import (
    config_tool as jax_config_tool)
from automatic_as_built_reconstruction_tpu_torch.builder import config_io
from automatic_as_built_reconstruction_tpu_torch.core import bev_ops, nms
from automatic_as_built_reconstruction_tpu_torch.utils import config_tool

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "automatic_as_built_reconstruction_tpu"
                  / "configs").rglob("*.config"))
NEW_RANGE = [-10.5, -20.25, 10.1, 20.3]


# --------------------------------------------------------------------------
# core/bev_ops.py
# --------------------------------------------------------------------------

def test_points_to_bev_unit_case():
    pts = np.array([[0.5, 0.5, 0.25, 0.8],
                    [0.5, 0.5, 0.75, 0.3],   # same cell, upper slab
                    [2.5, 1.5, 0.25, 0.1]], np.float32)
    bev = bev_ops.points_to_bev(pts, (1, 1, 0.5), (0, 0, 0, 4, 2, 1))
    want = jax_bev_ops.points_to_bev(pts, (1, 1, 0.5), (0, 0, 0, 4, 2, 1))
    assert bev.dtype == want.dtype and bev.shape == (4, 2, 4)
    np.testing.assert_array_equal(bev, want)
    assert bev[3, 0, 0] == pytest.approx(0.8)


@pytest.mark.parametrize("channels,with_intensity", [(4, True), (4, False),
                                                     (3, True)])
def test_points_to_bev_equals_reference(channels, with_intensity):
    """A scan with points outside the range and on cell faces."""
    rng = np.random.default_rng(channels + with_intensity)
    pts = rng.uniform([-2, -42, -4, 0], [72, 42, 2, 1],
                      (20000, 4)).astype(np.float32)[:, :channels]
    pts[:500, :2] = np.round(pts[:500, :2] / 0.2) * 0.2
    kw = dict(voxel_size=(0.2, 0.2, 0.5), coors_range=(0, -40, -3, 70.4, 40,
                                                       1),
              with_intensity=with_intensity)
    got, want = bev_ops.points_to_bev(pts, **kw), jax_bev_ops.points_to_bev(
        pts, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# core/nms.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pre,post", [(None, None), (60, None), (None, 7),
                                      (40, 5)])
def test_nms_keeps_the_reference_indices(pre, post):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 20, (120, 2))
    wh = rng.uniform(0.5, 4, (120, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.random(120)
    got = nms.nms(boxes, scores, 0.3, pre, post)
    want = jax_nms.nms(boxes, scores, 0.3, pre, post)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < 120


@pytest.mark.parametrize("pre,post", [(None, None), (50, 6)])
def test_rotate_nms_keeps_the_reference_indices(pre, post):
    rng = np.random.default_rng(4)
    rboxes = np.concatenate([rng.uniform(0, 12, (90, 2)),
                             rng.uniform(0.3, 3, (90, 2)),
                             rng.uniform(-np.pi, np.pi, (90, 1))], 1)
    rboxes[::9, 2:4] = 0.0                       # degenerate boxes
    scores = rng.random(90)
    got = nms.rotate_nms(rboxes, scores, 0.2, pre, post)
    want = jax_nms.rotate_nms(rboxes, scores, 0.2, pre, post)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < 90


# --------------------------------------------------------------------------
# utils/config_tool.py
# --------------------------------------------------------------------------

def _default(field, value) -> bool:
    """A proto3 field without presence at its default: not written."""
    if field.enum_type is not None:
        number = (field.enum_type.values_by_name[value].number
                  if isinstance(value, str) else value)
        return number == 0
    return value in (0, False, "")


def canon(d: dict, desc) -> dict:
    """A config dict as protobuf holds it: proto3 defaults left out,
    ``float`` fields rounded to single precision, enums by name, a map's
    entries as a dict."""
    out = {}
    for name, value in d.items():
        field = desc.fields_by_name[name]
        if field.is_repeated:
            values = [_canon_value(field, v)
                      for v in config_io.as_list(value)]
            if (values and field.message_type is not None
                    and field.message_type.GetOptions().map_entry):
                # a map: its entries in no order
                values = {v.get("key"): v.get("value") for v in values}
            if values:
                out[name] = values
        elif (field.message_type is not None
              or field.containing_oneof is not None
              or not _default(field, value)):
            out[name] = _canon_value(field, value)
    return out


def _canon_value(field, value):
    if field.message_type is not None:
        return canon(value, field.message_type)
    if field.type == descriptor.FieldDescriptor.TYPE_FLOAT:
        return float(np.float32(value))
    if field.enum_type is not None and not isinstance(value, str):
        return field.enum_type.values_by_number[value].name
    return value


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[p.stem for p in CONFIGS])
def test_config_tool_equals_reference(path, tmp_path):
    jcfg = jax_config_tool.read_config(path)
    cfg = config_tool.read_config(path)
    assert cfg == config_io.load_config(path)
    desc = pipeline_pb2.TrainEvalPipelineConfig.DESCRIPTOR
    assert canon(config_io.parse_text(text_format.MessageToString(jcfg)),
                 desc) == canon(cfg, desc)

    jax_config_tool.change_detection_range(jcfg.model.second, NEW_RANGE)
    m = cfg["model"]["second"]
    assert config_tool.change_detection_range(m, NEW_RANGE) is m
    assert m["voxel_generator"]["point_cloud_range"][:2] == NEW_RANGE[:2]
    assert canon(config_io.parse_text(text_format.MessageToString(jcfg)),
                 desc) == canon(cfg, desc)
    assert (config_tool.get_downsample_factor(m)
            == jax_config_tool.get_downsample_factor(jcfg.model.second))

    config_tool.save_config(cfg, tmp_path / "x.config")
    assert config_tool.read_config(tmp_path / "x.config") == cfg
    back = pipeline_pb2.TrainEvalPipelineConfig()
    text_format.Parse((tmp_path / "x.config").read_text(), back)
    assert back == jcfg


def test_text_writer_round_trips_every_value_kind():
    cfg = {"a": {"b": [1, 2], "c": "q\"uo\\te\n", "d": True, "e": -0.25,
                 "f": {}, "g": [{"h": 1}], "i": [], "j": float("inf")},
           "k": [{"l": "NormByNumPositives"}, {"l": "x"}], "m": 1e-05}
    text = config_io.to_text(cfg)
    assert config_io.parse_text(text) == cfg
    assert "l: NormByNumPositives" in text and 'l: "x"' in text
