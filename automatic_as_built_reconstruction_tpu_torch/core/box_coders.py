"""Box coders: residual encodings between boxes and anchors.

The port's copy of the JAX package's ``core/box_coders.py`` (numpy, the
same formulas: encode and decode are equal to the reference's bit for
bit).  The training reader's target assignment encodes with them; the
device decode of ``predict`` is ``ops/box_ops.py::second_box_decode``.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np

from . import box_ops


class BoxCoder(abc.ABC):
    @property
    @abc.abstractmethod
    def code_size(self) -> int: ...

    @abc.abstractmethod
    def encode(self, boxes, anchors): ...

    @abc.abstractmethod
    def decode(self, encodings, anchors): ...


@dataclasses.dataclass
class GroundBox3dCoder(BoxCoder):
    """7-dof SECOND residual coder; optional (cos,sin) yaw vector encoding."""

    linear_dim: bool = False      # smooth (ratio-1) size encoding
    vec_encode: bool = False      # yaw as (cos,sin) difference vector

    @property
    def code_size(self) -> int:
        return 8 if self.vec_encode else 7

    def encode(self, boxes, anchors):
        return box_ops.second_box_encode(
            boxes, anchors, self.vec_encode, self.linear_dim)

    def decode(self, encodings, anchors):
        return box_ops.second_box_decode(
            encodings, anchors, self.vec_encode, self.linear_dim)


@dataclasses.dataclass
class BevBoxCoder(BoxCoder):
    """BEV 5-dof coder; z/h use fixed dataset-level bounds."""

    linear_dim: bool = False
    vec_encode: bool = False
    z_fixed: float = -1.0
    h_fixed: float = 2.0

    @property
    def code_size(self) -> int:
        return 6 if self.vec_encode else 5

    def encode(self, boxes, anchors):
        anchors = anchors[..., [0, 1, 3, 4, 6]]
        boxes = boxes[..., [0, 1, 3, 4, 6]]
        return box_ops.bev_box_encode(
            boxes, anchors, self.vec_encode, self.linear_dim)

    def decode(self, encodings, anchors):
        anchors = anchors[..., [0, 1, 3, 4, 6]]
        ret = box_ops.bev_box_decode(
            encodings, anchors, self.vec_encode, self.linear_dim)
        z_fixed = np.full([*ret.shape[:-1], 1], self.z_fixed, dtype=ret.dtype)
        h_fixed = np.full([*ret.shape[:-1], 1], self.h_fixed, dtype=ret.dtype)
        return np.concatenate(
            [ret[..., :2], z_fixed, ret[..., 2:4], h_fixed, ret[..., 4:]],
            axis=-1)
