"""PyTorch/CUDA port of ``automatic_as_built_reconstruction_tpu``.

The JAX package beside this one is the reference; this package serves, on
an NVIDIA Hopper GPU, the as-built pillar detector (voxelize ->
PillarFeatureNet -> pillar scatter -> RPN -> decode + rotated NMS) and
SECOND (voxelize -> SimpleVoxel -> the sparse middle stack -> RPN ->
decode + rotated NMS), and trains the pillar detector
(``train.train.train``).  Its hand-written CUDA kernels live in ``csrc/``
and are bound through ``ops/_build.py``:

- ``ops.pillar_scatter.scatter_sorted_to_canvas`` and its backward
  ``ops.pillar_scatter.pillar_gather`` (``csrc/pillar_scatter.cu``)
- ``ops.rotated_iou.rotate_iou_matrix`` (``csrc/rotated_iou.cu``)
- ``ops.sparse_gather_gemm.keymatch_gemm`` and ``.gather_gemm``
  (``csrc/sparse_gather_gemm.cu``)

Each kernel launch a served request makes is also a registered operator
(``ops/library.py``, namespace ``abr``), so that ``utils/serving_export.py``
can export the whole serving program with ``torch.export``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA request on a machine without a GPU raises.  The package imports
torch, numpy and the standard library only.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
