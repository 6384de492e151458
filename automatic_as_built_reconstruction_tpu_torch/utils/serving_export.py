"""Serving artifacts through ``torch.export``.

The port of the JAX package's ``utils/serving_export.py``: the whole
single-device serving program of a :class:`~..parallel.inference.
PodInference` (voxelize -> network -> decode + rotated NMS, as
``PodInference.program`` runs it, with the weights inside) in one
serialized artifact that a deployment host loads and calls without the
model code, the config system or a checkpoint directory.

Where the reference lowers to StableHLO (``jax.export``), the port
exports a ``torch.export`` program on the device it names (``cuda`` or
``cpu``).  The hand-written kernels are the registered operators of
``ops/library.py``, so the exported graph holds them as ops: a loaded
artifact launches the CUDA kernels on the card (and counts them on the
wrappers' counters) and their plain versions on the CPU.  NMS decides on
the device (``ops/nms.py``: a ``while_loop`` and a ``cond`` node), so
nothing of the program waits on the host.

An artifact is framed as the reference frames one: ``_MAGIC``, a 4-byte
little-endian metadata length, JSON metadata (the reference's keys and a
``format`` key naming ``torch.export``), then the ``torch.export.save``
payload.  Loading and calling an artifact imports ``ops/library.py``
(and, at the first call of an op, its wrapper module in ``ops/``) and
nothing under ``models/``, ``builder/`` or ``train/``.
"""
from __future__ import annotations

import io
import json
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import fp32_math, resolve_device
from ..ops import library  # noqa: F401  (registers the ops a program calls)

_MAGIC = b"ABRSERVE1\n"
FORMAT = "torch.export"
OUTPUTS = ("box3d_lidar", "scores", "label_preds", "valid")
PLATFORMS = ("cuda", "cpu")


class _Program(torch.nn.Module):
    """A pod's serving program as a module: (points, num_valid) -> the
    OUTPUTS tensors."""

    def __init__(self, pod):
        super().__init__()
        self.model = pod.model
        self._pod = pod

    def forward(self, points, num_valid):
        out = self._pod.program(points, num_valid)
        return tuple(out[k] for k in OUTPUTS)


def _platform(platforms: Sequence[str]) -> str:
    platforms = tuple(platforms)
    if "tpu" in platforms:
        raise ValueError("platform 'tpu': the port exports a torch.export "
                         "program for 'cuda' or 'cpu'; a TPU artifact "
                         "comes from the JAX package's export_serving")
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"platforms {platforms}: want one of {PLATFORMS} "
                         f"(a torch.export program runs on the device it "
                         f"was exported on)")
    return platforms[0]


def export_serving(pod, batch: int, max_points: int, num_features: int = 4,
                   platforms: Sequence[str] = ("cuda",)) -> bytes:
    """Serialize a single-device ``PodInference`` program.

    Args:
        pod: a built PodInference (``mesh=None``) on the device that
            ``platforms`` names.
        batch / max_points / num_features: the static serving shapes —
            points [batch, max_points, num_features] float32 + num_valid
            [batch] int32.
        platforms: ``("cuda",)`` (the default: exported on the card) or
            ``("cpu",)``.

    Returns the artifact bytes (header + metadata + ``torch.export``
    payload).
    """
    if getattr(pod, "mesh", None) is not None:
        raise ValueError("export_serving packages the single-device "
                         "program; shard batches across artifact "
                         "replicas (or use PodInference in-process)")
    platform = _platform(platforms)
    dev = resolve_device(platform)
    if pod.device.type != dev.type:
        raise ValueError(f"the pod serves on {pod.device}: build it with "
                         f"device={platform!r} to export for {platform}")
    args = (torch.zeros((batch, max_points, num_features),
                        dtype=torch.float32, device=pod.device),
            torch.zeros((batch,), dtype=torch.int32, device=pod.device))
    with torch.no_grad(), fp32_math():
        exported = torch.export.export(_Program(pod).eval(), args)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    meta = json.dumps({
        "batch": batch, "max_points": max_points,
        "num_features": num_features, "platforms": [platform],
        "voxelization": pod.voxelization, "outputs": list(OUTPUTS),
        "format": FORMAT}).encode()
    return _MAGIC + len(meta).to_bytes(4, "little") + meta + buf.getvalue()


class ServingArtifact:
    """A loaded artifact: ``artifact(points, num_valid) -> detections``."""

    def __init__(self, meta: Dict, exported):
        self.meta = meta
        self.device = resolve_device(meta["platforms"][0])
        self._exported = exported
        self._module = exported.module()

    def __call__(self, points: np.ndarray,
                 num_valid: np.ndarray) -> Dict[str, np.ndarray]:
        """points [batch, max_points, num_features] + num_valid [batch]
        -> the numpy dict of ``PodInference.__call__``.  Runs in full
        float32 (``device.fp32_math``: the TF32 flags are process state
        that the program does not hold), the caller's flags restored."""
        m = self.meta
        want = (m["batch"], m["max_points"], m["num_features"])
        if tuple(np.shape(points)) != want or np.shape(num_valid) != want[:1]:
            raise ValueError(f"points {np.shape(points)} / num_valid "
                             f"{np.shape(num_valid)}: the artifact takes "
                             f"{want} / {want[:1]}")
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)
        nv = torch.as_tensor(np.asarray(num_valid, np.int32),
                             device=self.device)
        with torch.no_grad(), fp32_math():
            out = self._module(pts, nv)
        return {k: v.cpu().numpy() for k, v in zip(m["outputs"], out)}


def load_serving(blob: bytes) -> ServingArtifact:
    """Artifact bytes -> :class:`ServingArtifact` (refuses anything but
    the port's ``torch.export`` artifacts)."""
    if not blob.startswith(_MAGIC):
        raise ValueError("not an ABRSERVE1 artifact")
    off = len(_MAGIC)
    n = int.from_bytes(blob[off:off + 4], "little")
    meta = json.loads(blob[off + 4:off + 4 + n].decode())
    if meta.get("format") != FORMAT:
        raise ValueError(f"artifact format {meta.get('format')!r}: not a "
                         f"{FORMAT} program (a JAX-package artifact is "
                         f"StableHLO; load it with that package)")
    exported = torch.export.load(io.BytesIO(blob[off + 4 + n:]))
    return ServingArtifact(meta, exported)


def export_serving_from_checkpoint(
        config_path, model_dir, output_path, *, batch: int = 8,
        max_points: int = 60000, platforms: Sequence[str] = ("cuda",),
        max_voxels: int = 20000, max_points_per_voxel: int = 32,
        voxelization: str = "hard") -> Tuple[int, Dict]:
    """Config + the latest checkpoint of a port model directory (``train``
    or ``import_torch_weights``) -> artifact file.  With no checkpoint it
    warns and exports random weights from seed 0, as
    ``pod_inference_from_checkpoint`` serves them.  Returns (bytes
    written, metadata)."""
    from ..parallel.inference import pod_inference_from_checkpoint

    pod = pod_inference_from_checkpoint(
        config_path, model_dir, device=_platform(platforms),
        max_voxels=max_voxels, max_points_per_voxel=max_points_per_voxel,
        voxelization=voxelization)
    blob = export_serving(pod, batch, max_points, platforms=platforms)
    with open(output_path, "wb") as f:
        f.write(blob)
    return len(blob), load_serving(blob).meta
