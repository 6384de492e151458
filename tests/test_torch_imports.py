"""The port stands alone: it imports no JAX, no flax and nothing of the
JAX package, and its entry points refuse a missing GPU instead of
falling back to the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from automatic_as_built_reconstruction_tpu_torch import resolve_device
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)

REPO = Path(__file__).resolve().parents[1]

_CHECK = """
import sys
import automatic_as_built_reconstruction_tpu_torch
import automatic_as_built_reconstruction_tpu_torch.parallel
import automatic_as_built_reconstruction_tpu_torch.builder.second_builder
import automatic_as_built_reconstruction_tpu_torch.data.building
import automatic_as_built_reconstruction_tpu_torch.data.kitti_like
import automatic_as_built_reconstruction_tpu_torch.models.middle
import automatic_as_built_reconstruction_tpu_torch.models.middle_plans
import automatic_as_built_reconstruction_tpu_torch.ops.sparse_conv
import automatic_as_built_reconstruction_tpu_torch.ops.sparse_gather_gemm
import automatic_as_built_reconstruction_tpu_torch.utils.seeded_init
import automatic_as_built_reconstruction_tpu_torch.builder.input_reader_builder
import automatic_as_built_reconstruction_tpu_torch.core.geometry
import automatic_as_built_reconstruction_tpu_torch.core.point_refine
import automatic_as_built_reconstruction_tpu_torch.core.voxelize
import automatic_as_built_reconstruction_tpu_torch.data.batching
import automatic_as_built_reconstruction_tpu_torch.data.dataset
import automatic_as_built_reconstruction_tpu_torch.data.preprocess
import automatic_as_built_reconstruction_tpu_torch.ops.voxel_mean
import automatic_as_built_reconstruction_tpu_torch.ops.voxelize
import automatic_as_built_reconstruction_tpu_torch.train.input_pipeline
import automatic_as_built_reconstruction_tpu_torch.train.train
import automatic_as_built_reconstruction_tpu_torch.utils.eval
import automatic_as_built_reconstruction_tpu_torch.builder.box_coder_builder
import automatic_as_built_reconstruction_tpu_torch.builder.losses_builder
import automatic_as_built_reconstruction_tpu_torch.builder.optimizer_builder
import automatic_as_built_reconstruction_tpu_torch.builder.similarity_calculator_builder
import automatic_as_built_reconstruction_tpu_torch.builder.target_assigner_builder
import automatic_as_built_reconstruction_tpu_torch.core.augment
import automatic_as_built_reconstruction_tpu_torch.core.box_coders
import automatic_as_built_reconstruction_tpu_torch.core.region_similarity
import automatic_as_built_reconstruction_tpu_torch.core.target_assign
import automatic_as_built_reconstruction_tpu_torch.models.losses
import automatic_as_built_reconstruction_tpu_torch.train.checkpoint
import automatic_as_built_reconstruction_tpu_torch.train.metrics
import automatic_as_built_reconstruction_tpu_torch.utils.progress
import automatic_as_built_reconstruction_tpu_torch.builder.dbsampler_builder
import automatic_as_built_reconstruction_tpu_torch.core.box_ops
import automatic_as_built_reconstruction_tpu_torch.core.sample_ops
import automatic_as_built_reconstruction_tpu_torch.data.create_data
import automatic_as_built_reconstruction_tpu_torch.data.kitti_common
import automatic_as_built_reconstruction_tpu_torch.data.kitti_dataset
import automatic_as_built_reconstruction_tpu_torch.data.synth_kitti
import chip_smoke
import rotated_iou_ablation
import sparse_gemm_ablation
import train_precision
import voxel_mean_ablation
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "orbax", "jaxlib",
                      "google.protobuf")
             or m == "automatic_as_built_reconstruction_tpu"
             or m.startswith(("jax.", "flax.", "optax.", "orbax.",
                              "automatic_as_built_reconstruction_tpu.")))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    # a subprocess: tests/conftest.py has already imported jax here
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        pod_inference_from_checkpoint(
            REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
            / "building" / "asbuilt_pillars_tiny.config",
            REPO / "artifacts" / "asbuilt_r2_step8000.pkl")
    assert resolve_device("cpu") == torch.device("cpu")


def test_every_module_of_the_port_is_checked():
    """Every .py file of the package imports in a fresh interpreter
    without pulling in jax, flax, protobuf or the JAX package."""
    pkg = REPO / "automatic_as_built_reconstruction_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py"
        and "_build" not in p.parts)
    assert len(mods) > 54
    code = ("import sys, importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
              "'automatic_as_built_reconstruction_tpu') "
              "or m.startswith('google.protobuf'))\n"
              "print('BAD', bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
