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
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "jaxlib", "google.protobuf")
             or m == "automatic_as_built_reconstruction_tpu"
             or m.startswith(("jax.", "flax.",
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
