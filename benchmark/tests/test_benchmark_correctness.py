"""The comparison that decides ``correct``: the port against the
reference at a small size on the CPU, the lower-precision control, and
the faults a serve cell can have planted under the timed path."""
import numpy as np
import pytest
import torch

from benchmark import control, serve
from benchmark.tests import helpers


def _failed(result) -> dict:
    return {n: c["value"] for n, c in result["checks"].items()
            if c["value"] > c["limit"]}


@pytest.mark.parametrize("config,mix", [
    ("asbuilt_tiny", helpers.TINY_ROOMS),
    ("second_small", helpers.SMALL_STREET)])
def test_port_agrees_with_reference(config, mix):
    result = helpers.run(config, mix)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= mix["pool"] and result["failed"] == 0
    assert result["checks"]["head_gap"]["value"] < 1e-5


@pytest.mark.parametrize("stage,number", [
    ("vox", "vox_mismatch"), ("decode", "det_unmatched_pct")])
def test_lower_precision_control_fails(stage, number):
    result = helpers.run("asbuilt_tiny", helpers.TINY_ROOMS,
                         program_factory=control.factory([stage]),
                         control=True)
    assert not result["correct"]
    assert number in _failed(result)


def test_reference_in_full_precision_passes():
    result = helpers.run("asbuilt_tiny", helpers.TINY_ROOMS,
                         program_factory=control.factory([]), control=True)
    assert result["correct"], result["checks"]


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on a CUDA device only")
    result = helpers.run("asbuilt_tiny", helpers.TINY_ROOMS,
                         program_factory=control.factory(["net"]),
                         control=True, device="cuda")
    assert "head_gap" in _failed(result)


class _Broken:
    """The program's pod with a fault planted where its answer is made."""

    def __init__(self, pod, fault):
        object.__setattr__(self, "pod", pod)
        object.__setattr__(self, "fault", fault)

    def __getattr__(self, name):            # the harness's taps go to the
        return getattr(self.pod, name)      # program's own stages

    def __setattr__(self, name, value):
        setattr(self.pod, name, value)

    def __call__(self, points, num_valid):
        if self.fault == "half_batch":
            num_valid = np.array(num_valid)
            num_valid[len(num_valid) // 2:] = 0
        out = self.pod(points, num_valid)
        if self.fault == "altered_answer":      # one scan's answer, 1 cm off
            out = {k: v.copy() for k, v in out.items()}
            out["box3d_lidar"][0, :, 0] += 0.01
        return out


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_planted_fault_fails(fault):
    def factory(config, weights, device):
        return _Broken(serve.build_program(config, weights, device), fault)

    result = helpers.run("asbuilt_tiny", helpers.TINY_ROOMS,
                         program_factory=factory)
    assert not result["correct"], result["checks"]
