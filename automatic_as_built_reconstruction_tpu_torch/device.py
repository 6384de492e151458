"""Device resolution (``cuda`` by default, the CPU only when asked for)
and the fp32 arithmetic the entry points run in."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` / ``torch.device`` -> device.

    Raises when CUDA is asked for and ``torch.cuda.is_available()`` is
    false: the port never carries on quietly on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def fp32_math(deterministic: bool = False):
    """Full fp32 inside the block: TF32 off for cuDNN convolutions (on by
    PyTorch's default) and cuBLAS matmuls, whatever the caller's global
    flags; with ``deterministic`` also cuDNN's deterministic algorithms
    (the training step: without them two runs from one seed and one batch
    stream part after a step, the RPN convolutions' backward summing in
    another order; ``train_determinism.py``).  The caller's flags are
    restored on the way out.  The flags are process-wide, so two threads
    must not run entry points at once."""
    backends = torch.backends
    conv, matmul = backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32
    det = backends.cudnn.deterministic
    backends.cudnn.allow_tf32 = False
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.deterministic = det or deterministic
    try:
        yield
    finally:
        backends.cudnn.allow_tf32 = conv
        backends.cuda.matmul.allow_tf32 = matmul
        backends.cudnn.deterministic = det
