"""Checkpoints of the training state with latest-step semantics.

The port of the JAX package's ``train/checkpoint.py`` (``CheckpointManager``
:18, ``try_restore_latest`` :48) without orbax: each checkpoint is the
directory ``<model_dir>/checkpoints/<step>/`` holding ``state.pt``, a
``torch.save`` of ``{"step", "model", "optimizer"}`` (the lineage-named
model ``state_dict``, BatchNorm statistics included, and the optimizer's
``state_dict``).  The semantics are orbax's as the reference uses them:
the latest step wins, at most ``max_to_keep`` checkpoints stay (the
oldest go), a save at a step not past the latest is skipped unless
``force``, and a forced save at a step that exists raises
:class:`StepAlreadyExistsError`.  A checkpoint is written to a temporary
directory and renamed into place, so a crash leaves no half checkpoint.
"""
from __future__ import annotations

import pathlib
import shutil
from typing import List, Optional

import torch

STATE_FILE = "state.pt"


class StepAlreadyExistsError(FileExistsError):
    pass


class CheckpointManager:
    def __init__(self, model_dir, max_to_keep: int = 8):
        self._dir = pathlib.Path(model_dir).absolute() / "checkpoints"
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False) -> bool:
        """Write ``state`` (a ``train.TrainState``) at ``step``.  -> True
        if written."""
        latest = self.latest_step()
        if not force and latest is not None and step <= latest:
            return False
        final = self._dir / str(step)
        if final.exists():
            raise StepAlreadyExistsError(f"checkpoint step {step} exists in "
                                         f"{self._dir}")
        tmp = self._dir / f".tmp-{step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"step": int(step), "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()},
                   tmp / STATE_FILE)
        tmp.rename(final)
        for old in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(self._dir / str(old))
        return True

    def _load(self, step: Optional[int], device) -> Optional[dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._dir / str(step) / STATE_FILE,
                          map_location=device, weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (the latest if None) into
        ``state`` (model, optimizer, step).  -> ``state``, or None if there
        is no checkpoint."""
        ckpt = self._load(step, next(state.model.parameters()).device)
        if ckpt is None:
            return None
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state

    def restore_model(self, model: torch.nn.Module,
                      step: Optional[int] = None) -> Optional[int]:
        """Load only the model of the checkpoint at ``step`` (the latest if
        None).  -> its step, or None if there is no checkpoint."""
        ckpt = self._load(step, next(model.parameters()).device)
        if ckpt is None:
            return None
        model.load_state_dict(ckpt["model"], strict=True)
        return int(ckpt["step"])


def try_restore_latest(model_dir, state):
    """(state, step) from the latest checkpoint, or (None, 0)."""
    mgr = CheckpointManager(model_dir)
    step = mgr.latest_step()
    if step is None:
        return None, 0
    return mgr.restore(state, step), step
