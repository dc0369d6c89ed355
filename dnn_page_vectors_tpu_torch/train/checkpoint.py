"""Checkpoint and resume: the counterpart of the JAX package's
train/checkpoint.py, torch-native (``torch.save`` files instead of orbax).

A checkpoint is one file ``step_<step>.pt`` under the manager's directory
holding a nested dict of tensors and ints: the trainer saves the model's
parameters, the optimizer's moments and update count (the schedule's
position) and the step. The data cursor needs no state of its own: the
batcher derives (epoch, offset) from the restored step.

* Writes are atomic: a temporary file in the same directory, then
  ``os.replace``. A crash mid-save leaves the older checkpoints whole.
* ``max_to_keep`` newest checkpoints are kept; older ones are deleted
  after a save.
* ``restore`` validates what it reads against a state of the wanted
  structure (the same keys, the same shapes, finite floats) and refuses a
  state that differs. With ``step=None`` it restores the newest step that
  loads and validates, rolling back past a corrupt newer file; an explicit
  step is restored or raises.
"""
from __future__ import annotations

import os
import pickle
import re
import warnings
from typing import Any, List, Mapping, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.pt")

    def save(self, step: int, state: Mapping[str, Any]) -> str:
        """Writes `state` (tensors are copied to the CPU) for `step`,
        atomically, then prunes to the newest max_to_keep."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(_to_cpu(state), tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))
        return path

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Mapping[str, Any],
                step: Optional[int] = None) -> dict:
        """The saved state, validated against `state_like` (a state of the
        wanted structure; its tensors' shapes are the contract). Tensors
        come back on the CPU."""
        steps = self.all_steps()
        if step is not None:
            if step not in steps:
                raise FileNotFoundError(
                    f"no checkpoint for step {step} in {self.directory} "
                    f"(available steps: {steps or 'none'})")
            return self._load(step, state_like)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        errors = []
        for s in reversed(steps):
            try:
                out = self._load(s, state_like)
            except (OSError, RuntimeError, ValueError, EOFError,
                    pickle.UnpicklingError) as e:
                # a torn or corrupt file: the case rollback exists for
                errors.append(f"step {s}: {type(e).__name__}: {e}")
                continue
            if errors:
                warnings.warn(f"checkpoint rollback in {self.directory}: "
                              f"restored step {s}; skipped "
                              + "; ".join(x[:200] for x in errors))
            return out
        raise RuntimeError(f"every checkpoint in {self.directory} failed to "
                           "restore: " + "; ".join(x[:200] for x in errors))

    def _load(self, step: int, state_like: Mapping[str, Any]) -> dict:
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        err = _validate(state, state_like)
        if err:
            raise ValueError(f"checkpoint step {step} does not fit: {err}")
        return state


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, Mapping):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _validate(got: Any, want: Any, path: str = "") -> Optional[str]:
    """Same keys, same tensor shapes and dtypes, finite floats."""
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping):
            return f"{path or 'state'}: not a dict"
        if set(got) != set(want):
            return (f"{path or 'state'}: keys differ: "
                    f"{sorted(map(str, set(got) ^ set(want)))[:10]}")
        for k in want:
            err = _validate(got[k], want[k], f"{path}.{k}" if path else str(k))
            if err:
                return err
        return None
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            return f"{path}: not a tensor"
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            return (f"{path}: {tuple(got.shape)} {got.dtype} != expected "
                    f"{tuple(want.shape)} {want.dtype}")
        if got.is_floating_point() and not torch.isfinite(got).all():
            return f"{path}: non-finite values"
        return None
    if type(got) is not type(want):
        return f"{path}: {type(got).__name__} != {type(want).__name__}"
    return None
