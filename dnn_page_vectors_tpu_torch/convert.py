"""Weights from the JAX package into the port, and back.

``params_from_flax`` takes a flax parameter tree as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and returns a torch
state dict for the port's module of the same structure:

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed), with
  or without a ``bias`` (the t5 blocks' Dense layers, ``wi_0`` and
  ``wi_1`` among them, have none);
* Embed ``embedding`` -> ``weight``;
* everything else keeps its name and layout: Dense and LayerNorm
  ``bias``, LayerNorm and RmsNorm ``scale``, ``pos_embed``, the t5
  ``rel_bias`` table [32, H], ``log_scale``.

Module paths are joined with dots (``query_tower/block0/attn/wq`` ->
``query_tower.block0.attn.wq``), which is how the port names its modules.
``flax_from_state_dict`` is the inverse.

``adamw_state_from_optax`` carries training state across: the optax state
of ``chain(clip_by_global_norm, adamw)`` (numpy leaves) becomes the state
of the port's optimizer (train/optimizer.py), so a run trained in JAX can
continue in the port.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) -> torch state dict (float32 tensors)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, np.float32)
        head, _, name = path.rpartition(".")
        if name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{path}: only Dense kernels are ported "
                                 f"(got shape {arr.shape})")
            name, arr = "weight", arr.T
        elif name == "embedding":
            name = "weight"
        key = f"{head}.{name}" if head else name
        out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out


def flax_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """torch state dict -> {"params": nested dict of numpy arrays}. A
    ``weight`` under a module named ``tok_embed`` is an Embed table; every
    other ``weight`` is a Dense kernel (transposed back)."""
    params: Dict[str, Any] = {}
    for key, val in state.items():
        arr = val.detach().cpu().float().numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            if len(parts) > 1 and parts[-2] == "tok_embed":
                parts[-1] = "embedding"
            else:
                parts[-1], arr = "kernel", arr.T
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.array(arr, order="C")
    return {"params": params}


def _find_adam_state(state: Any):
    """The ScaleByAdamState inside an optax chain state: the one node with
    ``count``, ``mu`` and ``nu`` (found by its fields, so optax itself is
    not imported)."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adamw_state_from_optax(opt_state: Any) -> Dict[str, Any]:
    """optax ``chain(clip_by_global_norm(1.0), adamw(...))`` state, with
    numpy leaves, -> ``ClippedOptimizer.state_dict()`` form: {"count": int,
    "mu": {name: tensor}, "nu": {name: tensor}}. The moments' trees are
    flax parameter trees and map like the parameters (Dense kernels
    transposed). The adam count is the number of updates made, which is
    also the schedule's position."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the optax state: "
                         "want the state of chain(clip_by_global_norm, adamw)")
    return {"count": int(np.asarray(adam.count)),
            "mu": params_from_flax(adam.mu),
            "nu": params_from_flax(adam.nu)}
