"""Optimizer and LR schedule: the counterpart of the JAX package's
train/optimizer.py, ``chain(clip_by_global_norm(1.0), adamw | sgd)`` with a
warmup-cosine schedule, computed as optax computes it:

* clip: with n the global L2 norm of all gradients, gradients are left as
  they are when n < 1 and multiplied by 1/n otherwise
  (``torch.nn.utils.clip_grad_norm_`` divides by n + 1e-6 instead);
* AdamW (b1 0.9, b2 0.999, eps 1e-8): bias-corrected moments, then
  ``weight_decay * param`` added to the update of every parameter, then
  the update scaled by -lr(t);
* SGD: the update is -lr(t) * gradient;
* lr(t) rises linearly from 0 at t = 0 to the peak at ``warmup_steps``,
  then follows a cosine down to 0.1 x peak at ``steps``; t counts the
  updates made before this one, so the first update has lr 0.

Moments and the count are the whole state: ``state_dict`` holds them by
parameter name, which ``convert.adamw_state_from_optax`` also produces.

On a mesh whose model axis splits parameters (``model_group``,
parallel/sharding.py), a rank holds its shards and their moments; the
global norm sums each split parameter's squares over the model group
once, and counts a replicated parameter once (every rank of the group
holds the same gradient of it).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from dnn_page_vectors_tpu_torch.config import TrainConfig
from dnn_page_vectors_tpu_torch.parallel.mesh import group_size
from dnn_page_vectors_tpu_torch.parallel.sharding import spec_for_param

CLIP_NORM = 1.0


def warmup_cosine(cfg: TrainConfig):
    """optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(steps, warmup + 1), 0.1 * lr) as a function of the update count."""
    peak = cfg.learning_rate
    warmup = max(cfg.warmup_steps, 1)
    decay = max(cfg.steps, cfg.warmup_steps + 1) - warmup
    alpha = 0.0 if peak == 0.0 else 0.1

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


class ClippedOptimizer:
    """Global-norm clip, then AdamW or SGD, over named float32 parameters.
    ``step()`` reads each parameter's ``.grad``, updates the parameters in
    place, and returns the gradients' global norm before clipping."""

    def __init__(self, cfg: TrainConfig,
                 params: Iterable[Tuple[str, torch.nn.Parameter]],
                 model_group=None):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.weight_decay = cfg.weight_decay
        self.schedule = warmup_cosine(cfg)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.params: Dict[str, torch.nn.Parameter] = dict(params)
        self.model_group = model_group
        self.count = 0                       # updates made so far
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        if self.kind == "adamw":
            for name, p in self.params.items():
                self.mu[name] = torch.zeros_like(p)
                self.nu[name] = torch.zeros_like(p)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = {}
        for n, p in self.params.items():
            if p.grad is None:
                raise RuntimeError(f"parameter {n} has no gradient")
            grads[n] = p.grad
        norm = self.global_norm(grads)
        # optax: select(norm < max_norm, g, g / norm * max_norm)
        factor = torch.where(norm < CLIP_NORM, torch.ones_like(norm),
                             CLIP_NORM / norm)
        lr = self.schedule(self.count)
        self.count += 1
        if self.kind == "sgd":
            for n, p in self.params.items():
                p.add_(grads[n] * factor, alpha=-lr)
            return norm
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n] * factor
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        return norm

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        if group_size(self.model_group) == 1:
            return torch.sqrt(sum((g.float() * g.float()).sum()
                                  for g in grads.values()))
        sq = {n: (g.float() * g.float()).sum() for n, g in grads.items()}
        device = next(iter(grads.values())).device
        split = sum((sq[n] for n in sq if spec_for_param(n) is not None),
                    torch.zeros((), device=device))
        torch.distributed.all_reduce(split, group=self.model_group)
        return torch.sqrt(split + sum(
            sq[n] for n in sq if spec_for_param(n) is None))

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        """Copies moments into place; refuses other names or shapes."""
        for key in ("mu", "nu"):
            got, have = state[key], getattr(self, key)
            if set(got) != set(have):
                raise ValueError(f"optimizer state {key}: parameters "
                                 f"{sorted(set(got) ^ set(have))} differ")
            for n, t in got.items():
                if tuple(t.shape) != tuple(have[n].shape):
                    raise ValueError(f"optimizer state {key}[{n}]: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(have[n].shape)}")
            for n, t in got.items():
                have[n].copy_(t)
        self.count = int(state["count"])


def make_optimizer(cfg: TrainConfig, params,
                   model_group=None) -> ClippedOptimizer:
    """`params`: named parameters, e.g. ``model.named_parameters()``;
    `model_group`: the mesh's model group where it splits them."""
    return ClippedOptimizer(cfg, params, model_group)
