"""Tensor-parallel rules: which parameter the mesh's model axis splits,
and on which dimension.

Counterpart of the JAX package's parallel/sharding.py. Its ``TP_RULES``
are regexes over flax paths with PartitionSpecs over flax layouts; these
are the same rules over the port's parameter names and torch layouts (a
Dense weight is [out, in], so flax's output axis 1 is torch's 0):

* attention ``wq``, ``wk``, ``wv``: weight and bias by output;
* attention ``wo``: weight by input;
* MLP ``wi`` / ``wi_0`` / ``wi_1``: weight and bias by output;
* MLP ``wo_mlp``: weight by input;
* ``tok_embed``: by features.

Everything else (norms, the output projections' biases, ``pos_embed``,
the t5 ``rel_bias`` table, ``proj``, ``log_scale``, every parameter of the
towers without attention) is replicated. models/transformer.py builds a
rank's modules at these shapes.

``shard_params`` cuts a rank's part of a full state dict,
``gather_params`` puts the full tensors together from the shards (every
rank of a model group calls it). A rank's part of the global batch is
cut where it is read: data/loader.py's ``TrainBatcher(process_index=,
process_count=)``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from dnn_page_vectors_tpu_torch.parallel.mesh import Mesh, group_size

# (name regex, split dimension in the torch layout). First match wins.
TP_RULES: List[Tuple[str, int]] = [
    (r".*\.attn\.w[qkv]\.weight$", 0),
    (r".*\.attn\.w[qkv]\.bias$", 0),
    (r".*\.attn\.wo\.weight$", 1),
    (r".*\.(wi|wi_0|wi_1)\.weight$", 0),
    (r".*\.(wi|wi_0|wi_1)\.bias$", 0),
    (r".*\.wo_mlp\.weight$", 1),
    (r".*\.tok_embed\.weight$", 1),
]


def spec_for_param(name: str) -> Optional[int]:
    """The dimension the model axis splits parameter `name` on, or None
    (replicated)."""
    for pattern, dim in TP_RULES:
        if re.match(pattern, name):
            return dim
    return None


def _slice(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    if t.shape[dim] % parts:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"divide over mesh.model={parts}")
    width = t.shape[dim] // parts
    return t.narrow(dim, index * width, width).contiguous()


def shard_params(state: Mapping[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's part of a full state dict (or of optimizer moments
    keyed by parameter name): split tensors narrowed to its model index,
    the rest as they are."""
    out = {}
    for name, t in state.items():
        dim = spec_for_param(name)
        out[name] = (t if dim is None or mesh.model == 1
                     else _slice(t, dim, mesh.model, mesh.model_index))
    return out


def gather_params(state: Mapping[str, torch.Tensor], mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """The full tensors of a rank's state dict: each split tensor
    all-gathered over the model group (a collective: every rank of the
    group calls it, with the same names in the same order)."""
    group = mesh.group("model")
    out = {}
    for name, t in state.items():
        dim = spec_for_param(name)
        if dim is None or group_size(group) == 1:
            out[name] = t
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.model)]
        dist.all_gather(parts, t, group=group)
        out[name] = torch.cat(parts, dim)
    return out

