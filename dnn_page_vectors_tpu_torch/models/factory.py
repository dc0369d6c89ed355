"""Encoder factory: Config -> TwoTower module with seeded random weights.

Counterpart of the JAX package's models/factory.py. The port builds the
``bert`` and ``t5`` encoders; the other encoders raise NotImplementedError
naming the slice of the port that brings them.

Initialization draws from one ``torch.Generator`` seeded by
``cfg.train.seed`` on the CPU, then moves the module to ``device``, so the
weights do not depend on the device. The distributions follow flax's
defaults (Dense: lecun normal, bias 0; Embed: normal, std 1/sqrt(d);
pos_embed and rel_bias: normal, std 0.02; LayerNorm: scale 1, bias 0;
RmsNorm: scale 1); the numbers
differ from JAX's, whose generator is another. Weights trained in JAX carry
over through convert.py.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.models.transformer import (
    VARIANTS, Dense, LayerNorm, RmsNorm, TransformerEncoder)
from dnn_page_vectors_tpu_torch.models.two_tower import TwoTower
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_LATER = {
    "cdssm": "slice 5 (CDSSM, Kim-CNN and LSTM)",
    "kim_cnn": "slice 5 (CDSSM, Kim-CNN and LSTM)",
    "lstm": "slice 5 (CDSSM, Kim-CNN and LSTM)",
}


def _build_encoder(cfg: Config, vocab_size: int) -> nn.Module:
    m = cfg.model
    if m.encoder in _LATER:
        raise NotImplementedError(
            f"encoder {m.encoder!r} is not ported yet: it comes with "
            f"{_LATER[m.encoder]} of the port")
    if m.encoder not in VARIANTS:
        raise ValueError(f"unknown encoder {m.encoder!r}")
    if m.attention not in ("dense", "flash"):
        raise ValueError(f"unknown attention kind {m.attention!r} (want "
                         "dense | flash; ring attention is a later slice)")
    if m.dtype not in DTYPES:
        raise ValueError(f"unknown model dtype {m.dtype!r} (want "
                         f"{' | '.join(DTYPES)})")
    return TransformerEncoder(
        vocab_size=vocab_size, num_layers=m.num_layers,
        num_heads=m.num_heads, model_dim=m.model_dim, mlp_dim=m.mlp_dim,
        out_dim=m.out_dim, max_len=max(cfg.data.query_len, cfg.data.page_len),
        dtype=DTYPES[m.dtype], attention_kind=m.attention,
        dropout=m.dropout, variant=m.encoder)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in a fixed module order (see the module docstring)."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            std = 1.0 / math.sqrt(mod.in_features)
            mod.weight.normal_(0.0, std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                               generator=generator)
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RmsNorm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, TransformerEncoder):
            table = mod.rel_bias if mod.variant == "t5" else mod.pos_embed
            table.normal_(0.0, 0.02, generator=generator)


def build_two_tower(cfg: Config, vocab_size: int,
                    device: DeviceLike = None) -> TwoTower:
    """Both towers share one tokenizer vocab (query/page differ only in
    length), so one vocab_size parameterises both. Returns the model in
    eval mode on `device` (``None`` = cuda)."""
    dev = resolve_device(device)
    query_tower = _build_encoder(cfg, vocab_size)
    page_tower = (None if cfg.model.shared_towers
                  else _build_encoder(cfg, vocab_size))
    model = TwoTower(query_tower, page_tower,
                     shared=cfg.model.shared_towers,
                     temperature_init=cfg.train.temperature_init)
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(dev).eval()
