"""Encoder factory: Config -> TwoTower module with seeded random weights.

Counterpart of the JAX package's models/factory.py: the ``cdssm``,
``kim_cnn``, ``lstm``, ``bert`` and ``t5`` encoders.

Initialization draws from one ``torch.Generator`` seeded by
``cfg.train.seed`` on the CPU, then moves the module to ``device``, so the
weights do not depend on the device. The distributions follow flax's
defaults (Dense: lecun normal, bias 0; Conv: lecun normal over fan-in =
in_channels x width, bias 0; the LSTM's ``rec*``: orthogonal; Embed:
normal, std 1/sqrt(d); pos_embed and rel_bias: normal, std 0.02;
LayerNorm: scale 1, bias 0; RmsNorm: scale 1); the numbers
differ from JAX's, whose generator is another. Weights trained in JAX carry
over through convert.py.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.models.cdssm import CdssmEncoder
from dnn_page_vectors_tpu_torch.models.conv import Conv
from dnn_page_vectors_tpu_torch.models.kim_cnn import KimCnnEncoder
from dnn_page_vectors_tpu_torch.models.lstm import LstmEncoder
from dnn_page_vectors_tpu_torch.models.transformer import (
    VARIANTS, Dense, LayerNorm, RmsNorm, TransformerEncoder)
from dnn_page_vectors_tpu_torch.models.two_tower import TwoTower
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

def _build_encoder(cfg: Config, vocab_size: int) -> nn.Module:
    m = cfg.model
    if m.dtype not in DTYPES:
        raise ValueError(f"unknown model dtype {m.dtype!r} (want "
                         f"{' | '.join(DTYPES)})")
    dtype = DTYPES[m.dtype]
    if m.encoder == "cdssm":
        return CdssmEncoder(vocab_size=vocab_size, embed_dim=m.embed_dim,
                            conv_width=m.conv_widths[0],
                            conv_channels=m.conv_channels, out_dim=m.out_dim,
                            dtype=dtype)
    if m.encoder == "kim_cnn":
        return KimCnnEncoder(vocab_size=vocab_size, embed_dim=m.embed_dim,
                             conv_widths=m.conv_widths,
                             conv_channels=m.conv_channels, out_dim=m.out_dim,
                             dropout=m.dropout, dtype=dtype)
    if m.encoder == "lstm":
        return LstmEncoder(vocab_size=vocab_size, embed_dim=m.embed_dim,
                           hidden_dim=m.model_dim, num_layers=m.num_layers,
                           out_dim=m.out_dim, dropout=m.dropout, dtype=dtype)
    if m.encoder not in VARIANTS:
        raise ValueError(f"unknown encoder {m.encoder!r}")
    if m.attention not in ("dense", "flash"):
        raise ValueError(f"unknown attention kind {m.attention!r} (want "
                         "dense | flash; ring attention is a later slice)")
    return TransformerEncoder(
        vocab_size=vocab_size, num_layers=m.num_layers,
        num_heads=m.num_heads, model_dim=m.model_dim, mlp_dim=m.mlp_dim,
        out_dim=m.out_dim, max_len=max(cfg.data.query_len, cfg.data.page_len),
        dtype=dtype, attention_kind=m.attention,
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
        elif isinstance(mod, Conv):
            fan_in = mod.in_channels * mod.kernel_size[0]
            mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                               generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                               generator=generator)
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RmsNorm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, LstmEncoder):
            for _, rec in sorted(mod.named_parameters(recurse=False)):
                nn.init.orthogonal_(rec, generator=generator)
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
