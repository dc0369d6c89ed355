"""Config dataclasses for the port: the fields the BERT-mini and mT5
serving and training slices read, with the JAX package's names and
defaults (its config.py), the ``bert_mini_v5p16`` and ``mt5_multilingual``
presets, and ``get_config`` with dotted overrides.

Sections and fields of later slices (mesh, scan_steps, packing, index,
fleet, maintenance, ...) join as those slices land; an override naming a
field that is not here yet raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-side data pipeline settings."""
    tokenizer: str = "trigram"       # trigram | word | wordpiece | sentencepiece
    corpus: str = "toy"              # toy (jsonl:<path> is a later slice)
    num_pages: int = 10_000          # corpus size (toy generator)
    query_len: int = 16              # max tokens per query
    page_len: int = 64               # max tokens per page
    vocab_size: int = 30_000         # word / subword vocab size
    languages: int = 1               # >1: cross-lingual toy corpus
    num_topics: int = 64             # toy-corpus topics
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Encoder settings. The port builds the `bert` and `t5` encoders."""
    encoder: str = "cdssm"           # cdssm | kim_cnn | lstm | bert | t5
    out_dim: int = 128               # final vector dimension (both towers)
    num_layers: int = 4
    num_heads: int = 4
    mlp_dim: int = 1024
    model_dim: int = 256
    dropout: float = 0.1             # embedding, attention and MLP outputs
    attention: str = "dense"         # dense | flash (CUDA kernels K1-K4)
    shared_towers: bool = False      # share params between the towers
    dtype: str = "bfloat16"          # compute dtype; params stay float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer settings (train/loop.py). One process on one card: the
    batch is the whole global batch."""
    batch_size: int = 256            # pages (and queries) per step
    steps: int = 1_000
    optimizer: str = "adamw"         # adamw | sgd
    learning_rate: float = 1e-3      # peak of the warmup-cosine schedule
    warmup_steps: int = 100
    weight_decay: float = 0.01
    temperature_init: float = 20.0   # learnable inverse-temperature init
    hard_negatives: int = 0          # mined negatives per positive (mining
                                     # is a later slice: Trainer raises
                                     # above 0; the loss takes negatives)
    checkpoint_every: int = 500
    log_every: int = 50
    # >0: the chunked contrastive loss (models/losses.py) scores this many
    # query rows at a time, so the [B, B] logits never exist at once. Must
    # divide batch_size. 0 = the dense loss.
    loss_chunk: int = 0
    seed: int = 0                    # weights, data order and dropout masks


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    recall_k: int = 10               # Recall@10 query->page
    eval_queries: int = 1_000        # queries evaluate_recall embeds
    embed_batch_size: int = 512
    store_shard_size: int = 65_536   # vector-store shard rows (fp16 store)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs the lean SearchService reads."""
    # "exact" = brute-force top-k over the whole store staged on the card;
    # the IVF index is a later slice.
    index: str = "exact"


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "custom"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)


def _nested_replace(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {"model.attention": "flash"}."""
    for path, value in overrides.items():
        parts = path.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: value})
            continue
        section = getattr(cfg, parts[0])
        if not hasattr(section, parts[1]):
            raise KeyError(f"unknown config field {path!r} (not ported yet, "
                           "or misspelled)")
        # coerce CLI strings to the dataclass field's current type
        current = getattr(section, parts[1])
        if isinstance(current, bool):
            if value in (True, "true", "True", "1", 1):
                value = True
            elif value in (False, "false", "False", "0", 0):
                value = False
            else:
                raise ValueError(
                    f"bad boolean for {path}: {value!r} (use true/false)")
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        section = dataclasses.replace(section, **{parts[1]: value})
        cfg = dataclasses.replace(cfg, **{parts[0]: section})
    return cfg


def bert_mini_v5p16() -> Config:
    """Config 3: two-tower BERT-mini (query + page) with in-batch negatives.
    BERT-mini: L=4, d=256, A=4 (Dh=64), mlp 1024, out 256, WordPiece vocab
    30,522, page_len 64, query_len 16."""
    return Config(
        name="bert_mini_v5p16",
        data=DataConfig(tokenizer="wordpiece", corpus="toy",
                        num_pages=10_000_000, vocab_size=30_522),
        model=ModelConfig(encoder="bert", num_layers=4, num_heads=4,
                          model_dim=256, mlp_dim=1024, out_dim=256),
        train=TrainConfig(batch_size=8_192, steps=100_000,
                          learning_rate=5e-4),
    )


def mt5_multilingual() -> Config:
    """Config 5: multilingual mT5-base page encoder with cross-lingual
    retrieval. mT5-base encoder: L=12, d=768, A=12 (Dh=64), ff 2048 (gated
    GELU), out 768, SentencePiece vocab 250,112, page_len 128, query_len
    16, a 4-language corpus. The batch of 4,096 is the global batch of the
    JAX config's data=4 x model=2 mesh; one card does not hold it, so a
    single-card run cuts it with the ``train.batch_size`` override."""
    return Config(
        name="mt5_multilingual",
        data=DataConfig(tokenizer="sentencepiece", corpus="toy",
                        num_pages=10_000_000, vocab_size=250_112,
                        page_len=128, languages=4),
        model=ModelConfig(encoder="t5", num_layers=12, num_heads=12,
                          model_dim=768, mlp_dim=2048, out_dim=768),
        train=TrainConfig(batch_size=4_096, steps=100_000,
                          learning_rate=1e-4),
    )


CONFIGS = {
    "bert_mini_v5p16": bert_mini_v5p16,
    "mt5_multilingual": mt5_multilingual,
}


def get_config(name: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]()
    if overrides:
        cfg = _nested_replace(cfg, overrides)
    return cfg
