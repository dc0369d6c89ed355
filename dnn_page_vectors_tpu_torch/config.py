"""Config dataclasses for the port: the fields the serving and training
slices (BERT-mini, mT5, sequence packing, the CDSSM, Kim-CNN and BiLSTM
towers, and hard-negative mining) read, with the JAX package's names and
defaults (its config.py), the ``cdssm_toy``, ``kim_cnn_v5e8``,
``lstm_words``, ``bert_mini_v5p16``, ``hardneg_v5p64``,
``mt5_multilingual`` and ``bert_long_sp`` presets,
and ``get_config`` with dotted overrides.

Sections and fields of later slices (mesh, scan_steps, index, fleet,
maintenance, ...) join as those slices land; an override naming a field
that is not here yet raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-side data pipeline settings."""
    tokenizer: str = "trigram"       # trigram | word | wordpiece | sentencepiece
    corpus: str = "toy"              # toy (jsonl:<path> is a later slice)
    num_pages: int = 10_000          # corpus size (toy generator)
    query_len: int = 16              # max tokens per query
    page_len: int = 64               # max tokens per page
    trigrams_per_word: int = 8       # K trigram ids kept per word (CDSSM)
    trigram_buckets: int = 16_384    # hash-bucket vocab for char trigrams
    vocab_size: int = 30_000         # word / subword vocab size
    languages: int = 1               # >1: cross-lingual toy corpus
    num_topics: int = 64             # toy-corpus topics
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Encoder settings. `encoder` selects the family."""
    encoder: str = "cdssm"           # cdssm | kim_cnn | lstm | bert | t5
    embed_dim: int = 128             # token/word embedding width
    out_dim: int = 128               # final vector dimension (both towers)
    # conv families
    conv_widths: Tuple[int, ...] = (3,)  # cdssm: (3,); kim_cnn: (3, 4, 5)
    conv_channels: int = 256
    # transformer families (model_dim is also the LSTM's hidden size and
    # num_layers its depth)
    num_layers: int = 4
    num_heads: int = 4
    mlp_dim: int = 1024
    model_dim: int = 256
    dropout: float = 0.1             # embedding, attention and MLP outputs
    attention: str = "dense"         # dense | flash (CUDA kernels K1-K4);
                                     # ring is a later slice
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
    hard_negatives: int = 0          # mined negatives per positive
                                     # (mine/ann.py; train/pipeline.py
                                     # mines them between rounds)
    checkpoint_every: int = 500
    log_every: int = 50
    # >0: the chunked contrastive loss (models/losses.py) scores this many
    # query rows at a time, so the [B, B] logits never exist at once. Must
    # divide batch_size. 0 = the dense loss.
    loss_chunk: int = 0
    # Sequence packing (data/loader.py pack_segments): >1 packs this many
    # consecutive short pages into ONE [data.page_len] row with segment ids
    # (attention and pooling never cross pages; BERT positions restart per
    # page), so a corpus of short pages stops paying for full-row padding.
    # batch_size still counts PAGES; the row batch is batch_size /
    # pack_pages. Needs a bert or t5 tower. 1 = unpacked.
    pack_pages: int = 1
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
        if isinstance(value, list):
            value = tuple(value)
        elif not isinstance(value, tuple):
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
            elif isinstance(current, tuple):      # "3,4,5" -> (3, 4, 5)
                value = tuple(int(x) for x in str(value).split(","))
        section = dataclasses.replace(section, **{parts[1]: value})
        cfg = dataclasses.replace(cfg, **{parts[0]: section})
    return cfg


def cdssm_toy() -> Config:
    """Config 1: CDSSM char-trigram CNN over the 10,000-page toy corpus,
    one process: trigram ids [L, K=8] hashed into 16,384 buckets, embed
    128, one conv of width 3 with 256 channels, out 128, float32."""
    return Config(
        name="cdssm_toy",
        data=DataConfig(tokenizer="trigram", corpus="toy", num_pages=10_000),
        model=ModelConfig(encoder="cdssm", conv_widths=(3,), conv_channels=256,
                          embed_dim=128, out_dim=128, dtype="float32"),
        train=TrainConfig(batch_size=256, steps=1_000),
    )


def kim_cnn_v5e8() -> Config:
    """Config 2: word-level Kim-CNN page encoder over a 1M-page toy corpus:
    a 100,000-word vocab, embed 256, convs of widths 3, 4 and 5 with 256
    channels each, out 256. The batch of 4,096 is the global batch of the
    JAX config's data=8 mesh, which has no counterpart here yet; one card
    holds it whole."""
    return Config(
        name="kim_cnn_v5e8",
        data=DataConfig(tokenizer="word", corpus="toy", num_pages=1_000_000,
                        vocab_size=100_000),
        model=ModelConfig(encoder="kim_cnn", conv_widths=(3, 4, 5),
                          conv_channels=256, embed_dim=256, out_dim=256),
        train=TrainConfig(batch_size=4_096, steps=50_000),
    )


def lstm_words() -> Config:
    """The BiLSTM word-level page encoder, sized like kim_cnn_v5e8 on the
    same corpus and vocab: embed 256, one layer, hidden 256 a direction,
    out 256. The batch of 4,096 is the global batch of the JAX config's
    data=8 mesh, which has no counterpart here yet; one card holds it
    whole."""
    return Config(
        name="lstm_words",
        data=DataConfig(tokenizer="word", corpus="toy", num_pages=1_000_000,
                        vocab_size=100_000),
        model=ModelConfig(encoder="lstm", embed_dim=256, model_dim=256,
                          num_layers=1, out_dim=256),
        train=TrainConfig(batch_size=4_096, steps=50_000),
    )


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


def hardneg_v5p64() -> Config:
    """Config 4: hard-negative ANN-mined contrastive training over a
    100M-page corpus: config 3's BERT-mini towers and WordPiece vocab, 7
    mined negatives per pair (train/pipeline.py alternates training with
    mining them, mine/ann.py). The batch of 16,384 pairs is the global
    batch of the JAX config's 64-chip mesh: with its negatives, 131,072
    page encodes of 64 tokens a step. One card holds about 1,024 pairs
    (8,192 page encodes plus 1,024 queries, about bert_mini_v5p16's step
    of 8,192 pages and 8,192 queries, which fits one 80 GB card), so a
    single-card run cuts the batch, and the corpus, with
    ``train.batch_size`` and ``data.num_pages`` overrides."""
    return Config(
        name="hardneg_v5p64",
        data=DataConfig(tokenizer="wordpiece", corpus="toy",
                        num_pages=100_000_000, vocab_size=30_522),
        model=ModelConfig(encoder="bert", num_layers=4, num_heads=4,
                          model_dim=256, mlp_dim=1024, out_dim=256),
        train=TrainConfig(batch_size=16_384, steps=200_000,
                          hard_negatives=7, learning_rate=5e-4),
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


def bert_long_sp() -> Config:
    """The long-page variant: BERT geometry at twice BERT-mini's width over
    1,024-token pages. L=4, d=512, A=8 (Dh=64), mlp 2048, out 256,
    WordPiece vocab 30,522, page_len 1024, query_len 32, batch 2,048 pages,
    lr 5e-4. Its attention is ring attention over a mesh's sequence axis,
    which the port does not have yet (the factory raises and names it); on
    one card it runs with ``model.attention=flash``, as the JAX package
    runs it there, packed with ``train.pack_pages`` for short pages."""
    return Config(
        name="bert_long_sp",
        data=DataConfig(tokenizer="wordpiece", corpus="toy",
                        num_pages=1_000_000, vocab_size=30_522,
                        page_len=1024, query_len=32),
        model=ModelConfig(encoder="bert", num_layers=4, num_heads=8,
                          model_dim=512, mlp_dim=2048, out_dim=256,
                          attention="ring"),
        train=TrainConfig(batch_size=2_048, steps=100_000,
                          learning_rate=5e-4),
    )


CONFIGS = {
    "cdssm_toy": cdssm_toy,
    "kim_cnn_v5e8": kim_cnn_v5e8,
    "lstm_words": lstm_words,
    "bert_mini_v5p16": bert_mini_v5p16,
    "hardneg_v5p64": hardneg_v5p64,
    "mt5_multilingual": mt5_multilingual,
    "bert_long_sp": bert_long_sp,
}


def get_config(name: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]()
    if overrides:
        cfg = _nested_replace(cfg, overrides)
    return cfg
