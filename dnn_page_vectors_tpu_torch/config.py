"""Config dataclasses for the port: the fields the serving and training
slices (BERT-mini, mT5, sequence packing, the CDSSM, Kim-CNN and BiLSTM
towers, hard-negative mining, the int8 store and the IVF/PQ index, the
host data path, serving under load) read, with the JAX package's names and
defaults (its config.py), the ``cdssm_toy``, ``kim_cnn_v5e8``,
``lstm_words``, ``bert_mini_v5p16``, ``hardneg_v5p64``,
``mt5_multilingual`` and ``bert_long_sp`` presets,
and ``get_config`` with dotted overrides.

``mesh`` (``MeshConfig``) is the (data, model, seq) grid of ranks a
training job runs on (parallel/mesh.py). Fields of later slices
(scan_steps, ...) join as those slices land; an override naming a field
that is not here yet raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-side data pipeline settings."""
    tokenizer: str = "trigram"       # trigram | word | wordpiece | sentencepiece
    corpus: str = "toy"              # toy | jsonl:<path>
    num_pages: int = 10_000          # corpus size (toy generator)
    query_len: int = 16              # max tokens per query
    page_len: int = 64               # max tokens per page
    trigrams_per_word: int = 8       # K trigram ids kept per word (CDSSM)
    trigram_buckets: int = 16_384    # hash-bucket vocab for char trigrams
    vocab_size: int = 30_000         # word / subword vocab size
    languages: int = 1               # >1: cross-lingual toy corpus
    num_topics: int = 64             # toy-corpus topics
    # >1 splits one native subword batch encode across host threads (the
    # C++ matcher releases the GIL)
    tokenize_threads: int = 1
    # the tokenizer worker pool: >1 reads and tokenizes the batches of the
    # bulk-embed sweep and of the train batcher on N threads, reassembled
    # in batch order (data/loader.py ordered_parallel_map), so the batches
    # stay byte for byte the serial path's. Workers split ACROSS batches,
    # tokenize_threads WITHIN one. 1 = a serial producer.
    tokenize_workers: int = 4
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
    # dense | flash (CUDA kernels K1-K4) | ring (parallel/ring_attention.py:
    # the sequence split over the mesh's seq group; at mesh.seq=1 it is
    # flash)
    attention: str = "dense"
    shared_towers: bool = False      # share params between the towers
    dtype: str = "bfloat16"          # compute dtype; params stay float32


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The grid of ranks (one process a card) a training job runs on:
    ``data`` splits the batch (data parallelism, global in-batch
    negatives), ``model`` splits the transformer's heads, MLP and
    embedding features (tensor parallelism), ``seq`` splits the tokens
    (ring attention). ``strict=True`` raises where the job has another
    number of ranks than ``num_devices``; ``strict=False`` shrinks the
    grid to the ranks there are (``fit_mesh_to_devices``), as the JAX
    package does on a dev box."""
    data: int = 1
    model: int = 1
    seq: int = 1
    strict: bool = False

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.seq


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer settings (train/loop.py). ``batch_size`` is the GLOBAL
    batch, split over the mesh's data axis."""
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
    store_shard_size: int = 65_536   # vector-store shard rows
    # float16 | int8: int8 stores symmetric per-vector codes + float16
    # scales (infer/vector_store.py), half the bytes of float16 rows
    store_dtype: str = "float16"
    # shards the bulk embed's background writer may hold queued; a slow
    # disk then holds the device loop back instead of filling host memory
    writeback_depth: int = 2


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving and index knobs: SearchService's micro-batcher, caches and
    admission (infer/serve.py), the socket front end (infer/server.py), and
    the IVF/PQ index build (index/ivf.py). Names and defaults are the JAX
    package's."""
    # micro-batcher window: how long the dispatcher waits for more callers
    # after the first request of a batch arrives (a lone caller pays at
    # most one window)
    batch_window_ms: float = 2.0
    # move the window between batch_window_ms and batch_window_max_ms off
    # the windowed queue-wait p99 (AdaptiveWindow); off = a fixed window
    batch_window_adaptive: bool = False
    batch_window_max_ms: float = 25.0
    max_batch: int = 32              # most requests one dispatch carries
    max_queue: int = 256             # bounded request queue (backpressure)
    # LRU query-embedding cache entries, keyed on whitespace-normalized
    # text and the store's model step; 0 turns it off
    query_cache_size: int = 4096
    # "exact" = brute-force top-k over the whole store staged on the card;
    # "ivf" = the inverted-file index, falling back to exact per request
    # (counted in ann_fallbacks) while the index is unavailable
    index: str = "exact"
    nprobe: int = 8                  # IVF lists probed per query
    nlist: int = 0                   # IVF list count; 0 = auto (~sqrt N)
    kmeans_iters: int = 8            # coarse quantizer k-means iterations
    kmeans_init: str = "kmeans++"    # kmeans++ | random (both seeded)
    # >0 caps each list at ceil(factor * N / nlist) rows in the final
    # assignment sweep (overflow spills to the next-best centroid)
    kmeans_balance: float = 0.0
    pq_m: int = 0                    # PQ subspaces (bytes a code row); 0 =
                                     # stored-width postings, no PQ
    pq_iters: int = 8                # per-subspace codebook iterations
    pq_opq_iters: int = 3            # OPQ rotation alternations; 0 = PQ
    pq_rerank: int = 0               # ADC survivors re-ranked exactly per
                                     # query; 0 = max(8k, 64)
    # device memory (GiB) for the hot posting set of a PQ index: the most
    # probed lists' codes, list ids and attribute words staged on the card
    # at view build (IVFIndex.stage_hot), so they need no host gather; the
    # other lists keep the mmap path. 0 = off
    hot_postings_gb: float = 0.0
    # partitioned serving (infer/partition.py): >1 splits the store's
    # shard table into this many contiguous partitions (clamped to the
    # shard count), each owning its shard range, its slice of the IVF
    # posting files and its cut of hot_postings_gb; search_many encodes
    # once and scatter-gathers. 1 (with replicas=1) is the single view
    partitions: int = 1
    # R copies of every partition, each a worker thread with a view of its
    # own, behind health-based routing: a replica that is restaging,
    # degraded (the streaming sweep) or past its queue budget sheds to a
    # sibling (replica_shed)
    replicas: int = 1
    # requests in flight past which a replica stops being preferred (only a
    # routing preference: with every replica over it one still serves)
    replica_shed_queue: int = 8
    # filtered retrieval: serve attribute predicates (index/attrs.py) and
    # confirm FLAG_FILTERS on the socket; off, a filtered frame is refused
    filters: bool = True
    # a filtered IVF probe set that fills fewer than k rows re-runs with
    # nprobe times this until k fills or every list is probed
    # (ivf.filter_escalations); <= 1 turns it off
    filter_escalate: float = 4.0
    # the socket front end's listen address ("host:port"; port 0 binds an
    # ephemeral port)
    listen: str = "127.0.0.1:0"
    # default per-request deadline (ms) applied at admission when a request
    # carries none; a request that cannot make it is shed (deadline_shed),
    # never counted as an error. 0 = no deadline
    deadline_ms: float = 0.0
    # negotiate the compressed RESULT frame and query-block interning per
    # connection (both lossless); False = raw frames only
    wire_compress: bool = True
    # result cache: formatted top-k keyed by (normalized text, k, nprobe,
    # store generation and model step, index generation), probed before
    # admission; off by default
    result_cache: bool = False
    result_cache_size: int = 4096
    # the fleet over the wire (infer/partition_host.py). A partition whose
    # answer has not come within this quantile of its observed RPC latency
    # is asked again of a sibling replica's worker, and the first answer
    # wins (serve.hedge_fired); needs 8 latency samples; <= 0 or >= 1 off
    hedge_quantile: float = 0.95
    # a worker's heartbeat interval (s); one silent for 2x this (plus
    # 0.25 s) or whose connection dropped is lost (worker_lost) and its
    # replica sheds with reason "liveness"
    heartbeat_s: float = 0.5
    # share the result cache between front ends over the wire
    # (FLAG_RESULT_CACHE: T_CACHE_LOOKUP / T_CACHE_PUT) and let the workers
    # keep a per-connection block cache; needs serve.result_cache
    result_cache_fleet: bool = False
    # a worker that loses its gateway re-dials with exponential backoff and
    # jitter from reconnect_base_s up to reconnect_max_s (s) and
    # re-registers; False: a lost connection ends the worker
    reconnect: bool = True
    reconnect_base_s: float = 0.05
    reconnect_max_s: float = 2.0
    # the gateway's breaker per replica: this many consecutive wire
    # failures open it (routing skips the replica) for breaker_open_s,
    # doubling on each failed probe up to breaker_max_s; <= 0 off
    breaker_failures: int = 3
    breaker_open_s: float = 0.25
    breaker_max_s: float = 30.0
    # elastic membership: the live worker set sets the partition split (a
    # worker joining at the next tail index widens it, a draining tail
    # worker narrows it) through the generation-gated T_REFRESH handoff;
    # False: the split is fixed at boot
    elastic: bool = False


@dataclasses.dataclass(frozen=True)
class UpdatesConfig:
    """Live corpus updates (updates/append.py, index/ivf.py ``update``,
    infer/serve.py ``refresh``): the JAX package's names and defaults."""
    # IVFIndex.update rebuilds in full (fresh k-means) once the fraction of
    # the corpus appended since the last full build exceeds this
    rebuild_drift: float = 0.25
    # refresh() and `cli append` bring an existing IVF index up to date;
    # False: the store alone moves, and the stale index serves exact
    auto_update_index: bool = True
    # refresh() keeps a staged row that a new tombstone killed (masked, so
    # it never takes a result slot) while the staged rows' dead share
    # stays at or below this; past it the live rows are compacted on the
    # card (restage_skipped / restage_forced)
    restage_tombstone_density: float = 0.05
    # the append lease's ttl (s): a crashed writer's lease is taken over
    # after this instead of blocking appends forever
    writer_lease_s: float = 30.0
    # how long a second writer waits on a held lease (s); 0 fails at once
    lease_wait_s: float = 5.0


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    """The background MaintenanceService (maintenance/service.py):
    compaction, off-path IVF rebuilds, the janitor, the migrator and the
    autoscaler. The JAX package's names and defaults."""
    # fold the chain into a compacted base once the tombstone density
    # (dead rows / stored rows) reaches this (``compaction_due``)
    compact_tombstone_density: float = 0.2
    # seconds between a pillar worker's trigger checks (run_once and
    # `cli maintain --once` ignore it)
    interval_s: float = 5.0
    # with a MaintenanceService attached, refresh() defers a drift
    # rebuild of the IVF index (the incremental append still runs and
    # serve.index_rebuild_pending flags it) and the rebuild pillar builds
    # the next index generation beside the live one; False keeps the
    # rebuild inline in refresh()
    bg_rebuild: bool = True
    # the autoscale pillar: decide worker spawns and drains from the
    # windowed queue-wait p99 and deadline-shed rate, acting only through
    # hooks given to attach_scaler (observable only without them)
    autoscale: bool = False
    autoscale_min_workers: int = 1
    autoscale_max_workers: int = 4
    autoscale_up_queue_p99_ms: float = 50.0
    autoscale_up_shed_rate: float = 0.5
    autoscale_down_queue_p99_ms: float = 5.0
    autoscale_cooldown_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Rolling model migrations (maintenance/migrate.py): how a sweep
    that `cli migrate` or MaintenanceService.request_migration asks for
    runs. The JAX package's names and defaults."""
    # page texts a re-embed call takes from the corpus
    batch_rows: int = 4096
    # units the migrate pillar commits a pass before the serving view
    # hot-swaps
    units_per_pass: int = 1
    # remove a unit's superseded shard files once the serving view has
    # moved past them (False leaves them to the janitor)
    purge: bool = True


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault injection and the transient-I/O retry policy
    (utils/faults.py). Injection is off unless `plan` is non-empty."""
    # "op:kind:at[:count],...", e.g. "shard_write:io_error:1"
    plan: str = ""
    seed: int = 0                    # corruption offsets and bits
    retry_attempts: int = 3          # attempts an I/O operation
    retry_backoff_s: float = 0.05    # the first backoff; doubles a retry
    retry_jitter_s: float = 0.02     # uniform jitter added to each backoff


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability (utils/telemetry.py, utils/tracing.py): request
    tracing, the slow-query log and the registry's rolling windows."""
    enabled: bool = True             # off: every span is a shared no-op
    # a finished request trace at least this slow (ms) lands in the slow-
    # query log; 0 logs every request, negative turns the log off
    slow_ms: float = -1.0
    slow_log_size: int = 64
    trace_buffer: int = 64           # recent traces kept for `cli trace`
    # the rolling window (s) behind the live qps, error and cache-hit
    # rates and the windowed percentiles
    window_s: float = 10.0
    reservoir: int = 4096            # percentile reservoir (Algorithm R)
    events: int = 256                # lifecycle event ring


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "custom"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    updates: UpdatesConfig = dataclasses.field(default_factory=UpdatesConfig)
    maintenance: MaintenanceConfig = dataclasses.field(
        default_factory=MaintenanceConfig)
    migrate: MigrationConfig = dataclasses.field(
        default_factory=MigrationConfig)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)


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
    channels each, out 256. The batch of 4,096 is the global batch of a
    data=8 mesh: eight ranks take 512 pairs each, against every rank's
    pages as negatives; one card holds it whole."""
    return Config(
        name="kim_cnn_v5e8",
        data=DataConfig(tokenizer="word", corpus="toy", num_pages=1_000_000,
                        vocab_size=100_000),
        model=ModelConfig(encoder="kim_cnn", conv_widths=(3, 4, 5),
                          conv_channels=256, embed_dim=256, out_dim=256),
        mesh=MeshConfig(data=8),
        train=TrainConfig(batch_size=4_096, steps=50_000),
    )


def lstm_words() -> Config:
    """The BiLSTM word-level page encoder, sized like kim_cnn_v5e8 on the
    same corpus and vocab: embed 256, one layer, hidden 256 a direction,
    out 256. The batch of 4,096 is the global batch of a data=8 mesh,
    as in kim_cnn_v5e8; one card holds it whole."""
    return Config(
        name="lstm_words",
        data=DataConfig(tokenizer="word", corpus="toy", num_pages=1_000_000,
                        vocab_size=100_000),
        model=ModelConfig(encoder="lstm", embed_dim=256, model_dim=256,
                          num_layers=1, out_dim=256),
        mesh=MeshConfig(data=8),
        train=TrainConfig(batch_size=4_096, steps=50_000),
    )


def bert_mini_v5p16() -> Config:
    """Config 3: two-tower BERT-mini (query + page) with in-batch negatives.
    BERT-mini: L=4, d=256, A=4 (Dh=64), mlp 1024, out 256, WordPiece vocab
    30,522, page_len 64, query_len 16. Its mesh is data=16: 16 ranks of
    512 pairs, each scoring its queries against all 8,192 pages."""
    return Config(
        name="bert_mini_v5p16",
        data=DataConfig(tokenizer="wordpiece", corpus="toy",
                        num_pages=10_000_000, vocab_size=30_522),
        model=ModelConfig(encoder="bert", num_layers=4, num_heads=4,
                          model_dim=256, mlp_dim=1024, out_dim=256),
        mesh=MeshConfig(data=16),
        train=TrainConfig(batch_size=8_192, steps=100_000,
                          learning_rate=5e-4),
    )


def hardneg_v5p64() -> Config:
    """Config 4: hard-negative ANN-mined contrastive training over a
    100M-page corpus: config 3's BERT-mini towers and WordPiece vocab, 7
    mined negatives per pair (train/pipeline.py alternates training with
    mining them, mine/ann.py). The batch of 16,384 pairs is the global
    batch of a data=64 mesh: 256 pairs a rank, each rank's queries scored
    against all 16,384 pages and 114,688 mined negatives; with its
    negatives, 131,072 page encodes of 64 tokens a step. One card holds
    about 1,024 pairs (8,192 page encodes plus 1,024 queries, about
    bert_mini_v5p16's step of 8,192 pages and 8,192 queries, which fits
    one 80 GB card), so a single-card run cuts the batch, and the
    corpus, with ``train.batch_size`` and ``data.num_pages`` overrides."""
    return Config(
        name="hardneg_v5p64",
        data=DataConfig(tokenizer="wordpiece", corpus="toy",
                        num_pages=100_000_000, vocab_size=30_522),
        model=ModelConfig(encoder="bert", num_layers=4, num_heads=4,
                          model_dim=256, mlp_dim=1024, out_dim=256),
        mesh=MeshConfig(data=64),
        train=TrainConfig(batch_size=16_384, steps=200_000,
                          hard_negatives=7, learning_rate=5e-4),
    )


def mt5_multilingual() -> Config:
    """Config 5: multilingual mT5-base page encoder with cross-lingual
    retrieval. mT5-base encoder: L=12, d=768, A=12 (Dh=64), ff 2048 (gated
    GELU), out 768, SentencePiece vocab 250,112, page_len 128, query_len
    16, a 4-language corpus. The batch of 4,096 is the global batch of a
    data=4 x model=2 mesh: each pair of ranks splits the 12 heads, the
    gated MLP and the embedding's features in two and takes 1,024 pairs;
    one card does not hold it, so a single-card run cuts it with the
    ``train.batch_size`` override."""
    return Config(
        name="mt5_multilingual",
        data=DataConfig(tokenizer="sentencepiece", corpus="toy",
                        num_pages=10_000_000, vocab_size=250_112,
                        page_len=128, languages=4),
        model=ModelConfig(encoder="t5", num_layers=12, num_heads=12,
                          model_dim=768, mlp_dim=2048, out_dim=768),
        mesh=MeshConfig(data=4, model=2),
        train=TrainConfig(batch_size=4_096, steps=100_000,
                          learning_rate=1e-4),
    )


def bert_long_sp() -> Config:
    """The long-page variant: BERT geometry at twice BERT-mini's width over
    1,024-token pages. L=4, d=512, A=8 (Dh=64), mlp 2048, out 256,
    WordPiece vocab 30,522, page_len 1024, query_len 32, batch 2,048 pages,
    lr 5e-4. Its attention is ring attention over the mesh's seq axis
    (data=16 x seq=4: four ranks hold 256 tokens of each page, and the
    key/value blocks travel around them); at mesh.seq=1, on one card, the
    ring is one hop and runs the flash kernels. Packed rows
    (``train.pack_pages``) take ``model.attention=flash``."""
    return Config(
        name="bert_long_sp",
        data=DataConfig(tokenizer="wordpiece", corpus="toy",
                        num_pages=1_000_000, vocab_size=30_522,
                        page_len=1024, query_len=32),
        model=ModelConfig(encoder="bert", num_layers=4, num_heads=8,
                          model_dim=512, mlp_dim=2048, out_dim=256,
                          attention="ring"),
        mesh=MeshConfig(data=16, seq=4),
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
