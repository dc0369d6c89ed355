"""PyTorch/CUDA port of dnn_page_vectors_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path and names (``models/transformer.py``,
``infer/bulk_embed.py``, ...) so a reader finds each pair. This package
imports torch and numpy only: never jax, flax, or anything of the JAX
package.

Ported so far: the BERT-mini serving path (WordPiece tokenize -> page tower
bulk embed into the fp16 vector store -> store staged whole on the card ->
query tower + exact top-k behind ``SearchService.search_many``) and its
training path (``train/loop.py:Trainer``: TrainBatcher -> both towers ->
cosine-contrastive loss -> backward -> clip + AdamW -> checkpoints), with
the flash-attention forward and backward as hand-written CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), sequence packing for the
transformer towers, the CDSSM (trigram), Kim-CNN and BiLSTM (word)
towers on torch ops, and hard-negative mining (``mine/ann.py``: the query
tower against the store streamed a shard at a time, ``ops/topk.py
topk_over_store``) with the train -> embed -> mine -> train loop of
``train/pipeline.py``, the int8 store and the IVF/PQ index (``index/``),
and the host data path: jsonl corpora (``data/jsonl.py``,
``data/synth.py``), the C++ tokenizers and jsonl index (``native/``), the
tokenizer worker pool and ``prefetch_to_device`` (``data/loader.py``),
the background shard writer (``infer/bulk_embed.py``), the offline
CLI (``cli.py``), serving under load (``infer/serve.py``,
``infer/server.py``, ``loadgen/``), and live corpus updates: store
generations, tombstones and writer manifests (``infer/vector_store.py``),
``updates/append.py``, the append lease and compaction
(``maintenance/``), ``IVFIndex.update`` and ``SearchService.refresh``.
Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU present they raise.
"""
