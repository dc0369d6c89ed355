#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (dnn_page_vectors_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH] [--parent TREE]

Phases, each printing one JSON line:
  1. device: the card, its power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA source of the paths (K1 in flash_fwd.cu; K2, K3 and
     K4 in flash_bwd.cu) is compiled with nvcc for sm_90a from the
     checkout (build/torch_kernels/), one nvcc per source, all started
     together; each kernel's registers and spills (ptxas), and a failure
     if a tensor-core kernel spills; the C++ host library (native/*.cpp:
     the trigram hash, the jsonl index, the subword encoder) is compiled
     with g++ (build/torch_native/) beside them. The mT5 SentencePiece vocab is
     trained meanwhile in a second process (host work only; it is joined
     before the mT5 phases);
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the paths' shapes and the contract's edge cases (the
     tensor-core kernels' too: head dims 8, 24, 40, 128, one query row,
     one key, an unaligned view, a batch that is not a multiple of K4's
     group), with the tolerance stated, and which of each kernel's two
     versions launched (bf16: tensor cores, f32: CUDA cores); two runs of
     K2, of K3 and of K4 bitwise equal; plus each kernel's time, the plain
     version's, one PyTorch library call's (a yardstick the port never
     calls) and its bound, the backward kernels at the page and the query
     towers' training shapes. With --parent TREE (a checkout
     of the parent commit), scripts/bwd_ab.py times the kernels of
     TREE and of this checkout in turns (TREE, this, this, TREE), with
     CUDA events around back-to-back calls (the kernels' `ms` here too)
     and as the profiler's device time, once phase 9's data is built
     (before phase 6);
  4. BERT-mini serving: config bert_mini_v5p16 at full width (random
     weights from a seeded torch.Generator, flash attention) trains the
     30,522-piece WordPiece vocab over a 100,000-page toy corpus, bulk
     embeds every page into the fp16 store, stages the store on the card
     and answers 32 queries through SearchService, then 200 single ones.
     Every kernel launch counter is set to 0 just before and read just
     after (every K1 launch must take the tensor-core kernel); the results
     are checked against a plain full q @ store^T top-k and against dense
     attention;
  5. BERT-mini training: a flash-attention Trainer at full width takes 6
     steps of 8,192 pages from the same corpus through Trainer.train
     (counted: K1, K2 and K3 launch 8 times a step, all on the tensor
     cores), then 6 steps on
     pre-made batches are timed (the first 2 warm up) and one is profiled
     by kernel class; flash gradients are held against dense ones, two
     runs of one step must give bitwise equal gradients, and 3 steps +
     save + restore into a fresh Trainer + 3 steps must give the losses of
     6 straight;
  6. mT5 serving: config mt5_multilingual at full width (12 layers, d=768,
     12 heads, ff 2048, vocab 250,112, page_len 128, flash attention with
     the T5 relative-position bias) over the 250,112-piece vocab trained
     on a 300,000-page 4-language corpus; the first 2,048 pages (cut
     from 20,000 for the run's time) are bulk embedded (dim 768), then
     the serving checks of phase 4 (12 K1 launches per encode);
  7. mT5 training: phase 5 at the config's width with the batch cut from
     4,096 (the JAX config's global batch over 8 chips) to 512 pages: K1,
     K4 and K3 launch 24 times a step (all on the tensor cores), K2
     never; the rel_bias table is
     among the gradients held flash against dense (bf16) and bitwise run
     to run; the resume check and the f32 comparison are left out for
     the run's time (phases 7 and 9);
  8. packed bert_long_sp training (sequence packing, train.pack_pages=4):
     config bert_long_sp at full width (4 layers, d=512, 8 heads, mlp
     2048, page_len 1024, query_len 32) with flash attention, 1,024 toy
     pages of 215 words a step packed 4 to a 1,024-token row (256 rows),
     over phase 4's WordPiece vocab; the checks of phase 5, with K1, K2
     and K3 launching 8 times a step, the page tower's 4 of each with
     segment ids, all on the tensor cores, and the share of page tokens
     that waterfilling clipped;
  9. packed mT5 training: phase 7's config with train.pack_pages=4, 2,048
     toy pages of 20 words a step (512 rows of 128 tokens) over phase 6's
     vocab; K1, K4 and K3 launch 24 times a step, 12 of each with segment
     ids and the bias;
 10. cdssm_toy (float32; trigram ids hashed by the Python tokenizer): its
     whole 10,000-page corpus bulk embedded in batches of 512, then the
     serving checks of phase 4; 6 steps of 256 pairs and the training
     checks of phase 5; the same weights encode 512 pages on the card and
     on the CPU (unit rows within 1e-5); a CDSSM trained on the card at
     tests/test_e2e_cdssm_toy.py's overrides must reach Recall@10 > 0.5;
 11. kim_cnn_v5e8 (bf16): the 100,000-word vocab over the config's 1M-page
     corpus (trained in the second process after the mT5 vocab), the
     first 50,000 pages embedded, 6 steps of 4,096 pairs (the config's
     batch, dropout 0.1); the checks of phase 10 (card vs CPU within
     2e-2), and step times with and without cuDNN's deterministic
     algorithms;
 12. lstm_words (bf16, one layer, H = 256): phase 11's corpus, vocab,
     sizes and checks, and the recurrence's launches, device time and
     host time per encode and per step (models/lstm.py lstm_pass alone,
     by torch.profiler);
 13. hardneg_v5p64 (config 4: BERT-mini, 7 mined negatives a pair) at full
     width over phase 4's corpus and vocab, 1,024 pairs a step (cut from
     16,384, a 64-chip mesh's batch), a store of 2 shards: run_pipeline
     of 2 rounds of 3 steps (in-batch steps, an embed, Recall@10 over
     1,000 queries, a mine of 7 negatives per page from the top 100;
     then steps with them, an embed, Recall@10), every launch counter read
     after each stage (K1, K2, K3 8 times an in-batch step and 12 a step
     with negatives, K1 4 times an encode, all on the tensor cores; K4,
     the summary and gdead never); the mined table in range and never the
     gold page; the mine's sweep equal to a plain top-100 of the store
     staged whole except at ties, and the table to the plain retrieval's
     picks except in rows a tie touched; then 6 steps with negatives on
     pre-made batches (the first 2 warm up), profiled, bitwise twice,
     flash vs dense gradients on 128 pairs and their 896 negatives, and
     the peak memory (<= 80 GB);
 14. retrieval through the IVF/PQ index and the int8 store (config 3 at
     full width, phase 4's weights, corpus and vocab): (a) the 100,000
     pages bulk embedded into an int8 store (quantized on the card, 2
     shards), a plain IVF index over phase 4's fp16 store and an IVF-PQ
     one (32 bytes a row) over the int8 store (auto nlist 316, 8 k-means
     iterations, k-means++, seed 0, OPQ 3 iterations), SearchService with
     serve.index="ivf" answering 32 queries and 200 single ones,
     Recall@10 over 1,000 queries and a mine of 10,000 queries through
     the index at nprobe 16, every launch counter read after (K1 4 times
     an encode, nothing else); the checks: the int8 codes and scales equal
     the host quantization of the fp16 store's rows byte for byte, two
     seeded builds byte for byte, full probe (with every candidate
     re-ranked) equal to the exact sweep except at ties for the plain and
     the PQ payload over both stores, the survivors of ADC (adc_topr at
     full probe, the default re-rank depth 80) equal to a plain top-80 of
     the decoded codes on the host except at ties, for both PQ indexes,
     the card's search equal to the CPU's on the same index files, no
     exact fallback, the mined table in range
     and never the gold page (and its agreement with an exact mine); (b)
     a plain IVF and an IVF-PQ index over 1,000,000 rows (page-tower
     encodes of random id rows, cut from config 3's 10M pages; each row
     with the attribute word phase 19 filters by); printed:
     recall against exact at nprobe 8, 16, 32 and 64 for every index,
     the build's seconds by stage, the lists' imbalance, single-query p50
     and p95 of the IVF and the exact service, one search_many's time by
     stage and on the card by kernel class, and the peak memory.
 15. the production job from a jsonl corpus (config 3's towers at full
     width, phase 4's weights and WordPiece vocab): (a) data/synth.py
     writes 1,000,000 pages (seed 11, 32-word pages, 8-word queries: the
     JAX package's 1M-page scale test's corpus; in the second process,
     after the vocabs, while the card works on phases 4-14) and
     JsonlCorpus indexes them with the C++ index; (b) embed_corpus embeds all of them into an
     fp16 store of 16 shards with 4 tokenizer workers and the fused C++
     extract + encode, counted (K1 4 times an encode, all on the tensor
     cores, nothing else), printing pages/s, the stage split and the peak
     memory; (c) the first 100,000 pages again with one worker and with
     the pool: their rows byte for byte the 1M store's; the plain Python
     WordPiece ids of 20,000 pages and queries (and the plain trigram ids
     of 2,000) equal the native ones; which route each tokenizer and the
     corpus index took (any plain one fails the phase); (d) 6 steps of
     8,192 pairs from the file through Trainer.train with the pool and
     prefetch_to_device (K1, K2, K3 8 times a step), the step time from
     text beside phase 5's on pre-made batches; (e) that test's recipe
     through the CLI in subprocesses on the card (cdssm_toy at its
     overrides: train 600 steps of 512, embed, eval, embed again): 16
     shards of 1,000,000 vectors, Recall@10 over 512 queries > 0.2, the
     second embed a manifest no-op. The file and the store stay for 16;
 16. serving under load (config 3's towers, phase 4's weights and vocab,
     over phase 15's 1M-row fp16 store staged whole on the card and its
     jsonl corpus for the snippets): (a) 64 corpus queries through
     search_many, their top-10 equal to a plain q @ store^T top-10 except
     at ties, then through search() from 16 threads with the
     micro-batcher on (equal, some batch > 1); (b) the same queries
     streamed from disk at preload_hbm_gb=0; (c) a SearchServer on
     loopback and a SocketSearchClient equal to in-process search, and a
     request whose deadline passed shed with T_SHED before any bucket
     slot; (d) find_qps_at_p99 over the socket (Poisson, seed 0, 10,000
     distinct corpus queries, Zipf 1.1, k=10, p99 <= 50 ms, <= 1%
     errors) with the query cache on (4,096) and off, then a burst and a
     closed-loop (16 workers) trial at the cache-off rate, printing qps,
     p50/p95/p99, the mean batch, the cache hit rate, deadline sheds and
     the card's busy share (torch.profiler) of a trial at each; (e) K1
     launched 4 times a query encode the services dispatched, all on the
     tensor cores, nothing else; (f) at most 90 s, trials of 2 s, at
     most 8 a rate search; (g) no batch retried, nothing on the CPU.
 17. live corpus updates (run_updates): appends, tombstones, refresh(),
     the IVF update and compaction of phase 15's store under load.
 18. a rolling migration and background maintenance (run_migration):
     phase 17's store re-embedded by a tower trained 3 steps further,
     unit by unit, by the MaintenanceService attached to a loaded
     SearchServer; every flip against a dual-stamp oracle; then the
     rebuild pillar's off-path IVF rebuild under load, and the CLI's
     migrate, index and maintain. Then the corpus file is deleted.
 19. filtered retrieval and the hot posting set (run_filtered): phase
     14(b)'s 1M-row int8 store with the words of the JAX package's
     filtered protocol (written in phase 14), filtered exact and
     filtered IVF-PQ in arms of 50%, 10% and 1% selectivity against a
     plain post-filter top-10, the hot posting set at half the rows'
     bytes against the mmap path, both behind a SearchServer under a
     filtered load, and appends with a word, the IVF update and
     compaction over a copy of phase 14(a)'s rows.
 20. partitioned and replicated serving in one process (run_partitioned;
     run right after phase 16, while phase 15's store and corpus exist):
     (a) 4 partitions x 2 replicas over phase 15's 500,000-row store, each
     replica a view of its own staged on the card with a CUDA stream of
     its own, 64 corpus queries through search_many, topk_vectors and a
     SearchServer against the single view, simulate()'s critical path and
     each partition's scan bytes; (b) 4 x 1 through the IVF-PQ index over
     phase 14(b)'s 1M-row int8 store with phase 19's hot-set budget cut
     by rows, against the single-view index and exact search; (c) a
     tombstone generation and refresh() in a trial of phase 16's mix at 25
     qps over the socket (on a copy of the store), every answer the old
     table's or the new one's, sheds while replicas restage, and at R=1
     the old views until the publish; (d) sheds at replica_shed_queue=0
     under a burst, answers unchanged; (e) one find_qps_at_p99 at the
     client's p99 <= 50 ms, cache off, beside phase 16's rate; (f) K1 4
     times an encode, the same per query as one view; (g) every view's
     tensors on the card, the phase within 60 s.
 21. the fleet over the wire (run_fleet; right after phase 20, over a copy
     of phase 15's store; config 3 at full width on the front ends, phase
     4's weights and vocab): (a) 8 `cli partition-worker` subprocesses (4
     partitions x 2 replicas, no --device: each stages its view on the
     card, 512,000,000 B in all) register with a WorkerGateway on each of
     two front ends, the time to register, their ready lines and the
     card's memory; (b) 64 corpus queries through search_many,
     topk_vectors and a SearchServer with a SocketSearchClient equal phase
     20's in-process P x R answers and the single view's byte for byte
     (or, where another process's cuBLAS rounds otherwise, ids equal
     except at ties and scores within 1e-6, reported), RPCs on every
     partition, no fallback, hedge_fires and the wire bytes with their
     compression; (g) the second front end answers the same, and a query
     front end 0 answered is a peer hit of front end 1's result cache;
     (c) a kill -9 of partition 1's primary mid-way through a 3 s trial
     of phase 16's mix at 25 qps over the socket: every answer the
     oracle's, worker_lost and a shed by liveness, and a new process for
     the slot registers; (d) that process answers 300 ms late
     (DPV_WORKER_SLOW_MS): at hedge_quantile 0.5 calls hedge to its
     sibling, answers unchanged, each under a third of 300 ms; (f) its
     drain (SIGTERM) finishes the call in flight from it while its
     sibling takes new ones; (e) a tombstone generation and refresh() in
     a trial of the same mix: wait_for_generation holds, no stale worker,
     the same pids, no answer mixes generations; (h) find_qps_at_p99 at
     the client's p99 <= 50 ms, cache off, trials of 2 s, at most 6,
     beside phase 20's and phase 16's rates, the front end's busy share
     and nvidia-smi's utilization.gpu; (f) elastic, thread workers on the
     card at 4 x 1: the tail's drain narrows the split to 3 and a new
     tail widens it to 4 under a hammer, no answer mixing splits; (i) K1
     4 times an encode of the front ends, every worker's exit line with
     no launch of K1-K4, no view tensor on the CPU, no worker left
     running, the phase within 75 s.
No attention kernel runs in phases 10-12: every launch counter is read
after each of their main paths and must be 0.
The toy corpora keep each text once made (KeptTexts): the phases read
the same pages many times, and the toy generator makes a text in Python
under the GIL; the texts, ids and checks are unchanged, and a sweep over
kept texts times the tokenizer and the card, not the generator.
The kernel checks also hold the segment (seg) variants of K1 (against
the plain forward, and mean(V) at every row that sees no key) and of K2,
K3 and K4 (against the plain backward), bf16 and f32, with seg at both
packed paths' shapes, at the segment ids of phase 8's first batch (phase
4's corpus and vocab are built before the kernel checks for it), K4 and
the biased K3 also at phase 9's first batch's (once the mT5 vocab is
ready, before phase 6), and at the edge cases (a row that is all pad, a
segment of one token, segments across tile edges, ids that are not
contiguous, a segment whose keys are all masked, one segment over the
row, a ragged length), each with and without the bias; the segment
summary kernel (run before the bf16 K1 with seg, whose tile skip it
serves, as the backward's K2, K4 and K3 skips) and the dead rows' g sum
(before K3 with seg) against their plain versions; and time them, each
bf16 seg time beside the share of tiles (K1's, K3's, and K2's or with
the bias K4's) and 16 x 16 chunks the kernels visit. Bounds count the
pairs the segments allow. Then the `kernels` line, the card's name and
power limit as nvidia-smi prints them, and last {"ok": true, "device":
{...}}.

Exits non-zero, printing no result, when no CUDA device is present, when
the port is not importable (run from the root of a checkout), or when any
phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): bf16/fp16 tensor cores, float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
TPU_K1 = "dnn_page_vectors_tpu/ops/flash_attention.py:98"
TPU_K2 = "dnn_page_vectors_tpu/ops/flash_attention.py:172"
TPU_K3 = "dnn_page_vectors_tpu/ops/flash_attention.py:212"
TPU_K4 = "dnn_page_vectors_tpu/ops/flash_attention.py:184"
K1_SOURCE = "dnn_page_vectors_tpu_torch/csrc/flash_fwd.cu"
K23_SOURCE = "dnn_page_vectors_tpu_torch/csrc/flash_bwd.cu"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
# each source's tensor-core kernels, whose ptxas summaries must be in the
# log
TC_KERNELS = {"flash_fwd.cu": ("flash_fwd_tc_kernel",),
              "flash_bwd.cu": ("flash_bwd_dq_tc_kernel",
                               "flash_bwd_dkv_tc_kernel",
                               "flash_bwd_dq_dbias_tc_kernel")}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# gradients: 1e-4 relative + 1e-5 absolute in f32 (the JAX flash tests'),
# 2e-2 in bf16
GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# single-query latency samples: enough that p95 has ten samples beyond it
LATENCY_SAMPLES = 200
# the slice's size: pages embedded into the store, queries in search_many
N_PAGES = 100_000
N_QUERIES = 32
# the training phase: pages per step (the config's batch), steps of which
# the first TRAIN_WARMUP are not timed; flash vs dense gradient bounds
# (relative error of each gradient tensor): bf16 rounds at other places
# in the two paths (dense rounds the probabilities and its output to
# bf16, flash keeps both in f32), which f32 towers do not; and the resume
# loss bound
TRAIN_BATCH = 8_192
TRAIN_STEPS = 6
TRAIN_WARMUP = 2
FLASH_DENSE_GRAD_TOL = 2.5e-2
FLASH_DENSE_GRAD_TOL_F32 = 1e-4
F32_ROWS = 1_024                 # the f32 comparison's share of the batch
KEY_BIAS_GRAD_TOL = 1e-2
RESUME_LOSS_TOL = 1e-5
# mT5: the vocab's corpus (tests/test_vocab_honesty.py's), the pages
# embedded, and the training batch (the config's 4,096 is the global batch
# of an 8-chip mesh; 512 pages fit one card); its flash vs dense gradients
# at 256 rows in bf16 (the dense [B, 12, 128, 128] scores of 12 layers fit
# beside the flash tower). The bf16 bound is wider than BERT-mini's: 12
# layers against 4, and a CPU rehearsal of the plain versions at d=768
# gave 4.9e-2 (the query tower's top wq/wk). For the chip check's time
# the two mT5 training cells leave out the resume check (its checkpoint
# round trip of the 250,112-row tables took 34-44 s a cell on an H100
# 80GB HBM3 at 700 W) and the f32 flash vs dense gradients (64 rows);
# the BERT-mini and bert_long_sp cells keep both (PERF.md section 4).
MT5 = "mt5_multilingual"
MT5_VOCAB_PAGES = 300_000
MT5_PAGES = 2_048
MT5_TRAIN_BATCH = 512
MT5_BF16_ROWS = 256
MT5_FLASH_DENSE_GRAD_TOL = 1e-1
# The packed cells (sequence packing, train.pack_pages=4). bert_long_sp:
# 1,024 pages a step (256 rows of 1,024 tokens), cut from the config's
# 2,048, which would need about twice the 41 GB the cut takes; toy pages
# of 215 words (bench.py's long-pack phase makes them so), about 222
# WordPiece tokens with this vocab, so 4 fill a row; flash vs dense
# gradients on 32 rows in bf16 and 8 in f32 (the dense [rows, 8, 1024,
# 1024] scores of 4 layers), the bf16 bound twice BERT-mini's: a CPU
# rehearsal of the plain versions at this width on 8 packed rows gave
# 2.63e-2 (the query tower's top wq.bias), over BERT-mini's 2.5e-2.
# mT5: 2,048 pages a step (512 rows of 128 tokens), cut from 4,096, over
# pages of 20 words; flash vs dense on 64 rows (256 pages) and 16 in f32.
LONG = "bert_long_sp"
PACK = 4
LONG_TRAIN_BATCH = 1_024
LONG_PAGE_WORDS = 215
LONG_PAGES = 8_192
LONG_FLASH_DENSE_GRAD_TOL = 5e-2
MT5_PACK_TRAIN_BATCH = 2_048
MT5_PACK_PAGE_WORDS = 20
MT5_PACK_PAGES = 16_384
# Phases 10-12, the CDSSM, Kim-CNN and BiLSTM towers (no attention: every
# flash kernel counter must read 0 there). cdssm_toy embeds its whole
# corpus; the word configs train their 100,000-word vocab over their 1M-page
# corpus (the scan stops early) and embed its first WORD_PAGES pages, cut
# from 1M, and from 100,000 for the time limit (at 100,000 the three
# phases took 194 s: the host makes only 3,000-5,000 toy pages a second);
# each trains at its config's batch.
# Their encodes on the card are held against the port on the CPU (unit
# rows, ZOO_CPU_PAGES pages; TF32 is off, so f32 agrees to rounding), and
# a CDSSM trained at tests/test_e2e_cdssm_toy.py's overrides must reach
# its Recall@10 bar on the card.
CDSSM = "cdssm_toy"
KIM = "kim_cnn_v5e8"
LSTM = "lstm_words"
CDSSM_PAGES = 10_000
WORD_VOCAB_PAGES = 1_000_000
WORD_PAGES = 50_000
ZOO_CPU_PAGES = 512
ZOO_CPU_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
E2E_CDSSM = {"data.num_pages": 600, "data.trigram_buckets": 4096,
             "model.embed_dim": 64, "model.conv_channels": 128,
             "model.out_dim": 64, "train.batch_size": 64, "train.steps": 80,
             "train.warmup_steps": 10, "train.learning_rate": 2e-3,
             "train.log_every": 40, "eval.eval_queries": 200,
             "eval.embed_batch_size": 128}
E2E_RECALL_BAR = 0.5
# Phase 13, hardneg_v5p64 (config 4): BERT-mini at full width over phase
# 4's corpus and vocab, 1,024 pairs a step with 7 mined negatives each
# (8,192 page encodes), cut from the config's 16,384 pairs, the global
# batch of a 64-chip mesh; the 100M-page corpus cut to phase 4's 100,000
# pages in 2 store shards, so the sweep crosses a shard. run_pipeline
# takes 2 rounds of 3 steps; the mine keeps the top 100 of each query.
# Flash vs dense gradients with negatives on the first 128 pairs (and
# their 896 negatives), at BERT-mini's bound.
HARDNEG = "hardneg_v5p64"
HARDNEG_BATCH = 1_024
HARDNEG_SHARD = 65_536
HARDNEG_ROUND_STEPS = 3
HARDNEG_SEARCH_K = 100
HARDNEG_GRAD_PAIRS = 128
# the sweep against a plain top-k of the store staged whole: ids equal
# except where two pages tie (their scores at that rank within
# TIE_SCORE_TOL), scores within SWEEP_SCORE_TOL
TIE_SCORE_TOL = 1e-6
SWEEP_SCORE_TOL = 1e-5
# Phase 14, retrieval through the IVF/PQ index and the int8 store at config
# 3's full width. (a) phase 4's 100,000 pages embedded into an int8 store
# (65,536-row shards: the index crosses a shard edge), a plain IVF index
# over phase 4's fp16 store and an IVF-PQ one (pq_m 32) over the int8
# store, both at auto nlist (316), 8 k-means iterations, k-means++, seed 0,
# OPQ 3 iterations; the service, Recall@10 over IVF_EVAL_QUERIES and a mine
# of IVF_MINE_QUERIES queries through the index at IVF_MINE_NPROBE.
# (b) a store of IVF_BIG_ROWS rows, cut from config 3's 10M pages for the
# run's time limit: page-tower encodes of seeded random WordPiece id rows
# drawn on the card, so the host tokenizer does not set the time; a plain
# IVF and an IVF-PQ index at auto nlist (1,000) and IVF_EVAL_QUERIES query
# encodes of random id rows. Recall against exact is printed at
# IVF_NPROBES; full probe is checked on IVF_CHECK_QUERIES queries, with
# every candidate surviving the ADC cut (full probe with a full re-rank is
# exact search).
IVF_PQ_M = 32
IVF_EVAL_QUERIES = 1_000
IVF_MINE_QUERIES = 10_000
IVF_MINE_NPROBE = 16
IVF_NPROBES = (8, 16, 32, 64)
IVF_CHECK_QUERIES = 32
IVF_BIG_ROWS = 1_000_000
IVF_SEED = 0
PEAK_LIMIT_GB = 80.0
# Phase 15, the production job from a jsonl corpus: the JAX package's
# 1M-page scale test's corpus (tests/test_scale_1m.py:47: seed 11, 32-word
# pages, 8-word queries) written by data/synth.py, config 3's towers at
# full width (phase 4's weights and WordPiece vocab) embedding all of it
# with the tokenizer worker pool; PROD_SERIAL_ROWS of it again with one
# worker; steps of TRAIN_BATCH pairs from the file; then that test's
# recipe through the CLI (its cdssm_toy overrides, tests/test_scale_1m.py
# :53-71, and its bar, :90). The corpus is cut to its first 500,000 pages
# and the serial rows to 20,000 for the script's time limit (PERF.md
# section 4: phases 15-18 took 1,155 s of a run's 1,200 s on a slow host).
PROD_PAGES = 500_000
PROD_SEED = 11
PROD_PAGE_WORDS = 32
PROD_QUERY_WORDS = 8
PROD_SERIAL_ROWS = 20_000
PROD_PLAIN_PAGES = 20_000
PROD_TRIGRAM_PLAIN_PAGES = 2_000
PROD_TRAIN_STEPS = 6
PROD_SHARD = 65_536
CLI_DEVICE = "cuda"
CLI_OVERRIDES = {
    "data.num_pages": PROD_PAGES, "data.trigram_buckets": 16_384,
    "data.page_len": 32, "model.embed_dim": 48, "model.conv_channels": 96,
    "model.out_dim": 48, "train.batch_size": 512, "train.steps": 600,
    "train.warmup_steps": 20, "train.learning_rate": 5e-3,
    "train.log_every": 1000, "eval.embed_batch_size": 512,
    "eval.store_shard_size": 65_536, "eval.eval_queries": 512}
CLI_RECALL_BAR = 0.2
# Phase 16, serving under load: config 3's towers (phase 4's weights and
# vocab) over phase 15's 1M-row fp16 store and its jsonl corpus (the
# snippets are reads of that file). SERVE_QUERIES queries check the staged,
# streaming and socket paths; find_qps_at_p99 runs a Poisson workload over
# SERVE_DISTINCT distinct corpus queries (Zipf SERVE_ALPHA, seed 0, k=10)
# against PERF.md section 2's 50 ms interactive p99 on the client's clock
# (issue to answer over the socket), with the query cache on and off, each
# search SERVE_RUNS times after one profiled warm-up trial of SERVE_WARM_S
# at SERVE_START_QPS; then one burst and one closed-loop trial at the
# cache-off rate. A trial offers SERVE_WARMUP_S + SERVE_TRIAL_S seconds
# (obs.window_s is the measured part) and a rate search takes at most
# SERVE_MAX_TRIALS of them: the doubling from SERVE_START_QPS (below the
# rate expected) to SERVE_MAX_QPS (a rate that passes there reads as
# SERVE_MAX_QPS, `load_sustained` equal to it; the closed loop of 16
# workers has stayed under 300 qps on the card), then SERVE_ITERS
# bisection steps: at most 5 trials.
SERVE_QUERIES = 64
SERVE_THREADS = 16
SERVE_DISTINCT = 10_000
SERVE_ALPHA = 1.1
SERVE_SEED = 0
SERVE_P99_MS = 50.0
SERVE_MAX_ERROR_RATE = 0.01
SERVE_CACHE = 4_096
SERVE_TRIAL_S = 3.0
SERVE_WARMUP_S = 0.25
SERVE_START_QPS = 50.0
SERVE_MAX_QPS = 400.0
SERVE_WARM_S = 1.0
SERVE_ITERS = 1
SERVE_MAX_TRIALS = 8
SERVE_RUNS = 2
SERVE_LOAD_WORKERS = 64
SERVE_CLOSED_WORKERS = 16
SERVE_BUDGET_S = 90.0
# two encodes of one query in buckets of other queries differ in the last
# bits, which can move a score rounded to 4 decimals by one unit
SERVE_SCORE_TOL = 1.01e-4
SERVE_LONE_QUERIES = 50
# Phase 17, live corpus updates under load: config 3's towers (phase 4's
# weights and vocab) embed phase 15's first UPD_BASE_PAGES pages (5
# shards of 65,536) into a fresh fp16 store, staged whole behind a
# SearchServer (query and result caches on); then phase 16's Poisson mix
# (seed 0, Zipf 1.1) at UPD_QPS, at or below the lowest cache-off rate
# phase 16 has found, over the socket: one trial with no mutation, then
# three in each of which a mutator fires once, at UPD_FIRE_S of trial
# time (the trial's first request), on a thread of its own (the load
# generator never waits for it): an append and refresh(). The trials
# measure UPD_TRIAL_S, not phase 16's 3 s: an append of 65,536 pages and
# its refresh took 3.0-4.5 s under the load on an H100 (700 W), and a
# trial must hold the swap. The appends take the rest
# of the corpus in UPD_APPENDS, the last with UPD_UPDATED pages
# re-embedded and UPD_TOMBSTONED deleted (seeded picks of the base). Then
# the IVF update on phase 14's int8 rows under a PQ index of its knobs
# (UPD_IVF_APPEND pages of phase 4's corpus grown, then UPD_IVF_APPEND_2
# past a rebuild_drift of UPD_IVF_DRIFT), the compaction of the chain, and
# the store commands of the CLI at the manual fleet's cdssm_toy overrides
# (README, "Live updates"; UPD_CLI_OVERRIDES; random weights, no
# training).
UPD_BASE_PAGES = 327_680
UPD_APPENDS = ((327_680, 393_216), (393_216, 458_752), (458_752, 500_000))
UPD_UPDATED = 10_000
UPD_TOMBSTONED = 10_000
UPD_SEED = 17
UPD_QPS = 25.0
UPD_FIRE_S = 0.0
UPD_TRIAL_S = 5.0
UPD_CHECK_QUERIES = 64
UPD_PRESENCE = 16
UPD_IVF_APPEND = 2_000
UPD_IVF_APPEND_2 = 1_000
UPD_IVF_DRIFT = 0.02
UPD_CLI_OVERRIDES = {
    "data.num_pages": 600, "data.trigram_buckets": 4_096,
    "model.embed_dim": 64, "model.conv_channels": 128, "model.out_dim": 64,
    "train.batch_size": 64, "eval.embed_batch_size": 128,
    "eval.store_shard_size": 256}
UPD_CLI_GROWN = 700
# (e) compacts once the chain's tombstone density reaches this (20,000
# dead of 1,010,000 stored rows is 0.0198)
UPD_COMPACT_DENSITY = 0.01
UPD_BUDGET_S = 90.0
# Phase 18, a rolling model migration and background maintenance under
# load (run_migration): the target tower trains MIG_TRAIN_STEPS steps from
# phase 17's weights; MIG_UPDATED updated pages are appended before the
# sweep (phase 17 leaves one compacted base) and MIG_UPDATED more during
# it (seeded picks of MIG_SEED among the live pages); the maintenance
# workers poll every MIG_INTERVAL_S; every flip is probed with MIG_PROBES
# unseen queries; the sweep's trials stop at MIG_MAX_TRIALS. Then the
# rebuild pillar over phase 14's int8 rows: MIG_IVF_APPEND pages of phase
# 4's corpus grown, past an updates.rebuild_drift of MIG_IVF_DRIFT.
MIG_TRAIN_STEPS = 3
MIG_UPDATED = 10_000
MIG_SEED = 19
MIG_INTERVAL_S = 0.2
MIG_PROBES = 8
MIG_MAX_TRIALS = 40
MIG_IVF_APPEND = 3_000
MIG_IVF_DRIFT = 0.02
MIG_BUDGET_S = 100.0
# Phase 19, filtered retrieval and the hot posting set (run_filtered):
# phase 14(b)'s 1M-row store carries the words of `filter_words` (the JAX
# package's filtered protocol), so lang==0, site in {0} and recency>=3
# keep 50%, 10% and 1% of the rows (the arms s50, s10, s1); FILT_QUERIES
# corpus queries in each arm, full probe checked on FILT_CHECK_QUERIES;
# the hot set's budget is half the rows' code bytes and list ids (0.5 x
# 1M x (32 + 4) B); a trial of FILT_TRIAL_S at FILT_QPS of phase 16's mix
# with the arms as FILT_SCENARIOS, with and without it; FILT_APPEND pages
# of phase 4's grown corpus appended with lang FILT_LANG to phase 14(a)'s
# rows (FILT_TOMBSTONED deleted).
FILT_ARMS = (("none", None), ("s50", "lang==0"), ("s10", "site in {0}"),
             ("s1", "recency>=3"))
FILT_SCENARIOS = (("unfiltered", None, 0.25), ("s50", "lang==0", 0.25),
                  ("s10", "site in {0}", 0.25), ("s1", "recency>=3", 0.25))
FILT_QUERIES = 64
FILT_CHECK_QUERIES = 8
FILT_HOT_BUDGET = 18_000_000
FILT_QPS = 25.0
FILT_TRIAL_S = 3.0
FILT_APPEND = 10_000
FILT_TOMBSTONED = 100
FILT_LANG = 7
FILT_BUDGET_S = 60.0
# Phase 20, partitioned and replicated serving in one process
# (run_partitioned), right after phase 16 over its 500,000-row fp16 store
# and jsonl corpus: PART_P partitions x PART_R replicas; PART_QUERIES
# corpus queries against the single view; the IVF part over phase 14(b)'s
# 1M-row int8 store and its PQ index at PART_IVF_P partitions x 1 replica
# with phase 19's hot-set budget (FILT_HOT_BUDGET) cut across them, full
# probe checked on PART_FULL_PROBE_QUERIES; a PART_MUT_TRIAL_S trial of
# phase 16's mix at PART_QPS over the socket holding a tombstone
# generation and refresh() at PART_FIRE_S of trial time (on a copy of the
# store: phase 17 reads phase 15's); a burst of PART_BURST_CALLS
# one-query calls from PART_BURST_THREADS threads at
# replica_shed_queue=0; one find_qps_at_p99 of PART_RATE_TRIAL_S trials
# from PART_START_QPS, cache off, at most SERVE_MAX_TRIALS trials; the
# phase within PART_BUDGET_S.
PART_P = 4
PART_R = 2
PART_IVF_P = 4
PART_QUERIES = 64
PART_SOCKET_QUERIES = 16
PART_PROBES = 8
PART_QPS = 25.0
PART_MUT_TRIAL_S = 3.0
PART_FIRE_S = 1.0
PART_FULL_PROBE_QUERIES = 4
PART_BURST_THREADS = 16
PART_BURST_CALLS = 64
PART_RATE_TRIAL_S = 2.0
PART_START_QPS = 25.0
PART_BUDGET_S = 60.0
# Phase 21, the fleet over the wire (run_fleet), right after phase 20 over a
# copy of phase 15's store: FLEET_P x FLEET_R `cli partition-worker`
# subprocesses on the card behind a WorkerGateway on each of two front ends
# (config 3 at full width, phase 4's weights), heartbeats of
# FLEET_HEARTBEAT_S, registration within FLEET_REGISTER_S; FLEET_QUERIES
# corpus queries against phase 20's in-process path and the single view; a
# FLEET_TRIAL_S trial of phase 16's mix at FLEET_QPS with a kill -9 of
# partition FLEET_KILL_PID's primary at FLEET_KILL_AT_S of trial time, its
# replacement answering FLEET_SLOW_MS late (DPV_WORKER_SLOW_MS) for the
# hedging of FLEET_HEDGE_CALLS calls at hedge_quantile FLEET_HEDGE_Q and
# then drained; a tombstone generation and refresh() at FLEET_FIRE_S of
# another such trial; one find_qps_at_p99 of FLEET_RATE_TRIAL_S trials
# from PART_START_QPS, cache off, at most FLEET_MAX_TRIALS; the elastic
# re-split 4 -> 3 -> 4 over thread workers; the phase within
# FLEET_BUDGET_S.
FLEET_P = 4
FLEET_R = 2
FLEET_QUERIES = 64
FLEET_HEARTBEAT_S = 0.5
FLEET_REGISTER_S = 60.0
FLEET_QPS = 25.0
FLEET_TRIAL_S = 3.0
FLEET_KILL_PID = 1
FLEET_KILL_AT_S = 1.5
FLEET_SLOW_MS = 300.0
FLEET_HEDGE_Q = 0.5
FLEET_HEDGE_CALLS = 4
FLEET_FIRE_S = 1.0
FLEET_RATE_TRIAL_S = 2.0
FLEET_MAX_TRIALS = 6
FLEET_ELASTIC_QUERIES = 16
FLEET_BUDGET_S = 75.0
ROOT = os.path.dirname(os.path.abspath(__file__))
TRANSFORMERS = ("bert", "t5")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_counts() -> None:
    """Every kernel launch counter of the port to 0."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    for name in fa.COUNTERS:
        setattr(fa, name, 0)


def require_no_attention(phase: str) -> dict:
    """Every kernel launch counter of the port, which must all read 0 after
    a path without attention (the CDSSM, Kim-CNN and BiLSTM towers)."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    counts = {name: getattr(fa, name) for name in fa.COUNTERS}
    if any(counts.values()):
        raise AssertionError(f"{phase} launched attention kernels: "
                             f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def widths(cfg) -> dict:
    """The widths of Config `cfg`'s towers, by family."""
    m = cfg.model
    if m.encoder in TRANSFORMERS:
        return {"attention": m.attention, "layers": m.num_layers,
                "model_dim": m.model_dim, "heads": m.num_heads,
                "mlp_dim": m.mlp_dim, "out_dim": m.out_dim}
    out = {"encoder": m.encoder, "dtype": m.dtype, "embed_dim": m.embed_dim,
           "out_dim": m.out_dim}
    if m.encoder == "lstm":
        return {**out, "layers": m.num_layers, "hidden_dim": m.model_dim}
    return {**out, "conv_widths": list(m.conv_widths),
            "conv_channels": m.conv_channels}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean wall time on the card of fn() over `iters` back-to-back calls
    (CUDA events: the kernels and the gaps between them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: K1 against its plain version ----------------------------------

def packed_seg(B, L, gen, pack=PACK):
    """[B, L] int32 segment ids of rows packed as pack_segments packs them:
    `pack` pages of random lengths (so segments cross tile edges), the
    first page of every other row a single token, a pad tail, and the last
    row all pad (seg 0)."""
    lens = torch.randint(1, max(2, L // pack + 1), (B, pack), generator=gen)
    lens[::2, 0] = 1
    ends = lens.cumsum(1)                                   # [B, pack]
    seg = (torch.arange(L)[None, :, None] >= ends[:, None, :]).sum(-1) + 1
    seg[seg > pack] = 0
    seg[-1] = 0
    return seg.to(torch.int32)


def plain_forward(x) -> tuple:
    """reference_forward over batch chunks of at most 2**28 score elements
    (its [B,H,L,S] f32 temporaries stay near 1 GB each, which the
    1,024-token packed shape needs); one chunk at the other paths'
    shapes."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    B, H, L = x["q"].shape[:3]
    step = max(1, (1 << 28) // (H * L * x["k"].shape[2]))
    rows = lambda t, i: None if t is None else t[i:i + step]
    parts = [fa.reference_forward(
        *(rows(x[n], i) for n in ("q", "k", "v", "kv_mask")), x["bias"],
        rows(x["seg"], i)) for i in range(0, B, step)]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(2))


def plain_backward(q, k, v, kv_mask, g, out, lse, bias=None, seg=None
                   ) -> tuple:
    """reference_backward over batch chunks, as plain_forward; dbias is
    the sum of the chunks' (one chunk at the unpacked paths' shapes)."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    B, H, L = q.shape[:3]
    step = max(1, (1 << 28) // (H * L * k.shape[2]))
    rows = lambda t, i: None if t is None else t[i:i + step]
    parts = [fa.reference_backward(
        *(rows(t, i) for t in (q, k, v, kv_mask, g, out, lse)), bias,
        rows(seg, i)) for i in range(0, B, step)]
    if len(parts) == 1:
        return parts[0]
    dq, dk, dv = (torch.cat([p[j] for p in parts]) for j in range(3))
    dbias = None
    if bias is not None:
        dbias = sum(p[3].float() for p in parts).to(bias.dtype)
    return dq, dk, dv, dbias


def seg_layout(layout: str, B: int, L: int, gen) -> tuple:
    """([B, L] int32 segment ids, [B, L] kv mask) of an edge case of the
    skipping K2 and K3, the last batch row all pad in each: "interleaved"
    (runs of 5 positions with ids from 0 to PACK: ids reused along the row
    and not in order, pads between them), "masked_segment" (packed_seg with
    every key of segment 2 masked: its rows see no key), "all_pad"
    (packed_seg with every other row all pad), "one_segment" (one segment
    over the whole row: every tile visited)."""
    if layout == "interleaved":
        runs = torch.randint(0, PACK + 1, (B, -(-L // 5)), generator=gen)
        seg = runs.repeat_interleave(5, dim=1)[:, :L].to(torch.int32)
    elif layout == "one_segment":
        seg = torch.ones(B, L, dtype=torch.int32)
    else:
        seg = packed_seg(B, L, gen)
        if layout == "all_pad":
            seg[::2] = 0
    seg[-1] = 0
    mask = seg > 0
    if layout == "masked_segment":
        mask &= seg != 2
    return seg, mask


def k1_inputs(B, H, L, S, Dh, dtype, device, seed, pad="tail", bias=False,
              seg=False, strided=False, unaligned=False, packed=False,
              layout=None, seg_ids=None):
    """q, k, v, kv_mask and optionally the bias and segment ids: `seg`
    three pages per row beside a padding mask, `packed` rows as
    packed_seg makes them with kv_mask = seg > 0, as the towers pass
    it; `layout` one of seg_layout's; `seg_ids` [B, L] given ids (kv_mask
    = seg_ids > 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if strided:      # [B, len, H, Dh] viewed as [B, H, len, Dh], as the
        q, k, v = (torch.randn(B, n, H, Dh, generator=g)   # towers pass it
                   .to(device, dtype).transpose(1, 2) for n in (L, S, S))
    elif unaligned:  # base and row stride (Dh + 1) off 16 bytes
        q, k, v = (torch.randn(B, H, n, Dh + 1, generator=g)
                   .to(device, dtype)[..., 1:] for n in (L, S, S))
    else:
        q, k, v = (torch.randn(B, H, n, Dh, generator=g).to(device, dtype)
                   for n in (L, S, S))
    lens = torch.randint(1, S + 1, (B,), generator=g)
    if pad == "none":
        lens[:] = S
    elif pad == "masked_rows":       # every other batch row sees no key
        lens[::2] = 0
    mask = (torch.arange(S)[None, :] < lens[:, None]).to(device)
    out = {"q": q, "k": k, "v": v, "kv_mask": mask, "bias": None,
           "seg": None}
    if bias:
        out["bias"] = torch.randn(H, L, S, generator=g).to(device)
    if seg:                          # three packed pages per row, pad tail
        ids = torch.zeros(B, L, dtype=torch.int32)
        cuts = sorted(torch.randint(1, L, (2,), generator=g).tolist())
        ids[:, :cuts[0]] = 1
        ids[:, cuts[0]:cuts[1]] = 2
        ids[:, cuts[1]:L - 3] = 3
        out["seg"] = ids.to(device)
    if packed:
        out["seg"] = packed_seg(B, L, g).to(device)
        out["kv_mask"] = out["seg"] > 0
    if layout is not None:
        ids, mask = seg_layout(layout, B, L, g)
        out["seg"], out["kv_mask"] = ids.to(device), mask.to(device)
    if seg_ids is not None:
        out["seg"] = seg_ids.to(device, torch.int32)
        out["kv_mask"] = out["seg"] > 0
    return out


# The edges of the tensor-core kernels' tiling (bf16): head dims that are
# not multiples of 16 or above 64, one query row, one key, and a view that
# is not 16-byte aligned (the wrapper copies it). Checked for K1 as they
# stand and for K3 both with and without the bias.
TC_EDGE_CASES = {
    "dh8_bf16": dict(B=8, H=4, L=48, S=48, Dh=8, dtype=torch.bfloat16,
                     pad="masked_rows"),
    "dh24_bf16": dict(B=8, H=4, L=37, S=53, Dh=24, dtype=torch.bfloat16,
                      bias=True),
    "dh40_bf16": dict(B=8, H=4, L=64, S=64, Dh=40, dtype=torch.bfloat16),
    "dh128_bf16": dict(B=2, H=2, L=130, S=200, Dh=128, dtype=torch.bfloat16,
                       bias=True),
    "L1_bf16": dict(B=16, H=4, L=1, S=64, Dh=64, dtype=torch.bfloat16),
    "S1_bf16": dict(B=16, H=4, L=64, S=1, Dh=64, dtype=torch.bfloat16,
                    pad="masked_rows"),
    "unaligned_bf16": dict(B=8, H=4, L=37, S=53, Dh=64, dtype=torch.bfloat16,
                           unaligned=True),
}


def segment_groups(x) -> tuple:
    """(rows, keys, batch) [groups]: for each batch row and segment id > 0
    (each batch row, without segment ids) its query rows and its real
    keys (f64) and its batch row, without a [B, L, S] array; a group's
    rows see exactly its keys (the pairs allowed_pairs allows)."""
    B, L = x["q"].shape[0], x["q"].shape[2]
    mask = x["kv_mask"].double()
    seg = x.get("seg")
    if seg is None:
        return (torch.full((B,), float(L), dtype=torch.float64,
                           device=mask.device), mask.sum(-1),
                torch.arange(B, device=mask.device))
    ids = seg.long()
    live = ids > 0
    batch = torch.arange(B, device=ids.device)[:, None].expand_as(ids)
    groups, which = torch.unique(torch.stack([batch[live], ids[live]], 1),
                                 dim=0, return_inverse=True)
    return (torch.bincount(which).double(),
            torch.bincount(which, weights=mask[live]), groups[:, 0])


def pair_count(x) -> int:
    """The (row, key) pairs these inputs allow, in one head: the sum over
    segment_groups of rows times keys."""
    rows, keys, _ = segment_groups(x)
    return int((rows * keys).sum().item())


def live_counts(x) -> tuple:
    """(live rows, live keys) over the batch: the query rows that see a
    key (the others, fully masked, need no q: their output is the mean of
    V, their dv term g / S) and the keys a row sees (the others need no k
    or v). The bounds read q (and K3's g) at live rows only, k and v at
    live keys only."""
    rows, keys, _ = segment_groups(x)
    return int(rows[keys > 0].sum().item()), int(keys.sum().item())


def v_key_count(x) -> int:
    """The keys whose v K1 must read, over the batch: in a batch row that
    holds a row that sees no key (its output is the mean of V over every
    key below S) every key, elsewhere the keys a row sees."""
    rows, keys, batch = segment_groups(x)
    B, L = x["q"].shape[0], x["q"].shape[2]
    S = x["k"].shape[2]
    live_rows = torch.zeros(B, dtype=torch.float64, device=rows.device)
    live_rows.index_add_(0, batch, torch.where(keys > 0, rows,
                                               torch.zeros_like(rows)))
    seen = torch.zeros(B, dtype=torch.float64, device=rows.device)
    seen.index_add_(0, batch, keys)
    return int(torch.where(live_rows < L, float(S), seen).sum().item())


def per_position(t) -> int:
    """Bytes of [B, H, L, Dh] tensor `t` at one (batch row, position),
    over its heads."""
    return t.numel() * t.element_size() // (t.shape[0] * t.shape[2])


def k1_bound(x) -> dict:
    """Least time of K1 for these inputs: q at the live rows and k at the
    live keys (live_counts) read once, v at the keys v_key_count counts
    (a dead row's mean(V) reads every key of its batch row) once, the
    mask, bias and segment ids read once, out and lse written once,
    against the operations over the pairs that pair_count counts (the
    work these inputs need)."""
    q, k = x["q"], x["k"]
    B, H, L, Dh = q.shape
    rows, keys = live_counts(x)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (x["kv_mask"], x["bias"], x["seg"]) if t is not None)
    nbytes += (rows * per_position(q) + keys * per_position(k)
               + v_key_count(x) * per_position(x["v"]))
    nbytes += B * H * L * Dh * 4 + B * H * L * 4       # out, lse (f32)
    flops = 4.0 * H * pair_count(x) * Dh                 # q.k^T and p.v
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_k1(device, timed_cases, train_seg) -> dict:
    """Kernel vs plain version on every case (the serving and training
    paths' shapes, the edge cases, and with segment ids every case of
    SEG_EDGE_CASES and the training layout `train_seg`, each without and
    with the bias, where every row that sees no key must return mean(V)
    and an lse <= -1e29); times at `timed_cases`, the seg ones with the
    segment summary kernel alone and the share of tiles K1 visits."""
    import torch.nn.functional as F
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    long_c = dict(B=LONG_TRAIN_BATCH // PACK, H=8, L=1024, S=1024, Dh=64,
                  dtype=torch.bfloat16, strided=True, packed=True)
    cases = {
        "embed_bf16": dict(B=512, H=4, L=64, S=64, Dh=64,
                           dtype=torch.bfloat16),
        "query_bucket_bf16": dict(B=8, H=4, L=16, S=16, Dh=64,
                                  dtype=torch.bfloat16),
        # the training path's shapes, on the towers' transposed views
        "page_train_bf16": dict(B=TRAIN_BATCH, H=4, L=64, S=64, Dh=64,
                                dtype=torch.bfloat16, strided=True),
        "query_train_bf16": dict(B=TRAIN_BATCH, H=4, L=16, S=16, Dh=64,
                                 dtype=torch.bfloat16, strided=True),
        "ragged_L37_S53": dict(B=8, H=4, L=37, S=53, Dh=64,
                               dtype=torch.bfloat16),
        "fully_masked_rows": dict(B=16, H=4, L=64, S=64, Dh=64,
                                  dtype=torch.bfloat16, pad="masked_rows"),
        "bias_ragged": dict(B=8, H=4, L=37, S=53, Dh=64,
                            dtype=torch.bfloat16, bias=True),
        "seg": dict(B=16, H=4, L=64, S=64, Dh=64, dtype=torch.bfloat16,
                    seg=True),
        # the packed paths' shapes: bert_long_sp's 256 rows of 1,024
        # tokens, mT5's 512 rows of 128 with the bias
        "bert_long_packed_bf16": long_c,
        # the packed bert_long_sp cell's first batch: the layout its step
        # runs
        "bert_long_train_layout_bf16": {**long_c, "packed": False,
                                        "seg_ids": train_seg},
        "bert_long_packed_f32": dict(B=8, H=8, L=1024, S=1024, Dh=64,
                                     dtype=torch.float32, packed=True),
        "mt5_packed_bias_bf16": dict(B=MT5_PACK_TRAIN_BATCH // PACK, H=12,
                                     L=128, S=128, Dh=64,
                                     dtype=torch.bfloat16, bias=True,
                                     strided=True, packed=True),
        "embed_f32": dict(B=512, H=4, L=64, S=64, Dh=64,
                          dtype=torch.float32),
        "long_S300_Dh128_f32": dict(B=2, H=2, L=300, S=300, Dh=128,
                                    dtype=torch.float32, bias=True),
        # mT5: the bulk embed's and the training path's page shape, and
        # the query tower's, with the relative-position bias
        "mt5_page_bias_bf16": dict(B=MT5_TRAIN_BATCH, H=12, L=128, S=128,
                                   Dh=64, dtype=torch.bfloat16, bias=True,
                                   strided=True),
        "mt5_query_bias_bf16": dict(B=MT5_TRAIN_BATCH, H=12, L=16, S=16,
                                    Dh=64, dtype=torch.bfloat16, bias=True,
                                    strided=True),
        **TC_EDGE_CASES,
        **{f"seg_{n}{'_bias' if b else ''}": {
            **c, "bias": b, "packed": "layout" not in c}
           for n, c in SEG_EDGE_CASES.items() for b in (False, True)},
        "bert_long_train_layout_bias_bf16": {**long_c, "packed": False,
                                             "seg_ids": train_seg,
                                             "bias": True},
    }
    worst, worst_seg = {}, {}
    for i, (name, c) in enumerate(cases.items()):
        x = k1_inputs(device=device, seed=i, **c)
        before = (fa.launches_tc, fa.launches_f32, fa.launches_seg)
        out, lse = fa.flash_forward(**x)
        torch.cuda.synchronize()
        took_tc = (fa.launches_tc - before[0], fa.launches_f32 - before[1])
        if took_tc != ((1, 0) if c["dtype"] == torch.bfloat16 else (0, 1)):
            raise AssertionError(f"K1 case {name} ({c['dtype']}) launched "
                                 f"(tensor-core, CUDA-core) {took_tc}")
        if fa.launches_seg - before[2] != int(x["seg"] is not None):
            raise AssertionError(f"K1 case {name} miscounted its seg launch")
        want_out, want_lse = plain_forward(x)
        tol = TOL[c["dtype"]]
        err = (out - want_out).abs().max().item()
        lse_err = ((lse - want_lse).abs()
                   / want_lse.abs().clamp_min(1.0)).max().item()
        ok = (bool(torch.isfinite(out).all()) and err <= tol
              and lse_err <= tol and out.shape == want_out.shape)
        if c.get("pad") == "masked_rows":
            mean_v = x["v"][0::2].float().mean(dim=2, keepdim=True)
            mv_err = (out[0::2] - mean_v).abs().max().item()
            ok = ok and mv_err <= tol
        dead_rec = {}
        if x["seg"] is not None:
            # every row that sees no key (the plain lse says which): the
            # mean of V over its batch row's keys, and an lse <= -1e29
            dead = want_lse <= fa.MASKED_ROW_LSE
            mean_v = x["v"].float().mean(dim=2, keepdim=True).expand_as(out)
            dead_rec = {"dead_rows": int(dead.sum().item()),
                        "dead_mean_v_err": (out[dead] - mean_v[dead]).abs()
                        .max().item() if dead.any() else 0.0,
                        "dead_lse_ok": bool((lse[dead]
                                             <= fa.MASKED_ROW_LSE).all())}
            ok = (ok and dead_rec["dead_mean_v_err"] <= tol
                  and dead_rec["dead_lse_ok"])
        rec = {"phase": "k1_check", "case": name,
               "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]],
               "dtype": str(c["dtype"]).replace("torch.", ""),
               "bias": x["bias"] is not None, "seg": x["seg"] is not None,
               "max_abs_err": err, "lse_rel_err": lse_err, "tol": tol,
               **dead_rec, "ok": ok}
        emit(rec)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {rec}")
        worst[name] = err
        if x["seg"] is not None:
            worst_seg[name] = err
    # times at the bulk-embed shapes, the paths' hot calls
    timed = {}
    for case in timed_cases:
        c = cases[case]
        x = k1_inputs(device=device, seed=100, **c)
        mask4, kind = library_mask(x["kv_mask"], x["bias"], x["seg"],
                                   c["dtype"])
        t = {
            "kernel_ms": cuda_ms(lambda: fa.flash_forward(**x)),
            "plain_ms": cuda_ms(lambda: plain_forward(x),
                                iters=20 if x["seg"] is None else 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                x["q"], x["k"], x["v"], attn_mask=mask4)),
        }
        if x["seg"] is not None and c["dtype"] == torch.bfloat16:
            # kernel_ms is the call's (the summary kernel, then K1); K1
            # alone on a summary made beforehand, and the summary kernel
            summary, vmean = fa.launch_seg_summary(x["seg"], x["kv_mask"],
                                                   x["v"])
            t["k1_alone_ms"] = cuda_ms(lambda: fa.launch_forward(
                x["q"], x["k"], x["v"], x["kv_mask"], x["bias"], x["seg"],
                summary, vmean))
            t["seg_summary_ms"] = cuda_ms(lambda: fa.launch_seg_summary(
                x["seg"], x["kv_mask"], x["v"]))
            t["visited"] = visit_shares(x)
            del summary, vmean
        b = k1_bound(x)
        rec = {"phase": "k1_timing", "case": case,
               "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]], **t,
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
               "bytes": b["bytes"], "flops": b["flops"],
               "library_call": "torch.nn.functional."
                               f"scaled_dot_product_attention ({kind})"}
        emit(rec)
        timed[case] = {**t, **b}
        del x, mask4
    return {"max_abs_err": max(worst.values()), "worst": worst,
            "max_abs_err_seg": max(worst_seg.values()), "timed": timed}


def library_mask(kv_mask, bias, seg, dtype):
    """The attention mask of the library yardstick (scaled_dot_product_
    attention) for these inputs, and its description: a bool mask [B, 1,
    1 or L, S] of the allowed pairs, or with a bias one float mask [B, H,
    L, S] of the bias plus -inf where a pair is not allowed."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    allowed = fa.allowed_pairs(kv_mask, seg)
    what = "padding" if seg is None else "padding and segments"
    if bias is None:
        return allowed, f"bool mask: {what}"
    neg = torch.zeros(allowed.shape, device=kv_mask.device).masked_fill(
        ~allowed, float("-inf"))
    return (bias[None] + neg).to(dtype), f"float mask: bias + {what}"


# -- phase 3: K2, K3 and K4 against the plain backward ----------------------

def k23_inputs(device, seed, **case):
    """K1's inputs plus an upstream gradient g (f32, laid out like the
    towers hand it over when q is strided) and K1's out and lse (with the
    segment ids of a packed case)."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    x = k1_inputs(device=device, seed=seed, **case)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1000)
    B, H, L, Dh = x["q"].shape
    if case.get("strided"):
        g = torch.randn(B, L, H, Dh, generator=gen).to(device).transpose(1, 2)
    else:
        g = torch.randn(B, H, L, Dh, generator=gen).to(device)
    with torch.no_grad():
        out, lse = fa.flash_forward(x["q"], x["k"], x["v"], x["kv_mask"],
                                    x["bias"], x["seg"])
    return {"q": x["q"], "k": x["k"], "v": x["v"], "kv_mask": x["kv_mask"],
            "bias": x["bias"], "seg": x["seg"], "g": g, "out": out,
            "lse": lse}


def bwd_bound(x) -> dict:
    """Least time of the dq kernel (K2, or K4 with a bias) and of K3 for
    these inputs, against the operations each needs (2 flops per
    multiply-add) at the peak rate of q's type. Bytes: q at the live rows
    and k and v at the live keys (live_counts) read once; the dq kernel
    reads g and out at every row (delta is written at every row); K3
    reads g at the live rows and, with segment ids, the dead rows' sum
    gdead (the summary kernel reads g at the dead rows, and its own bound
    counts that); lse, delta, the mask and segment ids read once, every
    output written once. With a bias K4 also reads it and writes dbias,
    and K3 reads it. The operations count the pairs these inputs allow
    (pair_count), not the whole L x S."""
    q, k = x["q"], x["k"]
    B, H, L, Dh = q.shape
    nb = lambda t: 0 if t is None else t.numel() * t.element_size()
    rows, keys = live_counts(x)
    row = B * H * L * 4                                  # lse or delta, f32
    mask = nb(x["kv_mask"]) + nb(x.get("seg"))
    bias = nb(x["bias"])
    qkv = rows * per_position(q) + keys * (per_position(k)
                                           + per_position(x["v"]))
    # without segment ids K3 takes the dead rows' term from g itself
    g_dkv = (rows * per_position(x["g"]) + B * H * Dh * 4
             if x.get("seg") is not None else nb(x["g"]))
    dq_bytes = (qkv + nb(x["g"]) + nb(x["out"]) + row + mask + 2 * bias
                + nb(q) + row)                           # + dq, delta, dbias
    dkv_bytes = (qkv + g_dkv + 2 * row + mask + bias
                 + nb(k) + nb(x["v"]))                   # + dk, dv
    mac = 2.0 * H * pair_count(x) * Dh                   # one [L,S,Dh] product
    out = {}
    for name, nbytes, flops in (("dq", dq_bytes, 3 * mac),     # s, dp, dq
                                ("dkv", dkv_bytes, 4 * mac)):  # s, dp, dk, dv
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
        out[name] = {"bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def visit_shares(x) -> dict:
    """With segment ids: the share of the bf16 K1's, K3's and K2's tiles
    (with a bias K4's instead of K2's; the tiles as the library chooses
    them, which must be tile_shapes') and of the 16 x 16 chunks that the
    skipping kernels visit, by their rule, from the plain summary; and
    the share of pairs the segments allow."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    B, _, L, _ = x["q"].shape
    S = x["k"].shape[2]
    summary = fa.seg_summary(x["seg"])
    share = lambda rows, keys: fa.visited_tiles(summary, rows, keys
                                                ).float().mean().item()
    bias = x["bias"] is not None
    tiles = fa.kernel_tile_shapes(L, S, bias)
    if tiles != fa.tile_shapes(L, S, bias):
        raise AssertionError(f"tile_shapes {fa.tile_shapes(L, S, bias)} is "
                             f"not the library's choice {tiles}")
    out = {f"{n}_tiles": share(*t) for n, t in tiles.items()}
    out["chunks_16x16"] = share(16, 16)
    out["allowed_pairs"] = pair_count(x) / (B * L * S)
    return out


def check_summary(case: str, x: dict) -> dict:
    """The segment summary kernel (before the bf16 K1 with segment ids)
    against its plain versions at a case's inputs: the summary equal to
    seg_summary and vmean to value_mean, exactly (both sum in f32 in one
    order); its time, the plain versions' and its bound (it reads seg and
    the kv mask, and v at every key of each batch row that can hold a row
    that sees no key; writes the summary and vmean); raises on a
    disagreement."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    seg, mask, v = x["seg"], x["kv_mask"], x["v"]
    before = fa.seg_summary_launches
    summary, vmean = fa.launch_seg_summary(seg, mask, v)
    torch.cuda.synchronize()
    want_sum, want_mean = fa.seg_summary(seg), fa.value_mean(v, mask, seg)
    ok = (fa.seg_summary_launches == before + 1
          and torch.equal(summary, want_sum) and torch.equal(vmean, want_mean))
    B, H, L, Dh = v.shape
    can_die = int(((seg <= 0) | ~mask.bool()).any(-1).sum().item())
    nbytes = (seg.numel() * 4 + mask.numel() * mask.element_size()
              + can_die * L * per_position(v) + summary.numel() * 4
              + vmean.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = can_die * H * L * Dh / PEAK_FLOPS[torch.float32] * 1e3
    rec = {"phase": "seg_summary_check", "case": case, "shape": [B, H, L, Dh],
           "summary_equal": torch.equal(summary, want_sum),
           "vmean_equal": torch.equal(vmean, want_mean),
           "max_abs_err": (vmean - want_mean).abs().max().item(),
           "batch_rows_that_can_hold_a_dead_row": can_die,
           "ms": cuda_ms(lambda: fa.launch_seg_summary(seg, mask, v)),
           "plain_ms": cuda_ms(lambda: (fa.seg_summary(seg),
                                        fa.value_mean(v, mask, seg)),
                               iters=3, warmup=1),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ok": ok,
           "plain_call": "seg_summary and value_mean"}
    emit(rec)
    if not ok:
        raise AssertionError(f"the segment summary kernel disagrees with its "
                             f"plain versions: {rec}")
    return rec


def check_gdead(case: str, x: dict) -> dict:
    """The dead rows' g sum (before the bf16 K3 with segment ids) against
    dead_rows_sum, exactly (both sum in f32 in row order), at a case's
    inputs; its time, the plain version's and its bound (it reads lse and
    g at the dead rows, writes gdead); raises on a disagreement."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    lse, g = x["lse"], x["g"]
    before = fa.gdead_launches
    gdead = fa.launch_dead_rows_sum(lse, g)
    torch.cuda.synchronize()
    want = fa.dead_rows_sum(g, lse)
    ok = fa.gdead_launches == before + 1 and torch.equal(gdead, want)
    B, H, L, Dh = g.shape
    dead = int((lse <= fa.MASKED_ROW_LSE).sum().item())
    nbytes = lse.numel() * 4 + dead * Dh * 4 + gdead.numel() * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = dead * Dh / PEAK_FLOPS[torch.float32] * 1e3
    rec = {"phase": "gdead_check", "case": case, "shape": [B, H, L, Dh],
           "gdead_equal": torch.equal(gdead, want),
           "max_abs_err": (gdead - want).abs().max().item(),
           "dead_rows": dead,
           "ms": cuda_ms(lambda: fa.launch_dead_rows_sum(lse, g)),
           "plain_ms": cuda_ms(lambda: fa.dead_rows_sum(g, lse), iters=3,
                               warmup=1),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ok": ok, "plain_call": "dead_rows_sum"}
    emit(rec)
    if not ok:
        raise AssertionError(f"the dead rows' g sum disagrees with "
                             f"dead_rows_sum: {rec}")
    return rec


def check_bwd_case(phase: str, name: str, c: dict, x: dict) -> dict:
    """flash_backward (K2 + K3, or K4 + K3 with a bias) against
    reference_backward on one case; raises on a disagreement. Returns the
    largest absolute error of each gradient."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    seg = x.get("seg")
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["g"], x["out"], x["lse"],
            x["bias"], seg)
    def split():     # (K2 or K4, K3) launches: (tensor-core, CUDA-core,
        return ((fa.dq_launches_tc + fa.dq_dbias_launches_tc,     # seg)
                 fa.dq_launches_f32 + fa.dq_dbias_launches_f32,
                 fa.dq_launches_seg + fa.dq_dbias_launches_seg),
                (fa.dkv_launches_tc, fa.dkv_launches_f32,
                 fa.dkv_launches_seg))
    before = split()
    summaries = (fa.seg_summary_launches, fa.gdead_launches)
    got = fa.flash_backward(*args)
    torch.cuda.synchronize()
    took = [tuple(a_ - b_ for a_, b_ in zip(a, b))
            for a, b in zip(split(), before)]
    want = ((1, 0) if c["dtype"] == torch.bfloat16 else (0, 1)) + (
        int(seg is not None),)
    if took != [want, want]:
        raise AssertionError(f"case {name} ({c['dtype']}) launched (K2 or K4, "
                             f"K3) as (tensor-core, CUDA-core, seg) {took}")
    # given no summary, a bf16 backward with seg launches the summary
    # kernel once (K2 and K3 share it) and the dead rows' g sum once
    summaries = (fa.seg_summary_launches - summaries[0],
                 fa.gdead_launches - summaries[1])
    want_n = int(seg is not None and c["dtype"] == torch.bfloat16)
    if summaries != (want_n, want_n):
        raise AssertionError(f"case {name} launched the segment summary "
                             f"kernel and the dead rows' sum {summaries} "
                             "times")
    want = plain_backward(*args)
    rtol, atol = GRAD_TOL[c["dtype"]]
    names = ("dq", "dk", "dv", "dbias")[:3 if x["bias"] is None else 4]
    errs, ok = {}, True
    for gname, a, b, t in zip(names, got, want,
                              (x["q"], x["k"], x["v"], x["bias"])):
        a, b = a.float(), b.float()
        errs[gname] = (a - b).abs().max().item()
        excess = ((a - b).abs() - (atol + rtol * b.abs())).max().item()
        ok = (ok and excess <= 0 and bool(torch.isfinite(a).all())
              and a.shape == t.shape)
    if c.get("pad") == "masked_rows":     # rows 0, 2, ... see no key
        S = x["k"].shape[2]
        dv_want = (x["g"][0::2].sum(dim=2, keepdim=True) / S
                   ).expand_as(got[2][0::2])
        errs["masked_dv"] = (got[2][0::2].float() - dv_want
                             ).abs().max().item()
        ok = (ok and errs["masked_dv"] <= atol + rtol
              * dv_want.abs().max().item()
              and not got[0][0::2].any() and not got[1][0::2].any())
    if seg is not None:
        # no row that sees no key (a pad row, or one of a segment whose keys
        # are all masked) adds to dq; where the last batch row is all pad
        # (every case but a training batch's layout): dv = sum_l g / S at
        # every key there, and no dk
        dead = (x["lse"] <= fa.MASKED_ROW_LSE)[..., None].expand_as(got[0])
        ok = ok and not got[0][dead].any()
        if not seg[-1].any():
            S = x["k"].shape[2]
            dv_want = (x["g"][-1].sum(dim=1, keepdim=True) / S
                       ).expand_as(got[2][-1])
            errs["pad_row_dv"] = (got[2][-1].float() - dv_want
                                  ).abs().max().item()
            ok = (ok and errs["pad_row_dv"] <= atol + rtol
                  * dv_want.abs().max().item() and not got[1][-1].any())
    rec = {"phase": phase, "case": name,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]],
           "dtype": str(c["dtype"]).replace("torch.", ""),
           "bias": x["bias"] is not None, "seg": seg is not None,
           "max_abs_err": errs, "rtol": rtol, "atol": atol, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"the backward kernels disagree with "
                             f"reference_backward: {rec}")
    return errs


def time_bwd(phase: str, case: str, c: dict, x: dict) -> dict:
    """The dq kernel (K2, or K4 with a bias) and K3 each timed alone, the
    pair through flash_backward, the plain backward, and one library call
    (the autograd backward of scaled_dot_product_attention, the pair's
    yardstick) on inputs `x`, with the bound of each kernel; emits the
    record and returns it."""
    import torch.nn.functional as F
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    q, k, v, mask, g = x["q"], x["k"], x["v"], x["kv_mask"], x["g"]
    bias, out, lse, seg = x["bias"], x["out"], x["lse"], x.get("seg")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    # the bf16 K2 (or K4) and K3 with seg take the forward's segment
    # summary, and K3 the dead rows' g sum, launched once per backward
    # (inside the pair's time, timed alone below)
    summary = gdead = None
    if seg is not None and q.dtype == torch.bfloat16:
        summary, gdead = summary_args(x)
    if bias is None:
        names = ("k2_ms", "k3_ms", "k2_k3_ms")
        dq_fn = lambda: fa.launch_dq(q, k, v, mask, g, out, lse, seg,
                                     summary)
        pair = "K2 + K3"
    else:
        names = ("k4_ms", "k3_bias_ms", "k4_k3_ms")
        dq_fn = lambda: fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse,
                                           seg, summary)
        leaves.append(bias.detach().requires_grad_(True))
        pair = "K4 + K3"
    attn_mask, kind = library_mask(mask, None if bias is None else leaves[3],
                                   seg, q.dtype)
    if bias is not None:
        kind += "; the gradients of q, k, v and the bias"
    delta = dq_fn()[1]
    sdpa_out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=attn_mask)
    g_lib = g.to(sdpa_out.dtype)
    t = {
        names[0]: cuda_ms(dq_fn),
        names[1]: cuda_ms(lambda: fa.launch_dkv(q, k, v, mask, g, lse, delta,
                                                bias, seg, summary, gdead)),
        names[2]: cuda_ms(lambda: fa.flash_backward(q, k, v, mask, g, out,
                                                    lse, bias, seg, summary)),
        "plain_ms": cuda_ms(lambda: plain_backward(
            q, k, v, mask, g, out, lse, bias, seg),
            iters=5 if seg is None else 2, warmup=3 if seg is None else 1),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, g_lib, retain_graph=True)),
    }
    if summary is not None:
        t["gdead_ms"] = cuda_ms(lambda: fa.launch_dead_rows_sum(lse, g))
        t["visited"] = visit_shares(x)
    b = bwd_bound(x)
    B, H, L, Dh = q.shape
    # blocks of the dq kernel an SM holds at this shape (the tensor-core
    # kernels' occupancy query)
    t["dq_blocks_per_sm"] = (fa.dq_blocks_per_sm(
        bias is not None, seg is not None, L, k.shape[2], Dh, q.device)
        if q.dtype == torch.bfloat16 else None)
    rec = {"phase": phase, "case": case,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]],
           "seg": seg is not None, **t, "bound": b,
           "plain_call": f"reference_backward ({pair} together"
                         + (", over batch chunks)" if seg is not None
                            else ")"),
           "library_call": "autograd backward of torch.nn.functional."
                           f"scaled_dot_product_attention ({kind}), against "
                           f"{pair} together"}
    emit(rec)
    return {**t, "bound": b}


def summary_args(x: dict) -> tuple:
    """(summary, gdead) from the segment summary kernel and the dead rows'
    g sum, which the bf16 K2, K4 and K3 take with segment ids; (None,
    None) without them or in f32."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    if x.get("seg") is None or x["q"].dtype != torch.bfloat16:
        return None, None
    return (fa.launch_seg_summary(x["seg"], x["kv_mask"], x["v"])[0],
            fa.launch_dead_rows_sum(x["lse"], x["g"]))


def k2_bitwise(x: dict, case: str) -> bool:
    """Two runs of K2 on the same inputs give bitwise equal dq and delta
    (one writer per element, a fixed order over the KV tiles); raises if
    not."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["g"], x["out"], x["lse"],
            x.get("seg"), summary_args(x)[0])
    first = fa.launch_dq(*args)
    again = fa.launch_dq(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    emit({"phase": "k2_bitwise", "case": case, "seg": args[7] is not None,
          "dq_delta_equal": equal})
    if not equal:
        raise AssertionError(f"two runs of K2 gave different dq or delta "
                             f"({case})")
    return equal


def check_k23(device, timed_case: str, query_case: str) -> dict:
    """K2 + K3 (through flash_backward) vs reference_backward on every
    case; two runs of K2 and of K3 bitwise equal; each kernel timed alone
    at the page and query towers' training shapes."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    cases = {
        "page_train_bf16": dict(B=TRAIN_BATCH, H=4, L=64, S=64, Dh=64,
                                dtype=torch.bfloat16, strided=True),
        "query_train_bf16": dict(B=TRAIN_BATCH, H=4, L=16, S=16, Dh=64,
                                 dtype=torch.bfloat16, strided=True),
        "ragged_L37_S53": dict(B=8, H=4, L=37, S=53, Dh=64,
                               dtype=torch.bfloat16),
        "fully_masked_rows": dict(B=16, H=4, L=64, S=64, Dh=64,
                                  dtype=torch.bfloat16, pad="masked_rows"),
        "train_f32": dict(B=512, H=4, L=64, S=64, Dh=64,
                          dtype=torch.float32, strided=True),
        "long_S300_Dh128_f32": dict(B=2, H=2, L=300, S=300, Dh=128,
                                    dtype=torch.float32),
        **{n: {**c, "bias": False} for n, c in TC_EDGE_CASES.items()},
    }
    worst = {}
    for i, (name, c) in enumerate(cases.items()):
        x = k23_inputs(device, seed=200 + i, **c)
        errs = check_bwd_case("k23_check", name, c, x)
        worst[name] = {"k2": errs["dq"], "k3": max(errs["dk"], errs["dv"])}
        del x
    c = cases[timed_case]
    x = k23_inputs(device, seed=300, **c)
    bitwise = k2_bitwise(x, timed_case)
    _, delta = fa.launch_dq(x["q"], x["k"], x["v"], x["kv_mask"], x["g"],
                            x["out"], x["lse"])
    k3_bits = k3_bitwise(x, delta, timed_case)
    t = time_bwd("k23_timing", timed_case, c, x)
    del x, delta
    c = cases[query_case]
    query = time_bwd("k23_timing", query_case, c,
                     k23_inputs(device, seed=301, **c))
    return {"worst": worst, "k2_bitwise": bitwise, "k3_bitwise": k3_bits,
            **t, "query": query}


def k3_bitwise(x: dict, delta, case: str) -> bool:
    """Two runs of K3 on the same inputs give bitwise equal dk and dv (one
    writer per element, a fixed order over the Q tiles); raises if not."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["g"], x["lse"], delta,
            x["bias"], x.get("seg"), *summary_args(x))
    first = fa.launch_dkv(*args)
    again = fa.launch_dkv(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    emit({"phase": "k3_bitwise", "case": case,
          "bias": x["bias"] is not None, "seg": args[8] is not None,
          "dk_dv_equal": equal})
    if not equal:
        raise AssertionError(f"two runs of K3 gave different dk or dv "
                             f"({case})")
    return equal


def k4_bitwise(x: dict, case: str) -> tuple:
    """Two runs of K4 on the same inputs (with segment ids, on the segment
    summary) give bitwise equal dq, delta and dbias (one writer per
    element, fixed orders over the KV tiles and the batch rows); raises if
    not. Returns (True, delta)."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["bias"], x["g"],
            x["out"], x["lse"], x.get("seg"), summary_args(x)[0])
    first = fa.launch_dq_dbias(*args)
    equal = all(torch.equal(a, b) for a, b in
                zip(first, fa.launch_dq_dbias(*args)))
    emit({"phase": "k4_bitwise", "case": case, "seg": args[8] is not None,
          "dq_delta_dbias_equal": equal})
    if not equal:
        raise AssertionError(f"two runs of K4 gave different dq, delta or "
                             f"dbias ({case})")
    return equal, first[1]


def check_k4(device, timed_case: str, query_case: str) -> dict:
    """K4 + the biased K3 (through flash_backward) vs the biased
    reference_backward on every case; two runs of K4 bitwise equal; each
    kernel timed alone at the mT5 page and query towers' training
    shapes."""
    cases = {
        "mt5_page_train_bf16": dict(B=MT5_TRAIN_BATCH, H=12, L=128, S=128,
                                    Dh=64, dtype=torch.bfloat16, bias=True,
                                    strided=True),
        "mt5_query_train_bf16": dict(B=MT5_TRAIN_BATCH, H=12, L=16, S=16,
                                     Dh=64, dtype=torch.bfloat16, bias=True,
                                     strided=True),
        "ragged_L37_S53_bias": dict(B=8, H=4, L=37, S=53, Dh=64,
                                    dtype=torch.bfloat16, bias=True),
        "fully_masked_rows_bias": dict(B=16, H=4, L=64, S=64, Dh=64,
                                       dtype=torch.bfloat16, bias=True,
                                       pad="masked_rows"),
        "train_f32_bias": dict(B=64, H=12, L=128, S=128, Dh=64,
                               dtype=torch.float32, bias=True, strided=True),
        # not a multiple of K4's batch group of 8
        "odd_batch_f32_bias": dict(B=11, H=2, L=48, S=48, Dh=64,
                                   dtype=torch.float32, bias=True),
        "odd_batch_bf16_bias": dict(B=11, H=2, L=48, S=48, Dh=64,
                                    dtype=torch.bfloat16, bias=True,
                                    pad="masked_rows"),
        **{n + "_bias": {**c, "bias": True}
           for n, c in TC_EDGE_CASES.items()},
    }
    worst = {}
    for i, (name, c) in enumerate(cases.items()):
        x = k23_inputs(device, seed=400 + i, **c)
        errs = check_bwd_case("k4_check", name, c, x)
        worst[name] = {"k4": max(errs["dq"], errs["dbias"]),
                       "k3": max(errs["dk"], errs["dv"])}
        del x
    c = cases[timed_case]
    x = k23_inputs(device, seed=500, **c)
    bitwise, delta = k4_bitwise(x, timed_case)
    k3_bits = k3_bitwise(x, delta, timed_case)
    t = time_bwd("k4_timing", timed_case, c, x)
    del x, delta
    c = cases[query_case]
    query = time_bwd("k4_timing", query_case, c,
                     k23_inputs(device, seed=501, **c))
    return {"worst": worst, "bitwise": bitwise, "k3_bitwise": k3_bits, **t,
            "query": query}


# The edges of the seg variants' tiling, each run without and with the bias
# (bf16 on the tensor cores, f32 on the CUDA cores): head dims 8, 24, 40
# and 128, the query tile of L=16, an unaligned view, a batch that is not
# a multiple of K4's group. Every case is packed (packed_seg): segments of
# one token and across tile edges, and a row that is all pad.
SEG_EDGE_CASES = {
    "dh8_bf16": dict(B=8, H=4, L=48, S=48, Dh=8, dtype=torch.bfloat16),
    "dh24_bf16": dict(B=8, H=4, L=53, S=53, Dh=24, dtype=torch.bfloat16),
    "dh40_bf16": dict(B=8, H=4, L=64, S=64, Dh=40, dtype=torch.bfloat16),
    "dh128_bf16": dict(B=2, H=2, L=200, S=200, Dh=128,
                       dtype=torch.bfloat16),
    "L16_bf16": dict(B=16, H=4, L=16, S=16, Dh=64, dtype=torch.bfloat16),
    "unaligned_bf16": dict(B=8, H=4, L=37, S=37, Dh=64, dtype=torch.bfloat16,
                           unaligned=True),
    "odd_batch_bf16": dict(B=11, H=2, L=48, S=48, Dh=64,
                           dtype=torch.bfloat16),
    "odd_batch_f32": dict(B=11, H=2, L=48, S=48, Dh=64, dtype=torch.float32),
    "dh128_f32": dict(B=2, H=2, L=130, S=130, Dh=128, dtype=torch.float32),
    # the layouts of seg_layout, which the skipping K2 and K3 must not trip
    # on, over many tiles (S at most 512: the bf16 K4 of the bias
    # variants); and a ragged L = S, not a multiple of 64
    "interleaved_bf16": dict(B=8, H=8, L=512, S=512, Dh=64,
                             dtype=torch.bfloat16, layout="interleaved"),
    "masked_segment_bf16": dict(B=8, H=8, L=512, S=512, Dh=64,
                                dtype=torch.bfloat16, strided=True,
                                layout="masked_segment"),
    "all_pad_bf16": dict(B=8, H=4, L=512, S=512, Dh=64, dtype=torch.bfloat16,
                         layout="all_pad"),
    "one_segment_bf16": dict(B=4, H=4, L=512, S=512, Dh=64,
                             dtype=torch.bfloat16, layout="one_segment"),
    "ragged_L451_bf16": dict(B=6, H=8, L=451, S=451, Dh=64,
                             dtype=torch.bfloat16),
    "masked_segment_f32": dict(B=5, H=2, L=200, S=200, Dh=64,
                               dtype=torch.float32, layout="masked_segment"),
}


def train_layout_seg(data, config: str = LONG,
                     batch: int = LONG_TRAIN_BATCH) -> torch.Tensor:
    """[batch / PACK, page_len] int32 segment ids of a packed cell's first
    batch (TrainBatcher(pack=4) over `data`, packed_data's, as phases 8
    and 9 train on it): the layout the step runs. [256, 1024] for the
    packed bert_long_sp cell's 215-word pages, [512, 128] for the packed
    mT5 cell's 20-word ones."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import TrainBatcher
    corpus, q_tok, p_tok = data
    first = next(iter(TrainBatcher(corpus, q_tok, p_tok, batch,
                                   seed=get_config(config).train.seed,
                                   pack=PACK)))
    return torch.from_numpy(first["page_seg"])


def check_seg(device, train_seg) -> dict:
    """The seg variants of K2, K3 and K4 (through flash_backward with
    segment ids) against reference_backward with them, at both packed
    paths' shapes (bf16 at the full batch, f32 at a cut one), at the
    training layout `train_seg` (train_layout_seg's) and the edge cases;
    the segment summary kernel and the dead rows' g sum against their
    plain versions; two runs of each bitwise equal; each timed at the
    packed shapes, bert_long_sp's at both layouts (packed_seg's and the
    training batch's)."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    rows_long, rows_mt5 = LONG_TRAIN_BATCH // PACK, MT5_PACK_TRAIN_BATCH // PACK
    long_c = dict(B=rows_long, H=8, L=1024, S=1024, Dh=64,
                  dtype=torch.bfloat16, strided=True, packed=True)
    train_c = {**long_c, "packed": False, "seg_ids": train_seg}
    mt5_c = dict(B=rows_mt5, H=12, L=128, S=128, Dh=64, dtype=torch.bfloat16,
                 bias=True, strided=True, packed=True)
    cases = {
        "bert_long_packed_bf16": long_c,
        "bert_long_train_layout_bf16": train_c,
        "mt5_packed_bias_bf16": mt5_c,
        "bert_long_packed_f32": {**long_c, "B": 8, "dtype": torch.float32},
        "mt5_packed_bias_f32": {**mt5_c, "B": 64, "dtype": torch.float32},
        **{f"{n}{'_bias' if b else ''}": {
            **c, "bias": b, "packed": "layout" not in c}
           for n, c in SEG_EDGE_CASES.items() for b in (False, True)},
    }
    worst = {}
    for i, (name, c) in enumerate(cases.items()):
        x = k23_inputs(device, seed=600 + i, **c)
        errs = check_bwd_case("seg_check", name, c, x)
        worst[name] = {"dq": errs["dq"], "k3": max(errs["dk"], errs["dv"]),
                       "dbias": errs.get("dbias", 0.0),
                       "dtype": str(c["dtype"]).replace("torch.", "")}
        del x
    out = {"worst": worst, "summary": {}, "gdead": {}}
    for key, case, c, seed in (
            ("long", "bert_long_packed_bf16", long_c, 700),
            ("long_train", "bert_long_train_layout_bf16", train_c, 702),
            ("mt5", "mt5_packed_bias_bf16", mt5_c, 701)):
        x = k23_inputs(device, seed=seed, **c)
        out["summary"][key] = check_summary(case, x)
        out["gdead"][key] = check_gdead(case, x)
        if x["bias"] is None:
            bitwise = k2_bitwise(x, case)
            delta = fa.launch_dq(x["q"], x["k"], x["v"], x["kv_mask"], x["g"],
                                 x["out"], x["lse"], x["seg"],
                                 summary_args(x)[0])[1]
        else:
            bitwise, delta = k4_bitwise(x, case)
        k3_bits = k3_bitwise(x, delta, case)
        del delta
        out[key] = {**time_bwd("seg_timing", case, c, x), "bitwise": bitwise,
                    "k3_bitwise": k3_bits}
        del x
    return out


def check_seg_mt5_train(device, train_seg) -> dict:
    """K4 and the biased K3 with segment ids at the packed mT5 cell's own
    first batch (`train_seg`, train_layout_seg's of phase 9's data), as
    check_seg holds and times them at `packed_seg`'s layout: against
    reference_backward, two runs of each bitwise equal, and each timed
    beside the share of tiles visited, the bound, the plain version and
    the library call."""
    name = "mt5_train_layout_bias_bf16"
    c = dict(B=MT5_PACK_TRAIN_BATCH // PACK, H=12, L=128, S=128, Dh=64,
             dtype=torch.bfloat16, bias=True, strided=True,
             seg_ids=train_seg)
    x = k23_inputs(device, seed=703, **c)
    errs = check_bwd_case("seg_check", name, c, x)
    bitwise, delta = k4_bitwise(x, name)
    k3_bits = k3_bitwise(x, delta, name)
    del delta
    t = time_bwd("seg_timing", name, c, x)
    return {**t, "bitwise": bitwise, "k3_bitwise": k3_bits,
            "worst": {"dq": errs["dq"], "k3": max(errs["dk"], errs["dv"]),
                      "dbias": errs["dbias"], "dtype": "bfloat16"}}


# kernel names (lower case) of cuDNN's convolutions and their layout
# transposes, and of the embedding lookup (a gather) and its backward
# (sort, segment sums)
CONV_KERNELS = ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm",
                "convolve", "nchwtonhwc", "nhwctonchw")
EMBEDDING_KERNELS = ("embedding", "indexselect", "vectorized_gather",
                     "radixsort", "grad_weight",
                     "sum_and_scatter", "partial_segment",
                     "partials_per_segment", "segment_offsets")


def device_breakdown(fn, iters: int = 5) -> dict:
    """Device time of fn() by kernel class, from torch.profiler (CUPTI):
    per-call milliseconds of K1, K2, K3, K4, the segment summary kernel,
    the dead rows' g sum, of convolutions (cuDNN), embedding lookups and
    their backward, matrix products, and of the rest (elementwise); of
    those of K1, K2, K3 and K4, the seg variants' share (their last
    template flag); the kernels launched per call; plus the six largest
    kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = [(e.key, e.self_device_time_total / 1e3 / iters)
               for e in events]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    classes = {"k1_flash_fwd": 0.0, "k2_flash_bwd_dq": 0.0,
               "k3_flash_bwd_dkv": 0.0, "k4_flash_bwd_dq_dbias": 0.0,
               "seg_summary": 0.0, "gdead": 0.0, "conv": 0.0,
               "embedding": 0.0, "matmul": 0.0, "other": 0.0}
    seg = {"k1_seg": 0.0, "k2_seg": 0.0, "k3_seg": 0.0, "k4_seg": 0.0}
    for name, ms in kernels:
        low = name.lower()
        # the template arguments, demangled (<64, true>) or not (ILi64ELb1EE)
        flags = re.search(r"_tc_kernel(?:<([^<>]*)>|I(\w*?)EE)", name)
        if flags and ((flags.group(1) or "").strip().endswith("true")
                      or (flags.group(2) or "").endswith("Lb1")):
            kind = ("k1_seg" if "flash_fwd" in low else
                    "k4_seg" if "dbias" in low else
                    "k2_seg" if "flash_bwd_dq" in low else "k3_seg")
            seg[kind] += ms
        if "seg_summary" in low:         # before K1 with seg
            classes["seg_summary"] += ms
        elif "gdead" in low:             # before K3 with seg
            classes["gdead"] += ms
        elif "flash_fwd" in low:
            classes["k1_flash_fwd"] += ms
        elif "dbias" in low:             # K4's two launches
            classes["k4_flash_bwd_dq_dbias"] += ms
        elif "flash_bwd_dq" in low:
            classes["k2_flash_bwd_dq"] += ms
        elif "flash_bwd_dkv" in low:
            classes["k3_flash_bwd_dkv"] += ms
        elif any(t in low for t in CONV_KERNELS):
            classes["conv"] += ms
        elif any(t in low for t in EMBEDDING_KERNELS):
            classes["embedding"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return {"device_ms_per_call": sum(ms for _, ms in kernels),
            "launches_per_call": sum(e.count for e in events) / iters,
            "by_class_ms": classes, "seg_variants_ms": seg,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


# -- phases 4 and 6: serving ---------------------------------------------------

# (seed, topics, page_len, query_len, languages) -> (page texts, query
# texts) made so far in this run
_KEPT_TEXTS: dict = {}


class KeptTexts:
    """A toy corpus whose texts are kept once made. ToyCorpus makes each
    text in Python under the GIL (about 2,100 pages/s on the card's host:
    PERF.md §5), and the phases read the same pages many times (phase 4's
    100,000 pages in phases 4, 13 and 14; each training cell's batches
    from text, then again as pre-made batches; the word corpus in phases
    11 and 12): kept, each text is made once a run. The texts, and so the
    token ids, stores, results and checks, are the corpus's own; a sweep
    over kept texts measures the tokenizer and the card, not the toy
    generator. A text does not depend on the corpus's size, so corpora
    of one seed and shape share them."""

    def __init__(self, corpus):
        self._corpus = corpus
        key = (corpus.seed, corpus.num_topics, corpus.page_len,
               corpus.query_len, corpus.languages)
        self._pages, self._queries = _KEPT_TEXTS.setdefault(key, ({}, {}))

    def __getattr__(self, name):
        return getattr(self._corpus, name)

    def page_text(self, i: int) -> str:
        text = self._pages.get(i)
        if text is None:
            text = self._pages[i] = self._corpus.page_text(i)
        return text

    def query_text(self, i: int) -> str:
        text = self._queries.get(i)
        if text is None:
            text = self._queries[i] = self._corpus.query_text(i)
        return text

    def pairs(self, start: int = 0, stop=None):
        stop = self.num_pages if stop is None else min(stop, self.num_pages)
        for i in range(start, stop):
            yield i, self.query_text(i), self.page_text(i)

    def all_texts(self, limit=None):
        stop = self.num_pages if limit is None else min(limit, self.num_pages)
        for i in range(stop):
            yield self.page_text(i)
            yield self.query_text(i)


def data_config(config: str, n_pages: int):
    from dnn_page_vectors_tpu_torch.config import get_config
    return get_config(config, {"data.num_pages": n_pages})


def train_tokenizers(cfg, corpus=None):
    """The subword tokenizers of Config `cfg` trained over its toy corpus
    (`corpus`, or a fresh one), and the seconds that took (host work
    only: for mT5 this runs in a second process while the card works on
    the BERT-mini phases)."""
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    t0 = time.perf_counter()
    q_tok, p_tok = build_tokenizer(
        cfg, corpus if corpus is not None else build_corpus(cfg))
    return q_tok, p_tok, time.perf_counter() - t0


def build_data(config: str, n_pages: int, tokenizers=None):
    """The toy corpus of n_pages pages and the tokenizers of the config
    (a trained vocab is trained on that corpus; the serving and training
    phases share them); `tokenizers` is the result of train_tokenizers
    when it ran elsewhere."""
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus
    cfg = data_config(config, n_pages)
    corpus = KeptTexts(build_corpus(cfg))
    q_tok, p_tok, tok_s = tokenizers or train_tokenizers(cfg, corpus)
    want = (cfg.data.trigram_buckets + 1 if cfg.data.tokenizer == "trigram"
            else cfg.data.vocab_size)
    if p_tok.vocab_size != want:
        raise AssertionError(f"vocab {p_tok.vocab_size} != {want}")
    # the trigram and subword tokenizers run the C++ encoders; the word
    # tokenizer has no native route (the JAX package has none either)
    paths = [getattr(t, "path", "python (no native encoder)")
             for t in (q_tok, p_tok)]
    if "python" in paths:
        raise AssertionError(f"a {config} tokenizer took the plain Python "
                             f"route: {paths}")
    emit({"phase": "tokenizer", "config": config, "encoder_path": paths,
          "style": cfg.data.tokenizer, "vocab_size": p_tok.vocab_size,
          "train_s": tok_s, "corpus_pages": n_pages,
          "languages": cfg.data.languages})
    return corpus, q_tok, p_tok


def card_vs_cpu(cfg, model, vocab: int, ids: torch.Tensor) -> dict:
    """The same weights encode the same pages on the card and through the
    port on the CPU: the largest difference of the unit page rows (float32
    before the store's float16), within ZOO_CPU_TOL of the model dtype."""
    from dnn_page_vectors_tpu_torch.models.factory import (
        DTYPES, build_two_tower)
    from dnn_page_vectors_tpu_torch.models.losses import l2_normalize
    cpu = build_two_tower(cfg, vocab_size=vocab, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        card = l2_normalize(model.encode_page(ids)).cpu()
        host = l2_normalize(cpu.encode_page(ids.cpu()))
    err = (card - host).abs().max().item()
    tol = ZOO_CPU_TOL[DTYPES[cfg.model.dtype]]
    if not err <= tol:
        raise AssertionError(f"{cfg.name}: page vectors on the card and on "
                             f"the CPU differ by {err} (tolerance {tol})")
    return {"pages": int(ids.shape[0]), "max_abs_err": err, "tol": tol}


def lstm_loop(tower, ids: torch.Tensor, backward: bool = False) -> dict:
    """The BiLSTM recurrence alone (models/lstm.py ``lstm_pass``, every
    layer and direction of `tower` on its own input projections of `ids`),
    forward, or forward and backward: the host's time to issue it, the
    device time and the kernels it launches, by torch.profiler. Inside an
    encode or a step it runs as here, between the input projections and
    the pooling."""
    from dnn_page_vectors_tpu_torch.models.lstm import lstm_pass
    mask = ids > 0
    passes = []
    with torch.no_grad():
        x = tower.word_embed(ids).to(tower.dtype)
        for layer in range(tower.num_layers):
            states = []
            for tag, rev in (("fwd", False), ("bwd", True)):
                xp = getattr(tower, f"in_proj{layer}_{tag}")(x).float()
                u = getattr(tower, f"rec{layer}_{tag}").detach()
                passes.append((xp.requires_grad_(backward),
                               u.clone().requires_grad_(backward), rev))
                states.append(torch.stack(lstm_pass(xp, mask, u, rev)[1], 1))
            x = torch.cat(states, -1).to(tower.dtype)

    def run():
        with torch.set_grad_enabled(backward):
            for xp, u, rev in passes:
                h, hs = lstm_pass(xp, mask, u, rev)
                if backward:
                    torch.autograd.grad(h.sum() + torch.stack(hs).sum(),
                                        (xp, u))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    prof = device_breakdown(run, iters=2)
    return {"shape": list(ids.shape), "backward": backward,
            "steps": len(passes) * ids.shape[1],
            "host_issue_ms": host_ms,
            "device_ms": prof["device_ms_per_call"],
            "launches": prof["launches_per_call"],
            "by_class_ms": prof["by_class_ms"]}


def run_slice(device, config: str, n_pages: int, n_queries: int,
              workdir: str, data) -> dict:
    """Bulk embeds the first n_pages pages of the data's corpus into a
    store, serves queries from it, and checks the results: transformer
    towers with flash attention (K1 once per layer per encode, held against
    dense attention), the other towers with no attention kernel at all
    (held against the same weights on the CPU)."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus, to_device
    from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk

    transformer = get_config(config).model.encoder in TRANSFORMERS
    # the query cache off: every single query below is timed through the
    # encode (phase 16 serves with it on)
    overrides = {"data.num_pages": n_pages, "eval.store_shard_size": 65_536,
                 "eval.embed_batch_size": 512, "serve.query_cache_size": 0,
                 **({"model.attention": "flash"} if transformer else {})}
    cfg = get_config(config, overrides)
    m = cfg.model
    _, q_tok, p_tok = data
    # page i is the same text at every size
    corpus = KeptTexts(build_corpus(cfg))

    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    # warm the card (cuBLAS handles, the kernel library) outside the run
    emb.embed_pages(np.zeros((8,) + p_tok.encode("").shape, np.int32))
    emb.embed_queries(np.zeros((8,) + q_tok.encode("").shape, np.int32))
    torch.cuda.synchronize()

    store = VectorStore(os.path.join(workdir, f"store_{config}"),
                        dim=m.out_dim, shard_size=cfg.eval.store_shard_size)
    qids = np.linspace(0, n_pages - 1, n_queries).astype(np.int64)
    queries = [corpus.query_text(int(i)) for i in qids]

    # ---- the main path, counted --------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    emb.embed_corpus(corpus, store)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    svc = SearchService(cfg, emb, corpus, store)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = svc.search_many(queries, k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    lat = []
    for i in range(LATENCY_SAMPLES):
        t0 = time.perf_counter()
        one = svc.search(queries[i % n_queries], k=10)
        lat.append((time.perf_counter() - t0) * 1e3)
        if not one:
            raise AssertionError("a query returned no results")
    launches, launches_tc = fa.launches, fa.launches_tc
    if not transformer:
        require_no_attention(f"{config} serving")
    # ------------------------------------------------------------------
    if launches_tc != launches:
        raise AssertionError(f"{launches - launches_tc} of {launches} bf16 "
                             "K1 launches missed the tensor-core kernel")
    bs = cfg.eval.embed_batch_size
    ss = cfg.eval.store_shard_size
    n_batches = sum(-(-min(ss, n_pages - lo) // bs)
                    for lo in range(0, n_pages, ss))
    encode_calls = n_batches + 1 + LATENCY_SAMPLES  # embed, batch, singles
    per_encode = m.num_layers if transformer else 0
    expected = encode_calls * per_encode
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times in the main "
                             f"path, expected {expected} (one per layer "
                             f"per encode call)")

    # ---- checks ------------------------------------------------------
    if store.num_vectors != n_pages or svc.num_vectors != n_pages:
        raise AssertionError(f"store holds {store.num_vectors} vectors, "
                             f"want {n_pages}")
    pages = svc.pages.float()
    norms = pages.norm(dim=1)
    if not (torch.isfinite(pages).all() and
            (norms - 1).abs().max().item() < 2e-3):
        raise AssertionError("store vectors are not finite unit rows")
    qv = svc.encode_queries(queries)[:n_queries]
    full = qv @ pages.T
    want_s, want_i = torch.topk(full, 10, dim=1)
    want_pid = svc.page_ids[want_i.cpu().numpy()]
    got_pid = np.array([[r["page_id"] for r in res] for res in results])
    got_s = np.array([[r["score"] for r in res] for res in results])
    want_s = want_s.cpu().numpy()
    score_err = float(np.abs(got_s - want_s).max())
    mism = 0
    for a, b, s in zip(got_pid, want_pid, want_s):
        for j in np.flatnonzero(a != b):
            near = [abs(s[j] - s[x]) <= 1e-4
                    for x in (j - 1, j + 1) if 0 <= x < len(s)]
            if not any(near):
                raise AssertionError(f"top-k differs from the plain "
                                     f"q @ store^T at a non-tie: {a} vs {b}")
            mism += 1
    if score_err > 1e-4:            # _format rounds scores to 4 decimals
        raise AssertionError(f"scores differ by {score_err}")

    # flash towers vs dense towers on the same weights and pages (the
    # other towers: the card vs the CPU), and the stored rows vs a fresh
    # encode of the same first batch
    ids = to_device(p_tok.encode_batch(
        [corpus.page_text(i) for i in range(bs)]), device)
    fa.launches = 0                 # K1 launches of one 512-page encode
    v_flash = emb.encode_pages(ids).float()
    launches_per_batch = fa.launches
    if launches_per_batch != per_encode:
        raise AssertionError(f"one encode launched K1 {launches_per_batch} "
                             f"times, want {per_encode} (one per layer)")
    checks = {}
    if transformer:
        dense = build_two_tower(
            get_config(config, {**overrides, "model.attention": "dense"}),
            vocab_size=p_tok.vocab_size, device=device)
        dense.load_state_dict(model.state_dict())
        v_dense = BulkEmbedder(cfg, dense, p_tok,
                               device=device).encode_pages(ids).float()
        del dense
        flash_dense_err = (v_flash - v_dense).abs().max().item()
        if not flash_dense_err <= 5e-3:
            raise AssertionError(f"flash vs dense page vectors differ by "
                                 f"{flash_dense_err} (tolerance 5e-3)")
        checks["flash_vs_dense_max_err"] = flash_dense_err
    else:
        checks["card_vs_cpu"] = card_vs_cpu(cfg, model, p_tok.vocab_size,
                                            ids[:ZOO_CPU_PAGES])
    stored_err = (pages[:bs] - v_flash).abs().max().item()
    if not stored_err <= 1e-3:
        raise AssertionError(f"store rows differ from a fresh encode of the "
                             f"same batch by {stored_err}")

    # device-only encode rate: a pre-tokenized batch, no host in the loop
    dev_ms = cuda_ms(lambda: emb.encode_pages(ids), iters=20)
    encode_profile = device_breakdown(lambda: emb.encode_pages(ids))
    one_q = to_device(q_tok.encode_batch(queries[:1] + [""] * 7), device)
    query_profile = device_breakdown(
        lambda: chunked_topk(emb.encode_queries(one_q)[:1], svc.pages, k=10))

    if m.encoder == "lstm":
        checks["lstm_loop_encode"] = lstm_loop(model.page_tower, ids)
    recall, n_eval = evaluate_recall(emb, corpus, store, num_queries=1000,
                                     k=10)
    rec = {
        "phase": "slice", "config": cfg.name, **widths(cfg),
        "vocab": p_tok.vocab_size, "pages": n_pages,
        "embed_pages_per_s_from_text": n_pages / embed_s,
        "embed_s": embed_s,
        "embed_breakdown_s": {k: v for k, v in emb.stats.items()
                              if k.endswith("_s")},
        "encode_pages_per_s_device": bs / (dev_ms / 1e3),
        "encode_ms_per_512_batch": dev_ms,
        # an estimate, not traced: batches x the separately measured
        # per-batch device time, over the sweep's wall time
        "embed_device_busy_share_estimate": n_batches * dev_ms / 1e3 / embed_s,
        "encode_profile": encode_profile,
        "query_device_profile": query_profile,
        "queries": n_queries, "search_many_ms": batch_ms,
        "query_latency_samples": len(lat),
        "query_p50_ms": float(np.percentile(lat, 50)),
        "query_p95_ms": float(np.percentile(lat, 95)),
        "k1_launches": launches,
        "k1_launches_tensor_core": launches_tc,
        "k1_launches_per_embed_batch": launches_per_batch,
        "topk_score_err": score_err, "topk_tie_swaps": mism, **checks,
        "store_vs_fresh_encode_err": stored_err,
        "recall_at_10_random_weights": recall, "recall_queries": n_eval,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


# -- phases 5, 7, 8 and 9: training ------------------------------------------

def _grads(model, batch, generator=None) -> dict:
    """Parameter gradients of the contrastive loss on one batch (packed
    rows when it has "page_seg", mined negatives when it has
    "neg_page")."""
    from dnn_page_vectors_tpu_torch.models.losses import (
        cosine_contrastive_loss)
    model.zero_grad(set_to_none=True)
    q, p, neg, scale = model(batch["query"], batch["page"],
                             batch.get("neg_page"), generator=generator,
                             page_seg=batch.get("page_seg"),
                             page_pos=batch.get("page_pos"))
    loss, _ = cosine_contrastive_loss(q, p, scale, neg)
    loss.backward()
    return {n: t.grad.detach().clone() for n, t in model.named_parameters()}


def flash_vs_dense(config, overrides, vocab, batch, device, dtype) -> dict:
    """Parameter gradients of flash and dense towers with the same seeded
    weights, dropout off, at model.dtype `dtype`: the largest relative
    error ||flash - dense|| / ||dense|| over the gradient tensors (the t5
    rel_bias table among them).

    A key bias (bert) shifts every score of a query row by the same q.b,
    which the softmax ignores: its exact gradient is 0 and both versions
    hold rounding noise there, so it is held to a bound relative to its
    layer's wk.weight gradient instead of to itself."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    grads, state = {}, None
    for att in ("flash", "dense"):
        c = get_config(config, {
            **overrides, "model.attention": att, "model.dropout": 0.0,
            "model.dtype": dtype})
        tower = build_two_tower(c, vocab_size=vocab, device=device).train()
        if state is None:
            state = tower.state_dict()
        tower.load_state_dict(state)
        grads[att] = _grads(tower, batch)
        del tower
    rel, key_bias = {}, {}
    for n, g in grads["dense"].items():
        f = grads["flash"][n]
        if n.endswith(".attn.wk.bias"):
            ref = grads["dense"][n[:-len("bias")] + "weight"].norm().item()
            key_bias[n] = max(f.norm().item(), g.norm().item()) / ref
        else:
            rel[n] = ((f - g).norm() / g.norm().clamp_min(1e-30)).item()
    names = [f"page_tower.block0.attn.{n}.weight" for n in ("wq", "wk", "wv")]
    names += [n for n in grads["flash"] if n.endswith("rel_bias")]
    for name in names:
        if not grads["flash"][name].abs().max().item() > 0:
            raise AssertionError(f"{name} got no gradient through flash")
    worst = max(rel, key=rel.get)
    return {"max_rel_err": rel[worst], "worst_tensor": worst,
            "rel_bias_rel_err": {n: e for n, e in rel.items()
                                 if n.endswith("rel_bias")},
            "key_bias_over_wk": max(key_bias.values(), default=0.0)}


# the training cells: the config, its batch (pages a step), pages packed a
# row, and (transformer cells) the batch share (pages) and bounds of the
# flash vs dense gradient comparison (no f32 share: none in f32); resume
# False leaves out the resume check
TRAIN_CELLS = {
    "bert_mini": dict(config="bert_mini_v5p16", batch=TRAIN_BATCH, pack=1,
                      bf16_pages=TRAIN_BATCH, f32_pages=F32_ROWS,
                      bf16_tol=FLASH_DENSE_GRAD_TOL),
    "mt5": dict(config=MT5, batch=MT5_TRAIN_BATCH, pack=1,
                bf16_pages=MT5_BF16_ROWS, f32_pages=None,
                bf16_tol=MT5_FLASH_DENSE_GRAD_TOL, resume=False),
    "bert_long_packed": dict(config=LONG, batch=LONG_TRAIN_BATCH, pack=PACK,
                             bf16_pages=32 * PACK, f32_pages=8 * PACK,
                             bf16_tol=LONG_FLASH_DENSE_GRAD_TOL),
    "mt5_packed": dict(config=MT5, batch=MT5_PACK_TRAIN_BATCH, pack=PACK,
                       bf16_pages=MT5_BF16_ROWS, f32_pages=None,
                       bf16_tol=MT5_FLASH_DENSE_GRAD_TOL, resume=False),
    # the towers without attention, at their configs' batches
    "cdssm": dict(config=CDSSM, batch=256, pack=1),
    "kim_cnn": dict(config=KIM, batch=4_096, pack=1),
    "lstm": dict(config=LSTM, batch=4_096, pack=1),
}


def packed_data(config: str, words: int, n_pages: int, data):
    """A packed cell's corpus, toy pages of `words` words (the config's
    other corpus settings), and tokenizers at the config's token lengths
    over the vocab of `data` (an earlier phase's): the toy corpus draws its
    words from the seed alone, whatever the page length, which this
    checks."""
    from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
    from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
    from dnn_page_vectors_tpu_torch.config import get_config
    d = get_config(config).data
    base, _, p_tok = data
    corpus = KeptTexts(ToyCorpus(
        num_pages=n_pages, seed=d.seed, page_len=words,
        query_len=d.query_len, languages=d.languages,
        num_topics=d.num_topics))
    same = (corpus.common_words == base.common_words
            and corpus.topic_words == base.topic_words
            and all(np.array_equal(a, b) for a, b in
                    zip(corpus._lang_perm, base._lang_perm))
            and len(corpus._lang_perm) == len(base._lang_perm))
    if not same:
        raise AssertionError(f"the toy corpus of {words}-word pages draws "
                             "other words than the vocab's corpus")
    emit({"phase": "packed_data", "config": config, "page_words": words,
          "corpus_pages": n_pages, "vocab_size": p_tok.vocab_size,
          "vocab_from": f"{base.num_pages}-page corpus of "
                        f"{base.page_len}-word pages"})
    q = SubwordTokenizer(p_tok.vocab, style=p_tok.style,
                         max_tokens=d.query_len)
    p = SubwordTokenizer(p_tok.vocab, style=p_tok.style,
                         max_tokens=d.page_len)
    return corpus, q, p


def _take(batch: dict, pages: int, pack: int) -> dict:
    """The first `pages` pages of a batch: its first pages / pack rows of
    packed pages (and the queries of those pages)."""
    rows = pages // pack
    return {k: v[:rows] if k in ("page", "page_seg", "page_pos")
            else v[:pages] for k, v in batch.items()}


def determinism_cost(trainer, batches) -> dict:
    """Step times (CUDA events) with cuDNN's deterministic algorithms, as
    the port runs, and without them (``cudnn.deterministic`` False, the
    algorithms cuDNN picks by its heuristics), in turns on the same
    batches: what bitwise equal gradients cost the conv towers (the
    float32 CDSSM conv's deterministic backward is an FFT one)."""
    def step_ms(b) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(b)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    times = {True: [], False: []}
    try:
        for det in (True, False, False, True):
            torch.backends.cudnn.deterministic = det
            times[det] += [step_ms(b) for b in batches]
    finally:
        torch.backends.cudnn.deterministic = True
    return {"deterministic_ms": times[True],
            "nondeterministic_ms": times[False],
            "deterministic_median_ms": float(np.median(times[True])),
            "nondeterministic_median_ms": float(np.median(times[False]))}


def resume_check(new_trainer, batches, losses, workdir: str,
                 cell_name: str) -> float:
    """3 steps on a fresh Trainer, a save, a restore into another, 3 more
    steps: the largest difference of their losses from the straight run's
    `losses`, within RESUME_LOSS_TOL."""
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    first = new_trainer()
    for b in batches[:3]:
        first.train_step(b)
    ckpt = CheckpointManager(os.path.join(workdir, f"ckpt_{cell_name}"),
                             max_to_keep=1)
    first.save(ckpt)
    del first
    resumed = new_trainer()
    if resumed.restore(ckpt) != 3:
        raise AssertionError("restored the wrong step")
    resumed_losses = [float(resumed.train_step(b)["loss"])
                      for b in batches[3:]]
    resume_diff = float(np.abs(np.array(resumed_losses)
                               - np.array(losses[3:])).max())
    if not resume_diff <= RESUME_LOSS_TOL:
        raise AssertionError(f"resumed losses {resumed_losses} differ from "
                             f"straight {losses[3:]} by {resume_diff}")
    return resume_diff


def run_training(device, cell_name: str, data, workdir: str) -> dict:
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import (
        TrainBatcher, pack_segments, to_device)
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.train.loop import (
        Trainer, dropout_generator)

    cell = TRAIN_CELLS[cell_name]
    config, pack = cell["config"], cell["pack"]
    corpus, q_tok, p_tok = data
    transformer = get_config(config).model.encoder in TRANSFORMERS
    overrides = {"data.num_pages": corpus.num_pages, "train.log_every": 1,
                 "train.batch_size": cell["batch"],
                 "train.pack_pages": pack,
                 **({"model.attention": "flash"} if transformer else {})}
    cfg = get_config(config, overrides)
    m, t = cfg.model, cfg.train
    # one launch per layer per tower; none without attention
    per_layer = 2 * m.num_layers if transformer else 0
    biased = m.encoder == "t5"           # K4 replaces K2 on the bias path
    per_step = [per_layer, 0 if biased else per_layer, per_layer,
                per_layer if biased else 0]
    # with packing, the page tower's launches (one per layer) take seg:
    # each of its forward calls launches the segment summary kernel once
    # (its backward takes that summary), each backward call the dead rows'
    # g sum once
    seg_step = [n // 2 if pack > 1 else 0 for n in per_step]
    summary_step = seg_step[0]
    gdead_step = seg_step[2]
    names = ("k1", "k2", "k3", "k4")

    def new_trainer():
        return Trainer(cfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                       device=device)

    def counts():
        return [fa.launches, fa.dq_launches, fa.dkv_launches,
                fa.dq_dbias_launches]

    def seg_counts():
        return [fa.launches_seg, fa.dq_launches_seg, fa.dkv_launches_seg,
                fa.dq_dbias_launches_seg]

    # the seconds of each part of the phase, for the chip check's time
    part_s, t_part = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    # ---- the main path, counted: Trainer.train from text ---------------
    trainer = new_trainer()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts()
    tensor_core = {"k1": fa.launches_tc, "k2": fa.dq_launches_tc,
                   "k3": fa.dkv_launches_tc, "k4": fa.dq_dbias_launches_tc}
    with_seg = dict(zip(names, seg_counts()))
    summaries = fa.seg_summary_launches
    gdeads = fa.gdead_launches
    # ------------------------------------------------------------------
    if (summaries, gdeads) != (TRAIN_STEPS * summary_step,
                               TRAIN_STEPS * gdead_step):
        raise AssertionError(f"the segment summary kernel and the dead "
                             f"rows' g sum launched {summaries}, {gdeads} "
                             f"times in {TRAIN_STEPS} steps, want "
                             f"{TRAIN_STEPS * summary_step}, "
                             f"{TRAIN_STEPS * gdead_step}")
    if launches != [TRAIN_STEPS * n for n in per_step]:
        raise AssertionError(f"K1/K2/K3/K4 launched {launches} times in "
                             f"{TRAIN_STEPS} steps, want "
                             f"{[TRAIN_STEPS * n for n in per_step]}")
    if list(tensor_core.values()) != launches:
        raise AssertionError(f"of {launches} K1/K2/K3/K4 launches (all bf16) "
                             f"only {tensor_core} took the tensor-core "
                             "kernels")
    if list(with_seg.values()) != [TRAIN_STEPS * n for n in seg_step]:
        raise AssertionError(f"K1/K2/K3/K4 launched {with_seg} times with "
                             f"segment ids, want "
                             f"{[TRAIN_STEPS * n for n in seg_step]}")
    hist = trainer.history
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite([h["loss"], h["grad_norm"]]).all() and h["loss"] > 0
            for h in hist):
        raise AssertionError(f"training metrics are not finite: {hist}")
    del trainer                          # one trainer on the card at a time
    lap("from_text")

    # ---- device timing on pre-made batches ---------------------------------
    t0 = time.perf_counter()
    host = [b for _, b in zip(range(TRAIN_STEPS), TrainBatcher(
        corpus, q_tok, p_tok, batch_size=t.batch_size, seed=t.seed))]
    produce_s = time.perf_counter() - t0
    packing = {}
    if pack > 1:
        # packed as TrainBatcher(pack=...) packs them (the first batch is
        # checked against it), with the share of page tokens waterfilling
        # clipped to fit the rows
        tokens = sum(int((b["page"] != 0).sum()) for b in host)
        host = [dict(b, **dict(zip(("page", "page_seg", "page_pos"),
                                   pack_segments(b["page"], pack))))
                for b in host]
        kept = sum(int((b["page_seg"] > 0).sum()) for b in host)
        first = next(iter(TrainBatcher(corpus, q_tok, p_tok,
                                       batch_size=t.batch_size, seed=t.seed,
                                       pack=pack)))
        if list(first) != list(host[0]) or not all(
                np.array_equal(first[k], host[0][k]) for k in first):
            raise AssertionError("the packed batches differ from "
                                 "TrainBatcher's")
        packing = {"pack_pages": pack,
                   "rows_per_step": t.batch_size // pack,
                   "page_tokens_per_step": tokens / TRAIN_STEPS,
                   "mean_page_tokens": tokens / TRAIN_STEPS / t.batch_size,
                   "row_fill": kept / (len(host) * host[0]["page"].size),
                   "page_tokens_clipped_share": 1.0 - kept / tokens}
        emit({"phase": "packing", "cell": cell_name, **packing})
    batches = [{k: to_device(v, device) for k, v in b.items()} for b in host]
    straight = new_trainer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, enqueue_ms, wall_ms = [], [], [], []
    for b in batches:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        metrics = straight.train_step(b)
        enqueue_ms.append((time.perf_counter() - w0) * 1e3)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - w0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lap("timed_steps")
    main_diff = float(np.abs(np.array(losses)
                             - np.array([h["loss"] for h in hist])).max())
    if not main_diff <= RESUME_LOSS_TOL:
        raise AssertionError(f"the timed run's losses {losses} differ from "
                             f"Trainer.train's {[h['loss'] for h in hist]}")
    med = float(np.median(step_ms[TRAIN_WARMUP:]))
    reset_counts()
    straight.train_step(batches[0])
    torch.cuda.synchronize()
    one_step = counts()
    summaries_one_step = fa.seg_summary_launches
    gdeads_one_step = fa.gdead_launches
    if (one_step != per_step or seg_counts() != seg_step
            or (summaries_one_step, gdeads_one_step)
            != (summary_step, gdead_step)):
        raise AssertionError(f"one step launched K1/K2/K3/K4 {one_step} "
                             f"times ({seg_counts()} with seg, the summary "
                             f"{summaries_one_step}, the dead rows' sum "
                             f"{gdeads_one_step}), want {per_step} "
                             f"({seg_step}, {summary_step}, {gdead_step})")
    profile = device_breakdown(lambda: straight.train_step(batches[1]),
                               iters=1)
    # where the host waits for the device inside a step: PyTorch warns at
    # each synchronizing call while the sync debug mode is on
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            straight.train_step(batches[2])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught
             if "called a synchronizing" in str(w.message)]
    torch.cuda.synchronize()
    lap("launches_profile")

    extra = {}
    if m.encoder == "lstm":
        extra["lstm_loop_step"] = [
            lstm_loop(straight.model.query_tower, batches[1]["query"], True),
            lstm_loop(straight.model.page_tower, batches[1]["page"], True)]
    if m.encoder in ("cdssm", "kim_cnn"):
        extra["determinism_cost"] = determinism_cost(straight, batches[1:4])

    # ---- bitwise: one step's gradients twice, dropout on ---------------------
    g1 = _grads(straight.model, batches[2],
                dropout_generator(t.seed, 0, device))
    g2 = _grads(straight.model, batches[2],
                dropout_generator(t.seed, 0, device))
    differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    if differ:
        raise AssertionError(f"two runs of one step gave different "
                             f"gradients for {differ}")
    del g1, g2, straight
    lap("bitwise")

    # ---- resume: 3 steps, save, restore into a fresh Trainer, 3 steps ------
    resume_diff = None
    if cell.get("resume", True):
        resume_diff = resume_check(new_trainer, batches, losses, workdir,
                                   cell_name)
    lap("resume")

    # ---- flash vs dense gradients, dropout off, the seeded weights ----------
    if transformer:
        comps = [("bf16", cell["bf16_pages"], "bfloat16", cell["bf16_tol"])]
        if cell["f32_pages"]:
            comps.append(("f32", cell["f32_pages"], "float32",
                          FLASH_DENSE_GRAD_TOL_F32))
        for name, pages, dtype, tol in comps:
            fvd = flash_vs_dense(config, overrides, p_tok.vocab_size,
                                 _take(batches[2], pages, pack), device,
                                 dtype)
            if not fvd["max_rel_err"] <= tol:
                raise AssertionError(f"flash vs dense gradients differ: "
                                     f"{fvd} (bound {tol})")
            if not fvd["key_bias_over_wk"] <= KEY_BIAS_GRAD_TOL:
                raise AssertionError(f"a key-bias gradient (exactly 0 in "
                                     f"exact arithmetic) is not small: {fvd}")
            extra[f"flash_vs_dense_grads_{name}"] = {
                **fvd, "tol": tol, "pages": pages}
        extra["key_bias_grad_tol"] = KEY_BIAS_GRAD_TOL
        lap("flash_vs_dense")


    rec = {
        "phase": "train", "cell": cell_name, "config": cfg.name,
        **widths(cfg), "page_len": cfg.data.page_len,
        "query_len": cfg.data.query_len,
        "vocab": p_tok.vocab_size, "batch_pages": t.batch_size,
        "config_batch_pages": get_config(config).train.batch_size,
        **packing,
        "steps": TRAIN_STEPS,
        "train_pages_per_s_from_text": TRAIN_STEPS * t.batch_size / train_s,
        "train_s": train_s,
        "host_batch_produce_s": produce_s / TRAIN_STEPS,
        "median_step_ms": med,
        "step_ms_cuda_events": step_ms,
        "train_pages_per_s_device": t.batch_size / (med / 1e3),
        # the host's time to issue a step includes any wait for the device:
        # at a synchronizing call (host_syncs_in_one_step lists those the
        # sync debug mode sees) or at a full launch queue
        "host_enqueue_ms": enqueue_ms, "step_wall_ms": wall_ms,
        "host_syncs_in_one_step": syncs,
        # share of the step in which the device runs no kernel, i.e. waits
        # for the host: 1 - profiled kernel time / CUDA-event step time
        "host_share": 1.0 - profile["device_ms_per_call"] / med,
        "device_busy_share": profile["device_ms_per_call"] / med,
        "peak_memory_gb": peak_gb,
        "step_profile": profile,
        "launches_main_path": dict(zip(names, launches)),
        "launches_tensor_core_main_path": tensor_core,
        "launches_seg_main_path": with_seg,
        "launches_one_step": dict(zip(names, one_step)),
        "seg_summary_launches_main_path": summaries,
        "seg_summary_launches_one_step": summaries_one_step,
        "gdead_launches_main_path": gdeads,
        "gdead_launches_one_step": gdeads_one_step,
        "losses": losses, "history": hist,
        "timed_vs_main_path_loss_max_diff": main_diff,
        "resume_checked": resume_diff is not None,
        "resume_loss_max_diff": resume_diff,
        "resume_loss_tol": RESUME_LOSS_TOL,
        "bitwise_equal_grads": True, **extra, "seconds_by_part": part_s,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


def cdssm_quality(device, workdir: str) -> dict:
    """tests/test_e2e_cdssm_toy.py on the card: cdssm_toy at the test's
    overrides (600 pages, 80 steps) trained through Trainer.train, bulk
    embedded, and evaluated with evaluate_recall over 200 queries, which
    must give Recall@10 > 0.5 (random: about 0.017)."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    cfg = get_config(CDSSM, E2E_CDSSM)
    reset_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    metrics = trainer.train()
    train_s = time.perf_counter() - t0
    store = VectorStore(os.path.join(workdir, "store_cdssm_quality"),
                        dim=cfg.model.out_dim, shard_size=256)
    emb = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                       query_tok=trainer.query_tok, device=device)
    emb.embed_corpus(trainer.corpus, store, batch_size=128)
    recall, n = evaluate_recall(emb, trainer.corpus, store,
                                num_queries=200, k=10)
    require_no_attention("the CDSSM quality run")
    rec = {"phase": "quality", "config": CDSSM, "overrides": E2E_CDSSM,
           "train_s": train_s, "loss": metrics["loss"],
           "in_batch_acc": metrics["in_batch_acc"],
           "recall_at_10": recall, "recall_queries": n,
           "recall_bar": E2E_RECALL_BAR, "pages": store.num_vectors,
           "device": torch.cuda.get_device_name(0)}
    emit(rec)
    if not (np.isfinite(metrics["loss"]) and recall > E2E_RECALL_BAR):
        raise AssertionError(f"the trained CDSSM reached Recall@10 "
                             f"{recall} (bar {E2E_RECALL_BAR}): {rec}")
    return rec


# -- phase 13: hard-negative mining (config 4) ---------------------------------

def launch_counts() -> dict:
    """Every kernel launch counter of the port, by name."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    return {name: getattr(fa, name) for name in fa.COUNTERS}


@contextlib.contextmanager
def pipeline_stages(stages: list, captured: dict):
    """While open, each stage of run_pipeline (Trainer.train,
    BulkEmbedder.embed_corpus, and the pipeline's evaluate_recall and
    mine_hard_negatives) appends {stage, host seconds, the launches each
    counter gained in it} to `stages`, read just after the stage; the
    mine's sweep leaves its query vectors and results, and the store's
    rows, in `captured` (the next round's embed resets the store)."""
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.mine import ann
    from dnn_page_vectors_tpu_torch.train import pipeline
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    last = [launch_counts()]
    saved = (Trainer.train, BulkEmbedder.embed_corpus,
             pipeline.evaluate_recall, pipeline.mine_hard_negatives,
             ann.topk_over_store)

    def staged(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            now = launch_counts()
            stages.append({"stage": name, "seconds": secs,
                           "launches": {k: now[k] - last[0][k]
                                        for k in now}})
            last[0] = now
            return out
        return run

    def mine(embedder, corpus, store, **kwargs):
        out = staged("mine", saved[3])(embedder, corpus, store, **kwargs)
        captured["store"] = store.load_all()
        return out

    def sweep(query_vecs, store, **kwargs):
        scores, ids = saved[4](query_vecs, store, **kwargs)
        for key, val in (("queries", query_vecs), ("scores", scores),
                         ("ids", ids)):
            captured.setdefault(key, []).append(val)
        return scores, ids

    Trainer.train = staged("train", saved[0])
    BulkEmbedder.embed_corpus = staged("embed", saved[1])
    pipeline.evaluate_recall = staged("eval", saved[2])
    pipeline.mine_hard_negatives = mine
    ann.topk_over_store = sweep
    try:
        yield
    finally:
        (Trainer.train, BulkEmbedder.embed_corpus, pipeline.evaluate_recall,
         pipeline.mine_hard_negatives, ann.topk_over_store) = saved


def expected_launches(k1: int, k2k3: int) -> dict:
    """Every counter as a stage of phase 13 must read it: K1 `k1` times,
    K2 and K3 `k2k3` times each, all on the tensor cores (bf16), nothing
    with seg, no K4, no summary, no gdead."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    want = dict.fromkeys(fa.COUNTERS, 0)
    for name, n in (("launches", k1), ("dq_launches", k2k3),
                    ("dkv_launches", k2k3)):
        want[name] = want[name + "_tc"] = n
    return want


def check_sweep(device, captured: dict, table: np.ndarray, H: int) -> dict:
    """The mine's sweep (topk_over_store, a shard at a time) against a
    plain top-k of the same fp16 store staged whole: f32 q @ store^T in
    query blocks, then torch.topk, for every query. Ids must be equal
    except at ties (where they differ, the two scores at that rank within
    TIE_SCORE_TOL), scores within SWEEP_SCORE_TOL; the mined table must
    equal _pick_negatives of the plain retrieval except in rows a tie
    touched."""
    from dnn_page_vectors_tpu_torch.mine.ann import _pick_negatives
    q = np.concatenate(captured["queries"])
    got_s = np.concatenate(captured["scores"])
    got_i = np.concatenate(captured["ids"])
    ids, vecs = captured["store"]
    k = got_i.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = torch.from_numpy(vecs).to(device).float()
    plain_s, plain_i = [], []
    for s0 in range(0, q.shape[0], 2_048):
        sc, idx = torch.topk(torch.from_numpy(q[s0: s0 + 2_048]).to(device)
                             @ pages.T, k, dim=1)
        plain_s.append(sc.cpu().numpy())
        plain_i.append(ids[idx.cpu().numpy()])
    plain_s, plain_i = np.concatenate(plain_s), np.concatenate(plain_i)
    plain_sweep_s = time.perf_counter() - t0
    del pages
    score_err = float(np.abs(got_s - plain_s).max())
    differ = got_i != plain_i
    tie_gap = float(np.abs(got_s - plain_s)[differ].max()) \
        if differ.any() else 0.0
    if tie_gap > TIE_SCORE_TOL:
        raise AssertionError(f"the sweep's ids differ from the plain top-k "
                             f"where the scores differ by {tie_gap}: not a "
                             "tie")
    if score_err > SWEEP_SCORE_TOL:
        raise AssertionError(f"the sweep's scores differ from the plain "
                             f"top-k by {score_err}")
    tie_rows = differ.any(axis=1)
    gold = np.arange(q.shape[0], dtype=np.int64)
    plain_table = _pick_negatives(plain_i, gold, H, len(ids))
    table_rows = (plain_table != table).any(axis=1)
    if (table_rows & ~tie_rows).any():
        raise AssertionError(f"{int((table_rows & ~tie_rows).sum())} rows of "
                             "the mined table differ from the plain "
                             "retrieval's picks with no tie in them")
    return {"queries": int(q.shape[0]), "store_rows": int(len(ids)), "k": k,
            "score_max_abs_err": score_err, "score_tol": SWEEP_SCORE_TOL,
            "tie_score_max_gap": tie_gap, "tie_score_tol": TIE_SCORE_TOL,
            "tie_swapped_slots": int(differ.sum()),
            "rows_touched_by_ties": int(tie_rows.sum()),
            "table_rows_differing_from_plain": int(table_rows.sum()),
            "plain_sweep_s": plain_sweep_s}


def run_hardneg(device, data, workdir: str) -> dict:
    """Phase 13: hardneg_v5p64 at full width over phase 4's corpus and
    vocab: run_pipeline (2 rounds of HARDNEG_ROUND_STEPS steps: in-batch
    training, an embed of the corpus, Recall@10, a mine of 7 negatives per
    page from the top HARDNEG_SEARCH_K; then training with them, an embed,
    Recall@10), every launch counter read after each stage; the mined
    table's checks and the sweep against a plain top-k; then steps with
    negatives on pre-made batches (timed by CUDA events, profiled, bitwise
    twice, flash vs dense) and their peak memory."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import TrainBatcher, to_device
    from dnn_page_vectors_tpu_torch.train.loop import (
        Trainer, dropout_generator)
    from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline

    t_phase = time.perf_counter()
    corpus, q_tok, p_tok = data
    n = corpus.num_pages
    if data_config(HARDNEG, n).data != data_config("bert_mini_v5p16", n).data:
        raise AssertionError(f"{HARDNEG} and bert_mini_v5p16 no longer share "
                             "their corpus and vocab")
    overrides = {"data.num_pages": n, "model.attention": "flash",
                 "train.batch_size": HARDNEG_BATCH, "train.log_every": 1,
                 "eval.store_shard_size": HARDNEG_SHARD,
                 "eval.embed_batch_size": 512}
    cfg = get_config(HARDNEG, overrides)
    m, t, e = cfg.model, cfg.train, cfg.eval
    H, B, R = t.hard_negatives, t.batch_size, HARDNEG_ROUND_STEPS
    layers = m.num_layers

    def batches_of(block: int, size: int) -> int:
        return sum(-(-min(block, n - lo) // size)
                   for lo in range(0, n, block))
    # one K1 per layer per encode: an in-batch step encodes queries and
    # pages, a step with negatives the negatives too (and K2, K3 alike)
    embed = expected_launches(batches_of(e.store_shard_size,
                                         e.embed_batch_size) * layers, 0)
    evaluate = expected_launches(
        -(-min(e.eval_queries, n) // e.embed_batch_size) * layers, 0)
    mine = expected_launches(batches_of(8_192, e.embed_batch_size) * layers,
                             0)     # mine_hard_negatives' query blocks
    in_batch = expected_launches(*2 * [R * 2 * layers])
    with_negs = expected_launches(*2 * [R * 3 * layers])
    want = [("train", in_batch), ("embed", embed), ("eval", evaluate),
            ("mine", mine), ("train", with_negs), ("embed", embed),
            ("eval", evaluate)]

    # ---- the main path, counted: run_pipeline -----------------------------
    trainer = Trainer(cfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                      workdir=os.path.join(workdir, "hardneg"), device=device)
    stages, captured = [], {}
    reset_counts()
    t0 = time.perf_counter()
    with pipeline_stages(stages, captured):
        out = run_pipeline(cfg, rounds=2, steps_per_round=R, trainer=trainer)
    torch.cuda.synchronize()
    pipeline_s = time.perf_counter() - t0
    total = launch_counts()
    # ------------------------------------------------------------------
    got = [(st["stage"], st["launches"]) for st in stages]
    if got != want:
        raise AssertionError(f"the pipeline's stages launched {got}, want "
                             f"{want}")
    hist = trainer.history
    if len(hist) != 2 * R or not all(
            np.isfinite([h["loss"], h["grad_norm"]]).all() and h["loss"] > 0
            for h in hist):
        raise AssertionError(f"training metrics are not finite: {hist}")
    recalls = out["recalls"]
    if len(recalls) != 2 or not all(0.0 <= r <= 1.0 for r in recalls):
        raise AssertionError(f"recalls {recalls}")
    negs = out["negatives"]
    table = np.asarray(negs.table)
    if table.shape != (n, H) or table.dtype != np.int32:
        raise AssertionError(f"mined table {table.shape} {table.dtype}, "
                             f"want ({n}, {H}) int32")
    if table.min() < 0 or table.max() >= n:
        raise AssertionError(f"mined ids out of range [{table.min()}, "
                             f"{table.max()}]")
    if (table == np.arange(n)[:, None]).any():
        raise AssertionError("the mined table holds a gold page")
    sweep = check_sweep(device, captured, table, H)
    rounds = []
    for r in out["rounds"]:
        row = {"round": r["round"], "step": r["step"],
               "train_s": r["train_s"],
               "embed_s": r["embed"]["seconds"],
               "embed_pages_per_s_from_text": r["embed"]["pages_per_sec"],
               "eval_s": r["eval_s"], "recall_at_10": r["recall"]}
        if "mine" in r:
            mst = r["mine"]
            row.update(mine_s=mst["seconds"],
                       mine_query_embed_s=mst["embed_s"],
                       mine_sweep_s=mst["sweep_s"],
                       mine_pick_s=mst["pick_s"],
                       sweep_query_row_products_per_s=(
                           mst["queries"] * n / mst["sweep_s"]))
        rounds.append(row)
    train_from_text_s = out["rounds"][1]["train_s"]
    del trainer, out, captured

    # ---- steps with negatives on pre-made batches ------------------------
    t0 = time.perf_counter()
    host = [b for _, b in zip(range(TRAIN_STEPS), TrainBatcher(
        corpus, q_tok, p_tok, batch_size=B, seed=t.seed,
        hard_negative_lookup=negs))]
    produce_s = time.perf_counter() - t0
    batches = [{k: to_device(v, device) for k, v in b.items()} for b in host]
    timed = Trainer(cfg, corpus=corpus, hard_negative_lookup=negs,
                    tokenizers=(q_tok, p_tok), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = timed.train_step(b)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(step_ms[TRAIN_WARMUP:]))
    reset_counts()
    timed.train_step(batches[0])
    torch.cuda.synchronize()
    one_step = launch_counts()
    per_step = expected_launches(*2 * [3 * layers])
    if one_step != per_step:
        raise AssertionError(f"one step with negatives launched {one_step}, "
                             f"want {per_step}")
    if not (np.isfinite(losses).all() and peak_gb <= PEAK_LIMIT_GB):
        raise AssertionError(f"losses {losses}, peak {peak_gb} GB (limit "
                             f"{PEAK_LIMIT_GB})")
    profile = device_breakdown(lambda: timed.train_step(batches[1]), iters=1)
    g1 = _grads(timed.model, batches[2], dropout_generator(t.seed, 0, device))
    g2 = _grads(timed.model, batches[2], dropout_generator(t.seed, 0, device))
    differ = [name for name in g1 if not torch.equal(g1[name], g2[name])]
    if differ:
        raise AssertionError(f"two runs of one step with negatives gave "
                             f"different gradients for {differ}")
    del g1, g2, timed
    bf16 = flash_vs_dense(HARDNEG, overrides, p_tok.vocab_size,
                          _take(batches[2], HARDNEG_GRAD_PAIRS, 1), device,
                          "bfloat16")
    if not (bf16["max_rel_err"] <= FLASH_DENSE_GRAD_TOL
            and bf16["key_bias_over_wk"] <= KEY_BIAS_GRAD_TOL):
        raise AssertionError(f"flash vs dense gradients with negatives "
                             f"differ: {bf16} (bound {FLASH_DENSE_GRAD_TOL})")
    del batches

    names = ("k1", "k2", "k3", "k4")
    keys = ("launches", "dq_launches", "dkv_launches", "dq_dbias_launches")
    rec = {
        "phase": "hardneg", "config": cfg.name, **widths(cfg),
        "page_len": cfg.data.page_len, "query_len": cfg.data.query_len,
        "vocab": p_tok.vocab_size, "dtype": m.dtype, "dropout": m.dropout,
        "pages": n, "store_shard_size": e.store_shard_size,
        "batch_pairs": B,
        "config_batch_pairs": get_config(HARDNEG).train.batch_size,
        "negatives": H, "page_encodes_per_step": B * (1 + H),
        "search_k": HARDNEG_SEARCH_K, "round_steps": R,
        "pipeline_s": pipeline_s, "rounds": rounds,
        "stages": [{**st, "launches": {k: v for k, v in st["launches"].items()
                                       if v}} for st in stages],
        "recalls_random_weights": recalls,
        "table": {"shape": list(table.shape), "dtype": str(table.dtype),
                  "min": int(table.min()), "max": int(table.max())},
        "sweep_check": sweep,
        "train_pairs_per_s_from_text": R * B / train_from_text_s,
        "train_page_encodes_per_s_from_text":
            R * B * (1 + H) / train_from_text_s,
        "host_batch_produce_s": produce_s / TRAIN_STEPS,
        "median_step_ms": med, "step_ms_cuda_events": step_ms,
        "losses": losses,
        "pairs_per_s_device": B / (med / 1e3),
        "page_encodes_per_s_device": B * (1 + H) / (med / 1e3),
        "host_share": 1.0 - profile["device_ms_per_call"] / med,
        "device_busy_share": profile["device_ms_per_call"] / med,
        "peak_memory_gb": peak_gb, "peak_limit_gb": PEAK_LIMIT_GB,
        "step_profile": profile,
        "launches_main_path": {nm: total[k] for nm, k in zip(names, keys)},
        "launches_tensor_core_main_path": {
            nm: total[k + "_tc"] for nm, k in zip(names, keys)},
        "launches_seg_main_path": {
            nm: total[k + "_seg"] for nm, k in zip(names, keys)},
        "launches_one_step": {nm: one_step[k] for nm, k in zip(names, keys)},
        "seg_summary_launches_main_path": total["seg_summary_launches"],
        "gdead_launches_main_path": total["gdead_launches"],
        "bitwise_equal_grads": True,
        "flash_vs_dense_grads_bf16": {**bf16, "tol": FLASH_DENSE_GRAD_TOL,
                                      "pairs": HARDNEG_GRAD_PAIRS,
                                      "negatives": HARDNEG_GRAD_PAIRS * H},
        "seconds": time.perf_counter() - t_phase,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


# -- phase 14: the IVF/PQ index and the int8 store ---------------------------

def npy_bytes(directory: str) -> dict:
    """Every .npy file of a directory, by name, as bytes."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".npy"):
            with open(os.path.join(directory, name), "rb") as f:
                out[name] = f.read()
    return out


def copy_store(store, path: str):
    """A copy of the store's files at `path` without its index, opened."""
    import shutil
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    shutil.copytree(store.directory, path,
                    ignore=shutil.ignore_patterns("ivf"))
    return VectorStore(path)


def check_int8_store(fp16, q8) -> dict:
    """The int8 store the bulk embed quantized on the card against the host
    quantization of the fp16 store's rows of the same weights: codes,
    scales and ids byte for byte, and the dequantized rows within half a
    scale of the fp16 rows."""
    from dnn_page_vectors_tpu_torch.infer.vector_store import quantize_rows
    if [s["count"] for s in fp16.shards()] != \
            [s["count"] for s in q8.shards()]:
        raise AssertionError("the int8 store's shards differ from the fp16 "
                             "store's")
    worst = 0.0
    for (ids16, v16, _), (ids8, codes, scl) in zip(
            fp16.iter_shards(raw=True), q8.iter_shards(raw=True)):
        h_codes, h_scl = quantize_rows(v16)
        if not (np.array_equal(ids16, ids8)
                and np.array_equal(np.asarray(codes), h_codes)
                and np.array_equal(scl, h_scl)):
            raise AssertionError("int8 codes or scales quantized on the card "
                                 "differ from the host's quantization")
        s = scl.astype(np.float32)[:, None]
        err = np.abs(np.asarray(codes, np.float32) * s
                     - np.asarray(v16, np.float32))
        if not (err <= s / 2).all():
            raise AssertionError("dequantized rows are over half a scale "
                                 "from the fp16 rows")
        worst = max(worst, float((err / np.maximum(s, 1e-12)).max()))
    return {"rows": q8.num_vectors, "codes_scales_equal_host": True,
            "max_err_in_scales": worst,
            "store_mb": {"fp16": fp16.num_vectors * fp16.row_bytes / 1e6,
                         "int8": q8.num_vectors * q8.row_bytes / 1e6}}


def ties_only(got_s, got_i, want_s, want_i, what: str) -> int:
    """Two top-k answers of the same rows: the same id set in every row
    except at ties (an id of one that the other lacks scores within
    TIE_SCORE_TOL of the other's k-th score), scores in rank order within
    SWEEP_SCORE_TOL. Returns the rows a tie touched."""
    err = float(np.abs(got_s - want_s).max())
    if err > SWEEP_SCORE_TOL:
        raise AssertionError(f"{what}: scores differ by {err}")
    touched = 0
    for gs, gi, ws, wi in zip(got_s, got_i, want_s, want_i):
        extra = set(gi.tolist()) ^ set(wi.tolist())
        if not extra:
            continue
        kth = min(gs[-1], ws[-1])
        score = {**dict(zip(wi.tolist(), ws)), **dict(zip(gi.tolist(), gs))}
        if any(abs(score[i] - kth) > TIE_SCORE_TOL for i in extra):
            raise AssertionError(f"{what}: id sets differ at a non-tie: "
                                 f"{sorted(extra)}")
        touched += 1
    return touched


def check_full_probe(index, store, q: np.ndarray, device) -> dict:
    """nprobe = nlist with every candidate re-ranked (rerank = N) against
    the exact sweep (topk_over_store) of the same store."""
    from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
    want_s, want_i = topk_over_store(q, store, k=10, device=device)
    got_s, got_i, st = index.search(q, k=10, nprobe=index.nlist,
                                    rerank=store.num_vectors)
    return {"queries": int(q.shape[0]), "nprobe": index.nlist,
            "rows_touched_by_ties": ties_only(got_s, got_i, want_s, want_i,
                                              "full probe vs exact"),
            "candidates_reranked": st["candidates_reranked"]}


def check_adc_survivors(index, q: np.ndarray, device, k: int = 10) -> dict:
    """adc_topr at full probe and the search's default re-rank depth
    (max(8k, 64) survivors a query) against a plain top-r on the host:
    every code row decoded (its codewords @ R^T) and scored against each
    query in float64. The survivors' scores agree with the plain ones
    within SWEEP_SCORE_TOL, and every survivor's plain score is within
    SWEEP_SCORE_TOL of the plain r-th or above it (the id sets agree except
    at ties)."""
    from dnn_page_vectors_tpu_torch.index.pq import adc_topr
    pq, r = index.pq, max(8 * k, 64)
    _, cent, _, _, codes = index._gather(np.arange(index.nlist), codes=True)
    qd = torch.from_numpy(q).to(device)
    sel = torch.arange(index.nlist, device=device)[None].expand(len(q), -1)
    got_s, got_p = adc_topr(pq.lut(qd), torch.from_numpy(codes).to(device),
                            torch.from_numpy(cent).to(device), sel, r=r)
    got_s, got_p = got_s.cpu().numpy(), got_p.cpu().numpy()
    words = pq.codebooks[np.arange(pq.m)[None], codes.astype(np.int64)]
    rows = words.reshape(len(codes), -1).astype(np.float64) \
        @ pq.rotation.T.astype(np.float64)
    plain = q.astype(np.float64) @ rows.T                       # [B, C]
    plain[:, cent < 0] = -np.inf                                # dead rows
    kth = -np.partition(-plain, r - 1, axis=1)[:, r - 1]
    if (got_p < 0).any():
        raise AssertionError("adc_topr returned fewer than r survivors")
    mine = np.take_along_axis(plain, got_p, axis=1)
    err = float(np.abs(got_s - mine).max())
    below = float((kth[:, None] - mine).max())
    if err > SWEEP_SCORE_TOL or below > SWEEP_SCORE_TOL:
        raise AssertionError(f"ADC survivors differ from the plain top-{r}: "
                             f"scores {err}, below the r-th by {below}")
    ref = np.argpartition(-plain, r - 1, axis=1)[:, :r]
    swapped = sum(len(set(a.tolist()) - set(b.tolist()))
                  for a, b in zip(got_p, ref))
    return {"queries": int(q.shape[0]), "rows": int(len(codes)), "r": r,
            "score_max_abs_err": err, "tie_swapped_survivors": swapped}


def check_card_vs_cpu(store, q: np.ndarray, nprobe: int) -> dict:
    """The card's search against the port's CPU run of the same index files
    and query vectors."""
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    card = IVFIndex.open(store)
    cpu = IVFIndex.open(store, device="cpu")
    gs, gi, gst = card.search(q, k=10, nprobe=nprobe)
    ws, wi, wst = cpu.search(q, k=10, nprobe=nprobe)
    err = float(np.abs(gs - ws).max())
    differ = gi != wi
    gap = float(np.abs(gs[differ] - ws[differ]).max()) if differ.any() \
        else 0.0
    if err > SWEEP_SCORE_TOL or gap > TIE_SCORE_TOL or gst != wst:
        raise AssertionError(f"the card's search differs from the CPU's: "
                             f"scores {err}, tie gap {gap}, stats {gst} vs "
                             f"{wst}")
    return {"queries": int(q.shape[0]), "nprobe": nprobe,
            "score_max_abs_err": err, "tie_swapped_slots": int(differ.sum())}


def recall_curve(index, store, q: np.ndarray) -> dict:
    """recall_vs_exact at each of IVF_NPROBES, and one search's stats per
    query there."""
    from dnn_page_vectors_tpu_torch.evals.recall import recall_vs_exact
    out = {}
    for nprobe in IVF_NPROBES:
        before = dict(index.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = recall_vs_exact(index, store, q, k=10, nprobe=nprobe)
        secs = time.perf_counter() - t0
        per_q = {k: (index.stats[k] - before.get(k, 0)) / q.shape[0]
                 for k in ("lists_scanned", "candidates_reranked",
                           "gather_bytes", "reranked_rows")}
        out[str(nprobe)] = {"recall_vs_exact_at_10": r,
                            "seconds_with_exact_sweep": secs,
                            "per_query": per_q}
    return out


def index_record(index) -> dict:
    man = index.manifest
    return {"nlist": index.nlist, "pq_m": index.pq_m,
            "store_dtype": man["dtype"], "rows": man["num_vectors"],
            "build_s": index.build_stats,
            "imbalance": man["imbalance"],
            "imbalance_raw": man["imbalance_raw"],
            "init_imbalance": man["init_imbalance"],
            "reseeded": man["reseeded"]}


def _timed(fn, key: str, split: dict):
    """fn, adding its milliseconds between two synchronizations of the card
    to split[key]."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        split[key] = split.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return run


@contextlib.contextmanager
def ivf_stages(split: dict):
    """While open, the IVF search's stages add their milliseconds to
    `split`, each between two synchronizations of the card: the centroid
    top-k, the ADC (tables and the running top-r), the exact re-ranks, and
    the gathers (the host's reads off the mmaps and the copies to the
    card)."""
    from dnn_page_vectors_tpu_torch.index import ivf
    saved = {n: getattr(ivf, n) for n in ("chunked_topk", "adc_topr",
                                          "rerank_candidates",
                                          "rerank_positions")}
    methods = {n: getattr(ivf.IVFIndex, n) for n in (
        "_gather", "_fetch_rows", "_dev")}
    lut = ivf.PQCodec.lut
    stage = {"chunked_topk": "topk", "adc_topr": "adc", "lut": "adc",
             "rerank_candidates": "rerank", "rerank_positions": "rerank",
             "_gather": "gather", "_fetch_rows": "gather", "_dev": "gather"}
    depth = [0]           # _gather calls _fetch_rows: time the outer only

    def timed(name, fn):
        clocked = _timed(fn, stage[name], split)

        def run(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            try:
                return clocked(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    for n, fn in saved.items():
        setattr(ivf, n, timed(n, fn))
    for n, fn in methods.items():
        setattr(ivf.IVFIndex, n, timed(n, fn))
    ivf.PQCodec.lut = timed("lut", lut)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ivf, n, fn)
        for n, fn in methods.items():
            setattr(ivf.IVFIndex, n, fn)
        ivf.PQCodec.lut = lut


def search_split(svc, queries) -> dict:
    """One search_many of `queries`: its milliseconds by stage (ivf_stages,
    the query tokenize, the query encode, the results' formatting with
    their snippets, and the rest), then its device time by kernel class
    (device_breakdown)."""
    split = {}
    for name in ("_tokenize", "_encode", "_format"):
        setattr(svc, name, _timed(getattr(svc, name), name.strip("_"),
                                  split))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ivf_stages(split):
            svc.search_many(queries, k=10)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        del svc._tokenize, svc._encode, svc._format
    split["other"] = total - sum(split.values())
    return {"queries": len(queries), "total_ms": total,
            "stage_ms": split,
            "device": device_breakdown(lambda: svc.search_many(queries, k=10),
                                       iters=2)}


def single_query_latency(svc, queries) -> dict:
    """LATENCY_SAMPLES single queries in a closed loop: p50 and p95 by the
    host clock and by CUDA events around each call."""
    wall, events = [], []
    for i in range(LATENCY_SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        one = svc.search(queries[i % len(queries)], k=10)
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        if not one:
            raise AssertionError("a query returned no results")
    pct = lambda xs, p: float(np.percentile(xs, p))  # noqa: E731
    return {"samples": len(wall), "p50_ms": pct(wall, 50),
            "p95_ms": pct(wall, 95), "events_p50_ms": pct(events, 50),
            "events_p95_ms": pct(events, 95)}


def big_store(emb, store, rows: int, device) -> dict:
    """Phase 14(b)'s store: `rows` page-tower encodes of seeded random
    WordPiece id rows drawn on the card, through the bulk embedder's
    encode-and-quantize (encode_pages_q8) and write_shard, a shard at a
    time; on a store with an attribute table each row also gets its
    `filter_words` word (phase 19's)."""
    cfg = emb.cfg
    bs, ss = cfg.eval.embed_batch_size, cfg.eval.store_shard_size
    vocab = emb.page_tok.vocab_size
    gen = torch.Generator(device=device).manual_seed(IVF_SEED)
    t0 = time.perf_counter()
    for si, lo in enumerate(range(0, rows, ss)):
        hi = min(lo + ss, rows)
        codes, scales = [], []
        for b in range(lo, hi, bs):
            ids = torch.randint(1, vocab, (min(bs, hi - b),
                                           cfg.data.page_len),
                                generator=gen, device=device)
            c, s = emb.encode_pages_q8(ids)
            codes.append(c)
            scales.append(s)
        store.write_shard(si, np.arange(lo, hi, dtype=np.int64),
                          codes=torch.cat(codes).cpu().numpy(),
                          scales=torch.cat(scales).cpu().numpy(),
                          attrs=(filter_words(lo, hi) if store.attrs_enabled
                                 else None))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"rows": rows, "shards": len(store.shards()), "seconds": secs,
            "rows_per_s": rows / secs,
            "store_mb": rows * store.row_bytes / 1e6}


def random_queries(emb, n: int, device) -> np.ndarray:
    """Query-tower encodes of `n` seeded random WordPiece id rows."""
    gen = torch.Generator(device=device).manual_seed(IVF_SEED + 1)
    ids = torch.randint(1, emb.query_tok.vocab_size,
                        (n, emb.cfg.data.query_len), generator=gen,
                        device=device)
    bs = emb.cfg.eval.embed_batch_size
    return np.concatenate([emb.encode_queries(ids[s: s + bs]).cpu().numpy()
                           for s in range(0, n, bs)])


def run_ivf(device, data, workdir: str) -> dict:
    """Phase 14: (a) phase 4's corpus through embed_corpus into an int8
    store, IVFIndex.build over phase 4's fp16 store (plain) and over the
    int8 store (PQ), SearchService(serve.index="ivf"), evaluate_recall and
    mine_hard_negatives through the index, every launch counter read after;
    (b) IVF and IVF-PQ over a store of IVF_BIG_ROWS rows. The checks raise;
    recall against exact, build times, latency and stats are printed."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex, index_dir
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.mine.ann import mine_hard_negatives
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower

    t_phase = time.perf_counter()
    corpus, q_tok, p_tok = data
    n = corpus.num_pages
    # phase 4's overrides and seed: the same weights as its fp16 store's
    base = {"data.num_pages": n, "eval.store_shard_size": 65_536,
            "eval.embed_batch_size": 512, "model.attention": "flash",
            "serve.query_cache_size": 0}
    # every index is built from its config's serve.* knobs: cfg's IVF-PQ
    # (serve.pq_m IVF_PQ_M), plain_cfg's stored-width postings
    cfg = get_config("bert_mini_v5p16", {**base, "eval.store_dtype": "int8",
                                         "serve.index": "ivf",
                                         "serve.pq_m": IVF_PQ_M})
    plain_cfg = get_config("bert_mini_v5p16", {**base, "serve.pq_m": 0})
    m, sv = cfg.model, cfg.serve

    def build(store, c):
        return IVFIndex.build_from_config(store, c, device=device)
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    fp16 = VectorStore(os.path.join(workdir, "store_bert_mini_v5p16"))
    if fp16.num_vectors != n:
        raise AssertionError(f"phase 4's store holds {fp16.num_vectors} "
                             f"vectors, want {n}")
    q8 = VectorStore(os.path.join(workdir, "ivf_int8"), dim=m.out_dim,
                     shard_size=cfg.eval.store_shard_size,
                     dtype=cfg.eval.store_dtype)
    qids = np.linspace(0, n - 1, N_QUERIES).astype(np.int64)
    queries = [corpus.query_text(int(i)) for i in qids]
    served = N_QUERIES + LATENCY_SAMPLES

    def encodes(rows: int, block: int) -> int:
        """Query or page encodes of `rows` rows in blocks of `block`."""
        bs = cfg.eval.embed_batch_size
        return sum(-(-min(block, rows - lo) // bs)
                   for lo in range(0, rows, block))
    # the embed's shards, search_many, the single queries, the eval's
    # queries and the mine's query blocks of 8,192
    n_encodes = (encodes(n, cfg.eval.store_shard_size) + 1 + LATENCY_SAMPLES
                 + encodes(IVF_EVAL_QUERIES, IVF_EVAL_QUERIES)
                 + encodes(IVF_MINE_QUERIES, 8_192))
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted --------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    emb.embed_corpus(corpus, q8)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    plain16 = build(fp16, plain_cfg)
    pq8 = build(q8, cfg)
    svc = SearchService(cfg, emb, corpus, q8)
    results = svc.search_many(queries, k=10)
    ivf_lat = single_query_latency(svc, queries)
    recall, n_eval = evaluate_recall(emb, corpus, q8, num_queries=
                                     IVF_EVAL_QUERIES, k=10, index=svc.index,
                                     nprobe=sv.nprobe)
    t0 = time.perf_counter()
    negs = mine_hard_negatives(emb, corpus, q8, num_negatives=7,
                               search_k=HARDNEG_SEARCH_K,
                               num_queries=IVF_MINE_QUERIES, index=pq8,
                               nprobe=IVF_MINE_NPROBE)
    mine_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    # ------------------------------------------------------------------
    want = expected_launches(n_encodes * m.num_layers, 0)
    if counts != want:
        raise AssertionError(f"phase 14's main path launched {counts}, want "
                             f"{want} ({n_encodes} encodes)")
    met = svc.metrics()
    if met["ann_fallbacks"] or met["ann_lists_scanned"] < served * sv.nprobe:
        raise AssertionError(f"service counters {met}")
    if not all(len(r) == 10 for r in results):
        raise AssertionError("search_many returned short result lists")
    table = np.asarray(negs.table)
    if table.shape != (IVF_MINE_QUERIES, 7) or table.min() < 0 or \
            table.max() >= n:
        raise AssertionError(f"IVF-mined table {table.shape} out of range")
    if (table == np.arange(IVF_MINE_QUERIES)[:, None]).any():
        raise AssertionError("the IVF-mined table holds a gold page")

    # ---- checks ------------------------------------------------------
    int8_check = check_int8_store(fp16, q8)
    # the other payload over each store, in copies (an index per store)
    pq16 = build(copy_store(fp16, os.path.join(workdir, "ivf_f16")), cfg)
    plain8 = build(copy_store(q8, os.path.join(workdir, "ivf_q8")),
                   plain_cfg)
    again = copy_store(q8, os.path.join(workdir, "ivf_q8_again"))
    rebuilt = build(again, cfg)
    mans = []
    for idx in (pq8, rebuilt):
        man = json.loads(json.dumps(idx.manifest))
        man.pop("build_seconds")
        man["pq"].pop("train_seconds")
        mans.append(man)
    files = (npy_bytes(index_dir(q8)), npy_bytes(index_dir(again)))
    if files[0] != files[1] or mans[0] != mans[1]:
        differ = [k for k in files[0] if files[0][k] != files[1].get(k)]
        raise AssertionError(f"two seeded builds on the card differ: {differ}"
                             f" (manifests equal: {mans[0] == mans[1]})")
    qv_check = svc.encode_queries(queries).cpu().numpy()[:IVF_CHECK_QUERIES]
    indexes = {"fp16_plain": (plain16, fp16), "fp16_pq": (pq16, pq16.store),
               "int8_plain": (plain8, plain8.store), "int8_pq": (pq8, q8)}
    full_probe = {name: check_full_probe(idx, st, qv_check, device)
                  for name, (idx, st) in indexes.items()}
    adc_survivors = {name: check_adc_survivors(idx, qv_check, device)
                     for name, (idx, _) in indexes.items()
                     if idx.pq is not None}
    card_cpu = {name: check_card_vs_cpu(st, qv_check, sv.nprobe)
                for name, (_, st) in indexes.items()}
    t0 = time.perf_counter()
    exact_negs = mine_hard_negatives(emb, corpus, q8, num_negatives=7,
                                     search_k=HARDNEG_SEARCH_K,
                                     num_queries=IVF_MINE_QUERIES)
    exact_mine_s = time.perf_counter() - t0
    agree = float((np.asarray(exact_negs.table) == table).all(axis=1).mean())

    # ---- printed, not gated ------------------------------------------
    qv_eval = emb.embed_texts([corpus.query_text(i)
                               for i in range(IVF_EVAL_QUERIES)])
    curves = {name: recall_curve(idx, st, qv_eval)
              for name, (idx, st) in indexes.items()}
    exact_svc = SearchService(get_config("bert_mini_v5p16", {
        **base, "eval.store_dtype": "int8"}), emb, corpus, q8)
    exact_lat = single_query_latency(exact_svc, queries)
    split = search_split(svc, queries)
    del exact_svc
    small = {"embed_s": embed_s, "embed_pages_per_s_from_text": n / embed_s,
             "int8_store": int8_check,
             "indexes": {name: index_record(idx)
                         for name, (idx, _) in indexes.items()},
             "seeded_builds_byte_identical": True,
             "npy_files_compared": len(files[0]),
             "full_probe_vs_exact": full_probe, "card_vs_cpu": card_cpu,
             "adc_survivors_vs_plain": adc_survivors,
             "service": {"metrics": met, "queries_served": served,
                         "ivf_latency": ivf_lat, "exact_latency": exact_lat,
                         "search_many_split": split},
             "recall_at_10_random_weights": recall,
             "recall_queries": n_eval,
             "mine": {"queries": IVF_MINE_QUERIES, "nprobe": IVF_MINE_NPROBE,
                      "seconds": mine_s, "stats": negs.stats,
                      "exact_seconds": exact_mine_s,
                      "rows_equal_to_exact_mine": agree},
             "recall_vs_exact": curves}
    del svc, negs, exact_negs

    # ---- (b): the index at a store size its users run ------------------
    reset_counts()
    big = VectorStore(os.path.join(workdir, "ivf_big"), dim=m.out_dim,
                      shard_size=cfg.eval.store_shard_size, dtype="int8")
    # phase 19 filters these rows: their words are written beside them
    # (and copied with them into ivf_big_pq)
    big.init_attrs()
    fill = big_store(emb, big, IVF_BIG_ROWS, device)
    fill_launches = launch_counts()
    want_fill = expected_launches(
        encodes(IVF_BIG_ROWS, cfg.eval.store_shard_size) * m.num_layers, 0)
    if fill_launches != want_fill:
        raise AssertionError(f"the 1M-row store's encodes launched "
                             f"{fill_launches}, want {want_fill}")
    qv_big = random_queries(emb, IVF_EVAL_QUERIES, device)
    big_plain = build(big, plain_cfg)
    big_pq = build(copy_store(big, os.path.join(workdir, "ivf_big_pq")), cfg)
    big_idx = {"int8_plain": (big_plain, big), "int8_pq": (big_pq,
                                                           big_pq.store)}
    big_rec = {"store": fill,
               "indexes": {k: index_record(i) for k, (i, _) in
                           big_idx.items()},
               # the plain payload only: a full re-rank of 1M ADC
               # survivors a query is host work of no user's
               "full_probe_vs_exact": {"int8_plain": check_full_probe(
                   big_plain, big, qv_big[:IVF_CHECK_QUERIES], device)},
               "recall_vs_exact": {k: recall_curve(i, st, qv_big)
                                   for k, (i, st) in big_idx.items()}}
    rec = {"phase": "ivf", "config": cfg.name, **widths(cfg),
           "pages": n, "store_shard_size": cfg.eval.store_shard_size,
           "nprobe": sv.nprobe, "pq_m": sv.pq_m, "seed": cfg.data.seed,
           "build": {k: getattr(sv, k) for k in (
               "nlist", "kmeans_iters", "kmeans_init", "kmeans_balance",
               "pq_iters", "pq_opq_iters")},
           "k1_launches": counts["launches"],
           "k1_launches_tensor_core": counts["launches_tc"],
           "k1_launches_big_store": fill_launches["launches"],
           "k1_launches_big_store_tensor_core": fill_launches["launches_tc"],
           "encodes_main_path": n_encodes, **small, "big": big_rec,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase,
           "device": torch.cuda.get_device_name(0), "nvidia_smi":
           nvidia_smi()}
    emit(rec)
    return rec


# -- phase 15: the production job from a jsonl corpus ------------------------

def copy_lines(path: str, dst: str, nbytes: int) -> None:
    """The first `nbytes` bytes of `path` (whole lines) into `dst`."""
    with open(path, "rb") as src, open(dst, "wb") as out:
        while nbytes > 0:
            chunk = src.read(min(nbytes, 1 << 24))
            out.write(chunk)
            nbytes -= len(chunk)


def shard_rows(store, rows: int) -> tuple:
    """(ids, vector bytes) of the first `rows` rows of `store`, as stored
    (float16 rows or int8 codes), for byte comparisons."""
    ids, vecs, n = [], [], 0
    for out in store.iter_shards(raw=True):
        ids.append(np.asarray(out[0]))
        vecs.append(np.asarray(out[1]))
        n += len(ids[-1])
        if n >= rows:
            break
    ids = np.concatenate(ids)[:rows]
    vecs = np.ascontiguousarray(np.concatenate(vecs)[:rows])
    return ids, vecs.view(np.uint8)


def run_cli(command: str, args: list, timeout: int) -> tuple:
    """`python -m dnn_page_vectors_tpu_torch.cli command args` from the
    root of the checkout; returns (its last stdout line as JSON, seconds).
    Raises with its stderr's tail if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dnn_page_vectors_tpu_torch.cli", command,
         *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {command} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), secs


def write_production_corpus(path: str, pages: int, seed: int,
                            page_words: int, query_words: int) -> dict:
    """data/synth.py's corpus of `pages` pages into `path` (host work of
    seconds; chip_smoke runs it in the tokenizer process); returns its
    seconds and bytes."""
    from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl
    t0 = time.perf_counter()
    write_synth_jsonl(path, pages, seed=seed, page_len=page_words,
                      query_len=query_words)
    return {"seconds": time.perf_counter() - t0,
            "bytes": os.path.getsize(path)}


def run_production(device, data, workdir: str, report: dict,
                   corpus_job=None) -> dict:
    """Phase 15: (a) write_synth_jsonl writes PROD_PAGES pages (the JAX
    package's 1M-page scale test's corpus; `corpus_job`, when given, is
    write_production_corpus's future writing it into workdir) and
    JsonlCorpus indexes them;
    (b) config 3's towers (phase 4's weights and vocab) embed every page
    into an fp16 store through embed_corpus with the worker pool and the
    fused native route, counted (K1 4 times an encode, on the tensor
    cores, nothing else); (c) the first PROD_SERIAL_ROWS pages again with
    one worker and with the pool, byte for byte the same rows, and the
    plain Python encoders' ids against the native ones; (d) Trainer.train
    takes PROD_TRAIN_STEPS steps of TRAIN_BATCH pairs from the file
    (counted: K1, K2, K3 8 times a step); (e) the CLI (train, embed,
    eval, embed again) at the scale test's cdssm_toy overrides in
    subprocesses on the card: 16 shards, Recall@10 over 512 queries >
    CLI_RECALL_BAR, the second embed a manifest no-op. The corpus file and
    the 1M store stay for phase 16 (run_phases deletes the file after
    it); rec["corpus_path"] names the file."""
    from dnn_page_vectors_tpu_torch import native
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
    from dnn_page_vectors_tpu_torch.data.loader import fused_encode
    from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
    from dnn_page_vectors_tpu_torch.data.trigram import TrigramTokenizer
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler

    t_phase = time.perf_counter()
    _, q_tok, p_tok = data
    path = os.path.join(workdir, "corpus_1m.jsonl")
    rec = {"phase": "production", "config": "bert_mini_v5p16",
           "pages": PROD_PAGES, "synth": {
               "seed": PROD_SEED, "page_words": PROD_PAGE_WORDS,
               "query_words": PROD_QUERY_WORDS}}
    t0 = time.perf_counter()
    written = (write_production_corpus(path, PROD_PAGES, PROD_SEED,
                                       PROD_PAGE_WORDS, PROD_QUERY_WORDS)
               if corpus_job is None else corpus_job.get())
    rec["synth"].update(written, wait_s=time.perf_counter() - t0,
                        pages_per_s=PROD_PAGES / written["seconds"])
    rec["corpus_path"] = path
    t0 = time.perf_counter()
    corpus = JsonlCorpus(path)
    rec["index_s"] = time.perf_counter() - t0
    if corpus.num_pages != PROD_PAGES:
        raise AssertionError(f"the corpus indexes {corpus.num_pages} "
                             f"records, want {PROD_PAGES}")
    # ---- (b) the bulk embed, counted ---------------------------------
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
        "eval.store_shard_size": PROD_SHARD,
        "eval.embed_batch_size": 512, "model.attention": "flash"})
    m = cfg.model
    rec.update(widths(cfg))
    routes = {"page_tokenizer": p_tok.path, "query_tokenizer": q_tok.path,
              "corpus_index": ("native" if corpus.native_index
                               else "python"),
              "embed_encode": ("fused" if fused_encode(corpus, p_tok)
                               else "plain"),
              "native_library": str(native.build().name)}
    rec["routes"] = routes
    emit({"phase": "production_routes", **routes})
    if (routes["page_tokenizer"], routes["query_tokenizer"],
            routes["corpus_index"], routes["embed_encode"]) != (
            "native", "native", "native", "fused"):
        raise AssertionError(f"a host path took the plain route: "
                             f"{routes}")
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size,
                            device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    emb.embed_pages(np.zeros((8, p_tok.max_tokens), np.int32))   # warm
    store = VectorStore(os.path.join(workdir, "store_production"),
                        dim=m.out_dim, shard_size=PROD_SHARD)
    prof = PipelineProfiler()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    emb.embed_corpus(corpus, store, profiler=prof)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    counts = launch_counts()
    # ------------------------------------------------------------------
    bs, ss = cfg.eval.embed_batch_size, cfg.eval.store_shard_size
    n_batches = sum(-(-min(ss, PROD_PAGES - lo) // bs)
                    for lo in range(0, PROD_PAGES, ss))
    want = expected_launches(n_batches * m.num_layers, 0)
    if counts != want:
        raise AssertionError(f"phase 15's embed launched {counts}, want "
                             f"{want} ({n_batches} encodes)")
    if (store.num_vectors, len(store.shards())) != (
            PROD_PAGES, -(-PROD_PAGES // PROD_SHARD)):
        raise AssertionError(f"the store holds {store.num_vectors} "
                             f"vectors in {len(store.shards())} shards")
    shards = list(store.iter_shards())
    for out in (shards[0], shards[-1]):
        v = np.asarray(out[1], np.float32)
        if not (np.isfinite(v).all()
                and np.abs(np.linalg.norm(v, axis=1) - 1).max() < 2e-3):
            raise AssertionError("store rows are not finite unit rows")
    rec["embed"] = {
        "pages_per_s_from_text": PROD_PAGES / embed_s, "seconds": embed_s,
        "workers": cfg.data.tokenize_workers, "batches": n_batches,
        "stats": emb.stats, "stage_s": prof.stages(),
        "stage_calls": prof.counts(),
        "k1_launches": counts["launches"],
        "k1_launches_tensor_core": counts["launches_tc"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"phase": "production_embed", **rec["embed"]})
    del store, shards

    # ---- (c) one worker against the pool, the plain encoders -----------
    head = os.path.join(workdir, "corpus_head.jsonl")
    copy_lines(path, head, int(corpus.offsets[PROD_SERIAL_ROWS]))
    head_corpus = JsonlCorpus(head)
    serial = {}
    for workers in (1, cfg.data.tokenize_workers):
        s = VectorStore(os.path.join(workdir, f"store_head_{workers}"),
                        dim=m.out_dim, shard_size=PROD_SHARD)
        t0 = time.perf_counter()
        emb.embed_corpus(head_corpus, s, workers=workers)
        torch.cuda.synchronize()
        serial[workers] = (s, time.perf_counter() - t0)
    full = VectorStore(os.path.join(workdir, "store_production"))
    want_ids, want_bytes = shard_rows(full, PROD_SERIAL_ROWS)
    equal = {}
    for workers, (s, _) in serial.items():
        ids, vb = shard_rows(s, PROD_SERIAL_ROWS)
        equal[workers] = bool(len(ids) == PROD_SERIAL_ROWS
                              and np.array_equal(ids, want_ids)
                              and np.array_equal(vb, want_bytes))
    ids = range(PROD_PLAIN_PAGES)
    plain_p = SubwordTokenizer(p_tok.vocab, style=p_tok.style,
                               max_tokens=p_tok.max_tokens,
                               use_native=False)
    plain_q = SubwordTokenizer(q_tok.vocab, style=q_tok.style,
                               max_tokens=q_tok.max_tokens,
                               use_native=False)
    t0 = time.perf_counter()
    want_p = plain_p.encode_batch(corpus.page_texts(ids))
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_p = p_tok.encode_jsonl_lines(corpus.page_lines(ids))
    fused_s = time.perf_counter() - t0
    queries = corpus.query_texts(ids)
    tri = dict(buckets=16_384, max_words=PROD_PAGE_WORDS, k=8)
    tri_texts = corpus.page_texts(range(PROD_TRIGRAM_PLAIN_PAGES))
    ids_equal = {
        "wordpiece_pages_fused": bool(np.array_equal(got_p, want_p)),
        "wordpiece_pages_batch": bool(np.array_equal(
            p_tok.encode_batch(corpus.page_texts(ids)), want_p)),
        "wordpiece_queries": bool(np.array_equal(
            q_tok.encode_batch(queries), plain_q.encode_batch(queries))),
        "trigram_pages": bool(np.array_equal(
            TrigramTokenizer(**tri).encode_batch(tri_texts),
            TrigramTokenizer(**tri, use_native=False).encode_batch(
                tri_texts)))}
    rec["serial_check"] = {
        "rows": PROD_SERIAL_ROWS,
        "rows_equal_to_the_1m_store": {str(k): v
                                       for k, v in equal.items()},
        "pages_per_s_one_worker":
            PROD_SERIAL_ROWS / serial[1][1],
        "pages_per_s_pool": (PROD_SERIAL_ROWS
                             / serial[cfg.data.tokenize_workers][1]),
        "plain_ids_equal": ids_equal,
        "plain_pages": PROD_PLAIN_PAGES,
        "trigram_plain_pages": PROD_TRIGRAM_PLAIN_PAGES,
        "wordpiece_plain_pages_per_s": PROD_PLAIN_PAGES / plain_s,
        "wordpiece_fused_pages_per_s": PROD_PLAIN_PAGES / fused_s}
    emit({"phase": "production_serial_check", **rec["serial_check"]})
    if not all(equal.values()) or not all(ids_equal.values()):
        raise AssertionError(f"the pool's rows or the native ids differ: "
                             f"{rec['serial_check']}")
    del serial, full
    os.remove(head)

    # ---- (d) training from the file, counted ---------------------------
    tcfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
        "model.attention": "flash", "train.log_every": 1,
        "train.batch_size": TRAIN_BATCH})
    trainer = Trainer(tcfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                      device=device)
    starts = []
    step = trainer.train_step

    def timed_step(batch):
        starts.append(time.perf_counter())
        return step(batch)
    trainer.train_step = timed_step
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(PROD_TRAIN_STEPS)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = launch_counts()
    # ------------------------------------------------------------------
    per_layer = 2 * tcfg.model.num_layers
    want = expected_launches(PROD_TRAIN_STEPS * per_layer,
                             PROD_TRAIN_STEPS * per_layer)
    if counts != want:
        raise AssertionError(f"phase 15's training launched {counts}, "
                             f"want {want}")
    hist = trainer.history
    if len(hist) != PROD_TRAIN_STEPS or not all(
            np.isfinite([h["loss"], h["grad_norm"]]).all()
            for h in hist):
        raise AssertionError(f"training metrics are not finite: {hist}")
    step_ms = list(np.diff(starts + [t_end]) * 1e3)
    names = ("k1", "k2", "k3", "k4")
    keys = ("launches", "dq_launches", "dkv_launches",
            "dq_dbias_launches")
    rec["train"] = {
        "batch_pages": TRAIN_BATCH, "steps": PROD_TRAIN_STEPS,
        "workers": tcfg.data.tokenize_workers,
        "train_s": t_end - t0,
        "step_ms_from_text": step_ms,
        "median_step_ms_from_text": float(np.median(step_ms[2:])),
        "phase5_median_step_ms_premade":
            report["train"]["median_step_ms"],
        "train_pages_per_s_from_text": TRAIN_BATCH / (
            float(np.median(step_ms[2:])) / 1e3),
        "host_stage_s": trainer.profiler.stages(),
        "losses": [h["loss"] for h in hist],
        "launches_main_path": {n: counts[k] for n, k in zip(names, keys)},
        "launches_tensor_core_main_path": {
            n: counts[k + "_tc"] for n, k in zip(names, keys)},
        "launches_seg_main_path": {
            n: counts[k + "_seg"] for n, k in zip(names, keys)},
        "launches_one_step": {n: counts[k] // PROD_TRAIN_STEPS
                              for n, k in zip(names, keys)},
        "seg_summary_launches_main_path": 0,
        "gdead_launches_main_path": 0}
    emit({"phase": "production_train", **rec["train"]})
    del trainer, model, emb
    torch.cuda.empty_cache()

    # ---- (e) the CLI on the card ---------------------------------------
    wd = os.path.join(workdir, "cli_1m")
    args = ["--config", "cdssm_toy", "--workdir", wd, "--device",
            CLI_DEVICE, "--set", f"data.corpus=jsonl:{path}"]
    for k, v in CLI_OVERRIDES.items():
        args += ["--set", f"{k}={v}"]
    cli = {}
    cli["train"], cli["train_s"] = run_cli("train", args, 600)
    cli["embed"], cli["embed_s"] = run_cli("embed", args, 600)
    cli["eval"], cli["eval_s"] = run_cli("eval", args, 300)
    cli_store = VectorStore(os.path.join(wd, "store"))
    files = sorted(f for f in os.listdir(cli_store.directory)
                   if f.endswith(".npy"))
    mtimes = [os.stat(os.path.join(cli_store.directory, f)).st_mtime_ns
              for f in files]
    cli["embed_again"], cli["embed_again_s"] = run_cli("embed", args, 300)
    noop = (mtimes == [os.stat(os.path.join(cli_store.directory,
                                            f)).st_mtime_ns
                       for f in files]
            and "stage_tokenize_n" not in cli["embed_again"]["stages"])
    recall = cli["eval"]["recall@10"]
    rec["cli"] = {**cli, "overrides": CLI_OVERRIDES,
                  "store_vectors": cli_store.num_vectors,
                  "store_shards": len(cli_store.shards()),
                  "second_embed_noop": noop,
                  "recall_bar": CLI_RECALL_BAR}
    emit({"phase": "production_cli", **rec["cli"]})
    shards = -(-PROD_PAGES // CLI_OVERRIDES["eval.store_shard_size"])
    if (cli_store.num_vectors, len(cli_store.shards())) != (
            PROD_PAGES, shards) or cli["embed"]["embedded"] != PROD_PAGES:
        raise AssertionError(f"the CLI's store: {rec['cli']}")
    if not (cli["eval"]["num_queries"] == CLI_OVERRIDES[
            "eval.eval_queries"] and recall > CLI_RECALL_BAR and noop):
        raise AssertionError(f"the CLI run failed its checks: "
                             f"{rec['cli']}")
    rec["seconds"] = time.perf_counter() - t_phase
    rec["device"] = torch.cuda.get_device_name(0)
    rec["nvidia_smi"] = nvidia_smi()
    emit({k: v for k, v in rec.items()
          if k not in ("embed", "serial_check", "train", "cli")})
    return rec


# -- phase 16: serving under load ---------------------------------------------

def serve_results_equal(got, want, what: str,
                        tol: float = SERVE_SCORE_TOL) -> int:
    """Two lists of formatted results of the same queries: scores (rounded
    to 4 decimals) within `tol`, ids equal in every rank except where the
    scores of neighbouring ranks tie within `tol`. Returns the rows whose
    ids differ (at ties)."""
    touched = 0
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} result lists, want "
                             f"{len(want)}")
    for g, w in zip(got, want):
        gs = np.array([r["score"] for r in g])
        ws = np.array([r["score"] for r in w])
        if len(g) != len(w) or (len(g) and np.abs(gs - ws).max() > tol):
            raise AssertionError(f"{what}: scores differ: {gs} vs {ws}")
        row = False
        for j, (a, b) in enumerate(zip(w, g)):
            if a["page_id"] != b["page_id"]:
                if not any(abs(ws[j] - ws[x]) <= tol
                           for x in (j - 1, j + 1) if 0 <= x < len(ws)):
                    raise AssertionError(f"{what}: rank {j} differs at a "
                                         f"non-tie: {a} vs {b}")
                row = True
        touched += row
    return touched


def gpu_state() -> str:
    """The card's SM and memory clocks, power draw, temperature and
    performance state, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,pstate", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()


def busy_share(fn) -> tuple:
    """(fn()'s result, the share of its wall time the card was busy): the
    union of the intervals of every kernel and copy torch.profiler (CUPTI)
    records during fn, over fn's wall time; None when the profiler
    recorded no device time. The raw events are read: key_averages()
    would build an object for each of the trial's tens of thousands."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.duration_ns() > 0)
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a >= end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    return out, (busy_ns / 1e9 / wall if busy_ns > 0 else None)


@contextlib.contextmanager
def gc_seconds(out: dict):
    """While open, out["gc_s"] sums the seconds of the interpreter's cyclic
    garbage collections (any thread's: a collection stops them all) and
    out["gc_full"] counts the full (generation 2) ones."""
    import gc
    out.update(gc_s=0.0, gc_full=0)
    t0 = [0.0]

    def cb(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            out["gc_s"] += time.perf_counter() - t0[0]
            out["gc_full"] += info["generation"] == 2
    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def stage_ms(svc, before: dict, queries: int) -> dict:
    """The service's stage seconds (PipelineProfiler) since `before`, as
    milliseconds a query."""
    return {k: (v - before.get(k, 0.0)) * 1e3 / queries
            for k, v in svc.profiler.stages().items()}


def trial_line(tr: dict, busy=None) -> dict:
    """The printed numbers of one load trial."""
    keys = ("offered_qps", "achieved_qps", "client_p50_ms", "client_p95_ms",
            "client_p99_ms", "issue_lag_max_ms", "p50_ms", "p95_ms", "p99_ms",
            "error_rate", "cache_hit_rate", "queue_wait_p99_ms",
            "requests_sent", "errors", "met")
    out = {k: tr.get(k) for k in keys}
    out["deadline_shed"] = (tr.get("transport") or {}).get(
        "deadline_sheds", 0)
    if busy is not None:
        out["card_busy_share"] = busy
    return out


def run_serving(device, data, workdir: str, production: dict) -> dict:
    """Phase 16: SearchService over phase 15's 1M-row store
    (store_production) and its jsonl corpus, with config 3's towers
    rebuilt from phase 4's seed and vocab (the weights that embedded the
    store). (a) SERVE_QUERIES corpus queries through search_many, their
    top-10 against a plain q @ store^T top-10 of the staged rows (ties
    only), then through search() from SERVE_THREADS threads with the
    micro-batcher on: equal, and some batch larger than 1; (b) the same
    service at preload_hbm_gb=0 serves (a)'s results from disk; (c) a
    SearchServer on loopback and a SocketSearchClient return in-process
    search's ids and scores, and a request whose deadline has passed gets
    T_SHED, counts in deadline_shed, takes no bucket slot; (d)
    find_qps_at_p99 over the socket, judged on the client's p99, with the
    query cache on and off, a profiled warm-up trial at SERVE_START_QPS
    and SERVE_RUNS searches each, alternating (a search in which no trial
    met the target reads 0 with target_met false), a burst trial at the
    lowest cache-off rate found and a closed-loop trial, both profiled;
    (e) K1 launched 4 times an encode the
    services dispatched, all on the tensor cores, nothing else; (f) the
    phase's seconds; (g) no batch retry, everything on the card."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.server import SearchServer
    from dnn_page_vectors_tpu_torch.infer.transport import (
        DeadlineExceeded, SocketSearchClient)
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.loadgen import (
        find_qps_at_p99, make_workload, run_trial)
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

    import gc
    t_phase = time.perf_counter()
    # the earlier phases' objects (vocabs, corpora, records) out of the
    # cyclic collector's reach: a full collection walks every object the
    # process holds, and its pause would land in a trial's tail as the
    # harness's cost, not the service's (gc_seconds records what is left)
    gc.collect()
    gc.freeze()
    _, q_tok, p_tok = data
    path = production["corpus_path"]
    corpus = JsonlCorpus(path)
    store = VectorStore(os.path.join(workdir, "store_production"))
    if store.num_vectors != PROD_PAGES:
        raise AssertionError(f"phase 15's store holds {store.num_vectors} "
                             f"vectors, want {PROD_PAGES}")

    def config(cache: int):
        return get_config("bert_mini_v5p16", {
            "data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
            "model.attention": "flash", "serve.query_cache_size": cache,
            "obs.window_s": SERVE_TRIAL_S})
    cfg = config(SERVE_CACHE)
    m = cfg.model
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    queries = corpus.query_texts(np.linspace(
        0, PROD_PAGES - 1, SERVE_QUERIES).astype(np.int64))
    rec = {"phase": "serving", "config": cfg.name, **widths(cfg),
           "store_vectors": store.num_vectors, "store_dtype": "float16",
           "queries": SERVE_QUERIES}
    services = []

    def service(cache: int, preload: float = 4.0):
        svc = SearchService(config(cache), emb, corpus, store,
                            preload_hbm_gb=preload)
        services.append(svc)
        return svc

    torch.cuda.synchronize()
    reset_counts()
    # ---- the main path, counted (a)-(d) ------------------------------
    t0 = time.perf_counter()
    svc = service(SERVE_CACHE)
    stage_s = time.perf_counter() - t0
    if not (svc.preloaded and svc.pages.device.type == device.type
            and svc.pages.dtype == torch.float16
            and svc.pages.shape == (PROD_PAGES, m.out_dim)):
        raise AssertionError("the 1M store is not staged whole on the card")
    # (a) staged exact, batched
    t0 = time.perf_counter()
    results = svc.search_many(queries, k=10)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3
    qv = svc._embed_queries_cached(svc._view, queries)   # the cache's rows
    raw_s, raw_i = svc.topk_vectors(qv, k=10)
    fmt = [svc._format(raw_s[i], raw_i[i]) for i in range(SERVE_QUERIES)]
    if fmt != results:
        raise AssertionError("search_many differs from its own top-k")
    plain_s, plain_i = torch.topk(qv @ svc.pages.float().T, 10, dim=1)
    plain_pid = svc.page_ids[plain_i.cpu().numpy()]
    ties_a = ties_only(raw_s, raw_i, plain_s.cpu().numpy(), plain_pid,
                       "phase 16 (a) search_many vs the plain top-k")
    svc.clear_cache()
    serve_window_ms = cfg.serve.batch_window_ms
    svc.start_batcher()
    batched = [None] * SERVE_QUERIES
    with ThreadPoolExecutor(SERVE_THREADS) as pool:
        for i, res in zip(range(SERVE_QUERIES), pool.map(
                lambda q: svc.search(q, k=10), queries)):
            batched[i] = res
    sizes = svc.batch_sizes
    ties_batched = serve_results_equal(batched, results,
                                       "phase 16 (a) batched search()")
    if max(sizes) <= 1:
        raise AssertionError(f"the batcher coalesced nothing: {sizes}")
    rec["a_staged"] = {
        "search_many_ms": many_ms, "stage_1m_store_s": stage_s,
        "tie_rows_vs_plain": ties_a, "threads": SERVE_THREADS,
        "batch_window_ms": serve_window_ms, "batches": len(sizes),
        "max_batch": max(sizes), "mean_batch": float(np.mean(sizes)),
        "batched_tie_rows": ties_batched,
        "at_s": time.perf_counter() - t_phase}
    emit({"phase": "serving_a_staged", **rec["a_staged"]})
    # (b) streaming
    stream = service(SERVE_CACHE, preload=0.0)
    t0 = time.perf_counter()
    streamed = stream.search_many(queries, k=10)
    stream_ms = (time.perf_counter() - t0) * 1e3
    if stream.preloaded:
        raise AssertionError("preload_hbm_gb=0 staged the store")
    rec["b_streaming"] = {
        "preloaded": stream.preloaded, "search_many_ms": stream_ms,
        "tie_rows_vs_staged": serve_results_equal(
            streamed, results, "phase 16 (b) streaming vs staged"),
        "at_s": time.perf_counter() - t_phase}
    emit({"phase": "serving_b_streaming", **rec["b_streaming"]})
    del stream
    # (c) the socket
    off = service(0)
    off.start_batcher()
    servers = [SearchServer(x, executor_workers=SERVE_LOAD_WORKERS)
               for x in (svc, off)]
    clients = []
    try:
        for server in servers:
            server.start_background()
            clients.append(SocketSearchClient(server.host, server.port))
        client, client_off = clients
        wire, local = [], []
        for q in queries[:16]:
            wire.append(client.search(q, k=10))
            local.append(svc.search(q, k=10))
        same = all([(r["page_id"], round(r["score"], 4)) for r in a] ==
                   [(r["page_id"], r["score"]) for r in b]
                   for a, b in zip(wire, local))
        if not same:
            raise AssertionError("the socket's results differ from "
                                 "in-process search")
        sheds, n_batches, encodes = (svc.deadline_sheds,
                                     len(svc.batch_sizes), svc.encodes)
        try:
            client.search(queries[0] + " late", k=10, deadline_ms=1e-6)
            raise AssertionError("an expired deadline was served")
        except DeadlineExceeded as e:
            shed_reason = str(e)
        if (svc.deadline_sheds != sheds + 1
                or len(svc.batch_sizes) != n_batches
                or svc.encodes != encodes):
            raise AssertionError("the expired request was not shed at the "
                                 "door")
        rec["c_socket"] = {"queries": 16, "equal_to_inprocess": same,
                           "expired_shed": shed_reason,
                           "deadline_shed": svc.deadline_sheds,
                           "at_s": time.perf_counter() - t_phase}
        emit({"phase": "serving_c_socket", **rec["c_socket"]})

        # (d) load, over the socket
        distinct = corpus.query_texts(range(SERVE_DISTINCT))
        # a lone query at a time, cache off: what one caller waits with no
        # load, over the socket and in process, with the service's stage
        # split (ms a query)
        n = SERVE_LONE_QUERIES
        load = {"lone_query": {"queries": n}}
        for how, call, qs in (("socket", client_off.search, distinct[-n:]),
                              ("inprocess", off.search,
                               distinct[-2 * n: -n])):
            lone, before = [], off.profiler.stages()
            for q in qs:
                t0 = time.perf_counter()
                call(q, k=10)
                lone.append((time.perf_counter() - t0) * 1e3)
            load["lone_query"][how] = {
                "p50_ms": float(np.percentile(lone, 50)),
                "p95_ms": float(np.percentile(lone, 95)),
                "stage_ms": stage_ms(off, before, n)}
        load["lone_query"]["at_s"] = time.perf_counter() - t_phase
        emit({"phase": "serving_d_lone_query", **load["lone_query"]})

        def workload(shape: str = "poisson", **kw):
            return make_workload(shape, seed=SERVE_SEED,
                                 distinct=SERVE_DISTINCT, alpha=SERVE_ALPHA,
                                 profile=((10, None, 1.0),), **kw)

        def rate_search(target, clt, cache: int, run: int) -> dict:
            target.clear_cache()     # every run starts from a cold cache
            batches0 = len(target.batch_sizes)
            stages0 = target.profiler.stages()
            requests0 = target._m_requests.value
            collected = {}
            t0 = time.perf_counter()
            with gc_seconds(collected):
                rep = find_qps_at_p99(
                    target, workload(), distinct,
                    p99_target_ms=SERVE_P99_MS, start=SERVE_START_QPS,
                    max_load=SERVE_MAX_QPS, iters=SERVE_ITERS,
                    duration_s=SERVE_TRIAL_S, warmup_s=SERVE_WARMUP_S,
                    workers=SERVE_LOAD_WORKERS,
                    max_error_rate=SERVE_MAX_ERROR_RATE, client=clt,
                    p99_key="client_p99_ms")
            trials = [trial_line(t) for t in rep["trials"]]
            if len(trials) > SERVE_MAX_TRIALS:
                raise AssertionError(f"the rate search took {len(trials)} "
                                     "trials")
            # a search in which no trial met the target reads 0 and says
            # so; nothing stands in for the rate it did not find
            best = max((t for t in rep["trials"] if t["met"]),
                       key=lambda t: t["achieved_qps"], default=None)
            out = {"query_cache_size": cache, "run": run,
                   "qps_at_p99": rep["qps_at_p99"],
                   "target_met": best is not None,
                   "load_sustained": rep["load_sustained"],
                   "trials": trials,
                   "at_rate": trial_line(best) if best else None,
                   "mean_batch": float(np.mean(
                       target.batch_sizes[batches0:])),
                   "seconds": time.perf_counter() - t0,
                   "search_gc_s": collected["gc_s"],
                   "search_gc_full": collected["gc_full"],
                   "stage_ms_a_request": stage_ms(
                       target, stages0,
                       max(1, target._m_requests.value - requests0)),
                   "host_loadavg_1m": os.getloadavg()[0],
                   "gpu_state_after": gpu_state(),
                   "at_s": time.perf_counter() - t_phase}
            emit({"phase": f"serving_d_cache_{'on' if cache else 'off'}"
                           f"_run{run}", **out})
            return out

        cells = (("on", svc, client, SERVE_CACHE), ("off", off, client_off, 0))
        # a short trial at SERVE_START_QPS on each service first,
        # profiled: it warms the process under load (the first load trial
        # of a process can stall its queue on the card, PERF.md section
        # 6) and gives the card's busy share there; not part of a search
        warm = {}
        for name, target, clt, cache in cells:
            tr, busy = busy_share(lambda: run_trial(
                target, workload(), SERVE_START_QPS, distinct,
                duration_s=SERVE_WARM_S, warmup_s=SERVE_WARMUP_S,
                workers=SERVE_LOAD_WORKERS, client=clt))
            warm[name] = {**trial_line(tr, busy),
                          "gpu_state_after": gpu_state(),
                          "at_s": time.perf_counter() - t_phase}
            emit({"phase": f"serving_d_warm_cache_{name}", **warm[name]})
        # the searches alternate (on, off, on, off, ...) so that a drift
        # of the host over the phase falls on both alike
        runs = {name: [] for name, *_ in cells}
        for run in range(SERVE_RUNS):
            for name, target, clt, cache in cells:
                runs[name].append(rate_search(target, clt, cache, run))
        for name, target, clt, cache in cells:
            rates = [r["qps_at_p99"] for r in runs[name]]
            load[name] = {
                "query_cache_size": cache, "qps_at_p99": min(rates),
                "qps_at_p99_runs": rates,
                "runs_without_a_met_trial": sum(
                    not r["target_met"] for r in runs[name]),
                "spread_qps": max(rates) - min(rates),
                "p99_target_ms": SERVE_P99_MS,
                "p99_judged_on": "client_p99_ms",
                "at_rate_runs": [r["at_rate"] for r in runs[name]],
                "mean_batch_runs": [r["mean_batch"] for r in runs[name]],
                "warm_trial": warm[name],
                "card_busy_share_at_start_qps": warm[name].get(
                    "card_busy_share")}
            emit({"phase": f"serving_d_cache_{name}", **load[name]})
            load[name]["runs"] = runs[name]
        # the burst's mean rate: the lowest rate a cache-off run found
        found = [r for r in load["off"]["qps_at_p99_runs"] if r > 0]
        for shape, offered, kw in (
                ("burst", min(found, default=None),
                 {"on_s": 0.5, "off_s": 0.5}),
                ("closed", SERVE_CLOSED_WORKERS, {})):
            if offered is None:
                load[shape] = {"skipped": "no cache-off run met the "
                               f"{SERVE_P99_MS} ms client p99"}
                emit({"phase": f"serving_d_{shape}", **load[shape]})
                continue
            wl = workload(shape, **kw)
            tr, busy = busy_share(lambda: run_trial(
                off, wl, offered, distinct, duration_s=SERVE_TRIAL_S,
                warmup_s=SERVE_WARMUP_S, workers=SERVE_LOAD_WORKERS,
                client=client_off))
            load[shape] = {"offered": offered, **kw,
                           **trial_line(tr, busy),
                           "at_s": time.perf_counter() - t_phase}
            emit({"phase": f"serving_d_{shape}", **load[shape]})
    finally:
        for c in clients:
            c.close()
        for server in servers:
            server.close()
        svc.close()
        off.close()
    torch.cuda.synchronize()
    counts = launch_counts()
    # ------------------------------------------------------------------
    encodes = sum(s.encodes for s in services)
    retries = sum(s.batch_retries for s in services)
    want = expected_launches(encodes * m.num_layers, 0)
    if counts != want:
        raise AssertionError(f"phase 16 launched {counts}, want {want} "
                             f"({encodes} query encodes)")
    if retries:
        raise AssertionError(f"the batcher retried {retries} requests")
    del services, svc, off
    torch.cuda.empty_cache()
    gc.unfreeze()
    seconds = time.perf_counter() - t_phase
    rec.update({
        "d_load": load, "encodes": encodes,
        "k1_launches": counts["launches"],
        "k1_launches_tensor_core": counts["launches_tc"],
        "k1_launches_per_encode": counts["launches"] / max(encodes, 1),
        "batch_retries": retries, "seconds": seconds,
        "budget_s": SERVE_BUDGET_S,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()})
    emit({k: v for k, v in rec.items() if k != "d_load"})
    if seconds > SERVE_BUDGET_S:
        raise AssertionError(f"phase 16 took {seconds:.1f} s, over its "
                             f"{SERVE_BUDGET_S} s budget")
    return rec


# -- phase 17: live corpus updates under load -------------------------------

class OneShotMutator:
    """A loadgen Mutator's shape (calls, ops, calls_by_op, errors,
    maybe_fire) that fires its one op once, at `at_s` of trial time, on a
    thread of its own, so the load generator never waits for it. As the
    Mutator does, it stores an op's exception in `errors` and raises
    nothing into the trial; `join()` waits for the op, and the caller
    reads `errors`."""

    def __init__(self, name: str, op, at_s: float):
        self.ops = [(name, op)]
        self.at_s = at_s
        self.calls = 0
        self.calls_by_op = {name: 0}
        self.errors: list = []
        self.result = None
        self.done_at_s = None
        self._thread = None

    def maybe_fire(self, elapsed_s: float, base: int = 0) -> bool:
        if self.calls or elapsed_s < self.at_s:
            return False
        name, op = self.ops[0]
        self.calls += 1
        self.calls_by_op[name] += 1
        t0 = time.perf_counter() - elapsed_s

        def run():
            try:
                self.result = op()
            except Exception as e:  # noqa: BLE001 -- read from errors
                self.errors.append(f"{name}: {type(e).__name__}: {e}"[:300])
            self.done_at_s = time.perf_counter() - t0
        self._thread = threading.Thread(target=run, name=f"mutator-{name}")
        self._thread.start()
        return True

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()


def count_encodes(emb) -> dict:
    """Wraps the embedder's page and query encodes (instance attributes)
    to count their calls: K1 launches num_layers times a call (a query
    encode with another tower, `model=`, too)."""
    counts = {"page": 0, "query": 0}
    lock = threading.Lock()
    for kind, name in (("page", "encode_pages"), ("query", "encode_queries")):
        fn = getattr(emb, name)

        def wrapped(ids, _fn=fn, _kind=kind, **kw):
            with lock:
                counts[_kind] += 1
            return _fn(ids, **kw)
        setattr(emb, name, wrapped)
    return counts


def live_topk(device, store, qv: torch.Tensor, k: int) -> tuple:
    """A plain top-k of qv over the store's live rows: every shard read
    from disk with its tombstones (load_all), dead rows dropped, one
    float32 q @ rows^T on the card, torch.topk. (scores, page ids)."""
    ids, vecs = store.load_all()
    live = ids >= 0
    rows = torch.from_numpy(np.ascontiguousarray(vecs[live])).to(device)
    s, i = torch.topk(qv.float() @ rows.float().T, k, dim=1)
    return s.cpu().numpy(), ids[live][i.cpu().numpy()]


def cli_fleet_args(workdir: str, overrides: dict) -> list:
    """The common arguments of phase 17's CLI commands."""
    out = ["--config", "cdssm_toy", "--workdir",
           os.path.join(workdir, "cli_updates"), "--device", CLI_DEVICE]
    for k, v in overrides.items():
        out += ["--set", f"{k}={v}"]
    return out


def run_cli_fleet(workdir: str) -> dict:
    """The manual fleet through the CLI in subprocesses on the card (the
    README's recipe, random weights): init-store, the embed slices
    all at once, merge-store. Returns each command's JSON and seconds."""
    ss = UPD_CLI_OVERRIDES["eval.store_shard_size"]
    n = UPD_CLI_OVERRIDES["data.num_pages"]
    args = cli_fleet_args(workdir, UPD_CLI_OVERRIDES)
    out = {"init-store": run_cli("init-store", args, 300)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dnn_page_vectors_tpu_torch.cli", "embed",
         *args, "--start", str(lo), "--stop", str(min(lo + ss, n))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for lo in range(0, n, ss)]
    slices = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"cli embed slice exited {p.returncode}: "
                                 f"{se[-3000:]}")
        slices.append(json.loads(so.strip().splitlines()[-1]))
    out["embed_slices"] = (slices, time.perf_counter() - t0)
    out["merge-store"] = run_cli("merge-store", args, 300)
    return out


def run_cli_updates(workdir: str) -> dict:
    """The fleet's store updated through the CLI: append (a grown corpus,
    2 pages deleted, 1 updated) and refresh (the IVF index, built in full:
    there is none)."""
    args = cli_fleet_args(workdir, {**UPD_CLI_OVERRIDES,
                                    "data.num_pages": UPD_CLI_GROWN})
    return {"append": run_cli("append", [*args, "--tombstone", "3,4",
                                         "--update-ids", "9"], 600),
            "refresh": run_cli("refresh", args, 600)}


class Background:
    """A call on a thread of its own; `result()` joins it and returns
    its value or raises its exception."""

    def __init__(self, fn, *args):
        self._out, self._err = None, None

        def run():
            try:
                self._out = fn(*args)
            except BaseException as e:  # noqa: BLE001 -- raised in result
                self._err = e
        self._thread = threading.Thread(target=run, name=fn.__name__)
        self._thread.start()

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def run_updates(device, data, workdir: str, production: dict) -> dict:
    """Phase 17: live corpus updates on config 3's 1M-page store.

    (a) embed_corpus(stop=UPD_BASE_PAGES) of phase 15's corpus into a
    fresh fp16 store (phase 4's weights and vocab), staged whole in a
    SearchService (query and result caches on) behind a SearchServer;
    (b) a warm-up trial, a UPD_TRIAL_S trial of Poisson load at UPD_QPS
    over the socket with no mutation, then one per append of UPD_APPENDS, each holding an
    append_corpus and a refresh() on the mutator's thread; per refresh
    its swap_ms, refresh_seconds, the host-to-device bytes and the
    trial's client p99 beside the unmutated one's; (c) the two full
    appended generations' rows byte for byte phase 15's rows of the same
    ids; after the last refresh, search_many of UPD_CHECK_QUERIES corpus
    queries against a plain top-10 over the live rows read from disk and
    against a service opened fresh on the store (ties only); no result
    holds a tombstoned id or an updated page's old row; appended pages
    are found by their own stored vectors; no mutator error, no failed
    request, no index_error; no result of an older generation comes from
    the result cache; (d) IVFIndex.update on the card over phase 14's
    int8 rows under a PQ index of its knobs after an append: only the new
    shard assigned, full probe with every candidate re-ranked = exact; a
    second append past UPD_IVF_DRIFT rebuilds in full; (e) compaction_due
    at UPD_COMPACT_DENSITY, then compact_store over (b)'s chain: the same
    top-10 before and after and the live row count; (f) the CLI's store
    commands in subprocesses on the card (init-store, the embed slices and
    merge-store beside (a), append and refresh beside (c)-(e)); (g) K1
    launched num_layers times a page or query encode, all on the tensor
    cores, nothing else."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex, index_dir
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.server import SearchServer
    from dnn_page_vectors_tpu_torch.infer.transport import SocketSearchClient
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.loadgen import make_workload, run_trial
    from dnn_page_vectors_tpu_torch.maintenance import (
        compact_store, compaction_due)
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.updates import append_corpus
    import gc

    t_phase = time.perf_counter()
    gc.collect()
    gc.freeze()
    _, q_tok, p_tok = data
    path = production["corpus_path"]
    corpus = JsonlCorpus(path)
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
        "model.attention": "flash", "eval.store_shard_size": PROD_SHARD,
        "eval.embed_batch_size": 512, "serve.query_cache_size": SERVE_CACHE,
        "serve.result_cache": True, "obs.window_s": UPD_TRIAL_S,
        "maintenance.compact_tombstone_density": UPD_COMPACT_DENSITY})
    m = cfg.model
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    emb.embed_pages(np.zeros((8, p_tok.max_tokens), np.int32))   # warm
    rec = {"phase": "updates", "config": cfg.name, **widths(cfg),
           "base_pages": UPD_BASE_PAGES, "appends": [list(a) for a in
                                                     UPD_APPENDS],
           "qps": UPD_QPS}
    rng = np.random.default_rng(UPD_SEED)
    picks = rng.choice(UPD_BASE_PAGES, UPD_UPDATED + UPD_TOMBSTONED,
                       replace=False)
    updated = np.sort(picks[:UPD_UPDATED])
    tombstoned = np.sort(picks[UPD_UPDATED:])
    encodes = count_encodes(emb)
    services = []
    # (f) the CLI's manual fleet, in subprocesses beside (a): no load
    # trial runs before it is joined
    fleet = Background(run_cli_fleet, workdir)
    torch.cuda.synchronize()
    reset_counts()
    # ---- the main path, counted (a)-(e) -------------------------------
    # (a) the base store
    store_dir = os.path.join(workdir, "store_updates")
    store = VectorStore(store_dir, dim=m.out_dim, shard_size=PROD_SHARD)
    store.ensure_model_step(0)
    t0 = time.perf_counter()
    emb.embed_corpus(corpus, store, stop=UPD_BASE_PAGES)
    torch.cuda.synchronize()
    rec["a_embed_s"] = time.perf_counter() - t0
    if (store.num_vectors, len(store.shards())) != (
            UPD_BASE_PAGES, -(-UPD_BASE_PAGES // PROD_SHARD)):
        raise AssertionError(f"the base store holds {store.num_vectors} "
                             f"rows in {len(store.shards())} shards")
    t0 = time.perf_counter()
    svc = SearchService(cfg, emb, corpus, VectorStore(store_dir))
    services.append(svc)
    rec["a_stage_s"] = time.perf_counter() - t0
    if not (svc.preloaded and svc.pages.shape == (UPD_BASE_PAGES, m.out_dim)
            and svc.pages.device.type == device.type):
        raise AssertionError("the base store is not staged whole")
    svc.start_batcher()
    server = SearchServer(svc, executor_workers=SERVE_LOAD_WORKERS)
    server.start_background()
    client = SocketSearchClient(server.host, server.port)
    distinct = corpus.query_texts(range(SERVE_DISTINCT))
    checks = corpus.query_texts(np.linspace(
        0, UPD_BASE_PAGES - 1, UPD_CHECK_QUERIES).astype(np.int64))

    def workload():
        return make_workload("poisson", seed=SERVE_SEED,
                             distinct=SERVE_DISTINCT, alpha=SERVE_ALPHA,
                             profile=((10, None, 1.0),))

    def trial(mutator=None, before=None, duration_s=UPD_TRIAL_S):
        # every trial starts from cold caches, as phase 16's searches do
        svc.clear_cache()
        if before is not None:
            before()
        return run_trial(svc, workload(), UPD_QPS, distinct,
                         duration_s=duration_s, warmup_s=SERVE_WARMUP_S,
                         workers=SERVE_LOAD_WORKERS, client=client,
                         mutator=mutator)

    refreshes, errors = [], []
    cli_out = fleet.result()
    try:
        # (b) a warm-up trial (a process's first load trial can stall its
        # queue, PERF.md section 6), a trial with no mutation, then one
        # per append
        rec["b_warm"] = trial_line(trial(duration_s=SERVE_WARM_S))
        base_trial = trial()
        rec["b_no_mutation"] = trial_line(base_trial)
        emit({"phase": "updates_b_no_mutation", **rec["b_no_mutation"],
              "at_s": time.perf_counter() - t_phase})
        for g, (lo, hi) in enumerate(UPD_APPENDS, 1):
            last = g == len(UPD_APPENDS)
            kw = ({"update_ids": updated, "tombstone": tombstoned}
                  if last else {})

            def op(lo=lo, hi=hi, kw=kw):
                t = time.perf_counter()
                stats = append_corpus(emb, corpus, VectorStore(store_dir),
                                      start=lo, stop=hi, **kw)
                append_s = time.perf_counter() - t
                return stats, append_s, svc.refresh()
            mut = OneShotMutator(f"append_{g}", op, UPD_FIRE_S)
            # before the last: the check queries cached at generation 2,
            # for (c)
            tr = trial(mut, before=(lambda: [svc.search(q, k=10)
                                             for q in checks])
                       if last else None)
            mut.join()
            errors += mut.errors
            if mut.result is None:
                raise AssertionError(f"mutation {g} failed: {mut.errors}")
            stats, append_s, info = mut.result
            one = {"generation": g, "ids": [lo, hi],
                   "updated": stats["updated"],
                   "tombstoned": stats["tombstoned"],
                   "append_s": append_s,
                   "swap_ms": info["swap_ms"],
                   "refresh_seconds": info["refresh_seconds"],
                   "h2d_bytes": info["stage"]["h2d_bytes"],
                   "h2d_rows": info["stage"]["h2d_rows"],
                   "d2d_bytes": info["stage"]["d2d_bytes"],
                   "grew_buffer": info["stage"]["grew_buffer"],
                   "newly_dead_rows": info["stage"]["newly_dead_rows"],
                   "mutation_done_at_s": mut.done_at_s,
                   "trial_s": SERVE_WARMUP_S + UPD_TRIAL_S,
                   "swap_in_trial": mut.done_at_s
                   <= SERVE_WARMUP_S + UPD_TRIAL_S,
                   "store_generation": info["store_generation"],
                   "index_error": info.get("index_error"),
                   "client_p99_ms": tr.get("client_p99_ms"),
                   "client_p99_ms_no_mutation": base_trial.get(
                       "client_p99_ms"),
                   "trial": trial_line(tr),
                   "at_s": time.perf_counter() - t_phase}
            refreshes.append(one)
            emit({"phase": f"updates_b_refresh_{g}", **one})
            if tr["errors"] or one["index_error"] is not None:
                raise AssertionError(f"mutation trial {g}: {one}")
        if errors or base_trial["errors"]:
            raise AssertionError(f"mutator errors {errors}, "
                                 f"{base_trial['errors']} failed requests")
        rec["b_refreshes"] = refreshes
        # (f) the fleet's append and refresh, beside (c)-(e)
        cli_updates = Background(run_cli_updates, workdir)

        # (c) the checks
        full = VectorStore(os.path.join(workdir, "store_production"))
        prod = {e["index"]: e for e in full.shards()}
        byte_equal = {}
        upd_store = VectorStore(store_dir)
        for gen in upd_store.generations()[:2]:
            for e in gen["shards"]:
                want = prod[e["index"]]
                same = all(
                    np.array_equal(
                        np.load(os.path.join(full.directory, want[key])),
                        np.load(os.path.join(upd_store.directory, e[key])))
                    for key in ("ids", "vec"))
                byte_equal[e["vec"]] = same
        if len(byte_equal) != 2 or not all(byte_equal.values()):
            raise AssertionError(f"appended rows differ from phase 15's: "
                                 f"{byte_equal}")
        if svc._view.generation != 3 or upd_store.generation != 3:
            raise AssertionError("the service is not on generation 3")
        # every check query has a generation-2 entry in the result cache;
        # a lookup now misses unless the load put a generation-3 one
        keys = [svc._result_cache_key(q, 10, None) for q in checks]
        if any(k[3] & 0xFFFFFFFF != 3 for k in keys):
            raise AssertionError("a result-cache key is not generation 3's")
        with svc._rcache_lock:
            old_held = sum((*k[:3], k[3] - 1, *k[4:]) in svc._rcache
                           for k in keys)
            new_held = sum(k in svc._rcache for k in keys)
        misses0, hits0 = svc.result_cache_misses, svc.result_cache_hits
        got = [svc.search(q, k=10) for q in checks]
        first_misses = svc.result_cache_misses - misses0
        again = [svc.search(q, k=10) for q in checks]
        if (old_held != UPD_CHECK_QUERIES
                or first_misses != UPD_CHECK_QUERIES - new_held
                or again != got or svc.result_cache_hits - hits0
                != UPD_CHECK_QUERIES + new_held):
            raise AssertionError(
                f"the result cache: {old_held} generation-2 entries held, "
                f"{new_held} generation-3, {first_misses} misses")
        qv = svc._embed_queries_cached(svc._view, checks)
        plain_s, plain_pid = live_topk(device, upd_store, qv, 10)
        raw_s, raw_i = svc.topk_vectors(qv, k=10)
        ties_plain = ties_only(raw_s, raw_i, plain_s, plain_pid,
                               "phase 17 (c) refreshed service vs a plain "
                               "top-10 over the live rows")
        fresh = SearchService(cfg, emb, corpus, VectorStore(store_dir))
        services.append(fresh)
        ties_fresh = serve_results_equal(
            fresh.search_many(checks, k=10), got,
            "phase 17 (c) refreshed vs a service opened fresh")
        dead = set(tombstoned.tolist())
        upd_set = set(updated.tolist())
        ids_all, vecs_all = upd_store.load_all()
        live = ids_all >= 0
        rows_of = dict(zip(ids_all[live].tolist(),
                           np.flatnonzero(live).tolist()))
        qh = qv.float().cpu().numpy()
        for qi, hits in enumerate(got):
            ids = [h["page_id"] for h in hits]
            if len(ids) != 10 or len(set(ids)) != 10 or dead & set(ids):
                raise AssertionError(f"query {qi}: a dead or repeated row "
                                     f"in {ids}")
            for h in hits:
                if h["page_id"] in upd_set:
                    new = float(qh[qi] @ np.asarray(
                        vecs_all[rows_of[h["page_id"]]], np.float32))
                    if abs(new - h["score"]) > SERVE_SCORE_TOL:
                        raise AssertionError(
                            f"updated page {h['page_id']} served its old "
                            f"row: {h['score']} vs {new}")
        # appended and updated pages found by their own stored vectors
        found = np.concatenate([
            np.linspace(UPD_BASE_PAGES, PROD_PAGES - 1,
                        UPD_PRESENCE).astype(np.int64), updated[:8]])
        own = np.stack([np.asarray(vecs_all[rows_of[int(i)]], np.float32)
                        for i in found])
        _, top = svc.topk_vectors(own, k=1)
        if not np.array_equal(top[:, 0], found):
            raise AssertionError(f"appended pages not found by their own "
                                 f"rows: {top[:, 0]} vs {found}")
        rec["c_checks"] = {
            "appended_rows_byte_equal_phase15": byte_equal,
            "tie_rows_vs_plain_live": ties_plain,
            "tie_rows_vs_fresh_service": ties_fresh,
            "result_cache_generation_2_entries_held": old_held,
            "result_cache_generation_3_entries_held": new_held,
            "result_cache_misses_after_swap": first_misses,
            "presence_checked": int(found.size),
            "live_rows": int(live.sum()), "stored_rows": int(ids_all.size),
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "updates_c_checks", **rec["c_checks"]})
        del ids_all, vecs_all, rows_of
    finally:
        client.close()
        server.close()
        svc.close()
    try:
        # (d) the IVF update: phase 14's int8 rows (its codes and scales,
        # copied shard by shard into a store stamped at step 0, as every
        # store the CLI makes is) under a PQ index of phase 14's knobs
        t0 = time.perf_counter()
        ivf_dir = os.path.join(workdir, "ivf_updates")
        src = VectorStore(os.path.join(workdir, "ivf_int8"))
        q8 = VectorStore(ivf_dir, dim=m.out_dim, shard_size=PROD_SHARD,
                         dtype="int8")
        q8.ensure_model_step(0)
        for e in src.shards():
            ids, codes, scl = src._load_entry(e, raw=True)
            q8.write_shard(e["index"], ids, codes=np.asarray(codes),
                           scales=np.asarray(scl))
        n0 = q8.num_vectors
        ivf_cfg = get_config("bert_mini_v5p16", {
            "data.num_pages": n0, "serve.index": "ivf",
            "serve.pq_m": IVF_PQ_M, "eval.store_dtype": "int8"})
        IVFIndex.build_from_config(q8, ivf_cfg, device=device)
        d = index_dir(q8)
        posting0 = {f: os.stat(os.path.join(d, f)).st_mtime_ns
                    for f in os.listdir(d) if f.startswith("posting_")}
        grown = KeptTexts(build_corpus(data_config(
            "bert_mini_v5p16", n0 + UPD_IVF_APPEND + UPD_IVF_APPEND_2)))
        a1 = append_corpus(emb, grown, q8, start=n0,
                           stop=n0 + UPD_IVF_APPEND)
        idx, info = IVFIndex.update(
            VectorStore(ivf_dir), rebuild_drift=cfg.updates.rebuild_drift,
            nlist=cfg.serve.nlist, iters=cfg.serve.kmeans_iters,
            init=cfg.serve.kmeans_init, device=device)
        untouched = all(os.stat(os.path.join(d, f)).st_mtime_ns == t
                        for f, t in posting0.items())
        if not (info["action"] == "incremental" and info["new_shards"] == 1
                and info["appended_rows"] == UPD_IVF_APPEND and untouched
                and idx.index_generation == 1 and idx.pq_m == IVF_PQ_M):
            raise AssertionError(f"the IVF update: {info}, old postings "
                                 f"untouched: {untouched}")
        qids = np.concatenate([np.linspace(0, n0 - 1, 24),
                               np.linspace(n0, n0 + UPD_IVF_APPEND - 1, 8)]
                              ).astype(np.int64)
        ivf_q = emb.embed_texts([grown.query_text(int(i)) for i in qids])
        ann_s, ann_i, _ = idx.search(ivf_q, k=10, nprobe=idx.nlist,
                                     rerank=VectorStore(ivf_dir).num_vectors)
        from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
        ex_s, ex_i = topk_over_store(ivf_q, VectorStore(ivf_dir), k=10,
                                     device=device)
        ties_ivf = ties_only(ann_s, ann_i, ex_s, ex_i,
                             "phase 17 (d) IVF full probe vs exact")
        a2 = append_corpus(emb, grown, VectorStore(ivf_dir))
        idx2, info2 = IVFIndex.update(
            VectorStore(ivf_dir), rebuild_drift=UPD_IVF_DRIFT,
            nlist=cfg.serve.nlist, iters=cfg.serve.kmeans_iters,
            init=cfg.serve.kmeans_init, device=device)
        if not (info2["action"] == "rebuild" and idx2.index_generation == 0
                and int(idx2.list_sizes.sum()) == n0 + UPD_IVF_APPEND
                + UPD_IVF_APPEND_2 and idx2.pq_m == IVF_PQ_M):
            raise AssertionError(f"the drift rebuild: {info2}")
        rec["d_ivf"] = {"store_rows": n0, "append": a1["appended"],
                        "update": info, "old_postings_untouched": untouched,
                        "tie_rows_full_probe_vs_exact": ties_ivf,
                        "second_append": a2["appended"],
                        "rebuild_drift": UPD_IVF_DRIFT, "rebuild": info2,
                        "seconds": time.perf_counter() - t0,
                        "at_s": time.perf_counter() - t_phase}
        emit({"phase": "updates_d_ivf", **rec["d_ivf"]})

        # (e) the compaction of (b)'s chain under the service
        t0 = time.perf_counter()
        before = svc.search_many(checks, k=10)
        if not compaction_due(VectorStore(store_dir), cfg):
            raise AssertionError("the chain's tombstone density is under "
                                 "the compaction trigger")
        stats = compact_store(VectorStore(store_dir))
        info = svc.refresh()
        after = svc.search_many(checks, k=10)
        ties_compact = serve_results_equal(
            after, before, "phase 17 (e) compacted vs the chain")
        want_rows = PROD_PAGES - UPD_TOMBSTONED
        if not (stats["action"] == "compacted" and stats["rows"] == want_rows
                and svc.num_vectors == want_rows
                and info["store_generation"] == 3
                and stats["dead_rows_dropped"] == UPD_UPDATED
                + UPD_TOMBSTONED):
            raise AssertionError(f"the compaction: {stats}, service "
                                 f"{svc.num_vectors} rows")
        rec["e_compact"] = {
            **{k: v for k, v in stats.items()
               if k not in ("stale_dirs", "stale_files")},
            "refresh_seconds": info["refresh_seconds"],
            "restage_h2d_bytes": info["stage"]["h2d_bytes"],
            "tie_rows": ties_compact, "live_rows": svc.num_vectors,
            "phase_s": time.perf_counter() - t0,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "updates_e_compact", **rec["e_compact"]})
        cli_out.update(cli_updates.result())
    finally:
        svc.close()
    torch.cuda.synchronize()
    counts = launch_counts()
    # ------------------------------------------------------------------
    cli = {k: {"out": v[0], "seconds": v[1]} for k, v in cli_out.items()}
    slices = cli["embed_slices"]["out"]
    ok = (cli["merge-store"]["out"]["shards"] == 3
          and cli["merge-store"]["out"]["vectors"] == 600
          and sum(x["embedded"] > 0 for x in slices) == 3
          and cli["append"]["out"]["generation"] == 1
          and cli["append"]["out"]["appended"] == UPD_CLI_GROWN - 600
          and cli["append"]["out"]["store_vectors"] == UPD_CLI_GROWN + 1
          and cli["refresh"]["out"]["store_generation"] == 1
          and cli["refresh"]["out"]["action"] == "rebuild")
    rec["f_cli"] = {**cli, "overrides": UPD_CLI_OVERRIDES, "ok": ok}
    emit({"phase": "updates_f_cli", **rec["f_cli"]})
    if not ok:
        raise AssertionError(f"the CLI's store commands: {rec['f_cli']}")
    # (g) K1 as often as the encodes need, every one on the tensor cores
    want = expected_launches((encodes["page"] + encodes["query"])
                             * m.num_layers, 0)
    if counts != want:
        raise AssertionError(f"phase 17 launched {counts}, want {want} "
                             f"({encodes})")
    del services, svc
    torch.cuda.empty_cache()
    gc.unfreeze()
    seconds = time.perf_counter() - t_phase
    rec.update({"page_encodes": encodes["page"],
                "query_encodes": encodes["query"],
                "k1_launches": counts["launches"],
                "k1_launches_tensor_core": counts["launches_tc"],
                "seconds": seconds, "budget_s": UPD_BUDGET_S,
                "over_budget": seconds > UPD_BUDGET_S,
                "device": torch.cuda.get_device_name(0),
                "nvidia_smi": nvidia_smi()})
    emit({k: v for k, v in rec.items()
          if k not in ("b_refreshes", "f_cli", "d_ivf")})
    return rec


# -- phase 18: a rolling migration and background maintenance under load ----

class ThreadLaunches:
    """K1 launches counted per thread, beside the kernel wrappers' own
    counters: `fa._count` is wrapped to also add to a thread-local tally,
    so a probe on one thread reads exactly its own launches while other
    threads serve load."""

    def __init__(self):
        from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
        self._fa = fa
        self._orig = fa._count
        self._local = threading.local()
        orig, local = self._orig, self._local

        def counted(name, tensor_cores, seg):
            orig(name, tensor_cores, seg)
            if name == "launches":
                local.k1 = getattr(local, "k1", 0) + 1
        fa._count = counted

    def k1(self) -> int:
        return getattr(self._local, "k1", 0)

    def close(self) -> None:
        self._fa._count = self._orig


def store_oracle(device, view, towers: dict, q_tok, texts, k: int,
                 encode) -> tuple:
    """The dual-stamp oracle: each query encoded by every stamp's tower on
    the card, each live shard of the view's table read from disk and
    scored plainly (float32 q @ rows^T) with its own stamp's vector, one
    top-k over them all. (scores, page ids)."""
    enc = to_host_ids(q_tok, texts)
    qs = {s: encode(torch.from_numpy(enc).to(device), towers[s]).float()
          for s in view.steps}
    best_s = torch.full((len(texts), k), -torch.inf, device=device)
    best_i = torch.full((len(texts), k), -1, dtype=torch.int64,
                        device=device)
    store = view.store
    for e in view.entries:
        if not e["count"]:
            continue
        ids = store.load_ids(e)
        _, vecs, _ = store._load_entry(e, raw=True)
        live = ids >= 0
        rows = torch.from_numpy(np.ascontiguousarray(
            np.asarray(vecs)[live])).to(device).float()
        pid = torch.from_numpy(ids[live]).to(device)
        s = qs[store.entry_step(e)] @ rows.T
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, pid[None].expand(len(texts), -1)], dim=1)
        best_s, at = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, at)
    return best_s.cpu().numpy(), best_i.cpu().numpy()


def to_host_ids(tok, texts) -> np.ndarray:
    enc = tok.encode_batch(list(texts))
    pad = -len(texts) % 8
    if pad:
        enc = np.concatenate([enc, np.zeros((pad,) + enc.shape[1:],
                                            enc.dtype)])
    return enc


def run_cli_migration(workdir: str) -> dict:
    """Phase 17's CLI store (cdssm_toy, random weights) through the slice's
    commands in subprocesses on the card: one training step (a checkpoint
    at step 1), migrate (the store re-embedded from step 0 to 1), index
    --pq and maintain --once."""
    args = cli_fleet_args(workdir, {**UPD_CLI_OVERRIDES,
                                    "data.num_pages": UPD_CLI_GROWN})
    out = {"train": run_cli("train", [*args, "--steps", "1"], 600)}
    for command, extra in (("migrate", []), ("index", ["--pq"]),
                           ("maintain", ["--once"])):
        out[command] = run_cli(command, [*args, *extra], 600)
    return out


def run_migration(device, data, workdir: str, production: dict) -> dict:
    """Phase 18: a rolling model migration and background maintenance on
    config 3's live 1M-page store under load.

    (a) the target tower: phase 17's weights (config 3's seeded towers)
    trained MIG_TRAIN_STEPS steps of 8,192 pairs from phase 15's corpus
    (K1, K2, K3), saved through the port's checkpoint and restored into a
    fresh Trainer, which stamps it at the next step; (b) phase 17's store
    is one compacted base, so one generation of MIG_UPDATED updated pages
    is appended first; (c) a SearchService (query and result caches on)
    stages it behind a SearchServer with the MaintenanceService attached
    (start_maintenance(), its workers polling every MIG_INTERVAL_S,
    units_per_pass 1, purge on) and request_migration(to_step, corpus,
    target embedder); phase 16's Poisson mix at UPD_QPS over the socket:
    a warm-up trial, one with no mutation, then UPD_TRIAL_S trials back to
    back until the sweep completes, the first holding an append of
    MIG_UPDATED more updated pages at the old step (under the service's
    mutation lock: a pending unit of the sweep). At each unit's flip, in
    the migrator's thread: UPD_CHECK_QUERIES corpus queries through the
    refreshed service equal the dual-stamp oracle (store_oracle) except
    at ties, their result-cache keys all moved, and a probe of
    MIG_PROBES unseen queries launches K1 4 times a stamp the view serves
    (8 mid-sweep, 4 after the flip; ThreadLaunches). After completion:
    model_step == to_step, migration None, no pending unit, no shard of
    the old stamp; one base shard and each migrated generation equal a
    bulk embed of their pages by the target tower byte for byte. (d) the
    rebuild pillar: phase 17 (d)'s store (phase 14's int8 rows and its
    appends, under the PQ index of its drift rebuild) served through the
    index at UPD_QPS with the maintenance
    attached: an append past MIG_IVF_DRIFT and refresh() in a trial set
    serve.index_rebuild_pending; the rebuild pillar builds ivf-0001 beside
    the live index, flips the pointer and hot-swaps within the trials;
    its files equal a seeded build(dirname=) of the same store byte for
    byte; full probe with every candidate re-ranked equals exact; the old
    directory exists at the flip and the janitor removes it later. (e)
    the CLI's train, migrate, index --pq and maintain --once over phase
    17's CLI store, beside (c). (f) K1 4 times every page batch and query
    dispatch of the phase, K2 and K3 only in (a), all on the tensor
    cores; no failed request, no mutator or pillar error."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.server import SearchServer
    from dnn_page_vectors_tpu_torch.infer.transport import SocketSearchClient
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.loadgen import make_workload, run_trial
    from dnn_page_vectors_tpu_torch.maintenance import MigrationPlan
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    from dnn_page_vectors_tpu_torch.updates import append_corpus
    from dnn_page_vectors_tpu_torch.utils import faults
    import gc
    import shutil

    t_phase = time.perf_counter()
    gc.collect()
    gc.freeze()
    _, q_tok, p_tok = data
    path = production["corpus_path"]
    corpus = JsonlCorpus(path)
    base_ov = {"data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
               "model.attention": "flash", "eval.store_shard_size": PROD_SHARD,
               "eval.embed_batch_size": 512}
    cfg = get_config("bert_mini_v5p16", {
        **base_ov, "serve.query_cache_size": SERVE_CACHE,
        "serve.result_cache": True, "obs.window_s": UPD_TRIAL_S,
        "maintenance.interval_s": MIG_INTERVAL_S,
        "migrate.batch_rows": PROD_SHARD})
    m = cfg.model
    # K1, K2 and K3 of the target tower's steps: a layer of each tower
    train_k = 2 * m.num_layers * MIG_TRAIN_STEPS
    store_dir = os.path.join(workdir, "store_updates")
    old_model = build_two_tower(cfg, vocab_size=p_tok.vocab_size,
                                device=device)
    emb = BulkEmbedder(cfg, old_model, p_tok, query_tok=q_tok, device=device)
    emb.embed_pages(np.zeros((8, p_tok.max_tokens), np.int32))   # warm
    rec = {"phase": "migration", "config": cfg.name, **widths(cfg),
           "qps": UPD_QPS, "trial_s": UPD_TRIAL_S,
           "interval_s": MIG_INTERVAL_S}
    # (e) the CLI, in subprocesses beside (c)
    cli_job = Background(run_cli_migration, workdir)
    torch.cuda.synchronize()
    reset_counts()
    tl = ThreadLaunches()
    enc_old = count_encodes(emb)
    services, servers, clients, maints = [], [], [], []
    try:
        # ---- (a) the target tower -------------------------------------
        t0 = time.perf_counter()
        tcfg = get_config("bert_mini_v5p16", base_ov)
        trainer = Trainer(tcfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                          device=device)
        same_start = all(torch.equal(a, b) for a, b in zip(
            trainer.model.state_dict().values(),
            old_model.state_dict().values()))
        if not same_start:
            raise AssertionError("the trainer does not start from phase "
                                 "17's weights")
        before = launch_counts()
        hist = trainer.train(steps=MIG_TRAIN_STEPS)
        torch.cuda.synchronize()
        after = launch_counts()
        train_counts = {k: after[k] - before[k] for k in after}
        mgr = CheckpointManager(os.path.join(workdir, "ckpt_migration"))
        trainer.save(mgr)
        restored = Trainer(tcfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                           device=device)
        to_step = restored.restore(mgr)
        if not (to_step == MIG_TRAIN_STEPS and all(
                torch.equal(a, b) for a, b in zip(
                    restored.model.state_dict().values(),
                    trainer.model.state_dict().values()))):
            raise AssertionError("the checkpoint round trip of the target "
                                 "tower")
        target = restored.model
        del trainer, restored
        torch.cuda.empty_cache()
        names = ("k1", "k2", "k3", "k4")
        keys = ("launches", "dq_launches", "dkv_launches",
                "dq_dbias_launches")
        want_train = {n: train_k if n in ("k1", "k2", "k3") else 0
                      for n in names}
        got_train = {n: train_counts[k] for n, k in zip(names, keys)}
        if got_train != want_train or any(
                train_counts[k + "_tc"] != train_counts[k] for k in keys):
            raise AssertionError(f"the target tower's steps launched "
                                 f"{train_counts}")
        rec["train"] = {
            "steps": MIG_TRAIN_STEPS, "batch_pairs": tcfg.train.batch_size,
            "seconds": time.perf_counter() - t0,
            "loss": hist.get("loss"), "to_step": to_step,
            "launches_main_path": got_train,
            "launches_tensor_core_main_path": {
                n: train_counts[k + "_tc"] for n, k in zip(names, keys)},
            "launches_seg_main_path": {
                n: train_counts[k + "_seg"] for n, k in zip(names, keys)},
            "launches_one_step": {n: v // MIG_TRAIN_STEPS
                                  for n, v in got_train.items()},
            "seg_summary_launches_main_path": 0,
            "gdead_launches_main_path": 0}
        emit({"phase": "migration_a_target_tower", **rec["train"]})
        emb2 = BulkEmbedder(cfg, target, p_tok, query_tok=q_tok,
                            device=device)
        enc_new = count_encodes(emb2)

        # ---- (b) a generation to migrate beside the base ---------------
        store = VectorStore(store_dir)
        from_step = store.model_step
        towers = {from_step: old_model, to_step: target}
        rng = np.random.default_rng(MIG_SEED)
        phase17 = np.random.default_rng(UPD_SEED).choice(
            UPD_BASE_PAGES, UPD_UPDATED + UPD_TOMBSTONED, replace=False)
        gone = set(phase17[UPD_UPDATED:].tolist())
        pool = np.setdiff1d(np.arange(PROD_PAGES),
                            np.fromiter(gone, np.int64))
        picks = rng.choice(pool, 2 * MIG_UPDATED, replace=False)
        pre_ids, mid_ids = np.sort(picks[:MIG_UPDATED]), \
            np.sort(picks[MIG_UPDATED:])
        t0 = time.perf_counter()
        if not store.generations():
            append_corpus(emb, corpus, store, start=PROD_PAGES,
                          stop=PROD_PAGES, update_ids=pre_ids)
        rec["b_pre_sweep_append_s"] = time.perf_counter() - t0
        store = VectorStore(store_dir)
        rec["b_store"] = {"rows": store.num_vectors,
                          "base_shards": len(store.manifest["shards"]),
                          "generations": [g["gen"] for g in
                                          store.generations()],
                          "compacted_through": store.compacted_through,
                          "model_step": from_step}

        # ---- (c) the sweep under load -----------------------------------
        t0 = time.perf_counter()
        # the rows a unit's refresh must copy: its rows the first stage
        # took (not those dead then), or all of a generation appended since
        at_stage = VectorStore(store_dir)
        units0 = {0: at_stage.manifest["shards"],
                  **{int(g["gen"]): g["shards"]
                     for g in at_stage.generations()}}
        staged_at = {u: int(sum((at_stage.load_ids(e) >= 0).sum()
                                for e in ents))
                     for u, ents in units0.items()}

        def staged_rows(unit: int, rows: int) -> int:
            return staged_at.get(unit, rows)
        svc = SearchService(cfg, emb, corpus, VectorStore(store_dir))
        services.append(svc)
        rec["c_stage_s"] = time.perf_counter() - t0
        if not svc.preloaded:
            raise AssertionError("the store is not staged whole")
        svc.start_batcher()
        server = SearchServer(svc, executor_workers=SERVE_LOAD_WORKERS)
        server.start_background()
        servers.append(server)
        client = SocketSearchClient(server.host, server.port)
        clients.append(client)
        maint = svc.start_maintenance()
        maints.append(maint)
        checks = corpus.query_texts(np.linspace(
            0, PROD_PAGES - 1, UPD_CHECK_QUERIES).astype(np.int64))
        distinct = corpus.query_texts(range(SERVE_DISTINCT))
        flips = []
        real_refresh = svc.refresh

        def refresh(update_index=None):
            # the migrator's refresh, on its thread under the mutation
            # lock: the check queries before and after the view moves
            view0 = svc._view
            pre = svc.search_many(checks, k=10)
            keys0 = [svc._result_cache_key(q, 10, None, view=view0)
                     for q in checks]
            info = real_refresh(update_index)
            view = svc._view
            keys1 = [svc._result_cache_key(q, 10, None, view=view)
                     for q in checks]
            qv = svc._embed_queries_cached(view, checks)
            got_s, got_i, _ = svc._topk_view(view, qv, len(checks), 10)
            want_s, want_i = store_oracle(
                device, view, towers, q_tok, checks, 10,
                lambda ids, tw: emb.encode_queries(ids, model=tw))
            ties = ties_only(got_s, got_i, want_s[:len(checks)],
                             want_i[:len(checks)],
                             f"phase 18 flip {len(flips)} vs the oracle")
            got = svc.search_many(checks, k=10)
            if [[h["page_id"] for h in r] for r in got] != got_i.tolist():
                raise AssertionError("search_many differs from its view's "
                                     "top-k")
            k1_0 = tl.k1()
            probes = [f"migration probe {len(flips)} {i}"
                      for i in range(MIG_PROBES)]
            svc.search_many(probes, k=10)
            probe_k1 = tl.k1() - k1_0
            one = {"flip": len(flips), "steps_serving": list(view.steps),
                   "runs": [list(r) for r in view.runs],
                   "swap_ms": info["swap_ms"],
                   "refresh_seconds": info["refresh_seconds"],
                   "stage": info.get("stage"),
                   "migration": info.get("migration"),
                   "adopted_step": info.get("migration_adopted_step"),
                   "store_generation": info["store_generation"],
                   "tie_rows_vs_oracle": ties,
                   "cache_keys_moved": sum(a != b
                                           for a, b in zip(keys0, keys1)),
                   "answers_changed_by_flip": sum(
                       [h["page_id"] for h in a] != [h["page_id"] for h in b]
                       for a, b in zip(pre, got)),
                   "probe_k1": probe_k1,
                   "probe_k1_want": m.num_layers * len(view.steps),
                   "at_s": time.perf_counter() - t_phase}
            flips.append(one)
            emit({"phase": f"migration_c_flip_{one['flip']}", **one})
            return info
        svc.refresh = refresh

        def workload():
            return make_workload("poisson", seed=SERVE_SEED,
                                 distinct=SERVE_DISTINCT, alpha=SERVE_ALPHA,
                                 profile=((10, None, 1.0),))

        def trial(tsvc, tclient, queries, mutator=None,
                  duration_s=UPD_TRIAL_S):
            # every trial starts from cold caches, as phase 17's do
            tsvc.clear_cache()
            return run_trial(tsvc, workload(), UPD_QPS, queries,
                             duration_s=duration_s, warmup_s=SERVE_WARMUP_S,
                             workers=SERVE_LOAD_WORKERS, client=tclient,
                             mutator=mutator)

        rec["c_warm"] = trial_line(trial(svc, client, distinct,
                                         duration_s=SERVE_WARM_S))
        base_trial = trial(svc, client, distinct)
        rec["c_no_mutation"] = trial_line(base_trial)
        emit({"phase": "migration_c_no_mutation", **rec["c_no_mutation"],
              "at_s": time.perf_counter() - t_phase})
        t_sweep = time.perf_counter()
        maint.request_migration(to_step, corpus, emb2)

        def mid_append():
            # once the sweep has begun, under the mutation lock: between
            # two units, never under a flip, so the completion sees this
            # generation as a pending unit
            t_wait = time.perf_counter() + 60.0
            while VectorStore(store_dir, verify=False).migration is None:
                if time.perf_counter() > t_wait:
                    raise AssertionError("the sweep did not begin")
                time.sleep(0.05)
            with maint.exclusive():
                t = time.perf_counter()
                st = append_corpus(emb, corpus, VectorStore(store_dir),
                                   start=PROD_PAGES, stop=PROD_PAGES,
                                   update_ids=mid_ids)
                return st, time.perf_counter() - t, len(flips)
        trials, errors = [], []
        mut = OneShotMutator("append_mid_sweep", mid_append, UPD_FIRE_S)
        while not any(f["adopted_step"] is not None for f in flips):
            if len(trials) >= MIG_MAX_TRIALS:
                raise AssertionError(f"the sweep did not complete in "
                                     f"{len(trials)} trials: {flips}")
            tr = trial(svc, client, distinct,
                       mutator=mut if not trials else None)
            trials.append(trial_line(tr))
            emit({"phase": f"migration_c_trial_{len(trials)}",
                  **trials[-1], "flips_so_far": len(flips),
                  "at_s": time.perf_counter() - t_phase})
            if tr["errors"]:
                raise AssertionError(f"failed requests in sweep trial "
                                     f"{len(trials)}: {trials[-1]}")
        sweep_s = time.perf_counter() - t_sweep
        mut.join()
        errors += mut.errors
        pillar_errors = {k: v for k, v in faults.counters().items()
                         if k.startswith("maintenance_")}
        if errors or base_trial["errors"] or pillar_errors or \
                mut.result is None:
            raise AssertionError(f"mutator errors {errors}, pillar errors "
                                 f"{pillar_errors}, {base_trial['errors']} "
                                 "failed requests")
        mid_stats, mid_s, mid_after_flips = mut.result
        # the checks after completion
        done = VectorStore(store_dir)
        pend = MigrationPlan(done, corpus, emb2, to_step).pending_units()
        old_left = [e["index"] for e in done.shards()
                    if done.entry_step(e) != to_step]
        if not (done.model_step == to_step and done.migration is None
                and pend == [] and not old_left
                and done.model_steps() == [to_step]):
            raise AssertionError(f"the store after the sweep: step "
                                 f"{done.model_step}, {done.migration}, "
                                 f"pending {pend}, old shards {old_left}")
        bad_flips = [f for f in flips
                     if f["cache_keys_moved"] != UPD_CHECK_QUERIES
                     or f["probe_k1"] != f["probe_k1_want"]]
        if bad_flips or len(flips) < 4 or svc._towers:
            raise AssertionError(f"the flips: {flips}")
        units = [e for e in svc.registry.events()
                 if e["event"] == "migration_generation_done"]
        # each unit's refresh copied exactly the unit's rows from the host
        if len(units) != len(flips) - 1:
            raise AssertionError(f"{len(units)} units for {len(flips)} "
                                 "flips")
        for f, u in zip(flips, units):
            st = f["stage"]
            f["unit"] = u["attrs"]["generation"]
            f["unit_rows"] = u["attrs"]["rows"]
            f["unit_seconds"] = u["attrs"]["seconds"]
            f["staged_rows"] = staged_rows(f["unit"], f["unit_rows"])
            f["h2d_bytes_want"] = f["staged_rows"] * done.row_bytes
            # the unit's rows, and any generation appended since the last
            # refresh, come from the host; nothing else
            f["unit_h2d_bytes"] = st["replaced_rows"] * done.row_bytes
            if st["replaced_rows"] != f["staged_rows"] or \
                    st["h2d_bytes"] != st["h2d_rows"] * done.row_bytes \
                    + 8 * st["newly_dead_rows"]:
                raise AssertionError(f"flip {f['flip']} moved {st} for a "
                                     f"unit of {f['unit_rows']} rows")
        # migrated rows vs a bulk embed by the target tower, byte for byte
        byte_equal = {}
        base0 = done.manifest["shards"][0]
        gens = [s for g in done.generations() for s in g["shards"]]
        for e in [base0, *gens]:
            ids = np.load(os.path.join(done.directory, e["ids"]))
            want = emb2.embed_texts([corpus.page_text(int(i)) for i in ids],
                                    tower="page")
            got = np.load(os.path.join(done.directory, e["vec"]))
            byte_equal[e["vec"]] = bool(np.array_equal(
                got.view(np.uint16), want.view(np.uint16)))
        if not all(byte_equal.values()):
            raise AssertionError(f"migrated rows differ from a bulk embed "
                                 f"by the target tower: {byte_equal}")
        rows = sum(f.get("unit_rows", 0) for f in flips)
        rec["c_sweep"] = {
            "from_step": from_step, "to_step": to_step,
            "seconds": sweep_s, "rows": rows,
            "pages_per_s_under_load": rows / sweep_s,
            "units": [{k: f.get(k) for k in (
                "unit", "unit_rows", "staged_rows", "unit_seconds",
                "swap_ms", "refresh_seconds", "h2d_bytes_want",
                "unit_h2d_bytes")}
                | {"h2d_bytes": (f["stage"] or {}).get("h2d_bytes"),
                   "d2d_bytes": (f["stage"] or {}).get("d2d_bytes")}
                for f in flips],
            "mid_sweep_append": {"updated": mid_stats["updated"],
                                 "generation": mid_stats["generation"],
                                 "seconds": mid_s,
                                 "after_flips": mid_after_flips},
            "trials": trials, "byte_equal_bulk_embed": byte_equal,
            "rows_after": done.num_vectors,
            "at_s": time.perf_counter() - t_phase}
        rec["c_flips"] = flips
        emit({"phase": "migration_c_sweep", **rec["c_sweep"]})
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.close()
        for s in services:
            s.close()
        clients.clear()
        servers.clear()
        services.clear()
    try:
        # ---- (d) the rebuild pillar under load --------------------------
        t0 = time.perf_counter()
        # phase 17 (d)'s store: phase 14's int8 rows and its appends, under
        # the PQ index of its drift rebuild
        ivf_dir = os.path.join(workdir, "ivf_updates")
        n0 = VectorStore(ivf_dir).num_vectors
        icfg = get_config("bert_mini_v5p16", {
            "data.num_pages": n0, "serve.index": "ivf",
            "serve.pq_m": IVF_PQ_M, "eval.store_dtype": "int8",
            "updates.rebuild_drift": MIG_IVF_DRIFT,
            "serve.query_cache_size": SERVE_CACHE,
            "obs.window_s": UPD_TRIAL_S,
            "maintenance.interval_s": MIG_INTERVAL_S})
        grown = KeptTexts(build_corpus(data_config(
            "bert_mini_v5p16", n0 + MIG_IVF_APPEND)))
        emb_i = BulkEmbedder(icfg, old_model, p_tok, query_tok=q_tok,
                             device=device)
        enc_i = count_encodes(emb_i)
        isvc = SearchService(icfg, emb_i, grown, VectorStore(ivf_dir))
        services.append(isvc)
        if isvc.index is None:
            raise AssertionError("the PQ index does not serve")
        isvc.start_batcher()
        iserver = SearchServer(isvc, executor_workers=SERVE_LOAD_WORKERS)
        iserver.start_background()
        servers.append(iserver)
        iclient = SocketSearchClient(iserver.host, iserver.port)
        clients.append(iclient)
        imaint = isvc.start_maintenance()
        maints.append(imaint)
        gauge = isvc.registry.gauge("serve.index_rebuild_pending")
        swaps = []
        real_irefresh = isvc.refresh

        def irefresh(update_index=None):
            old = os.path.join(ivf_dir, isvc._view.store.index_dirname)
            info = real_irefresh(update_index)
            swaps.append({"old_dir": old,
                          "old_dir_exists_at_swap": os.path.isdir(old),
                          "index_dirname": isvc._view.store.index_dirname,
                          "at_s": time.perf_counter() - t_phase})
            return info
        isvc.refresh = irefresh
        iqueries = [grown.query_text(i)
                    for i in range(min(SERVE_DISTINCT, n0))]
        rec["d_warm"] = trial_line(trial(isvc, iclient, iqueries,
                                         duration_s=SERVE_WARM_S))

        def append_refresh():
            t = time.perf_counter()
            st = append_corpus(emb_i, grown, VectorStore(ivf_dir), start=n0,
                               stop=n0 + MIG_IVF_APPEND)
            info = isvc.refresh()
            return st, info, gauge.value, time.perf_counter() - t
        imut = OneShotMutator("append_refresh", append_refresh, UPD_FIRE_S)
        itrials = []
        t_rb = time.perf_counter()
        while not (swaps and swaps[-1]["index_dirname"] == "ivf-0001"):
            if len(itrials) >= MIG_MAX_TRIALS:
                raise AssertionError("the background rebuild did not swap "
                                     f"in {len(itrials)} trials")
            tr = trial(isvc, iclient, iqueries,
                       mutator=imut if not itrials else None)
            itrials.append(trial_line(tr))
            if tr["errors"]:
                raise AssertionError(f"failed requests in rebuild trial "
                                     f"{len(itrials)}: {itrials[-1]}")
        imut.join()
        if imut.errors or imut.result is None:
            raise AssertionError(f"the IVF append: {imut.errors}")
        ast, ainfo, pending_after_refresh, append_s = imut.result
        upd = ainfo.get("index_update") or {}
        last_rb = imaint.stats()["last"].get("rebuild") or {}
        if not (upd.get("rebuild_pending") and pending_after_refresh == 1.0
                and gauge.value == 0.0 and last_rb.get("dirname")
                == "ivf-0001" and isvc.full_rebuilds == 1):
            raise AssertionError(f"the deferred rebuild: {upd}, gauge "
                                 f"{pending_after_refresh} then "
                                 f"{gauge.value}, {last_rb}")
        ist = VectorStore(ivf_dir)
        live_dir = os.path.join(ivf_dir, ist.index_dirname)
        man = json.load(open(os.path.join(live_dir, "manifest.json")))
        pq = man["pq"]
        IVFIndex.build(ist, nlist=icfg.serve.nlist,
                       iters=icfg.serve.kmeans_iters, seed=icfg.data.seed,
                       init=icfg.serve.kmeans_init,
                       balance=man.get("balance", 0.0), pq_m=pq["m"],
                       pq_iters=pq["iters"], opq_iters=pq["opq_iters"],
                       device=device, dirname="ivf-seeded")
        a = npy_bytes(live_dir)
        b = npy_bytes(os.path.join(ivf_dir, "ivf-seeded"))
        if a != b or not a:
            raise AssertionError("ivf-0001 differs from a seeded build of "
                                 "the same store")
        shutil.rmtree(os.path.join(ivf_dir, "ivf-seeded"))
        qids = np.concatenate([np.linspace(0, n0 - 1, 24),
                               np.linspace(n0, n0 + MIG_IVF_APPEND - 1, 8)]
                              ).astype(np.int64)
        ivf_q = emb_i.embed_texts([grown.query_text(int(i)) for i in qids])
        idx = isvc.index
        ann_s, ann_i, _ = idx.search(ivf_q, k=10, nprobe=idx.nlist,
                                     rerank=ist.num_vectors)
        ex_s, ex_i = topk_over_store(ivf_q, ist, k=10, device=device)
        ties_ivf = ties_only(ann_s, ann_i, ex_s, ex_i,
                             "phase 18 (d) the rebuilt index's full probe "
                             "vs exact")
        # the janitor: the old index existed at the flip; a pass removes it
        old_dir = swaps[-1]["old_dir"]
        janitor = imaint.run_once().get("janitor") or {}
        if not (swaps[-1]["old_dir_exists_at_swap"]
                and not os.path.isdir(old_dir)
                and os.path.isdir(live_dir)):
            raise AssertionError(f"the janitor: {swaps}, {janitor}")
        rec["d_rebuild"] = {
            "store_rows": n0, "append": ast["appended"],
            "append_s": append_s, "drift": upd.get("drift"),
            "index_update": upd,
            "pending_gauge_after_refresh": pending_after_refresh,
            "rebuild": last_rb,
            "rebuild_done_after_s": swaps[-1]["at_s"] - (t_rb - t_phase),
            "swaps": swaps, "trials": itrials,
            "p99_of_trial_holding_the_rebuild": max(
                t.get("client_p99_ms") or 0.0 for t in itrials),
            "files_equal_seeded_build": True,
            "tie_rows_full_probe_vs_exact": ties_ivf,
            "janitor_pass_after": janitor,
            "seconds": time.perf_counter() - t0,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "migration_d_rebuild", **rec["d_rebuild"]})
        cli = {k: {"out": v[0], "seconds": v[1]}
               for k, v in cli_job.result().items()}
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.close()
        for s in services:
            s.close()
        tl.close()
    torch.cuda.synchronize()
    counts = launch_counts()
    # ------------------------------------------------------------------
    mig_out, idx_out = cli["migrate"]["out"], cli["index"]["out"]
    ok = (mig_out["action"] == "migrated" and mig_out["to_step"] == 1
          and mig_out["completed"] and mig_out["rows"] == UPD_CLI_GROWN + 1
          and idx_out["model_step"] == 1 and idx_out["pq_m"] > 0
          and idx_out["vectors"] == UPD_CLI_GROWN + 1
          and "store" in cli["maintain"]["out"])
    rec["e_cli"] = {**cli, "ok": ok}
    emit({"phase": "migration_e_cli", **rec["e_cli"]})
    if not ok:
        raise AssertionError(f"the CLI's commands: {rec['e_cli']}")
    # (f) K1 4 times every encode call, K2 and K3 only in the training
    calls = {"page_old": enc_old["page"], "query_old": enc_old["query"],
             "page_target": enc_new["page"], "query_target": enc_new["query"],
             "page_ivf": enc_i["page"], "query_ivf": enc_i["query"]}
    k1 = m.num_layers * sum(calls.values()) + train_k
    want = expected_launches(k1, train_k)
    if counts != want:
        raise AssertionError(f"phase 18 launched {counts}, want {want} "
                             f"({calls})")
    del services, svc, isvc, target
    torch.cuda.empty_cache()
    gc.unfreeze()
    seconds = time.perf_counter() - t_phase
    rec.update({"encode_calls": calls,
                "k1_launches": counts["launches"] - train_k,
                "k1_launches_tensor_core": counts["launches_tc"] - train_k,
                "seconds": seconds, "budget_s": MIG_BUDGET_S,
                "over_budget": seconds > MIG_BUDGET_S,
                "device": torch.cuda.get_device_name(0),
                "nvidia_smi": nvidia_smi()})
    emit({k: v for k, v in rec.items()
          if k not in ("c_flips", "e_cli", "d_rebuild", "c_sweep")})
    return rec


# -- phase 19: filtered retrieval and the hot posting set --------------------

def filter_words(lo: int, hi: int) -> np.ndarray:
    """The attribute words of page ids [lo, hi) in phase 14(b)'s store:
    the JAX package's filtered protocol (bench.py), lang = i % 2, site
    bucket = i % 10, recency 3 where i % 100 == 0, else 0."""
    from dnn_page_vectors_tpu_torch.index.attrs import pack_words
    i = np.arange(lo, hi)
    return pack_words(lang=(i % 2).astype(np.uint32),
                      site=(i % 10).astype(np.uint32),
                      recency=np.where(i % 100 == 0, 3, 0).astype(np.uint32))


def plain_filtered_topk(svc, qv: torch.Tensor, keep: np.ndarray,
                        k: int = 10) -> tuple:
    """A plain post-filter top-k over a service's staged rows: each int8
    row dequantized on the card with its scale, float32 q @ rows^T, the
    rows `keep` drops at -inf, torch.topk. (scores, page ids)."""
    pages, scales = svc.pages, svc.scales
    parts = []
    for lo in range(0, pages.shape[0], 262_144):
        rows = pages[lo: lo + 262_144].float()
        if scales is not None:
            rows = rows * scales[lo: lo + 262_144].float()[:, None]
        parts.append(qv.float() @ rows.T)
    mask = torch.from_numpy(keep).to(qv.device)
    sc = torch.cat(parts, dim=1).masked_fill(~mask, -torch.inf)
    s, i = torch.topk(sc, k, dim=1)
    return s.cpu().numpy(), svc.page_ids[i.cpu().numpy()]


def hot_bytes_on_card(index) -> int:
    """The bytes of an index's staged hot set on the card: codes, list
    ids and attribute words."""
    hot = index._hot
    return sum(t.numel() * t.element_size()
               for t in (hot["codes"], hot["cent"], hot["attrs"]))


def run_filtered(device, data, workdir: str) -> dict:
    """Phase 19: filtered retrieval and the hot posting set on config 3's
    towers (phase 4's weights and vocab), over phase 14(b)'s 1M-row int8
    store, whose rows carry the words of `filter_words`, and its IVF-PQ
    index (pq_m 32). (a) a SearchService (exact) answers FILT_QUERIES
    corpus queries through search_many in each arm of FILT_ARMS: the
    top-10 against a plain post-filter top-10 of the dequantized rows on
    the card (ties only), every result matching, and the s10 arm's
    scan_bytes at most 0.3x the unfiltered arm's; (b) the predicate
    through the index: recall against (a)'s filtered exact at nprobe 8,
    16, 32 and 64 a arm, full probe with every matching row re-ranked
    equal to filtered exact on FILT_CHECK_QUERIES queries (ties only), s1
    filling k at nprobe 8 and escalating at nprobe 1; (c) stage_hot at
    FILT_HOT_BUDGET: 0 < hot_lists < nlist, the staged bytes on the card,
    searches with and without a predicate equal to the mmap path's (ties
    only) with fewer bytes gathered and hot rows scored, a lone query's
    search time with and without the hot set, and after a burst of
    searches a restage ranked by popularity; (d) serve.index=
    "ivf" with serve.hot_postings_gb at that budget and both caches on
    behind a SearchServer: a SocketSearchClient's filtered results equal
    in-process search, the result cache keeps a filtered entry apart from
    its unfiltered twin, a serve.filters=False server refuses a filtered
    frame; a trial of FILT_TRIAL_S at FILT_QPS of phase 16's mix with the
    arms as filter scenarios, with and without the hot set (the client's
    p50/p95/p99, the card's busy share), then restage_hot; (e) phase
    14(a)'s 100,000 int8 rows copied into a store stamped 0 under a PQ
    index of its knobs, init_attrs() (its shards then read as all-zero
    words), FILT_APPEND pages of phase 4's grown corpus appended with
    attrs=pack_word(lang=FILT_LANG) (FILT_TOMBSTONED base pages deleted),
    IVFIndex.update through refresh() under a service: lang==FILT_LANG
    returns appended rows only on the exact and the index path, and
    compaction carries every live row's word; (f) K1 launched 4 times
    every encode, all on the tensor cores, nothing else. The phase's
    seconds beside FILT_BUDGET_S."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus
    from dnn_page_vectors_tpu_torch.index.attrs import Predicate, pack_word
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    from dnn_page_vectors_tpu_torch.infer import transport
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.server import SearchServer
    from dnn_page_vectors_tpu_torch.infer.transport import (
        RemoteError, SocketSearchClient)
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.loadgen import make_workload, run_trial
    from dnn_page_vectors_tpu_torch.maintenance import compact_store
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.updates import append_corpus
    import gc

    t_phase = time.perf_counter()
    gc.collect()
    gc.freeze()
    corpus, q_tok, p_tok = data
    big_dir = os.path.join(workdir, "ivf_big_pq")
    base = {"data.num_pages": N_PAGES, "eval.store_shard_size": 65_536,
            "eval.embed_batch_size": 512, "model.attention": "flash",
            "eval.store_dtype": "int8", "serve.pq_m": IVF_PQ_M,
            "serve.query_cache_size": SERVE_CACHE,
            "obs.window_s": FILT_TRIAL_S}

    def config(**kw):
        return get_config("bert_mini_v5p16", {**base, **{
            f"serve.{k}": v for k, v in kw.items()}})
    cfg = config()
    m = cfg.model
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    encodes = count_encodes(emb)
    store = VectorStore(big_dir)
    words = np.concatenate([store.load_attrs(e) for e in store.shards()])
    if not (store.attrs_enabled and np.array_equal(
            words, filter_words(0, IVF_BIG_ROWS))):
        raise AssertionError("phase 14(b)'s store does not carry the "
                             "filtered protocol's words")
    preds = {name: None if text is None else Predicate.parse(text)
             for name, text in FILT_ARMS}
    keep = {name: (np.ones(words.shape, bool) if p is None
                   else p.matches(words)) for name, p in preds.items()}
    queries = [corpus.query_text(int(i)) for i in np.linspace(
        0, N_PAGES - 1, FILT_QUERIES).astype(np.int64)]
    rec = {"phase": "filtered", "config": cfg.name, **widths(cfg),
           "store_rows": store.num_vectors, "store_dtype": "int8",
           "queries": FILT_QUERIES, "arms": {n: t for n, t in FILT_ARMS},
           "selectivity": {n: float(k.mean()) for n, k in keep.items()}}
    services, servers, clients = [], [], []

    def service(c, directory=big_dir, corp=corpus, **kw):
        svc = SearchService(c, emb, corp, VectorStore(directory), **kw)
        services.append(svc)
        return svc

    def serve(svc):
        svc.start_batcher()
        server = SearchServer(svc, executor_workers=SERVE_LOAD_WORKERS)
        server.start_background()
        servers.append(server)
        client = SocketSearchClient(server.host, server.port)
        clients.append(client)
        return server, client

    torch.cuda.synchronize()
    reset_counts()
    try:
        # ---- the main path, counted (a)-(e) ---------------------------
        # (a) filtered exact
        t0 = time.perf_counter()
        svc = service(cfg)
        rec["a_open_s"] = time.perf_counter() - t0
        if not (svc.preloaded and svc.pages.shape[0] == IVF_BIG_ROWS):
            raise AssertionError("the 1M-row store is not staged")
        exact, a_rec = {}, {}
        qv = None
        for name, text in FILT_ARMS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = svc.search_many(queries, k=10, filters=text)
            torch.cuda.synchronize()
            many_ms = (time.perf_counter() - t0) * 1e3
            if qv is None:
                qv = svc._embed_queries_cached(svc._view, queries)
                qv_host = qv[:FILT_QUERIES].float().cpu().numpy()
            raw_s, raw_i, scan = svc._topk_view(
                svc._view, qv_host, FILT_QUERIES, 10, None,
                predicate=preds[name])
            fmt = [svc._format(raw_s[i], raw_i[i])
                   for i in range(FILT_QUERIES)]
            if fmt != res:
                raise AssertionError(f"phase 19 (a) {name}: search_many "
                                     "differs from its own top-k")
            plain_s, plain_i = plain_filtered_topk(
                svc, qv[:FILT_QUERIES], keep[name][svc.page_ids])
            ties = ties_only(raw_s, raw_i, plain_s, plain_i,
                             f"phase 19 (a) {name} vs the plain post-filter")
            if not all(keep[name][int(r["page_id"])] for hits in res
                       for r in hits) or any(len(h) != 10 for h in res):
                raise AssertionError(f"phase 19 (a) {name}: a result "
                                     "misses the predicate or k")
            exact[name] = (raw_s, raw_i)
            a_rec[name] = {"search_many_ms": many_ms, "scan_bytes": scan,
                           "tie_rows_vs_plain": ties}
        for name in a_rec:
            a_rec[name]["scan_share"] = (a_rec[name]["scan_bytes"]
                                         / a_rec["none"]["scan_bytes"])
        if a_rec["s10"]["scan_share"] > 0.3:
            raise AssertionError(f"phase 19 (a): the s10 arm scanned "
                                 f"{a_rec['s10']['scan_share']:.3f}x the "
                                 "unfiltered bytes, over 0.3x")
        ev = svc.registry.events("filtered_query")
        rec["a_exact"] = {**a_rec, "filtered_query_events": len(ev),
                          "at_s": time.perf_counter() - t_phase}
        emit({"phase": "filtered_a_exact", **rec["a_exact"]})

        # (b) the predicate through the index
        idx = IVFIndex.open(VectorStore(big_dir), device=device)
        curves = {}
        for name, text in FILT_ARMS:
            curve = {}
            for nprobe in IVF_NPROBES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, i, st = idx.search(qv_host, 10, nprobe=nprobe,
                                      predicate=preds[name])
                secs = time.perf_counter() - t0
                want = exact[name][1]
                recall = float(np.mean([
                    len(set(g[g >= 0].tolist()) & set(w[w >= 0].tolist()))
                    / max(1, int((w >= 0).sum())) for g, w in zip(i, want)]))
                if not keep[name][i[i >= 0]].all():
                    raise AssertionError(f"phase 19 (b) {name}: a result "
                                         "misses the predicate")
                curve[str(nprobe)] = {
                    "recall_vs_filtered_exact_at_10": recall,
                    "seconds": secs, "filled": float((i >= 0).mean()),
                    "gather_bytes_per_query": st["gather_bytes"]
                    / FILT_QUERIES,
                    "filter_escalations": st.get("filter_escalations", 0)}
            curves[name] = curve
        full = {}
        n_chk = FILT_CHECK_QUERIES
        for name, text in FILT_ARMS:
            if text is None:
                continue
            s, i, st = idx.search(qv_host[:n_chk], 10, nprobe=idx.nlist,
                                  rerank=int(keep[name].sum()),
                                  predicate=preds[name])
            full[name] = ties_only(s, i, exact[name][0][:n_chk],
                                   exact[name][1][:n_chk],
                                   f"phase 19 (b) {name} full probe")
        s1_8 = curves["s1"]["8"]
        if s1_8["filled"] != 1.0:
            raise AssertionError(f"phase 19 (b): s1 at nprobe 8 left k "
                                 f"short: {s1_8}")
        _, i1, st1 = idx.search(qv_host, 10, nprobe=1,
                                predicate=preds["s1"])
        if not (st1.get("filter_escalations", 0) > 0 and (i1 >= 0).all()):
            raise AssertionError(f"phase 19 (b): s1 at nprobe 1 did not "
                                 f"escalate to k: {st1}")
        rec["b_ivf"] = {"nlist": idx.nlist, "pq_m": idx.pq_m,
                        "recall": curves,
                        "full_probe_tie_rows": full,
                        "full_probe_queries": n_chk,
                        "s1_nprobe1_escalations": st1["filter_escalations"],
                        "at_s": time.perf_counter() - t_phase}
        emit({"phase": "filtered_b_ivf", **rec["b_ivf"]})

        # (c) the hot posting set
        hot_idx = IVFIndex.open(VectorStore(big_dir), device=device)
        t0 = time.perf_counter()
        summary = hot_idx.stage_hot(FILT_HOT_BUDGET)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        if not 0 < summary["hot_lists"] < hot_idx.nlist:
            raise AssertionError(f"phase 19 (c): {summary}")
        c_rec = {"summary": summary, "stage_s": stage_s,
                 "staged_bytes_on_card": hot_bytes_on_card(hot_idx)}
        for name, text in FILT_ARMS:
            for nprobe in (8, 32):
                s, i, st = hot_idx.search(qv_host, 10, nprobe=nprobe,
                                          predicate=preds[name])
                ms, mi, mst = idx.search(qv_host, 10, nprobe=nprobe,
                                         predicate=preds[name])
                ties = ties_only(s, i, ms, mi, f"phase 19 (c) {name} "
                                 f"nprobe {nprobe}: hot vs mmap")
                if not (st["gather_bytes"] < mst["gather_bytes"]
                        and st.get("hot_rows_scored", 0) > 0):
                    raise AssertionError(f"phase 19 (c) {name}: hot {st} "
                                         f"vs mmap {mst}")
                c_rec[f"{name}_nprobe{nprobe}"] = {
                    "tie_rows": ties,
                    "gather_bytes_per_query": st["gather_bytes"]
                    / FILT_QUERIES,
                    "mmap_gather_bytes_per_query": mst["gather_bytes"]
                    / FILT_QUERIES,
                    "hot_rows_scored_per_query": st["hot_rows_scored"]
                    / FILT_QUERIES}
        # one query at nprobe 8 (the serving shape at low load), hot
        # against mmap: the hot half scores every staged row of the set
        # (masked to the probed lists), the mmap half the probed lists'
        for name, index in (("hot", hot_idx), ("mmap", idx)):
            ms = []
            for j in range(SERVE_LONE_QUERIES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                index.search(qv_host[j % FILT_QUERIES][None], 10, nprobe=8)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            c_rec[f"one_query_ms_{name}"] = {
                "p50": float(np.percentile(ms, 50)),
                "p95": float(np.percentile(ms, 95))}
        # a burst of searches of the same queries, then a restage: the
        # lists they probe are the popular ones now
        for _ in range(8):
            hot_idx.search(qv_host, 10, nprobe=8)
        counts = hot_idx.scan_counts.copy()
        restaged = hot_idx.stage_hot(FILT_HOT_BUDGET)
        res = hot_idx._hot["lists"]
        if not (restaged["hot_by_popularity"]
                and counts[res].mean() > counts[~res].mean()):
            raise AssertionError(f"phase 19 (c): the restage {restaged}")
        c_rec.update({"restaged": restaged,
                      "probes_per_resident_list": float(counts[res].mean()),
                      "probes_per_other_list": float(counts[~res].mean()),
                      "at_s": time.perf_counter() - t_phase})
        rec["c_hot"] = c_rec
        emit({"phase": "filtered_c_hot", **c_rec})
        del idx, hot_idx

        # (d) through the service and the socket
        gb = FILT_HOT_BUDGET / 2 ** 30
        t0 = time.perf_counter()
        hot_svc = service(config(index="ivf", result_cache=True,
                                 hot_postings_gb=gb))
        d_rec = {"open_hot_s": time.perf_counter() - t0,
                 "hot_rows": hot_svc.metrics()["ann_index"]["hot_rows"]}
        cold_svc = service(config(index="ivf", result_cache=True))
        if not (d_rec["hot_rows"] > 0
                and cold_svc.metrics()["ann_index"]["hot_rows"] == 0):
            raise AssertionError(f"phase 19 (d): the services' hot rows "
                                 f"{d_rec['hot_rows']}")
        _, hot_client = serve(hot_svc)
        _, cold_client = serve(cold_svc)
        for name, text in FILT_ARMS:
            want_s, want_i = hot_svc.topk_vectors(qv_host[:16], k=10,
                                                  filters=text)
            got_s, got_i, _ = hot_client.topk_vectors(qv_host[:16], k=10,
                                                      filters=text)
            local = hot_svc.search(queries[0], k=10, filters=text)
            remote = hot_client.search(queries[0], k=10, filters=text)
            if not (np.array_equal(got_i, want_i)
                    and np.array_equal(got_s, want_s)
                    and [r["page_id"] for r in remote]
                    == [r["page_id"] for r in local]):
                raise AssertionError(f"phase 19 (d) {name}: the socket "
                                     "differs from in-process search")
        q = queries[1]
        hot_svc.clear_cache()
        unfiltered = hot_svc.search(q, k=10)
        filtered = hot_svc.search(q, k=10, filters="lang==1")
        again = hot_svc.search(q, k=10, filters=" lang == 1 ")
        slots = {key[5] for key in hot_svc._rcache}
        if not (any(r["page_id"] % 2 == 0 for r in unfiltered)
                and all(r["page_id"] % 2 == 1 for r in filtered)
                and again == filtered and slots == {"", "lang==1"}):
            raise AssertionError("phase 19 (d): the result cache crossed "
                                 "the filter boundary")
        off_svc = service(config(filters=False), preload_hbm_gb=0.0)
        off_server, off_client = serve(off_svc)
        try:
            off_client.search(q, k=10, filters="lang==1")
            raise AssertionError("phase 19 (d): a client sent a filtered "
                                 "query to a serve.filters=False server")
        except RemoteError:
            pass
        raw = socket.create_connection((off_server.host, off_server.port),
                                       timeout=30)
        transport.write_frame(raw, transport.T_QUERY, transport.encode_query(
            1, [q], k=10, filters="lang==1"))
        ftype, body = transport.read_frame(raw)
        raw.close()
        if ftype != transport.T_ERROR or off_svc._m_requests.value:
            raise AssertionError("phase 19 (d): a serve.filters=False "
                                 "server served a filtered frame")
        distinct = [corpus.query_text(i) for i in range(SERVE_DISTINCT)]

        def workload():
            return make_workload("poisson", seed=SERVE_SEED,
                                 distinct=SERVE_DISTINCT, alpha=SERVE_ALPHA,
                                 profile=((10, None, 1.0),),
                                 filter_scenarios=FILT_SCENARIOS)
        trials = {}
        for name, tsvc, client in (("hot", hot_svc, hot_client),
                                   ("mmap", cold_svc, cold_client)):
            tsvc.clear_cache()
            tr, busy = busy_share(lambda: run_trial(
                tsvc, workload(), FILT_QPS, distinct,
                duration_s=FILT_TRIAL_S, warmup_s=SERVE_WARMUP_S,
                workers=SERVE_LOAD_WORKERS, client=client))
            if tr["errors"] or tr["requests_sent"] == 0:
                raise AssertionError(f"phase 19 (d) {name} trial: {tr}")
            trials[name] = {**trial_line(tr, busy),
                            "scenarios": tr.get("filter_scenarios")}
            emit({"phase": f"filtered_d_trial_{name}", **trials[name]})
        out = hot_svc.restage_hot()
        if not (out.get("hot_by_popularity")
                and hot_svc.registry.events("hot_restaged")):
            raise AssertionError(f"phase 19 (d): restage_hot gave {out}")
        d_rec.update({"trials": trials, "restage_hot": out,
                      "socket_equal_in_process": True,
                      "result_cache_slots": sorted(slots),
                      "filters_off_refused": True,
                      "at_s": time.perf_counter() - t_phase})
        rec["d_service"] = d_rec
        for client in clients:
            client.close()
        for server in servers:
            server.close()
        for s_ in services:
            s_.close()
        clients, servers, services = [], [], []

        # (e) appends, the IVF update and compaction
        t0 = time.perf_counter()
        src = VectorStore(os.path.join(workdir, "ivf_int8"))
        udir = os.path.join(workdir, "filtered_updates")
        ust = VectorStore(udir, dim=m.out_dim, shard_size=65_536,
                          dtype="int8")
        ust.ensure_model_step(0)
        for e in src.shards():
            ids, codes, scl = src._load_entry(e, raw=True)
            ust.write_shard(e["index"], ids, codes=np.asarray(codes),
                            scales=np.asarray(scl))
        n0 = ust.num_vectors
        IVFIndex.build_from_config(ust, get_config("bert_mini_v5p16", {
            **base, "data.num_pages": n0}), device=device)
        ust = VectorStore(udir)
        ust.init_attrs()
        e_rec = {"base_rows": n0, "setup_s": time.perf_counter() - t0}
        grown = KeptTexts(build_corpus(data_config("bert_mini_v5p16",
                                                   n0 + FILT_APPEND)))
        ucfg = get_config("bert_mini_v5p16", {
            **base, "data.num_pages": n0 + FILT_APPEND,
            "serve.index": "ivf"})
        usvc = service(ucfg, directory=udir, corp=grown)
        word = pack_word(lang=FILT_LANG)
        t0 = time.perf_counter()
        app = append_corpus(emb, grown, VectorStore(udir), start=n0,
                            stop=n0 + FILT_APPEND,
                            tombstone=range(FILT_TOMBSTONED), attrs=word)
        e_rec["append_s"] = time.perf_counter() - t0
        info = usvc.refresh()
        upd = info.get("index_update") or {}
        if upd.get("action") != "incremental" or "index_error" in info:
            raise AssertionError(f"phase 19 (e): the refresh {info}")
        lq = [grown.query_text(int(i)) for i in np.linspace(
            n0, n0 + FILT_APPEND - 1, 16).astype(np.int64)]
        text = f"lang=={FILT_LANG}"
        uexact = service(get_config("bert_mini_v5p16", {
            **base, "data.num_pages": n0 + FILT_APPEND}), directory=udir,
            corp=grown)
        for path, s_ in (("index", usvc), ("exact", uexact)):
            out = s_.search_many(lq, k=10, filters=text)
            if not all(len(h) == 10 and all(
                    n0 <= r["page_id"] < n0 + FILT_APPEND for r in h)
                    for h in out):
                raise AssertionError(f"phase 19 (e) {path}: {text} "
                                     "returned a row that was not appended")
        for s_ in services:
            s_.close()
        services = []

        def words_by_id(st) -> dict:
            out = {}
            for e in st.shards():
                for pid, w in zip(st.load_ids(e), st.load_attrs(e)):
                    if pid >= 0:
                        out[int(pid)] = int(w)
            return out
        before = words_by_id(VectorStore(udir))
        want = {i: (word if i >= n0 else 0) for i in range(n0 + FILT_APPEND)
                if i >= FILT_TOMBSTONED}
        t0 = time.perf_counter()
        stats = compact_store(VectorStore(udir))
        e_rec["compact_s"] = time.perf_counter() - t0
        after = words_by_id(VectorStore(udir))
        if not (stats.get("action") == "compacted" and before == want
                and after == want):
            raise AssertionError(f"phase 19 (e): the words before and after "
                                 f"compaction ({stats.get('action')})")
        e_rec.update({"appended": app["appended"],
                      "tombstoned": app["tombstoned"],
                      "refresh_seconds": info["refresh_seconds"],
                      "index_update": upd,
                      "compaction_rows": stats["rows"],
                      "dead_rows_dropped": stats["dead_rows_dropped"],
                      "words_carried": len(after),
                      "at_s": time.perf_counter() - t_phase})
        rec["e_updates"] = e_rec
        emit({"phase": "filtered_e_updates", **e_rec})
        torch.cuda.synchronize()
        counts = launch_counts()
        # ----------------------------------------------------------------
    finally:
        for client in clients:
            client.close()
        for server in servers:
            server.close()
        for s_ in services:
            s_.close()
    # (f) K1 4 times every encode, all on the tensor cores, nothing else
    want = expected_launches((encodes["page"] + encodes["query"])
                             * m.num_layers, 0)
    if counts != want:
        raise AssertionError(f"phase 19 launched {counts}, want {want} "
                             f"({encodes})")
    torch.cuda.empty_cache()
    gc.unfreeze()
    seconds = time.perf_counter() - t_phase
    rec.update({"page_encodes": encodes["page"],
                "query_encodes": encodes["query"],
                "k1_launches": counts["launches"],
                "k1_launches_tensor_core": counts["launches_tc"],
                "seconds": seconds, "budget_s": FILT_BUDGET_S,
                "over_budget": seconds > FILT_BUDGET_S,
                "device": torch.cuda.get_device_name(0),
                "nvidia_smi": nvidia_smi()})
    emit({k: v for k, v in rec.items()
          if k not in ("a_exact", "b_ivf", "c_hot", "d_service",
                       "e_updates")})
    return rec


# the bool template flags of each templated kernel, in order
# -- phase 20: partitioned and replicated serving ---------------------------

class RecordingClient:
    """A SocketSearchClient that keeps every (query, answer) it returns,
    for the per-request oracle of phase 20 (c)."""

    def __init__(self, client):
        self._client = client
        self._lock = threading.Lock()
        self.answers: list = []

    def search(self, query, k=None, nprobe=None, **kw):
        out = self._client.search(query, k=k, nprobe=nprobe, **kw)
        with self._lock:
            self.answers.append((query, out))
        return out

    def __getattr__(self, name):
        return getattr(self._client, name)


def same_results(got, want) -> bool:
    """serve_results_equal as a predicate: socket answers (scores as
    sent) against formatted ones (scores rounded to 4 decimals)."""
    got = [[{"page_id": r["page_id"], "score": round(float(r["score"]), 4)}
            for r in hits] for hits in got]
    try:
        serve_results_equal(got, want, "")
    except AssertionError:
        return False
    return True


def view_tensors(view) -> list:
    """Every tensor a serving view holds: its staged rows, scales, dead
    mask and buffers, its index's centroids and hot set."""
    out = [t for t in (view.pages, view.scales, view.alive, view.buf,
                       view.scale_buf) if t is not None]
    idx = view.index
    if idx is not None:
        if idx._dev_centroids is not None:
            out.append(idx._dev_centroids)
        if idx._hot is not None:
            out += [idx._hot[key] for key in ("codes", "cent", "attrs")]
    return out


def staged_bytes(view) -> int:
    """The bytes a view holds on the card (staged rows with their scales
    and dead mask, or its index's hot set)."""
    return sum(t.numel() * t.element_size() for t in (
        view.pages, view.scales, view.alive) if t is not None) + (
        hot_bytes_on_card(view.index) if view.index is not None
        and view.index._hot is not None else 0)


def partition_record(svc) -> dict:
    """A partitioned service's table: each view's rows, staged bytes,
    device and stream, and its partition's spec."""
    pset = svc.partition_set
    views = []
    for spec, row in zip(pset.specs(), pset.table()):
        for rid, view in enumerate(row):
            rep = pset._parts[spec.pid][rid]
            views.append({"partition": spec.pid, "replica": rid,
                          "shards": list(spec.shard_indices),
                          "rows": spec.rows, "hot_gb": spec.hot_gb,
                          "staged_bytes": staged_bytes(view),
                          "own_stream": rep.stream is not None})
    return {"partitions": pset.partitions, "replicas": pset.replicas,
            "views": views,
            "staged_bytes": sum(v["staged_bytes"] for v in views)}


def require_on_card(svc, what: str) -> int:
    """Every tensor of every view of the service lies on the card."""
    views = ([v for row in svc.partition_set.table() for v in row]
             if svc.partition_set is not None else [svc._view])
    n = 0
    for view in views:
        for t in view_tensors(view):
            if t.device.type != "cuda":
                raise AssertionError(f"{what}: a view holds a tensor on "
                                     f"{t.device}")
            n += 1
    return n


def restage_probe(svc, qv: torch.Tensor, log: list):
    """Wraps the service's _build_view so that while each replica is
    marked restaging one scatter of `qv` runs before the view is built:
    a query routed during the restage, its ids and seconds kept in `log`
    (the build's own seconds beside them). Returns the undo."""
    orig = svc._build_view

    def build(*args, **kwargs):
        t0 = time.perf_counter()
        _, ids = svc.topk_vectors(qv, k=10)
        t1 = time.perf_counter()
        view = orig(*args, **kwargs)
        log.append({"ids": ids, "probe_s": t1 - t0,
                    "build_s": time.perf_counter() - t1})
        return view
    svc._build_view = build
    return lambda: delattr(svc, "_build_view")


def run_partitioned(device, data, workdir: str, production: dict,
                    serving: dict) -> dict:
    """Phase 20: partitioned and replicated serving in one process
    (infer/partition.py) on config 3's towers (phase 4's weights and
    vocab). (a) PART_P x PART_R over phase 15's store staged whole, every
    replica a view of its own: PART_QUERIES corpus queries through
    search_many and topk_vectors against the single view (ids equal
    except at ties, scores within 1e-5), through a SearchServer and a
    SocketSearchClient, simulate()'s partition, merge and critical-path
    seconds beside the single view's top-k, and each partition's
    scan_bytes its rows' bytes, summing to the single view's; (b)
    PART_IVF_P x 1 through the IVF-PQ index over phase 14(b)'s 1M-row
    int8 store with phase 19's hot-set budget cut by rows: at nprobe 8
    against the single-view index (no row worse, rows equal counted;
    with every probed candidate re-ranked, equal except at ties), full
    probe with a full re-rank equal to exact search, the staged hot bytes
    summing to at most the budget; (c) a trial of phase 16's mix at
    PART_QPS over the socket (P x R, on a copy of the store) holding a
    generation that tombstones every page of the trial queries' top-10s
    and refresh(): every answer the old table's or the new one's, sheds
    while replicas restage (one probe scatter held inside each restage),
    swap_ms and each replica's restage seconds; then at R=1 the old views
    answer until the publish; (d) replica_shed_queue=0 under a burst:
    sheds, answers unchanged; (e) one find_qps_at_p99 at the client's p99
    <= 50 ms, cache off, beside phase 16's P=1 rate, with the card's busy
    share of one trial; (f) K1 launched 4 times an encode the services
    dispatched, all on the tensor cores, the same per query as at P=1;
    (g) every view's tensors on the card, the phase's seconds beside
    PART_BUDGET_S."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.server import SearchServer
    from dnn_page_vectors_tpu_torch.infer.transport import SocketSearchClient
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.loadgen import (
        find_qps_at_p99, make_workload, run_trial)
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    import gc
    import shutil

    t_phase = time.perf_counter()
    gc.collect()
    gc.freeze()
    corpus4, q_tok, p_tok = data
    path = production["corpus_path"]
    corpus = JsonlCorpus(path)
    prod_dir = os.path.join(workdir, "store_production")
    big_dir = os.path.join(workdir, "ivf_big_pq")

    def config(partitions=1, replicas=1, cache=0, **serve):
        return get_config("bert_mini_v5p16", {
            "data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
            "model.attention": "flash", "serve.query_cache_size": cache,
            "serve.partitions": partitions, "serve.replicas": replicas,
            "obs.window_s": PART_RATE_TRIAL_S,
            **{f"serve.{k}": v for k, v in serve.items()}})
    cfg = config()
    m = cfg.model
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    encodes = count_encodes(emb)
    queries = corpus.query_texts(np.linspace(
        0, PROD_PAGES - 1, PART_QUERIES).astype(np.int64))
    distinct = corpus.query_texts(range(SERVE_DISTINCT))
    rec = {"phase": "partitioned", "config": cfg.name, **widths(cfg),
           "store_vectors": PROD_PAGES, "partitions": PART_P,
           "replicas": PART_R, "queries": PART_QUERIES}
    services, servers, clients = [], [], []

    def service(c, directory=prod_dir, corp=corpus):
        svc = SearchService(c, emb, corp, VectorStore(directory))
        services.append(svc)
        return svc

    def serve(svc):
        svc.start_batcher()
        server = SearchServer(svc, executor_workers=SERVE_LOAD_WORKERS)
        server.start_background()
        servers.append(server)
        client = SocketSearchClient(server.host, server.port)
        clients.append(client)
        return client

    def close(*svcs):
        for svc in svcs:
            svc.close()
        torch.cuda.empty_cache()

    def workload():
        return make_workload("poisson", seed=SERVE_SEED,
                             distinct=SERVE_DISTINCT, alpha=SERVE_ALPHA,
                             profile=((10, None, 1.0),))

    def k1_delta(fn):
        before = fa.launches
        out = fn()
        torch.cuda.synchronize()
        return out, fa.launches - before

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        # ---- the main path, counted (a)-(e) ---------------------------
        # (a) exact, P x R over the store staged whole, against one view
        single = service(config())
        t0 = time.perf_counter()
        part = service(config(PART_P, PART_R))
        stage_s = time.perf_counter() - t0
        pset = part.partition_set
        table = partition_record(part)
        if (pset.partitions, pset.replicas) != (PART_P, PART_R) or \
                sum(s.rows for s in pset.specs()) != PROD_PAGES:
            raise AssertionError(f"phase 20 (a): the partition set is "
                                 f"{table}")
        emit({"phase": "partitioned_a_views", **table,
              "stage_s": stage_s, "peak_gb": torch.cuda.max_memory_allocated()
              / 1e9})
        times, results = {}, {}
        for name, svc in (("single", single), ("partitioned", part)):
            svc.search_many(queries[:8], k=10)       # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[name], k1 = k1_delta(
                lambda: svc.search_many(queries, k=10))
            times[name] = {"search_many_ms":
                           (time.perf_counter() - t0) * 1e3,
                           "k1_launches": k1}
        if times["single"]["k1_launches"] != \
                times["partitioned"]["k1_launches"]:
            raise AssertionError(f"phase 20 (f): K1 launches per query "
                                 f"differ with partitions: {times}")
        ties_many = serve_results_equal(
            results["partitioned"], results["single"],
            "phase 20 (a) search_many vs the single view")
        qv = single.encode_queries(queries)[:PART_QUERIES]
        s1, i1, scan1 = single._topk_view(single._view, qv, PART_QUERIES,
                                          10)
        sp, ip = part.topk_vectors(qv, k=10)
        ties_raw = ties_only(sp, ip, s1, i1,
                             "phase 20 (a) topk_vectors vs the single view")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single._topk_view(single._view, qv, PART_QUERIES, 10)
        single_topk_s = time.perf_counter() - t0
        sim = pset.simulate(qv, PART_QUERIES, 10)
        ties_only(sim["scores"], sim["ids"], s1, i1,
                  "phase 20 (a) simulate vs the single view")
        row_bytes = single.store.row_bytes
        want_scan = [s.rows * row_bytes for s in pset.specs()]
        if sim["scan_bytes"] != want_scan or sum(want_scan) != scan1:
            raise AssertionError(f"phase 20 (a): scan bytes "
                                 f"{sim['scan_bytes']}, want {want_scan} "
                                 f"summing to {scan1}")
        client = serve(part)
        wire, local = [], []
        for q in queries[:PART_SOCKET_QUERIES]:
            wire.append(client.search(q, k=10))
            local.append(single.search(q, k=10))
        if not all(same_results([w], [x]) for w, x in zip(wire, local)):
            raise AssertionError("phase 20 (a): the socket's answers differ "
                                 "from the single view's")
        rec["a_exact"] = {
            **times, "stage_s": stage_s, "tie_rows_search_many": ties_many,
            "tie_rows_topk": ties_raw,
            "single_topk_s": single_topk_s,
            "partition_seconds": sim["partition_seconds"],
            "merge_seconds": sim["merge_seconds"],
            "critical_path_seconds": sim["critical_path_seconds"],
            "scan_bytes": sim["scan_bytes"], "single_scan_bytes": scan1,
            "socket_queries": PART_SOCKET_QUERIES,
            "socket_equal_to_single": True,
            "staged_bytes": table["staged_bytes"],
            "staged_bytes_by_view": [v["staged_bytes"]
                                     for v in table["views"]],
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "partitioned_a_exact", **rec["a_exact"]})

        # (e) the rate at the client's p99 <= 50 ms, cache off, P x R,
        # after a short profiled trial at the first rate: it warms the
        # service under load (a first load trial can stall its queue,
        # PERF.md section 6) and gives the card's busy share
        t0 = time.perf_counter()
        warm, busy = busy_share(lambda: run_trial(
            part, workload(), PART_START_QPS, distinct,
            duration_s=SERVE_WARM_S, warmup_s=SERVE_WARMUP_S,
            workers=SERVE_LOAD_WORKERS, client=client))
        collected = {}
        with gc_seconds(collected):
            rep = find_qps_at_p99(
                part, workload(), distinct, p99_target_ms=SERVE_P99_MS,
                start=PART_START_QPS, max_load=SERVE_MAX_QPS,
                iters=SERVE_ITERS, duration_s=PART_RATE_TRIAL_S,
                warmup_s=SERVE_WARMUP_S, workers=SERVE_LOAD_WORKERS,
                max_error_rate=SERVE_MAX_ERROR_RATE, client=client,
                p99_key="client_p99_ms")
        trials = [trial_line(t) for t in rep["trials"]]
        if len(trials) > SERVE_MAX_TRIALS:
            raise AssertionError(f"phase 20 (e): {len(trials)} trials")
        best = max((t for t in rep["trials"] if t["met"]),
                   key=lambda t: t["achieved_qps"], default=None)
        p1 = serving["d_load"]["off"]
        rec["e_rate"] = {
            "qps_at_p99": rep["qps_at_p99"], "target_met": best is not None,
            "p99_target_ms": SERVE_P99_MS, "p99_judged_on": "client_p99_ms",
            "trials": trials, "at_rate": trial_line(best) if best else None,
            "warm_trial": trial_line(warm, busy),
            "card_busy_share_at_start_qps": busy,
            "search_gc_s": collected["gc_s"],
            "search_gc_full": collected["gc_full"],
            "phase16_p1_qps_at_p99": p1["qps_at_p99"],
            "phase16_p1_qps_at_p99_runs": p1["qps_at_p99_runs"],
            "replica_shed": part.replica_shed,
            "seconds": time.perf_counter() - t0,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "partitioned_e_rate", **rec["e_rate"]})
        rec["a_exact"]["routing"] = part.metrics()["partitions"]
        for c in clients:
            c.close()
        for s in servers:
            s.close()
        clients.clear()
        servers.clear()
        rec["on_card_tensors"] = require_on_card(part, "phase 20 (a)")
        close(single, part)

        # (b) the IVF-PQ index, P x 1, phase 19's hot budget cut by rows
        big = {"data.num_pages": N_PAGES, "eval.store_shard_size": 65_536,
               "eval.store_dtype": "int8", "serve.pq_m": IVF_PQ_M}

        def ivf_config(partitions, **serve):
            return get_config("bert_mini_v5p16", {
                **big, "model.attention": "flash",
                "serve.query_cache_size": 0, "serve.index": "ivf",
                "serve.nprobe": 8, "serve.partitions": partitions,
                **{f"serve.{k}": v for k, v in serve.items()}})
        hot_gb = FILT_HOT_BUDGET / 2 ** 30
        secs = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            return out
        ivf1, ivfp = timed("open_s", lambda: (
            service(ivf_config(1, hot_postings_gb=hot_gb), big_dir, corpus4),
            service(ivf_config(PART_IVF_P, hot_postings_gb=hot_gb), big_dir,
                    corpus4)))
        bq = [corpus4.query_text(int(i)) for i in np.linspace(
            0, N_PAGES - 1, PART_QUERIES).astype(np.int64)]
        bqv = ivf1.encode_queries(bq)[:PART_QUERIES]
        hot = [rep.view.index._hot for rep in
               (reps[0] for reps in ivfp.partition_set._parts)]
        hot_booked = sum(h["bytes"] for h in hot if h is not None)
        if not 0 < hot_booked <= FILT_HOT_BUDGET:
            raise AssertionError(f"phase 20 (b): the partitions staged "
                                 f"{hot_booked} B of a {FILT_HOT_BUDGET} B "
                                 "budget")
        s1, i1 = timed("single_s", lambda: ivf1.topk_vectors(
            bqv, k=10, nprobe=8))
        sp, ip = timed("partitioned_s", lambda: ivfp.topk_vectors(
            bqv, k=10, nprobe=8))
        worse = ((sp < s1 - SWEEP_SCORE_TOL) & np.isfinite(s1)).any(axis=1)
        if worse.any():
            raise AssertionError(f"phase 20 (b): {int(worse.sum())} rows "
                                 "rank worse than the single-view index")
        same_rows = sum(
            set(a.tolist()) == set(b.tolist())
            or np.abs(x - y).max() <= TIE_SCORE_TOL
            for a, b, x, y in zip(ip, i1, sp, s1))
        if ivfp.ann_fallbacks or ivf1.ann_fallbacks:
            raise AssertionError("phase 20 (b): an exact fallback on the "
                                 "index path")
        hot_on_card = sum(hot_bytes_on_card(rep.view.index)
                          for reps in ivfp.partition_set._parts
                          for rep in reps if rep.view.index._hot)
        b_table = partition_record(ivfp)
        nlist = ivf1.index.nlist
        # a re-rank depth that keeps every candidate of 8 probed lists,
        # and one that keeps every row of a partition
        r8 = int(np.sort(ivf1.index.list_sizes)[-8:].sum())
        r_part = max(s.rows for s in ivfp.partition_set.specs())
        rec["on_card_tensors"] += require_on_card(ivfp, "phase 20 (b)")
        close(ivf1, ivfp)
        exact = service(get_config("bert_mini_v5p16", {
            **big, "model.attention": "flash",
            "serve.query_cache_size": 0}), big_dir, corpus4)
        ex_s, ex_i = timed("exact_s", lambda: exact.topk_vectors(bqv, k=10))
        close(exact)

        def recall(ids):
            return float(np.mean([len(set(g.tolist()) & set(w.tolist()))
                                  / 10 for g, w in zip(ids, ex_i)]))
        all1 = service(ivf_config(1, pq_rerank=r8), big_dir, corpus4)
        allp = service(ivf_config(PART_IVF_P, pq_rerank=r8), big_dir,
                       corpus4)
        a1 = timed("every_candidate_single_s",
                   lambda: all1.topk_vectors(bqv, k=10, nprobe=8))
        ap = timed("every_candidate_partitioned_s",
                   lambda: allp.topk_vectors(bqv, k=10, nprobe=8))
        ties_all8 = ties_only(*ap, *a1, "phase 20 (b) nprobe 8, every "
                              "candidate re-ranked, vs the single view")
        close(all1, allp)
        nck = PART_FULL_PROBE_QUERIES
        fullp = service(ivf_config(PART_IVF_P, pq_rerank=r_part), big_dir,
                        corpus4)
        fp = timed("full_probe_s", lambda: fullp.topk_vectors(
            bqv[:nck], k=10, nprobe=nlist))
        ties_full = ties_only(*fp, ex_s[:nck], ex_i[:nck],
                              "phase 20 (b) full probe vs exact")
        close(fullp)
        rec["b_ivf"] = {
            "partitions": PART_IVF_P, "nprobe": 8, "nlist": nlist,
            "hot_budget_bytes": FILT_HOT_BUDGET,
            "hot_booked_bytes": hot_booked,
            "hot_booked_by_partition": [h["bytes"] if h else 0 for h in hot],
            "hot_rows_by_partition": [h["rows"] if h else 0 for h in hot],
            "hot_bytes_on_card": hot_on_card,
            "rows_by_partition": [v["rows"] for v in b_table["views"]],
            "rows_equal_to_single_view": int(same_rows),
            "rows_worse_than_single_view": 0,
            "recall_vs_exact": {"single": recall(i1),
                                "partitioned": recall(ip)},
            "rerank_every_candidate": r8,
            "tie_rows_every_candidate_reranked": ties_all8,
            "full_probe_queries": nck, "full_probe_rerank": r_part,
            "tie_rows_full_probe": ties_full, "seconds": secs,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "partitioned_b_ivf", **rec["b_ivf"]})

        # (c) a rolling refresh under load over the socket, on a copy
        cdir = os.path.join(workdir, "store_partitioned")
        t0 = time.perf_counter()
        copy_store(VectorStore(prod_dir), cdir)
        copy_s = time.perf_counter() - t0
        svc = service(config(PART_P, PART_R, cache=SERVE_CACHE), cdir)
        sched = workload().schedule(SERVE_WARMUP_S + PART_MUT_TRIAL_S,
                                    PART_QPS)
        texts = sorted({distinct[r.query_id % len(distinct)]
                        for _, r in sched})
        old = dict(zip(texts, svc.search_many(texts, k=10)))
        dead = sorted({r["page_id"] for hits in old.values() for r in hits})
        probe_qv = svc.encode_queries(texts[:PART_PROBES])[:PART_PROBES]
        _, probe_old = svc.topk_vectors(probe_qv, k=10)
        probes: list = []
        undo = restage_probe(svc, probe_qv, probes)
        rclient = RecordingClient(serve(svc))

        def mutate():
            # a generation of tombstones alone (phase 15's store carries
            # no model stamp, which append_corpus needs)
            t = time.perf_counter()
            VectorStore(cdir).begin_generation(tombstones=dead).commit()
            return time.perf_counter() - t, svc.refresh()
        mut = OneShotMutator("tombstone_refresh", mutate,
                             SERVE_WARMUP_S + PART_FIRE_S)
        tr = run_trial(svc, workload(), PART_QPS, distinct,
                       duration_s=PART_MUT_TRIAL_S, warmup_s=SERVE_WARMUP_S,
                       workers=SERVE_LOAD_WORKERS, client=rclient,
                       mutator=mut)
        mut.join()
        undo()
        if mut.result is None or tr["errors"]:
            raise AssertionError(f"phase 20 (c): the mutation or the trial "
                                 f"failed: {mut.errors}, {tr['errors']} "
                                 "errors")
        append_s, info = mut.result
        new = dict(zip(texts, svc.search_many(texts, k=10)))
        if any(r["page_id"] in set(dead) for h in new.values() for r in h):
            raise AssertionError("phase 20 (c): a dead page served after "
                                 "the refresh")
        verdict = {"old": 0, "new": 0}
        for q, hits in rclient.answers:
            is_old, is_new = same_results([hits], [old[q]]), \
                same_results([hits], [new[q]])
            if not (is_old or is_new):
                raise AssertionError(f"phase 20 (c): a mixed result set "
                                     f"for {q!r}: {hits}")
            verdict["old" if is_old else "new"] += 1
        for p in probes:
            if not np.array_equal(p["ids"], probe_old):
                raise AssertionError("phase 20 (c): a query routed during a "
                                     "restage saw the new generation")
        if svc.replica_shed == 0:
            raise AssertionError("phase 20 (c): no replica shed while the "
                                 "replicas restaged")
        restage = [{"partition": p["partition"], "rows": p["rows"],
                    "restage_ms": p["restage_ms"]} for p in
                   info["partitions"]]
        rec["c_refresh"] = {
            "qps": PART_QPS, "trial_s": PART_MUT_TRIAL_S,
            "copy_store_s": copy_s, "tombstoned": len(dead),
            "generation_s": append_s, "swap_ms": info["swap_ms"],
            "refresh_seconds": info["refresh_seconds"],
            "restage": restage,
            "restage_build_s": [p["build_s"] for p in probes],
            "restage_probe_s": [p["probe_s"] for p in probes],
            "answers": verdict, "distinct_queries": len(texts),
            "replica_shed": svc.replica_shed,
            "shed_events": len(svc.registry.events("replica_shed")),
            "mutation_done_at_s": mut.done_at_s,
            "trial_window_s": SERVE_WARMUP_S + PART_MUT_TRIAL_S,
            "trial": trial_line(tr), "store_generation":
            info["store_generation"], "at_s": time.perf_counter() - t_phase}
        for c in clients:
            c.close()
        for s in servers:
            s.close()
        clients.clear()
        servers.clear()
        rec["on_card_tensors"] += require_on_card(svc, "phase 20 (c)")
        close(svc)
        # R=1: the old views answer until the publish
        svc1 = service(config(PART_P, 1), cdir)
        before = svc1.topk_vectors(probe_qv, k=10)[1]
        probes1: list = []
        undo = restage_probe(svc1, probe_qv, probes1)
        VectorStore(cdir).begin_generation(
            tombstones=sorted(set(before[:, 0].tolist()))).commit()
        info1 = svc1.refresh()
        undo()
        after = svc1.topk_vectors(probe_qv, k=10)[1]
        if not (len(probes1) == PART_P and all(
                np.array_equal(p["ids"], before) for p in probes1)
                and svc1.replica_shed == 0
                and not set(before[:, 0].tolist()) & set(after.ravel())):
            raise AssertionError("phase 20 (c): at R=1 the old views did "
                                 "not serve until the publish")
        rec["c_refresh"]["r1"] = {
            "probes_during_restage": len(probes1), "replica_shed": 0,
            "swap_ms": info1["swap_ms"],
            "restage_ms": [p["restage_ms"] for p in info1["partitions"]]}
        emit({"phase": "partitioned_c_refresh", **rec["c_refresh"]})
        close(svc1)

        # (d) the queue budget at 0 under a burst: sheds, same answers
        svcd = service(config(PART_P, PART_R, replica_shed_queue=0))
        base_s, base_i = svcd.topk_vectors(qv, k=10)
        rounds = 0
        ties_d = 0
        while rounds < 3 and svcd.replica_shed == 0:
            rounds += 1
            with ThreadPoolExecutor(PART_BURST_THREADS) as pool:
                got = list(pool.map(
                    lambda j: svcd.topk_vectors(qv[j: j + 1], k=10),
                    [j % PART_QUERIES for j in range(PART_BURST_CALLS)]))
            for j, (s, i) in enumerate(got):
                r = j % PART_QUERIES
                ties_d += ties_only(s, i, base_s[r: r + 1], base_i[r: r + 1],
                                    "phase 20 (d) under the burst")
        if svcd.replica_shed == 0:
            raise AssertionError("phase 20 (d): no shed at "
                                 "replica_shed_queue=0 under a burst")
        reasons = sorted({e["attrs"]["reason"] for e in
                          svcd.registry.events("replica_shed")})
        rec["d_queue_shed"] = {
            "threads": PART_BURST_THREADS, "calls": PART_BURST_CALLS,
            "rounds": rounds, "replica_shed": svcd.replica_shed,
            "reasons": reasons, "tie_rows": ties_d,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "partitioned_d_queue_shed", **rec["d_queue_shed"]})
        close(svcd)
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.close()
        for svc_ in services:
            svc_.close()
        gc.unfreeze()
    torch.cuda.synchronize()
    counts = launch_counts()
    # ------------------------------------------------------------------
    dispatched = sum(s.encodes for s in services)
    want = expected_launches(dispatched * m.num_layers, 0)
    if counts != want or encodes["page"] or encodes["query"] != dispatched:
        raise AssertionError(f"phase 20 launched {counts}, want {want} "
                             f"({dispatched} query encodes; the embedder "
                             f"counted {encodes})")
    retries = sum(s.batch_retries for s in services)
    if retries:
        raise AssertionError(f"phase 20: the batcher retried {retries}")
    shutil.rmtree(os.path.join(workdir, "store_partitioned"),
                  ignore_errors=True)
    del services
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    rec.update({
        "encodes": dispatched, "k1_launches": counts["launches"],
        "k1_launches_tensor_core": counts["launches_tc"],
        "k1_launches_per_encode": counts["launches"] / max(dispatched, 1),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "seconds": seconds, "budget_s": PART_BUDGET_S,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()})
    emit({k: v for k, v in rec.items()
          if k not in ("a_exact", "b_ivf", "c_refresh", "d_queue_shed",
                       "e_rate")})
    if seconds > PART_BUDGET_S:
        raise AssertionError(f"phase 20 took {seconds:.1f} s, over its "
                             f"{PART_BUDGET_S} s budget")
    return rec


class WorkerFleet:
    """Phase 21's `cli partition-worker` subprocesses: one a (partition,
    replica) slot, started with `cmd` from the checkout's root, stdout and
    stderr read by a thread a process (the ready and exit lines kept, and
    no pipe ever fills). `stop()` waits for every process and kills what
    is left, so none outlives the phase."""

    def __init__(self, cmd: list):
        self.cmd = list(cmd)
        self.procs: dict = {}        # (partition, replica) -> the slot's now
        self.spawned: list = []      # every (slot, process, lines) started

    def spawn(self, p: int, r: int, slow_ms: float = 0.0):
        env = {k: v for k, v in os.environ.items()
               if k != "DPV_WORKER_SLOW_MS"}
        if slow_ms:
            env["DPV_WORKER_SLOW_MS"] = str(slow_ms)
        proc = subprocess.Popen(
            self.cmd + ["--partition", str(p), "--replica", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines: list = []

        def drain():
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
        threading.Thread(target=drain, daemon=True,
                         name=f"fleet-p{p}r{r}-stdout").start()
        self.procs[(p, r)] = proc
        self.spawned.append(((p, r), proc, lines))
        return proc

    def lines_of(self, proc) -> list:
        return next(ln for _, pr, ln in self.spawned if pr is proc)

    def record(self, proc, key: str, timeout_s: float = 0.0):
        """The first JSON line of `proc` holding `key` (waiting up to
        `timeout_s` for it), or None."""
        t_end = time.perf_counter() + timeout_s
        while True:
            for line in list(self.lines_of(proc)):
                if line.startswith("{") and f'"{key}"' in line:
                    return json.loads(line)
            if time.perf_counter() >= t_end:
                return None
            time.sleep(0.01)

    def tail(self, proc, n: int = 20) -> str:
        return "\n".join(self.lines_of(proc)[-n:])

    def stop(self, timeout_s: float) -> list:
        """Wait up to `timeout_s` for every process, then kill the rest;
        returns the slots that had to be killed."""
        t_end = time.perf_counter() + timeout_s
        killed = []
        for slot, proc, _ in self.spawned:
            try:
                proc.wait(timeout=max(0.0, t_end - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                killed.append(slot)
        return killed


def worker_processes(marker: str) -> list:
    """The process ids of every live `partition-worker` whose command
    line names `marker` (read from /proc)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        if b"partition-worker" in cmd and marker.encode() in b" ".join(cmd):
            out.append(int(pid))
    return out


def gpu_utilization(stop: threading.Event, out: list) -> None:
    """Samples nvidia-smi's utilization.gpu (the share of the last sample
    period a kernel ran on the card, any process's) until `stop`."""
    while not stop.is_set():
        try:
            out.append(float(subprocess.run(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=10).stdout.strip().splitlines()[0]))
        except (OSError, ValueError, IndexError,
                subprocess.SubprocessError):
            pass
        stop.wait(0.2)


def inflight_to(gw, pid: int, rid: int) -> int:
    """The gateway's requests still awaiting an answer from worker (pid,
    rid), a hedged loser's included."""
    with gw._lock:
        return sum(1 for _, w in gw._pending.values()
                   if (w.partition, w.replica) == (pid, rid))


def run_fleet(device, data, workdir: str, production: dict, serving: dict,
              partitioned: dict) -> dict:
    """Phase 21: the fleet over the wire (infer/partition_host.py), config
    3's towers at full width (phase 4's weights and vocab) on the front
    ends, over a copy of phase 15's store. (a) FLEET_P x FLEET_R `cli
    partition-worker` subprocesses (no --device: each stages its view on
    the card) register with a WorkerGateway on each of two front ends;
    their ready lines and the card's memory. (b) FLEET_QUERIES corpus
    queries through search_many, topk_vectors and a SearchServer with a
    SocketSearchClient equal phase 20's in-process path on the same
    service (each shape against its own: the 64-query block, one query a
    call) and the single view, byte for byte, or, where another
    process's cuBLAS rounds otherwise, with ids equal except at ties and
    scores within TIE_SCORE_TOL (a rounding step once formatted), the
    byte-equal answers counted; RPCs on every partition, no fallback. (g) the second front end answers the same;
    a query front end 0 answered is a peer hit of front end 1's result
    cache. (c) a kill -9 of one primary mid-way through a FLEET_TRIAL_S
    trial of phase 16's mix at FLEET_QPS over the socket: every answer the
    oracle's, worker_lost, a shed by liveness, and a new process for the
    slot registers (answering FLEET_SLOW_MS late). (d) at hedge_quantile
    FLEET_HEDGE_Q, calls hedge away from it, answers unchanged, well
    before it answers. (f) its drain finishes the call in flight from it
    while its sibling takes new ones. (e) a tombstone generation and
    refresh() in a trial of the same mix: the workers ack with no restart,
    and no answer mixes generations. (h) find_qps_at_p99 at the client's
    p99 <= 50 ms, cache off, beside phase 20's and phase 16's rates, with
    the card's busy share. (f) elastic: thread workers on the card at 4 x
    1; a tail drain narrows the split to 3 and a rejoin widens it to 4
    under a hammer, with no answer mixing splits. (i) K1 4 times an encode
    of the front ends, no launch in any worker, no view on the CPU, no
    worker left running, the phase within FLEET_BUDGET_S."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.partition_host import (
        DeviceEmbedder, PartitionWorker, WorkerGateway)
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.server import SearchServer
    from dnn_page_vectors_tpu_torch.infer.transport import SocketSearchClient
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.loadgen import (
        find_qps_at_p99, make_workload, run_trial)
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    import gc
    import shutil

    t_phase = time.perf_counter()
    gc.collect()
    corpus4, q_tok, p_tok = data
    path = production["corpus_path"]
    corpus = JsonlCorpus(path)
    fdir = os.path.join(workdir, "fleet")
    fstore = os.path.join(fdir, "store")
    os.makedirs(fdir, exist_ok=True)
    t0 = time.perf_counter()
    copy_store(VectorStore(os.path.join(workdir, "store_production")), fstore)
    copy_s = time.perf_counter() - t0
    P, R = FLEET_P, FLEET_R

    def config(partitions=1, replicas=1, cache=False, **serve):
        return get_config("bert_mini_v5p16", {
            "data.corpus": f"jsonl:{path}", "data.num_pages": PROD_PAGES,
            "model.attention": "flash", "serve.query_cache_size": 0,
            "serve.partitions": partitions, "serve.replicas": replicas,
            "serve.result_cache": cache, "serve.result_cache_fleet": cache,
            "serve.heartbeat_s": FLEET_HEARTBEAT_S,
            "obs.window_s": FLEET_RATE_TRIAL_S,
            **{f"serve.{k}": v for k, v in serve.items()}})
    cfg = config()
    m = cfg.model
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    encodes = count_encodes(emb)
    queries = corpus.query_texts(np.linspace(
        0, PROD_PAGES - 1, FLEET_QUERIES).astype(np.int64))
    distinct = corpus.query_texts(range(SERVE_DISTINCT))
    rec = {"phase": "fleet", "config": cfg.name, **widths(cfg),
           "store_vectors": PROD_PAGES, "partitions": P, "replicas": R,
           "queries": FLEET_QUERIES, "copy_store_s": copy_s}
    services, servers, clients, gateways, threads_w = [], [], [], [], []
    fleet = WorkerFleet([
        sys.executable, "-m", "dnn_page_vectors_tpu_torch.cli",
        "partition-worker", "--config", "bert_mini_v5p16", "--workdir", fdir,
        "--partitions", str(P), "--set", f"data.corpus=jsonl:{path}",
        "--set", f"serve.heartbeat_s={FLEET_HEARTBEAT_S}",
        "--set", "serve.result_cache=true",
        "--set", "serve.result_cache_fleet=true"])

    def service(c, embedder=emb):
        svc = SearchService(c, embedder, corpus, VectorStore(fstore))
        services.append(svc)
        return svc

    def serve(svc, front_end):
        svc.start_batcher()
        server = SearchServer(svc, executor_workers=SERVE_LOAD_WORKERS,
                              front_end=front_end)
        server.start_background()
        servers.append(server)
        client = SocketSearchClient(server.host, server.port)
        clients.append(client)
        return server, client

    def workload():
        return make_workload("poisson", seed=SERVE_SEED,
                             distinct=SERVE_DISTINCT, alpha=SERVE_ALPHA,
                             profile=((10, None, 1.0),))

    def wait(pred, what, timeout_s=FLEET_REGISTER_S):
        t = time.perf_counter()
        while not pred():
            if time.perf_counter() - t > timeout_s:
                raise AssertionError(f"phase 21: {what} within "
                                     f"{timeout_s} s")
            time.sleep(0.01)
        return time.perf_counter() - t

    def raw_equal(got, want):
        return (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]))

    def raw_match(got, want, what) -> bool:
        """True when two raw answers are byte for byte equal. Otherwise
        (another process's cuBLAS may take another algorithm for a
        shape) they must meet the bar of ids equal except at ties and
        scores within TIE_SCORE_TOL, or this raises; False then."""
        if raw_equal(got, want):
            return True
        fin = np.isfinite(want[0])
        diff = float(np.abs(np.asarray(got[0])[fin]
                            - np.asarray(want[0])[fin]).max()
                     if fin.any() else 0.0)
        if diff > TIE_SCORE_TOL or not np.array_equal(np.isfinite(got[0]),
                                                      fin):
            raise AssertionError(f"{what}: scores differ by {diff}")
        ties_only(*got, *want, what)
        return False

    def text_match(got, want, what) -> bool:
        """raw_match for formatted answers, whose scores are rounded to 4
        decimals: equal, or ids equal except at ties and scores within a
        rounding step (SERVE_SCORE_TOL)."""
        if hits(got) == hits(want):
            return True
        serve_results_equal([got], [want], what)
        return False

    def hits(wire):
        return [(r["page_id"], round(float(r["score"]), 4)) for r in wire]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        # ---- the main path, counted -----------------------------------
        fe0 = service(config(P, R, cache=True))
        fe1 = service(config(P, R, cache=True))
        # the gateways listen now and the workers start; the front ends
        # route through them once attached, after the oracles below
        gw0, gw1 = WorkerGateway(fe0), WorkerGateway(fe1)
        gateways += [gw0, gw1]
        fleet.cmd += ["--connect", f"{gw0.host}:{gw0.port},"
                                   f"{gw1.host}:{gw1.port}"]
        t_spawn = time.perf_counter()
        for p in range(P):
            for r in range(R):
                fleet.spawn(p, r)
        single = service(config())
        # phase 20's in-process path on the same service, before the
        # gateway is attached, and the single view: the oracles
        inproc_many = fe0.search_many(queries, k=10)
        fe0.clear_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()                 # warm, as phase 20 times
        fe0.search_many(queries, k=10)
        inproc_many_s = time.perf_counter() - t0
        single_many = single.search_many(queries, k=10)
        qv = single.encode_queries(queries)[:FLEET_QUERIES]
        qv_host = qv.float().cpu().numpy()
        inproc_raw = fe0.topk_vectors(qv, k=10)
        hq = qv[:8]                      # (d)'s and (f)'s calls
        want_h = fe0.topk_vectors(hq, k=10)
        # one query a call, as the socket's sequential client sends them:
        # the query tower's output depends on the batch's shape in its
        # last bits, so the socket's oracle is encoded as it is
        inproc_one = [fe0.search_many([q], k=10)[0] for q in queries]
        inproc_rows = [fe0.topk_vectors(qv[i: i + 1], k=10)
                       for i in range(FLEET_QUERIES)]
        single_raw = single._topk_view(single._view, qv, FLEET_QUERIES,
                                       10)[:2]
        if not (inproc_many == single_many
                and raw_equal(inproc_raw, single_raw)):
            raise AssertionError("phase 21: the in-process P x R answers "
                                 "differ from the single view's")
        fe0.clear_cache()
        fe0.attach_gateway(gw0)
        fe1.attach_gateway(gw1)

        # (a) the fleet comes up
        for name, gw in (("front end 0", gw0), ("front end 1", gw1)):
            if not gw.wait_for_workers(P * R, timeout_s=FLEET_REGISTER_S):
                missing = sorted(set(fleet.procs) - set(gw.live_workers()))
                raise AssertionError(
                    f"phase 21 (a): {len(missing)} of {P * R} workers did "
                    f"not register with {name} within {FLEET_REGISTER_S} "
                    f"s: {missing}; " + "; ".join(
                        fleet.tail(fleet.procs[s], 5) for s in missing))
        register_s = time.perf_counter() - t_spawn
        ready = {}
        for slot, proc in fleet.procs.items():
            line = fleet.record(proc, "partition_worker", FLEET_REGISTER_S)
            if line is None:
                raise AssertionError(f"phase 21 (a): no ready line from "
                                     f"{slot}: {fleet.tail(proc)}")
            ready[slot] = line
        pids0 = gw0.worker_pids()
        if (pids0 != gw1.worker_pids()
                or pids0 != {s: pr.pid for s, pr in fleet.procs.items()}):
            raise AssertionError(f"phase 21 (a): the gateways see "
                                 f"{pids0} and {gw1.worker_pids()}")
        staged = sum(r["staged_bytes"] for r in ready.values())
        rows = [[ready[(p, r)]["rows"] for r in range(R)] for p in range(P)]
        card = str(fe0._view.pages.device)      # the workers' device too
        if any(r["device"] != card or r["staged_device"] != card
               for r in ready.values()) or staged != R * PROD_PAGES * \
                fe0.store.row_bytes or sum(x[0] for x in rows) != PROD_PAGES:
            raise AssertionError(f"phase 21 (a): ready lines {ready}")
        free_b, total_b = torch.cuda.mem_get_info(device)
        rec["a_fleet"] = {
            "register_s": register_s, "workers": P * R,
            "ready": [ready[s] for s in sorted(ready)],
            "staged_bytes": staged,
            "staged_bytes_by_worker": [ready[s]["staged_bytes"]
                                       for s in sorted(ready)],
            "card_used_bytes_all_processes": int(total_b - free_b),
            "front_end_allocated_bytes": torch.cuda.memory_allocated(device),
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_a_up", **rec["a_fleet"]})

        # (b) results over the wire
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wire_many = fe0.search_many(queries, k=10)
        first_s = time.perf_counter() - t0       # the workers' first call
        fe0.clear_cache()
        t0 = time.perf_counter()
        fe0.search_many(queries, k=10)
        wire_many_s = time.perf_counter() - t0
        wire_raw = fe0.topk_vectors(qv, k=10)
        wire_rows = [fe0.topk_vectors(qv[i: i + 1], k=10)
                     for i in range(FLEET_QUERIES)]
        many_equal = sum(text_match(w, x, "phase 21 (b) search_many")
                         for w, x in zip(wire_many, inproc_many))
        block_equal = raw_match(wire_raw, inproc_raw,
                                "phase 21 (b) topk_vectors, 64 rows")
        rows_equal = sum(raw_match(w, x, "phase 21 (b) topk_vectors, a row")
                         for w, x in zip(wire_rows, inproc_rows))
        row_diff = max(float(np.abs(w[0] - x[0]).max())
                       for w, x in zip(wire_rows, inproc_rows))
        server0, client0 = serve(fe0, 0)
        fe0.clear_cache()
        wire_socket = [client0.search(q, k=10) for q in queries]
        socket_equal = sum(text_match(w, x, "phase 21 (b) the socket")
                           for w, x in zip(wire_socket, inproc_one))
        byte_equal = (many_equal == rows_equal == socket_equal
                      == FLEET_QUERIES and block_equal)
        st = gw0.stats()
        by_pid = st["rpcs_by_partition"]
        if len(by_pid) != P or min(by_pid) == 0 or st["rpc_fallbacks"]:
            raise AssertionError(f"phase 21 (b): the gateway counted {st}")
        tr0 = fe0.metrics()["transport"]
        rec["b_results"] = {
            "byte_equal": byte_equal,
            "search_many_answers_byte_equal": many_equal,
            "block_64_rows_byte_equal": block_equal,
            "one_row_calls_byte_equal": rows_equal,
            "one_row_calls_max_score_diff": row_diff,
            "socket_answers_byte_equal": socket_equal,
            "search_many_ms": wire_many_s * 1e3,
            "search_many_first_call_ms": first_s * 1e3,
            "inproc_search_many_ms": inproc_many_s * 1e3,
            "phase20_search_many_ms": partitioned["a_exact"][
                "partitioned"]["search_many_ms"],
            "socket_queries": len(queries), "rpcs_by_partition": by_pid,
            "rpc_fallbacks": st["rpc_fallbacks"],
            "hedge_fires": fe0.hedge_fires,
            "wire_bytes": tr0["wire_bytes"],
            "wire_raw_bytes": tr0.get("wire_raw_bytes", tr0["wire_bytes"]),
            "wire_raw_over_wire_bytes": tr0.get("wire_raw_bytes",
                                                tr0["wire_bytes"])
            / tr0["wire_bytes"],
            "workers_compressing": st["workers_compressing"],
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_b_results", **rec["b_results"]})

        # (g) two front ends over the same workers; the fleet result cache
        fe1_many = fe1.search_many(queries, k=10)
        fe1_raw = fe1.topk_vectors(qv, k=10)
        fe1_equal = sum(text_match(w, x, "phase 21 (g) search_many")
                        for w, x in zip(fe1_many, inproc_many))
        fe1_block = raw_match(fe1_raw, inproc_raw, "phase 21 (g) raw")
        st1 = gw1.stats()
        if min(st1["rpcs_by_partition"] or [0]) == 0 or st1["rpc_fallbacks"]:
            raise AssertionError(f"phase 21 (g): front end 1's gateway "
                                 f"counted {st1}")
        server1, _ = serve(fe1, 1)
        peer = SocketSearchClient(server0.host, server0.port,
                                  result_cache=True)
        clients.append(peer)
        fe1.attach_cache_peers([peer])
        cq = corpus.query_text(PROD_PAGES // 3 + 1)
        answered = fe0.search(cq, k=10)
        enc1, rpc1, hit1 = fe1.encodes, gw1.stats()["rpcs"], \
            fe1.result_cache_hits
        peer_hit = fe1.search(cq, k=10)
        if not (peer_hit == answered and fe1.result_cache_hits == hit1 + 1
                and fe1.encodes == enc1 and gw1.stats()["rpcs"] == rpc1):
            raise AssertionError("phase 21 (g): front end 0's answer was not "
                                 "a peer hit of front end 1's cache")
        rec["g_front_ends"] = {
            "front_ends": 2, "search_many_answers_byte_equal": fe1_equal,
            "block_64_rows_byte_equal": fe1_block,
            "rpcs_by_partition": st1["rpcs_by_partition"],
            "peer_hit": True, "front_end_1_result_cache_hits":
            fe1.result_cache_hits, "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_g_front_ends", **rec["g_front_ends"]})

        # (c) a kill -9 under load
        sched = workload().schedule(SERVE_WARMUP_S + FLEET_TRIAL_S,
                                    FLEET_QPS)
        texts = sorted({distinct[r.query_id % len(distinct)]
                        for _, r in sched})
        old = dict(zip(texts, single.search_many(texts, k=10)))
        kp, kill_at = FLEET_KILL_PID, {}

        def kill():
            victim = fleet.procs[(kp, 0)]
            kill_at["t"] = time.perf_counter()
            victim.kill()
            detect = wait(lambda: not gw0.worker_alive(kp, 0),
                          "the killed worker was not seen lost", 10.0)
            fleet.spawn(kp, 0, slow_ms=FLEET_SLOW_MS)
            return detect
        rclient = RecordingClient(client0)
        mut = OneShotMutator("kill", kill, SERVE_WARMUP_S + FLEET_KILL_AT_S)
        fb0 = gw0.stats()["rpc_fallbacks"]
        tr = run_trial(fe0, workload(), FLEET_QPS, distinct,
                       duration_s=FLEET_TRIAL_S, warmup_s=SERVE_WARMUP_S,
                       workers=SERVE_LOAD_WORKERS, client=rclient,
                       mutator=mut)
        mut.join()
        if mut.result is None or tr["errors"]:
            raise AssertionError(f"phase 21 (c): the kill or the trial "
                                 f"failed: {mut.errors}, {tr['errors']} "
                                 "errors")
        # under load the batcher coalesces buckets of any size, whose
        # query vectors may differ from the oracle's bucket in their last
        # bits: the answers are held to the oracle's up to ties
        bad = [q for q, a in rclient.answers
               if not same_results([a], [old[q]])]
        if bad:
            raise AssertionError(f"phase 21 (c): {len(bad)} answers differ "
                                 f"from the oracle: {bad[:3]}")
        exact_c = sum(hits(a) == hits(old[q]) for q, a in rclient.answers)
        lost = [e for e in fe0.registry.events("worker_lost")
                if e["attrs"]["partition"] == kp]
        sheds = [e["attrs"] for e in fe0.registry.events("replica_shed")
                 if e["attrs"]["partition"] == kp]
        if not lost or not any(s["reason"] == "liveness"
                               and s["to_replica"] == 1 for s in sheds):
            raise AssertionError(f"phase 21 (c): lost {lost}, sheds {sheds}")
        # (f) elastic, while the killed slot's new process starts: 4 x 1
        # thread workers on the card, the tail drains (4 -> 3) and rejoins
        # (3 -> 4) under a hammer
        dev_emb = DeviceEmbedder(device)
        eq = qv_host[:FLEET_ELASTIC_QUERIES]
        fe_e = service(config(P, 1, elastic=True), dev_emb)
        o4 = [fe_e.topk_vectors(eq[j: j + 1], k=10) for j in range(len(eq))]
        three = service(config(P - 1, 1), dev_emb)
        o3 = [three.topk_vectors(eq[j: j + 1], k=10) for j in range(len(eq))]
        three.close()
        services.remove(three)
        gw_e = WorkerGateway(fe_e)
        gateways.append(gw_e)
        fe_e.attach_gateway(gw_e)
        wcfg = config()

        def thread_worker(p):
            w = PartitionWorker(wcfg, fstore, ("127.0.0.1", gw_e.port), p, P,
                                device=device)
            threads_w.append(w)
            threading.Thread(target=w.run, daemon=True,
                             name=f"fleet-elastic-p{p}").start()
            return w
        tail = thread_worker(P - 1)          # the tail first: no re-cut
        wait(lambda: len(gw_e.live_workers()) == 1, "the elastic tail")
        for p in range(P - 1):
            thread_worker(p)

        def at_width(n):
            table = gw_e.partition_set.table()
            return (len(table) == n and len(gw_e.live_workers()) == n
                    and gw_e.stale_workers(table[0][0].generation,
                                           split=n) == 0)
        wait(lambda: at_width(P), "the elastic fleet at 4")
        stop_h, errors, mixed = threading.Event(), [], []
        served = {3: 0, 4: 0, "byte_equal": 0}

        def hammer():
            j = 0
            while not stop_h.is_set():
                i = j % len(eq)
                j += 1
                try:
                    got = fe_e.topk_vectors(eq[i: i + 1], k=10)
                except Exception as e:  # noqa: BLE001 -- counted
                    errors.append(repr(e)[:200])
                    continue
                # an answer of one split, byte for byte or under the
                # relaxed bar; a mixed split fails both
                for width, oracle in ((4, o4[i]), (3, o3[i])):
                    try:
                        exact = raw_match(got, oracle, "split")
                    except AssertionError:
                        continue
                    served[width] += 1
                    served["byte_equal"] += exact
                    break
                else:
                    mixed.append(i)
        hs = [threading.Thread(target=hammer) for _ in range(2)]
        for h in hs:
            h.start()
        try:
            time.sleep(0.3)
            t0 = time.perf_counter()
            threading.Thread(target=tail.drain, kwargs={"wait_s": 0.5},
                             daemon=True).start()
            narrow_s = wait(lambda: at_width(P - 1), "the re-split to 3")
            time.sleep(0.3)
            t1 = time.perf_counter()
            thread_worker(P - 1)
            widen_s = wait(lambda: at_width(P), "the re-split to 4")
            time.sleep(0.3)
        finally:
            stop_h.set()
            for h in hs:
                h.join(30)
        triggers = [e["attrs"]["trigger"]
                    for e in fe_e.registry.events("fleet_resplit")]
        if (errors or mixed or "drain" not in triggers
                or "join" not in triggers or not served[3] + served[4]):
            raise AssertionError(f"phase 21 (f): errors {errors[:3]}, mixed "
                                 f"{len(mixed)}, served {served}, "
                                 f"re-splits {triggers}")
        rec["f_elastic"] = {
            "workers": "threads on the card", "queries": len(eq),
            "answers_by_split": served, "mixed": 0, "errors": 0,
            "queries_whose_split_oracles_differ": sum(
                not raw_equal(a, b) for a, b in zip(o3, o4)),
            "resplit_triggers": triggers, "narrow_s": narrow_s,
            "widen_s": widen_s, "resplits": gw_e.stats()["resplits"],
            "drain_to_narrow_s": t1 - t0,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_f_elastic", **rec["f_elastic"]})
        new_proc = fleet.procs[(kp, 0)]
        wait(lambda: gw0.worker_pids().get((kp, 0)) == new_proc.pid
             and gw1.worker_pids().get((kp, 0)) == new_proc.pid,
             "the new worker of the killed slot did not register")
        respawn_s = time.perf_counter() - kill_at["t"]
        rec["c_kill"] = {
            "qps": FLEET_QPS, "trial_s": FLEET_TRIAL_S,
            "killed": [kp, 0], "detect_s": mut.result,
            "replacement_registered_s": respawn_s,
            "replacement_pid": new_proc.pid,
            "answers": len(rclient.answers), "answers_byte_equal": exact_c,
            "distinct_queries": len(texts),
            "rpc_fallbacks": gw0.stats()["rpc_fallbacks"] - fb0,
            "shed_reasons": sorted({s["reason"] for s in sheds}),
            "trial": trial_line(tr), "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_c_kill", **rec["c_kill"]})

        # (d) hedging away from the slow new primary
        wait(lambda: gw0._routed_generation(kp) == gw0._workers[
            (kp, 0)].generation, "the new worker's generation")
        gw0.hedge_quantile = FLEET_HEDGE_Q
        fired0 = fe0.hedge_fires
        times_h = []
        for _ in range(FLEET_HEDGE_CALLS):
            t0 = time.perf_counter()
            got = fe0.topk_vectors(hq, k=10)
            times_h.append(time.perf_counter() - t0)
            raw_match(got, want_h, "phase 21 (d) a hedged answer")
        hedged = [e["attrs"] for e in fe0.registry.events("hedge_fired")
                  if e["attrs"]["partition"] == kp
                  and e["attrs"]["from_replica"] == 0]
        if (fe0.hedge_fires - fired0 < FLEET_HEDGE_CALLS or
                len(hedged) < FLEET_HEDGE_CALLS
                or max(times_h) > FLEET_SLOW_MS / 1e3 / 3):
            raise AssertionError(f"phase 21 (d): {fe0.hedge_fires - fired0} "
                                 f"hedges, calls {times_h} s")
        # the slow worker answers every request it got before its drain
        wait(lambda: inflight_to(gw0, kp, 0) == 0,
             "the slow worker's answers", 10.0)
        rec["d_hedge"] = {
            "hedge_quantile": FLEET_HEDGE_Q, "slow_ms": FLEET_SLOW_MS,
            "calls": FLEET_HEDGE_CALLS, "call_s": times_h,
            "hedge_fires": fe0.hedge_fires - fired0,
            "hedge_events_from_slow_primary": len(hedged),
            "hedge_after_ms": [h["after_ms"] for h in hedged],
            "answers_unchanged": True, "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_d_hedge", **rec["d_hedge"]})

        # (f) the slow worker's drain finishes the call in flight from it;
        # its sibling takes the partition
        gw0.hedge_quantile = 0.0
        slow = fleet.procs[(kp, 0)]
        out, fb0, rpcs0 = {}, gw0.stats()["rpc_fallbacks"], gw0.stats()["rpcs"]

        def inflight():
            t = time.perf_counter()
            out["got"] = fe0.topk_vectors(hq, k=10)
            out["s"] = time.perf_counter() - t
        th = threading.Thread(target=inflight)
        th.start()
        wait(lambda: inflight_to(gw0, kp, 0) == 1, "the call in flight", 10.0)
        slow.send_signal(signal.SIGTERM)
        wait(lambda: gw0.stats()["workers_draining"] >= 1,
             "the drain announcement", 10.0)
        t0 = time.perf_counter()
        during = fe0.topk_vectors(hq, k=10)
        during_s = time.perf_counter() - t0
        th.join(30)
        slow.wait(30)
        exit_slow = fleet.record(slow, "partition_worker_exit")
        raw_match(out["got"], want_h, "phase 21 (f) the call in flight")
        raw_match(during, want_h, "phase 21 (f) the sibling's answer")
        if not (out["s"] >= FLEET_SLOW_MS / 1e3
                and during_s < FLEET_SLOW_MS / 1e3 / 3
                and gw0.stats()["rpc_fallbacks"] == fb0
                and slow.returncode == 0 and exit_slow is not None
                and exit_slow["answered"] >= FLEET_HEDGE_CALLS + 1):
            raise AssertionError(
                f"phase 21 (f): drain: in flight {out.get('s')} s, during "
                f"{during_s} s, exit {slow.returncode} {exit_slow}")
        gw0.hedge_quantile = config().serve.hedge_quantile
        lost = fe0.registry.events("worker_lost")[-1]["attrs"]
        rec["f_drain"] = {
            "in_flight_call_s": out["s"], "sibling_call_s": during_s,
            "rpcs": gw0.stats()["rpcs"] - rpcs0,
            "rpc_fallbacks": gw0.stats()["rpc_fallbacks"] - fb0,
            "exit_code": slow.returncode, "exit": exit_slow,
            "lost_reason": lost["reason"],
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_f_drain", **rec["f_drain"]})

        # (e) a refresh over the wire under a trial of the same mix
        dead = sorted({r["page_id"] for h in old.values() for r in h})
        pids_e = gw0.worker_pids()

        def mutate():
            t = time.perf_counter()
            VectorStore(fstore).begin_generation(tombstones=dead).commit()
            gen_s = time.perf_counter() - t
            info = fe0.refresh()
            ok = gw0.wait_for_generation(info["store_generation"],
                                         timeout_s=FLEET_REGISTER_S)
            return gen_s, info, ok, time.perf_counter() - t
        rclient = RecordingClient(client0)
        mut = OneShotMutator("tombstone_refresh", mutate,
                             SERVE_WARMUP_S + FLEET_FIRE_S)
        tr = run_trial(fe0, workload(), FLEET_QPS, distinct,
                       duration_s=FLEET_TRIAL_S, warmup_s=SERVE_WARMUP_S,
                       workers=SERVE_LOAD_WORKERS, client=rclient,
                       mutator=mut)
        mut.join()
        if mut.result is None or tr["errors"] or not mut.result[2]:
            raise AssertionError(f"phase 21 (e): {mut.errors}, "
                                 f"{tr['errors']} errors, {mut.result}")
        gen_s, info, _, acked_s = mut.result
        new_gen = info["store_generation"]
        single.refresh()
        new = dict(zip(texts, single.search_many(texts, k=10)))
        verdict = {"old": 0, "new": 0}
        for q, a in rclient.answers:
            is_old = same_results([a], [old[q]])
            is_new = same_results([a], [new[q]])
            if not (is_old or is_new):
                raise AssertionError(f"phase 21 (e): a mixed answer for "
                                     f"{q!r}: {a}")
            verdict["old" if is_old else "new"] += 1
        after = fe0.search_many(texts, k=10)
        if (gw0.stale_workers(new_gen) or gw0.worker_pids() != pids_e
                or not all(same_results([a], [new[q]])
                           for q, a in zip(texts, after))
                or any(r["page_id"] in set(dead) for h in after for r in h)):
            raise AssertionError(f"phase 21 (e): stale "
                                 f"{gw0.stale_workers(new_gen)}, pids "
                                 f"{gw0.worker_pids()} vs {pids_e}")
        rec["e_refresh"] = {
            "tombstoned": len(dead), "generation_s": gen_s,
            "refresh_seconds": info["refresh_seconds"],
            "swap_ms": info["swap_ms"],
            "workers_refresh": info["workers_refresh"],
            "refresh_to_every_ack_s": acked_s, "stale_workers": 0,
            "same_pids": True, "answers": verdict, "trial": trial_line(tr),
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_e_refresh", **rec["e_refresh"]})

        # (h) the rate over the socket fleet, cache off
        fe0._rcache_cap = 0      # the result cache off for the rate search
        fe0.clear_cache()
        util, stop_u = [], threading.Event()
        sampler = threading.Thread(target=gpu_utilization,
                                   args=(stop_u, util))
        sampler.start()
        try:
            # the workers run in processes of their own, which this
            # process's profiler does not see: the card's busy share is
            # nvidia-smi's, over every process
            warm = run_trial(fe0, workload(), PART_START_QPS, distinct,
                             duration_s=SERVE_WARM_S, warmup_s=SERVE_WARMUP_S,
                             workers=SERVE_LOAD_WORKERS, client=client0)
        finally:
            stop_u.set()
            sampler.join()
        busy = sum(util) / len(util) / 100.0 if util else None
        t0 = time.perf_counter()
        rep = find_qps_at_p99(
            fe0, workload(), distinct, p99_target_ms=SERVE_P99_MS,
            start=PART_START_QPS, max_load=SERVE_MAX_QPS, iters=SERVE_ITERS,
            duration_s=FLEET_RATE_TRIAL_S, warmup_s=SERVE_WARMUP_S,
            workers=SERVE_LOAD_WORKERS, max_error_rate=SERVE_MAX_ERROR_RATE,
            client=client0, p99_key="client_p99_ms")
        trials = [trial_line(t) for t in rep["trials"]]
        if len(trials) > FLEET_MAX_TRIALS:
            raise AssertionError(f"phase 21 (h): {len(trials)} trials")
        best = max((t for t in rep["trials"] if t["met"]),
                   key=lambda t: t["achieved_qps"], default=None)
        rec["h_rate"] = {
            "qps_at_p99": rep["qps_at_p99"], "target_met": best is not None,
            "p99_target_ms": SERVE_P99_MS, "p99_judged_on": "client_p99_ms",
            "trials": trials, "at_rate": trial_line(best) if best else None,
            "warm_trial": trial_line(warm, busy),
            "card_busy_share_at_start_qps": busy,
            "busy_share_from": "nvidia-smi utilization.gpu, every process",
            "nvidia_smi_utilization_gpu_samples": util,
            "phase20_inproc_qps_at_p99": partitioned["e_rate"]["qps_at_p99"],
            "phase16_p1_qps_at_p99": serving["d_load"]["off"]["qps_at_p99"],
            "phase16_p1_qps_at_p99_runs": serving["d_load"]["off"][
                "qps_at_p99_runs"],
            "hedge_fires": fe0.hedge_fires,
            "rpc_fallbacks": gw0.stats()["rpc_fallbacks"],
            "seconds": time.perf_counter() - t0,
            "at_s": time.perf_counter() - t_phase}
        emit({"phase": "fleet_h_rate", **rec["h_rate"]})

        on_card = sum(require_on_card(s, "phase 21 (i)") for s in services)
        for w in threads_w:
            for t in view_tensors(w.view):
                if t.device.type != device.type:
                    raise AssertionError("phase 21 (i): a worker's view "
                                         f"holds a tensor on {t.device}")
                on_card += 1
        rec["on_card_tensors"] = on_card
        dispatched = sum(s.encodes for s in services)
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.close()
        for gw in gateways:
            gw.close()           # BYE: every worker ends on its own
        for w in threads_w:
            w.stop()
        killed = fleet.stop(30.0)
        for svc_ in services:
            svc_.close()
    torch.cuda.synchronize()
    counts = launch_counts()
    # ------------------------------------------------------------------
    want = expected_launches(dispatched * m.num_layers, 0)
    if counts != want or encodes["page"] or encodes["query"] != dispatched:
        raise AssertionError(f"phase 21 launched {counts}, want {want} "
                             f"({dispatched} query encodes; the embedder "
                             f"counted {encodes})")
    exits, codes = [], []
    for slot, proc, _ in fleet.spawned:
        codes.append((slot, proc.returncode))
        line = fleet.record(proc, "partition_worker_exit")
        if proc.returncode == -signal.SIGKILL:
            continue                         # (c)'s victim
        if proc.returncode != 0 or line is None or set(
                line["kernel_launches"].values()) != {0}:
            raise AssertionError(f"phase 21 (i): worker {slot} exited "
                                 f"{proc.returncode}: {fleet.tail(proc)}")
        exits.append(line)
    left = worker_processes(fdir)
    if killed or left or sum(c == -signal.SIGKILL for _, c in codes) != 1:
        raise AssertionError(f"phase 21 (i): workers killed at teardown "
                             f"{killed}, left running {left}, exit codes "
                             f"{codes}")
    shutil.rmtree(fdir, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    rec.update({
        "encodes": dispatched, "k1_launches": counts["launches"],
        "k1_launches_tensor_core": counts["launches_tc"],
        "k1_launches_per_encode": counts["launches"] / max(dispatched, 1),
        "worker_exits": len(exits),
        "worker_answered": [e["answered"] for e in exits],
        "worker_kernel_launches": 0, "processes_spawned":
        len(fleet.spawned), "processes_left": 0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "seconds": seconds, "budget_s": FLEET_BUDGET_S,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()})
    emit({k: v for k, v in rec.items()
          if k not in ("a_fleet", "b_results", "c_kill", "d_hedge",
                       "e_refresh", "f_drain", "f_elastic", "g_front_ends",
                       "h_rate")})
    if seconds > FLEET_BUDGET_S:
        raise AssertionError(f"phase 21 took {seconds:.1f} s, over its "
                             f"{FLEET_BUDGET_S} s budget")
    return rec


KERNEL_FLAGS = {"flash_fwd_tc_kernel": ("seg",),
                "flash_bwd_dkv_tc_kernel": ("bias", "seg"),
                "flash_bwd_dq_tc_kernel": ("seg",),
                "flash_bwd_dq_dbias_tc_kernel": ("seg",),
                "flash_bwd_dkv_kernel": ("bias",)}


def ptxas_summary(log: str) -> list:
    """[kernel, registers, spill store bytes, spill load bytes] for each
    kernel in nvcc's -Xptxas -v output (kept beside a cached library; "no
    log" when there is none)."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"flash_[a-z_]+?_kernel", mangled)
            name = base.group(0) if base else mangled
            if base and not any(n in name for n in ("dbias_sum", "summary",
                                                    "gdead")):
                # the tensor-core kernels take bf16 only, the rest f32;
                # the template arguments follow the name: Li64E the head-
                # dim width DP, Lb1E / Lb0E a bool flag set / unset
                args = ["bf16" if "_tc_" in name else "f32"]
                tmpl = mangled[base.end():]
                tmpl = tmpl[1:tmpl.find("EE") + 1] if tmpl[:1] == "I" else ""
                width = re.match(r"Li(\d+)E", tmpl)
                if width:
                    args.append(f"Dh<={width.group(1)}")
                flags = re.findall(r"Lb([01])E", tmpl)
                args += [f for f, on in zip(KERNEL_FLAGS.get(name, ()), flags)
                         if on == "1"]
                name += "<" + ",".join(args) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), *spill])
            name, spill = None, (0, 0)
    return out or [log[-200:]]


def run_ab(parent: str, seg_file: str, mt5_seg_file: str) -> dict:
    """scripts/bwd_ab.py over the tree `parent` and this checkout in turns
    (parent, this, this, parent), one process per tree on this card: each
    kernel's time in each run at the shapes the script names (the seg
    kernels also at the training layouts saved in `seg_file`, bert_long_sp's,
    and `mt5_seg_file`, mT5's), with CUDA events around back-to-back calls
    and as the profiler's device time; whether every run's K2 with seg gave
    the same dq up to the sign of a zero, every run's K1 with seg the same
    out and lse at the rows that see a key, and every run's K4 with seg
    the same dq up to the sign of a zero and bitwise the same dbias."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "scripts", "bwd_ab.py"), parent,
         here, here, parent, "--train-seg", seg_file, "--train-seg-mt5",
         mt5_seg_file], capture_output=True, text=True, timeout=900,
        check=False)
    if proc.returncode != 0:
        raise AssertionError(f"scripts/bwd_ab.py failed:\n"
                             f"{proc.stderr[-3000:]}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    summary = last["summary"]
    rec = {"phase": "ab", "script": "scripts/bwd_ab.py", "parent": parent,
           "order": "parent, this, this, parent",
           "parent_ms": summary[parent], "this_ms": summary[here],
           "k2_seg_dq_equal": last["k2_seg_dq_equal"],
           "k1_seg_out_equal": last["k1_seg_out_equal"],
           "k4_seg_equal": last["k4_seg_equal"]}
    emit(rec)
    if not all(last["k2_seg_dq_equal"].values()):
        raise AssertionError(f"K2 with seg gave another dq than the parent "
                             f"tree's: {last['k2_seg_dq_equal']}")
    if not all(last["k1_seg_out_equal"].values()):
        raise AssertionError(f"K1 with seg gave another out or lse than the "
                             f"parent tree's at the rows that see a key: "
                             f"{last['k1_seg_out_equal']}")
    if not all(last["k4_seg_equal"].values()):
        raise AssertionError(f"K4 with seg gave another dq or dbias than the "
                             f"parent tree's: {last['k4_seg_equal']}")
    return rec


def run_phases(device, report: dict, tok_pool, mt5_tok, word_tok,
               parent=None) -> list:
    """Phases 2-21; fills `report` and returns the `kernels` line's
    entries. `mt5_tok` and `word_tok` are the futures of the mT5 and the
    word tokenizers, trained in `tok_pool`'s process, which then writes
    phase 15's corpus; with `parent` (another tree of the port) the
    kernels are also timed against it. report["timeline"] holds the seconds
    since the phases began at the end of each of them."""
    from dnn_page_vectors_tpu_torch.ops import build
    t_run = time.perf_counter()
    timeline = report["timeline"] = {}

    def done(name: str) -> None:
        timeline[name] = time.perf_counter() - t_run
    from dnn_page_vectors_tpu_torch import native
    # one nvcc per source and the g++ of the C++ host library, all started
    # together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        host_lib = pool.submit(native.build)
        for f in [pool.submit(build.compile_source, src) for src in SOURCES]:
            f.result()
        lib_path = host_lib.result()
    report["build"] = {}
    native.load()
    report["build"]["native"] = {"library": lib_path.name,
                                 "gxx_s": native.BUILD_INFO["seconds"]}
    emit({"phase": "build", "source": "native/*.cpp (g++, the C++ host "
          "library)", "library": lib_path.name,
          "gxx_seconds": native.BUILD_INFO["seconds"]})
    for src in SOURCES:
        build.load_library(src)
        secs, log = build.BUILD_INFO.get(src, (0.0, "no log"))
        rows = ptxas_summary(log)
        report["build"][src] = {"nvcc_s": secs, "ptxas": rows}
        emit({"phase": "build", "source": src, "arch": "sm_90a",
              "nvcc_seconds": secs, "ptxas": rows})
        tc_rows = [r for r in rows if isinstance(r, list) and "_tc_" in r[0]]
        for kernel in TC_KERNELS[src]:
            if not any(r[0].startswith(kernel + "<") for r in tc_rows):
                raise AssertionError(f"no ptxas summary of {kernel} in the "
                                     f"build log of {src}: {rows}")
        spills = [r for r in tc_rows if r[2] or r[3]]
        if spills:
            raise AssertionError(f"a tensor-core kernel spills: {spills}")
    emit({"phase": "build_total", "seconds": time.perf_counter() - t0})
    done("build")

    # phase 4's corpus and vocab first: the seg kernels are also checked
    # and timed at the segment ids of phase 8's first batch
    bert = build_data("bert_mini_v5p16", N_PAGES)
    long_data = packed_data(LONG, LONG_PAGE_WORDS, LONG_PAGES, bert)
    train_seg = train_layout_seg(long_data)
    done("bert_data")
    report["k1"] = check_k1(device, ("embed_bf16", "mt5_page_bias_bf16",
                                     "bert_long_packed_bf16",
                                     "bert_long_train_layout_bf16",
                                     "mt5_packed_bias_bf16"), train_seg)
    done("k1")
    report["k23"] = check_k23(device, "page_train_bf16", "query_train_bf16")
    done("k23")
    report["k4"] = check_k4(device, "mt5_page_train_bf16",
                            "mt5_query_train_bf16")
    done("k4")
    with tempfile.TemporaryDirectory(dir=os.getcwd(), prefix=".chip_smoke_",
                                     ignore_cleanup_errors=True) as tmp:
        # phase 15's corpus is host work: written in the tokenizer
        # process, after the vocabs, while the card works on phases 4-14
        corpus_job = tok_pool.apply_async(write_production_corpus, (
            os.path.join(tmp, "corpus_1m.jsonl"), PROD_PAGES, PROD_SEED,
            PROD_PAGE_WORDS, PROD_QUERY_WORDS))
        report["seg"] = check_seg(device, train_seg)
        done("seg")
        report["slice"] = run_slice(device, "bert_mini_v5p16", N_PAGES,
                                    N_QUERIES, tmp, bert)
        done("slice")
        report["train"] = run_training(device, "bert_mini", bert, tmp)
        done("train")
        t0 = time.perf_counter()
        tokenizers = mt5_tok.get()
        emit({"phase": "mt5_tokenizer_wait", "seconds":
              time.perf_counter() - t0})
        mt5 = build_data(MT5, MT5_VOCAB_PAGES, tokenizers)
        # phase 9's data now: K4 and K3 with seg are also checked and timed
        # at its first batch's segment ids
        mt5_pack_data = packed_data(MT5, MT5_PACK_PAGE_WORDS, MT5_PACK_PAGES,
                                    mt5)
        mt5_seg = train_layout_seg(mt5_pack_data, MT5, MT5_PACK_TRAIN_BATCH)
        done("mt5_data")
        report["seg"]["mt5_train"] = check_seg_mt5_train(device, mt5_seg)
        report["seg"]["worst"]["mt5_train_layout_bias_bf16"] = (
            report["seg"]["mt5_train"]["worst"])
        if parent is not None:
            seg_files = [os.path.join(tmp, f"{n}_seg.pt")
                         for n in ("train", "mt5_train")]
            torch.save(train_seg, seg_files[0])
            torch.save(mt5_seg, seg_files[1])
            torch.cuda.empty_cache()     # the A/B runs in processes of its own
            report["ab"] = run_ab(parent, *seg_files)
            done("ab")
        report["mt5_slice"] = run_slice(device, MT5, MT5_PAGES, N_QUERIES,
                                        tmp, mt5)
        done("mt5_slice")
        report["mt5_train"] = run_training(device, "mt5", mt5, tmp)
        done("mt5_train")
        # phases 8 and 9: packed training over the vocabs of phases 4, 6
        report["long_train"] = run_training(device, "bert_long_packed",
                                            long_data, tmp)
        done("long_train")
        report["mt5_pack_train"] = run_training(device, "mt5_packed",
                                                mt5_pack_data, tmp)
        done("mt5_pack_train")
        # phases 10-12: the towers without attention
        t_zoo = time.perf_counter()
        cdssm = build_data(CDSSM, CDSSM_PAGES)
        report["cdssm_slice"] = run_slice(device, CDSSM, CDSSM_PAGES,
                                          N_QUERIES, tmp, cdssm)
        done("cdssm_slice")
        report["cdssm_train"] = run_training(device, "cdssm", cdssm, tmp)
        done("cdssm_train")
        report["cdssm_quality"] = cdssm_quality(device, tmp)
        done("cdssm_quality")
        del cdssm
        t0 = time.perf_counter()
        tokenizers = word_tok.get()
        emit({"phase": "word_tokenizer_wait", "seconds":
              time.perf_counter() - t0})
        if data_config(KIM, WORD_VOCAB_PAGES).data != \
                data_config(LSTM, WORD_VOCAB_PAGES).data:
            raise AssertionError(f"{KIM} and {LSTM} no longer share their "
                                 "corpus and vocab")
        words = build_data(KIM, WORD_VOCAB_PAGES, tokenizers)
        done("word_data")
        for config, cell in ((KIM, "kim_cnn"), (LSTM, "lstm")):
            report[f"{cell}_slice"] = run_slice(device, config, WORD_PAGES,
                                                N_QUERIES, tmp, words)
            done(f"{cell}_slice")
            report[f"{cell}_train"] = run_training(device, cell, words, tmp)
            done(f"{cell}_train")
        emit({"phase": "phases_10_to_12", "seconds":
              time.perf_counter() - t_zoo})
        # phase 13: hard-negative mining over phase 4's corpus and vocab
        report["hardneg"] = run_hardneg(device, bert, tmp)
        done("hardneg")
        # phase 14: the IVF/PQ index and the int8 store, over phase 4's
        # corpus, vocab and fp16 store
        report["ivf"] = run_ivf(device, bert, tmp)
        done("ivf")
        # phase 15: the production job from a jsonl corpus, with phase 4's
        # vocab and weights
        report["production"] = run_production(device, bert, tmp, report,
                                              corpus_job)
        done("production")
        # phases 16 and 17: serving under load, then live updates, over
        # phase 15's store and corpus
        try:
            report["serving"] = run_serving(device, bert, tmp,
                                            report["production"])
            done("serving")
            # phase 20: partitioned and replicated serving over phase 15's
            # store and corpus (a copy of the store for its refresh) and
            # phase 14(b)'s 1M-row index
            report["partitioned"] = run_partitioned(
                device, bert, tmp, report["production"], report["serving"])
            done("partitioned")
            # phase 21: the fleet over the wire, over a copy of phase 15's
            # store, beside phases 16's and 20's rates
            report["fleet"] = run_fleet(
                device, bert, tmp, report["production"], report["serving"],
                report["partitioned"])
            done("fleet")
            report["updates"] = run_updates(device, bert, tmp,
                                            report["production"])
            done("updates")
            # phase 18: a rolling migration of phase 17's store and the
            # background maintenance, under load
            report["migration"] = run_migration(device, bert, tmp,
                                                report["production"])
        finally:
            os.remove(report["production"]["corpus_path"])
        done("migration")
        # phase 19: filtered retrieval and the hot posting set over phase
        # 14's stores
        report["filtered"] = run_filtered(device, bert, tmp)
        done("filtered")
    emit({"phase": "timeline", "seconds_at_end_of": timeline})
    return kernel_entries(report)


def kernel_entries(report: dict) -> list:
    """The `kernels` line: one entry per kernel, launches summed over the
    main paths (each path's count read around its own run); with the A/B
    run, the --parent tree's kernel time and this tree's beside it (means
    of the two runs of each tree; CUDA events around back-to-back calls,
    and the profiler's device time); the registers and spills of each
    instantiation."""
    k1, k23, k4, seg = report["k1"], report["k23"], report["k4"], report["seg"]
    ab = report.get("ab")

    def parent(key):
        if ab is None:
            return {"parent_ms": None, "parent_note": "not measured: run "
                    "with --parent TREE (the parent commit's checkout)"}
        # None where a tree has no such call (the parent's seg variants)
        mean = lambda xs: None if None in xs else sum(xs) / len(xs)
        par, this = ab["parent_ms"], ab["this_ms"]
        return {"parent_ms": mean(par[key]), "ab_ms": mean(this[key]),
                "ab_runs_ms": {"parent": par[key], "this": this[key]},
                "parent_device_ms": mean(par["device_ms"][key]),
                "ab_device_ms": mean(this["device_ms"][key])}

    rows = [r for src in SOURCES for r in report["build"][src]["ptxas"]
            if isinstance(r, list)]

    def ptxas(*prefixes):
        return [r for r in rows if r[0].startswith(prefixes)]
    zoo = ("cdssm", "kim_cnn", "lstm")   # no attention: 0 launches each
    paths = {"bert_serving": report["slice"]["k1_launches"],
             "mt5_serving": report["mt5_slice"]["k1_launches"],
             **{f"{z}_serving": report[f"{z}_slice"]["k1_launches"]
                for z in zoo},
             "ivf_retrieval": report["ivf"]["k1_launches"],
             "ivf_1m_store_encodes": report["ivf"]["k1_launches_big_store"],
             "production_1m_embed": report["production"]["embed"][
                 "k1_launches"],
             "serving_under_load": report["serving"]["k1_launches"],
             "live_updates": report["updates"]["k1_launches"],
             "migration_and_maintenance": report["migration"][
                 "k1_launches"],
             "filtered_and_hot_set": report["filtered"]["k1_launches"],
             "partitioned_serving": report["partitioned"]["k1_launches"],
             "fleet_over_the_wire": report["fleet"]["k1_launches"]}
    training = (("bert_training", report["train"]),
                ("mt5_training", report["mt5_train"]),
                ("bert_long_packed_training", report["long_train"]),
                ("mt5_packed_training", report["mt5_pack_train"]),
                *((f"{z}_training", report[f"{z}_train"]) for z in zoo),
                ("hardneg_pipeline", report["hardneg"]),
                ("production_training_from_jsonl",
                 report["production"]["train"]),
                ("migration_target_training", report["migration"]["train"]))
    by_path = {n: {} for n in ("k1", "k2", "k3", "k4")}
    tc_by_path = {
        "k1": {"bert_serving": report["slice"]["k1_launches_tensor_core"],
               "mt5_serving": report["mt5_slice"]["k1_launches_tensor_core"],
               **{f"{z}_serving": report[f"{z}_slice"][
                   "k1_launches_tensor_core"] for z in zoo},
               "ivf_retrieval": report["ivf"]["k1_launches_tensor_core"],
               "ivf_1m_store_encodes": report["ivf"][
                   "k1_launches_big_store_tensor_core"],
               "production_1m_embed": report["production"]["embed"][
                   "k1_launches_tensor_core"],
               "serving_under_load": report["serving"][
                   "k1_launches_tensor_core"],
               "live_updates": report["updates"][
                   "k1_launches_tensor_core"],
               "migration_and_maintenance": report["migration"][
                   "k1_launches_tensor_core"],
               "filtered_and_hot_set": report["filtered"][
                   "k1_launches_tensor_core"],
               "partitioned_serving": report["partitioned"][
                   "k1_launches_tensor_core"],
               "fleet_over_the_wire": report["fleet"][
                   "k1_launches_tensor_core"]},
        "k2": {}, "k3": {}, "k4": {}}
    seg_by_path = {n: {} for n in ("k1", "k2", "k3", "k4")}
    for path, rec in training:
        for n, count in rec["launches_main_path"].items():
            by_path[n][path] = count
        for n, count in rec["launches_tensor_core_main_path"].items():
            tc_by_path[n][path] = count
        for n, count in rec["launches_seg_main_path"].items():
            if count:
                seg_by_path[n][path] = count
    by_path["k1"].update(paths)
    bert_pair = {"k2_k3_ms": k23["k2_k3_ms"]}
    mt5_pair = {"k4_k3_ms": k4["k4_k3_ms"]}
    bert_shape = f"B={TRAIN_BATCH} H=4 L=S=64 Dh=64 bf16 q/k/v, f32 g"
    mt5_shape = (f"B={MT5_TRAIN_BATCH} H=12 L=S=128 Dh=64 bf16 q/k/v, f32 g, "
                 "f32 bias")
    k1_bert = k1["timed"]["embed_bf16"]
    k1_mt5 = k1["timed"]["mt5_page_bias_bf16"]
    long_shape = (f"B={LONG_TRAIN_BATCH // PACK} H=8 L=S=1024 Dh=64 bf16 "
                  f"q/k/v, f32 g, {PACK} pages a row (segment ids)")
    mt5p_shape = (f"B={MT5_PACK_TRAIN_BATCH // PACK} H=12 L=S=128 Dh=64 bf16 "
                  f"q/k/v, f32 g, f32 bias, {PACK} pages a row (segment ids)")
    per_step = lambda n: {path: rec["launches_one_step"][n]
                          for path, rec in training}

    def query(rec, names, shape, key):
        """A backward kernel's numbers at the query tower's shape."""
        q = rec["query"]
        return {"shape": shape, "ms": q[names[0]], "plain_ms": q["plain_ms"],
                "bound_ms": q["bound"]["dq"]["bound_ms"],
                "bound_by": q["bound"]["dq"]["bound_by"],
                "library_ms": q["library_ms"], names[2]: q[names[2]],
                "k3_ms": q[names[1]],
                "k3_bound_ms": q["bound"]["dkv"]["bound_ms"],
                "blocks_per_sm": q["dq_blocks_per_sm"],
                "plain_and_library_cover": "the pair", **parent(key)}
    return [{
        "name": "flash_fwd (K1)", "route": "cuda", "source": K1_SOURCE,
        "replaces": TPU_K1, "launches": sum(by_path["k1"].values()),
        "launches_by_path": by_path["k1"],
        "launches_per_embed_batch": {
            "bert": report["slice"]["k1_launches_per_embed_batch"],
            "mt5": report["mt5_slice"]["k1_launches_per_embed_batch"]},
        "launches_per_train_step": per_step("k1"),
        "max_abs_err": k1["max_abs_err"], "ms": k1_bert["kernel_ms"],
        "plain_ms": k1_bert["plain_ms"], "bound_ms": k1_bert["bound_ms"],
        "bound_by": k1_bert["bound_by"], "library_ms": k1_bert["library_ms"],
        "shape": "B=512 H=4 L=S=64 Dh=64 bf16", **parent("k1_bert_ms"),
        "kernel": "flash_fwd_tc_kernel (tensor cores, bf16); f32 inputs "
                  "take flash_fwd_kernel (CUDA cores)",
        "launches_tensor_core": sum(tc_by_path["k1"].values()),
        "ptxas": ptxas("flash_fwd"),
        "mt5": {"shape": "B=512 H=12 L=S=128 Dh=64 bf16, f32 bias",
                "ms": k1_mt5["kernel_ms"], "plain_ms": k1_mt5["plain_ms"],
                "bound_ms": k1_mt5["bound_ms"],
                "bound_by": k1_mt5["bound_by"],
                "library_ms": k1_mt5["library_ms"], **parent("k1_mt5_ms")},
        "launches_seg": sum(seg_by_path["k1"].values()),
        "launches_seg_by_path": seg_by_path["k1"]},
        k1_seg_entry(k1, seg_by_path, ptxas, parent, long_shape,
                     mt5p_shape), {
        "name": "flash_bwd_dq (K2)", "route": "cuda", "source": K23_SOURCE,
        "replaces": TPU_K2, "launches": sum(by_path["k2"].values()),
        "launches_by_path": by_path["k2"],
        "launches_per_train_step": per_step("k2"),
        "max_abs_err": max(w["k2"] for w in k23["worst"].values()),
        "ms": k23["k2_ms"], "plain_ms": k23["plain_ms"],
        "bound_ms": k23["bound"]["dq"]["bound_ms"],
        "bound_by": k23["bound"]["dq"]["bound_by"],
        "library_ms": k23["library_ms"], **bert_pair, "shape": bert_shape,
        "plain_and_library_cover": "K2 and K3 together", **parent("k2_ms"),
        "kernel": "flash_bwd_dq_tc_kernel (tensor cores, bf16); f32 inputs "
                  "take flash_bwd_dq_kernel (CUDA cores)",
        "launches_tensor_core": sum(tc_by_path["k2"].values()),
        "bitwise_equal_runs": k23["k2_bitwise"],
        "blocks_per_sm": k23["dq_blocks_per_sm"],
        "ptxas": ptxas("flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel"),
        "query": query(k23, ("k2_ms", "k3_ms", "k2_k3_ms"),
                       f"B={TRAIN_BATCH} H=4 L=S=16 Dh=64 bf16 q/k/v, f32 g",
                       "k2_query_ms")}, {
        "name": "flash_bwd_dkv (K3)", "route": "cuda", "source": K23_SOURCE,
        "replaces": TPU_K3, "launches": sum(by_path["k3"].values()),
        "launches_by_path": by_path["k3"],
        "launches_per_train_step": per_step("k3"),
        "max_abs_err": max([w["k3"] for w in k23["worst"].values()]
                           + [w["k3"] for w in k4["worst"].values()]),
        "ms": k23["k3_ms"], "plain_ms": k23["plain_ms"],
        "bound_ms": k23["bound"]["dkv"]["bound_ms"],
        "bound_by": k23["bound"]["dkv"]["bound_by"],
        "library_ms": k23["library_ms"], **bert_pair, "shape": bert_shape,
        "plain_and_library_cover": "K2 and K3 together", **parent("k3_ms"),
        "kernel": "flash_bwd_dkv_tc_kernel (tensor cores, bf16); f32 "
                  "inputs take flash_bwd_dkv_kernel (CUDA cores)",
        "launches_tensor_core": sum(tc_by_path["k3"].values()),
        "bitwise_equal_runs": k23["k3_bitwise"] and k4["k3_bitwise"],
        "ptxas": ptxas("flash_bwd_dkv"),
        "biased": {"shape": mt5_shape, "ms": k4["k3_bias_ms"],
                   "plain_ms": k4["plain_ms"],
                   "bound_ms": k4["bound"]["dkv"]["bound_ms"],
                   "bound_by": k4["bound"]["dkv"]["bound_by"],
                   "library_ms": k4["library_ms"], **mt5_pair,
                   "plain_and_library_cover": "K4 and K3 together",
                   **parent("k3_bias_ms")}}, {
        "name": "flash_bwd_dq_dbias (K4)", "route": "cuda",
        "source": K23_SOURCE, "replaces": TPU_K4,
        "launches": sum(by_path["k4"].values()),
        "launches_by_path": by_path["k4"],
        "launches_per_train_step": per_step("k4"),
        "max_abs_err": max(w["k4"] for w in k4["worst"].values()),
        "ms": k4["k4_ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound"]["dq"]["bound_ms"],
        "bound_by": k4["bound"]["dq"]["bound_by"],
        "library_ms": k4["library_ms"], **mt5_pair, "shape": mt5_shape,
        "bitwise_equal_runs": k4["bitwise"],
        "plain_and_library_cover": "K4 and K3 together", **parent("k4_ms"),
        "kernel": "flash_bwd_dq_dbias_tc_kernel (tensor cores, bf16); f32 "
                  "inputs take flash_bwd_dq_dbias_kernel (CUDA cores); both "
                  "then flash_bwd_dbias_sum_kernel",
        "launches_tensor_core": sum(tc_by_path["k4"].values()),
        "blocks_per_sm": k4["dq_blocks_per_sm"],
        "ptxas": ptxas("flash_bwd_dq_dbias", "flash_bwd_dbias_sum"),
        "query": query(k4, ("k4_ms", "k3_bias_ms", "k4_k3_ms"),
                       f"B={MT5_TRAIN_BATCH} H=12 L=S=16 Dh=64 bf16 q/k/v, "
                       "f32 g, f32 bias", "k4_query_ms")},
        *seg_entries(seg, seg_by_path, ptxas, parent, long_shape,
                     mt5p_shape),
        summary_entry(seg, training, ptxas, parent, long_shape),
        gdead_entry(seg, training, ptxas, parent, long_shape)]


def k1_seg_entry(k1, seg_by_path, ptxas, parent, long_shape,
                 mt5p_shape) -> dict:
    """The `kernels` line's entry of K1 with segment ids (the bf16 kernel
    visits only the KV tiles that share a segment): K1 alone (`ms`, on a
    summary made beforehand) and the call (`with_summary_ms`: the summary
    kernel, then K1) at bert_long_sp's packed shape at both layouts and at
    mT5's, with the share of K1's tiles visited, the bound, the plain
    version and the library call (scaled_dot_product_attention with the
    segments' mask); launches with segment ids on the main paths."""
    timed = k1["timed"]

    def timing(rec):
        return {"ms": rec["k1_alone_ms"], "with_summary_ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "visited": rec["visited"]}
    train_shape = long_shape + (", the training batch's segment ids "
                                "(phase 8's first batch)")
    return {
        "name": "flash_fwd with seg (K1, packed rows)", "route": "cuda",
        "source": K1_SOURCE, "replaces": TPU_K1,
        "launches": sum(seg_by_path["k1"].values()),
        "launches_by_path": seg_by_path["k1"],
        "max_abs_err": k1["max_abs_err_seg"],
        **timing(timed["bert_long_packed_bf16"]), "shape": long_shape,
        **parent("k1_seg_ms"),
        "train_layout": {"shape": train_shape,
                         **timing(timed["bert_long_train_layout_bf16"]),
                         **parent("k1_seg_train_ms")},
        "mt5_packed": {"shape": mt5p_shape,
                       **timing(timed["mt5_packed_bias_bf16"]),
                       **parent("k1_seg_mt5_ms")},
        "parent_covers": "the call (flash_forward: the summary kernel, "
                         "then K1; the parent tree has no summary there)",
        "kernel": "flash_fwd_tc_kernel<DP, seg> (tensor cores, bf16), after "
                  "flash_fwd_seg_summary_kernel; f32 inputs take "
                  "flash_fwd_kernel with seg",
        "ptxas": [r for r in ptxas("flash_fwd_tc_kernel", "flash_fwd_kernel")
                  if "seg" in r[0] or "_tc_" not in r[0]]}


def seg_entries(seg, seg_by_path, ptxas, parent, long_shape,
                mt5p_shape) -> list:
    """The `kernels` line's entries of the seg variants of K2, K3 and K4:
    times, bounds, plain and library (scaled_dot_product_attention with the
    segments' mask) at the packed paths' shapes, launches with segment ids
    on the main paths (run_training fails unless every launch of a packed
    path took the tensor cores)."""
    long, train, mt5 = seg["long"], seg["long_train"], seg["mt5"]
    mt5_train = seg["mt5_train"]
    worst = seg["worst"].values()
    biased = [w for n, w in seg["worst"].items() if "bias" in n]
    plain = [w for n, w in seg["worst"].items() if "bias" not in n]
    seg_rows = lambda *names: [r for r in ptxas(*names)
                               if "seg" in r[0] or "_tc_" not in r[0]]

    def timing(rec, key, bound, pair, pair_key):
        return {"ms": rec[key], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound"][bound]["bound_ms"],
                "bound_by": rec["bound"][bound]["bound_by"],
                "library_ms": rec["library_ms"], pair: rec[pair],
                "plain_and_library_cover": pair_key,
                "visited": rec.get("visited")}
    train_shape = long_shape + (", the training batch's segment ids "
                                "(phase 8's first batch)")
    mt5_train_shape = mt5p_shape + (", the training batch's segment ids "
                                    "(phase 9's first batch)")
    return [{
        "name": "flash_bwd_dq with seg (K2, packed rows)", "route": "cuda",
        "source": K23_SOURCE, "replaces": TPU_K2,
        "launches": sum(seg_by_path["k2"].values()),
        "launches_by_path": seg_by_path["k2"],
        "max_abs_err": max(w["dq"] for w in plain),
        **timing(long, "k2_ms", "dq", "k2_k3_ms", "K2 and K3 together"),
        "shape": long_shape, **parent("k2_seg_ms"),
        "train_layout": {"shape": train_shape,
                         **timing(train, "k2_ms", "dq", "k2_k3_ms",
                                  "K2 and K3 together"),
                         **parent("k2_seg_train_ms")},
        "kernel": "flash_bwd_dq_tc_kernel<DP, seg> (tensor cores, bf16); "
                  "f32 inputs take flash_bwd_dq_kernel with seg",
        "bitwise_equal_runs": long["bitwise"] and train["bitwise"],
        "blocks_per_sm": long["dq_blocks_per_sm"],
        "ptxas": seg_rows("flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel")}, {
        "name": "flash_bwd_dkv with seg (K3, packed rows)", "route": "cuda",
        "source": K23_SOURCE, "replaces": TPU_K3,
        "launches": sum(seg_by_path["k3"].values()),
        "launches_by_path": seg_by_path["k3"],
        "max_abs_err": max(w["k3"] for w in worst),
        **timing(long, "k3_ms", "dkv", "k2_k3_ms", "K2 and K3 together"),
        "shape": long_shape, **parent("k3_seg_ms"),
        "train_layout": {"shape": train_shape,
                         **timing(train, "k3_ms", "dkv", "k2_k3_ms",
                                  "K2 and K3 together"),
                         **parent("k3_seg_train_ms")},
        "kernel": "flash_bwd_dkv_tc_kernel<DP, bias, seg> (tensor cores, "
                  "bf16); f32 inputs take flash_bwd_dkv_kernel with seg",
        "bitwise_equal_runs": (long["k3_bitwise"] and train["k3_bitwise"]
                               and mt5["k3_bitwise"]
                               and mt5_train["k3_bitwise"]),
        "ptxas": seg_rows("flash_bwd_dkv"),
        "biased": {"shape": mt5p_shape,
                   **timing(mt5, "k3_bias_ms", "dkv", "k4_k3_ms",
                            "K4 and K3 together"),
                   **parent("k3_bias_seg_ms"),
                   "train_layout": {
                       "shape": mt5_train_shape,
                       **timing(mt5_train, "k3_bias_ms", "dkv", "k4_k3_ms",
                                "K4 and K3 together"),
                       **parent("k3_bias_seg_train_ms")}}}, {
        "name": "flash_bwd_dq_dbias with seg (K4, packed rows)",
        "route": "cuda", "source": K23_SOURCE, "replaces": TPU_K4,
        "launches": sum(seg_by_path["k4"].values()),
        "launches_by_path": seg_by_path["k4"],
        "max_abs_err": max(max(w["dq"], w["dbias"]) for w in biased),
        **timing(mt5, "k4_ms", "dq", "k4_k3_ms", "K4 and K3 together"),
        "shape": mt5p_shape, **parent("k4_seg_ms"),
        "train_layout": {"shape": mt5_train_shape,
                         **timing(mt5_train, "k4_ms", "dq", "k4_k3_ms",
                                  "K4 and K3 together"),
                         **parent("k4_seg_train_ms")},
        "kernel": "flash_bwd_dq_dbias_tc_kernel<DP, seg> (tensor cores, "
                  "bf16), then flash_bwd_dbias_sum_kernel; f32 inputs take "
                  "flash_bwd_dq_dbias_kernel with seg",
        "bitwise_equal_runs": mt5["bitwise"] and mt5_train["bitwise"],
        "blocks_per_sm": mt5["dq_blocks_per_sm"],
        "ptxas": seg_rows("flash_bwd_dq_dbias", "flash_bwd_dbias_sum")}]


def summary_entry(seg, training, ptxas, parent, long_shape) -> dict:
    """The `kernels` line's entry of the segment summary kernel (before
    the bf16 K1 with segment ids, once per forward: the ranges by which
    K1, K2 and K3 skip tiles, and the dead rows' mean(V), a part of the
    TPU K1's work): checked and timed at both packed paths' shapes and the
    training layout; launches on the main paths."""
    checks = seg["summary"]
    long = checks["long"]
    by_path = {path: rec["seg_summary_launches_main_path"]
               for path, rec in training
               if rec["seg_summary_launches_main_path"]}
    return {
        "name": "flash_fwd_seg_summary (segment summary and the dead rows' "
                "mean(V), for K1, K2 and K3 with seg)", "route": "cuda",
        "source": K1_SOURCE, "replaces": TPU_K1,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": long["ms"], "plain_ms": long["plain_ms"],
        "bound_ms": long["bound_ms"], "bound_by": long["bound_by"],
        "library_ms": None, "shape": long_shape,
        "plain_call": long["plain_call"],
        "train_layout": {k: checks["long_train"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")},
        "mt5_packed": {k: checks["mt5"][k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by")},
        **parent("seg_summary_ms"),
        "parent_covers": "the parent tree's summary kernel, in its "
                         "backward (the summary and the dead rows' g sum)",
        "kernel": "flash_fwd_seg_summary_kernel",
        "ptxas": ptxas("flash_fwd_seg_summary")}


def gdead_entry(seg, training, ptxas, parent, long_shape) -> dict:
    """The `kernels` line's entry of the dead rows' g sum (before the bf16
    K3 with segment ids, once per backward: their dv term, a part of the
    TPU K3's work): checked and timed at both packed paths' shapes and
    the training layout; launches on the main paths."""
    checks = seg["gdead"]
    long = checks["long"]
    by_path = {path: rec["gdead_launches_main_path"]
               for path, rec in training if rec["gdead_launches_main_path"]}
    return {
        "name": "flash_bwd_gdead (the dead rows' g sum, for K3 with seg)",
        "route": "cuda", "source": K23_SOURCE, "replaces": TPU_K3,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": long["ms"], "plain_ms": long["plain_ms"],
        "bound_ms": long["bound_ms"], "bound_by": long["bound_by"],
        "library_ms": None, "shape": long_shape,
        "plain_call": long["plain_call"],
        "train_layout": {k: checks["long_train"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")},
        "mt5_packed": {k: checks["mt5"][k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by")},
        **parent("gdead_ms"),
        "kernel": "flash_bwd_gdead_kernel",
        "ptxas": ptxas("flash_bwd_gdead")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="also write every phase's record to this JSON file")
    ap.add_argument("--parent", default=None, metavar="TREE",
                    help="another tree of the port (e.g. the parent commit "
                         "unpacked with git archive): time its kernels and "
                         "this checkout's in turns with scripts/bwd_ab.py")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from dnn_page_vectors_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 3
    device = resolve_device(None)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    report = {"device": {"kind": kind, "nvidia_smi": smi,
                         "count": torch.cuda.device_count(),
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda}}
    emit({"phase": "device", **report["device"]})

    # the mT5 vocab is host work of minutes, the word vocab of phases 11
    # and 12 of seconds: train them in a second process, one after the
    # other, while the card works on the builds, the checks and BERT-mini;
    # the process is ended with the run, whether it succeeded or not
    tok_pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        mt5_tok = tok_pool.apply_async(
            train_tokenizers, (data_config(MT5, MT5_VOCAB_PAGES),))
        word_tok = tok_pool.apply_async(
            train_tokenizers, (data_config(KIM, WORD_VOCAB_PAGES),))
        kernels = run_phases(device, report, tok_pool, mt5_tok, word_tok,
                             args.parent)
    except BaseException:
        # where a failed run spent its time: the phases that ended
        emit({"phase": "timeline", "seconds_at_end_of":
              report.get("timeline"), "failed": True})
        raise
    finally:
        tok_pool.terminate()
        tok_pool.join()
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
