#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (dnn_page_vectors_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH] [--parent TREE]

Phases, each printing one JSON line:
  1. device: the card, its power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA source of the paths (K1 in flash_fwd.cu; K2, K3 and
     K4 in flash_bwd.cu) is compiled with nvcc for sm_90a from the
     checkout (build/torch_kernels/), one nvcc per source, all started
     together; each kernel's registers and spills (ptxas), and a failure
     if a tensor-core kernel spills. The mT5 SentencePiece vocab is
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
     on a 300,000-page 4-language corpus; the first 20,000 pages are bulk
     embedded (dim 768), then the serving checks of phase 4 (12 K1
     launches per encode);
  7. mT5 training: phase 5 at the config's width with the batch cut from
     4,096 (the JAX config's global batch over 8 chips) to 512 pages: K1,
     K4 and K3 launch 24 times a step (all on the tensor cores), K2
     never; the rel_bias table is
     among the gradients held flash against dense and bitwise run to run;
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
     the peak memory (<= 80 GB).
No attention kernel runs in phases 10-12: every launch counter is read
after each of their main paths and must be 0.
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
import subprocess
import sys
import tempfile
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
# beside the flash tower) and 64 in f32. The bf16 bound is wider than
# BERT-mini's: 12 layers against 4, and a CPU rehearsal of the plain
# versions at d=768 gave 4.9e-2 (the query tower's top wq/wk).
MT5 = "mt5_multilingual"
MT5_VOCAB_PAGES = 300_000
MT5_PAGES = 20_000
MT5_TRAIN_BATCH = 512
MT5_BF16_ROWS = 256
MT5_F32_ROWS = 64
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
PEAK_LIMIT_GB = 80.0
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

def data_config(config: str, n_pages: int):
    from dnn_page_vectors_tpu_torch.config import get_config
    return get_config(config, {"data.num_pages": n_pages})


def train_tokenizers(cfg):
    """The subword tokenizers of Config `cfg` trained over its toy corpus,
    and the seconds that took (host work only: for mT5 this runs in a
    second process while the card works on the BERT-mini phases)."""
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    t0 = time.perf_counter()
    q_tok, p_tok = build_tokenizer(cfg, build_corpus(cfg))
    return q_tok, p_tok, time.perf_counter() - t0


def build_data(config: str, n_pages: int, tokenizers=None):
    """The toy corpus of n_pages pages and the tokenizers of the config
    (a trained vocab is trained on that corpus; the serving and training
    phases share them); `tokenizers` is the result of train_tokenizers
    when it ran elsewhere."""
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus
    cfg = data_config(config, n_pages)
    corpus = build_corpus(cfg)
    q_tok, p_tok, tok_s = tokenizers or train_tokenizers(cfg)
    want = (cfg.data.trigram_buckets + 1 if cfg.data.tokenizer == "trigram"
            else cfg.data.vocab_size)
    if p_tok.vocab_size != want:
        raise AssertionError(f"vocab {p_tok.vocab_size} != {want}")
    emit({"phase": "tokenizer", "config": config,
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
    overrides = {"data.num_pages": n_pages, "eval.store_shard_size": 65_536,
                 "eval.embed_batch_size": 512,
                 **({"model.attention": "flash"} if transformer else {})}
    cfg = get_config(config, overrides)
    m = cfg.model
    _, q_tok, p_tok = data
    corpus = build_corpus(cfg)   # page i is the same text at every size

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
# flash vs dense gradient comparison
TRAIN_CELLS = {
    "bert_mini": dict(config="bert_mini_v5p16", batch=TRAIN_BATCH, pack=1,
                      bf16_pages=TRAIN_BATCH, f32_pages=F32_ROWS,
                      bf16_tol=FLASH_DENSE_GRAD_TOL),
    "mt5": dict(config=MT5, batch=MT5_TRAIN_BATCH, pack=1,
                bf16_pages=MT5_BF16_ROWS, f32_pages=MT5_F32_ROWS,
                bf16_tol=MT5_FLASH_DENSE_GRAD_TOL),
    "bert_long_packed": dict(config=LONG, batch=LONG_TRAIN_BATCH, pack=PACK,
                             bf16_pages=32 * PACK, f32_pages=8 * PACK,
                             bf16_tol=LONG_FLASH_DENSE_GRAD_TOL),
    "mt5_packed": dict(config=MT5, batch=MT5_PACK_TRAIN_BATCH, pack=PACK,
                       bf16_pages=MT5_BF16_ROWS, f32_pages=MT5_F32_ROWS,
                       bf16_tol=MT5_FLASH_DENSE_GRAD_TOL),
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
    corpus = ToyCorpus(num_pages=n_pages, seed=d.seed, page_len=words,
                       query_len=d.query_len, languages=d.languages,
                       num_topics=d.num_topics)
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


def run_training(device, cell_name: str, data, workdir: str) -> dict:
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import (
        TrainBatcher, pack_segments, to_device)
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
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

    # ---- resume: 3 steps, save, restore into a fresh Trainer, 3 steps ------
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
    del resumed

    # ---- flash vs dense gradients, dropout off, the seeded weights ----------
    if transformer:
        bf16 = flash_vs_dense(config, overrides, p_tok.vocab_size,
                              _take(batches[2], cell["bf16_pages"], pack),
                              device, "bfloat16")
        f32 = flash_vs_dense(config, overrides, p_tok.vocab_size,
                             _take(batches[2], cell["f32_pages"], pack),
                             device, "float32")
        for rec, tol in ((bf16, cell["bf16_tol"]),
                         (f32, FLASH_DENSE_GRAD_TOL_F32)):
            if not rec["max_rel_err"] <= tol:
                raise AssertionError(f"flash vs dense gradients differ: "
                                     f"{rec} (bound {tol})")
            if not rec["key_bias_over_wk"] <= KEY_BIAS_GRAD_TOL:
                raise AssertionError(f"a key-bias gradient (exactly 0 in "
                                     f"exact arithmetic) is not small: {rec}")
        extra["flash_vs_dense_grads_bf16"] = {
            **bf16, "tol": cell["bf16_tol"], "pages": cell["bf16_pages"]}
        extra["flash_vs_dense_grads_f32"] = {
            **f32, "tol": FLASH_DENSE_GRAD_TOL_F32,
            "pages": cell["f32_pages"]}
        extra["key_bias_grad_tol"] = KEY_BIAS_GRAD_TOL

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
        "resume_loss_max_diff": resume_diff,
        "resume_loss_tol": RESUME_LOSS_TOL,
        "bitwise_equal_grads": True, **extra,
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


# the bool template flags of each templated kernel, in order
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


def run_phases(device, report: dict, mt5_tok, word_tok, parent=None
               ) -> list:
    """Phases 2-13; fills `report` and returns the `kernels` line's
    entries. `mt5_tok` and `word_tok` are the futures of the mT5 and the
    word tokenizers; with `parent` (another tree of the port) the kernels
    are also timed against it."""
    from dnn_page_vectors_tpu_torch.ops import build
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for f in [pool.submit(build.compile_source, src) for src in SOURCES]:
            f.result()
    report["build"] = {}
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

    # phase 4's corpus and vocab first: the seg kernels are also checked
    # and timed at the segment ids of phase 8's first batch
    bert = build_data("bert_mini_v5p16", N_PAGES)
    long_data = packed_data(LONG, LONG_PAGE_WORDS, LONG_PAGES, bert)
    train_seg = train_layout_seg(long_data)
    report["k1"] = check_k1(device, ("embed_bf16", "mt5_page_bias_bf16",
                                     "bert_long_packed_bf16",
                                     "bert_long_train_layout_bf16",
                                     "mt5_packed_bias_bf16"), train_seg)
    report["k23"] = check_k23(device, "page_train_bf16", "query_train_bf16")
    report["k4"] = check_k4(device, "mt5_page_train_bf16",
                            "mt5_query_train_bf16")
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".chip_smoke_") as tmp:
        report["seg"] = check_seg(device, train_seg)
        report["slice"] = run_slice(device, "bert_mini_v5p16", N_PAGES,
                                    N_QUERIES, tmp, bert)
        report["train"] = run_training(device, "bert_mini", bert, tmp)
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
        report["mt5_slice"] = run_slice(device, MT5, MT5_PAGES, N_QUERIES,
                                        tmp, mt5)
        report["mt5_train"] = run_training(device, "mt5", mt5, tmp)
        # phases 8 and 9: packed training over the vocabs of phases 4, 6
        report["long_train"] = run_training(device, "bert_long_packed",
                                            long_data, tmp)
        report["mt5_pack_train"] = run_training(device, "mt5_packed",
                                                mt5_pack_data, tmp)
        # phases 10-12: the towers without attention
        t_zoo = time.perf_counter()
        cdssm = build_data(CDSSM, CDSSM_PAGES)
        report["cdssm_slice"] = run_slice(device, CDSSM, CDSSM_PAGES,
                                          N_QUERIES, tmp, cdssm)
        report["cdssm_train"] = run_training(device, "cdssm", cdssm, tmp)
        report["cdssm_quality"] = cdssm_quality(device, tmp)
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
        for config, cell in ((KIM, "kim_cnn"), (LSTM, "lstm")):
            report[f"{cell}_slice"] = run_slice(device, config, WORD_PAGES,
                                                N_QUERIES, tmp, words)
            report[f"{cell}_train"] = run_training(device, cell, words, tmp)
        emit({"phase": "phases_10_to_12", "seconds":
              time.perf_counter() - t_zoo})
        # phase 13: hard-negative mining over phase 4's corpus and vocab
        report["hardneg"] = run_hardneg(device, bert, tmp)
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
                for z in zoo}}
    training = (("bert_training", report["train"]),
                ("mt5_training", report["mt5_train"]),
                ("bert_long_packed_training", report["long_train"]),
                ("mt5_packed_training", report["mt5_pack_train"]),
                *((f"{z}_training", report[f"{z}_train"]) for z in zoo),
                ("hardneg_pipeline", report["hardneg"]))
    by_path = {n: {} for n in ("k1", "k2", "k3", "k4")}
    tc_by_path = {
        "k1": {"bert_serving": report["slice"]["k1_launches_tensor_core"],
               "mt5_serving": report["mt5_slice"]["k1_launches_tensor_core"],
               **{f"{z}_serving": report[f"{z}_slice"][
                   "k1_launches_tensor_core"] for z in zoo}},
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
        kernels = run_phases(device, report, mt5_tok, word_tok, args.parent)
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
