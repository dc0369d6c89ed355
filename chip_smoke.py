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
     one key, an unaligned view), with the tolerance stated, and which of
     K1's and K3's two kernels launched (bf16: tensor cores, f32: CUDA
     cores); two runs of K3 and of K4 bitwise equal; plus each kernel's
     time, the plain version's, one PyTorch library call's (a yardstick
     the port never calls) and its bound. With --parent TREE (a checkout
     of the parent commit), scripts/bwd_ab.py then times the kernels of
     TREE and of this checkout in turns (TREE, this, this, TREE), with
     CUDA events around back-to-back calls (the kernels' `ms` here too)
     and as the profiler's device time;
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
     (counted: K1, K2 and K3 launch 8 times a step, K1 and K3 on the
     tensor cores), then 6 steps on
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
     K4 and K3 launch 24 times a step, K2 never; the rel_bias table is
     among the gradients held flash against dense and bitwise run to run.
Then the `kernels` line, the card's name and power limit as nvidia-smi
prints them, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present, when
the port is not importable (run from the root of a checkout), or when any
phase fails.
"""
from __future__ import annotations

import argparse
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
# each source's tensor-core kernel, whose ptxas summary must be in the log
TC_KERNELS = {"flash_fwd.cu": "flash_fwd_tc_kernel",
              "flash_bwd.cu": "flash_bwd_dkv_tc_kernel"}
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
    for name in ("launches", "launches_tc", "launches_f32", "dq_launches",
                 "dkv_launches", "dkv_launches_tc", "dkv_launches_f32",
                 "dq_dbias_launches"):
        setattr(fa, name, 0)


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

def k1_inputs(B, H, L, S, Dh, dtype, device, seed, pad="tail", bias=False,
              seg=False, strided=False, unaligned=False):
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


def k1_bound(x) -> dict:
    q, k = x["q"], x["k"]
    B, H, L, Dh = q.shape
    S = k.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in
                 (x["q"], x["k"], x["v"], x["kv_mask"], x["bias"], x["seg"])
                 if t is not None)
    nbytes += B * H * L * Dh * 4 + B * H * L * 4       # out, lse (f32)
    flops = 4.0 * B * H * L * S * Dh                     # q.k^T and p.v
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_k1(device, timed_cases) -> dict:
    """Kernel vs plain version on every case (the serving and training
    paths' shapes and the edge cases); times at `timed_cases`."""
    import torch.nn.functional as F
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
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
    }
    worst = {}
    for i, (name, c) in enumerate(cases.items()):
        x = k1_inputs(device=device, seed=i, **c)
        before = (fa.launches_tc, fa.launches_f32)
        out, lse = fa.flash_forward(**x)
        torch.cuda.synchronize()
        took_tc = (fa.launches_tc - before[0], fa.launches_f32 - before[1])
        if took_tc != ((1, 0) if c["dtype"] == torch.bfloat16 else (0, 1)):
            raise AssertionError(f"K1 case {name} ({c['dtype']}) launched "
                                 f"(tensor-core, CUDA-core) {took_tc}")
        want_out, want_lse = fa.reference_forward(**x)
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
        rec = {"phase": "k1_check", "case": name,
               "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]],
               "dtype": str(c["dtype"]).replace("torch.", ""),
               "max_abs_err": err, "lse_rel_err": lse_err, "tol": tol,
               "ok": ok}
        emit(rec)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {rec}")
        worst[name] = err
    # times at the bulk-embed shapes, the paths' hot calls
    timed = {}
    for case in timed_cases:
        c = cases[case]
        x = k1_inputs(device=device, seed=100, **c)
        if x["bias"] is None:
            mask4, kind = x["kv_mask"][:, None, None, :], "bool mask"
        else:       # the bias and the padding as one float mask [B,H,L,S]
            neg = torch.zeros(x["kv_mask"].shape, device=device).masked_fill(
                ~x["kv_mask"], float("-inf"))
            mask4 = (x["bias"][None] + neg[:, None, None, :]).to(c["dtype"])
            kind = "float mask: bias + padding"
        t = {
            "kernel_ms": cuda_ms(lambda: fa.flash_forward(**x)),
            "plain_ms": cuda_ms(lambda: fa.reference_forward(**x)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                x["q"], x["k"], x["v"], attn_mask=mask4)),
        }
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
            "timed": timed}


# -- phase 3: K2, K3 and K4 against the plain backward ----------------------

def k23_inputs(device, seed, **case):
    """K1's inputs plus an upstream gradient g (f32, laid out like the
    towers hand it over when q is strided) and K1's out and lse."""
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
                                    x["bias"])
    return {"q": x["q"], "k": x["k"], "v": x["v"], "kv_mask": x["kv_mask"],
            "bias": x["bias"], "g": g, "out": out, "lse": lse}


def bwd_bound(x) -> dict:
    """Least time of the dq kernel (K2, or K4 with a bias) and of K3 for
    these inputs: each input read once, each output written once, against
    the operations each does (2 flops per multiply-add) at the peak rate
    of q's type. With a bias K4 also reads it and writes dbias, and K3
    reads it."""
    q, k = x["q"], x["k"]
    B, H, L, Dh = q.shape
    S = k.shape[2]
    nb = lambda t: 0 if t is None else t.numel() * t.element_size()
    row = B * H * L * 4                                  # lse or delta, f32
    mask, bias = nb(x["kv_mask"]), nb(x["bias"])
    dq_bytes = (nb(q) + nb(k) + nb(x["v"]) + nb(x["g"]) + nb(x["out"]) + row
                + mask + 2 * bias + nb(q) + row)         # + dq, delta, dbias
    dkv_bytes = (nb(q) + nb(k) + nb(x["v"]) + nb(x["g"]) + 2 * row + mask
                 + bias + nb(k) + nb(x["v"]))            # + dk, dv
    mac = 2.0 * B * H * L * S * Dh                       # one [L,S,Dh] product
    out = {}
    for name, nbytes, flops in (("dq", dq_bytes, 3 * mac),     # s, dp, dq
                                ("dkv", dkv_bytes, 4 * mac)):  # s, dp, dk, dv
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
        out[name] = {"bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def check_bwd_case(phase: str, name: str, c: dict, x: dict) -> dict:
    """flash_backward (K2 + K3, or K4 + K3 with a bias) against
    reference_backward on one case; raises on a disagreement. Returns the
    largest absolute error of each gradient."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["g"], x["out"], x["lse"],
            x["bias"])
    before = (fa.dkv_launches_tc, fa.dkv_launches_f32)
    got = fa.flash_backward(*args)
    torch.cuda.synchronize()
    took = (fa.dkv_launches_tc - before[0], fa.dkv_launches_f32 - before[1])
    if took != ((1, 0) if c["dtype"] == torch.bfloat16 else (0, 1)):
        raise AssertionError(f"K3 case {name} ({c['dtype']}) launched "
                             f"(tensor-core, CUDA-core) {took}")
    want = fa.reference_backward(*args)
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
    rec = {"phase": phase, "case": name,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]],
           "dtype": str(c["dtype"]).replace("torch.", ""),
           "max_abs_err": errs, "rtol": rtol, "atol": atol, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"the backward kernels disagree with "
                             f"reference_backward: {rec}")
    return errs


def check_k23(device, timed_case: str) -> dict:
    """K2 + K3 (through flash_backward) vs reference_backward on every
    case; each kernel timed alone at the page tower's training shape."""
    import torch.nn.functional as F
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
    q, k, v, mask, g = x["q"], x["k"], x["v"], x["kv_mask"], x["g"]
    _, delta = fa.launch_dq(q, k, v, mask, g, x["out"], x["lse"])
    bitwise = k3_bitwise(x, delta, timed_case)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask[:, None, None, :])
    g_lib = g.to(sdpa_out.dtype)
    t = {
        "k2_ms": cuda_ms(lambda: fa.launch_dq(q, k, v, mask, g, x["out"],
                                            x["lse"])),
        "k3_ms": cuda_ms(lambda: fa.launch_dkv(q, k, v, mask, g, x["lse"],
                                             delta)),
        "k2_k3_ms": cuda_ms(lambda: fa.flash_backward(
            q, k, v, mask, g, x["out"], x["lse"])),
        "plain_ms": cuda_ms(lambda: fa.reference_backward(
            q, k, v, mask, g, x["out"], x["lse"]), iters=5),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), g_lib, retain_graph=True)),
    }
    b = bwd_bound(x)
    rec = {"phase": "k23_timing", "case": timed_case,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]], **t,
           "bound": b,
           "plain_call": "reference_backward (K2 and K3 together)",
           "library_call": "autograd backward of torch.nn.functional."
                           "scaled_dot_product_attention (bool mask), "
                           "against K2 + K3 together"}
    emit(rec)
    return {"worst": worst, "bound": b, "k3_bitwise": bitwise, **t}


def k3_bitwise(x: dict, delta, case: str) -> bool:
    """Two runs of K3 on the same inputs give bitwise equal dk and dv (one
    writer per element, a fixed order over the Q tiles); raises if not."""
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["g"], x["lse"], delta,
            x["bias"])
    first = fa.launch_dkv(*args)
    again = fa.launch_dkv(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    emit({"phase": "k3_bitwise", "case": case,
          "bias": x["bias"] is not None, "dk_dv_equal": equal})
    if not equal:
        raise AssertionError(f"two runs of K3 gave different dk or dv "
                             f"({case})")
    return equal


def check_k4(device, timed_case: str) -> dict:
    """K4 + the biased K3 (through flash_backward) vs the biased
    reference_backward on every case; two runs of K4 bitwise equal; each
    kernel timed alone at the mT5 page tower's training shape."""
    import torch.nn.functional as F
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
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
    q, k, v, mask, g = x["q"], x["k"], x["v"], x["kv_mask"], x["g"]
    bias, out, lse = x["bias"], x["out"], x["lse"]
    first = fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse)
    again = fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse)
    bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    emit({"phase": "k4_bitwise", "case": timed_case,
          "dq_delta_dbias_equal": bitwise})
    if not bitwise:
        raise AssertionError("two runs of K4 gave different dq or dbias")
    delta = first[1]
    del again
    k3_bits = k3_bitwise(x, delta, timed_case)
    qs, ks, vs, bs = (t.detach().requires_grad_(True) for t in (q, k, v, bias))
    neg = torch.zeros(mask.shape, device=device).masked_fill(
        ~mask, float("-inf"))
    fmask = (bs[None] + neg[:, None, None, :]).to(q.dtype)
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)
    g_lib = g.to(sdpa_out.dtype)
    t = {
        "k4_ms": cuda_ms(lambda: fa.launch_dq_dbias(q, k, v, mask, bias, g,
                                                  out, lse)),
        "k3_bias_ms": cuda_ms(lambda: fa.launch_dkv(q, k, v, mask, g, lse,
                                                  delta, bias)),
        "k4_k3_ms": cuda_ms(lambda: fa.flash_backward(q, k, v, mask, g, out,
                                                    lse, bias)),
        "plain_ms": cuda_ms(lambda: fa.reference_backward(
            q, k, v, mask, g, out, lse, bias), iters=5),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs, bs), g_lib, retain_graph=True)),
    }
    b = bwd_bound(x)
    rec = {"phase": "k4_timing", "case": timed_case,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]], **t,
           "bound": b,
           "plain_call": "reference_backward with the bias (K4 and K3 "
                         "together)",
           "library_call": "autograd backward of torch.nn.functional."
                           "scaled_dot_product_attention (float mask: bias "
                           "+ padding; the gradients of q, k, v and the "
                           "bias), against K4 + K3 together"}
    emit(rec)
    return {"worst": worst, "bound": b, "bitwise": bitwise,
            "k3_bitwise": k3_bits, **t}


def device_breakdown(fn, iters: int = 5) -> dict:
    """Device time of fn() by kernel class, from torch.profiler (CUPTI):
    per-call milliseconds of K1, K2, K3, K4, of matrix products, and of
    the rest, plus the six largest kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / iters)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    classes = {"k1_flash_fwd": 0.0, "k2_flash_bwd_dq": 0.0,
               "k3_flash_bwd_dkv": 0.0, "k4_flash_bwd_dq_dbias": 0.0,
               "matmul": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_fwd" in low:
            classes["k1_flash_fwd"] += ms
        elif "dbias" in low:             # K4's two launches
            classes["k4_flash_bwd_dq_dbias"] += ms
        elif "flash_bwd_dq" in low:
            classes["k2_flash_bwd_dq"] += ms
        elif "flash_bwd_dkv" in low:
            classes["k3_flash_bwd_dkv"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return {"device_ms_per_call": sum(ms for _, ms in kernels),
            "by_class_ms": classes,
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
    """The toy corpus of n_pages pages and the subword tokenizers trained
    on it (the serving and training phases share them); `tokenizers` is
    the result of train_tokenizers when it ran elsewhere."""
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus
    cfg = data_config(config, n_pages)
    corpus = build_corpus(cfg)
    q_tok, p_tok, tok_s = tokenizers or train_tokenizers(cfg)
    if p_tok.vocab_size != cfg.data.vocab_size:
        raise AssertionError(f"vocab {p_tok.vocab_size} != "
                             f"{cfg.data.vocab_size}")
    emit({"phase": "tokenizer", "config": config,
          "style": cfg.data.tokenizer, "vocab_size": p_tok.vocab_size,
          "train_s": tok_s, "corpus_pages": n_pages,
          "languages": cfg.data.languages})
    return corpus, q_tok, p_tok


def run_slice(device, config: str, n_pages: int, n_queries: int,
              workdir: str, data) -> dict:
    """Bulk embeds the first n_pages pages of the data's corpus into a
    store, serves queries from it, and checks the results."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import build_corpus, to_device
    from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk

    overrides = {"model.attention": "flash", "data.num_pages": n_pages,
                 "eval.store_shard_size": 65_536,
                 "eval.embed_batch_size": 512}
    cfg = get_config(config, overrides)
    m = cfg.model
    _, q_tok, p_tok = data
    corpus = build_corpus(cfg)   # page i is the same text at every size

    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    # warm the card (cuBLAS handles, the kernel library) outside the run
    emb.embed_pages(np.zeros((8, cfg.data.page_len), np.int32))
    emb.embed_queries(np.zeros((8, cfg.data.query_len), np.int32))
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
    # ------------------------------------------------------------------
    if launches_tc != launches:
        raise AssertionError(f"{launches - launches_tc} of {launches} bf16 "
                             "K1 launches missed the tensor-core kernel")
    bs = cfg.eval.embed_batch_size
    ss = cfg.eval.store_shard_size
    n_batches = sum(-(-min(ss, n_pages - lo) // bs)
                    for lo in range(0, n_pages, ss))
    encode_calls = n_batches + 1 + LATENCY_SAMPLES  # embed, batch, singles
    expected = encode_calls * m.num_layers
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

    # flash towers vs dense towers on the same weights and pages, and the
    # stored rows vs a fresh encode of the same first batch
    dense = build_two_tower(
        get_config(config, {**overrides, "model.attention": "dense"}),
        vocab_size=p_tok.vocab_size, device=device)
    dense.load_state_dict(model.state_dict())
    dense_emb = BulkEmbedder(cfg, dense, p_tok, device=device)
    ids = to_device(p_tok.encode_batch(
        [corpus.page_text(i) for i in range(bs)]), device)
    fa.launches = 0                 # K1 launches of one 512-page encode
    v_flash = emb.encode_pages(ids).float()
    launches_per_batch = fa.launches
    if launches_per_batch != m.num_layers:
        raise AssertionError(f"one encode launched K1 {launches_per_batch} "
                             f"times, want {m.num_layers} (one per layer)")
    v_dense = dense_emb.encode_pages(ids).float()
    flash_dense_err = (v_flash - v_dense).abs().max().item()
    if not flash_dense_err <= 5e-3:
        raise AssertionError(f"flash vs dense page vectors differ by "
                             f"{flash_dense_err} (tolerance 5e-3)")
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

    del dense, dense_emb
    recall, n_eval = evaluate_recall(emb, corpus, store, num_queries=1000,
                                     k=10)
    rec = {
        "phase": "slice", "config": cfg.name, "attention": m.attention,
        "layers": m.num_layers, "model_dim": m.model_dim,
        "heads": m.num_heads, "mlp_dim": m.mlp_dim, "out_dim": m.out_dim,
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
        "topk_score_err": score_err, "topk_tie_swaps": mism,
        "flash_vs_dense_max_err": flash_dense_err,
        "store_vs_fresh_encode_err": stored_err,
        "recall_at_10_random_weights": recall, "recall_queries": n_eval,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


# -- phases 5 and 7: training --------------------------------------------

def _grads(model, batch, generator=None) -> dict:
    """Parameter gradients of the contrastive loss on one batch."""
    from dnn_page_vectors_tpu_torch.models.losses import (
        cosine_contrastive_loss)
    model.zero_grad(set_to_none=True)
    q, p, neg, scale = model(batch["query"], batch["page"], None,
                             generator=generator)
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


# the two training cells: the config, its batch (pages a step), and the
# rows and bounds of the flash vs dense gradient comparison
TRAIN_CELLS = {
    "bert_mini_v5p16": dict(batch=TRAIN_BATCH, bf16_rows=TRAIN_BATCH,
                            f32_rows=F32_ROWS, bf16_tol=FLASH_DENSE_GRAD_TOL),
    MT5: dict(batch=MT5_TRAIN_BATCH, bf16_rows=MT5_BF16_ROWS,
              f32_rows=MT5_F32_ROWS, bf16_tol=MT5_FLASH_DENSE_GRAD_TOL),
}


def run_training(device, config: str, data, workdir: str) -> dict:
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import TrainBatcher, to_device
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    from dnn_page_vectors_tpu_torch.train.loop import (
        Trainer, dropout_generator)

    cell = TRAIN_CELLS[config]
    corpus, q_tok, p_tok = data
    overrides = {"model.attention": "flash",
                 "data.num_pages": corpus.num_pages, "train.log_every": 1,
                 "train.batch_size": cell["batch"]}
    cfg = get_config(config, overrides)
    m, t = cfg.model, cfg.train
    per_layer = 2 * m.num_layers         # one launch per layer per tower
    biased = m.encoder == "t5"           # K4 replaces K2 on the bias path
    per_step = [per_layer, 0 if biased else per_layer, per_layer,
                per_layer if biased else 0]

    def new_trainer():
        return Trainer(cfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                       device=device)

    def counts():
        return [fa.launches, fa.dq_launches, fa.dkv_launches,
                fa.dq_dbias_launches]

    # ---- the main path, counted: Trainer.train from text ---------------
    trainer = new_trainer()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts()
    tensor_core = {"k1": fa.launches_tc, "k3": fa.dkv_launches_tc}
    # ------------------------------------------------------------------
    if launches != [TRAIN_STEPS * n for n in per_step]:
        raise AssertionError(f"K1/K2/K3/K4 launched {launches} times in "
                             f"{TRAIN_STEPS} steps, want "
                             f"{[TRAIN_STEPS * n for n in per_step]}")
    if tensor_core != {"k1": launches[0], "k3": launches[2]}:
        raise AssertionError(f"of {launches[0]} K1 and {launches[2]} K3 "
                             f"launches (all bf16) only {tensor_core} took "
                             "the tensor-core kernels")
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
    if one_step != per_step:
        raise AssertionError(f"one step launched K1/K2/K3/K4 {one_step} "
                             f"times, want {per_step}")
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
    ckpt = CheckpointManager(os.path.join(workdir, f"ckpt_{config}"),
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
    rows = {k: v[:cell["bf16_rows"]] for k, v in batches[2].items()}
    bf16 = flash_vs_dense(config, overrides, p_tok.vocab_size, rows, device,
                          "bfloat16")
    rows = {k: v[:cell["f32_rows"]] for k, v in batches[2].items()}
    f32 = flash_vs_dense(config, overrides, p_tok.vocab_size, rows, device,
                         "float32")
    for rec, tol in ((bf16, cell["bf16_tol"]),
                     (f32, FLASH_DENSE_GRAD_TOL_F32)):
        if not rec["max_rel_err"] <= tol:
            raise AssertionError(f"flash vs dense gradients differ: {rec} "
                                 f"(bound {tol})")
        if not rec["key_bias_over_wk"] <= KEY_BIAS_GRAD_TOL:
            raise AssertionError(f"a key-bias gradient (exactly 0 in exact "
                                 f"arithmetic) is not small: {rec}")

    names = ("k1", "k2", "k3", "k4")
    rec = {
        "phase": "train", "config": cfg.name, "attention": m.attention,
        "layers": m.num_layers, "model_dim": m.model_dim, "heads": m.num_heads,
        "mlp_dim": m.mlp_dim, "out_dim": m.out_dim,
        "vocab": p_tok.vocab_size, "batch_pages": t.batch_size,
        "config_batch_pages": get_config(config).train.batch_size,
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
        "launches_one_step": dict(zip(names, one_step)),
        "losses": losses, "history": hist,
        "timed_vs_main_path_loss_max_diff": main_diff,
        "resume_loss_max_diff": resume_diff,
        "resume_loss_tol": RESUME_LOSS_TOL,
        "bitwise_equal_grads": True,
        "flash_vs_dense_grads_bf16": {**bf16, "tol": cell["bf16_tol"],
                                      "rows": cell["bf16_rows"]},
        "flash_vs_dense_grads_f32": {**f32, "tol": FLASH_DENSE_GRAD_TOL_F32,
                                     "rows": cell["f32_rows"]},
        "key_bias_grad_tol": KEY_BIAS_GRAD_TOL,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


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
            if base and "dbias_sum" not in name:
                # the tensor-core kernels take bf16 only, the rest f32
                # unless instantiated for bf16; DP is the tensor-core
                # kernels' head-dim width, Lb1E a bias template flag
                args = ["bf16" if "_tc_" in name or "nv_bfloat16" in mangled
                        else "f32"]
                width = re.search(r"kernelILi(\d+)E", mangled)
                if width:
                    args.append(f"Dh<={width.group(1)}")
                if "Lb1E" in mangled:
                    args.append("bias")
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


def run_ab(parent: str) -> dict:
    """scripts/bwd_ab.py over the tree `parent` and this checkout in turns
    (parent, this, this, parent), one process per tree on this card: each
    kernel's time in each run at the shapes the script names, with CUDA
    events around back-to-back calls and as the profiler's device time."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "scripts", "bwd_ab.py"), parent,
         here, here, parent], capture_output=True, text=True, timeout=900,
        check=False)
    if proc.returncode != 0:
        raise AssertionError(f"scripts/bwd_ab.py failed:\n"
                             f"{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])["summary"]
    rec = {"phase": "ab", "script": "scripts/bwd_ab.py", "parent": parent,
           "order": "parent, this, this, parent",
           "parent_ms": summary[parent], "this_ms": summary[here]}
    emit(rec)
    return rec


def run_phases(device, report: dict, mt5_tok, parent=None) -> list:
    """Phases 2-7; fills `report` and returns the `kernels` line's
    entries. `mt5_tok` is the future of the mT5 tokenizers; with `parent`
    (another tree of the port) the kernels are also timed against it."""
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
        if not any(r[0].startswith(TC_KERNELS[src]) for r in tc_rows):
            raise AssertionError(f"no ptxas summary of {TC_KERNELS[src]} in "
                                 f"the build log of {src}: {rows}")
        spills = [r for r in tc_rows if r[2] or r[3]]
        if spills:
            raise AssertionError(f"a tensor-core kernel spills: {spills}")
    emit({"phase": "build_total", "seconds": time.perf_counter() - t0})

    k1 = report["k1"] = check_k1(device, ("embed_bf16",
                                          "mt5_page_bias_bf16"))
    k23 = report["k23"] = check_k23(device, "page_train_bf16")
    k4 = report["k4"] = check_k4(device, "mt5_page_train_bf16")
    if parent is not None:
        report["ab"] = run_ab(parent)
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".chip_smoke_") as tmp:
        data = build_data("bert_mini_v5p16", N_PAGES)
        report["slice"] = run_slice(device, "bert_mini_v5p16", N_PAGES,
                                    N_QUERIES, tmp, data)
        report["train"] = run_training(device, "bert_mini_v5p16", data, tmp)
        t0 = time.perf_counter()
        tokenizers = mt5_tok.get()
        emit({"phase": "mt5_tokenizer_wait", "seconds":
              time.perf_counter() - t0})
        data = build_data(MT5, MT5_VOCAB_PAGES, tokenizers)
        report["mt5_slice"] = run_slice(device, MT5, MT5_PAGES, N_QUERIES,
                                        tmp, data)
        report["mt5_train"] = run_training(device, MT5, data, tmp)
    return kernel_entries(report)


def kernel_entries(report: dict) -> list:
    """The `kernels` line: one entry per kernel, launches summed over the
    main paths (each path's count read around its own run); with the A/B
    run, the --parent tree's kernel time and this tree's beside it (means
    of the two runs of each tree; CUDA events around back-to-back calls,
    and the profiler's device time); the registers and spills of each
    instantiation."""
    k1, k23, k4 = report["k1"], report["k23"], report["k4"]
    ab = report.get("ab")

    def parent(key):
        if ab is None:
            return {"parent_ms": None, "parent_note": "not measured: run "
                    "with --parent TREE (the parent commit's checkout)"}
        mean = lambda xs: sum(xs) / len(xs)
        par, this = ab["parent_ms"], ab["this_ms"]
        return {"parent_ms": mean(par[key]), "ab_ms": mean(this[key]),
                "ab_runs_ms": {"parent": par[key], "this": this[key]},
                "parent_device_ms": mean(par["device_ms"][key]),
                "ab_device_ms": mean(this["device_ms"][key])}

    rows = [r for src in SOURCES for r in report["build"][src]["ptxas"]
            if isinstance(r, list)]

    def ptxas(*prefixes):
        return [r for r in rows if r[0].startswith(prefixes)]
    paths = {"bert_serving": report["slice"]["k1_launches"],
             "mt5_serving": report["mt5_slice"]["k1_launches"]}
    by_path = {n: {} for n in ("k1", "k2", "k3", "k4")}
    for path, rec in (("bert_training", report["train"]),
                      ("mt5_training", report["mt5_train"])):
        for n, count in rec["launches_main_path"].items():
            by_path[n][path] = count
    by_path["k1"].update(paths)
    tc_by_path = {
        "k1": {"bert_serving": report["slice"]["k1_launches_tensor_core"],
               "mt5_serving": report["mt5_slice"]["k1_launches_tensor_core"]},
        "k3": {}}
    for path, rec in (("bert_training", report["train"]),
                      ("mt5_training", report["mt5_train"])):
        for n, count in rec["launches_tensor_core_main_path"].items():
            tc_by_path[n][path] = count
    bert_pair = {"k2_k3_ms": k23["k2_k3_ms"]}
    mt5_pair = {"k4_k3_ms": k4["k4_k3_ms"]}
    bert_shape = f"B={TRAIN_BATCH} H=4 L=S=64 Dh=64 bf16 q/k/v, f32 g"
    mt5_shape = (f"B={MT5_TRAIN_BATCH} H=12 L=S=128 Dh=64 bf16 q/k/v, f32 g, "
                 "f32 bias")
    k1_bert = k1["timed"]["embed_bf16"]
    k1_mt5 = k1["timed"]["mt5_page_bias_bf16"]
    per_step = lambda n: {"bert": report["train"]["launches_one_step"][n],
                          "mt5": report["mt5_train"]["launches_one_step"][n]}
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
                "library_ms": k1_mt5["library_ms"], **parent("k1_mt5_ms")}}, {
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
        "ptxas": ptxas("flash_bwd_dq_kernel")}, {
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
        "ptxas": ptxas("flash_bwd_dq_dbias", "flash_bwd_dbias_sum")}]


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

    # the mT5 vocab is host work of minutes: train it in a second process
    # while the card works on the builds, the checks and BERT-mini; the
    # process is ended with the run, whether it succeeded or not
    tok_pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        mt5_tok = tok_pool.apply_async(
            train_tokenizers, (data_config(MT5, MT5_VOCAB_PAGES),))
        kernels = run_phases(device, report, mt5_tok, args.parent)
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
