#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (dnn_page_vectors_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each printing one JSON line:
  1. device: the card, its power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA source of the two paths (K1 in flash_fwd.cu, K2 and
     K3 in flash_bwd.cu) is compiled with nvcc for sm_90a from the checkout
     (build/torch_kernels/), one nvcc per source, all started together;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the paths' shapes and the contract's edge cases, with the
     tolerance stated; plus its time, the plain version's, one PyTorch
     library call's (a yardstick the port never calls) and its bound;
  4. serving: BERT-mini (config bert_mini_v5p16, full width, random
     weights from a seeded torch.Generator, flash attention) trains the
     30,522-piece WordPiece vocab over a 100,000-page toy corpus, bulk
     embeds every page into the fp16 store, stages the store on the card
     and answers 32 queries through SearchService. Every kernel launch
     counter is set to 0 just before and read just after; the results are
     checked against a plain full q @ store^T top-k and against dense
     attention;
  5. training: a flash-attention Trainer at full width takes 6 steps of
     8,192 pages from the same corpus through Trainer.train (counted:
     K1, K2 and K3 launch 8 times a step), then 6 steps on pre-made
     batches are timed (the first 2 warm up) and one is profiled by kernel
     class; flash gradients are held against dense ones, two runs of one
     step must give bitwise equal gradients, and 3 steps + save + restore
     into a fresh Trainer + 3 steps must give the losses of 6 straight.
Then the `kernels` line, the card's name and power limit as nvidia-smi
prints them, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present, when
the port is not importable (run from the root of a checkout), or when any
phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
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
K1_SOURCE = "dnn_page_vectors_tpu_torch/csrc/flash_fwd.cu"
K23_SOURCE = "dnn_page_vectors_tpu_torch/csrc/flash_bwd.cu"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
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
              seg=False, strided=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if strided:      # [B, len, H, Dh] viewed as [B, H, len, Dh], as the
        q, k, v = (torch.randn(B, n, H, Dh, generator=g)   # towers pass it
                   .to(device, dtype).transpose(1, 2) for n in (L, S, S))
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


def check_k1(device, timed_case: str) -> dict:
    """Kernel vs plain version on every case (the serving and training
    paths' shapes and the edge cases); times at the embed shape."""
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
    }
    worst = {}
    for i, (name, c) in enumerate(cases.items()):
        x = k1_inputs(device=device, seed=i, **c)
        out, lse = fa.flash_forward(**x)
        torch.cuda.synchronize()
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
    # times at the bulk-embed shape, the path's hot call
    c = cases[timed_case]
    x = k1_inputs(device=device, seed=100, **c)
    mask4 = x["kv_mask"][:, None, None, :]
    t = {
        "kernel_ms": cuda_ms(lambda: fa.flash_forward(**x)),
        "plain_ms": cuda_ms(lambda: fa.reference_forward(**x)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            x["q"], x["k"], x["v"], attn_mask=mask4)),
    }
    b = k1_bound(x)
    rec = {"phase": "k1_timing", "case": timed_case,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]], **t,
           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "bytes": b["bytes"], "flops": b["flops"],
           "library_call": "torch.nn.functional.scaled_dot_product_attention"
                           " (bool mask)"}
    emit(rec)
    return {"max_abs_err": max(worst.values()), "worst": worst, **t, **b}


# -- phase 3: K2 and K3 against the plain backward ---------------------------

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
        out, lse = fa.flash_forward(x["q"], x["k"], x["v"], x["kv_mask"])
    return {"q": x["q"], "k": x["k"], "v": x["v"], "kv_mask": x["kv_mask"],
            "g": g, "out": out, "lse": lse}


def k23_bound(x) -> dict:
    """Least time of K2 and of K3 for these inputs: each input read once,
    each output written once, against the operations each does (2 flops
    per multiply-add) at the peak rate of q's type."""
    q, k = x["q"], x["k"]
    B, H, L, Dh = q.shape
    S = k.shape[2]
    nb = lambda t: t.numel() * t.element_size()
    row = B * H * L * 4                                  # lse or delta, f32
    mask = nb(x["kv_mask"])
    k2_bytes = (nb(q) + nb(k) + nb(x["v"]) + nb(x["g"]) + nb(x["out"]) + row
                + mask + nb(q) + row)                    # + dq, delta
    k3_bytes = (nb(q) + nb(k) + nb(x["v"]) + nb(x["g"]) + 2 * row + mask
                + nb(k) + nb(x["v"]))                    # + dk, dv
    mac = 2.0 * B * H * L * S * Dh                       # one [L,S,Dh] product
    out = {}
    for name, nbytes, flops in (("k2", k2_bytes, 3 * mac),     # s, dp, dq
                                ("k3", k3_bytes, 4 * mac)):    # s, dp, dk, dv
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
        out[name] = {"bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


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
    }
    worst = {}
    for i, (name, c) in enumerate(cases.items()):
        x = k23_inputs(device, seed=200 + i, **c)
        args = (x["q"], x["k"], x["v"], x["kv_mask"], x["g"], x["out"],
                x["lse"])
        got = fa.flash_backward(*args)
        torch.cuda.synchronize()
        want = fa.reference_backward(*args)
        rtol, atol = GRAD_TOL[c["dtype"]]
        errs, ok = {}, True
        for gname, a, b, t in zip(("dq", "dk", "dv"), got, want,
                                  (x["q"], x["k"], x["v"])):
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
        rec = {"phase": "k23_check", "case": name,
               "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]],
               "dtype": str(c["dtype"]).replace("torch.", ""),
               "max_abs_err": errs, "rtol": rtol, "atol": atol, "ok": ok}
        emit(rec)
        if not ok:
            raise AssertionError(f"K2/K3 disagree with reference_backward: "
                                 f"{rec}")
        worst[name] = {"k2": errs["dq"], "k3": max(errs["dk"], errs["dv"])}
        del x, got, want
    c = cases[timed_case]
    x = k23_inputs(device, seed=300, **c)
    q, k, v, mask, g = x["q"], x["k"], x["v"], x["kv_mask"], x["g"]
    _, delta = fa.launch_dq(q, k, v, mask, g, x["out"], x["lse"])
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
    b = k23_bound(x)
    rec = {"phase": "k23_timing", "case": timed_case,
           "shape": [c["B"], c["H"], c["L"], c["S"], c["Dh"]], **t,
           "bound": b,
           "plain_call": "reference_backward (K2 and K3 together)",
           "library_call": "autograd backward of torch.nn.functional."
                           "scaled_dot_product_attention (bool mask), "
                           "against K2 + K3 together"}
    emit(rec)
    return {"worst": worst, "bound": b, **t}


def device_breakdown(fn, iters: int = 5) -> dict:
    """Device time of fn() by kernel class, from torch.profiler (CUPTI):
    per-call milliseconds of K1, K2, K3, of matrix products, and of the
    rest, plus the six largest kernels by name."""
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
               "k3_flash_bwd_dkv": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_fwd" in low:
            classes["k1_flash_fwd"] += ms
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


# -- phase 4: the serving slice ---------------------------------------------

def build_data(n_pages: int):
    """The toy corpus and the WordPiece tokenizers trained on it (the
    serving and training phases share them)."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    cfg = get_config("bert_mini_v5p16", {"data.num_pages": n_pages})
    t0 = time.perf_counter()
    corpus = build_corpus(cfg)
    q_tok, p_tok = build_tokenizer(cfg, corpus)
    tok_s = time.perf_counter() - t0
    if p_tok.vocab_size != cfg.data.vocab_size:
        raise AssertionError(f"vocab {p_tok.vocab_size} != "
                             f"{cfg.data.vocab_size}")
    emit({"phase": "tokenizer", "vocab_size": p_tok.vocab_size,
          "train_s": tok_s, "corpus_pages": n_pages})
    return corpus, q_tok, p_tok


def run_slice(device, n_pages: int, n_queries: int, workdir: str,
              data) -> dict:
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import to_device
    from dnn_page_vectors_tpu_torch.evals.recall import recall_at_k
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk

    overrides = {"model.attention": "flash", "data.num_pages": n_pages,
                 "eval.store_shard_size": 65_536,
                 "eval.embed_batch_size": 512}
    cfg = get_config("bert_mini_v5p16", overrides)
    m = cfg.model
    corpus, q_tok, p_tok = data

    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device=device)
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device=device)
    # warm the card (cuBLAS handles, the kernel library) outside the run
    emb.embed_pages(np.zeros((8, cfg.data.page_len), np.int32))
    emb.embed_queries(np.zeros((8, cfg.data.query_len), np.int32))
    torch.cuda.synchronize()

    store = VectorStore(os.path.join(workdir, "store"), dim=m.out_dim,
                        shard_size=cfg.eval.store_shard_size)
    qids = np.linspace(0, n_pages - 1, n_queries).astype(np.int64)
    queries = [corpus.query_text(int(i)) for i in qids]

    # ---- the main path, counted --------------------------------------
    fa.launches = 0
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
    launches = fa.launches
    # ------------------------------------------------------------------
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
        get_config("bert_mini_v5p16", {**overrides,
                                       "model.attention": "dense"}),
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

    eval_q = np.arange(0, n_pages, max(1, n_pages // 1000))[:1000]
    qvec = emb.embed_texts([corpus.query_text(int(i)) for i in eval_q],
                           tower="query", batch_size=bs)
    recall = recall_at_k(qvec, svc.page_ids, svc.pages, eval_q, k=10,
                         device=device)
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
        "k1_launches_per_embed_batch": launches_per_batch,
        "topk_score_err": score_err, "topk_tie_swaps": mism,
        "flash_vs_dense_max_err": flash_dense_err,
        "store_vs_fresh_encode_err": stored_err,
        "recall_at_10_random_weights": recall,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


# -- phase 5: the training slice --------------------------------------------

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


def flash_vs_dense(overrides, vocab, batch, device, dtype) -> dict:
    """Parameter gradients of flash and dense towers with the same seeded
    weights, dropout off, at model.dtype `dtype`: the largest relative
    error ||flash - dense|| / ||dense|| over the gradient tensors.

    A key bias shifts every score of a query row by the same q.b, which
    the softmax ignores: its exact gradient is 0 and both versions hold
    rounding noise there, so it is held to a bound relative to its layer's
    wk.weight gradient instead of to itself."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    grads, state = {}, None
    for att in ("flash", "dense"):
        c = get_config("bert_mini_v5p16", {
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
    for n in ("wq", "wk", "wv"):
        name = f"page_tower.block0.attn.{n}.weight"
        if not grads["flash"][name].abs().max().item() > 0:
            raise AssertionError(f"{name} got no gradient through flash")
    worst = max(rel, key=rel.get)
    return {"max_rel_err": rel[worst], "worst_tensor": worst,
            "key_bias_over_wk": max(key_bias.values())}


def run_training(device, data, workdir: str) -> dict:
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import TrainBatcher, to_device
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    from dnn_page_vectors_tpu_torch.train.loop import (
        Trainer, dropout_generator)

    corpus, q_tok, p_tok = data
    overrides = {"model.attention": "flash",
                 "data.num_pages": corpus.num_pages, "train.log_every": 1}
    cfg = get_config("bert_mini_v5p16", overrides)
    m, t = cfg.model, cfg.train
    if t.batch_size != TRAIN_BATCH:
        raise AssertionError(f"config batch {t.batch_size} != {TRAIN_BATCH}")
    per_step = 2 * m.num_layers          # one launch per layer per tower

    def new_trainer():
        return Trainer(cfg, corpus=corpus, tokenizers=(q_tok, p_tok),
                       device=device)

    def counts():
        return [fa.launches, fa.dq_launches, fa.dkv_launches]

    # ---- the main path, counted: Trainer.train from text ---------------
    trainer = new_trainer()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    t0 = time.perf_counter()
    trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts()
    # ------------------------------------------------------------------
    if launches != [TRAIN_STEPS * per_step] * 3:
        raise AssertionError(f"K1/K2/K3 launched {launches} times in "
                             f"{TRAIN_STEPS} steps, want "
                             f"{TRAIN_STEPS * per_step} each")
    hist = trainer.history
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite([h["loss"], h["grad_norm"]]).all() and h["loss"] > 0
            for h in hist):
        raise AssertionError(f"training metrics are not finite: {hist}")

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
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    straight.train_step(batches[0])
    torch.cuda.synchronize()
    one_step = counts()
    if one_step != [per_step] * 3:
        raise AssertionError(f"one step launched K1/K2/K3 {one_step} times, "
                             f"want {per_step} each")
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

    # ---- resume: 3 steps, save, restore into a fresh Trainer, 3 steps ------
    first = new_trainer()
    for b in batches[:3]:
        first.train_step(b)
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=1)
    first.save(ckpt)
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
    del first, resumed, trainer

    # ---- bitwise: one step's gradients twice, dropout on ---------------------
    g1 = _grads(straight.model, batches[2],
                dropout_generator(t.seed, 0, device))
    g2 = _grads(straight.model, batches[2],
                dropout_generator(t.seed, 0, device))
    differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    if differ:
        raise AssertionError(f"two runs of one step gave different "
                             f"gradients for {differ}")
    del g1, g2

    # ---- flash vs dense gradients, dropout off, the seeded weights ----------
    bf16 = flash_vs_dense(overrides, p_tok.vocab_size, batches[2], device,
                          "bfloat16")
    f32_batch = {k: v[:F32_ROWS] for k, v in batches[2].items()}
    f32 = flash_vs_dense(overrides, p_tok.vocab_size, f32_batch, device,
                         "float32")
    for rec, tol in ((bf16, FLASH_DENSE_GRAD_TOL),
                     (f32, FLASH_DENSE_GRAD_TOL_F32)):
        if not rec["max_rel_err"] <= tol:
            raise AssertionError(f"flash vs dense gradients differ: {rec} "
                                 f"(bound {tol})")
        if not rec["key_bias_over_wk"] <= KEY_BIAS_GRAD_TOL:
            raise AssertionError(f"a key-bias gradient (exactly 0 in exact "
                                 f"arithmetic) is not small: {rec}")

    rec = {
        "phase": "train", "config": cfg.name, "attention": m.attention,
        "layers": m.num_layers, "model_dim": m.model_dim, "heads": m.num_heads,
        "mlp_dim": m.mlp_dim, "out_dim": m.out_dim,
        "vocab": p_tok.vocab_size, "batch_pages": t.batch_size,
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
        "launches_main_path": {"k1": launches[0], "k2": launches[1],
                               "k3": launches[2]},
        "launches_one_step": {"k1": one_step[0], "k2": one_step[1],
                              "k3": one_step[2]},
        "losses": losses, "history": hist,
        "timed_vs_main_path_loss_max_diff": main_diff,
        "resume_loss_max_diff": resume_diff,
        "resume_loss_tol": RESUME_LOSS_TOL,
        "bitwise_equal_grads": True,
        "flash_vs_dense_grads_bf16": {**bf16, "tol": FLASH_DENSE_GRAD_TOL},
        "flash_vs_dense_grads_f32": {**f32, "tol": FLASH_DENSE_GRAD_TOL_F32,
                                     "rows": F32_ROWS},
        "key_bias_grad_tol": KEY_BIAS_GRAD_TOL,
        "device": torch.cuda.get_device_name(0),
    }
    emit(rec)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from dnn_page_vectors_tpu_torch.ops import build
        from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
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

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for f in [pool.submit(build.compile_source, src) for src in SOURCES]:
            f.result()
    report["build"] = {}
    for src in SOURCES:
        build.load_library(src)
        secs, log = build.BUILD_INFO.get(src, (0.0, "cached"))
        report["build"][src] = {"nvcc_s": secs}
        emit({"phase": "build", "source": src, "arch": "sm_90a",
              "nvcc_seconds": secs, "ptxas": log[-1500:]})
    emit({"phase": "build_total", "seconds": time.perf_counter() - t0})

    k1 = check_k1(device, "embed_bf16")
    report["k1"] = k1
    k23 = check_k23(device, "page_train_bf16")
    report["k23"] = k23
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".chip_smoke_") as tmp:
        data = build_data(N_PAGES)
        report["slice"] = run_slice(device, N_PAGES, N_QUERIES, tmp, data)
        report["train"] = run_training(device, data, tmp)

    serve, train = report["slice"], report["train"]
    train_launches = train["launches_main_path"]
    pair = {"k2_k3_ms": k23["k2_k3_ms"]}
    shape = f"B={TRAIN_BATCH} H=4 L=S=64 Dh=64 bf16 q/k/v, f32 g"
    kernels = [{
        "name": "flash_fwd (K1)", "route": "cuda", "source": K1_SOURCE,
        "replaces": TPU_K1,
        "launches": serve["k1_launches"] + train_launches["k1"],
        "launches_by_path": {"serving": serve["k1_launches"],
                             "training": train_launches["k1"]},
        "launches_per_embed_batch": serve["k1_launches_per_embed_batch"],
        "launches_per_train_step": train["launches_one_step"]["k1"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["kernel_ms"],
        "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "shape": "B=512 H=4 L=S=64 Dh=64 bf16"}, {
        "name": "flash_bwd_dq (K2)", "route": "cuda", "source": K23_SOURCE,
        "replaces": TPU_K2, "launches": train_launches["k2"],
        "launches_per_train_step": train["launches_one_step"]["k2"],
        "max_abs_err": max(w["k2"] for w in k23["worst"].values()),
        "ms": k23["k2_ms"], "plain_ms": k23["plain_ms"],
        "bound_ms": k23["bound"]["k2"]["bound_ms"],
        "bound_by": k23["bound"]["k2"]["bound_by"],
        "library_ms": k23["library_ms"], **pair, "shape": shape,
        "plain_and_library_cover": "K2 and K3 together"}, {
        "name": "flash_bwd_dkv (K3)", "route": "cuda", "source": K23_SOURCE,
        "replaces": TPU_K3, "launches": train_launches["k3"],
        "launches_per_train_step": train["launches_one_step"]["k3"],
        "max_abs_err": max(w["k3"] for w in k23["worst"].values()),
        "ms": k23["k3_ms"], "plain_ms": k23["plain_ms"],
        "bound_ms": k23["bound"]["k3"]["bound_ms"],
        "bound_by": k23["bound"]["k3"]["bound_by"],
        "library_ms": k23["library_ms"], **pair, "shape": shape,
        "plain_and_library_cover": "K2 and K3 together"}]
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
