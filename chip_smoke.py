#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (dnn_page_vectors_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each printing one JSON line:
  1. device: the card, its power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel of the serving path is compiled with nvcc for
     sm_90a from the sources in the checkout (build/torch_kernels/);
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the serving path's shapes and the contract's edge cases, with
     the tolerance stated; plus its time, the plain version's, one PyTorch
     library call's (a yardstick the port never calls) and its bound;
  4. the slice: BERT-mini (config bert_mini_v5p16, full width, random
     weights from a seeded torch.Generator, flash attention) trains the
     30,522-piece WordPiece vocab over a 100,000-page toy corpus, bulk
     embeds every page into the fp16 store, stages the store on the card
     and answers 32 queries through SearchService. Every kernel launch counter
     is set to 0 just before and read just after; the results are checked
     against a plain full q @ store^T top-k and against dense attention.
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

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): bf16/fp16 tensor cores, float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
TPU_K1 = "dnn_page_vectors_tpu/ops/flash_attention.py:98"
K1_SOURCE = "dnn_page_vectors_tpu_torch/csrc/flash_fwd.cu"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# single-query latency samples: enough that p95 has ten samples beyond it
LATENCY_SAMPLES = 200
# the slice's size: pages embedded into the store, queries in search_many
N_PAGES = 100_000
N_QUERIES = 32


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
              seg=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
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
    """Kernel vs plain version on every case; times at the embed shape."""
    import torch.nn.functional as F
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    cases = {
        "embed_bf16": dict(B=512, H=4, L=64, S=64, Dh=64,
                           dtype=torch.bfloat16),
        "query_bucket_bf16": dict(B=8, H=4, L=16, S=16, Dh=64,
                                  dtype=torch.bfloat16),
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


def device_breakdown(fn, iters: int = 5) -> dict:
    """Device time of fn() by kernel class, from torch.profiler (CUPTI):
    per-call milliseconds of K1, of matrix products, and of the rest, plus
    the six largest kernels by name."""
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
    classes = {"k1_flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_fwd" in low:
            classes["k1_flash_fwd"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return {"device_ms_per_call": sum(ms for _, ms in kernels),
            "by_class_ms": classes,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


# -- phase 4: the serving slice ---------------------------------------------

def run_slice(device, n_pages: int, n_queries: int, workdir: str) -> dict:
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer, to_device)
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
    t0 = time.perf_counter()
    corpus = build_corpus(cfg)
    q_tok, p_tok = build_tokenizer(cfg, corpus)
    tok_s = time.perf_counter() - t0
    if p_tok.vocab_size != cfg.data.vocab_size:
        raise AssertionError(f"vocab {p_tok.vocab_size} != "
                             f"{cfg.data.vocab_size}")
    emit({"phase": "tokenizer", "vocab_size": p_tok.vocab_size,
          "train_s": tok_s, "corpus_pages": n_pages})

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

    t0 = time.perf_counter()
    build.load_library("flash_fwd.cu")
    secs, log = build.BUILD_INFO.get("flash_fwd.cu", (0.0, "cached"))
    report["build"] = {"flash_fwd.cu": {"s": time.perf_counter() - t0,
                                        "nvcc_s": secs}}
    emit({"phase": "build", "source": K1_SOURCE, "arch": "sm_90a",
          "seconds": time.perf_counter() - t0, "ptxas": log[-1500:]})

    k1 = check_k1(device, "embed_bf16")
    report["k1"] = k1
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".chip_smoke_") as tmp:
        report["slice"] = run_slice(device, N_PAGES, N_QUERIES, tmp)

    kernels = [{
        "name": "flash_fwd (K1)", "route": "cuda", "source": K1_SOURCE,
        "replaces": TPU_K1, "launches": report["slice"]["k1_launches"],
        "launches_per_embed_batch":
            report["slice"]["k1_launches_per_embed_batch"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["kernel_ms"],
        "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "shape": "B=512 H=4 L=S=64 Dh=64 bf16"}]
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
