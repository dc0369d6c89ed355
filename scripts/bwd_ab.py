#!/usr/bin/env python3
"""Time of the port's flash-attention kernels, compared across source
trees on one GPU.

    python3 scripts/bwd_ab.py TREE [TREE ...] [--train-seg PATH]
        [--train-seg-mt5 PATH] [--out PATH]

For each TREE, in the order given (for two versions A and B: A B B A), one
process imports ``dnn_page_vectors_tpu_torch`` from TREE (its kernels build
into TREE/build/) and times each kernel call on the card two ways, one
after the other on the same inputs:

* ``KEY`` (e.g. ``k1_bert_ms``): CUDA events around 50 back-to-back calls,
  per call, the measure of earlier trees' records. It counts the kernels
  and the gaps in which the card waits for the host to issue the next
  call, so a wrapper that the host issues slower than the card runs it
  reads its host time here;
* ``device_ms[KEY]``: the kernel time torch.profiler (CUPTI) records over
  50 calls, summed over the kernels a call launches, per call: the card's
  time alone.

bf16 q/k/v with ragged padding:

* ``k2_ms``, ``k3_ms``: ``launch_dq`` (K2) and ``launch_dkv`` (K3) at
  BERT-mini's page-tower training shape, B=8192, H=4, L=S=64, Dh=64, q/k/v
  viewed from [B, L, H, Dh] as the towers pass them and an f32 upstream
  gradient laid out the same way;
* ``k1_bert_ms``: K1 (``flash_forward`` without gradients, as serving
  calls it) at BERT-mini's bulk-embed shape, B=512, H=4, L=S=64;
* ``k1_mt5_ms``, ``k4_ms``, ``k3_bias_ms``: K1, ``launch_dq_dbias`` (K4)
  and the biased ``launch_dkv`` at mT5's page shape, B=512, H=12,
  L=S=128, Dh=64, with the f32 relative-position bias [H, L, S] and
  strided views;
* ``k2_query_ms``: K2 where BERT-mini's query tower runs it in training,
  B=8192, H=4, L=S=16, Dh=64;
* ``k4_query_ms``: K4 where mT5's query tower runs it, B=512, H=12,
  L=S=16, Dh=64, with the bias;
* ``k1_seg_ms``, ``k2_seg_ms``, ``k3_seg_ms``: K1, K2 and K3 with segment
  ids at bert_long_sp's packed shape, B=256 rows, H=8, L=S=1024, Dh=64,
  4 pages a row (kv_mask = seg > 0, as the towers pass it);
* ``k4_seg_ms``, ``k3_bias_seg_ms``: K4 and the biased K3 with segment ids
  at mT5's packed shape, B=512 rows, H=12, L=S=128, Dh=64, 4 pages a row;
  K4 takes the segment summary in a tree whose K4 takes one (its skipping
  kernel), none in an older tree. A tree whose wrappers take no segment
  ids records None for these;
* ``k4_seg_train_ms``, ``k3_bias_seg_train_ms``: the same at the segment
  ids of ``--train-seg-mt5`` (a [512, 128] int32 tensor; chip_smoke.py
  saves the packed mT5 cell's first batch), None without the option;
* ``k1_seg_train_ms``, ``k2_seg_train_ms``, ``k3_seg_train_ms``: K1, K2
  and K3 at bert_long_sp's packed shape with the segment ids of
  ``--train-seg`` (a [256, 1024] int32 tensor saved with torch.save;
  chip_smoke.py saves the packed bert_long_sp cell's first batch), the
  layout the training step runs (None without the option);
* ``k1_seg_mt5_ms``: K1 with segment ids and the bias at mT5's packed
  shape;
* K1 is timed through ``flash_forward``: in a tree whose forward writes
  the segment summary (its K1 skips tiles by it), that kernel and K1;
* ``k23_seg_ms``, ``k23_seg_train_ms``: the backward at both layouts
  through ``flash_backward`` (K2 + K3, and in a tree that has them the
  segment summary kernel and the dead rows' g sum; a tree whose forward
  writes the summary gets it, as the training step does), and
  ``seg_summary_ms`` the segment summary kernel alone at the first layout
  (a tree whose forward writes it: with the dead rows' mean(V); a tree
  whose backward writes it: with the dead rows' g sum; None in a tree
  without it), ``gdead_ms`` the dead rows' g sum alone where it is a
  kernel of its own. A tree with the summary kernel times K2 and K3 alone
  on a summary made beforehand.

Each run also hashes K2's dq with segment ids at both layouts, -0 taken
as +0, and the summary line says whether every run gave the same dq
(``k2_seg_dq_equal``); K1's out and lse with segment ids at the rows
that see a key (lse > -1e29), at both layouts and at mT5's packed shape,
-0 taken as +0 (``k1_seg_out_equal``); and K4's dq with segment ids, -0
taken as +0, and its dbias bit for bit, at both of mT5's layouts
(``k4_seg_equal``).

Prints one JSON line per tree, the card's name and power limit
(nvidia-smi), and a summary line; ``--out`` also writes all of it as JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

BERT = dict(B=8192, H=4, L=64, Dh=64)
BERT_EMBED = dict(B=512, H=4, L=64, Dh=64)
MT5 = dict(B=512, H=12, L=128, Dh=64)
BERT_QUERY = dict(B=8192, H=4, L=16, Dh=64)
MT5_QUERY = dict(B=512, H=12, L=16, Dh=64)
LONG_PACKED = dict(B=256, H=8, L=1024, Dh=64)
MT5_PACKED = dict(B=512, H=12, L=128, Dh=64)
PACK = 4
SEG_KEYS = ("k1_seg_ms", "k2_seg_ms", "k3_seg_ms", "k4_seg_ms",
            "k3_bias_seg_ms", "k1_seg_train_ms", "k2_seg_train_ms",
            "k3_seg_train_ms", "k1_seg_mt5_ms", "k23_seg_ms",
            "k23_seg_train_ms", "seg_summary_ms", "gdead_ms",
            "k4_seg_train_ms", "k3_bias_seg_train_ms")
DQ_DIGESTS = ("k2_seg_dq", "k2_seg_train_dq")
OUT_DIGESTS = ("k1_seg_out", "k1_seg_train_out", "k1_seg_mt5_out")
K4_DIGESTS = ("k4_seg_dq", "k4_seg_dbias", "k4_seg_train_dq",
              "k4_seg_train_dbias")
KEYS = ("k2_ms", "k3_ms", "k1_bert_ms", "k1_mt5_ms", "k4_ms", "k3_bias_ms",
        "k2_query_ms", "k4_query_ms") + SEG_KEYS


def _event_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
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


def _device_ms(fn, iters: int = 50) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us / 1e3 / iters


def _inputs(B, H, L, Dh, gen, device, bias=False):
    """bf16 q, k, v viewed from [B, L, H, Dh], an f32 g laid out the same
    way, a ragged kv mask, and with `bias` an f32 [H, L, L] bias."""
    import torch
    q, k, v = (torch.randn(B, L, H, Dh, generator=gen)
               .to(device, torch.bfloat16).transpose(1, 2) for _ in range(3))
    g = torch.randn(B, L, H, Dh, generator=gen).to(device).transpose(1, 2)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(device)
    b = torch.randn(H, L, L, generator=gen).to(device) if bias else None
    return q, k, v, g, mask, b


def _packed(B, L, gen, device):
    """Segment ids of B rows of PACK pages of random lengths, a pad tail,
    and kv_mask = seg > 0."""
    import torch
    lens = torch.randint(1, L // PACK + 1, (B, PACK), generator=gen)
    ends = lens.cumsum(1)
    seg = (torch.arange(L)[None, :, None] >= ends[:, None, :]).sum(-1) + 1
    seg[seg > PACK] = 0
    seg = seg.to(device, torch.int32)
    return seg, seg > 0


def _digest(*tensors, signed_zeros: bool = False) -> str:
    """sha1 of the tensors' bytes with every -0 taken as +0 (kept apart
    with `signed_zeros`: bit for bit)."""
    import torch
    h = hashlib.sha1()
    for t in tensors:
        if not signed_zeros:
            t = torch.where(t == 0, torch.zeros_like(t), t)
        t = t.contiguous()
        h.update(t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _out_digest(out, lse) -> str:
    """_digest of K1's out and lse at the rows that see a key."""
    live = lse > -1e29
    return _digest(out[live], lse[live])


def _summaries(fa, seg, mask, v, lse, g):
    """(K2's extra arguments, K3's extra arguments, the backward's extra
    arguments) as the tree takes them: a tree whose forward writes the
    segment summary (and a separate dead rows' g sum), one whose backward
    writes both, or one without a summary kernel."""
    if hasattr(fa, "launch_dead_rows_sum"):
        summary = fa.launch_seg_summary(seg, mask, v)[0]
        gdead = fa.launch_dead_rows_sum(lse, g)
        return (summary,), (summary, gdead), (summary,)
    if hasattr(fa, "launch_seg_summary"):
        summary, gdead = fa.launch_seg_summary(seg, lse, g)
        return (summary,), (summary, gdead), ()
    return (), (), ()


def _seg_cases(fa, timed, rec, gen, device, train_seg) -> None:
    """The seg kernels at bert_long_sp's packed shape, at packed_seg's
    layout and (with `train_seg`) at the training batch's; in a tree with
    the segment summary kernel, K2 and K3 alone take a summary made
    beforehand."""
    import torch
    new_api = hasattr(fa, "launch_dead_rows_sum")
    q, k, v, g, _, _ = _inputs(**LONG_PACKED, gen=gen, device=device)
    seg, mask = _packed(LONG_PACKED["B"], LONG_PACKED["L"], gen, device)
    layouts = [("", seg, mask)]
    if train_seg is not None:
        tseg = train_seg.to(device, torch.int32)
        layouts.append(("_train", tseg, tseg > 0))
    for suffix, seg, mask in layouts:
        timed(f"k1_seg{suffix}_ms",
              lambda: fa.flash_forward(q, k, v, mask, None, seg))
        out, lse = fa.flash_forward(q, k, v, mask, None, seg)
        rec["out_digest"][f"k1_seg{suffix}_out"] = _out_digest(out, lse)
        extra_dq, extra_dkv, extra_bwd = _summaries(fa, seg, mask, v, lse, g)
        if not suffix and extra_dq:
            if new_api:
                timed("seg_summary_ms",
                      lambda: fa.launch_seg_summary(seg, mask, v))
                timed("gdead_ms", lambda: fa.launch_dead_rows_sum(lse, g))
            else:
                timed("seg_summary_ms",
                      lambda: fa.launch_seg_summary(seg, lse, g))
        dq, delta = fa.launch_dq(q, k, v, mask, g, out, lse, seg, *extra_dq)
        rec["dq_digest"][f"k2_seg{suffix}_dq"] = _digest(dq)
        del dq
        timed(f"k2_seg{suffix}_ms", lambda: fa.launch_dq(
            q, k, v, mask, g, out, lse, seg, *extra_dq))
        timed(f"k3_seg{suffix}_ms", lambda: fa.launch_dkv(
            q, k, v, mask, g, lse, delta, None, seg, *extra_dkv))
        timed(f"k23_seg{suffix}_ms", lambda: fa.flash_backward(
            q, k, v, mask, g, out, lse, None, seg, *extra_bwd))
        del out, lse, delta


def _mt5_seg_cases(fa, timed, rec, gen, device, train_seg) -> None:
    """K1, K4 and the biased K3 with segment ids at mT5's packed shape, at
    _packed's layout and (with `train_seg`) at the training batch's; K4
    takes the segment summary in a tree whose K4 takes one."""
    import torch
    q, k, v, g, _, bias = _inputs(**MT5_PACKED, gen=gen, device=device,
                                  bias=True)
    seg, mask = _packed(MT5_PACKED["B"], MT5_PACKED["L"], gen, device)
    layouts = [("", seg, mask)]
    if train_seg is not None:
        tseg = train_seg.to(device, torch.int32)
        layouts.append(("_train", tseg, tseg > 0))
    k4_summary = "summary" in inspect.signature(fa.launch_dq_dbias).parameters
    for suffix, seg, mask in layouts:
        if not suffix:
            timed("k1_seg_mt5_ms",
                  lambda: fa.flash_forward(q, k, v, mask, bias, seg))
        out, lse = fa.flash_forward(q, k, v, mask, bias, seg)
        if not suffix:
            rec["out_digest"]["k1_seg_mt5_out"] = _out_digest(out, lse)
        extra_dq, extra_dkv, _ = _summaries(fa, seg, mask, v, lse, g)
        extra_k4 = extra_dq if k4_summary else ()
        dq, delta, dbias = fa.launch_dq_dbias(q, k, v, mask, bias, g, out,
                                              lse, seg, *extra_k4)
        rec["k4_digest"][f"k4_seg{suffix}_dq"] = _digest(dq)
        rec["k4_digest"][f"k4_seg{suffix}_dbias"] = _digest(
            dbias, signed_zeros=True)
        del dq, dbias
        timed(f"k4_seg{suffix}_ms", lambda: fa.launch_dq_dbias(
            q, k, v, mask, bias, g, out, lse, seg, *extra_k4))
        timed(f"k3_bias_seg{suffix}_ms", lambda: fa.launch_dkv(
            q, k, v, mask, g, lse, delta, bias, seg, *extra_dkv))
        del out, lse, delta


def worker(tree: str, train_seg_path=None, train_seg_mt5_path=None
           ) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import dnn_page_vectors_tpu_torch as pkg
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    if not pkg.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"imported {pkg.__file__}, not from {tree}")
    device = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    rec = {"tree": tree, "device_ms": {}, "dq_digest": {}, "out_digest": {},
           "k4_digest": {}}

    def timed(key, fn):
        rec[key] = _event_ms(fn)
        rec["device_ms"][key] = _device_ms(fn)
    with torch.no_grad():
        q, k, v, g, mask, _ = _inputs(**BERT, gen=gen, device=device)
        out, lse = fa.flash_forward(q, k, v, mask)
        out = out.contiguous()
        _, delta = fa.launch_dq(q, k, v, mask, g, out, lse)
        timed("k2_ms", lambda: fa.launch_dq(q, k, v, mask, g, out, lse))
        timed("k3_ms", lambda: fa.launch_dkv(q, k, v, mask, g, lse, delta))
        del q, k, v, g, out, lse, delta
        q, k, v, _, mask, _ = _inputs(**BERT_EMBED, gen=gen, device=device)
        timed("k1_bert_ms", lambda: fa.flash_forward(q, k, v, mask))
        q, k, v, g, mask, bias = _inputs(**MT5, gen=gen, device=device,
                                         bias=True)
        timed("k1_mt5_ms", lambda: fa.flash_forward(q, k, v, mask, bias))
        out, lse = fa.flash_forward(q, k, v, mask, bias)
        _, delta, _ = fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse)
        timed("k4_ms",
             lambda: fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse))
        timed("k3_bias_ms",
             lambda: fa.launch_dkv(q, k, v, mask, g, lse, delta, bias))
        del q, k, v, g, out, lse, delta
        q, k, v, g, mask, _ = _inputs(**BERT_QUERY, gen=gen, device=device)
        out, lse = fa.flash_forward(q, k, v, mask)
        out = out.contiguous()
        timed("k2_query_ms", lambda: fa.launch_dq(q, k, v, mask, g, out, lse))
        q, k, v, g, mask, bias = _inputs(**MT5_QUERY, gen=gen, device=device,
                                         bias=True)
        out, lse = fa.flash_forward(q, k, v, mask, bias)
        timed("k4_query_ms",
              lambda: fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse))
        del q, k, v, g, out, lse
        for key in SEG_KEYS:             # where a tree has no such call
            rec[key] = rec["device_ms"][key] = None
        for key in DQ_DIGESTS:
            rec["dq_digest"][key] = None
        for key in OUT_DIGESTS:
            rec["out_digest"][key] = None
        for key in K4_DIGESTS:
            rec["k4_digest"][key] = None
        if "seg" in inspect.signature(fa.launch_dq).parameters:
            load = lambda path: None if path is None else torch.load(path)
            _seg_cases(fa, timed, rec, gen, device, load(train_seg_path))
            torch.cuda.empty_cache()
            _mt5_seg_cases(fa, timed, rec, gen, device,
                           load(train_seg_mt5_path))
    rec["shapes"] = {"bert_train": BERT, "bert_embed": BERT_EMBED,
                     "mt5_page": MT5, "bert_query": BERT_QUERY,
                     "mt5_query": MT5_QUERY, "bert_long_packed": LONG_PACKED,
                     "mt5_packed": MT5_PACKED, "pages_a_row": PACK}
    rec["device"] = torch.cuda.get_device_name(0)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--train-seg", default=None, metavar="PATH",
                    help="[256, 1024] int32 segment ids (torch.save) of the "
                         "training layout")
    ap.add_argument("--train-seg-mt5", default=None, metavar="PATH",
                    help="[512, 128] int32 segment ids (torch.save) of the "
                         "packed mT5 training layout")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0], args.train_seg,
                                args.train_seg_mt5)), flush=True)
        return 0
    runs = []
    extra = [] if args.train_seg is None else ["--train-seg", args.train_seg]
    if args.train_seg_mt5 is not None:
        extra += ["--train-seg-mt5", args.train_seg_mt5]
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             *extra], capture_output=True, text=True, timeout=600,
            check=False)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"bwd_ab: the run on {tree} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    summary = {tree: {key: [r[key] for r in runs if r["tree"] == tree]
                      for key in KEYS}
               for tree in dict.fromkeys(args.trees)}
    for tree, row in summary.items():
        row["device_ms"] = {key: [r["device_ms"][key] for r in runs
                                  if r["tree"] == tree] for key in KEYS}
    # every run that has K2 (K1, K4) with seg at a layout gave the same dq
    # (out and lse at the rows that see a key; dq and dbias) there
    same = lambda field, key: len({r[field][key] for r in runs
                                   if r[field][key] is not None}) <= 1
    equal = {key: same("dq_digest", key) for key in DQ_DIGESTS}
    out_equal = {key: same("out_digest", key) for key in OUT_DIGESTS}
    k4_equal = {key: same("k4_digest", key) for key in K4_DIGESTS}
    last = {"summary": summary, "k2_seg_dq_equal": equal,
            "k1_seg_out_equal": out_equal, "k4_seg_equal": k4_equal,
            "nvidia_smi": smi}
    print(json.dumps(last), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, **last}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
