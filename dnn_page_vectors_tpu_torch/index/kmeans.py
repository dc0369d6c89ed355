"""Mini-batch spherical k-means over the vector store on one card: the IVF
coarse quantizer, and the grouped per-subspace k-means that trains the PQ
codebooks (index/pq.py). The port's copy of the JAX package's
index/kmeans.py.

Each pass streams the store one shard at a time (the next shard read on a
reader thread) at its stored width to the card, where ``shard_pass``
scores a chunk of rows against the [nlist, D] centroids with one float32
product, takes each row's argmax, and adds the rows into per-list sums
with a second product, one-hot [chunk, nlist] transposed times the rows.
The host adds each shard's sums and counts in float64 and moves every
centroid to its list's mean, re-normalized (rows are unit vectors, so
assignment by the largest dot product is cosine assignment).

Determinism: the init sample, k-means++ and the reseed of empty lists
draw from seeded numpy generators; the per-list sums are products, never
``index_add_`` or ``scatter_add_`` (float atomics on the card, whose order
changes from run to run); shards and chunks are summed in a fixed order.
So a seeded build gives the same bytes on every run on the same card.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.infer.vector_store import read_ahead
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device


def shard_pass(pages: torch.Tensor, scales: Optional[torch.Tensor],
               centroids: torch.Tensor, chunk: int = 8192, choices: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One staged shard through the assignment and accumulation pass:
    pages [n, D] at stored width (float16, or int8 codes with float16
    `scales` [n]), centroids [nlist, D] float32, all on one device.
    Returns (sums [nlist, D] float32, counts [nlist] float32, assign): the
    rows' first-choice list [n], or with `choices` > 1 each row's top
    `choices` lists [n, choices] (the balanced sweep spills a row to its
    next choice); the sums and counts always take the first choice.

    One card: no psum over a mesh axis, and no padding of the shard to a
    shape the mesh divides, so every row is valid."""
    nlist, dim = centroids.shape
    dev = centroids.device
    sums = torch.zeros((nlist, dim), dtype=torch.float32, device=dev)
    counts = torch.zeros((nlist,), dtype=torch.float32, device=dev)
    lists = torch.arange(nlist, device=dev)
    out = []
    for c0 in range(0, pages.shape[0], chunk):
        rf = pages[c0: c0 + chunk].float()
        if scales is not None:                       # int8: dequantize
            rf = rf * scales[c0: c0 + chunk].float()[:, None]
        s = rf @ centroids.T                                  # [c, nlist]
        if choices > 1:
            top = torch.topk(s, min(choices, nlist), dim=1).indices
            a = top[:, 0]
        else:
            a = top = s.argmax(dim=1)
        onehot = (a[:, None] == lists[None, :]).float()       # [c, nlist]
        sums += onehot.T @ rf
        counts += onehot.sum(dim=0)
        out.append(top)
    if not out:
        shape = (0, choices) if choices > 1 else (0,)
        return sums, counts, torch.zeros(shape, dtype=torch.int64, device=dev)
    return sums, counts, torch.cat(out)


def _normalize(c: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(c, axis=1, keepdims=True)
    return (c / np.maximum(n, 1e-12)).astype(np.float32)


def _kmeans_pp(pool: np.ndarray, nlist: int,
               rng: np.random.Generator) -> np.ndarray:
    """Seeded k-means++ over the sampled pool: each next seed is drawn
    with probability proportional to its cosine distance from the nearest
    seed already chosen, one pool-vs-new-seed product a seed (never a full
    distance matrix). A chosen row has distance 0 and is never drawn
    again; a pool with no distance left draws uniformly."""
    n = pool.shape[0]
    out = np.empty((nlist, pool.shape[1]), np.float32)
    first = int(rng.integers(0, n))
    out[0] = pool[first]
    best = pool @ out[0]                     # nearest-seed cosine sim [n]
    for j in range(1, nlist):
        d = np.maximum(1.0 - best, 0.0)      # cosine distance to nearest
        total = d.sum()
        if total <= 0.0:
            nxt = int(rng.integers(0, n))
        else:
            nxt = int(rng.choice(n, p=d / total))
        out[j] = pool[nxt]
        best = np.maximum(best, pool @ out[j])
    return out


def sample_rows(store, n: int, seed: int) -> np.ndarray:
    """Seeded sample of up to `n` dequantized float32 rows, proportional
    per shard, in (shard, row) order: the k-means init pool, the reseed
    pool of empty lists and the PQ training pool."""
    N = store.num_vectors
    out = []
    for entry in store.shards():
        cnt = entry["count"]
        if cnt == 0:
            continue
        quota = min(cnt, max(1, -(-n * cnt // max(N, 1))))
        rng = np.random.default_rng([seed, entry["index"]])
        rows = np.sort(rng.choice(cnt, size=quota, replace=False))
        _, vecs = store._load_entry(entry)
        out.append(np.asarray(vecs[rows], np.float32))
    if not out:
        return np.zeros((0, store.dim), np.float32)
    return np.concatenate(out)[:n]


def _iter_staged(store, device: torch.device, sample_per_shard=None,
                 rng_key=None, entries=None):
    """Yield (entry, pages, scales-or-None) for every non-empty shard,
    staged on `device` at stored width; with `sample_per_shard`, a seeded
    subset of each larger shard's rows (the mini-batch). The disk reads
    run one shard ahead on a reader thread."""
    entries = store.shards() if entries is None else entries

    def _load():
        for e in entries:
            _, vecs, scl = store._load_entry(e, raw=True)
            yield e, np.array(vecs), scl

    for entry, vecs, scl in read_ahead(_load(), depth=1):
        n = vecs.shape[0]
        if n == 0:
            continue
        if sample_per_shard is not None and n > sample_per_shard:
            rng = np.random.default_rng([*rng_key, entry["index"]])
            take = np.sort(rng.choice(n, size=sample_per_shard,
                                      replace=False))
            vecs = vecs[take]
            scl = None if scl is None else scl[take]
        yield (entry, to_device(vecs, device),
               None if scl is None else to_device(scl, device))


def train_kmeans(store, nlist: int, iters: int = 8, seed: int = 0,
                 chunk: int = 8192, sample_per_shard: Optional[int] = None,
                 init_sample: int = 65_536, init: str = "kmeans++",
                 device: DeviceLike = None) -> Tuple[np.ndarray, Dict]:
    """Train `nlist` unit-norm centroids over the store on `device`.
    Returns (centroids [nlist, D] float32, stats). `init` is "kmeans++"
    (spread seeds) or "random" (a uniform draw from the pool); the stats
    record `init_imbalance`, the imbalance factor of the first pass, beside
    the count of reseeded empty lists."""
    dev = resolve_device(device)
    N = store.num_vectors
    if N == 0:
        raise ValueError("cannot train k-means over an empty store")
    nlist = int(min(max(1, nlist), N))
    pool = sample_rows(store, max(nlist, min(init_sample, N)), seed)
    rng = np.random.default_rng(seed)
    if init == "kmeans++":
        centroids = _normalize(_kmeans_pp(pool, nlist, rng))
    elif init == "random":
        centroids = _normalize(
            pool[rng.choice(pool.shape[0], size=nlist, replace=False)])
    else:
        raise ValueError(f"unknown k-means init {init!r} "
                         "(want kmeans++ or random)")
    reseeded = 0
    init_imbalance = 0.0
    for it in range(max(1, iters)):
        sums = np.zeros((nlist, store.dim), np.float64)
        counts = np.zeros((nlist,), np.float64)
        cdev = to_device(centroids, dev)
        for _, pages, scales in _iter_staged(
                store, dev, sample_per_shard=sample_per_shard,
                rng_key=(seed, 1 + it)):
            s, c, _ = shard_pass(pages, scales, cdev, chunk=chunk)
            sums += s.cpu().numpy().astype(np.float64)
            counts += c.cpu().numpy().astype(np.float64)
        if it == 0:                    # seeding quality, before any update
            tot = counts.sum()
            init_imbalance = float(nlist * np.square(counts).sum()
                                   / max(tot, 1.0) ** 2)
        new = centroids.astype(np.float64).copy()
        nz = counts > 0
        new[nz] = sums[nz] / counts[nz, None]
        empty = np.nonzero(~nz)[0]
        if empty.size:                 # reseed dead clusters from the pool
            r2 = np.random.default_rng([seed, 2, it])
            new[empty] = pool[r2.integers(0, pool.shape[0], empty.size)]
            reseeded += int(empty.size)
        centroids = _normalize(new.astype(np.float32))
    return centroids, {"nlist": nlist, "iters": int(max(1, iters)),
                       "reseeded": reseeded, "init": init,
                       "init_imbalance": round(init_imbalance, 4),
                       "trained_rows": int(N if sample_per_shard is None
                                           else min(N, sample_per_shard
                                                    * len(store.shards())))}


# -- grouped per-subspace k-means (the PQ codebook trainer, index/pq.py) ----

def _grouped_pass(x3: np.ndarray, cb: np.ndarray, chunk: int,
                  device: torch.device
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sums [m, k, dsub] float32, counts [m, k] float32, assign [n, m]
    int32) of one Euclidean assignment and one-hot accumulation pass over
    every subspace at once, a chunk of rows at a time on `device`.
    Euclidean, not spherical (sub-vectors of unit rows are not unit):
    argmin ||x - c||^2 = argmax (x . c - ||c||^2 / 2)."""
    n, m, dsub = x3.shape
    k = cb.shape[1]
    cbt = to_device(np.ascontiguousarray(cb, np.float32), device)
    cn = -0.5 * (cbt ** 2).sum(dim=-1)                           # [m, k]
    codewords = torch.arange(k, device=device)
    sums = torch.zeros((m, k, dsub), dtype=torch.float32, device=device)
    counts = torch.zeros((m, k), dtype=torch.float32, device=device)
    out = []
    for c0 in range(0, n, chunk):
        bf = to_device(np.ascontiguousarray(x3[c0: c0 + chunk], np.float32),
                       device)                                   # [c, m, d]
        s = torch.einsum("cmd,mkd->cmk", bf, cbt) + cn[None]
        a = s.argmax(dim=-1)                                     # [c, m]
        onehot = (a[..., None] == codewords).float()             # [c, m, k]
        sums += torch.einsum("cmk,cmd->mkd", onehot, bf)
        counts += onehot.sum(dim=0)
        out.append(a.to(torch.int32).cpu().numpy())
    assign = np.concatenate(out) if out else np.zeros((0, m), np.int32)
    return sums.cpu().numpy(), counts.cpu().numpy(), assign


def grouped_kmeans(x3: np.ndarray, k: int, iters: int = 8, seed=0,
                   chunk: int = 2048, device: DeviceLike = None
                   ) -> Tuple[np.ndarray, Dict]:
    """Train `m` independent k-means codebooks, one per PQ subspace, over
    the pool x3 [n, m, dsub], every subspace in each pass. Seeded: a
    distinct-row init per subspace, a seeded reseed of dead codewords, a
    fixed chunk order. Returns (codebooks [m, k, dsub] float32, stats)."""
    dev = resolve_device(device)
    n, m, dsub = x3.shape
    if k > n:
        raise ValueError(f"PQ codebook k={k} exceeds pool size {n}")
    x3 = np.asarray(x3, np.float32)
    skey = (tuple(int(s) for s in seed)
            if isinstance(seed, (tuple, list)) else (int(seed),))
    rng = np.random.default_rng(skey)
    cb = np.stack([x3[np.sort(rng.choice(n, size=k, replace=False)), j]
                   for j in range(m)])                     # [m, k, dsub]
    reseeded = 0
    for it in range(max(1, iters)):
        sums, counts, _ = _grouped_pass(x3, cb, chunk, dev)
        sums = sums.astype(np.float64)
        counts = counts.astype(np.float64)
        new = cb.astype(np.float64).copy()
        nz = counts > 0
        new[nz] = sums[nz] / counts[nz][:, None]
        empty = np.argwhere(~nz)
        if empty.size:                 # reseed dead codewords from the pool
            r2 = np.random.default_rng([*skey, 2, it])
            rows = r2.integers(0, n, empty.shape[0])
            for (j, c), r in zip(empty, rows):
                new[j, c] = x3[r, j]
            reseeded += int(empty.shape[0])
        cb = new.astype(np.float32)
    return cb, {"k": int(k), "iters": int(max(1, iters)),
                "reseeded": reseeded}


def grouped_assign(x3: np.ndarray, cb: np.ndarray, chunk: int = 2048,
                   device: DeviceLike = None) -> np.ndarray:
    """Nearest codeword per (row, subspace): [n, m] int32, the PQ encode,
    through the trainer's pass."""
    if x3.shape[0] == 0:
        return np.zeros((0, cb.shape[0]), np.int32)
    return _grouped_pass(np.asarray(x3, np.float32), cb, chunk,
                         resolve_device(device))[2]


def assign_store(store, centroids: np.ndarray, chunk: int = 8192,
                 entries=None, choices: int = 1, device: DeviceLike = None
                 ) -> Iterator[Tuple[Dict, np.ndarray]]:
    """The final assignment sweep: yield (shard entry, int32 assignment)
    for every non-empty shard, one shard at a time through the trainer's
    pass (its sums and counts dropped): each row's list [count], or with
    `choices` > 1 its top lists [count, choices] for the balanced spill.
    `entries` sweeps those shard entries instead of the store's."""
    dev = resolve_device(device)
    cdev = to_device(np.asarray(centroids, np.float32), dev)
    for entry, pages, scales in _iter_staged(store, dev, entries=entries):
        _, _, assign = shard_pass(pages, scales, cdev, chunk=chunk,
                                  choices=choices)
        yield entry, assign.to(torch.int32).cpu().numpy()
