"""OPQ+PQ codec: compressed posting payloads of the IVF index, the port's
copy of the JAX package's index/pq.py.

A row is rotated by the OPQ rotation R, split into `m` subspaces of
dsub = D / m dims, and each sub-vector is replaced by the id of its
nearest codeword in that subspace's 256-word codebook: m bytes a row. A
query scores a code row by asymmetric distance computation (ADC): per
query one [m, 256] table of query-subvector x codeword dot products
(``_pq_lut``), and a row's score is the sum of its m table entries
(``adc_topr``). Rows are unit vectors and R is orthogonal, so
q . x = (qR) . (xR) ~= sum_m (qR)_m . c_m; the IVF search re-ranks the
ADC survivors exactly, so the returned scores are true ones.

Training (``train_pq``) alternates, as OPQ (Ge et al. 2013) does:
codebooks by the grouped k-means (index/kmeans.py) in the current
rotation, the pool's reconstruction from its codes, and the orthogonal
Procrustes rotation R = U V^T from the SVD of X^T X_hat, in float64
numpy on the host, as the JAX package does; the identity rotation first.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.index.kmeans import (
    grouped_assign, grouped_kmeans, sample_rows)
from dnn_page_vectors_tpu_torch.ops.topk import probed_mask
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device

KSUB = 256                      # codewords per subspace: one uint8 per code


def auto_pq_m(dim: int) -> int:
    """Default subspace count: about 8 dims a subspace, coarser splits for
    dims 8 does not divide."""
    for dsub in (8, 6, 4, 2, 1):
        if dim % dsub == 0:
            return dim // dsub
    return dim


def _pq_lut(q: torch.Tensor, rotation: torch.Tensor,
            codebooks: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables of queries q [B, D] (float32, on the codec's
    device): rotate, split into subspaces, dot every codeword —
    [B, m, ksub] float32."""
    m, _, dsub = codebooks.shape
    q3 = (q.float() @ rotation).reshape(q.shape[0], m, dsub)
    return torch.einsum("bmd,mkd->bmk", q3, codebooks)


def adc_topr(lut: torch.Tensor, codes: torch.Tensor, cent: torch.Tensor,
             selected: torch.Tensor, r: int, chunk: int = 32_768
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-`r` ADC scores of the candidate code rows against each
    query: lut [B, m, ksub] float32, codes [C, m] uint8, cent [C] (each
    candidate's list; -1 padding, -2 dead), selected [B, nprobe] (each
    query's probed lists), all on one device. A chunk of rows is scored by
    gathering each row's m table entries, one subspace at a time, and
    adding them from subspace 0 to m - 1 in float32 (this order, on the
    card and on the CPU alike; the JAX package sums by a multi-hot
    product instead), masked to the query's probed lists
    (``probed_mask``), then merged into the running top-r by
    ``torch.topk``. Returns (scores [B, r] float32, positions into codes
    [B, r] int64, -1 where fewer than r rows matched)."""
    B, m, ksub = lut.shape
    flat = lut.reshape(B, m * ksub)
    base = torch.arange(m, device=lut.device) * ksub
    best_s = torch.full((B, r), -torch.inf, dtype=torch.float32,
                        device=lut.device)
    best_i = torch.full((B, r), -1, dtype=torch.int64, device=lut.device)
    for c0 in range(0, codes.shape[0], chunk):
        offs = codes[c0: c0 + chunk].long() + base               # [c, m]
        s = flat.index_select(1, offs[:, 0])
        for j in range(1, m):
            s = s + flat.index_select(1, offs[:, j])              # [B, c]
        s = s.masked_fill(~probed_mask(cent[c0: c0 + chunk], selected),
                          -torch.inf)
        ids = torch.arange(c0, c0 + offs.shape[0], device=lut.device)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids[None].expand(B, -1)], dim=1)
        best_s, pos = torch.topk(cat_s, r, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
    best_i = torch.where(torch.isfinite(best_s), best_i,
                         torch.full_like(best_i, -1))
    return best_s, best_i


class PQCodec:
    """A trained OPQ rotation and per-subspace codebooks. The arrays are
    small (D^2 + m * 256 * dsub floats) and persist as two npy files next
    to the posting lists (index/ivf.py); ``tensors`` caches them on a
    device."""

    def __init__(self, rotation: np.ndarray, codebooks: np.ndarray):
        self.rotation = np.ascontiguousarray(rotation, dtype=np.float32)
        self.codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    def tensors(self, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rotation, codebooks) on `device`, cached."""
        if device not in self._dev:
            self._dev[device] = (to_device(self.rotation, device),
                                 to_device(self.codebooks, device))
        return self._dev[device]

    def encode(self, vecs: np.ndarray, device: DeviceLike = None
               ) -> np.ndarray:
        """float rows [n, D] -> PQ codes [n, m] uint8: the rotation on the
        host (float32 numpy, as in the JAX package), the nearest codeword
        per subspace on `device` (the grouped assignment pass)."""
        xr = np.asarray(vecs, np.float32) @ self.rotation
        codes = grouped_assign(xr.reshape(-1, self.m, self.dsub),
                               self.codebooks, device=device)
        return codes.astype(np.uint8)

    def lut(self, q: torch.Tensor) -> torch.Tensor:
        """ADC tables [B, m, ksub] of queries q [B, D] on q's device."""
        return _pq_lut(q, *self.tensors(q.device))


def train_pq(store, m: int, ksub: int = KSUB, iters: int = 8,
             opq_iters: int = 3, seed: int = 0, sample: int = 65_536,
             device: DeviceLike = None) -> Tuple[PQCodec, Dict]:
    """Train an OPQ rotation and PQ codebooks over the store's seeded
    sample pool (see the module docstring; opq_iters=0 is plain PQ).
    Returns (codec, stats)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    D = store.dim
    if D % m:
        raise ValueError(f"pq_m={m} must divide the store dim {D}")
    N = store.num_vectors
    if N == 0:
        raise ValueError("cannot train PQ codebooks over an empty store")
    pool = sample_rows(store, max(2, min(sample, N)), seed)
    n = pool.shape[0]
    k = min(int(ksub), n)
    dsub = D // m
    R = np.eye(D, dtype=np.float32)
    reseeded = 0
    for t in range(max(0, int(opq_iters))):
        xr = pool @ R
        cb, st = grouped_kmeans(xr.reshape(n, m, dsub), k, iters=iters,
                                seed=(seed, 3, t), device=dev)
        reseeded += st["reseeded"]
        codes = grouped_assign(xr.reshape(n, m, dsub), cb, device=dev)
        recon = cb[np.arange(m)[None, :], codes].reshape(n, D)
        u, _, vt = np.linalg.svd(pool.T.astype(np.float64)
                                 @ recon.astype(np.float64))
        R = np.ascontiguousarray((u @ vt).astype(np.float32))
    xr = pool @ R
    cb, st = grouped_kmeans(xr.reshape(n, m, dsub), k, iters=iters,
                            seed=(seed, 3, max(0, int(opq_iters))),
                            device=dev)
    codec = PQCodec(R, cb)
    stats = {"m": int(m), "ksub": int(k), "dsub": int(dsub),
             "iters": int(iters), "opq_iters": int(opq_iters),
             "seed": int(seed), "pool": int(n),
             "reseeded": reseeded + st["reseeded"],
             "train_seconds": round(time.perf_counter() - t0, 3)}
    return codec, stats
