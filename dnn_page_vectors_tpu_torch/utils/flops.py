"""Analytic FLOP and byte counts, and the card's peaks, for MFU and the
roofline.

Counterpart of the JAX package's utils/flops.py: the same counts (one
multiply-accumulate = 2 FLOPs; embedding gathers, softmax, norms and
other vector work left out, as MFU conventionally does), and a table of
peaks keyed on ``torch.cuda.get_device_name()`` with NVIDIA rows only.
A card not in the table, and the CPU, have no peak (None): no MFU is
reported there, and no default stands in for one.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from dnn_page_vectors_tpu_torch.config import Config, ModelConfig


def encoder_flops_per_example(m: ModelConfig, seq_len: int) -> float:
    """Forward matmul FLOPs for ONE sequence through one tower."""
    if m.encoder in ("bert", "t5"):
        d, ff, L = m.model_dim, m.mlp_dim, seq_len
        # per token per layer: QKV and output projections (8 d^2), the
        # scores and their product with V (4 L d), the MLP (bert: two
        # matmuls, 4 d ff; t5's gated GELU: three, 6 d ff)
        mlp = 6 * d * ff if m.encoder == "t5" else 4 * d * ff
        per_tok_layer = 8 * d * d + 4 * L * d + mlp
        proj = 2 * d * m.out_dim          # the pooled vector -> out_dim
        return float(L * m.num_layers * per_tok_layer + proj)
    if m.encoder == "cdssm":
        E, C = m.embed_dim, m.conv_channels
        conv = sum(2 * w * E * C for w in m.conv_widths) * seq_len
        return float(conv + 2 * C * m.out_dim)
    if m.encoder == "kim_cnn":
        E, C = m.embed_dim, m.conv_channels
        conv = sum(2 * w * E * C for w in m.conv_widths) * seq_len
        return float(conv + 2 * len(m.conv_widths) * C * m.out_dim)
    if m.encoder == "lstm":
        # per direction per token: input projection 2 E_in 4H, recurrence
        # 2 H 4H; layer 1 reads the embedding, deeper layers [B, L, 2H]
        H = m.model_dim
        per_dir = 0.0
        e_in = m.embed_dim
        for _ in range(m.num_layers):
            per_dir += 2 * e_in * 4 * H + 2 * H * 4 * H
            e_in = 2 * H
        return float(seq_len * 2 * per_dir + 2 * (2 * H) * m.out_dim)
    raise ValueError(f"no FLOP model for encoder {m.encoder!r}")


def train_flops_per_pair(cfg: Config, batch_size: int,
                         pack: Optional[int] = None) -> float:
    """Matmul FLOPs per (query, page) pair of one optimizer step: both
    towers forward (and the mined negatives' pages), the in-batch logits,
    times 3 for forward and backward.

    `pack` (default train.pack_pages): the page tower runs one
    [page_len] row for `pack` pages, so a page costs the row / pack (the
    row the device computes: segment masks zero scores, they skip no
    FLOP of this count). Mined negatives ride unpacked rows."""
    m, d = cfg.model, cfg.data
    H = cfg.train.hard_negatives
    pack = max(1, cfg.train.pack_pages if pack is None else pack)
    fwd = (encoder_flops_per_example(m, d.query_len)
           + encoder_flops_per_example(m, d.page_len) / pack
           + H * encoder_flops_per_example(m, d.page_len))
    # logits: q [B, D] @ pages [(1 + H) B, D]^T, per pair
    fwd += 2.0 * batch_size * (1 + H) * m.out_dim
    return 3.0 * fwd


def embed_flops_per_page(cfg: Config) -> float:
    """Matmul FLOPs to embed one page (forward only)."""
    return encoder_flops_per_example(cfg.model, cfg.data.page_len)


def encoder_param_count(m: ModelConfig, vocab_size: int) -> float:
    """Approximate parameter count of ONE tower, its embedding included."""
    if m.encoder in ("bert", "t5"):
        d, ff = m.model_dim, m.mlp_dim
        mlp = 3 * d * ff if m.encoder == "t5" else 2 * d * ff
        per_layer = 4 * d * d + mlp
        return float(vocab_size * d + m.num_layers * per_layer
                     + d * m.out_dim)
    if m.encoder in ("cdssm", "kim_cnn"):
        E, C = m.embed_dim, m.conv_channels
        conv = sum(w * E * C for w in m.conv_widths)
        return float(vocab_size * E + conv
                     + len(m.conv_widths) * C * m.out_dim)
    if m.encoder == "lstm":
        H = m.model_dim
        per_dir, e_in = 0.0, m.embed_dim
        for _ in range(m.num_layers):
            per_dir += e_in * 4 * H + H * 4 * H
            e_in = 2 * H
        return float(vocab_size * m.embed_dim + 2 * per_dir
                     + 2 * H * m.out_dim)
    raise ValueError(f"no param model for encoder {m.encoder!r}")


def _act_bytes_per_example(m: ModelConfig, seq_len: int) -> float:
    """Rough activation traffic per sequence, forward and backward
    (2-byte compute dtype; passes counted from the op structure)."""
    if m.encoder in ("bert", "t5"):
        d, ff = m.model_dim, m.mlp_dim
        # per layer: ~10 passes over [L, d] (attention in and out,
        # residuals, norms, forward and backward) + ~6 over the [L, ff]
        # MLP hidden
        per_tok = m.num_layers * (10 * d + 6 * ff) + 4 * d
        return float(seq_len * per_tok * 2)
    if m.encoder in ("cdssm", "kim_cnn"):
        E, C = m.embed_dim, m.conv_channels
        per_tok = 3 * E + 4 * len(m.conv_widths) * C
        return float(seq_len * per_tok * 2)
    if m.encoder == "lstm":
        H = m.model_dim
        # the gate math runs in float32; x_proj [L, 4H] both directions
        per_tok = m.embed_dim * 2 + 2 * (4 * H + 2 * H) * 4
        return float(seq_len * per_tok * m.num_layers)
    raise ValueError(f"no activation model for encoder {m.encoder!r}")


def train_bytes_per_pair(cfg: Config, batch_size: int) -> float:
    """Analytic device bytes per (query, page) pair of one step: the
    embedding gather (forward) and its dense gradient's scatter and
    update (backward), both towers' activations, and the parameter and
    AdamW-moment traffic amortised over the batch. Coarse: a roofline
    denominator, not a simulator."""
    m, d = cfg.model, cfg.data
    H = cfg.train.hard_negatives
    vocab = (d.trigram_buckets if d.tokenizer == "trigram" else d.vocab_size)
    embed_width = m.model_dim if m.encoder in ("bert", "t5") else m.embed_dim
    tokens = d.query_len + (1 + H) * d.page_len
    # gather (2 B compute dtype) + scatter-add backward (f32 read + write)
    embed_traffic = tokens * embed_width * (2 + 2 * 4)
    acts = (_act_bytes_per_example(m, d.query_len)
            + (1 + H) * _act_bytes_per_example(m, d.page_len))
    # params: read forward, read backward, f32 gradient write, the AdamW
    # update (p, m, v read and written): ~10 f32 accesses a parameter,
    # over the batch; two towers unless shared
    towers = 1 if m.shared_towers else 2
    params = towers * encoder_param_count(m, vocab)
    opt = params * 4 * 10 / max(1, batch_size)
    return float(embed_traffic + acts + opt)


def roofline(flops_per_pair: float, bytes_per_pair: float,
             peak_flops: Optional[float], peak_bw: Optional[float]):
    """(ceiling pairs/s, binding wall): the lower of the compute and the
    memory ceilings; (None, None) where a peak is unknown (the CPU)."""
    if not peak_flops or not peak_bw:
        return None, None
    compute = peak_flops / max(flops_per_pair, 1.0)
    memory = peak_bw / max(bytes_per_pair, 1.0)
    return (min(compute, memory),
            "compute" if compute <= memory else "bandwidth")


# torch.cuda.get_device_name() -> (dense bf16 FLOP/s, HBM bytes/s), from
# NVIDIA's data sheets at the card's full power limit (H100 SXM5 80 GB,
# 700 W: 989.4 TFLOP/s dense bf16, 3.35 TB/s)
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
}

DeviceLike = Union[str, torch.device, None]


def _device_name(device: DeviceLike) -> Optional[str]:
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device                               # a device name
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def device_peak_flops(device: DeviceLike = None) -> Optional[float]:
    """Dense bf16 FLOP/s of `device` (a torch device, or a name as
    ``torch.cuda.get_device_name`` gives it), or None where unknown."""
    peak = _PEAKS.get(_device_name(device))
    return None if peak is None else peak[0]


def device_peak_hbm_bps(device: DeviceLike = None) -> Optional[float]:
    """Device memory bytes/s of `device`, or None where unknown."""
    peak = _PEAKS.get(_device_name(device))
    return None if peak is None else peak[1]
