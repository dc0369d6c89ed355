"""Two-tower wrapper: query tower + page tower + learnable logit scale.

Counterpart of the JAX package's models/two_tower.py. With ``shared`` the
page side reuses the query tower; otherwise the towers are independent
(the default, ``model.shared_towers=False``). The logit scale is a
learnable log inverse temperature, clamped at exp <= 100 when read.
``forward`` is the training call (the JAX ``__call__``), with packed
page rows when ``page_seg`` is given (sequence packing, train.pack_pages).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class TwoTower(nn.Module):
    def __init__(self, query_tower: nn.Module,
                 page_tower: Optional[nn.Module], shared: bool = False,
                 temperature_init: float = 20.0):
        super().__init__()
        if not shared and page_tower is None:
            raise ValueError("separate towers need a page_tower")
        self.shared = shared
        self.query_tower = query_tower
        self.page_tower = None if shared else page_tower
        self.log_scale = nn.Parameter(
            torch.tensor(math.log(temperature_init), dtype=torch.float32))

    def _page_enc(self) -> nn.Module:
        return self.query_tower if self.shared else self.page_tower

    def encode_query(self, ids: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """[B, query_len] ids -> [B, D] float32 (not normalized).
        `generator` draws dropout masks in training mode."""
        return self.query_tower(ids, generator)

    def encode_page(self, ids: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    seg: Optional[torch.Tensor] = None,
                    pos: Optional[torch.Tensor] = None,
                    nseg: int = 0) -> torch.Tensor:
        """[B, page_len] ids -> [B, D] float32 (not normalized); packed rows
        [R, page_len] with their segment ids `seg` and local positions
        `pos` (data/loader.py pack_segments) -> [R, nseg, D], one vector per
        packed page, attention and pooling never crossing pages."""
        return self._page_enc()(ids, generator, seg=seg, pos=pos, nseg=nseg)

    def scale(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.log_scale), max=100.0)

    def forward(self, query_ids: torch.Tensor, page_ids: torch.Tensor,
                neg_page_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                page_seg: Optional[torch.Tensor] = None,
                page_pos: Optional[torch.Tensor] = None):
        """(q [B,D], p [B,D], neg [B,H,D] or None, scale), all float32.
        `neg_page_ids` [B, H, page_len] are mined hard negatives, encoded
        by the page tower. The towers draw their dropout masks from
        `generator` in this order: queries, pages, negatives.

        With `page_seg` (sequence packing): `page_ids` is [R, L] packed
        rows carrying the B = query_ids.shape[0] pages (pack = B / R
        consecutive pages a row); the page tower's [R, pack, D] vectors are
        flattened to [B, D] in the unpacked batch's page order."""
        q = self.encode_query(query_ids, generator)
        if page_seg is not None:
            B, R = query_ids.shape[0], page_ids.shape[0]
            if B % R:
                raise ValueError(f"{B} pages do not fill {R} packed rows "
                                 "evenly")
            p = self.encode_page(page_ids, generator, seg=page_seg,
                                 pos=page_pos, nseg=B // R)
            p = p.reshape(B, p.shape[-1])
        else:
            p = self.encode_page(page_ids, generator)
        neg = None
        if neg_page_ids is not None:
            B, H = neg_page_ids.shape[:2]
            flat = neg_page_ids.reshape((B * H,) + neg_page_ids.shape[2:])
            neg = self.encode_page(flat, generator).reshape(B, H, -1)
        return q, p, neg, self.scale()
