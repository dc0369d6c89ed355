"""Two-tower wrapper: query tower + page tower + learnable logit scale.

Counterpart of the JAX package's models/two_tower.py. With ``shared`` the
page side reuses the query tower; otherwise the towers are independent
(the default, ``model.shared_towers=False``). The logit scale is a
learnable log inverse temperature, clamped at exp <= 100 when read.
``forward`` is the training call (the JAX ``__call__``, unpacked pages
only: the packed ``page_seg`` path is slice 4 of the port).
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
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """[B, page_len] ids -> [B, D] float32 (not normalized)."""
        return self._page_enc()(ids, generator)

    def scale(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.log_scale), max=100.0)

    def forward(self, query_ids: torch.Tensor, page_ids: torch.Tensor,
                neg_page_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(q [B,D], p [B,D], neg [B,H,D] or None, scale), all float32.
        `neg_page_ids` [B, H, page_len] are mined hard negatives, encoded
        by the page tower. The towers draw their dropout masks from
        `generator` in this order: queries, pages, negatives."""
        q = self.encode_query(query_ids, generator)
        p = self.encode_page(page_ids, generator)
        neg = None
        if neg_page_ids is not None:
            B, H = neg_page_ids.shape[:2]
            flat = neg_page_ids.reshape((B * H,) + neg_page_ids.shape[2:])
            neg = self.encode_page(flat, generator).reshape(B, H, -1)
        return q, p, neg, self.scale()
