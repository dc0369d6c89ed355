"""Two-tower wrapper: query tower + page tower + learnable logit scale.

Counterpart of the JAX package's models/two_tower.py. With ``shared`` the
page side reuses the query tower; otherwise the towers are independent
(the default, ``model.shared_towers=False``). The logit scale is a
learnable log inverse temperature, clamped at exp <= 100 when read.
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

    def encode_query(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, query_len] ids -> [B, D] float32 (not normalized)."""
        return self.query_tower(ids)

    def encode_page(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, page_len] ids -> [B, D] float32 (not normalized)."""
        return self._page_enc()(ids)

    def scale(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.log_scale), max=100.0)
