"""Paged KV pools (``repro/models/cache.py``).

Every full-attention layer shares one pool of ``n_blocks`` blocks of
``page_size`` rows; a slot addresses its rows through its row of the block
table, position ``p`` at row ``p % page_size`` of block
``table[p // page_size]``. Block 0 is the null block: never allocated, it
is what unused table entries point at.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def init_cache(cfg: ModelConfig, n_blocks: int, page_size: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    """Zeroed pools ``{"k", "v"}`` of shape (layers, n_blocks, page_size,
    kv heads, head dim) in the compute dtype; the leading axis is the
    stacked ``blocks`` axis of the reference's cache."""
    shape = (cfg.n_layers, n_blocks, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def page_rows(table: torch.Tensor, positions: torch.Tensor, page_size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pool (block, row) of each position through a block table: ``table``
    (P,) with positions (T,), or (B, P) with positions (B,)."""
    pages = (positions // page_size).long()
    if table.dim() == 1:
        blocks = table[pages]
    else:
        blocks = table.gather(1, pages[:, None])[:, 0]
    return blocks.long(), (positions % page_size).long()


def pages_per_slot(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def default_n_blocks(max_slots: int, max_len: int, page_size: int) -> int:
    """Dense-equivalent pool capacity plus the null block."""
    return max_slots * pages_per_slot(max_len, page_size) + 1

