"""Paged KV pools and per-slot recurrent state (``repro/models/cache.py``).

Every full-attention layer shares one pool of ``n_blocks`` blocks of
``page_size`` rows; a slot addresses its rows through its row of the block
table, position ``p`` at row ``p % page_size`` of block
``table[p // page_size]``. Block 0 is the null block: never allocated, it
is what unused table entries point at.

With ``cfg.kv_dtype`` set ("int8" or "fp8"), the pools hold K/V codes at
one byte per element plus per-row float16 absmax scales ``k_scale`` and
``v_scale`` of shape (layers, n_blocks, page_size, kv heads): writes
quantize each row, reads dequantize with its scale. The sizing helpers
count the storage width and the scales.

A Mamba model (``cfg.is_ssm``) has no full-attention layer and so no pools:
its cache is the dense per-slot state of every layer, ``{"h": (layers,
slots, d_inner * d_state) float32, "conv": (layers, slots, d_conv - 1,
d_inner)}`` in the compute dtype, as the reference keeps it beside its pools
(``cache.py:70-73``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.quant.tensor import SCALE_DTYPE, storage_dtype


def _pool_dtype(cfg: ModelConfig) -> torch.dtype:
    return storage_dtype(cfg.kv_dtype) if cfg.kv_dtype else cfg.compute_dtype


def init_cache(cfg: ModelConfig, n_blocks: int, page_size: int,
               device: torch.device, *, slots: int = 0
               ) -> dict[str, torch.Tensor]:
    """Zeroed pools ``{"k", "v"}`` of shape (layers, n_blocks, page_size,
    kv heads, head dim) in the compute dtype, or in int8 / fp8 codes with
    ``{"k_scale", "v_scale"}`` when ``cfg.kv_dtype`` is set; the leading
    axis is the stacked ``blocks`` axis of the reference's cache. A Mamba
    model gets the zeroed state ``{"h", "conv"}`` of ``slots`` slots
    instead (``n_blocks`` and ``page_size`` unused)."""
    if cfg.is_ssm:
        if slots < 1:
            raise ValueError("a mamba cache needs slots >= 1")
        s, L, DI = cfg.ssm, cfg.n_layers, cfg.d_inner
        return {"h": torch.zeros(L, slots, DI * s.d_state, device=device),
                "conv": torch.zeros(L, slots, s.d_conv - 1, DI,
                                    dtype=cfg.compute_dtype, device=device)}
    shape = (cfg.n_layers, n_blocks, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dt = _pool_dtype(cfg)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.kv_dtype:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=SCALE_DTYPE,
                                      device=device)
    return cache


def cache_bytes(cache: dict[str, torch.Tensor]) -> int:
    """Device bytes of the pools (scales included) or recurrent state."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def kv_block_bytes(cfg: ModelConfig, page_size: int) -> int:
    """KV bytes of one pool block summed over the layers, at the pools'
    storage width plus, for quantized pools, two float16 scales per row
    and head (``repro/models/cache.py:163``); 0 for a model with no
    full-attention layer."""
    if cfg.is_ssm:
        return 0
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    scale_bytes_row = 2 * SCALE_DTYPE.itemsize if cfg.kv_dtype else 0
    per_row = K * (hd * 2 * _pool_dtype(cfg).itemsize + scale_bytes_row)
    return cfg.n_layers * page_size * per_row


def n_blocks_for_bytes(cfg: ModelConfig, hbm_bytes: int, page_size: int
                       ) -> int:
    """Pool blocks, the null block included, that a KV budget of
    ``hbm_bytes`` holds (``repro/models/cache.py:179``, one device)."""
    per_block = kv_block_bytes(cfg, page_size)
    return max(int(hbm_bytes // max(per_block, 1)), 1) + 1


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

