"""GQA attention with qk-norm and RoPE over paged pools
(``repro/models/attention.py``).

The q/k/v/o projections and the chunked-prefill read (``attention_extend``)
are plain PyTorch, as they are plain XLA in the reference. The full-sequence
read goes through the ``flash_attention`` kernel and the decode read through
the ``paged_attention`` kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.cache import page_rows
from repro_torch.models.layers import apply_norm, rope

NEG_INF = -1e30


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.attn_scale or cfg.resolved_head_dim)


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q (B, S, K, G, hd), k and v (B, S, K, hd), normed and rotated
    (``attention.py:139``)."""
    B, S, _ = x.shape
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["q_proj"]).reshape(B, S, H, hd)
    k = (x @ p["k_proj"]).reshape(B, S, K, hd)
    v = (x @ p["v_proj"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, cfg.norm_eps)
        k = apply_norm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta).reshape(B, S, K, H // K, hd)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(p: dict, cfg: ModelConfig, x: torch.Tensor
                      ) -> torch.Tensor:
    """Causal self-attention over the whole sequence through the
    ``flash_attention`` kernel (``attention.py:161``, read at :209-219)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None]
    q, k, v = _project_qkv(p, cfg, x, positions)
    _, _, K, G, hd = q.shape
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * K * G, S, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * K, S, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * K, S, hd).contiguous()
    of = ops.flash_attention(qf, kf, vf, causal=True, cap=cfg.attn_softcap,
                             scale=_scale(cfg))
    out = of.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, K * G * hd) @ p["o_proj"]


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     pools: dict[str, torch.Tensor], pos: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """One token per slot: x (B, 1, d) at positions ``pos`` (B,). Writes
    the token's K/V into its slot's page in place, then reads the slot
    through the ``paged_attention`` kernel (``_paged_decode``,
    ``attention.py:343``, read at :389-399)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    blk, row = page_rows(block_tables, pos, pools["k"].shape[1])
    pools["k"][blk, row] = k[:, 0]
    pools["v"][blk, row] = v[:, 0]
    out = ops.paged_attention(q[:, 0].contiguous(), pools["k"], pools["v"],
                              block_tables, (pos + 1).to(torch.int32),
                              scale=_scale(cfg), cap=cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ p["o_proj"]


def attention_extend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     pools: dict[str, torch.Tensor], pos: int,
                     table: torch.Tensor) -> torch.Tensor:
    """Chunked prefill of one slot: x (1, T, d) at positions ``pos ..
    pos+T-1``; ``table`` (P,) is the slot's block-table row. Writes the
    chunk's K/V into the slot's pages in place, then attends causally over
    the slot's first ``pos + T`` rows (``attention.py:508``)."""
    T = x.shape[1]
    page = pools["k"].shape[1]
    positions = pos + torch.arange(T, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions[None])
    blk, row = page_rows(table, positions, page)
    pools["k"][blk, row] = k[0]
    pools["v"][blk, row] = v[0]
    n = pos + T
    pages = table[:-(-n // page)].long()
    K, hd = k.shape[2], k.shape[3]
    keys = pools["k"][pages].reshape(-1, K, hd)[:n]
    vals = pools["v"][pages].reshape(-1, K, hd)[:n]
    s = torch.einsum("tkgd,skd->kgts", q[0].float(), keys.float()) * _scale(cfg)
    if cfg.attn_softcap:
        s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
    causal = torch.arange(n, device=x.device)[None, :] <= positions[:, None]
    w = torch.softmax(s.masked_fill(~causal, NEG_INF), dim=-1)
    out = torch.einsum("kgts,skd->tkgd", w.to(x.dtype), vals)
    return out.reshape(1, T, -1) @ p["o_proj"]
