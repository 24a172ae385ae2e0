"""GQA attention with qk-norm and RoPE over paged pools
(``repro/models/attention.py``).

The q/k/v/o projections and the chunked-prefill read (``attention_extend``)
are plain PyTorch, as they are plain XLA in the reference; a quantized
projection kernel is dequantized and multiplied, as the reference's
``.astype`` does. The full-sequence read goes through the
``flash_attention`` kernel and the decode read through the
``paged_attention`` kernel, over bf16 pools or over int8 / fp8 pools with
per-row scales (``models/cache.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.cache import page_rows
from repro_torch.models.layers import apply_norm, rope
from repro_torch.quant.tensor import (QuantTensor, as_bytes, dequantize_kv,
                                      quantize_kv)

NEG_INF = -1e30


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.attn_scale or cfg.resolved_head_dim)


def weight(w: torch.Tensor | QuantTensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """A projection kernel as a dense matrix: a :class:`QuantTensor` is
    dequantized in float32 and cast to ``dtype`` for this call only."""
    return w.dequantize(dtype) if isinstance(w, QuantTensor) else w


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q (B, S, K, G, hd), k and v (B, S, K, hd), normed and rotated
    (``attention.py:139``)."""
    B, S, _ = x.shape
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ weight(p["q_proj"], x.dtype)).reshape(B, S, H, hd)
    k = (x @ weight(p["k_proj"], x.dtype)).reshape(B, S, K, hd)
    v = (x @ weight(p["v_proj"], x.dtype)).reshape(B, S, K, hd)
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
    return out.reshape(B, S, K * G * hd) @ weight(p["o_proj"], x.dtype)


def _write_rows(cfg: ModelConfig, pools: dict[str, torch.Tensor],
                blk: torch.Tensor, row: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Scatter K/V rows (n, K, hd) to pool rows (blk, row) in place.
    Quantized pools take each row's codes and its (row, head) float16
    scale (``attention.py:362-379``). Returns the scales to read the pools
    with: ``(k_scale, v_scale)``, or ``()`` for float pools."""
    if "k_scale" not in pools:
        pools["k"][blk, row] = k
        pools["v"][blk, row] = v
        return ()
    for name, x in (("k", k), ("v", v)):
        codes, scales = quantize_kv(x, cfg.kv_dtype)
        as_bytes(pools[name])[blk, row] = as_bytes(codes)
        pools[name + "_scale"][blk, row] = scales
    return pools["k_scale"], pools["v_scale"]


def _read_rows(pools: dict[str, torch.Tensor], name: str,
               pages: torch.Tensor, n: int, dtype: torch.dtype
               ) -> torch.Tensor:
    """The first ``n`` rows (n, K, hd) held by ``pages`` of pool ``name``,
    dequantized to ``dtype`` if the pool is quantized."""
    pool = pools[name]
    K, hd = pool.shape[2:]
    rows = as_bytes(pool)[pages].view(pool.dtype).reshape(-1, K, hd)[:n]
    if name + "_scale" not in pools:
        return rows
    scales = pools[name + "_scale"][pages].reshape(-1, K)[:n]
    return dequantize_kv(rows, scales, dtype)


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
    scales = _write_rows(cfg, pools, blk, row, k[:, 0], v[:, 0])
    out = ops.paged_attention(q[:, 0].contiguous(), pools["k"], pools["v"],
                              block_tables, (pos + 1).to(torch.int32),
                              *scales, scale=_scale(cfg),
                              cap=cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ weight(p["o_proj"], x.dtype)


def attention_extend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     pools: dict[str, torch.Tensor], pos: int,
                     table: torch.Tensor) -> torch.Tensor:
    """Chunked prefill of one slot: x (1, T, d) at positions ``pos ..
    pos+T-1``; ``table`` (P,) is the slot's block-table row. The chunk
    attends causally over the slot's rows before ``pos``, read from the
    pools before the chunk's own rows are written (dequantized if the pools
    are quantized), followed by its own k/v as computed: the reference's
    snapshot-plus-chunk form (``attention.py:560-640``), under which the
    chunk never sees its own keys quantized. Then the chunk's K/V go into
    the slot's pages in place (``attention.py:508``)."""
    T = x.shape[1]
    page = pools["k"].shape[1]
    positions = pos + torch.arange(T, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions[None])
    old = table[:-(-pos // page)].long()      # the pages of rows < pos
    keys = torch.cat([_read_rows(pools, "k", old, pos, x.dtype), k[0]])
    vals = torch.cat([_read_rows(pools, "v", old, pos, x.dtype), v[0]])
    blk, row = page_rows(table, positions, page)
    _write_rows(cfg, pools, blk, row, k[0], v[0])
    n = pos + T
    s = torch.einsum("tkgd,skd->kgts", q[0].float(), keys.float()) * _scale(cfg)
    if cfg.attn_softcap:
        s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
    causal = torch.arange(n, device=x.device)[None, :] <= positions[:, None]
    w = torch.softmax(s.masked_fill(~causal, NEG_INF), dim=-1)
    out = torch.einsum("kgts,skd->tkgd", w.to(x.dtype), vals)
    return out.reshape(1, T, -1) @ weight(p["o_proj"], x.dtype)
