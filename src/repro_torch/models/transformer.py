"""The dense decoder spine (``repro/models/transformer.py``).

Parameters are a plain dict of tensors in the compute dtype. Per-layer
tensors are stacked on a leading ``blocks`` axis, as the reference stacks
its scanned pattern (``transformer.py:76-114``):

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (d, V)],
     "blocks": {"pre_norm", "q_proj", "k_proj", "v_proj", "o_proj",
                ["q_norm", "k_norm"], "mlp_norm", ["gate"], "up", "down"}}

with projection kernels stored (d_in, d_out) and norms computing
``x * (1 + scale)``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm


def init(cfg: ModelConfig, *, seed: int = 0, device: str = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    the reference's initializers (normal / sqrt(fan_in) kernels and
    embedding, zero norm scales), drawn in float32 and cast once to the
    compute dtype. They are not ``jax.random``'s numbers."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    H, K, F, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.compute_dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=cfg.compute_dtype)

    blocks = {"pre_norm": zeros(L, d), "q_proj": normal((L, d, H * hd), d),
              "k_proj": normal((L, d, K * hd), d),
              "v_proj": normal((L, d, K * hd), d),
              "o_proj": normal((L, H * hd, d), H * hd),
              "mlp_norm": zeros(L, d), "up": normal((L, d, F), d),
              "down": normal((L, F, d), F)}
    if cfg.qk_norm:
        blocks["q_norm"] = zeros(L, hd)
        blocks["k_norm"] = zeros(L, hd)
    if cfg.gated_mlp:
        blocks["gate"] = normal((L, d, F), d)
    params = {"embed": normal((V, d), d), "final_norm": zeros(d),
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, V), d)
    return params


def _layers(params: dict):
    """Per-layer views of the stacked ``blocks`` tensors."""
    blocks = params["blocks"]
    n = next(iter(blocks.values())).shape[0]
    for i in range(n):
        yield i, {name: t[i] for name, t in blocks.items()}


def _block(lp: dict, cfg: ModelConfig, x: torch.Tensor, attend) -> torch.Tensor:
    """Pre-norm residual block: attention, then the MLP."""
    x = x + attend(apply_norm(lp["pre_norm"], x, cfg.norm_eps))
    h = apply_norm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + apply_mlp(lp, h, cfg.act, cfg.gated_mlp)


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """(B, S) int ids -> (B, S, d) in the compute dtype (``:382``)."""
    return params["embed"][tokens]


def logits_fn(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head (the tied embedding unless ``lm_head``), as
    float32 logits (``:405``)."""
    h = apply_norm(params["final_norm"], x, cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (h @ head).float()


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Whole-sequence causal pass, (B, S) ids -> hidden (B, S, d); every
    layer's attention reads through ``flash_attention`` (``:448``)."""
    x = embed_tokens(params, cfg, tokens)
    for _, lp in _layers(params):
        x = _block(lp, cfg, x, lambda h, lp=lp: attn.attention_forward(
            lp, cfg, h))
    return x


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor,
                block_tables: torch.Tensor) -> torch.Tensor:
    """One decode step for B slots: tokens (B, 1) at positions ``pos``
    (B,), slots' block-table rows (B, P) int32. Writes the pools in place;
    returns logits (B, 1, V) (``:479``)."""
    x = embed_tokens(params, cfg, tokens)
    for i, lp in _layers(params):
        pools = {"k": cache["k"][i], "v": cache["v"][i]}
        x = _block(lp, cfg, x, lambda h, lp=lp, pools=pools:
                   attn.attention_decode(lp, cfg, h, pools, pos,
                                         block_tables))
    return logits_fn(params, cfg, x)


def extend_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int, slot: int,
                block_tables: torch.Tensor) -> torch.Tensor:
    """Chunked prefill of slot ``slot``: tokens (1, T) at positions
    ``pos .. pos+T-1``. Writes the pools in place; returns the logits
    (1, 1, V) of the chunk's last token (``:512``)."""
    x = embed_tokens(params, cfg, tokens)
    table = block_tables[slot]
    for i, lp in _layers(params):
        pools = {"k": cache["k"][i], "v": cache["v"][i]}
        x = _block(lp, cfg, x, lambda h, lp=lp, pools=pools:
                   attn.attention_extend(lp, cfg, h, pools, pos, table))
    return logits_fn(params, cfg, x[:, -1:])
