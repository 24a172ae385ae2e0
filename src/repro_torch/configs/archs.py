"""Registry of the archs the port serves, and ``reduced`` for CPU tests."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.falcon_mamba_7b import FALCON_MAMBA_7B
from repro_torch.configs.qwen2_moe_a2_7b import QWEN2_MOE_A2_7B
from repro_torch.configs.qwen3_0_6b import QWEN3_0_6B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (QWEN3_0_6B,
                                                     FALCON_MAMBA_7B,
                                                     QWEN2_MOE_A2_7B)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, *, n_layers: int | None = None) -> ModelConfig:
    """Small same-family config for CPU smoke tests (``repro.configs.archs``
    ``reduced``, restricted to the fields the port has). Attention-free
    configs keep no heads; a MoE config keeps 8 experts, top 2 at most, of
    width 64, and at most 2 shared experts of total width 128."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers if n_layers is not None else 2 * len(cfg.pattern),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=(max(1, cfg.n_kv_heads * 4 // cfg.n_heads)
                    if cfg.n_heads else 0),
        head_dim=32 if cfg.head_dim else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            d_shared=128 if cfg.moe.d_shared else 0,
            n_shared=min(cfg.moe.n_shared, 2))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, dt_rank=16,
                                        chunk=16)
    return cfg.replace(**kw)
