"""Registry of the archs the port serves, and ``reduced`` for CPU tests."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen3_0_6b import QWEN3_0_6B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (QWEN3_0_6B,)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, *, n_layers: int | None = None) -> ModelConfig:
    """Small same-family config for CPU smoke tests (``repro.configs.archs``
    ``reduced``, restricted to the fields the port has)."""
    return cfg.replace(
        name=cfg.name + "-smoke",
        n_layers=n_layers if n_layers is not None else 2 * len(cfg.pattern),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
        head_dim=32 if cfg.head_dim else 0,
        d_ff=256,
        vocab_size=512,
    )
