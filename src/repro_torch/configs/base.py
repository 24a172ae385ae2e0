"""The port's own copy of the ``ModelConfig`` fields the dense decoder reads.

Field names, defaults and meanings are those of ``repro.configs.base``
(``tests/test_torch_model.py`` holds the two against each other), restricted
to what a dense decoder-only model with full attention needs. Families the
port does not serve yet have no fields here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "full"
    mlp: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0             # 0 => d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec("full", "dense"),)
    attn_softcap: float = 0.0
    attn_scale: float = 0.0       # 0 => 1/sqrt(head_dim)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"             # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/compute dtype
    page_size: int = 16
    prefill_chunk: int = 64

    def __post_init__(self):
        if any(sp != LayerSpec("full", "dense") for sp in self.pattern):
            raise NotImplementedError(
                f"{self.name}: the port serves full-attention dense layers "
                f"only, got pattern {self.pattern}")
        if self.act not in ("silu", "gelu"):
            raise ValueError(f"act={self.act!r}; expected silu or gelu")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.page_size < 1 or self.prefill_chunk < 1:
            raise ValueError("page_size and prefill_chunk must be >= 1")

    @property
    def compute_dtype(self) -> torch.dtype:
        """``dtype`` as a torch dtype (bfloat16, float32, ...)."""
        return getattr(torch, self.dtype)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
