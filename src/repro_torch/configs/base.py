"""The port's own copy of the ``ModelConfig`` fields the served families read.

Field names, defaults and meanings are those of ``repro.configs.base``
(``tests/test_torch_model.py`` holds the two against each other), restricted
to what the port serves: dense decoder-only models with full attention, and
Mamba-1 state-space models (``SSMConfig``). Families the port does not serve
yet have no fields here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "full"
    mlp: str = "dense"


#: the layer kinds the port serves; a pattern repeats one of them
FULL, MOE, MAMBA = (LayerSpec("full", "dense"), LayerSpec("full", "moe"),
                    LayerSpec("mamba", "none"))


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0
    d_expert: int = 1408          # per-expert FFN hidden size
    d_shared: int = 0             # total shared hidden (0 => n_shared*d_expert)
    capacity_factor: float = 1.25
    renorm_topk: bool = True      # renormalize top-k gates (qwen2-moe: no)
    shared_gate: bool = False     # qwen2-moe gates the shared expert output
    router_dtype: str = "float32"

    @property
    def shared_hidden(self) -> int:
        return self.d_shared or self.n_shared * self.d_expert


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model / 16)
    chunk: int = 256              # selective-scan chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm
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
    use_rope: bool = True         # rotary positions
    moe: MoEConfig | None = None  # set for mixture-of-experts MLPs
    ssm: SSMConfig | None = None  # set for Mamba-1 layers
    act: str = "silu"             # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/compute dtype
    page_size: int = 16
    prefill_chunk: int = 64
    # weight-only quantization of the matmul weights (repro_torch.quant) and
    # quantized paged KV pools with per-row float16 scales; int4 is
    # weight-only, since pool rows stay byte-addressable
    weight_dtype: str = ""        # "" | int8 | fp8 | float8_e4m3fn | int4
    kv_dtype: str = ""            # "" | int8 | fp8 | float8_e4m3fn
    quant_block: int = 0          # 0 => per-channel; else scale-block length

    def __post_init__(self):
        kinds = set(self.pattern)
        if len(kinds) != 1 or not kinds <= {FULL, MOE, MAMBA} or (
                kinds == {MAMBA} and self.ssm is None) or (
                kinds == {MOE} and self.moe is None):
            raise NotImplementedError(
                f"{self.name}: the port serves a repeated full-attention "
                f"dense layer, a repeated full-attention moe layer with moe "
                f"set, or a repeated mamba layer with ssm set; got pattern "
                f"{self.pattern}")
        if self.is_ssm and (self.weight_dtype or self.kv_dtype):
            raise NotImplementedError(
                f"{self.name}: weight_dtype / kv_dtype on mamba layers; the "
                "port does not quantize recurrent projections yet")
        if self.is_moe and (self.weight_dtype or self.kv_dtype):
            raise NotImplementedError(
                f"{self.name}: weight_dtype / kv_dtype on moe layers; the "
                "port does not quantize experts yet")
        if self.act not in ("silu", "gelu"):
            raise ValueError(f"act={self.act!r}; expected silu or gelu")
        if not self.is_ssm and (self.n_kv_heads < 1
                                or self.n_heads % self.n_kv_heads):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.page_size < 1 or self.prefill_chunk < 1:
            raise ValueError("page_size and prefill_chunk must be >= 1")
        quant_names = ("", "int8", "fp8", "float8_e4m3fn")
        if self.weight_dtype not in quant_names + ("int4",):
            raise ValueError(f"weight_dtype={self.weight_dtype!r}; expected "
                             f"one of {quant_names + ('int4',)}")
        if self.kv_dtype not in quant_names:
            raise ValueError(f"kv_dtype={self.kv_dtype!r}; expected one of "
                             f"{quant_names}")
        if self.quant_block < 0:
            raise ValueError("quant_block must be >= 0")

    @property
    def compute_dtype(self) -> torch.dtype:
        """``dtype`` as a torch dtype (bfloat16, float32, ...)."""
        return getattr(torch, self.dtype)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_ssm(self) -> bool:
        """Every layer is a Mamba-1 mixer with no MLP (no attention, no
        paged KV pools)."""
        return self.pattern[0] == MAMBA

    @property
    def is_moe(self) -> bool:
        """Every layer is full attention with a mixture-of-experts MLP
        (``models/moe.py``)."""
        return self.pattern[0] == MOE

    @property
    def d_inner(self) -> int:
        """Mamba's inner width, ``expand * d_model``."""
        return self.ssm.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
