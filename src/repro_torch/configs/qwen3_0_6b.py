"""qwen3-0.6b, as ``repro.configs.qwen3_0_6b`` defines it."""
from repro_torch.configs.base import LayerSpec, ModelConfig

# [hf Qwen/Qwen3-0.6B] qk-norm, GQA, head_dim 128
QWEN3_0_6B = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    pattern=(LayerSpec("full", "dense"),),
    qk_norm=True, rope_theta=1000000.0,
)

CONFIG = QWEN3_0_6B
