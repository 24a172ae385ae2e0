"""qwen2-moe-a2.7b, as ``repro.configs.qwen2_moe_a2_7b`` defines it."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

# [hf Qwen/Qwen1.5-MoE-A2.7B] 4 shared + 60 routed top-4, gate on shared expert
QWEN2_MOE_A2_7B = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    pattern=(LayerSpec("full", "moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408,
                  d_shared=5632, renorm_topk=False, shared_gate=True),
)

CONFIG = QWEN2_MOE_A2_7B
