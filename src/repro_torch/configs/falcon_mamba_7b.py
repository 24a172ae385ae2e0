"""falcon-mamba-7b, as ``repro.configs.falcon_mamba_7b`` defines it."""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

# [arXiv:2410.05355; hf tiiuae/falcon-mamba-7b] mamba1 arch
FALCON_MAMBA_7B = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    pattern=(LayerSpec("mamba", "none"),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    use_rope=False,
)

CONFIG = FALCON_MAMBA_7B
