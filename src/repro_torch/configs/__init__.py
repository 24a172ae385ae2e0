from repro_torch.configs.archs import ARCHS, get_arch, reduced
from repro_torch.configs.base import LayerSpec, ModelConfig

__all__ = ["ARCHS", "LayerSpec", "ModelConfig", "get_arch", "reduced"]
