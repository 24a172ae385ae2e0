from repro_torch.configs.archs import ARCHS, get_arch, reduced
from repro_torch.configs.base import (LayerSpec, ModelConfig, MoEConfig,
                                     SSMConfig)

__all__ = ["ARCHS", "LayerSpec", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_arch", "reduced"]
