from repro_torch.models.api import Model, build_model
from repro_torch.models.config import GLOBAL, Family, ModelConfig
from repro_torch.models.transformer import Runtime

__all__ = ["GLOBAL", "Family", "Model", "ModelConfig", "Runtime", "build_model"]
