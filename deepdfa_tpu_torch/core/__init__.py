from deepdfa_tpu_torch.core.config import (
    BatchConfig,
    Config,
    DataConfig,
    FeatureSpec,
    ModelConfig,
    ServeConfig,
    from_dict,
    load,
)
from deepdfa_tpu_torch.core.device import resolve_device

__all__ = [
    "BatchConfig",
    "Config",
    "DataConfig",
    "FeatureSpec",
    "ModelConfig",
    "ServeConfig",
    "from_dict",
    "load",
    "resolve_device",
]
