from deepdfa_tpu_torch.models.combined import CombinedConfig, CombinedModel
from deepdfa_tpu_torch.models.convert import (
    from_jax_combined_params,
    from_jax_encoder_params,
    from_jax_params,
)
from deepdfa_tpu_torch.models.deepdfa import DeepDFA
from deepdfa_tpu_torch.models.transformer import RobertaEncoder, TransformerConfig

__all__ = [
    "CombinedConfig",
    "CombinedModel",
    "DeepDFA",
    "RobertaEncoder",
    "TransformerConfig",
    "from_jax_combined_params",
    "from_jax_encoder_params",
    "from_jax_params",
]
