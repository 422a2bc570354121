from deepdfa_tpu_torch.models.combined import CombinedConfig, CombinedModel
from deepdfa_tpu_torch.models.convert import (
    from_jax_clone_params,
    from_jax_combined_params,
    from_jax_defect_params,
    from_jax_encoder_params,
    from_jax_gen_params,
    from_jax_params,
    from_jax_t5_params,
)
from deepdfa_tpu_torch.models.deepdfa import DeepDFA
from deepdfa_tpu_torch.models.t5 import DefectConfig, DefectModel, T5Config, T5Encoder
from deepdfa_tpu_torch.models.t5_gen import CloneConfig, CloneModel, GenConfig, T5Seq2Seq
from deepdfa_tpu_torch.models.transformer import RobertaEncoder, TransformerConfig

__all__ = [
    "CloneConfig",
    "CloneModel",
    "CombinedConfig",
    "CombinedModel",
    "DeepDFA",
    "DefectConfig",
    "DefectModel",
    "GenConfig",
    "RobertaEncoder",
    "T5Config",
    "T5Encoder",
    "T5Seq2Seq",
    "TransformerConfig",
    "from_jax_clone_params",
    "from_jax_combined_params",
    "from_jax_defect_params",
    "from_jax_encoder_params",
    "from_jax_gen_params",
    "from_jax_params",
    "from_jax_t5_params",
]
