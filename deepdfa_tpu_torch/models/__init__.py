from deepdfa_tpu_torch.models.convert import from_jax_params
from deepdfa_tpu_torch.models.deepdfa import DeepDFA

__all__ = ["DeepDFA", "from_jax_params"]
