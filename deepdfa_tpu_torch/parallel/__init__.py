"""Model-parallel building blocks of the port: the mixture-of-experts FFN
(`moe.py`) on one device. The reference's multi-device forms (expert
parallelism over an `ep` mesh axis) are ROADMAP queue A, item 9."""

from deepdfa_tpu_torch.parallel.moe import MoE, MoEConfig, capacity, init_moe_params, moe_ffn

__all__ = ["MoE", "MoEConfig", "capacity", "init_moe_params", "moe_ffn"]
