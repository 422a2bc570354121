"""deepdfa_tpu_torch: the DeepDFA scorer in PyTorch, for NVIDIA Hopper.

A second package beside `deepdfa_tpu` (the JAX reference). It imports
`torch` and `numpy` only — never `jax`, `flax` or any `deepdfa_tpu`
module — and keeps its own copy of the host code it needs. Each GGNN
step on a CUDA device runs one hand-written CUDA C++ kernel
(`csrc/ggnn_step.cu`); on the CPU the same step runs as plain PyTorch,
which is what the parity tests hold against the JAX package.

Layering (bottom-up):
  core/     typed config (the JSON files shared with the JAX package), device choice
  graphs/   GraphSpec / GraphBatch and `pack`, bit-for-bit with the reference
  csrc/     CUDA C++ kernel sources, built at first use by nn/cuda_build.py
  nn/       the GGNN step kernel wrapper, embedding, GGNN, pooling, head
  models/   DeepDFA and the Flax-params converter
  serve/    ladder executor, dynamic batcher, offline scoring drive
"""

__version__ = "0.1.0"
