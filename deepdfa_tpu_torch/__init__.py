"""deepdfa_tpu_torch: the DeepDFA scorer and trainer in PyTorch, for
NVIDIA Hopper.

A second package beside `deepdfa_tpu` (the JAX reference). It imports
`torch` and `numpy` only — never `jax`, `flax` or any `deepdfa_tpu`
module — and keeps its own copy of the host code it needs. Each GGNN
step on a CUDA device runs one hand-written CUDA C++ kernel
(`csrc/ggnn_step.cu`) and its backward two more (`csrc/ggnn_bwd.cu`);
on the CPU the same steps run as plain PyTorch, which is what the
parity tests hold against the JAX package.

Layering (bottom-up):
  core/     typed config (the JSON files shared with the JAX package), device choice
  graphs/   GraphSpec / GraphBatch, `pack` and the bucket planner, bit-for-bit
            with the reference; the graph-store reader
  csrc/     CUDA C++ kernel sources, built at first use by nn/cuda_build.py
  nn/       the GGNN step kernels' wrappers and autograd Function, embedding,
            GGNN, pooling, head
  models/   DeepDFA and the Flax-params converter
  serve/    ladder executor, dynamic batcher, offline scoring drive
  train/    losses, optimiser state, samplers, metrics, checkpoints, GraphTrainer
  cli.py    `python -m deepdfa_tpu_torch.cli train|test`
"""

__version__ = "0.1.0"
