"""deepdfa_tpu_torch: the C frontend and data preparation, the DeepDFA
scorer and trainer, the combined DeepDFA+LineVul and CodeT5+DeepDFA
scorers and trainers, and the CodeT5 generation family, in PyTorch, for
NVIDIA Hopper.

A second package beside `deepdfa_tpu` (the JAX reference). It imports
`torch` and `numpy` only — never `jax`, `flax` or any `deepdfa_tpu`
module — and keeps its own copy of the host code it needs. Each GGNN
step on a CUDA device runs one hand-written CUDA C++ kernel
(`csrc/ggnn_step.cu`) and its backward two more (`csrc/ggnn_bwd.cu`);
each transformer layer's attention runs the flash-attention kernels
(`csrc/flash_attention.cu`; the T5 decoder's self-attention its causal
build). On the CPU the same steps run as
plain PyTorch, which is what the parity tests hold against the JAX
package.

Layering (bottom-up):
  core/     typed config (the JSON files shared with the JAX package), device choice
  graphs/   GraphSpec / GraphBatch, `pack` and the bucket planner, bit-for-bit
            with the reference; the graph store
  frontend/ the C frontend: lexer, `#if` preprocessor, parser into a CPG, reaching
            definitions, dependences, abstract-dataflow features and vocabularies;
            the java, c#, js, go, php and ruby dialects CodeBLEU parses
  data/     dataset readers, the synthetic corpus, diff line labels, the extraction
            pipeline (C source -> GraphSpec); the hash tokenizer, the text (+ graph)
            collater of the combined path, the generation and clone task readers
  csrc/     CUDA C++ kernel sources, built at first use by nn/cuda_build.py
  nn/       the GGNN step kernels' wrappers and autograd Function, the flash-attention
            wrapper, embedding, GGNN, pooling, head
  models/   DeepDFA, the RoBERTa and T5 encoders, the combined and defect models, the
            T5 encoder-decoder (beam search, clone head) and the parameter converters
  serve/    ladder and bucket executors, dynamic batcher, offline scoring drives
  eval/     CodeBLEU (n-gram, weighted n-gram, syntax and dataflow matches; the
            digit-exact java/c# dataflow), calibration, localization, profiling
  train/    losses, optimiser state, samplers, metrics, checkpoints, GraphTrainer,
            CombinedTrainer, GenTrainer, fit_multi, CloneTrainer
  cli.py    `python -m deepdfa_tpu_torch.cli prepare|extract-vocab|extract|train|test|
            train-combined|train-gen|train-multi-gen|train-clone|tune|codebleu|...`
"""

__version__ = "0.1.0"
