"""The C frontend: the port's copy of the reference's
`deepdfa_tpu/frontend/` (tokens, preproc, parser, cpg, reaching, deps,
absdf, vocab, structfeat). Under backend "auto" the lexer and the reaching-definitions
solver run the port's native C++ library (`deepdfa_tpu_torch/native`),
as the reference's default path does; "python" runs the Python spec."""

from deepdfa_tpu_torch.frontend.absdf import (
    decl_features,
    graph_features,
    is_decl,
    node_hash,
)
from deepdfa_tpu_torch.frontend.cpg import Cpg, Node
from deepdfa_tpu_torch.frontend.parser import ParseError, parse_function
from deepdfa_tpu_torch.frontend.reaching import Definition, ReachingDefinitions
from deepdfa_tpu_torch.frontend.vocab import AbsDfVocab, build_vocab, build_vocabs, encode_nodes

__all__ = [
    "Cpg",
    "Node",
    "ParseError",
    "parse_function",
    "Definition",
    "ReachingDefinitions",
    "decl_features",
    "graph_features",
    "is_decl",
    "node_hash",
    "AbsDfVocab",
    "build_vocab",
    "build_vocabs",
    "encode_nodes",
]
