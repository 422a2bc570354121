"""Abstract-dataflow embedding tables (the reference's
`deepdfa_tpu/nn/embedding.py`).

Each node carries one vocab index per subkey (api, datatype, literal,
operator): 0 = node is not a definition, 1 = UNKNOWN hash, 2.. = train
hash buckets; table size = limit_all + 2. With `concat_all` (the
flagship) there is one table per subkey and the four embeddings are
concatenated to 4 * embedding_dim. `struct_vocab` adds one small table
per structural channel (frontend/structfeat.py: STRUCT_VOCAB), read from
the columns after the four subkey columns and concatenated after them.
The tables are stored in `param_dtype`, and the rows come out in it.
"""

from __future__ import annotations

import torch
from torch import nn

from deepdfa_tpu_torch.nn.init import truncated_normal_

SUBKEY_ORDER = ("api", "datatype", "literal", "operator")


class AbstractDataflowEmbedding(nn.Module):
    def __init__(self, input_dim: int, embedding_dim: int, concat_all: bool = True,
                 struct_vocab: tuple[int, ...] = (), param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.concat_all = concat_all
        self.struct_vocab = tuple(struct_vocab)
        self.names = (
            tuple(f"embed_{k}" for k in SUBKEY_ORDER) if concat_all else ("embed",)
        )
        for name in self.names:
            setattr(self, name, nn.Embedding(input_dim, embedding_dim, dtype=param_dtype))
        self.struct_names = tuple(f"embed_struct_{j}" for j in range(len(self.struct_vocab)))
        for name, vocab in zip(self.struct_names, self.struct_vocab):
            setattr(self, name, nn.Embedding(vocab, embedding_dim, dtype=param_dtype))

    @property
    def out_dim(self) -> int:
        return self.embedding_dim * (len(self.names) + len(self.struct_names))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for name in self.names + self.struct_names:
            truncated_normal_(getattr(self, name).weight, self.embedding_dim, generator)

    def forward(self, node_feats: torch.Tensor) -> torch.Tensor:
        """node_feats: [N, 4 (+S)] int -> [N, out_dim] embeddings."""
        # extraction always writes the 4 subkey columns before any struct
        # columns (data/pipeline.py:to_graph_spec): struct offsets are fixed
        struct_off = len(SUBKEY_ORDER)
        if self.struct_names and node_feats.shape[1] < struct_off + len(self.struct_names):
            raise ValueError(
                f"struct_vocab={self.struct_vocab} needs "
                f"{struct_off + len(self.struct_names)} feature columns, batch has "
                f"{node_feats.shape[1]} — extract the corpus with struct_feats=True"
            )
        idx = node_feats.long()
        outs = [getattr(self, name)(idx[:, i]) for i, name in enumerate(self.names)]
        outs += [getattr(self, name)(idx[:, struct_off + j])
                 for j, name in enumerate(self.struct_names)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
