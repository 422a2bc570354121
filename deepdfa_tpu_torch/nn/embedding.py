"""Abstract-dataflow embedding tables (the reference's
`deepdfa_tpu/nn/embedding.py`).

Each node carries one vocab index per subkey (api, datatype, literal,
operator): 0 = node is not a definition, 1 = UNKNOWN hash, 2.. = train
hash buckets; table size = limit_all + 2. With `concat_all` (the
flagship) there is one table per subkey and the four embeddings are
concatenated to 4 * embedding_dim.
"""

from __future__ import annotations

import torch
from torch import nn

from deepdfa_tpu_torch.nn.init import truncated_normal_

SUBKEY_ORDER = ("api", "datatype", "literal", "operator")


class AbstractDataflowEmbedding(nn.Module):
    def __init__(self, input_dim: int, embedding_dim: int, concat_all: bool = True):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.concat_all = concat_all
        self.names = (
            tuple(f"embed_{k}" for k in SUBKEY_ORDER) if concat_all else ("embed",)
        )
        for name in self.names:
            setattr(self, name, nn.Embedding(input_dim, embedding_dim))

    @property
    def out_dim(self) -> int:
        return self.embedding_dim * len(self.names)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for name in self.names:
            truncated_normal_(getattr(self, name).weight, self.embedding_dim, generator)

    def forward(self, node_feats: torch.Tensor) -> torch.Tensor:
        """node_feats: [N, 4] int -> [N, out_dim] embeddings."""
        idx = node_feats.long()
        outs = [getattr(self, name)(idx[:, i]) for i, name in enumerate(self.names)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
