"""Dataset coverage analysis: abstract-dataflow feature statistics (the
port's copy of the reference's `deepdfa_tpu/eval/coverage.py`).

Replaces the reference's --analyze_dataset audit
(DDFA/code_gnn/main_cli.py:192-313 get_coverage): per split, how many
nodes are definitions, how many map to known vs UNKNOWN hashes, and the
resulting known-def coverage percentage that the paper reports to justify
the vocab limits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deepdfa_tpu_torch.frontend.vocab import NOT_A_DEF, UNKNOWN_IDX
from deepdfa_tpu_torch.graphs.batch import GraphSpec


@dataclass
class CoverageStats:
    n_graphs: int
    n_nodes: int
    n_def_nodes: int
    n_known: int
    n_unknown: int

    @property
    def def_rate(self) -> float:
        return self.n_def_nodes / max(self.n_nodes, 1)

    @property
    def known_coverage(self) -> float:
        """Fraction of definition nodes with an in-vocab hash."""
        return self.n_known / max(self.n_def_nodes, 1)

    def as_dict(self) -> dict:
        return {
            "n_graphs": self.n_graphs,
            "n_nodes": self.n_nodes,
            "n_def_nodes": self.n_def_nodes,
            "n_known": self.n_known,
            "n_unknown": self.n_unknown,
            "def_rate": self.def_rate,
            "known_coverage": self.known_coverage,
        }


def coverage(specs: list[GraphSpec], feat_column: int = 1) -> CoverageStats:
    """Audit one split. feat_column picks the subkey column (default:
    datatype, the reference flagship feature)."""
    n_nodes = n_def = n_known = n_unknown = 0
    for s in specs:
        col = np.asarray(s.node_feats[:, feat_column])
        n_nodes += col.shape[0]
        is_def = col != NOT_A_DEF
        n_def += int(is_def.sum())
        n_unknown += int((col == UNKNOWN_IDX).sum())
        n_known += int((col > UNKNOWN_IDX).sum())
    return CoverageStats(
        n_graphs=len(specs),
        n_nodes=n_nodes,
        n_def_nodes=n_def,
        n_known=n_known,
        n_unknown=n_unknown,
    )


def coverage_report(split_specs: dict[str, list[GraphSpec]]) -> dict[str, dict]:
    return {split: coverage(specs).as_dict() for split, specs in split_specs.items()}
