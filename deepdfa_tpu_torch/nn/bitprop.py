"""Differentiable reaching-definitions propagation (the port of the
reference's `deepdfa_tpu/nn/bitprop.py`), the bitvector GGNN variant
behind the `dataflow_solution_{in,out}` label styles: the network's
message passing simulates the reaching-definitions fixpoint over soft
bitvectors, supervised by the exact solver's solution.

State: per node, a (0..1)-valued membership vector over definition
sites. A step (OUT = gen U (IN - kill), IN = U over preds of OUT):

    in_v   = union of out_u over incoming edges (nn/setops.py)
    out_v  = union(gen_v, in_v * (1 - kill_v))

Iterated n_steps times from out = gen; with hard 0/1 gen/kill and
n_steps >= n_nodes + 1 this equals the worklist solver's fixpoint
(`frontend/reaching.py`). `learned_gate=True` scales kill by a learned
per-node sigmoid gate over the node features (`kill_gate`).

The union over incoming edges is `setops.node_union`: a fixed-order
segment sum (the `csrc/setops.cu` kernel on the card), forward and
backward, so a step gives the same bits on every run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepdfa_tpu_torch.frontend.cpg import Cpg
from deepdfa_tpu_torch.frontend.reaching import ReachingDefinitions
from deepdfa_tpu_torch.nn import setops
from deepdfa_tpu_torch.nn.mlp import Dense


def rd_bit_problem(cpg: Cpg, max_defs: int, clip: bool = False):
    """Host-side: CFG arrays + gen/kill bit matrices + exact IN/OUT labels.

    None when the graph has no definitions, or (unless `clip`) more than
    max_defs of them; with clip=True only the first max_defs definition
    sites (in node order) carry bits, the corpus-label semantics where
    every graph gives fixed-width arrays. Dense node order follows
    cfg_nodes(); bit d is the d-th definition site in node order; the
    dict holds that node order under "nodes"."""
    rd = ReachingDefinitions(cpg)
    nodes, dense, src, dst = rd.dense_cfg()
    sites = [n for n in nodes if rd.gen_set[n]]
    if not sites or (len(sites) > max_defs and not clip):
        return None
    sites = sites[:max_defs]
    site_idx = {n: i for i, n in enumerate(sites)}

    n_nodes = len(nodes)
    gen = np.zeros((n_nodes, max_defs), np.float32)
    kill = np.zeros((n_nodes, max_defs), np.float32)
    var_of_site = {}
    for s in sites:
        (d,) = rd.gen_set[s]
        var_of_site[s] = d.var
    for n in nodes:
        if not rd.gen_set[n]:
            continue
        (d,) = rd.gen_set[n]
        if n in site_idx:  # clipped sites own no bit...
            gen[dense[n], site_idx[n]] = 1.0
        for s in sites:  # ...but still kill tracked sites of their var
            if var_of_site[s] == d.var and s != n:
                kill[dense[n], site_idx[s]] = 1.0

    in_sets = rd.solve()
    labels_in = np.zeros((n_nodes, max_defs), np.float32)
    for n, defs in in_sets.items():
        for d in defs:
            if d.node in site_idx:
                labels_in[dense[n], site_idx[d.node]] = 1.0
    # OUT derives from IN in one pass (no second fixpoint solve)
    labels_out = np.zeros((n_nodes, max_defs), np.float32)
    for n in nodes:
        out_defs = set(rd.gen(n)) | (in_sets[n] - rd.kill(n, in_sets[n]))
        for d in out_defs:
            if d.node in site_idx:
                labels_out[dense[n], site_idx[d.node]] = 1.0
    return {
        "gen": gen,
        "kill": kill,
        "edge_src": np.array(src, np.int32),
        "edge_dst": np.array(dst, np.int32),
        "labels_in": labels_in,
        "labels_out": labels_out,
        "n_nodes": n_nodes,
        "nodes": nodes,
    }


class BitvectorPropagation(nn.Module):
    """n_steps of differentiable OUT = gen U (IN - kill) over a batch.

    learned_gate=False is a parameter-free exact simulator (the parity
    check against the worklist solver); learned_gate=True gates kill per
    node with sigmoid(kill_gate(node_feats)), a `Dense(width, 1)` (fp32
    parameters, as the reference's). `axis_name` (the reference's
    edge-sharded union) is multi-device work, ROADMAP queue A item 9."""

    def __init__(self, n_steps: int, union_type: str = "simple", learned_gate: bool = False,
                 width: int | None = None, axis_name: str | None = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                f"BitvectorPropagation(axis_name={axis_name!r}): the edge-sharded union "
                "comes with the multi-device slice of the port (ROADMAP queue A, item 9)")
        if union_type not in ("simple", "relu"):
            raise ValueError(f"unknown union_type {union_type}")
        self.n_steps = n_steps
        self.union_type = union_type
        self.learned_gate = learned_gate
        if learned_gate:
            if width is None:
                raise ValueError("learned_gate needs the gate's input width")
            self.kill_gate = Dense(width, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if self.learned_gate:
            self.kill_gate.init_flax(generator)

    def forward(self, gen, kill, edge_src, edge_dst, edge_mask, node_feats=None):
        """gen, kill [N, B] -> (in_state, out_state), each [N, B]."""
        if self.learned_gate:
            gate_in = node_feats if node_feats is not None else gen
            kill = kill * torch.sigmoid(self.kill_gate(gate_in))
        union = setops.simple_union if self.union_type == "simple" else setops.relu_union
        runs = setops.edge_runs(edge_src, edge_dst, edge_mask, gen.shape[0])
        out = gen
        in_ = torch.zeros_like(gen)
        for _ in range(self.n_steps):
            in_ = setops.node_union(out, runs, self.union_type)
            out = union(gen, in_ * (1.0 - kill))
        return in_, out
