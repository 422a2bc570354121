"""Encoder transfer: load a trained DeepDFA's graph encoder into a
combined model (`CombinedModel` or the T5 family's `DefectModel`) and
freeze it (the reference's `train/transfer.py`).

The reference workflow (`--freeze_graph`): train the GGNN alone, load its
embedding, GGNN and pooling weights (not its classification head) into
the combined model's graph branch, and keep them fixed while the
transformer fine-tunes. The reference freezes with `optax.masked`:
frozen leaves get neither an update nor weight decay, and the gradient
clip's global norm covers the trainable leaves only. Here frozen
parameters are left out of the optimiser and set `requires_grad=False`,
which gives the same three properties.
"""

from __future__ import annotations

from typing import Mapping

import torch

#: the graph encoder's submodules (the DeepDFA head is not one of them)
ENCODER_PARTS = ("embedding", "ggnn", "pooling")


def graph_encoder_subset(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The embedding, GGNN and pooling entries of a DeepDFA state dict;
    the classification head is dropped. Raises KeyError when a part is
    missing."""
    sub = {k: v for k, v in state_dict.items() if k.split(".", 1)[0] in ENCODER_PARTS}
    missing = [p for p in ENCODER_PARTS if not any(k.startswith(p + ".") for k in sub)]
    if missing:
        raise KeyError(f"graph encoder parameters missing {missing}")
    return sub


def load_graph_encoder(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Copy a trained DeepDFA's encoder weights into `model.graph` (the
    graph branch of a `CombinedModel` or `DefectModel`), in place."""
    sub = graph_encoder_subset(state_dict)
    own = model.graph.state_dict()
    unknown = sorted(set(sub) - set(own))
    if unknown:
        raise KeyError(f"the combined model's graph branch has no {unknown}")
    with torch.no_grad():
        for k, v in sub.items():
            if own[k].shape != v.shape:
                raise ValueError(f"graph.{k}: checkpoint {tuple(v.shape)} vs model "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(v)


def freeze(model: torch.nn.Module) -> None:
    """Stop gradients into a combined model's graph branch (none when the
    model has no graph branch)."""
    for name, p in model.named_parameters():
        if name.startswith("graph."):
            p.requires_grad_(False)
