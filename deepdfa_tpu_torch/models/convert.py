"""Reference parameter trees -> the port's `state_dict`s.

`from_jax_params`: the Flax DeepDFA variables, `{"params": {...}}` (or
the bare params dict) with numpy arrays as leaves. Embedding tables and
the GGNN's weights keep their layout (the CUDA kernel reads the
reference's [in, out] kernels as they are); the per-etype Dense
subtrees stack into one [T, d, d] tensor; Dense layers that become
`nn.Linear` are transposed to [out, in].

`from_jax_encoder_params` / `from_jax_combined_params`: the transformer
encoder's and the combined model's parameter pytrees
(`models/transformer.py:init_params`, `models/combined.py:init_params`
of the reference). The stacked per-layer weights ([L, D, H, Dh] for
q/k/v, [L, H, Dh, D] for the output projection, [L, D, F] / [L, F, D]
for the FFN) split into the port's layers, with q, k and v fused into
one [D, 3*H*Dh] kernel; the graph encoder goes through
`from_jax_params`; the head's [in, out] Dense kernels are transposed for
`nn.Linear`.

`from_jax_t5_params` / `from_jax_defect_params`: the T5 encoder's and
the CodeT5+DeepDFA defect model's trees (`models/t5.py:init_params`,
`init_defect_params` of the reference): `wq/wk/wv [L, D, H, Dh]` fuse
into each layer's [D, 3*H*Dh] `wqkv`, `wo [L, H, Dh, D]` becomes [H*Dh,
D], `wi`, `wo_ffn`, `ln1`, `ln2`, `final_ln`, `word` and `rel_bias [32,
H]` keep their layout, the head's [in, 2] kernel is transposed for
`nn.Linear` and the graph encoder goes through `from_jax_params`.

`from_jax_gen_params` / `from_jax_clone_params`: the seq2seq and clone
trees (`models/t5_gen.py:init_gen_params`, `init_clone_params` of the
reference). The decoder's `wq/wk/wv` fuse into `wqkv`, `cq` stays [D,
H*Dh], `ck/cv` fuse into `ckv` [D, 2*H*Dh], `wo`/`co` become [H*Dh, D];
an untied `lm_head` [V, D] keeps its layout (the model must then be
built with `untied_head=True`); the clone head's Dense kernels are
transposed for `nn.Linear`.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def from_jax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    p = tree["params"] if "params" in tree else tree
    unknown = set(p) - {"embedding", "ggnn", "pooling", "head"}
    if unknown:
        raise KeyError(
            f"parameter subtrees the port has no module for: {sorted(unknown)}"
        )
    sd: dict[str, torch.Tensor] = {}
    for name, sub in p["embedding"].items():
        sd[f"embedding.{name}.weight"] = _t(sub["embedding"])

    g = p["ggnn"]
    etypes = sorted(
        (k for k in g if re.fullmatch(r"etype_\d+", k)), key=lambda k: int(k[6:])
    )
    sd["ggnn.etype_kernel"] = torch.stack([_t(g[k]["kernel"]) for k in etypes])
    sd["ggnn.etype_bias"] = torch.stack([_t(g[k]["bias"]) for k in etypes])
    gru = g["GRUCell_0"]
    sd["ggnn.gru.input_kernel"] = _t(gru["input_proj"]["kernel"])
    sd["ggnn.gru.input_bias"] = _t(gru["input_proj"]["bias"])
    sd["ggnn.gru.hidden_kernel"] = _t(gru["hidden_proj"]["kernel"])
    sd["ggnn.gru.hidden_bias"] = _t(gru["hidden_proj"]["bias"])

    if "pooling" in p:
        gate = p["pooling"]["gate_nn"]
        sd["pooling.gate_nn.weight"] = _t(gate["kernel"]).T.contiguous()
        sd["pooling.gate_nn.bias"] = _t(gate["bias"])
    for name, dense in p.get("head", {}).items():
        sd[f"head.{name}.weight"] = _t(dense["kernel"]).T.contiguous()
        sd[f"head.{name}.bias"] = _t(dense["bias"])
    return sd


def from_jax_encoder_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference encoder tree {"embeddings", "layers"[, "pooler"]} ->
    a `RobertaEncoder` state_dict (with its pooler iff the tree has one)."""
    unknown = set(tree) - {"embeddings", "layers", "pooler"}
    if unknown:
        raise KeyError(f"encoder subtrees the port has no module for: {sorted(unknown)}")
    sd: dict[str, torch.Tensor] = {}
    for name in ("word", "position", "token_type", "ln_scale", "ln_bias"):
        sd[f"embeddings.{name}"] = _t(tree["embeddings"][name])
    lay = {k: np.asarray(v, np.float32) for k, v in tree["layers"].items()}
    n_layers, d = lay["wq"].shape[:2]
    for i in range(n_layers):
        pre = f"layers.{i}."
        sd[pre + "wqkv"] = _t(np.concatenate(
            [lay[w][i].reshape(d, -1) for w in ("wq", "wk", "wv")], axis=1))
        sd[pre + "bqkv"] = _t(np.concatenate(
            [lay[b][i].reshape(-1) for b in ("bq", "bk", "bv")]))
        sd[pre + "wo"] = _t(lay["wo"][i].reshape(-1, d))
        for name in ("bo", "ln1_scale", "ln1_bias", "w1", "b1", "w2", "b2",
                     "ln2_scale", "ln2_bias"):
            sd[pre + name] = _t(lay[name][i])
    if "pooler" in tree:
        sd["pooler_w"] = _t(tree["pooler"]["w"])
        sd["pooler_b"] = _t(tree["pooler"]["b"])
    return sd


def from_jax_combined_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference combined tree {"encoder", "head"[, "graph"]} -> a
    `CombinedModel` state_dict."""
    unknown = set(tree) - {"encoder", "head", "graph"}
    if unknown:
        raise KeyError(f"combined subtrees the port has no module for: {sorted(unknown)}")
    sd = {f"encoder.{k}": v for k, v in from_jax_encoder_params(tree["encoder"]).items()}
    head = tree["head"]
    sd["head_dense.weight"] = _t(head["dense_w"]).T.contiguous()
    sd["head_dense.bias"] = _t(head["dense_b"])
    sd["head_out.weight"] = _t(head["out_w"]).T.contiguous()
    sd["head_out.bias"] = _t(head["out_b"])
    if "graph" in tree:
        sd.update({f"graph.{k}": v for k, v in from_jax_params(tree["graph"]).items()})
    return sd


def from_jax_t5_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference T5 tree {"word", "rel_bias", "layers", "final_ln"} ->
    a `T5Encoder` state_dict."""
    unknown = set(tree) - {"word", "rel_bias", "layers", "final_ln"}
    if unknown:
        raise KeyError(f"T5 subtrees the port has no module for: {sorted(unknown)}")
    sd = {name: _t(tree[name]) for name in ("word", "rel_bias", "final_ln")}
    lay = {k: np.asarray(v, np.float32) for k, v in tree["layers"].items()}
    n_layers, d = lay["wq"].shape[:2]
    for i in range(n_layers):
        pre = f"layers.{i}."
        sd[pre + "wqkv"] = _t(np.concatenate(
            [lay[w][i].reshape(d, -1) for w in ("wq", "wk", "wv")], axis=1))
        sd[pre + "wo"] = _t(lay["wo"][i].reshape(-1, d))
        for name in ("ln1", "wi", "wo_ffn", "ln2"):
            sd[pre + name] = _t(lay[name][i])
    return sd


def from_jax_defect_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference defect tree {"encoder", "head"[, "graph"]} -> a
    `DefectModel` state_dict."""
    unknown = set(tree) - {"encoder", "head", "graph"}
    if unknown:
        raise KeyError(f"defect subtrees the port has no module for: {sorted(unknown)}")
    sd = {f"encoder.{k}": v for k, v in from_jax_t5_params(tree["encoder"]).items()}
    sd["head.weight"] = _t(tree["head"]["w"]).T.contiguous()
    sd["head.bias"] = _t(tree["head"]["b"])
    if "graph" in tree:
        sd.update({f"graph.{k}": v for k, v in from_jax_params(tree["graph"]).items()})
    return sd


def from_jax_gen_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference seq2seq tree {"encoder", "decoder"} -> a `T5Seq2Seq`
    state_dict (with `decoder.lm_head` iff the tree has an untied head)."""
    unknown = set(tree) - {"encoder", "decoder"}
    if unknown:
        raise KeyError(f"seq2seq subtrees the port has no module for: {sorted(unknown)}")
    dec = tree["decoder"]
    unknown = set(dec) - {"rel_bias", "layers", "final_ln", "lm_head"}
    if unknown:
        raise KeyError(f"decoder subtrees the port has no module for: {sorted(unknown)}")
    sd = {f"encoder.{k}": v for k, v in from_jax_t5_params(tree["encoder"]).items()}
    for name in ("rel_bias", "final_ln", "lm_head"):
        if name in dec:
            sd[f"decoder.{name}"] = _t(dec[name])
    lay = {k: np.asarray(v, np.float32) for k, v in dec["layers"].items()}
    n_layers, d = lay["wq"].shape[:2]

    def fused(i, names):
        return _t(np.concatenate([lay[w][i].reshape(d, -1) for w in names], axis=1))

    for i in range(n_layers):
        pre = f"decoder.layers.{i}."
        sd[pre + "wqkv"] = fused(i, ("wq", "wk", "wv"))
        sd[pre + "cq"] = fused(i, ("cq",))
        sd[pre + "ckv"] = fused(i, ("ck", "cv"))
        sd[pre + "wo"] = _t(lay["wo"][i].reshape(-1, d))
        sd[pre + "co"] = _t(lay["co"][i].reshape(-1, d))
        for name in ("ln1", "lnc", "wi", "wo_ffn", "ln2"):
            sd[pre + name] = _t(lay[name][i])
    return sd


def from_jax_clone_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference clone tree {"seq2seq", "head"} -> a `CloneModel`
    state_dict (the clone path never uses an LM head: one in the tree is
    dropped, as the reference's `load_seq2seq` drops it)."""
    unknown = set(tree) - {"seq2seq", "head"}
    if unknown:
        raise KeyError(f"clone subtrees the port has no module for: {sorted(unknown)}")
    sd = {f"seq2seq.{k}": v for k, v in from_jax_gen_params(tree["seq2seq"]).items()
          if k != "decoder.lm_head"}
    head = tree["head"]
    sd["dense.weight"] = _t(head["dense_w"]).T.contiguous()
    sd["dense.bias"] = _t(head["dense_b"])
    sd["out.weight"] = _t(head["out_w"]).T.contiguous()
    sd["out.bias"] = _t(head["out_b"])
    return sd
