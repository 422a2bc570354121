"""Reference parameter trees -> the port's `state_dict`s.

`from_jax_params`: the Flax DeepDFA variables, `{"params": {...}}` (or
the bare params dict) with numpy arrays as leaves, the dataflow styles'
`bitprop` gate included. A bfloat16 leaf (an `ml_dtypes.bfloat16`
array) becomes a `torch.bfloat16` tensor of the same bits, any other
leaf fp32. Embedding tables and
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

`hf_roberta_tree` / `hf_t5_tree` / `hf_gen_tree`: a Hugging Face torch
`state_dict` (`RobertaModel` with a `'roberta.'` prefix or none;
`T5EncoderModel` / `T5Model`; `T5ForConditionalGeneration`) -> the
reference's parameter tree as numpy fp32 arrays, by the reference's own
key map (`params_from_hf_torch` of its `models/transformer.py` and
`models/t5.py`, `gen_params_from_hf_torch` of `models/t5_gen.py`). The
models' `params_from_hf_torch` / `gen_params_from_hf_torch` feed these
trees to the `from_jax_*` functions above.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    """A leaf as a tensor: bfloat16 bit for bit (read as its raw 16
    bits, so ml_dtypes is never imported), anything else fp32."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        raw = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    p = tree["params"] if "params" in tree else tree
    unknown = set(p) - {"embedding", "ggnn", "pooling", "bitprop", "head"}
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
    if "bitprop" in p:
        gate = p["bitprop"]["kill_gate"]
        sd["bitprop.kill_gate.weight"] = _t(gate["kernel"]).T.contiguous()
        sd["bitprop.kill_gate.bias"] = _t(gate["bias"])
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
    """The reference combined tree {"encoder", "head"[, "graph", "moe"]}
    -> a `CombinedModel` state_dict; the MoE leaves keep their layout."""
    unknown = set(tree) - {"encoder", "head", "graph", "moe"}
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
    if "moe" in tree:
        sd.update({f"moe.{k}": _t(tree["moe"][k]) for k in ("router", "w1", "b1", "w2", "b2")})
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


def _hf_getter(state_dict, prefixes):
    def get(name):
        for prefix in prefixes:
            k = prefix + name
            if k in state_dict:
                v = state_dict[k]
                v = v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else v
                return np.asarray(v, np.float32)
        raise KeyError(name)
    return get


def _stack(n_layers: int, fn) -> np.ndarray:
    return np.stack([fn(i) for i in range(n_layers)])


def hf_roberta_tree(cfg, state_dict) -> dict:
    """A HF `RobertaModel` state_dict -> the reference's encoder tree
    {"embeddings", "layers", "pooler"} (a zero pooler when the state dict
    has none). `cfg` is a TransformerConfig."""
    get = _hf_getter(state_dict, ("", "roberta."))
    D, H, Dh, L = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.num_layers
    emb = {
        "word": get("embeddings.word_embeddings.weight"),
        "position": get("embeddings.position_embeddings.weight"),
        "token_type": get("embeddings.token_type_embeddings.weight"),
        "ln_scale": get("embeddings.LayerNorm.weight"),
        "ln_bias": get("embeddings.LayerNorm.bias"),
    }

    def layer(name):
        return lambda i: get(f"encoder.layer.{i}.{name}")

    def heads_in(name):  # torch Linear [out, in] -> [in, H, Dh]
        return lambda i: layer(name)(i).T.reshape(D, H, Dh)

    layers = {
        "wq": _stack(L, heads_in("attention.self.query.weight")),
        "bq": _stack(L, lambda i: layer("attention.self.query.bias")(i).reshape(H, Dh)),
        "wk": _stack(L, heads_in("attention.self.key.weight")),
        "bk": _stack(L, lambda i: layer("attention.self.key.bias")(i).reshape(H, Dh)),
        "wv": _stack(L, heads_in("attention.self.value.weight")),
        "bv": _stack(L, lambda i: layer("attention.self.value.bias")(i).reshape(H, Dh)),
        "wo": _stack(L, lambda i: layer("attention.output.dense.weight")(i).T.reshape(H, Dh, D)),
        "bo": _stack(L, layer("attention.output.dense.bias")),
        "ln1_scale": _stack(L, layer("attention.output.LayerNorm.weight")),
        "ln1_bias": _stack(L, layer("attention.output.LayerNorm.bias")),
        "w1": _stack(L, lambda i: layer("intermediate.dense.weight")(i).T),
        "b1": _stack(L, layer("intermediate.dense.bias")),
        "w2": _stack(L, lambda i: layer("output.dense.weight")(i).T),
        "b2": _stack(L, layer("output.dense.bias")),
        "ln2_scale": _stack(L, layer("output.LayerNorm.weight")),
        "ln2_bias": _stack(L, layer("output.LayerNorm.bias")),
    }
    try:
        pooler = {"w": get("pooler.dense.weight").T, "b": get("pooler.dense.bias")}
    except KeyError:
        pooler = {"w": np.zeros((D, D), np.float32), "b": np.zeros((D,), np.float32)}
    return {"embeddings": emb, "layers": layers, "pooler": pooler}


def _t5_attention(blk, L, D, H, Dh, prefix: str, names=("q", "k", "v", "o")) -> dict:
    out = {}
    for w, n in zip(("wq", "wk", "wv"), names[:3]):
        out[w] = _stack(L, lambda i, n=n: blk(i, f"{prefix}.{n}.weight").T.reshape(D, H, Dh))
    out["wo"] = _stack(L, lambda i: blk(i, f"{prefix}.{names[3]}.weight").T.reshape(H, Dh, D))
    return out


def hf_t5_tree(cfg, state_dict) -> dict:
    """A HF `T5EncoderModel` / `T5Model` state_dict (keys bare, under
    `encoder.` or `transformer.`) -> the reference's T5 encoder tree
    {"word", "rel_bias", "layers", "final_ln"}. `cfg` is a T5Config."""
    get = _hf_getter(state_dict, ("", "encoder.", "transformer."))
    D, H, Dh, L = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.num_layers

    def blk(i, name):
        return get(f"block.{i}.layer.{name}")

    try:
        word = get("shared.weight")
    except KeyError:
        word = get("embed_tokens.weight")
    layers = _t5_attention(blk, L, D, H, Dh, "0.SelfAttention")
    layers.update(
        ln1=_stack(L, lambda i: blk(i, "0.layer_norm.weight")),
        wi=_stack(L, lambda i: blk(i, "1.DenseReluDense.wi.weight").T),
        wo_ffn=_stack(L, lambda i: blk(i, "1.DenseReluDense.wo.weight").T),
        ln2=_stack(L, lambda i: blk(i, "1.layer_norm.weight")),
    )
    return {"word": word,
            "rel_bias": get("block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
            "layers": layers, "final_ln": get("final_layer_norm.weight")}


def hf_gen_tree(cfg, state_dict) -> dict:
    """A HF `T5ForConditionalGeneration` state_dict -> the reference's
    seq2seq tree {"encoder", "decoder"}; an `lm_head` that differs from
    the shared embedding (an untied checkpoint) is kept as the decoder's
    `lm_head`. `cfg` is a GenConfig."""
    ecfg = cfg.encoder
    get = _hf_getter(state_dict, ("",))
    D, H, Dh, L = ecfg.hidden_size, ecfg.num_heads, ecfg.head_dim, cfg.n_dec_layers

    def blk(i, name):
        return get(f"decoder.block.{i}.layer.{name}")

    enc_sd = {k[len("encoder."):]: v for k, v in state_dict.items() if k.startswith("encoder.")}
    enc_sd["shared.weight"] = state_dict["shared.weight"]
    layers = _t5_attention(blk, L, D, H, Dh, "0.SelfAttention")
    cross = _t5_attention(blk, L, D, H, Dh, "1.EncDecAttention")
    layers.update(
        ln1=_stack(L, lambda i: blk(i, "0.layer_norm.weight")),
        cq=cross["wq"], ck=cross["wk"], cv=cross["wv"], co=cross["wo"],
        lnc=_stack(L, lambda i: blk(i, "1.layer_norm.weight")),
        wi=_stack(L, lambda i: blk(i, "2.DenseReluDense.wi.weight").T),
        wo_ffn=_stack(L, lambda i: blk(i, "2.DenseReluDense.wo.weight").T),
        ln2=_stack(L, lambda i: blk(i, "2.layer_norm.weight")),
    )
    decoder = {
        "rel_bias": get("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "layers": layers,
        "final_ln": get("decoder.final_layer_norm.weight"),
    }
    if "lm_head.weight" in state_dict:
        head = get("lm_head.weight")
        if not np.array_equal(head, get("shared.weight")):
            decoder["lm_head"] = head
    return {"encoder": hf_t5_tree(ecfg, enc_sd), "decoder": decoder}
