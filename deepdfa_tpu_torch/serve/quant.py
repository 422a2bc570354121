"""Post-training int8 quantization for served entries (the port's
counterpart of the reference's `deepdfa_tpu/serve/quant.py`).

A registry checkpoint tag with the `@int8` suffix (`serve.checkpoint=
best@int8`, or a cascade's stage-2 tag) restores the fp32 weights and
rewrites the module's state dict:

- **matmul weights** (the reference's float leaves with ndim >= 2:
  kernels, embeddings, attention projections and its stacked per-layer
  vectors) become per-channel SYMMETRIC int8: one fp32 scale per output
  channel, values rounded into [-127, 127]; dequantizing is one multiply;
- **every other float** (biases, norms, the GRU's vectors) becomes bf16;
- **a bfloat16 tensor** (a `model.param_dtype=bfloat16` checkpoint) stays
  as it is, neither quantized nor counted: the reference's float test
  (`_is_float`, numpy's `np.floating`) does not take ml_dtypes'
  bfloat16, so its `@int8` entry of such a checkpoint holds the bf16
  weights, and serving upcasts them to fp32 (its `dequantize_params`).

The port's state dicts are laid out otherwise than the reference's
parameter trees (`models/convert.py`): an `nn.Linear` weight is [out,
in], so its channel is dim 0 where the reference's [in, out] kernel has
it last; the per-etype kernels are stacked into one [T, d, d] tensor;
q, k and v are fused per layer into one [D, 3·H·Dh] kernel where the
reference stacks each over the layers as [L, D, H, Dh], and its
per-layer vectors ([L, D]) are 2-D there and so quantized. `quantize_
params` therefore quantizes each port tensor along the reference
leaf's output channel, its scale reduced over everything the
reference's leaf holds (all layers, all heads), so the int8 values and
the scales are the reference's own moved into the port's layout
(`_RULES`; tests/test_torch_quant.py holds them equal through convert).

Execution stays fp32: the quantized tree is what lives on the card, and
every dispatch dequantizes it (`QuantizedModel`: `dequantize_params`,
then the module's forward through `torch.func.functional_call`), as the
reference dequantizes inside its compiled program; the kernels run on
the dequantized weights as on an fp32 entry.

The drift contract: an `@int8` entry is admitted at registry load only
if the largest probability drift against the fp32 weights over a
deterministic calibration batch stays within `serve.quant_drift_bound`
(default 5e-2); past it the entry is refused loudly, naming the tensors
with the worst quantization error.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch

#: the registry tag suffix that requests a quantized entry
QUANT_SUFFIX = "@int8"

#: quantized-leaf marker keys (a dict with exactly these keys is one
#: quantized tensor)
_QKEYS = frozenset({"int8", "scale"})


class QuantizationError(RuntimeError):
    """Quantization refused: drift past the configured bound. Carries
    the measured drift, the bound and the offending tensors (worst
    quantization error first)."""

    def __init__(self, drift: float, bound: float, worst_paths: list[str]):
        self.drift = float(drift)
        self.bound = float(bound)
        self.worst_paths = list(worst_paths)
        super().__init__(
            f"int8 quantization refused: calibration prob drift "
            f"{drift:.3e} exceeds serve.quant_drift_bound={bound:g}; "
            f"worst-quantized params: {', '.join(worst_paths[:8])}"
            + ("..." if len(worst_paths) > 8 else "")
            + " (raise the bound, or serve the fp32 entry)"
        )


def split_checkpoint_tag(tag: str) -> tuple[str, str | None]:
    """`"best@int8"` -> ("best", "int8"); plain tags -> (tag, None)."""
    if tag.endswith(QUANT_SUFFIX):
        return tag[: -len(QUANT_SUFFIX)], "int8"
    return tag, None


def is_quantized_leaf(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node.keys()) == set(_QKEYS)


def _scale_of(absmax: np.ndarray) -> np.ndarray:
    scale = (absmax / 127.0).astype(np.float32)
    return np.where(scale > 0, scale, np.float32(1.0))


def _quantize_with(w: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(w / scale), -127, 127).astype(np.int8)


def quantize_leaf(w: np.ndarray) -> dict:
    """One weight -> per-channel symmetric int8 over its LAST axis (the
    reference's rule for a leaf laid out as the reference's)."""
    w = np.asarray(w, dtype=np.float32)
    scale = _scale_of(np.max(np.abs(w), axis=tuple(range(w.ndim - 1))))
    return {"int8": _quantize_with(w, scale), "scale": scale}


# -- where each port tensor keeps the reference leaf's output channel ---------
#
# kinds: "last" (the channel is the last axis, the layout is the
# reference's), "first" (an nn.Linear weight: the channel is dim 0),
# "etype" (the GGNN's [T, d, d] per-etype kernels: T leaves, each over
# its last axis), "heads" (a fused [.., 3·H·Dh] q/k/v tensor: three
# leaves whose channel is Dh, reduced over the heads), "bf16" (the
# reference's leaf is 1-D). Tensors under `layers.<i>.` share the scale
# of their stacked reference leaf across every layer.

_GGNN_RULES = (
    (r"embedding\.[^.]+\.weight", "last"),
    (r"ggnn\.etype_kernel", "etype"),
    (r"ggnn\.etype_bias", "bf16"),
    (r"ggnn\.gru\.(input|hidden)_kernel", "last"),
    (r"ggnn\.gru\.(input|hidden)_bias", "bf16"),
    (r"(pooling\.gate_nn|head\.[^.]+)\.weight", "first"),
    (r"(pooling\.gate_nn|head\.[^.]+)\.bias", "bf16"),
)
_ROBERTA_RULES = (
    (r"encoder\.embeddings\.(word|position|token_type)", "last"),
    (r"encoder\.embeddings\.ln_(scale|bias)", "bf16"),
    (r"encoder\.layers\.\d+\.[wb]qkv", "heads"),
    (r"encoder\.layers\.\d+\.(wo|bo|ln1_scale|ln1_bias|w1|b1|w2|b2|ln2_scale|ln2_bias)",
     "last"),
    (r"encoder\.pooler_w", "last"),
    (r"encoder\.pooler_b", "bf16"),
    (r"head_(dense|out)\.weight", "first"),
    (r"head_(dense|out)\.bias", "bf16"),
    (r"moe\.(router|w1|b1|w2|b2)", "last"),
)
_T5_RULES = (
    (r"encoder\.(word|rel_bias)", "last"),
    (r"encoder\.final_ln", "bf16"),
    (r"encoder\.layers\.\d+\.wqkv", "heads"),
    (r"encoder\.layers\.\d+\.(wo|ln1|wi|wo_ffn|ln2)", "last"),
    (r"head\.weight", "first"),
    (r"head\.bias", "bf16"),
)


def _rules_for(keys) -> tuple:
    """The rule table of a state dict's family: the GGNN alone, or a
    RoBERTa or T5 encoder with its head and a `graph.` GGNN branch."""
    if "encoder.word" in keys:
        encoder = _T5_RULES
    elif "encoder.embeddings.word" in keys:
        encoder = _ROBERTA_RULES
    else:
        return _GGNN_RULES
    return encoder + tuple((r"graph\." + pat, kind) for pat, kind in _GGNN_RULES)


def _kind(key: str, rules) -> str:
    for pat, kind in rules:
        if re.fullmatch(pat, key):
            return kind
    raise KeyError(f"no quantization rule for state dict key {key!r}")


def _group(key: str) -> str:
    return re.sub(r"(^|\.)layers\.\d+\.", r"\1layers.*.", key)


def _channel_absmax(kind: str, w: np.ndarray, heads: int | None) -> np.ndarray:
    a = np.abs(w)
    if kind == "last":
        return np.max(a.reshape(-1, w.shape[-1]), axis=0)
    if kind == "first":
        return np.max(a.reshape(w.shape[0], -1), axis=1)
    if kind == "etype":
        return np.max(a, axis=1)
    # heads: [.., 3·H·Dh] -> [-1, 3, H, Dh], reduced to [3, Dh]
    return np.max(a.reshape(-1, 3, heads, w.shape[-1] // (3 * heads)), axis=(0, 2))


def _broadcast_scale(kind: str, scale: np.ndarray, w: np.ndarray, heads: int | None):
    if kind == "last":
        return scale
    if kind == "first":
        return scale.reshape((-1,) + (1,) * (w.ndim - 1))
    if kind == "etype":
        return scale[:, None, :]
    return np.repeat(scale[:, None, :], heads, axis=1).reshape(-1)


def quantize_params(params: Mapping[str, torch.Tensor], num_heads: int | None = None) -> dict:
    """A served module's fp32 state dict -> the int8/bf16 serving tree on
    the host, keyed as the state dict: {"int8": int8, "scale": fp32
    broadcastable to the tensor} per quantized tensor, a bf16 tensor per
    other float, anything else as it is. `num_heads` is the encoder's
    head count, needed for a RoBERTa state dict's fused q/k/v (a T5
    one's is read off its relative bias)."""
    host = {k: v.detach().cpu() for k, v in params.items()}
    rules = _rules_for(host)
    if "encoder.rel_bias" in host:
        num_heads = int(host["encoder.rel_bias"].shape[1])
    floats = {k: v.float().numpy() for k, v in host.items()
              if v.is_floating_point() and v.dtype != torch.bfloat16}
    kinds = {k: _kind(k, rules) for k in floats}
    if num_heads is None and "heads" in kinds.values():
        raise ValueError("quantize_params needs num_heads for the fused q/k/v tensors")
    absmax: dict[str, np.ndarray] = {}
    for k, w in floats.items():
        if kinds[k] != "bf16":
            m = _channel_absmax(kinds[k], w, num_heads)
            g = _group(k)
            absmax[g] = m if g not in absmax else np.maximum(absmax[g], m)
    out: dict[str, Any] = {}
    for k, v in host.items():
        if k not in floats:
            out[k] = v
        elif kinds[k] == "bf16":
            out[k] = v.to(torch.bfloat16)
        else:
            w = floats[k]
            scale = _broadcast_scale(kinds[k], _scale_of(absmax[_group(k)]), w, num_heads)
            out[k] = {"int8": torch.from_numpy(_quantize_with(w, scale)),
                      "scale": torch.from_numpy(np.ascontiguousarray(scale))}
    return out


def dequantize_params(qtree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The serving tree -> fp32 tensors on the tree's device: int8
    weights times their scales, bf16 tensors upcast."""
    out = {}
    for k, v in qtree.items():
        if is_quantized_leaf(v):
            out[k] = v["int8"].float() * v["scale"]
        elif v.is_floating_point() and v.dtype != torch.float32:
            out[k] = v.float()
        else:
            out[k] = v
    return out


def tree_to(qtree: Mapping[str, Any], device) -> dict:
    """The serving tree with every tensor on `device`."""
    return {k: ({q: t.to(device) for q, t in v.items()} if is_quantized_leaf(v)
                else v.to(device)) for k, v in qtree.items()}


def _leaves(tree: Mapping[str, Any]):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from v.values()
        else:
            yield v


def tree_bytes(tree: Mapping[str, Any]) -> float:
    """Total tensor bytes of a state dict or a serving tree."""
    return float(sum(t.numel() * t.element_size() for t in _leaves(tree)))


@dataclasses.dataclass(frozen=True)
class QuantReport:
    """What quantization did to one state dict (the /healthz and refusal
    payload): byte totals and the per-tensor reconstruction error."""

    bytes_fp32: float
    bytes_quant: float
    path_errors: dict[str, float]  # key -> max |w - dequant(w)|

    @property
    def bytes_fraction(self) -> float:
        return self.bytes_quant / self.bytes_fp32 if self.bytes_fp32 else 1.0

    def worst_paths(self) -> list[str]:
        return [p for p, _ in sorted(self.path_errors.items(), key=lambda kv: -kv[1])]


def quant_report(params: Mapping[str, torch.Tensor], qtree: Mapping[str, Any]) -> QuantReport:
    errors: dict[str, float] = {}
    for k, node in qtree.items():
        if not is_quantized_leaf(node):
            continue
        w = params[k].detach().cpu().float().numpy()
        deq = node["int8"].cpu().numpy().astype(np.float32) * node["scale"].cpu().numpy()
        errors[k] = float(np.max(np.abs(w - deq))) if w.size else 0.0
    return QuantReport(bytes_fp32=tree_bytes(params), bytes_quant=tree_bytes(qtree),
                       path_errors=errors)


# -- serving a quantized tree --------------------------------------------------


class _Apply(torch.nn.Module):
    """`fn(module, *args)` as a module call, so functional_call can swap
    the wrapped module's weights for the duration of `fn`."""

    def __init__(self, module: torch.nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


class QuantizedModel(torch.nn.Module):
    """A served module whose weights are a quantized tree on the device.

    `module` is kept as a skeleton on the meta device (no weights of its
    own); every call dequantizes `qtree` and runs the skeleton's forward
    on the fp32 result through `torch.func.functional_call`, and `run(fn,
    *args)` does the same for `fn(module, *args)` (the localizer's
    attribution program). A call swaps the skeleton's weights while it
    runs, so calls are serialized by a lock; the device work each
    launches stays asynchronous. The config attributes the executors
    read (`cfg`, `label_style`) are the module's."""

    def __init__(self, module: torch.nn.Module, qtree: Mapping[str, Any]):
        super().__init__()
        for name in ("cfg", "label_style"):
            if hasattr(module, name):
                setattr(self, name, getattr(module, name))
        self.skeleton = module.eval().to("meta")
        self.qtree = dict(qtree)
        self._call_lock = threading.Lock()

    def forward(self, *args, **kwargs):
        weights = dequantize_params(self.qtree)
        with self._call_lock:
            return torch.func.functional_call(self.skeleton, weights, args, kwargs)

    def run(self, fn: Callable, *args):
        weights = {f"module.{k}": v for k, v in dequantize_params(self.qtree).items()}
        with self._call_lock:
            return torch.func.functional_call(_Apply(self.skeleton, fn), weights, args)


def run_served(model: torch.nn.Module, fn: Callable, *args):
    """`fn(model, *args)` on a served model: through the dequantized
    weights when it is a `QuantizedModel`."""
    if isinstance(model, QuantizedModel):
        return model.run(fn, *args)
    return fn(model, *args)


# -- calibration (the drift contract's measurement half) ----------------------


def calibration_graph_batch(
    size: int,
    node_budget: int,
    edge_budget: int,
    feat_width: int,
    input_dim: int,
    etypes: bool = False,
    n_etypes: int = 1,
    seed: int = 0,
):
    """A deterministic random-feature packed GraphBatch (the reference's,
    array for array, at 4 columns): real rows, so every weight the
    quantizer touched contributes to the measured drift. Columns past the
    four subkeys (a struct_feats model's) are taken modulo their channel's
    vocabulary, which the reference's draw over [0, input_dim) overruns."""
    from deepdfa_tpu_torch.frontend.structfeat import STRUCT_VOCAB
    from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, GraphSpec, pack

    rng = np.random.default_rng(seed)
    specs = []
    for g in range(size):
        n = int(rng.integers(4, 12))
        # a chain + a few random extra edges: connected, varied degrees
        src = list(range(n - 1)) + list(rng.integers(0, n, size=3))
        dst = list(range(1, n)) + list(rng.integers(0, n, size=3))
        feats = rng.integers(0, input_dim, size=(n, feat_width)).astype(np.int32)
        feats[:, NUM_SUBKEY_FEATS:] %= np.asarray(
            STRUCT_VOCAB[:feat_width - NUM_SUBKEY_FEATS], np.int32)
        specs.append(GraphSpec(
            graph_id=g,
            node_feats=feats,
            node_vuln=np.zeros(n, np.int32),
            edge_src=np.asarray(src, np.int32),
            edge_dst=np.asarray(dst, np.int32),
            label=float(g % 2),
            edge_type=(rng.integers(0, n_etypes, size=len(src)).astype(np.int32)
                       if etypes else None),
        ))
    return pack(specs, size, node_budget, edge_budget, feat_width=feat_width, etypes=etypes)


def calibration_text_batch(
    rows: int,
    seq_len: int,
    vocab_size: int,
    pad_id: int,
    node_budget: int,
    edge_budget: int,
    seed: int = 0,
):
    """Deterministic random token rows collated with empty graph slots
    (the reference's, array for array): the combined and t5 families'
    calibration input."""
    from deepdfa_tpu_torch.data.text import collate

    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab_size, size=(rows, seq_len)).astype(np.int32)
    # realistic ragged lengths: pad the tail of each row
    for r in range(rows):
        ln = int(rng.integers(max(4, seq_len // 4), seq_len + 1))
        ids[r, ln:] = pad_id
    return collate(ids, [0] * rows, list(range(rows)), {}, batch_rows=rows,
                   node_budget=node_budget, edge_budget=edge_budget, pad_id=pad_id)


def max_prob_drift(
    score_fn: Callable[[Mapping[str, torch.Tensor], Any], torch.Tensor],
    params_fp32: Mapping[str, torch.Tensor],
    qtree: Mapping[str, Any],
    batches: list,
) -> float:
    """max |P_quant - P_fp32| over the calibration batches. `score_fn`
    takes (fp32 state dict, batch) -> probabilities; the quantized side
    dequantizes first, as the served entry does."""
    drift = 0.0
    deq = dequantize_params(qtree)
    for batch in batches:
        with torch.inference_mode():
            p_ref = score_fn(params_fp32, batch).float().cpu().numpy()
            p_q = score_fn(deq, batch).float().cpu().numpy()
        if p_ref.size:
            drift = max(drift, float(np.max(np.abs(p_ref - p_q))))
    return drift


def check_drift(
    score_fn: Callable[[Mapping[str, torch.Tensor], Any], torch.Tensor],
    params_fp32: Mapping[str, torch.Tensor],
    qtree: Mapping[str, Any],
    batches: list,
    bound: float,
) -> float:
    """The admission check: the measured drift, or QuantizationError
    naming the worst-quantized tensors."""
    drift = max_prob_drift(score_fn, params_fp32, qtree, batches)
    if drift > float(bound):
        raise QuantizationError(drift, bound, quant_report(params_fp32, qtree).worst_paths())
    return drift
