"""Line-level vulnerability localization (the port of the reference's
`deepdfa_tpu/eval/localize.py`): which lines of a function make it
vulnerable, the paper's second output after the verdict.

Token attributions for the two combined families (the reference's
UniXcoder evaluation ranks lines by captum explanations of the
fine-tuned model, LineVul/unixcoder/linevul_main.py:955-1398), as
`torch.autograd.grad` over an embedding-injected forward:

- `attention`: attention mass each token receives from [CLS], averaged
  over heads and layers (RoBERTa family only);
- `saliency`: |d logit_vuln / d embedding|;
- `input_x_gradient`: gradient x embedding;
- `lig`: integrated gradients along the straight path from the
  reference embedding (pad everywhere, cls/sep kept), a midpoint
  Riemann sum of `n_steps`;
- `deeplift`: the same n-step rescale against the zero baseline;
- `deeplift_shap` / `gradient_shap`: those attributions averaged over
  noisy baselines / noisy path samples.

Each gradient method is summarized captum-tutorial style: summed over
the embedding dim and divided by the L2 norm of the summed row. The
forward is the model's own (`CombinedModel.forward` or
`DefectModel.forward` with `inputs_embeds=rows`), without dropout and
without remat (the reference's `_roberta_forward` scans plain layers), so
on the card each evaluation is the flash forward kernel once a layer and
dq and dk/dv once a layer in the backward.

GGNN node attributions for the flagship family: the same methods (no
sampled ones) against the per-node embedding rows of a packed
`GraphBatch`, each node carrying one source line. `ggnn_score_fn` is the
one attribution program of both drives, the offline one and the served
localizer (serve/localize.py), so the two cannot drift.

Every attribution differentiates with respect to its input rows only:
the model's parameters are set not to require gradients
(`requires_grad_(False)`), so the GGNN backward skips its weight passes
(nn/ggnn_kernel.py:step_bwd) and the T5 bias takes no cotangent (kernel
8 does not launch). A caller that trains the model afterwards turns them
back on.

Known differences from the reference: `deeplift_shap`'s and
`gradient_shap`'s noise comes from a CPU `torch.Generator(seed)`
(`shap_draws`), not from `jax.random`; `token_scores(draws=...)` takes
the reference's draws instead.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch.nn import functional as F

GRADIENT_METHODS = (
    "saliency",
    "input_x_gradient",
    "lig",
    "deeplift",
    "deeplift_shap",
    "gradient_shap",
)
METHODS = ("attention",) + GRADIENT_METHODS

GGNN_METHODS = (
    "attention",
    "saliency",
    "input_x_gradient",
    "deeplift",
    "lig",
)


def _grad_of(fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """rows -> d fn(rows) / d rows, with gradients on whatever the
    caller's mode."""

    def grad(rows: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            rows = rows.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(rows), rows)
        return g

    return grad


# ---------------------------------------------------------------------------
# token attributions (the combined families)


def attention_token_scores(encoder, input_ids: torch.Tensor) -> np.ndarray:
    """[B, T] attention-from-CLS scores of a `RobertaEncoder`, averaged
    over layers and heads: each layer's [CLS] row of softmax(q k^T /
    sqrt(Dh)) over the live keys, in fp32 and plain PyTorch, as the
    reference computes it outside its kernel; the layer then runs as the
    encoder runs it (the flash forward kernel on the card)."""
    cfg = encoder.cfg
    B, T = input_ids.shape
    H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    with torch.inference_mode():
        mask = input_ids != cfg.pad_token_id
        x = encoder.embed(input_ids)
        acc = torch.zeros((B, T), dtype=torch.float32, device=input_ids.device)
        neg = torch.finfo(torch.float32).min
        scale = 1.0 / math.sqrt(Dh)
        for layer in encoder.layers:
            xf = x.float()  # the reference's einsum promotes to the fp32 weights

            def heads(i):
                w, b = layer.wqkv[:, i * D:(i + 1) * D], layer.bqkv[i * D:(i + 1) * D]
                return (xf @ w + b).view(B, T, H, Dh).transpose(1, 2)

            s = (heads(0) @ heads(1).transpose(-1, -2)) * scale
            s = torch.where(mask[:, None, None, :], s, torch.full_like(s, neg))
            acc = acc + torch.softmax(s, dim=-1)[:, :, 0, :].mean(dim=1)
            x = layer(x, mask)
        return (acc / len(encoder.layers)).cpu().numpy()


def _token_forward(arch: str, model, input_ids, graph_batch, has_graph):
    """(fn(rows) -> the summed vuln logit, rows [B, T, D] fp32): the
    model's forward with `rows` in place of the word gather."""
    if arch not in ("roberta", "t5"):
        raise ValueError(f"unknown arch {arch!r} (roberta | t5)")
    model.requires_grad_(False)  # the rows' cotangent alone (the module's docstring)
    word = model.encoder.embeddings.word if arch == "roberta" else model.encoder.word
    rows = F.embedding(input_ids, word)
    graphs = (graph_batch, has_graph) if model.cfg.use_graph else (None, None)

    def fn(rows):
        logits = model(input_ids, *graphs, inputs_embeds=rows, remat=False)
        return logits[:, 1].sum()

    return fn, rows, word


def _summarize(attr: torch.Tensor) -> np.ndarray:
    """captum-tutorial summarization: sum over the embedding dim, L2
    normalized per example."""
    s = attr.sum(dim=-1)
    norm = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    return (s / norm.clamp(min=1e-12)).cpu().numpy()


def _path_attribution(grad, rows, base, steps: int):
    """n-step rescale: the midpoint Riemann sum of grads along the
    straight baseline->input path, times delta (lig, deeplift,
    deeplift_shap). Exact at any step count for a linear target;
    elsewhere it converges to the path integral, whose sum is f(input) -
    f(baseline) (completeness)."""
    delta = rows - base
    acc = torch.zeros_like(rows)
    for k in range(steps):
        alpha = (k + 0.5) / steps
        acc = acc + grad(base + alpha * delta)
    return delta * acc / steps


def _lig_baseline_rows(word, input_ids, pad_id: int, cls_id: int, sep_id: int):
    """The reference's create_ref_input_ids: pad everywhere, cls/sep kept."""
    keep = (input_ids == cls_id) | (input_ids == sep_id)
    return F.embedding(torch.where(keep, input_ids, torch.full_like(input_ids, pad_id)), word)


def shap_draws(shape: Sequence[int], n_samples: int, seed: int = 0
               ) -> list[tuple[float, torch.Tensor]]:
    """The sampled methods' noise, from a CPU `torch.Generator(seed)` (so
    the card and the CPU see the same draws): per sample (alpha, eps),
    alpha uniform in [0, 1) (gradient_shap's path point) and eps a
    standard normal of `shape` in fp32 (both methods scale it by 0.01)."""
    gen = torch.Generator().manual_seed(seed)
    return [(float(torch.rand((), generator=gen)), torch.randn(tuple(shape), generator=gen))
            for _ in range(n_samples)]


def token_scores(
    method: str,
    arch: str,
    model,
    input_ids: torch.Tensor,
    graph_batch=None,
    has_graph=None,
    *,
    n_steps: int = 20,
    n_samples: int = 8,
    seed: int = 0,
    draws: Sequence[tuple[float, torch.Tensor]] | None = None,
) -> np.ndarray:
    """[B, T] token attribution scores for the vulnerable-class logit of
    a `CombinedModel` (`arch="roberta"`) or a `DefectModel` (`"t5"`) on
    the device of its inputs. `draws` (deeplift_shap, gradient_shap)
    replaces `shap_draws(rows.shape, n_samples, seed)`."""
    if method == "attention":
        if arch != "roberta":
            raise ValueError(
                "the attention method reads RoBERTa-shaped encoder layers; "
                "use a gradient method for --arch t5"
            )
        return attention_token_scores(model.encoder, input_ids)
    if method not in GRADIENT_METHODS:
        raise ValueError(f"unknown method {method!r} (choose from {METHODS})")

    fn, rows, word = _token_forward(arch, model, input_ids, graph_batch, has_graph)
    grad = _grad_of(fn)
    if method == "saliency":
        return _summarize(grad(rows).abs())
    if method == "input_x_gradient":
        return _summarize(grad(rows) * rows)

    ecfg = model.cfg.encoder
    if method == "lig":
        cls_id, sep_id = (0, 2) if arch == "roberta" else (ecfg.eos_token_id,) * 2
        base = _lig_baseline_rows(word, input_ids, ecfg.pad_token_id, cls_id, sep_id)
        return _summarize(_path_attribution(grad, rows, base, n_steps))
    if method == "deeplift":
        return _summarize(_path_attribution(grad, rows, torch.zeros_like(rows), n_steps))

    if draws is None:
        draws = shap_draws(rows.shape, n_samples, seed)
    acc = torch.zeros_like(rows)
    if method == "deeplift_shap":
        # the rescale against noisy zero-mean baselines, at a quarter of
        # the steps each (about n_samples * n_steps / 4 evaluations)
        inner = max(2, n_steps // 4)
        for _, eps in draws:
            acc = acc + _path_attribution(grad, rows, 0.01 * eps.to(rows.device), inner)
        return _summarize(acc / len(draws))
    # gradient_shap: the expected gradient at noisy points of the path
    # from the zero baseline
    for alpha, eps in draws:
        acc = acc + grad(alpha * (rows + 0.01 * eps.to(rows.device)))
    return _summarize((acc / len(draws)) * rows)


def combined_saliency_scores(model, input_ids, graph_batch=None, has_graph=None) -> np.ndarray:
    """[B, T] |gradient x input| token norms of a `CombinedModel` (kept
    for the reference's API; the general entry point is `token_scores`)."""
    fn, rows, _ = _token_forward("roberta", model, input_ids, graph_batch, has_graph)
    return torch.linalg.vector_norm(_grad_of(fn)(rows) * rows, dim=-1).cpu().numpy()


# ---------------------------------------------------------------------------
# GGNN node attributions (the flagship family)


def ggnn_forward(model, batch):
    """(fn(rows) -> ([G] vuln logits, [N] pooling attention), rows [N,
    D]): the graph-level `DeepDFA` recomposed from its own submodules
    (`embedding`, `ggnn`, `pooling`, `head`) with the node embedding rows
    as the input, the readout through `nn/gnn.py:attention_pool`, which
    also returns the attention. The GGNN keeps every kernel knob of the
    model. The logits are the bits of `model(batch)`."""
    from deepdfa_tpu_torch.nn.gnn import attention_pool

    if model.label_style != "graph":
        raise ValueError(
            f"GGNN localization attributes the graph-level logit; "
            f"label_style={model.label_style!r} has no single logit to "
            f"attribute"
        )
    model.requires_grad_(False)  # the rows' cotangent alone (the module's docstring)
    with torch.no_grad():
        rows = model.embedding(batch.node_feats)

    def fn(rows):
        out = torch.cat([model.ggnn(batch, rows), rows], dim=-1)
        gate = model.pooling.gate_nn(out)[:, 0]
        pooled, attn = attention_pool(gate, out, batch.node_graph, batch.node_mask,
                                      batch.num_graphs)
        return model.head(pooled)[..., 0], attn

    return fn, rows


def _summarize_nodes(attr: torch.Tensor, batch) -> torch.Tensor:
    """[N, D] node attributions -> [N] scores: summed over the embedding
    dim and L2-normalized within each graph (`_summarize` per graph);
    padding slots are zero. The per-graph sums are one-hot products."""
    s = attr.sum(dim=-1)
    s = torch.where(batch.node_mask, s, torch.zeros_like(s))
    segments = torch.arange(batch.num_graphs + 1, device=s.device)
    onehot = (batch.node_graph[None, :] == segments[:, None]).to(s.dtype)
    norm = torch.sqrt(onehot @ (s * s))
    return s / norm[batch.node_graph.long()].clamp(min=1e-12)


def ggnn_score_fn(method: str, model, n_steps: int = 8) -> Callable:
    """run(batch) -> (probs [G], node_scores [N]) on the batch's device,
    for a graph-level `DeepDFA`:

    - `attention`: the pooling readout's attention, without gradients;
    - `saliency` / `input_x_gradient`: the vuln logit's gradient with
      respect to the node embedding rows (one evaluation, which also
      gives the probabilities);
    - `deeplift`: the n-step rescale against the zero baseline;
    - `lig`: integrated gradients against the embedding of all-zero
      node features (vocabulary index 0 of every table, "not a
      definition").

    The path methods take the probabilities from one forward without
    gradients, then `n_steps` evaluations. Graphs share nothing, so a
    node's score depends on its neighbours in the batch only through
    fp32 reduction order; at a fixed batch shape the run gives the same
    bits every time (the served and the offline drives agree)."""
    if method not in GGNN_METHODS:
        raise ValueError(
            f"unknown GGNN method {method!r} (choose from {GGNN_METHODS})"
        )

    def run(batch):
        fn, rows = ggnn_forward(model, batch)
        if method == "attention":
            with torch.inference_mode():
                logits, attn = fn(rows)
                return torch.sigmoid(logits), torch.where(batch.node_mask, attn,
                                                          torch.zeros_like(attn))
        if method in ("saliency", "input_x_gradient"):
            with torch.enable_grad():
                r = rows.detach().requires_grad_(True)
                logits, _ = fn(r)
                (g,) = torch.autograd.grad(logits.sum(), r)
            probs = torch.sigmoid(logits.detach())
            attr = g.abs() if method == "saliency" else g * rows
        else:
            with torch.inference_mode():
                probs = torch.sigmoid(fn(rows)[0])
            if method == "deeplift":
                base = torch.zeros_like(rows)
            else:  # lig
                with torch.no_grad():
                    base = model.embedding(torch.zeros_like(batch.node_feats))
            attr = _path_attribution(_grad_of(lambda r: fn(r)[0].sum()), rows, base, n_steps)
        return probs, _summarize_nodes(attr, batch)

    return run


# ---------------------------------------------------------------------------
# from scores to lines


def node_line_attributions(node_scores, node_lines, top_k: int = 0) -> list[dict]:
    """[n] per-node scores + [n] 1-based source lines (the function's own
    coordinates) -> ranked [{"line", "score"}], max-reduced per line,
    truncated to `top_k` when > 0. No rounding: the served payload is
    the offline one to the bit."""
    by_line: dict[int, float] = {}
    for s, ln in zip(np.asarray(node_scores), np.asarray(node_lines)):
        ln = int(ln)
        if ln < 1:
            continue
        s = float(s)
        if ln not in by_line or s > by_line[ln]:
            by_line[ln] = s
    ranked = sorted(by_line.items(), key=lambda kv: (-kv[1], kv[0]))
    if top_k:
        ranked = ranked[:top_k]
    return [{"line": ln, "score": s} for ln, s in ranked]


def aggregate_line_scores(
    token_scores: np.ndarray,
    token_lines: np.ndarray,
    n_lines: int,
    reduce: str = "max",
) -> np.ndarray:
    """[T] token scores + [T] 1-based line ids (0 = no line) -> [n_lines].

    Scores may be signed (lig, deeplift, ...): each line max- or
    sum-reduces its own tokens (no zero clamp), and a line without tokens
    ranks strictly below every tokenized one (the reference scores only
    tokenized lines, get_all_lines_score)."""
    out = np.full((n_lines,), -np.inf)
    for s, ln in zip(np.asarray(token_scores), np.asarray(token_lines)):
        if 1 <= ln <= n_lines:
            i = int(ln) - 1
            if reduce == "max":
                out[i] = max(out[i], float(s))
            else:
                out[i] = float(s) if np.isinf(out[i]) else out[i] + float(s)
    present = np.isfinite(out)
    floor = (out[present].min() - 1.0) if present.any() else 0.0
    out[~present] = floor
    return out
