"""Serving support for the combined families (the model-setup half of the
reference's `deepdfa_tpu/serve/cascade.py`).

- `model_cfg.json` (`save_model_setup`/`load_model_setup`): a run-dir
  manifest holding the tokenizer descriptor and encoder config that a
  combined (DeepDFA+LineVul) or t5 (CodeT5+DeepDFA) checkpoint is
  rebuilt with; `cli train-combined` writes it, `ModelRegistry` reads
  it. Its keys are the reference's, so either package reads the other's
  file.
- `CombinedFrontend`: code -> (token ids, GraphSpec | None), the
  combined families' counterpart of serve/frontend.py's preprocessor.
- `build_combined_service_parts`: the frontend and executor that
  serve/server.py:ScoringService wires for a combined or t5 registry.

The cascade itself (`CascadeStage2`: GGNN stage 1, escalation to the
combined model) is ROADMAP queue A item 4; `serve.cascade=true` is
refused (core/config.py:refuse_unported_serving), and so is a `"bpe"`
tokenizer in a manifest (the port has no BpeTokenizer yet, same item).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np

#: the run-dir manifest that makes a combined or t5 run self-describing
MODEL_CFG_MANIFEST = "model_cfg.json"


def save_model_setup(run_dir: str | Path, family: str, model_cfg: Any,
                     tokenizer_desc: dict, max_length: int) -> Path:
    """Write the manifest a combined or t5 run needs to be restored
    without CLI arguments. `tokenizer_desc` is {"kind": "hash",
    "vocab_size", "t5_frame"}."""
    d = dataclasses.asdict(model_cfg)
    encoder = d.pop("encoder")
    if family == "t5":
        # the reference's DefectConfig fixes the graph encoder's 5 steps
        # and has no field for them
        if d.pop("graph_n_steps") != 5:
            raise ValueError("a t5 manifest holds 5 graph steps (the reference's "
                             "DefectConfig has no graph_n_steps field)")
    doc = {"family": family, "max_length": int(max_length),
           "tokenizer": dict(tokenizer_desc), "encoder": encoder, "model": d}
    path = Path(run_dir) / MODEL_CFG_MANIFEST
    path.write_text(json.dumps(doc, indent=2))
    return path


def _build_tokenizer(desc: dict):
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer

    kind = desc.get("kind", "hash")
    if kind == "hash":
        return HashTokenizer(vocab_size=int(desc.get("vocab_size", 4096)),
                             t5_frame=bool(desc.get("t5_frame", False)))
    if kind == "bpe":
        raise NotImplementedError(
            "a 'bpe' tokenizer in model_cfg.json: the port has no BpeTokenizer yet "
            "(ROADMAP queue A, item 4)")
    raise ValueError(f"unknown tokenizer kind {kind!r} in manifest")


def load_model_setup(run_dir: str | Path, family: str):
    """(tokenizer, model config, max_length) from the run's manifest."""
    from deepdfa_tpu_torch.models import CombinedConfig, DefectConfig, T5Config, TransformerConfig

    path = Path(run_dir) / MODEL_CFG_MANIFEST
    doc = json.loads(path.read_text())
    saved_family = doc.get("family")
    if saved_family != family:
        raise ValueError(f"{path} describes family {saved_family!r}, not {family!r}: the "
                         "run was trained with another arch")
    tok = _build_tokenizer(doc["tokenizer"])
    if family == "t5":
        mcfg = DefectConfig(encoder=T5Config(**doc["encoder"]), **doc["model"])
    else:
        mcfg = CombinedConfig(encoder=TransformerConfig(**doc["encoder"]), **doc["model"])
    return tok, mcfg, int(doc["max_length"])


def try_load_model_setup(run_dir: str | Path, family: str):
    """load_model_setup, or None when the run has no manifest."""
    if not (Path(run_dir) / MODEL_CFG_MANIFEST).exists():
        return None
    return load_model_setup(run_dir, family)


@dataclasses.dataclass(frozen=True)
class TextFeatures:
    """The combined families' counterpart of serve/frontend.py:Features:
    `spec` is the CombinedExecutor payload (token ids, GraphSpec | None)."""

    spec: tuple
    node_lines: None = None


class CombinedFrontend:
    """code -> (token ids, GraphSpec | None), with RequestPreprocessor's
    surface (`features_full`, `features`, `cache`, `stats`).

    For a model trained with use_graph the graph half goes through a
    RequestPreprocessor (the shared cache); a function the graph frontend
    cannot parse degrades to a text-only row (has_graph False), the same
    way alone or batched."""

    def __init__(self, tokenizer, max_length: int, graph_frontend=None):
        from deepdfa_tpu_torch.serve.frontend import FeatureCache

        self.tok = tokenizer
        self.max_length = int(max_length)
        self.graph_frontend = graph_frontend
        self.cache = graph_frontend.cache if graph_frontend is not None else FeatureCache(0)

    def features_full(self, code: str, request_id: int = -1) -> TextFeatures:
        from deepdfa_tpu_torch.serve.frontend import FrontendError

        ids = self.tok.encode(code, max_length=self.max_length)
        spec = None
        if self.graph_frontend is not None:
            try:
                spec = self.graph_frontend.features(code, request_id)
            except FrontendError:
                spec = None  # a text-only row, consistently
        return TextFeatures(spec=(np.asarray(ids, np.int32), spec))

    def features(self, code: str, request_id: int = -1):
        return self.features_full(code, request_id).spec

    def stats(self) -> dict:
        return self.graph_frontend.stats() if self.graph_frontend is not None else {}


def build_combined_service_parts(registry, cfg, node_budget: int, edge_budget: int,
                                 seq_buckets=None):
    """(frontend, executor) for a combined or t5 registry. `seq_buckets`
    (tuned edges) replaces cfg.data.seq_buckets; edges past the run's
    max_length are dropped and max_length stays the top edge. With no
    buckets at all the one edge is max_length."""
    from deepdfa_tpu_torch.serve.batcher import CombinedExecutor
    from deepdfa_tpu_torch.serve.frontend import RequestPreprocessor, shared_cache

    tok = registry.tokenizer
    if tok is None:
        from deepdfa_tpu_torch.serve.registry import RegistryError

        raise RegistryError(
            f"serving family {registry.family!r} needs the run's tokenizer: save a "
            f"{MODEL_CFG_MANIFEST} manifest (train-combined writes one) in "
            f"{registry.run_dir}")
    max_length = int(registry.serve_max_length or 0)
    if seq_buckets and max_length:
        seq_buckets = tuple(int(b) for b in seq_buckets if int(b) < max_length) + (max_length,)
    buckets = tuple(int(b) for b in (seq_buckets or cfg.data.seq_buckets)) or (
        (max_length,) if max_length else ())
    graph_fe = None
    if registry.model_cfg.use_graph:
        graph_fe = RequestPreprocessor(
            cfg, registry.vocabs, cache=shared_cache(cfg.serve.feature_cache_entries))
    frontend = CombinedFrontend(tok, max_length or buckets[-1], graph_frontend=graph_fe)
    executor = CombinedExecutor(
        registry.model, tok, buckets, cfg.data.token_budget, node_budget, edge_budget,
        device=registry.device)
    return frontend, executor
