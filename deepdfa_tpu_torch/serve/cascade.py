"""Two-stage cascaded inference and the serving support of the combined
families (the port of the reference's `deepdfa_tpu/serve/cascade.py`).

The paper's economics on the serve path: the GGNN is cheap enough to
score every request, and the combined (DeepDFA+LineVul) or t5
(CodeT5+DeepDFA) transformer is worth running only on the requests the
GGNN is unsure of. With `serve.cascade=true` a deepdfa ScoringService
answers `/score` as

    stage 1 (always)     the GGNN -> p1
    calibrate            p_cal = temperature_scale(p1, T)
    in the band?         lo <= p_cal < hi   (eval/calibrate.py fits both)
    stage 2 (band only)  the combined or t5 model -> the served prob

and sheds before it queues: once the stage-2 queue holds
`serve.cascade_shed_depth_fraction` of `serve.queue_limit`, a new
escalation answers with its stage-1 score. A stage-2 failure (timeout,
full queue, executor error) also answers with the stage-1 score; it
never fails the request.

- `CascadeStage2`: the stage-2 stack (registry, frontend, batcher, a
  ScoringService of its own) and the band / temperature / shed policy;
  `build_stage2_smoke` lays down a real stage-2 checkpoint without a
  training loop (the CPU tests' fixture).
- `model_cfg.json` (`save_model_setup`/`load_model_setup`): a run-dir
  manifest holding the tokenizer descriptor (`{"kind": "hash", ...}` or
  `{"kind": "bpe", "vocab": path, "merges": path}`) and the encoder
  config that a combined or t5 checkpoint is rebuilt with; `cli
  train-combined` writes it, `ModelRegistry` reads it. Its keys are the
  reference's, so either package reads the other's file.
- `CombinedFrontend`: code -> (token ids, GraphSpec | None), the
  combined families' counterpart of serve/frontend.py's preprocessor.
- `build_combined_service_parts`: the frontend and executor that
  serve/server.py:ScoringService wires for a combined or t5 registry.

The cascade's counters are plain integers (`counters()`, in `/stats`
and `/healthz`), as the service's own `/stats` are. The reference's `obs`
registry metrics, SLO windows per stage, trace spans and
`validate_cascade_log`'s schema check belong to the operations layer
(ROADMAP queue A, item 12). A `serve.cascade_checkpoint` tag with the
suffix `@int8` serves a quantized stage 2 (serve/quant.py, through the
registry).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from deepdfa_tpu_torch.eval import calibrate as calibrate_mod

logger = logging.getLogger(__name__)

#: the run-dir manifest that makes a combined or t5 run self-describing
MODEL_CFG_MANIFEST = "model_cfg.json"


def save_model_setup(run_dir: str | Path, family: str, model_cfg: Any,
                     tokenizer_desc: dict, max_length: int) -> Path:
    """Write the manifest a combined or t5 run needs to be restored
    without CLI arguments. `tokenizer_desc` is {"kind": "hash",
    "vocab_size", "t5_frame"} or {"kind": "bpe", "vocab": path,
    "merges": path}."""
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
    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer, HashTokenizer

    kind = desc.get("kind", "hash")
    if kind == "hash":
        return HashTokenizer(vocab_size=int(desc.get("vocab_size", 4096)),
                             t5_frame=bool(desc.get("t5_frame", False)))
    if kind == "bpe":
        return BpeTokenizer(Path(desc["vocab"]), Path(desc["merges"]))
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
    surface (`features_full`, `features`, `cache`, `stats`, `close`).

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

    def close(self) -> None:
        if self.graph_frontend is not None:
            self.graph_frontend.close()


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
            cfg, registry.vocabs, use_joern=cfg.serve.use_joern,
            cache=shared_cache(cfg.serve.feature_cache_entries))
    frontend = CombinedFrontend(tok, max_length or buckets[-1], graph_frontend=graph_fe)
    executor = CombinedExecutor(
        registry.model, tok, buckets, cfg.data.token_budget, node_budget, edge_budget,
        device=registry.device)
    return frontend, executor


class CascadeStage2:
    """The escalation half of a cascade-mode ScoringService: a stage-2
    serving stack (`service`, a ScoringService over the combined or t5
    registry, its own warm-up) and the band / temperature / shed policy.
    The counters are shared by the HTTP handler's threads and guarded by
    one lock."""

    def __init__(self, service, band: tuple[float, float], temperature: float = 1.0,
                 shed_depth_fraction: float = 0.75, timeout_s: float = 60.0):
        self.service = service
        self.band = (float(band[0]), float(band[1]))
        self.temperature = float(temperature)
        self.shed_depth_fraction = float(shed_depth_fraction)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._counts = {"requests": 0, "escalations": 0, "sheds": 0, "failures": 0}

    @classmethod
    def from_config(cls, cfg, run_dir, device=None) -> "CascadeStage2":
        """The stage-2 stack of the primary serve config, on `device`:
        `serve.cascade_run_dir` (default the serving run's own), family
        and checkpoint tag; its config has `cascade`, `lines`,
        `request_log` and `hot_swap` forced off (stage 2 never builds a
        stage 3)."""
        from deepdfa_tpu_torch.core import config as config_mod
        from deepdfa_tpu_torch.serve.registry import ModelRegistry, load_run_config
        from deepdfa_tpu_torch.serve.server import ScoringService

        scfg = cfg.serve
        stage2_dir = Path(scfg.cascade_run_dir or run_dir)
        s2cfg = cfg if stage2_dir == Path(run_dir) else load_run_config(stage2_dir)
        s2cfg = config_mod.apply_overrides(s2cfg, [
            "serve.cascade=false", "serve.lines=false", "serve.request_log=false",
            "serve.hot_swap=false"])
        registry = ModelRegistry(stage2_dir, family=scfg.cascade_family,
                                 checkpoint=scfg.cascade_checkpoint, cfg=s2cfg, device=device)
        return cls(ScoringService(registry, s2cfg), band=tuple(scfg.cascade_band),
                   temperature=scfg.cascade_temperature,
                   shed_depth_fraction=scfg.cascade_shed_depth_fraction,
                   timeout_s=scfg.cascade_timeout_s)

    def _count(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    # -- policy --------------------------------------------------------------

    def calibrated(self, prob: float) -> float:
        return float(calibrate_mod.temperature_scale([prob], self.temperature)[0])

    def should_escalate(self, calibrated_prob: float) -> bool:
        return calibrate_mod.in_band(calibrated_prob, self.band)

    def overloaded(self) -> bool:
        """The stage-2 queue at or past the shed fraction of its limit."""
        depth = self.service.batcher.stats()["queue_depth"]
        return depth >= self.shed_depth_fraction * self.service.cfg.serve.queue_limit

    # -- the verdict both drives share ----------------------------------------

    def screen(self, prob1: float) -> tuple[bool, dict]:
        """Count the request, calibrate, apply the band and the shed
        check: (escalate?, response and log fields). The caller runs the
        escalation and reports it through `note_escalated` /
        `note_escalation_failed`, so the HTTP handler and `score_texts`
        count alike."""
        self._count("requests")
        cal = self.calibrated(prob1)
        fields: dict = {"stage": 1, "stage1_prob": float(prob1),
                        "calibrated_prob": round(cal, 6)}
        if self.should_escalate(cal):
            if not self.overloaded():
                return True, fields
            self._count("sheds")
            fields["cascade_shed"] = 1
        return False, fields

    def note_escalated(self) -> None:
        """One successful stage-2 pass (a failed one degrades to stage 1
        and is not an escalation)."""
        self._count("escalations")

    def note_escalation_failed(self) -> None:
        self._count("failures")

    # -- escalation ------------------------------------------------------------

    def escalate(self, code: str, request_id: str | None = None) -> tuple[float, float]:
        """(stage-2 prob, seconds) of one request: the online path (the
        HTTP handler's threads co-batch in the stage-2 batcher)."""
        t0 = time.perf_counter()
        req = self.service.submit_code(code, request_id=request_id)
        prob = req.wait(self.timeout_s)
        return float(prob), time.perf_counter() - t0

    def decide(self, code: str, prob1: float, request_id: str | None = None):
        """The verdict of one request: (final prob, response fields, extra
        stage seconds). A stage-2 failure degrades to the stage-1 score."""
        escalate, info = self.screen(prob1)
        extra: dict = {}
        if escalate:
            try:
                prob2, dt = self.escalate(code, request_id)
            except Exception:  # noqa: BLE001 - degrade, never fail
                logger.warning("stage-2 escalation failed for %s; serving the stage-1 "
                               "score", request_id, exc_info=True)
                self.note_escalation_failed()
                info["cascade_failed"] = 1
            else:
                self.note_escalated()
                info["stage"] = 2
                extra["cascade_stage2"] = dt
                return prob2, info, extra
        return float(prob1), info, extra

    def escalate_many(self, codes: list[str], request_ids=None) -> list:
        """The offline drive (`score_texts`): every escalated request
        through the stage-2 batcher's `score_all`. [(prob | None,
        seconds)] aligned with `codes`; None is a failed pass (counted;
        the caller serves that row's stage-1 score)."""
        svc = self.service
        payloads = [svc.frontend.features_full(c).spec for c in codes]
        t0 = time.perf_counter()
        reqs = svc.batcher.score_all(payloads, request_ids=request_ids)
        out = []
        for req in reqs:
            try:
                prob = req.wait(self.timeout_s)
            except Exception:  # noqa: BLE001 - per-row fault isolation
                logger.warning("stage-2 pass failed for %s; serving the stage-1 score",
                               req.request_id, exc_info=True)
                self.note_escalation_failed()
                out.append((None, req.latency_s or 0.0))
                continue
            self.note_escalated()
            out.append((float(prob), req.latency_s if req.latency_s is not None
                        else time.perf_counter() - t0))
        return out

    # -- service plumbing ------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            c = dict(self._counts)
        n = c["requests"]
        c["escalation_rate"] = round(c["escalations"] / n, 4) if n else 0.0
        return c

    def info(self) -> dict:
        """The `/healthz` cascade section."""
        reg = self.service.registry
        return {
            "band": list(self.band),
            "temperature": self.temperature,
            "shed_depth_fraction": self.shed_depth_fraction,
            "stage2_family": reg.family,
            "stage2_checkpoint": reg.checkpoint,
            "stage2_checkpoint_step": reg.info()["checkpoint_step"],
            "stage2_warmed_signatures": [list(s) for s in self.service.executor.signatures()],
            **self.counters(),
        }

    def start(self) -> None:
        self.service.start()

    def close(self) -> None:
        self.service.close()


def build_stage2_smoke(run_dir: str | Path, cfg, family: str = "combined", hidden: int = 8,
                       layers: int = 1, heads: int = 2, max_length: int = 32,
                       vocab_size: int = 256, use_graph: bool = False, seed: int = 0):
    """Lay down a real stage-2 checkpoint beside a (smoke) run's GGNN:
    `checkpoints-combined-torch/` with a `best` tag and the
    `model_cfg.json` manifest, so cascade tests go through the real
    registry restore. Returns (tokenizer, model config)."""
    import torch

    from deepdfa_tpu_torch.core.paths import COMBINED_CHECKPOINTS_DIR
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import (
        CombinedConfig,
        CombinedModel,
        DefectConfig,
        DefectModel,
        T5Config,
        TransformerConfig,
    )
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = Path(run_dir)
    tok = HashTokenizer(vocab_size=vocab_size, t5_frame=(family == "t5"))
    graph = dict(graph_hidden_dim=cfg.model.hidden_dim, graph_input_dim=cfg.data.feat.input_dim,
                 use_graph=use_graph)
    gen = torch.Generator().manual_seed(seed)
    if family == "t5":
        enc = dataclasses.replace(
            T5Config.tiny(vocab_size=tok.vocab_size, hidden_size=2 * hidden, num_layers=layers,
                          num_heads=heads, head_dim=hidden, ffn_size=4 * hidden),
            max_sequence_length=max_length)
        mcfg = DefectConfig(encoder=enc, **graph)
        model = DefectModel(mcfg, generator=gen)
    else:
        enc = TransformerConfig.tiny(vocab_size=tok.vocab_size,
                                     max_position_embeddings=max_length + 4, num_layers=layers,
                                     num_heads=heads, hidden_size=2 * hidden,
                                     intermediate_size=4 * hidden)
        mcfg = CombinedConfig(encoder=enc, **graph)
        model = CombinedModel(mcfg, generator=gen)
    mgr = CheckpointManager(run_dir / COMBINED_CHECKPOINTS_DIR, monitor="val_loss")
    mgr.save("epoch-0001", {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
             {"val_loss": 1.0}, step=1)
    save_model_setup(run_dir, family, mcfg,
                     {"kind": "hash", "vocab_size": tok.vocab_size, "t5_frame": family == "t5"},
                     max_length)
    return tok, mcfg
