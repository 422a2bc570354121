"""Model registry for online inference (the port's counterpart of the
reference's `deepdfa_tpu/serve/registry.py`).

Turns a run directory written by the port's own training commands into
a servable handle: the run's saved `config.json`, a weights-only restore
of a torch checkpoint (`train/checkpoint.py:CheckpointManager.restore`,
never the optimiser) into a fresh module on the serving device, and the
abstract-dataflow vocabularies the run was extracted with, digest-pinned
so a checkpoint is never served against features it was not trained on.

Hot swap: `maybe_reload()` re-reads the checkpoint manifest between
batches (the batcher's `on_batch` hook) and, when the tracked tag moved
to another step, restores the new weights into a new module outside the
lock and swaps one reference under it. A batch runs the old module or
the new one, never a mix. A run whose config or vocabulary digest
changed is refused (logged; the old weights keep serving). Every commit
bumps a generation counter, so a restore that another commit overtook
(a concurrent poller, or the fleet rollout's operator swap, ROADMAP
queue A item 12) is discarded instead of reverting it.

Three families restore through the same interface: "deepdfa" (the
flagship GGNN, `checkpoints-torch/`), "combined" (DeepDFA+LineVul) and
"t5" (CodeT5+DeepDFA; both `checkpoints-combined-torch/`). The combined
families rebuild their tokenizer and encoder config from the run's
`model_cfg.json` (serve/cascade.py), unless the caller passes
`model_cfg`.

The port restores its own checkpoints only: a run directory that holds
only the reference's orbax `checkpoints/` is refused by a message that
says so (the card's machine has no JAX, orbax or tensorstore). Left out:
`serve_mesh` (queue A item 9), `swap_checkpoint` and `rollback` (the
fleet rollout, item 12).

Quantized entries (serve/quant.py): a `tag@int8` checkpoint restores the
fp32 `tag`, quantizes it, measures the probability drift over
`serve.quant_calibration_samples` calibration rows against the fp32
weights, and refuses the entry past `serve.quant_drift_bound` (loudly,
naming the worst-quantized tensors; at hot swap the refusal is logged
and the old weights keep serving). The entry keeps the int8 weights,
their scales and the bf16 tensors on the device behind a
`QuantizedModel`, which dequantizes in every call; `info()` reports the
drift and the bytes fraction.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from pathlib import Path
from typing import Any

import torch

from deepdfa_tpu_torch.core import config as config_mod
from deepdfa_tpu_torch.core import paths
from deepdfa_tpu_torch.core.config import Config
from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.frontend.structfeat import feat_width
from deepdfa_tpu_torch.serve import quant

logger = logging.getLogger(__name__)

#: checkpoint subdirectory per model family (the port's training CLI's layout)
CKPT_DIR_BY_FAMILY = {
    "deepdfa": paths.CHECKPOINTS_DIR,
    "combined": paths.COMBINED_CHECKPOINTS_DIR,
    "t5": paths.COMBINED_CHECKPOINTS_DIR,
}
#: the reference's orbax directories, which the port cannot restore
REFERENCE_CKPT_DIR_BY_FAMILY = {
    "deepdfa": "checkpoints",
    "combined": "checkpoints-combined",
    "t5": "checkpoints-combined",
}


class RegistryError(RuntimeError):
    """Registry-level restore failure with an operator-grade message."""


#: model knobs left out of the digest: how the GGNN kernels tile, scatter
#: and accumulate, never parameter shapes or feature semantics, so a
#: tuned layout applied at serve time does not refuse hot swaps
_LAYOUT_ONLY_MODEL_KEYS = (
    "ggnn_kernel_block_nodes", "ggnn_kernel_block_edges",
    "ggnn_kernel_scatter", "ggnn_kernel_accum", "ggnn_kernel_unroll",
)

#: data knobs left out the same way: bucket edges shape padding only
_LAYOUT_ONLY_DATA_KEYS = ("seq_buckets",)


def config_digest(cfg: Config) -> str:
    """Digest of the config sections that fix parameter shapes and
    feature semantics (model + data): equal digests mean shape- and
    feature-compatible checkpoints, the hot-swap admission rule."""
    d = config_mod.to_dict(cfg)
    model = {k: v for k, v in d["model"].items() if k not in _LAYOUT_ONLY_MODEL_KEYS}
    data = {k: v for k, v in d["data"].items() if k not in _LAYOUT_ONLY_DATA_KEYS}
    payload = json.dumps({"model": model, "data": data}, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def config_drift(saved: dict, current: dict) -> list[str]:
    """Dotted keys of the model and data sections whose values differ
    between a run's saved config.json and the config being served."""
    out: list[str] = []
    for section in ("model", "data"):
        out.extend(_dict_drift(saved.get(section, {}), current.get(section, {}),
                               f"{section}."))
    return out


def _dict_drift(a: Any, b: Any, prefix: str) -> list[str]:
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            out.extend(_dict_drift(a.get(k), b.get(k), f"{prefix}{k}."))
        return out
    # tuples round-trip to lists through json
    na = list(a) if isinstance(a, (list, tuple)) else a
    nb = list(b) if isinstance(b, (list, tuple)) else b
    return [] if na == nb else [prefix.rstrip(".")]


def load_run_config(run_dir: str | Path) -> Config:
    """The run's saved config.json, the manifest every restore is built
    against."""
    path = Path(run_dir) / "config.json"
    if not path.exists():
        raise RegistryError(
            f"{path} not found: the run directory must hold the config.json the "
            f"training CLI writes (is {run_dir} a run?)"
        )
    cfg = config_mod.load(path)
    config_mod.validate(cfg)
    return cfg


def load_vocabs(cfg: Config) -> tuple[dict, str]:
    """The run's abstract-dataflow vocabularies and their content digest.
    The file name encodes the whole feature spec, so a spec drift between
    extraction and serving is a missing file here (named)."""
    from deepdfa_tpu_torch.frontend.vocab import AbsDfVocab

    vocab_path = paths.processed_dir(cfg.data.dataset) / f"vocab{cfg.data.feat.name}.json"
    if not vocab_path.exists():
        raise RegistryError(
            f"vocab file {vocab_path} not found: serving needs the vocabularies the "
            "checkpoint was trained with (run `extract` with the same data.feat.* "
            "settings, or fix data.feat.* to match the training run)"
        )
    raw = vocab_path.read_bytes()
    vocabs = {k: AbsDfVocab.from_json(v) for k, v in json.loads(raw).items()}
    want = cfg.data.feat.input_dim
    for k, v in vocabs.items():
        if v.input_dim > want:
            raise RegistryError(
                f"vocab subkey {k!r} input_dim {v.input_dim} exceeds "
                f"data.feat.limit_all+2={want}: the vocab on disk was built with "
                "another data.feat.limit_all than this config declares"
            )
    return vocabs, hashlib.sha256(raw).hexdigest()[:16]


class ModelRegistry:
    """Restores and holds the served module of one run on `device`
    (None: the card). `model()` is thread-safe: the batcher reads it on
    every batch while `maybe_reload()` may swap underneath."""

    def __init__(
        self,
        run_dir: str | Path,
        family: str = "deepdfa",
        checkpoint: str = "best",
        cfg: Config | None = None,
        model_cfg: Any = None,
        device: str | torch.device | None = None,
    ):
        if family not in CKPT_DIR_BY_FAMILY:
            raise RegistryError(f"unknown model family {family!r}; known: "
                                f"{sorted(CKPT_DIR_BY_FAMILY)}")
        self.run_dir = Path(run_dir)
        self.family = family
        #: the served tag ("best@int8"), the fp32 tag it restores ("best")
        #: and the quantization mode (None or "int8")
        self.checkpoint = checkpoint
        self.base_checkpoint, self.quant_mode = quant.split_checkpoint_tag(checkpoint)
        self.quant_drift: float | None = None
        self.quant_bytes_fraction: float | None = None
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else load_run_config(self.run_dir)
        self.model_cfg = model_cfg
        self.tokenizer = None
        self.serve_max_length: int | None = None
        if family in ("combined", "t5") and model_cfg is None:
            from deepdfa_tpu_torch.serve import cascade as cascade_mod

            setup = cascade_mod.try_load_model_setup(self.run_dir, family)
            if setup is None:
                raise RegistryError(
                    f"family {family!r} needs the encoder model_cfg the run was trained "
                    f"with: pass model_cfg, or train a run that saved "
                    f"{cascade_mod.MODEL_CFG_MANIFEST} (train-combined writes it)")
            self.tokenizer, self.model_cfg, self.serve_max_length = setup
        if family == "deepdfa" and self.cfg.model.label_style != "graph":
            raise RegistryError("serving supports model.label_style='graph' only "
                                f"(got {self.cfg.model.label_style!r})")
        self.config_digest = config_digest(self.cfg)
        self.vocabs, self.vocab_digest = load_vocabs(self.cfg)
        self._lock = threading.Lock()
        self._model: torch.nn.Module | None = None
        self._loaded_step: int | None = None
        self._loaded_manifest_sig: tuple | None = None
        self.reloads = 0
        #: bumped under the lock by every commit, so a restore that ran
        #: outside the lock while another commit landed is discarded
        self._swap_generation = 0
        self._load_initial()

    # -- construction --------------------------------------------------------

    @property
    def ckpt_dir(self) -> Path:
        return self.run_dir / CKPT_DIR_BY_FAMILY[self.family]

    def _build_model(self) -> torch.nn.Module:
        """A fresh module at the run's dimensions (on the host; the
        restore fills every weight)."""
        if self.family == "deepdfa":
            from deepdfa_tpu_torch.models import DeepDFA

            return DeepDFA.from_config(self.cfg.model, self.cfg.data.feat.input_dim)
        if self.family == "t5":
            from deepdfa_tpu_torch.models import DefectModel

            return DefectModel(self.model_cfg)
        from deepdfa_tpu_torch.models import CombinedModel

        return CombinedModel(self.model_cfg)

    def _manifest(self) -> tuple[dict, int] | None:
        """(manifest, mtime_ns) of the checkpoint directory, or None."""
        path = self.ckpt_dir / "manifest.json"
        try:
            st = path.stat()
            return json.loads(path.read_text()), st.st_mtime_ns
        except (OSError, json.JSONDecodeError):
            return None

    def _entry(self, manifest: dict) -> dict | None:
        """The manifest entry of the tracked tag."""
        tag = self.base_checkpoint
        if tag in ("best", "last"):
            return manifest.get(tag)
        return next((e for e in reversed(manifest.get("history", []))
                     if e.get("tag") == tag), None)

    def _manifest_sig(self) -> tuple | None:
        """(step, mtime_ns) of the tracked tag: the cheap change detector
        maybe_reload polls."""
        got = self._manifest()
        if got is None:
            return None
        manifest, mtime = got
        entry = self._entry(manifest)
        return (entry.get("step", -1) if entry else -1, mtime)

    def _restore(self) -> torch.nn.Module:
        """One weights restore into a new eval-mode module on the device
        (a `QuantizedModel` for an `@int8` tag), with operator-grade
        errors."""
        from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

        if not self.ckpt_dir.is_dir():
            ref_dir = self.run_dir / REFERENCE_CKPT_DIR_BY_FAMILY[self.family]
            if ref_dir.is_dir():
                raise RegistryError(
                    f"{self.run_dir} holds only the reference's orbax checkpoints "
                    f"({ref_dir.name}/): the port restores its own torch checkpoints "
                    f"({CKPT_DIR_BY_FAMILY[self.family]}/, written by `python -m "
                    "deepdfa_tpu_torch.cli train` or `train-combined`) and has no "
                    "orbax restore")
            raise RegistryError(
                f"no checkpoint directory {self.ckpt_dir}: family {self.family!r} "
                f"expects the {CKPT_DIR_BY_FAMILY[self.family]}/ layout the port's "
                "training CLI writes")
        tag = self.base_checkpoint
        if tag == "last":
            got = self._manifest()
            entry = got and got[0].get("last")
            if not entry:
                raise RegistryError(f"no 'last' entry in {self.ckpt_dir}/manifest.json")
            tag = entry["tag"]
        try:
            state = CheckpointManager(self.ckpt_dir).restore(tag)["model"]
        except FileNotFoundError as e:
            raise RegistryError(str(e)) from e
        model = self._build_model()
        try:
            model.load_state_dict(state)
        except RuntimeError as e:
            # name the config keys when the run's saved config can tell them
            saved_path = self.run_dir / "config.json"
            drift = (config_drift(json.loads(saved_path.read_text()),
                                  config_mod.to_dict(self.cfg))
                     if saved_path.exists() else [])
            if drift:
                raise RegistryError(
                    "checkpoint restore failed; config keys differ from the run's saved "
                    f"config.json: {drift} ({e})") from e
            raise RegistryError(f"checkpoint restore failed: {e}") from e
        return self._maybe_quantize(model.to(self.device).eval())

    # -- quantized entries (serve/quant.py) ----------------------------------

    def _score_fn(self, module: torch.nn.Module):
        """(fp32 state dict, host batch) -> probabilities on the device:
        the family's serving probability rule, run through `module`."""

        def score(params, batch):
            b = batch.to(self.device)
            if self.family == "deepdfa":
                return torch.sigmoid(torch.func.functional_call(module, params, (b,)))
            logits = torch.func.functional_call(
                module, params, (b.input_ids, b.graphs, b.has_graph))
            return torch.softmax(logits, dim=-1)[:, 1]

        return score

    def _calibration_batches(self) -> list:
        """The reference's deterministic calibration input: one packed
        batch of `serve.quant_calibration_samples` real rows."""
        n = max(1, int(self.cfg.serve.quant_calibration_samples))
        if self.family == "deepdfa":
            return [quant.calibration_graph_batch(
                n, node_budget=1024, edge_budget=4096, feat_width=self._feat_width(),
                input_dim=self.cfg.data.feat.input_dim, etypes=self.cfg.model.n_etypes > 1,
                n_etypes=self.cfg.model.n_etypes)]
        enc = self.model_cfg.encoder
        cap = int(getattr(enc, "max_sequence_length", 0)
                  or getattr(enc, "max_position_embeddings", 36) - 4)
        return [quant.calibration_text_batch(
            rows=n, seq_len=max(8, min(32, cap)), vocab_size=int(enc.vocab_size),
            pad_id=int(enc.pad_token_id), node_budget=1024, edge_budget=4096)]

    def _feat_width(self) -> int:
        """node_feats columns the GGNN family packs: 4, or 9 for a
        struct_feats model."""
        return feat_width(self.cfg.model.struct_feats)

    def _maybe_quantize(self, model: torch.nn.Module) -> torch.nn.Module:
        """A plain entry passes through; an `@int8` one is quantized, its
        calibration drift measured against the fp32 weights and refused
        past `serve.quant_drift_bound`."""
        if not self.quant_mode:
            return model
        params = model.state_dict()
        heads = getattr(getattr(self.model_cfg, "encoder", None), "num_heads", None)
        qtree = quant.quantize_params(params, num_heads=heads)
        bound = float(self.cfg.serve.quant_drift_bound)
        on_device = quant.tree_to(qtree, self.device)
        try:
            drift = quant.check_drift(self._score_fn(model), params, on_device,
                                      self._calibration_batches(), bound)
        except quant.QuantizationError as e:
            raise RegistryError(str(e)) from e
        report = quant.quant_report(params, qtree)
        self.quant_drift = drift
        self.quant_bytes_fraction = round(report.bytes_fraction, 4)
        logger.info("quantized %s: %.0f -> %.0f param bytes (%.1f%%), calibration drift "
                    "%.2e (bound %g)", self.checkpoint, report.bytes_fp32, report.bytes_quant,
                    100 * report.bytes_fraction, drift, bound)
        return quant.QuantizedModel(model, on_device)

    def _load_initial(self) -> None:
        sig = self._manifest_sig()
        model = self._restore()
        with self._lock:
            self._model = model
            self._loaded_manifest_sig = sig
            self._loaded_step = sig[0] if sig else None

    # -- serving surface -----------------------------------------------------

    def model(self) -> torch.nn.Module:
        """The served module (eval mode, on the device; a
        `QuantizedModel` for an `@int8` entry)."""
        with self._lock:
            return self._model

    def params(self) -> dict:
        """The served weights: the module's state dict, or an `@int8`
        entry's quantized tree."""
        model = self.model()
        if isinstance(model, quant.QuantizedModel):
            return model.qtree
        return model.state_dict()

    def maybe_reload(self) -> bool:
        """Poll the manifest; hot-swap when the tracked tag moved. Called
        between batches. A failed or refused attempt logs and keeps the
        old weights serving."""
        sig = self._manifest_sig()
        if sig is None or sig == self._loaded_manifest_sig:
            return False
        with self._lock:
            gen = self._swap_generation
        try:
            new_cfg = load_run_config(self.run_dir)
            if config_digest(new_cfg) != self.config_digest:
                logger.warning(
                    "hot-swap refused: run config changed (%s); still serving step %s",
                    config_drift(config_mod.to_dict(new_cfg), config_mod.to_dict(self.cfg)),
                    self._loaded_step)
                self._loaded_manifest_sig = sig  # don't re-log every poll
                return False
            _, vocab_digest = load_vocabs(self.cfg)
            if vocab_digest != self.vocab_digest:
                logger.warning(
                    "hot-swap refused: vocab digest changed (%s -> %s); still serving "
                    "step %s", self.vocab_digest, vocab_digest, self._loaded_step)
                self._loaded_manifest_sig = sig
                return False
            model = self._restore()
            with self._lock:
                if self._swap_generation != gen:
                    logger.warning(
                        "hot-swap discarded: another swap landed mid-restore; serving "
                        "%r step %s", self.checkpoint, self._loaded_step)
                    return False
                self._model = model
                self._loaded_manifest_sig = sig
                self._loaded_step = sig[0]
                self._swap_generation += 1
            self.reloads += 1
            logger.info("hot-swapped to checkpoint step %s", sig[0])
            return True
        except (RegistryError, OSError) as e:
            # a half-written checkpoint mid-poll must not kill serving
            logger.warning("hot-swap attempt failed (%s); keeping the weights", e)
            return False

    def info(self) -> dict:
        """The /healthz payload: what is serving, from where, pinned how."""
        out = {
            "family": self.family,
            "run_dir": str(self.run_dir),
            "checkpoint": self.checkpoint,
            "checkpoint_step": self._loaded_step,
            "config_digest": self.config_digest,
            "vocab_digest": self.vocab_digest,
            "hot_swaps": self.reloads,
            "device": str(self.device),
        }
        if self.quant_mode:
            out.update(quantized=self.quant_mode, quant_drift=self.quant_drift,
                       quant_drift_bound=self.cfg.serve.quant_drift_bound,
                       quant_param_bytes_fraction=self.quant_bytes_fraction)
        return out
