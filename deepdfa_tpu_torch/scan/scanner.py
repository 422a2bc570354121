"""Repo scan orchestration (the port's copy of the JAX package's
`deepdfa_tpu/scan/scanner.py`).

`RepoScanner` drives one scan over the online serving engine of the
port: the shared content-keyed frontend cache, the dynamic batcher's
offline drive (`DynamicBatcher.score_all` over the `GgnnExecutor`
ladder) and, with `scan.lines`, the line localizer
(`GgnnLocalizer.attribute_all`), so a scan runs the code paths live
traffic does, at repo scale, on the card unless the registry was built
for the CPU:

    walk -> split -> (manifest reuse | frontend -> score -> attribute)
         -> findings JSONL + SARIF -> manifest save -> scan_log.jsonl

Incrementality is two-layered (scan/manifest.py): unchanged files skip
re-splitting, unchanged functions (content key) skip frontend and
device entirely.

Known differences from the reference: no trace spans, `obs_metrics`
sections, efficiency ledger or flight-recorder postmortem (the port has
no telemetry plane yet), so the summary drops
`scan_steady_state_recompiles` and `scan_lines_steady_state_recompiles`
(PyTorch runs eagerly and compiles nothing to count) and adds `device`
and the kernel launches of the scan's window.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from pathlib import Path

from deepdfa_tpu_torch.nn import ggnn_kernel
from deepdfa_tpu_torch.scan.manifest import ScanManifest
from deepdfa_tpu_torch.scan.sarif import sarif_report, validate_sarif, write_sarif
from deepdfa_tpu_torch.scan.walker import split_functions, walk_repo
from deepdfa_tpu_torch.serve.driver import SUMMARY_KEYS

#: ggnn_kernel counters a scan summary reports, under their summary keys:
#: run_score's, and the backward kernels the line attributions launch
LAUNCH_KEYS = {**SUMMARY_KEYS, "GRU_BWD_LAUNCHES": "ggnn_gru_bwd_launches",
               "DMSG_LAUNCHES": "ggnn_dmsg_launches"}


def _launches() -> dict[str, int]:
    counts = ggnn_kernel.launch_counts()
    return {key: counts[name] for name, key in LAUNCH_KEYS.items()}


def write_scan_log(run_dir, records) -> Path:
    """Append scan records to <run_dir>/scan_log.jsonl."""
    path = Path(run_dir) / "scan_log.jsonl"
    with path.open("a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return path


class RepoScanner:
    """One scan engine bound to a ScoringService (registry + shared
    frontend + batcher); `scan()` is re-entrant per repo."""

    def __init__(self, service, cfg=None, localizer=None):
        cfg = cfg if cfg is not None else service.cfg
        if service.registry.family != "deepdfa":
            raise ValueError(f"scan scores with a GGNN run, not family "
                             f"{service.registry.family!r}")
        self.service = service
        self.cfg = cfg
        self.scfg = cfg.scan
        # the line localizer: an injected one wins, then the service's
        # (serve.lines warmed it), else one over the scoring ladder
        self.localizer = localizer if localizer is not None else service.localizer
        if self.localizer is None and self.scfg.lines:
            from deepdfa_tpu_torch.serve.localize import GgnnLocalizer

            scfg = cfg.serve
            ex = service.executor
            self.localizer = GgnnLocalizer(
                service.registry.model, ex.node_budget, ex.edge_budget, ex.sizes,
                method=scfg.lines_method, n_steps=scfg.lines_steps, top_k=scfg.lines_top_k,
                etypes=cfg.model.n_etypes > 1, device=service.registry.device,
                pipeline_depth=scfg.pipeline_depth,
                feat_width=service.registry._feat_width(),
            )
            self.localizer.warmup()
        self._next_id = 0

    # -- identity & state -----------------------------------------------------

    def identity(self) -> dict:
        """What a reused score is pinned to: the model/feature identity
        plus the attribution recipe (a method change must re-attribute)."""
        reg = self.service.registry
        ident = {
            "config_digest": reg.config_digest,
            "vocab_digest": reg.vocab_digest,
            "checkpoint": reg.checkpoint,
            "checkpoint_step": reg._loaded_step,
            "lines": self.localizer is not None,
        }
        if self.localizer is not None:
            ident.update(method=self.localizer.method, attr_steps=self.localizer.n_steps,
                         top_k=self.localizer.top_k)
        return ident

    def state_path(self, repo_root) -> Path:
        if self.scfg.state:
            return Path(self.scfg.state)
        digest = hashlib.sha256(str(Path(repo_root).resolve()).encode()).hexdigest()[:16]
        return self.service.registry.run_dir / "scan_state" / f"{digest}.json"

    # -- the scan -------------------------------------------------------------

    def scan(self, repo_root, out_jsonl=None, sarif_out=None, timeout_s: float = 300.0) -> dict:
        """Scan one repository; returns the summary record (also
        appended to <run_dir>/scan_log.jsonl)."""
        repo_root = Path(repo_root).resolve()
        run_dir = self.service.registry.run_dir
        out_jsonl = Path(out_jsonl if out_jsonl else run_dir / "scan" / "findings.jsonl")
        sarif_out = Path(sarif_out if sarif_out else run_dir / "scan" / "findings.sarif")
        cache = self.service.frontend.cache
        cache_hits0, cache_misses0 = cache.hits, cache.misses
        launches0 = _launches()
        t_start = time.perf_counter()

        # -- walk + split + manifest reuse
        walk_stats: dict = {}
        t0 = time.perf_counter()
        files = walk_repo(repo_root, self.scfg.suffixes, self.scfg.exclude_dirs,
                          self.scfg.max_file_kb * 1024, stats=walk_stats)
        walk_s = time.perf_counter() - t0
        manifest = (
            ScanManifest.load(self.state_path(repo_root), self.identity())
            if self.scfg.incremental
            else ScanManifest(self.state_path(repo_root), self.identity())
        )

        rows: list[dict] = []  # one per discovered function, file order
        pending: "OrderedDict[str, str]" = OrderedDict()  # key -> code
        files_reused = 0
        reused_fns = 0
        t0 = time.perf_counter()
        for sf in files:
            fns = manifest.file_functions(sf.rel, sf.sha256)
            if fns is None:
                fns = []
                for sp in split_functions(sf.text):
                    key = self.service.frontend.content_key(sp.code)
                    fns.append({"key": key, "name": sp.name, "start_line": sp.start_line,
                                "end_line": sp.end_line})
                    if manifest.result(key) is None:
                        pending.setdefault(key, sp.code)
                manifest.record_file(sf.rel, sf.sha256, fns)
            else:
                files_reused += 1
            for fn in fns:
                if manifest.result(fn["key"]) is not None:
                    reused_fns += 1
                rows.append({**fn, "file": sf.rel})
        split_s = time.perf_counter() - t0

        # -- frontend (shared content-keyed cache)
        feats_by_key: "OrderedDict[str, object]" = OrderedDict()
        failed = 0
        t0 = time.perf_counter()
        for key, code in pending.items():
            self._next_id += 1
            try:
                feats_by_key[key] = self.service.frontend.features_full(code, self._next_id)
            except Exception as e:  # noqa: BLE001 - one function is a failed row,
                # never a dead scan (failures are content-keyed too)
                manifest.record_result(key, {"ok": False, "error": str(e)})
                failed += 1
        frontend_s = time.perf_counter() - t0

        # -- score through the batcher's offline drive
        t0 = time.perf_counter()
        scored = 0
        keys = list(feats_by_key)
        reqs = self.service.batcher.score_all([feats_by_key[k].spec for k in keys])
        for key, req in zip(keys, reqs):
            try:
                prob = req.wait(timeout_s)
                manifest.record_result(key, {"ok": True, "prob": float(prob)})
                scored += 1
            except Exception as e:  # noqa: BLE001 - per-function fault isolation
                manifest.record_result(key, {"ok": False, "error": str(e)})
                feats_by_key.pop(key, None)
                failed += 1
        score_s = time.perf_counter() - t0

        # -- line attributions (the scoring ladder's rungs)
        attr_s = 0.0
        if self.localizer is not None and feats_by_key:
            t0 = time.perf_counter()
            keys = list(feats_by_key)
            attrs = self.localizer.attribute_all([feats_by_key[k] for k in keys])
            for key, (_, lines) in zip(keys, attrs):
                manifest.functions[key]["lines"] = lines
            attr_s = time.perf_counter() - t0

        # -- findings
        t0 = time.perf_counter()
        findings: list[dict] = []
        n_findings = 0
        for row in rows:
            res = manifest.result(row["key"]) or {"ok": False, "error": "internal: no result"}
            finding = {"file": row["file"], "function": row["name"],
                       "start_line": row["start_line"], "end_line": row["end_line"],
                       "ok": bool(res.get("ok"))}
            if res.get("ok"):
                finding["prob"] = res["prob"]
                if res["prob"] >= self.scfg.threshold:
                    n_findings += 1
                if res.get("lines") is not None:
                    # manifest lines are in the function's coordinates
                    # (content-keyed entries move with the function);
                    # findings carry absolute file lines
                    finding["lines"] = [
                        {"line": row["start_line"] + la["line"] - 1, "score": la["score"]}
                        for la in res["lines"]
                    ]
            else:
                finding["error"] = res.get("error")
            findings.append(finding)

        out_jsonl.parent.mkdir(parents=True, exist_ok=True)
        with out_jsonl.open("w") as f:
            for finding in findings:
                f.write(json.dumps(finding) + "\n")
        write_sarif(sarif_report(findings, repo_root, threshold=self.scfg.threshold), sarif_out)
        manifest.prune({sf.rel for sf in files}, {row["key"] for row in rows})
        manifest.save()
        write_s = time.perf_counter() - t0
        total_s = time.perf_counter() - t_start

        hits = cache.hits - cache_hits0
        misses = cache.misses - cache_misses0
        launches = {k: v - launches0[k] for k, v in _launches().items()}
        summary = {
            "device": str(self.service.registry.device),
            "scan_files": len(files),
            "scan_files_reused": files_reused,
            "scan_files_skipped": (walk_stats.get("files_too_large", 0)
                                   + walk_stats.get("files_unreadable", 0)),
            "scan_functions": len(rows),
            "scan_reused": reused_fns,
            "scan_extracted": len(pending),
            "scan_scored": scored,
            "scan_functions_failed": failed,
            "scan_findings": n_findings,
            "scan_seconds": round(total_s, 3),
            "scan_functions_per_sec": round(len(rows) / total_s, 2) if total_s else None,
            "scan_incremental_skip_fraction": round(reused_fns / len(rows), 4) if rows else 0.0,
            "scan_cache_hit_fraction": (round(hits / (hits + misses), 4)
                                        if (hits + misses) else None),
            "scan_walk_seconds": round(walk_s, 3),
            "scan_split_seconds": round(split_s, 3),
            "scan_frontend_seconds": round(frontend_s, 3),
            "scan_score_seconds": round(score_s, 3),
            "scan_attribute_seconds": round(attr_s, 3),
            "scan_write_seconds": round(write_s, 3),
            **launches,
            "repo": str(repo_root),
            "scores_path": str(out_jsonl),
            "sarif_path": str(sarif_out),
        }
        write_scan_log(run_dir, [summary])
        return summary


# ---------------------------------------------------------------------------
# the self-contained smoke (the `cli scan --smoke` drive)


def _build_smoke_repo(run_dir: Path, sources_dir: Path, cfg) -> Path:
    """A synthetic repository exercising every walker rule: multi-
    function files in nested directories, an excluded VCS dir with a
    decoy source, and an oversized generated file."""
    repo = run_dir / "smoke_repo"
    texts = [p.read_text() for p in sorted(sources_dir.glob("*.c"))]
    group = 3
    for gi in range(0, len(texts), group):
        sub = repo / ("src" if gi % 2 == 0 else "src/util")
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"mod_{gi // group:02d}.c").write_text("\n".join(texts[gi:gi + group]) + "\n")
    decoy = repo / ".git" / "decoy.c"
    decoy.parent.mkdir(parents=True, exist_ok=True)
    decoy.write_text("int decoy(void) { return 1; }\n")
    big = repo / "gen" / "amalgamated.c"
    big.parent.mkdir(parents=True, exist_ok=True)
    big.write_text("/* generated */\n" + "int filler;\n" * (cfg.scan.max_file_kb * 1024 // 12 + 1))
    return repo


def _edit_one_function(repo: Path) -> tuple[str, str]:
    """Insert one statement into the second function of the first
    scanned file (shifting every later function's lines without changing
    their content): the incremental-rescan probe. Returns (rel file,
    function name)."""
    target = sorted((repo / "src").glob("*.c"))[0]
    text = target.read_text()
    spans = split_functions(text)
    span = spans[1] if len(spans) > 1 else spans[0]
    lines = text.split("\n")
    lines.insert(span.start_line, "  int __scan_smoke_edited = 1;")
    target.write_text("\n".join(lines))
    return target.relative_to(repo).as_posix(), span.name


def run_scan_smoke(extra_overrides=None, device=None, **smoke_kw) -> dict:
    """Train a tiny checkpoint on `device` (None: the card), scan a
    synthetic repo cold, edit one function, re-scan incrementally: valid
    SARIF and JSONL, only the edited function re-extracted. The
    reference's recompile counts and postmortem are not part of the port's
    contract (the module's docstring)."""
    from deepdfa_tpu_torch.serve import driver
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import ScoringService

    smoke_kw.setdefault("max_epochs", 1)  # scan scores, never trains
    cfg, run_dir, sources_dir = driver.build_smoke_run(
        run_name="scan-smoke", dataset="scan-smoke",
        extra_overrides=[
            "scan.lines=true",
            "serve.lines_steps=2",
            # every scored function lands in the SARIF results: the tiny
            # model's probabilities hover near chance
            "scan.threshold=0.0",
            "scan.max_file_kb=64",
            *(extra_overrides or []),
        ],
        device=device,
        **smoke_kw,
    )
    repo = _build_smoke_repo(run_dir, sources_dir, cfg)
    registry = ModelRegistry(run_dir, family="deepdfa", checkpoint=cfg.serve.checkpoint,
                             cfg=cfg, device=device)
    service = ScoringService(registry, cfg)
    try:
        scanner = RepoScanner(service, cfg)
        cold = scanner.scan(repo)
        findings = [json.loads(ln) for ln in Path(cold["scores_path"]).read_text().splitlines()]
        sarif_doc = json.loads(Path(cold["sarif_path"]).read_text())
        sarif_problems = validate_sarif(sarif_doc)
        sarif_results = len(sarif_doc["runs"][0]["results"])
        edited_file, edited_fn = _edit_one_function(repo)
        incr = scanner.scan(repo)
    finally:
        service.close()
    return {
        "cold": cold,
        "incremental": incr,
        "findings": len(findings),
        "findings_ok": sum(1 for f in findings if f["ok"]),
        "findings_with_lines": sum(1 for f in findings if f.get("lines")),
        "sarif_problems": sarif_problems,
        "sarif_results": sarif_results,
        "edited_file": edited_file,
        "edited_function": edited_fn,
        "run_dir": str(run_dir),
        "repo": str(repo),
        "scan_log": str(run_dir / "scan_log.jsonl"),
    }


def smoke_problems(report: dict) -> list[str]:
    """What a `run_scan_smoke` report breaks of the smoke's contract (the
    reference's checks without its recompile counts and postmortem)."""
    cold, incr = report["cold"], report["incremental"]
    checks = {
        "no function scanned": cold["scan_functions"] == 0,
        "the cold scan reused functions": cold["scan_reused"] != 0,
        "a function without a finding row": report["findings"] != cold["scan_functions"],
        "no finding carries lines": report["findings_with_lines"] == 0,
        "invalid SARIF": bool(report["sarif_problems"]),
        "no SARIF result": report["sarif_results"] == 0,
        # one function changed: one extraction, everything else reused
        "the re-scan extracted other than one function": incr["scan_extracted"] != 1,
        "the re-scan reused other than the rest":
            incr["scan_reused"] != incr["scan_functions"] - 1,
    }
    return [name for name, bad in checks.items() if bad]
