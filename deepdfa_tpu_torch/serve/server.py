"""HTTP scoring endpoint and offline batch scorer (the port's counterpart
of the reference's `deepdfa_tpu/serve/server.py`).

stdlib only (`http.server.ThreadingHTTPServer`):

  POST /score    {"code": "<C function>"} -> {"ok": true, "prob": p,
                 "latency_ms": ..., "request_id": ...}; with
                 `serve.cascade` also "stage" (1 or 2), "stage1_prob",
                 "calibrated_prob" and, when it happened, "cascade_shed"
                 or "cascade_failed"; {"code": ..., "lines": true} adds
                 "lines", the ranked [{"line", "score"}] of the GGNN's
                 attribution (`serve.lines`)
  GET  /healthz  what is serving: family, checkpoint tag and step,
                 config and vocabulary digests, device, warmed rungs,
                 `lines` and `lines_method`
  GET  /stats    batcher, feature cache, frontend and status counts

Request lifecycle: HTTP thread -> frontend (cached extraction) ->
bounded queue -> scheduler (serve/batcher.py) -> the model on the card
-> response. Admission control maps to the reference's status codes: a
bad body or a missing `code` is 400, an unknown route 404, an
over-budget graph 413, an unparseable function 422, a full queue 429,
an executor failure 500 and a request not answered in time 504.

Cascade mode (`serve.cascade=true`, serve/cascade.py): a deepdfa
service builds a `CascadeStage2`; `/score` screens each stage-1 score and
escalates the calibrated uncertainty band to the combined or t5 model,
and `score_texts` takes every stage-1 verdict first, then escalates the
band in one grouped `escalate_many`. `/healthz` and `/stats` carry a
`cascade` section, and the request log the verdict's fields.

Line attributions (`serve.lines=true`, deepdfa family): the service
builds a `GgnnLocalizer` (serve/localize.py) over the scoring ladder,
with `serve.lines_method`, `lines_steps` and `lines_top_k`, and warms it
beside the executor. A request with {"lines": true} is scored as any
other, then its function is attributed alone; on a server started
without `serve.lines` it answers 400 before any device work. On a
cascade server the lines are stage 1's.

Left out (ROADMAP queue A item 12, the operations layer): `/metrics`
(it answers 404), the SLO windows, `/healthz?deep=1`'s backend probe
(the query is ignored) and trace spans.
"""

from __future__ import annotations

import collections
import json
import logging
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

from deepdfa_tpu_torch.core.config import refuse_unported_serving, serve_budgets
from deepdfa_tpu_torch.serve.batcher import (
    DynamicBatcher,
    GgnnExecutor,
    QueueFull,
    RequestTooLarge,
    ScoreRequest,
    new_request_id,
)
from deepdfa_tpu_torch.serve.frontend import FrontendError, RequestPreprocessor, shared_cache

logger = logging.getLogger(__name__)


class RequestLog:
    """Thread-safe per-request appender to serve_log.jsonl
    (`serve.request_log`): one handle held open, flushed per entry, so a
    crash loses at most the line in flight."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._file = self.path.open("a")

    def append(self, entry: dict) -> None:
        line = json.dumps(entry)
        with self._lock:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()


class ScoringService:
    """Registry + frontend + batcher wired per the serve config: the one
    object the HTTP server and the offline `score` command both drive.

    Family dispatch: the GGNN gets the graph frontend, a GgnnExecutor
    and, with `serve.lines`, a GgnnLocalizer on the same ladder; the
    combined and t5 registries the tokenizer frontend and a
    CombinedExecutor (serve/cascade.py). Under `tune.enabled` the
    tuned.json record matching this card and the serve budgets gives the
    GGNN ladder's rungs and the combined buckets' edges (loudly the
    defaults when none matches); the registry's config digest never sees
    them."""

    def __init__(self, registry, cfg=None):
        cfg = cfg if cfg is not None else registry.cfg
        refuse_unported_serving(cfg)
        self.cfg = cfg
        scfg = cfg.serve
        self.registry = registry
        node_budget, edge_budget = serve_budgets(cfg)
        self.tuned: dict | None = None
        tuned_rungs = tuned_buckets = None
        if cfg.tune.enabled:
            from deepdfa_tpu_torch.tune import cache as tune_cache

            rec = tune_cache.record_for_config(cfg, node_budget, edge_budget,
                                               device=registry.device)
            if rec is not None:
                tuned_rungs = tune_cache.serve_rungs_from(rec, scfg.max_batch_graphs)
                tuned_buckets = tune_cache.seq_edges_from(rec)
                self.tuned = {
                    "hardware": rec.get("hardware"),
                    "serve_rungs": list(tuned_rungs) if tuned_rungs else None,
                    "seq_buckets": list(tuned_buckets) if tuned_buckets else None,
                }
        self.localizer = None
        if registry.family == "deepdfa":
            self.frontend = RequestPreprocessor(
                cfg, registry.vocabs, cache=shared_cache(scfg.feature_cache_entries))
            self.executor = GgnnExecutor(
                registry.model, node_budget, edge_budget, scfg.max_batch_graphs,
                etypes=cfg.model.n_etypes > 1, device=registry.device, ladder=tuned_rungs,
                feat_width=registry._feat_width())
            if scfg.lines:
                from deepdfa_tpu_torch.serve.localize import GgnnLocalizer

                self.localizer = GgnnLocalizer(
                    registry.model, node_budget, edge_budget, self.executor.sizes,
                    method=scfg.lines_method, n_steps=scfg.lines_steps,
                    top_k=scfg.lines_top_k, etypes=cfg.model.n_etypes > 1,
                    device=registry.device, pipeline_depth=scfg.pipeline_depth,
                    feat_width=registry._feat_width())
        else:
            from deepdfa_tpu_torch.serve.cascade import build_combined_service_parts

            self.frontend, self.executor = build_combined_service_parts(
                registry, cfg, node_budget, edge_budget, seq_buckets=tuned_buckets)
        # the stage-2 stack, its own warm-up included, before this one's
        self.cascade = None
        if scfg.cascade and registry.family == "deepdfa":
            from deepdfa_tpu_torch.serve.cascade import CascadeStage2

            self.cascade = CascadeStage2.from_config(cfg, registry.run_dir,
                                                     device=registry.device)
        self.request_log: RequestLog | None = (
            RequestLog(registry.run_dir / "serve_log.jsonl") if scfg.request_log else None)
        self.batcher = DynamicBatcher(
            self.executor, queue_limit=scfg.queue_limit,
            max_batch_delay_s=scfg.max_batch_delay_ms / 1000.0,
            on_batch=self.registry.maybe_reload if scfg.hot_swap else None,
            pipeline_depth=scfg.pipeline_depth)
        self._status_lock = threading.Lock()
        self.status_counts: collections.Counter = collections.Counter()
        self.warmup_report = self.executor.warmup()
        if self.localizer is not None:
            self.warmup_report.update(self.localizer.warmup())

    def submit_code(self, code: str, request_id: str | None = None, want_feats: bool = False):
        """frontend + enqueue; the caller waits on the returned request
        (with `want_feats`, (request, the cached extraction), which the
        lines path attributes without a second frontend trip). A
        rejection (422, 413, 429) carries its frontend seconds on the
        exception as `frontend_s`."""
        rid = request_id or new_request_id()
        t0 = time.perf_counter()
        try:
            feats = self.frontend.features_full(code)
            req = self.batcher.submit(feats.spec, request_id=rid,
                                      frontend_s=time.perf_counter() - t0)
            return (req, feats) if want_feats else req
        except Exception as e:
            e.frontend_s = time.perf_counter() - t0
            raise

    def attribute_lines(self, feats) -> list[dict]:
        """The ranked [{"line", "score"}] of one extracted function,
        attributed alone (the `{"lines": true}` half of a request);
        FrontendError when the server runs without `serve.lines`."""
        if self.localizer is None:
            raise FrontendError(
                "line attributions are disabled; start the server with serve.lines=true")
        [(_, lines)] = self.localizer.attribute([feats])
        return lines

    def finish_request(self, request_id: str, status: int, latency_s: float | None,
                       req: ScoreRequest | None = None,
                       frontend_s: float | None = None, extra_stages: dict | None = None,
                       log_fields: dict | None = None) -> dict:
        """The one request epilogue (HTTP handler and offline drive): count
        the status, append the serve_log entry, and return the stage
        milliseconds. `extra_stages` carries the cascade's stage seconds
        (cascade_stage1, cascade_stage2), `log_fields` its verdict
        (stage, stage1_prob, ...) for the log entry."""
        stages = {
            "frontend": req.frontend_s if req is not None else frontend_s,
            "queue": req.queue_wait_s if req is not None else None,
            "device": req.device_s if req is not None else None,
            **(extra_stages or {}),
        }
        with self._status_lock:
            self.status_counts[int(status)] += 1
        ms = {f"{k}_ms": 1e3 * v for k, v in stages.items() if v is not None}
        if self.request_log is not None:
            entry = {"id": request_id, "status": int(status), "t_unix": time.time(), **ms}
            if latency_s is not None:
                entry["latency_ms"] = 1e3 * latency_s
            if req is not None and req.batch_size is not None:
                entry["batch_size"] = req.batch_size
            entry.update(log_fields or {})
            self.request_log.append({"request": entry})
        return ms

    def cascade_decide(self, code: str, prob1: float, request_id: str,
                       req: ScoreRequest | None = None):
        """The cascade verdict of one stage-1 score: (final prob, response
        fields, extra stage seconds); cascade_stage1 is the stage-1
        request's latency, cascade_stage2 the escalation's."""
        prob, info, extra = self.cascade.decide(code, prob1, request_id=request_id)
        if req is not None and req.latency_s is not None:
            extra = {"cascade_stage1": req.latency_s, **extra}
        return prob, info, extra

    def healthz(self) -> dict:
        info = self.registry.info()
        info["warmed_signatures"] = [list(s) for s in self.executor.signatures()]
        info["lines"] = self.localizer is not None
        if self.localizer is not None:
            info["lines_method"] = self.localizer.method
        if self.registry.family == "deepdfa":
            mcfg = self.registry.cfg.model
            info["ggnn_kernel"] = mcfg.ggnn_kernel
            if mcfg.ggnn_kernel:
                info.update(ggnn_kernel_accum=mcfg.ggnn_kernel_accum,
                            ggnn_kernel_scatter=mcfg.ggnn_kernel_scatter,
                            ggnn_kernel_unroll=mcfg.ggnn_kernel_unroll)
        if self.tuned is not None:
            info["tuned"] = self.tuned
        if self.cascade is not None:
            info["cascade"] = self.cascade.info()
        return info

    def stats(self) -> dict:
        out = self.batcher.stats()
        cache = self.frontend.cache
        out.update(
            feature_cache_entries=len(cache),
            feature_cache_hits=cache.hits,
            feature_cache_misses=cache.misses,
            frontend=self.frontend.stats(),
            hot_swaps=self.registry.reloads,
        )
        with self._status_lock:
            out["status_counts"] = {str(k): v for k, v in sorted(self.status_counts.items())}
        if self.localizer is not None:
            out["localize"] = self.localizer.stats()
        if self.cascade is not None:
            out["cascade"] = self.cascade.counters()
        return out

    def start(self) -> None:
        if self.cascade is not None:
            self.cascade.start()
        self.batcher.start()

    def close(self) -> None:
        self.batcher.close()
        if self.cascade is not None:
            self.cascade.close()
        if self.request_log is not None:
            self.request_log.close()


def write_serve_log(run_dir, records) -> Path:
    """Append records to <run_dir>/serve_log.jsonl."""
    path = Path(run_dir) / "serve_log.jsonl"
    with path.open("a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return path


def score_texts(service: ScoringService, texts: list[tuple[str, str]],
                timeout_s: float = 120.0) -> list[dict]:
    """Offline scoring of (name, code) pairs through the online path.

    Frontend failures become rows with ok false, never a crash; the
    batcher groups whatever was admitted as live traffic would. Every
    row goes through `finish_request` with the status the HTTP path
    would give it. In cascade mode every stage-1 verdict comes first
    (`CascadeStage2.screen`, as the handler), then the escalated band
    goes through the stage-2 batcher in one `escalate_many`; a failed
    stage-2 pass serves the row's stage-1 score."""
    rows: list[dict] = []
    payloads: list[tuple[dict, Any, str, float, str]] = []
    for name, code in texts:
        rid = new_request_id()
        row = {"name": name, "request_id": rid}
        rows.append(row)  # input order kept
        t0 = time.perf_counter()
        try:
            spec = service.frontend.features(code)
            payloads.append((row, spec, rid, time.perf_counter() - t0, code))
        except (FrontendError, RequestTooLarge) as e:
            status = 422 if isinstance(e, FrontendError) else 413
            row.update(ok=False, error=str(e))
            service.finish_request(rid, status, time.perf_counter() - t0,
                                   frontend_s=time.perf_counter() - t0)
    reqs = service.batcher.score_all(
        [p[1] for p in payloads], request_ids=[p[2] for p in payloads],
        frontend_seconds=[p[3] for p in payloads])
    casc = service.cascade
    escalate: list[tuple[dict, ScoreRequest, str, str, dict]] = []
    for (row, _, rid, _, code), req in zip(payloads, reqs):
        try:
            prob1 = req.wait(timeout_s)
        except Exception as e:  # per-row fault isolation
            row.update(ok=False, error=str(e))
            if isinstance(e, RequestTooLarge):
                status = 413
            elif isinstance(e, TimeoutError):
                status = 504
            else:
                status = 500
            service.finish_request(rid, status, req.latency_s, req=req)
            continue
        if casc is None:
            row.update(ok=True, prob=prob1)
            service.finish_request(rid, 200, req.latency_s, req=req)
            continue
        up, fields = casc.screen(prob1)
        if up:
            escalate.append((row, req, rid, code, fields))
            continue
        row.update(ok=True, prob=prob1, **fields)
        service.finish_request(rid, 200, req.latency_s, req=req,
                               extra_stages={"cascade_stage1": req.latency_s},
                               log_fields=fields)
    if escalate:
        results = casc.escalate_many([e[3] for e in escalate])
        for (row, req, rid, _, fields), (prob2, s2) in zip(escalate, results):
            extra = {"cascade_stage1": req.latency_s}
            if prob2 is None:
                fields["cascade_failed"] = 1
                row.update(ok=True, prob=fields["stage1_prob"], **fields)
            else:
                fields["stage"] = 2
                row.update(ok=True, prob=prob2, **fields)
                extra["cascade_stage2"] = s2
            service.finish_request(rid, 200, req.latency_s, req=req, extra_stages=extra,
                                   log_fields=fields)
    return rows


class _Handler(BaseHTTPRequestHandler):
    service: ScoringService = None  # set by make_server
    request_timeout_s: float = 60.0

    def _reply(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # through logging, not stderr
        logger.debug("http: " + fmt, *args)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = urllib.parse.urlsplit(self.path).path
        if path == "/healthz":
            self._reply(200, self.service.healthz())
        elif path == "/stats":
            self._reply(200, self.service.stats())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        service = self.service
        if self.path != "/score":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        rid = self.headers.get("X-Request-Id") or new_request_id()
        t0 = time.monotonic()
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError(f"body must be a JSON object, got {type(payload).__name__}")
            code = payload["code"]
            if not isinstance(code, str):
                raise ValueError(f"code must be a string, got {type(code).__name__}")
        except (ValueError, KeyError) as e:
            service.finish_request(rid, 400, time.monotonic() - t0)
            self._reply(400, {"error": f"bad request: {e}", "request_id": rid})
            return
        want_lines = bool(payload.get("lines"))
        if want_lines and service.localizer is None:
            # refused before any device work: lines are opted into at
            # server start (serve.lines=true warms the attribution ladder)
            service.finish_request(rid, 400, time.monotonic() - t0)
            self._reply(400, {"error": "line attributions are disabled on this server "
                                       "(start it with serve.lines=true)",
                              "request_id": rid})
            return
        req = None
        fields: dict = {}
        extra = None
        lines = None
        try:
            if want_lines:
                req, feats = service.submit_code(code, request_id=rid, want_feats=True)
            else:
                req = service.submit_code(code, request_id=rid)
            prob = req.wait(self.request_timeout_s)
            if service.cascade is not None:
                prob, fields, extra = service.cascade_decide(code, prob, rid, req=req)
            if want_lines:
                lines = service.attribute_lines(feats)
        except QueueFull as e:
            status, err = 429, e
        except RequestTooLarge as e:
            status, err = 413, e
        except FrontendError as e:
            status, err = 422, e
        except TimeoutError as e:
            status, err = 504, e
        except Exception as e:  # noqa: BLE001 - an executor failure is a 500
            logger.exception("request %s failed", rid)
            status, err = 500, e
        else:
            service.finish_request(rid, 200, time.monotonic() - t0, req=req,
                                   extra_stages=extra, log_fields=fields)
            out = {"ok": True, "prob": prob, "latency_ms": (time.monotonic() - t0) * 1e3,
                   "request_id": rid, **fields}
            if lines is not None:
                out["lines"] = lines
            self._reply(200, out)
            return
        service.finish_request(rid, status, time.monotonic() - t0, req=req,
                               frontend_s=getattr(err, "frontend_s", None))
        self._reply(status, {"error": str(err), "request_id": rid})


class _Server(ThreadingHTTPServer):
    # the listen backlog: clients that open a connection a request (8 in
    # chip_smoke.py's loads) overflow socketserver's default of 5 while
    # the accept thread waits on the GIL (a batch, an attribution), and an
    # overflowed connection can be reset instead of queued
    request_queue_size = 128


def make_server(service: ScoringService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """A bound (not yet serving) HTTP server; port 0 picks a free port
    (server.server_address[1] holds it)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return _Server((host, port), handler)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def serve_forever(service: ScoringService, host: str, port: int) -> None:
    """Serve until interrupted or sent SIGTERM; prints one JSON line
    {"serving": true, "host", "port", **healthz} once it listens."""
    service.start()
    httpd = make_server(service, host, port)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _interrupt)
    print(json.dumps({"serving": True, "host": host, "port": httpd.server_address[1],
                      **service.healthz()}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()


class BackgroundServer:
    """In-process server on a free port (smoke mode and tests)."""

    def __init__(self, service: ScoringService, host: str = "127.0.0.1"):
        self.service = service
        service.start()
        self.httpd = make_server(service, host, 0)
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def request(self, method: str, path: str, payload: Any = None, raw: bytes | None = None):
        """(status, JSON body); `raw` sends those bytes as the body."""
        status, text = self.request_text(method, path, payload, raw)
        return status, json.loads(text or "{}")

    def request_text(self, method: str, path: str, payload: Any = None,
                     raw: bytes | None = None):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port, timeout=60)
        body = raw if raw is not None else (
            json.dumps(payload) if payload is not None else None)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        data = resp.read().decode("utf-8", "replace")
        conn.close()
        return resp.status, data

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)
        self.service.close()
