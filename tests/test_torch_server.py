"""The port's HTTP handler, scoring service and `score`/`serve` commands
(deepdfa_tpu_torch/serve/server.py, driver.py, cli.py) on the CPU.

- through `BackgroundServer`, every status code of the reference's
  handler: 200, 400 (malformed JSON, no `code`), 404 (an unknown route,
  `/metrics` among them), 413 (over the serve budgets), 422
  (unparseable), 429 (queue full), 500 (executor failure) and 504
  (not answered in time), with `/healthz` and `/stats`;
- the combined family scores C sources through the same service as
  `score_combined` scores the same model on the same payloads (fp32
  rtol 1e-5, atol 1e-6);
- the serving options the port does not run are refused by name,
  `serve.lines` is served, and cascade mode (`serve.cascade=true`)
  answers through the handler with the stage fields, `/healthz` and
  `/stats` sections and the request log's verdicts;
- `cli score --device cpu`, `cli serve --smoke --device cpu` and `cli
  serve --port 0` end to end in subprocesses under a temporary storage
  root.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.core import paths  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.serve.registry import ModelRegistry  # noqa: E402
from deepdfa_tpu_torch.serve.server import BackgroundServer, ScoringService, score_texts  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
NODE_BUDGET = 64
OVERRIDES = ['data.feat={"limit_all": 50, "limit_subkeys": 50}', "model.hidden_dim=8",
             "model.n_steps=2", 'data.dataset="http"', 'run_name="http"',
             "serve.max_batch_graphs=4", f"serve.node_budget={NODE_BUDGET}",
             "serve.edge_budget=512"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(cfg, run_dir, functions that fit the budgets, one that does not)
    under a storage root of this module's."""
    root = tmp_path_factory.mktemp("storage")
    saved = os.environ.get("DEEPDFA_TPU_STORAGE")
    os.environ["DEEPDFA_TPU_STORAGE"] = str(root)
    try:
        cfg = config_mod.apply_overrides(config_mod.Config(), OVERRIDES)
        examples = synthetic.to_examples(synthetic.generate(32, seed=11))
        specs, vocabs = pipeline.build_dataset(examples, train_ids=range(32), limit_all=50,
                                               limit_subkeys=50)
        (paths.processed_dir("http") / f"vocab{cfg.data.feat.name}.json").write_text(
            json.dumps({k: v.to_json() for k, v in vocabs.items()}))
        run_dir = paths.runs_dir("http")
        config_mod.to_json(cfg, run_dir / "config.json")
        model = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim)
        model.reset_parameters(torch.Generator().manual_seed(3))
        CheckpointManager(run_dir / "checkpoints-torch").save(
            "epoch-0001", {"model": model.state_dict()}, {"val_loss": 1.0}, step=1)
        nodes = {s.graph_id: s.num_nodes for s in specs}
        small = [e.code for e in examples if nodes[e.id] <= NODE_BUDGET]
        big = next(e.code for e in examples if nodes[e.id] > NODE_BUDGET)
        assert len(small) >= 6
        yield cfg, run_dir, small, big
    finally:
        if saved is None:
            os.environ.pop("DEEPDFA_TPU_STORAGE", None)
        else:
            os.environ["DEEPDFA_TPU_STORAGE"] = saved


def _server(run, *extra):
    cfg, run_dir, _, _ = run
    cfg = config_mod.apply_overrides(cfg, list(extra))
    return BackgroundServer(ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg))


def test_handler_answers_the_reference_status_codes(run):
    _, _, small, big = run
    server = _server(run)
    try:
        got = [server.request("POST", "/score", {"code": c}) for c in small[:6]]
        assert all(st == 200 and body["ok"] and 0 < body["prob"] < 1 for st, body in got)
        # a repeat is a cache hit with the same score
        st, again = server.request("POST", "/score", {"code": small[0]})
        assert st == 200 and again["prob"] == got[0][1]["prob"]
        assert server.request("POST", "/score", raw=b"{not json")[0] == 400
        assert server.request("POST", "/score", {"text": small[0]})[0] == 400
        assert server.request("POST", "/score", ["a list"])[0] == 400
        assert server.request("POST", "/score", {"code": 7})[0] == 400
        assert server.request("POST", "/other", {"code": small[0]})[0] == 404
        assert server.request("GET", "/metrics")[0] == 404
        st, body = server.request("POST", "/score", {"code": big})
        assert st == 413 and "serving budgets" in body["error"]
        st, body = server.request("POST", "/score", {"code": "not a function @@@"})
        assert st == 422 and body["request_id"]
        st, health = server.request("GET", "/healthz?deep=1")
        assert st == 200 and health["checkpoint"] == "best" and health["checkpoint_step"] == 1
        assert health["config_digest"] and health["warmed_signatures"] == [[1], [2], [4]]
        st, stats = server.request("GET", "/stats")
        assert st == 200 and stats["feature_cache_hits"] >= 1
        assert stats["status_counts"] == {"200": 7, "400": 4, "413": 1, "422": 1}
        assert stats["frontend"]["failures"] == 1 and stats["batches"] >= 2
    finally:
        server.close()


def test_handler_answers_429_500_and_504(run, monkeypatch):
    _, _, small, _ = run
    server = _server(run, "serve.queue_limit=0")
    try:
        st, body = server.request("POST", "/score", {"code": small[0]})
        assert st == 429 and "queue at limit" in body["error"]
    finally:
        server.close()
    server = _server(run)
    try:
        def broken(key, packed):
            raise RuntimeError("device lost")

        monkeypatch.setattr(server.service.executor, "dispatch", broken)
        st, body = server.request("POST", "/score", {"code": small[0]})
        assert st == 500 and "device lost" in body["error"]
        dispatch = type(server.service.executor).dispatch

        def slow(key, packed):
            time.sleep(0.5)
            return dispatch(server.service.executor, key, packed)

        monkeypatch.setattr(server.service.executor, "dispatch", slow)
        monkeypatch.setattr(server.httpd.RequestHandlerClass, "request_timeout_s", 0.05)
        st, body = server.request("POST", "/score", {"code": small[1]})
        assert st == 504 and "not scored" in body["error"]
        counts = server.request("GET", "/stats")[1]["status_counts"]
        assert counts == {"500": 1, "504": 1}
    finally:
        server.close()


def test_request_log_and_hot_swap_through_the_service(run):
    import shutil

    cfg, http_run, small, _ = run
    run_dir = paths.runs_dir("http-swap")  # a copy: the other tests keep step 1
    shutil.copytree(http_run, run_dir, dirs_exist_ok=True)
    cfg = config_mod.apply_overrides(cfg, ["serve.request_log=true", "serve.hot_swap=true"])
    log = run_dir / "serve_log.jsonl"
    log.unlink(missing_ok=True)
    registry = ModelRegistry(run_dir, cfg=cfg, device="cpu")
    service = ScoringService(registry, cfg)
    try:
        [before] = score_texts(service, [("a.c", small[0])])
        state = {k: v + 0.1 if v.is_floating_point() else v
                 for k, v in registry.params().items()}
        CheckpointManager(run_dir / "checkpoints-torch").save(
            "epoch-0002", {"model": state}, {"val_loss": 0.5}, step=2)
        [after] = score_texts(service, [("a.c", small[0])])
        assert registry.reloads == 1 and after["prob"] != before["prob"]
        assert service.healthz()["checkpoint_step"] == 2
    finally:
        service.close()
    entries = [json.loads(x)["request"] for x in log.read_text().splitlines()]
    assert [e["status"] for e in entries] == [200, 200]
    assert all(e["frontend_ms"] >= 0 and e["batch_size"] == 1 for e in entries)


@pytest.mark.parametrize("override, item", [("serve.use_joern=true", "item 3")])
def test_unported_serving_options_are_refused(run, override, item):
    cfg, run_dir, _, _ = run
    bad = config_mod.apply_overrides(cfg, [override])
    with pytest.raises(NotImplementedError, match=item):
        ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), bad)


def test_serve_lines_is_accepted_and_served(run):
    """`serve.lines=true`, refused before line attributions were ported,
    builds and warms a localizer on the scoring ladder: scores are the
    plain service's, each function's lines come back ranked, and a
    service without the option refuses to attribute."""
    from deepdfa_tpu_torch.serve.frontend import FrontendError

    cfg, run_dir, small, _ = run
    lcfg = config_mod.apply_overrides(cfg, ["serve.lines=true", "serve.lines_top_k=2"])
    service = ScoringService(ModelRegistry(run_dir, cfg=lcfg, device="cpu"), lcfg)
    plain = ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg)
    try:
        assert service.localizer.sizes == service.executor.sizes
        assert {f"L{s}" for s in service.executor.sizes} <= set(service.warmup_report)
        texts = list(enumerate(small[:4]))
        assert [r["prob"] for r in score_texts(service, texts)] == \
            [r["prob"] for r in score_texts(plain, texts)]
        for code in small[:4]:
            lines = service.attribute_lines(service.frontend.features_full(code))
            assert 0 < len(lines) <= 2 and lines[0]["score"] >= lines[-1]["score"]
        with pytest.raises(FrontendError, match="serve.lines=true"):
            plain.attribute_lines(plain.frontend.features_full(small[0]))
        assert service.healthz()["lines_method"] == "saliency"
    finally:
        service.close()
        plain.close()


def test_cascade_mode_answers_through_the_handler(run, tmp_path):
    """`serve.cascade=true` over a stage-2 combined run: each 200 carries
    its stage, stage-1 and calibrated probabilities; the band decides
    the stage; an escalated request gets the stage-2 model's own score
    and a screened one the GGNN's; the counters add up in `/stats` and
    `/healthz`; the request log carries each verdict."""
    from deepdfa_tpu_torch.serve.cascade import build_stage2_smoke

    cfg, run_dir, small, _ = run
    stage2 = tmp_path / "stage2"
    stage2.mkdir()
    # the stage-2 run's own config: its serve budgets hold a text batch's
    # (empty) graph rows
    s2cfg = config_mod.apply_overrides(cfg, ["serve.node_budget=2048", "serve.edge_budget=8192"])
    config_mod.to_json(s2cfg, stage2 / "config.json")
    build_stage2_smoke(stage2, s2cfg, family="combined")
    codes = small[:8]
    plain = ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg)
    try:
        p1 = {r["name"]: r["prob"] for r in score_texts(plain, list(enumerate(codes)))}
    finally:
        plain.close()
    cut = float(np.median(list(p1.values())))  # about half of them escalate
    ccfg = config_mod.apply_overrides(cfg, [
        "serve.cascade=true", f"serve.cascade_band=[0.0, {cut}]",
        f'serve.cascade_run_dir="{stage2}"', "serve.request_log=true"])
    log = run_dir / "serve_log.jsonl"
    log.unlink(missing_ok=True)
    server = BackgroundServer(ScoringService(ModelRegistry(run_dir, cfg=ccfg, device="cpu"),
                                             ccfg))
    try:
        got = [server.request("POST", "/score", {"code": c}) for c in codes]
        stats = server.request("GET", "/stats")[1]
        health = server.request("GET", "/healthz")[1]
    finally:
        server.close()
    s2 = ScoringService(ModelRegistry(stage2, family="combined", cfg=s2cfg, device="cpu"), s2cfg)
    try:
        alone = {r["name"]: r["prob"] for r in score_texts(s2, list(enumerate(codes)))}
    finally:
        s2.close()
    assert all(st == 200 for st, _ in got)
    for i, (_, body) in enumerate(got):
        assert body["stage1_prob"] == p1[i]
        assert body["stage"] == (2 if p1[i] < cut else 1)
        assert body["prob"] == (alone[i] if body["stage"] == 2 else p1[i])
    n2 = sum(body["stage"] == 2 for _, body in got)
    assert 0 < n2 < len(codes)
    counts = stats["cascade"]
    assert counts["requests"] == len(codes) and counts["escalations"] == n2
    assert counts["sheds"] == counts["failures"] == 0
    assert health["cascade"]["band"] == [0.0, cut] and health["cascade"]["stage2_family"] == \
        "combined" and health["cascade"]["requests"] == len(codes)
    entries = [json.loads(x)["request"] for x in log.read_text().splitlines()]
    assert [e["stage"] for e in entries] == [body["stage"] for _, body in got]
    assert all("cascade_stage1_ms" in e for e in entries)
    assert sum("cascade_stage2_ms" in e for e in entries) == n2


def test_pipelined_service_scores_as_serial(run):
    """`serve.pipeline_depth=2` (refused before the pipelined batcher and
    localizer were ported): the service's scores and line attributions
    are the serial service's bits, its `/stats` carry the pipeline's
    counters, and a started pipelined server answers as the serial one."""
    cfg, run_dir, small, _ = run
    # no flush timer offline: both services form the same batches
    lines = ["serve.lines=true", "serve.lines_top_k=0", "serve.max_batch_delay_ms=3600000"]
    serial_cfg = config_mod.apply_overrides(cfg, lines)
    piped_cfg = config_mod.apply_overrides(cfg, lines + ["serve.pipeline_depth=2"])
    serial = ScoringService(ModelRegistry(run_dir, cfg=serial_cfg, device="cpu"), serial_cfg)
    piped = ScoringService(ModelRegistry(run_dir, cfg=piped_cfg, device="cpu"), piped_cfg)
    try:
        names = [(f"f{i}.c", c) for i, c in enumerate(small)]
        want, got = score_texts(serial, names), score_texts(piped, names)
        assert [r["prob"] for r in got] == [r["prob"] for r in want]
        feats = [piped.frontend.features_full(c) for c in small]
        assert piped.localizer.pipeline_depth == 2
        assert piped.localizer.attribute_all(feats) == serial.localizer.attribute_all(feats)
        stats = piped.stats()
        assert stats["pipeline_depth"] == 2 and stats["pipeline_in_flight"] == 0
        assert 1 <= stats["pipeline_in_flight_peak"] <= 2
        assert stats["batches"] == serial.stats()["batches"]
        assert stats["pipeline_device_busy_s"] > 0
    finally:
        serial.close()
        piped.close()
    server = _server(run, "serve.pipeline_depth=2")
    try:
        got = [server.request("POST", "/score", {"code": c}) for c in small[:4]]
        assert all(st == 200 for st, _ in got)
        np.testing.assert_allclose([b["prob"] for _, b in got],
                                   [r["prob"] for r in want[:4]], rtol=RTOL, atol=ATOL)
        assert server.request("GET", "/stats")[1]["pipeline_depth"] == 2
    finally:
        server.close()


def test_a_quantized_checkpoint_tag_is_refused(run):
    """A `tag@int8` entry (refused outright before serve/quant.py was
    ported) is refused only past `serve.quant_drift_bound`, loudly, naming
    tensors; within it, the registry serves the quantized tree (int8
    weights, fp32 scales, bf16 vectors), reports its drift and bytes
    fraction on `/healthz`, and scores within the drift bound of the fp32
    entry."""
    from deepdfa_tpu_torch.serve import quant
    from deepdfa_tpu_torch.serve.registry import RegistryError

    cfg, run_dir, small, _ = run
    tight = config_mod.apply_overrides(cfg, ["serve.quant_drift_bound=1e-12"])
    with pytest.raises(RegistryError, match="quant_drift_bound") as err:
        ModelRegistry(run_dir, checkpoint="best@int8", cfg=tight, device="cpu")
    assert "ggnn." in str(err.value) or "embedding." in str(err.value)
    registry = ModelRegistry(run_dir, checkpoint="best@int8", cfg=cfg, device="cpu")
    assert isinstance(registry.model(), quant.QuantizedModel)
    qtree = registry.params()
    assert qtree["ggnn.gru.input_kernel"]["int8"].dtype == torch.int8
    assert qtree["ggnn.gru.input_bias"].dtype == torch.bfloat16
    info = registry.info()
    assert info["checkpoint"] == "best@int8" and info["quantized"] == "int8"
    assert 0 <= info["quant_drift"] <= info["quant_drift_bound"] == 5e-2
    assert 0.25 < info["quant_param_bytes_fraction"] < 0.5
    service = ScoringService(registry, cfg)
    plain = ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg)
    try:
        names = [(f"f{i}.c", c) for i, c in enumerate(small)]
        got = [r["prob"] for r in score_texts(service, names)]
        want = [r["prob"] for r in score_texts(plain, names)]
        assert got != want
        np.testing.assert_allclose(got, want, atol=5e-2)
        assert service.healthz()["quant_drift"] == info["quant_drift"]
    finally:
        service.close()
        plain.close()


def test_combined_family_scores_sources_as_score_combined(run):
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, CombinedModel, TransformerConfig
    from deepdfa_tpu_torch.serve import score_combined
    from deepdfa_tpu_torch.serve.cascade import save_model_setup
    from deepdfa_tpu_torch.serve.frontend import FrontendError, RequestPreprocessor

    _, _, small, _ = run
    cfg = config_mod.apply_overrides(run[0], [
        'run_name="comb"', "data.seq_buckets=[16,32,64]", "data.token_budget=256",
        "serve.node_budget=2048", "serve.edge_budget=8192"])
    run_dir = paths.runs_dir("comb")
    config_mod.to_json(cfg, run_dir / "config.json")
    mcfg = CombinedConfig(encoder=TransformerConfig.tiny(vocab_size=512), graph_hidden_dim=8,
                          graph_input_dim=cfg.data.feat.input_dim)
    model = CombinedModel(mcfg, generator=torch.Generator().manual_seed(5)).eval()
    save_model_setup(run_dir, "combined", mcfg,
                     {"kind": "hash", "vocab_size": 512, "t5_frame": False}, 64)
    CheckpointManager(run_dir / "checkpoints-combined-torch").save(
        "epoch-0000", {"model": model.state_dict()}, {"val_loss": 0.5}, step=1)
    registry = ModelRegistry(run_dir, family="combined", cfg=cfg, device="cpu")
    service = ScoringService(registry, cfg)
    texts = small[:8] + ["not a function @@@"]
    try:
        rows = score_texts(service, [(f"f{i}.c", t) for i, t in enumerate(texts)])
        assert service.healthz()["warmed_signatures"] == [[16, 16, 16], [32, 8, 8], [64, 4, 4]]
    finally:
        service.close()
    assert all(r["ok"] for r in rows)  # an unparseable function scores text-only
    fe = RequestPreprocessor(cfg, registry.vocabs)

    def spec(t):
        try:
            return fe.features(t)
        except FrontendError:
            return None

    want = score_combined(model, [(t, spec(t)) for t in texts], cfg, HashTokenizer(512),
                          device="cpu")["probs"]
    np.testing.assert_allclose([r["prob"] for r in rows], want, rtol=RTOL, atol=ATOL)


# -- the commands, in subprocesses -------------------------------------------------


def _cli(storage, *argv, timeout=300):
    env = dict(os.environ, DEEPDFA_TPU_STORAGE=str(storage))
    res = subprocess.run([sys.executable, "-m", "deepdfa_tpu_torch.cli", *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_cli_score_smoke_then_score_a_directory(tmp_path):
    smoke = _cli(tmp_path, "score", "--smoke", "--device", "cpu")
    assert smoke["serve_scored"] == 24 and smoke["device"] == "cpu"
    run_dir = tmp_path / "runs" / "serve-smoke"
    first = [json.loads(x) for x in (run_dir / "scores.jsonl").read_text().splitlines()]
    (run_dir / "smoke_src" / "zz_bad.c").write_text("not a function @@@")
    out = tmp_path / "again.jsonl"
    summary = _cli(tmp_path, "score", str(run_dir / "smoke_src"), "--out", str(out),
                   "--device", "cpu", "--override", 'run_name="serve-smoke"')
    assert summary["serve_scored"] == 24 and summary["serve_failed_requests"] == 1
    assert summary["ggnn_step_launches"] == 0  # the plain path launches no kernel
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["name"] for r in rows[:24]] == [r["name"] for r in first]
    np.testing.assert_allclose([r["prob"] for r in rows[:24]], [r["prob"] for r in first],
                               rtol=RTOL, atol=ATOL)
    assert rows[24]["ok"] is False and rows[24]["name"].endswith("zz_bad.c")
    log = [json.loads(x) for x in (run_dir / "serve_log.jsonl").read_text().splitlines()]
    assert log[-1]["serve_scored"] == 24 and log[-1]["serve"]["status_counts"]["422"] == 1


def test_cli_serve_smoke(tmp_path):
    report = _cli(tmp_path, "serve", "--smoke", "--device", "cpu")
    assert [s["status"] for s in report["scored"]] == [200] * 6
    assert (report["reject_status"], report["bad_json_status"], report["no_code_status"],
            report["unknown_route_status"]) == (422, 400, 400, 404)
    assert report["healthz"]["checkpoint_step"] is not None


def test_cli_serve_on_a_free_port_until_sigterm(tmp_path):
    import http.client

    _cli(tmp_path, "score", "--smoke", "--device", "cpu")
    env = dict(os.environ, DEEPDFA_TPU_STORAGE=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve", "--port", "0", "--device",
         "cpu", "--override", 'run_name="serve-smoke"'],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        hello = json.loads(proc.stdout.readline())
        assert hello["serving"] and hello["port"] > 0 and hello["checkpoint"] == "best"
        code = (tmp_path / "runs" / "serve-smoke" / "smoke_src" / "fn_0000.c").read_text()
        conn = http.client.HTTPConnection("127.0.0.1", hello["port"], timeout=60)
        conn.request("POST", "/score", body=json.dumps({"code": code}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and 0 < body["prob"] < 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
