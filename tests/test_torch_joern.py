"""The Joern route of the port (deepdfa_tpu_torch/frontend/joern_io.py,
joern_session.py, serve/frontend.py:SessionPool and the `use_joern`
preprocessor, testing/joern_stub.py) against the reference, on the CPU.

- `load_joern_cpg` on the five hand-built exports of
  tests/joern_fixtures.py and on an export with filtered labels, edge
  types and malformed fields gives the reference's Cpg node for node and
  edge for edge; `load_joern_dataflow` the reference's sets;
- the port's copy of the five exports (testing/joern_stub.py) is the
  fixtures' bytes;
- the session protocol against echo, wedge and EOF stubs (marker
  framing, per-command deadline with the wedged process killed, one
  restart replaying the last importCode, EOF), the export commands and
  the port's stub REPL; every command waits 1-2 s at most;
- the session pool's reuse, discard, wake-up and close, step for step
  with the reference's;
- `RequestPreprocessor(use_joern=True)` over a pool of stub sessions
  gives the reference's GraphSpec, node lines and cache key; an unknown
  source is a counted, cached failure; without `joern` on PATH both
  packages raise the same FrontendError.

Every session and pool is closed in its fixture's teardown: a stub left
running would outlive the test worker.
"""

import json
import os
import stat
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.core import config as ref_config  # noqa: E402
from deepdfa_tpu.data import pipeline as ref_pipeline  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.frontend import joern_io as ref_joern_io  # noqa: E402
from deepdfa_tpu.frontend import joern_session as ref_joern_session  # noqa: E402
from deepdfa_tpu.serve import frontend as ref_frontend  # noqa: E402

from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.frontend import joern_io, joern_session  # noqa: E402
from deepdfa_tpu_torch.frontend.joern_session import JoernSession, JoernTimeout  # noqa: E402
from deepdfa_tpu_torch.serve import frontend  # noqa: E402
from deepdfa_tpu_torch.testing import joern_stub  # noqa: E402

from joern_fixtures import BUILDERS, SOURCES  # noqa: E402

NAMES = sorted(BUILDERS)
OVERRIDES = ['data.feat={"limit_all": 50, "limit_subkeys": 50}', 'data.dataset="joern"',
             'run_name="joern"']


def _stub(tmp_path, body: str, name: str = "joern-stub") -> str:
    """A marker-echoing stand-in for the joern REPL (it leaves on `:exit`,
    as Joern does)."""
    path = tmp_path / name
    path.write_text("#!" + sys.executable + "\n" + textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


ECHO_STUB = """
import sys
for line in sys.stdin:
    line = line.strip()
    if line == ":exit":
        break
    if line.startswith('println("'):
        print(line.split('"')[1], flush=True)
    else:
        print("echo: " + line, flush=True)
"""

WEDGE_STUB = """
import sys, time
n = 0
for line in sys.stdin:
    line = line.strip()
    if line == ":exit":
        break
    if line.startswith('println("'):
        n += 1
        if n > 1:
            time.sleep(3600)  # wedge after the readiness handshake
        print(line.split('"')[1], flush=True)
    else:
        print("echo: " + line, flush=True)
"""

RESTART_STUB = """
import sys, time, pathlib
flag = pathlib.Path(r'%s')
first = not flag.exists()
if first:
    flag.touch()
n = 0
for line in sys.stdin:
    line = line.strip()
    if line == ":exit":
        break
    if line.startswith('println("'):
        n += 1
        if first and n > 1:
            time.sleep(3600)  # the first process wedges after its handshake
        print(line.split('"')[1], flush=True)
    else:
        print("echo: " + line, flush=True)
"""


@pytest.fixture
def sessions():
    """Opens sessions through `open(...)` and closes every one at teardown."""
    opened = []

    def open_session(*args, **kwargs):
        s = JoernSession(*args, **kwargs)
        opened.append(s)
        return s

    yield open_session
    for s in opened:
        s.close()


def _nodes(cpg):
    return [(n.id, n.label, n.name, n.code, n.line, n.order, n.type_full_name)
            for n in cpg.nodes]


def _assert_same_cpg(got, want):
    assert _nodes(got) == _nodes(want)
    assert got.edges == want.edges
    assert (got.method_id, got.method_return_id, got.method_name) == (
        want.method_id, want.method_return_id, want.method_name)
    assert got.cfg_nodes() == want.cfg_nodes()


# -- the importer ----------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_load_joern_cpg_equals_reference(tmp_path, name):
    prefix = BUILDERS[name](tmp_path)
    _assert_same_cpg(joern_io.load_joern_cpg(prefix), ref_joern_io.load_joern_cpg(prefix))


def test_load_joern_cpg_filters_and_malformed_fields_as_reference(tmp_path):
    """COMMENT/FILE nodes and CONTAINS/SOURCE_FILE/DOMINATE/POST_DOMINATE
    edges dropped, `<empty>` code falling back to the name, unparseable
    line numbers and orders, a missing typeFullName, edges to dropped or
    unknown nodes: all as the reference reads them."""
    nodes = [
        {"id": 1000100, "_label": "METHOD", "name": "f", "code": "f", "lineNumber": 1},
        {"id": 1000101, "_label": "COMMENT", "code": "// x", "lineNumber": 1},
        {"id": 1000102, "_label": "FILE", "name": "f.c"},
        {"id": 1000103, "_label": "CALL", "name": "<operator>.assignment",
         "code": "<empty>", "lineNumber": "2", "order": "x"},
        {"id": 1000104, "_label": "IDENTIFIER", "name": "x", "code": "", "lineNumber": "",
         "order": 3, "typeFullName": "int"},
        {"id": 1000105, "_label": "LITERAL", "code": "1", "lineNumber": "two"},
        {"id": 1000106, "_label": "METHOD_RETURN", "name": "RET", "code": "RET",
         "lineNumber": 1, "order": None},
        {"id": 1000107, "_label": "METHOD", "name": "g", "code": "g", "lineNumber": 9},
    ]
    edges = [
        [1000103, 1000100, "AST", ""], [1000104, 1000103, "ARGUMENT", ""],
        [1000105, 1000103, "ARGUMENT", ""], [1000103, 1000100, "CFG", ""],
        [1000106, 1000103, "CFG", ""], [1000103, 1000100, "CONTAINS", ""],
        [1000106, 1000100, "DOMINATE", ""], [1000100, 1000106, "POST_DOMINATE", ""],
        [1000102, 1000100, "SOURCE_FILE", ""], [1000101, 1000100, "AST", ""],
        [99, 1000100, "CFG", ""], ["bad", 1000100, "CFG", ""],
    ]
    (tmp_path / "m.c.nodes.json").write_text(json.dumps(nodes))
    (tmp_path / "m.c.edges.json").write_text(json.dumps(edges))
    prefix = tmp_path / "m.c"
    got, want = joern_io.load_joern_cpg(prefix), ref_joern_io.load_joern_cpg(prefix)
    _assert_same_cpg(got, want)
    assert len(got.nodes) == 6 and len(got.edges) == 5


def test_load_joern_dataflow_equals_reference(tmp_path):
    rng = np.random.default_rng(3)
    raw = {}
    for m in range(4):
        sol = {}
        for kind in ("in", "out"):
            sol[kind] = {}
            for j in range(6):
                nid = int(1000100 + rng.integers(0, 400))
                key = str(nid) if j % 2 else f"Call[label=CALL; id={nid}]"
                sol[kind][key] = sorted(int(x) for x in rng.integers(0, 9, size=j))
        raw[f"ns::fn{m}(int)"] = sol
    raw["empty"] = {}
    path = tmp_path / "f.c.dataflow.json"
    path.write_text(json.dumps(raw))
    assert joern_io.load_joern_dataflow(path) == ref_joern_io.load_joern_dataflow(path)
    path.write_text(json.dumps({"m": {"in": {"Call[label=CALL]": [1]}}}))
    with pytest.raises(ValueError, match="unparseable"):
        ref_joern_io.load_joern_dataflow(path)
    with pytest.raises(ValueError, match="unparseable"):
        joern_io.load_joern_dataflow(path)


@pytest.mark.parametrize("name", NAMES)
def test_stub_exports_are_the_fixtures_bytes(tmp_path, name):
    assert joern_stub.SOURCES[name] == SOURCES[name]
    prefix = BUILDERS[name](tmp_path)
    ours = joern_stub.exports()[name]
    for suffix, text in zip((".nodes.json", ".edges.json"), ours):
        assert text.encode() == (tmp_path / (os.path.basename(prefix) + suffix)).read_bytes()
    (tmp_path / "port").mkdir()
    mine = joern_stub.BUILDERS[name](tmp_path / "port")
    assert mine == str(tmp_path / "port" / os.path.basename(prefix))


# -- the session -------------------------------------------------------------


def test_protocol_roundtrip(tmp_path, sessions):
    s = sessions(binary=_stub(tmp_path, ECHO_STUB), timeout=2)
    assert "echo: cpg.method.name.l" in s.run_command("cpg.method.name.l")
    assert "echo: 2 + 2" in s.run_command("2 + 2")


def test_timeout_raises_and_kills(tmp_path, sessions):
    s = sessions(binary=_stub(tmp_path, WEDGE_STUB), timeout=2, max_restarts=0)
    t0 = time.monotonic()
    with pytest.raises(JoernTimeout):
        s.run_command("anything", timeout=1)
    assert time.monotonic() - t0 < 5
    assert s.proc.poll() is not None  # the wedged process was killed
    assert s.restarts == 0


def test_eof_detected(tmp_path, sessions):
    s = sessions(binary=_stub(tmp_path, ECHO_STUB), timeout=2)
    s.proc.stdin.close()
    s.proc.wait(timeout=5)
    with pytest.raises((RuntimeError, ValueError)):
        s.run_command("after eof")


def test_timeout_restarts_once_replaying_the_import(tmp_path, sessions):
    """The first process wedges on the command; the session kills it,
    starts another, replays the last importCode and retries the command
    once: one restart, the command answered."""
    flag = tmp_path / "first-run-marker"
    s = sessions(binary=_stub(tmp_path, RESTART_STUB % str(flag)), timeout=2)
    sent = []
    exchange = s._exchange

    def spy(cmd, timeout=None):
        sent.append(cmd)
        return exchange(cmd, timeout)

    s._exchange = spy
    s._last_import = "/src/f.c"  # as if import_code had run
    out = s.run_command("cpg.method.name.l", timeout=1)
    assert "echo: cpg.method.name.l" in out and s.restarts == 1
    # the command, the new process's handshake, the replayed import, the retry
    assert sent == ["cpg.method.name.l", "1 + 1", 'importCode("/src/f.c")',
                    "cpg.method.name.l"]
    # a second hang exceeds the restart budget and propagates
    s2 = sessions(binary=_stub(tmp_path, WEDGE_STUB, "wedge"), timeout=2)
    s2.max_restarts = 1
    with pytest.raises(JoernTimeout):
        s2.run_command("again", timeout=1)
    assert s2.restarts == 1


def test_export_commands_send_the_reference_scripts(tmp_path, sessions):
    s = sessions(binary=_stub(tmp_path, ECHO_STUB), timeout=2)
    sent = []
    exchange = s._exchange
    s._exchange = lambda cmd, timeout=None: sent.append(cmd) or exchange(cmd, timeout)
    src = tmp_path / "f.c"
    assert s.export_cpg_json(src) == (tmp_path / "f.c.nodes.json", tmp_path / "f.c.edges.json")
    assert s.export_dataflow_json(src) == tmp_path / "f.c.dataflow.json"
    assert joern_session._EXPORT_TEMPLATE == ref_joern_session._EXPORT_TEMPLATE
    assert joern_session._DATAFLOW_TEMPLATE == ref_joern_session._DATAFLOW_TEMPLATE
    assert sent == [
        ref_joern_session._EXPORT_TEMPLATE.format(nodes_out=f"{src}.nodes.json",
                                                  edges_out=f"{src}.edges.json"),
        ref_joern_session._DATAFLOW_TEMPLATE.format(out=f"{src}.dataflow.json")]
    s.import_code(src)
    assert s._last_import == str(src)


def test_export_cpg_bin(tmp_path, sessions):
    s = sessions(binary=_stub(tmp_path, ECHO_STUB), timeout=2)
    with pytest.raises(RuntimeError, match="cpg.bin"):
        s.export_cpg_bin(tmp_path / "f.c")
    for name in ("a.c", "z.c"):
        proj = s.workspace / "workspace" / name
        proj.mkdir(parents=True)
        (proj / "cpg.bin").write_bytes(name.encode())
        time.sleep(0.01)
    # the project matching the source wins over the newest one
    assert s.export_cpg_bin(tmp_path / "a.c").read_bytes() == b"a.c"
    other = s.workspace / "elsewhere" / "b.c-project"
    other.mkdir(parents=True)
    (other / "cpg.bin").write_bytes(b"b")
    assert s.export_cpg_bin(tmp_path / "b.c").read_bytes() == b"b"


def test_available_and_refusal_without_a_binary(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert joern_session.available() is ref_joern_session.available() is False
    with pytest.raises(RuntimeError, match="joern binary not on PATH"):
        JoernSession()
    joern_stub.write_stub(tmp_path)
    assert joern_session.available() is ref_joern_session.available() is True


@pytest.mark.parametrize("name", NAMES)
def test_stub_repl_exports_the_fixture(tmp_path, sessions, name):
    """The port's stub REPL: importCode + export writes the fixture export
    for the imported source, loadable as the reference's Cpg."""
    s = sessions(binary=str(joern_stub.write_stub(tmp_path / "bin")), timeout=2)
    src = tmp_path / "request.c"
    src.write_text(SOURCES[name])
    s.import_code(src)
    s.export_cpg_json(src)
    (tmp_path / "ref").mkdir()
    _assert_same_cpg(joern_io.load_joern_cpg(src),
                     ref_joern_io.load_joern_cpg(BUILDERS[name](tmp_path / "ref")))
    unknown = tmp_path / "other.c"
    unknown.write_text("int h(void) { return 0; }\n")
    s.import_code(unknown)
    s.export_cpg_json(unknown)
    assert not (tmp_path / "other.c.nodes.json").exists()


def test_stub_repl_wedges_once_with_a_flag(tmp_path, sessions):
    """write_stub(wedge_flag=...): the first process wedges after its
    handshake; the restarted one exports."""
    stub = joern_stub.write_stub(tmp_path / "bin", wedge_flag=tmp_path / "flag")
    s = sessions(binary=str(stub), timeout=1)
    src = tmp_path / "request.c"
    src.write_text(SOURCES["if_else"])
    s.import_code(src)
    s.export_cpg_json(src)
    assert s.restarts == 1
    assert joern_io.load_joern_cpg(src).method_name == "g"


# -- the pool ----------------------------------------------------------------


def _pool_trace(mod):
    """The reference test's scenario, step by step: (reused, replaced,
    fresh after a discard, all closed)."""
    created = []

    class FakeSession:
        def __init__(self, i):
            self.i = i
            self.closed = False

        def close(self):
            self.closed = True

    pool = mod.SessionPool(lambda i: created.append(FakeSession(i)) or created[-1], size=2)
    with pool.session() as a:
        pass
    with pool.session() as b:
        reused = b is a
    with pytest.raises(RuntimeError):
        with pool.session():
            raise RuntimeError("jvm died")
    first_closed, replaced = created[0].closed, pool.replaced
    with pool.session() as d:
        fresh = d is not created[0]
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.session().__enter__()
    return (reused, first_closed, replaced, fresh, [s.i for s in created],
            all(s.closed for s in created))


def test_session_pool_matches_reference():
    assert _pool_trace(frontend) == _pool_trace(ref_frontend) == (
        True, True, 1, True, [0, 1], True)


def test_session_pool_discard_wakes_waiter_and_factory_failure_frees_capacity():
    class FakeSession:
        def close(self):
            pass

    pool = frontend.SessionPool(lambda i: FakeSession(), size=1)
    try:
        lease = pool.session()
        held = lease.__enter__()
        got = []

        def waiter():
            with pool.session() as s:
                got.append(s)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.1)
        assert not got  # blocked: the pool is exhausted
        lease.__exit__(RuntimeError, RuntimeError("jvm died"), None)
        t.join(timeout=5)
        assert got and got[0] is not held
    finally:
        pool.close()
    calls = []

    def flaky(i):
        calls.append(i)
        if len(calls) == 1:
            raise OSError("spawn failed")
        return FakeSession()

    pool = frontend.SessionPool(flaky, size=1)
    try:
        with pytest.raises(OSError):
            pool.session().__enter__()
        with pool.session() as s:
            assert isinstance(s, FakeSession)
        assert calls == [0, 1]
    finally:
        pool.close()


# -- the preprocessor's Joern route ------------------------------------------


@pytest.fixture(scope="module")
def vocabs():
    """(port vocabs, reference vocabs) of one seeded corpus."""
    def build(mod_synth, mod_pipe):
        ex = mod_synth.to_examples(mod_synth.generate(48, seed=2, vuln_rate=0.3))
        return mod_pipe.build_dataset(ex, train_ids=range(48), limit_all=50,
                                      limit_subkeys=50)[1]

    return build(synthetic, pipeline), build(ref_synthetic, ref_pipeline)


@pytest.fixture
def stub_pools(tmp_path):
    """make(mod, size) -> a SessionPool of port-stub sessions; all closed
    at teardown."""
    stub = str(joern_stub.write_stub(tmp_path / "bin"))
    pools = []

    def make(mod, size=2, session_cls=JoernSession):
        pool = mod.SessionPool(lambda i: session_cls(worker_id=i, binary=stub, timeout=2),
                               size=size)
        pools.append(pool)
        return pool

    yield make
    for p in pools:
        p.close()


@pytest.mark.parametrize("gtype", ["cfg", "cfg+dep"])
def test_preprocessor_joern_route_equals_reference(vocabs, stub_pools, gtype):
    etypes = "3" if gtype == "cfg+dep" else "1"
    over = OVERRIDES + [f'data.gtype="{gtype}"', f"model.n_etypes={etypes}"]
    cfg = config_mod.apply_overrides(config_mod.Config(), over)
    rcfg = ref_config.apply_overrides(ref_config.Config(), over)
    pre = frontend.RequestPreprocessor(cfg, vocabs[0], use_joern=True,
                                       joern_pool=stub_pools(frontend))
    ref = ref_frontend.RequestPreprocessor(
        rcfg, vocabs[1], use_joern=True,
        joern_pool=stub_pools(ref_frontend, session_cls=ref_joern_session.JoernSession))
    for name in NAMES:
        code = SOURCES[name]
        assert pre.content_key(code) == ref.content_key(code)
        assert "|joern=True|" in pre.content_key(code)
        got, want = pre.features_full(code), ref.features_full(code)
        assert np.array_equal(got.node_lines, want.node_lines)
        for f in ("node_feats", "edge_src", "edge_dst", "edge_type", "node_vuln"):
            a, b = getattr(got.spec, f, None), getattr(want.spec, f, None)
            if b is None:
                assert a is None, f
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
        assert float(got.spec.label) == float(want.spec.label)
    # the built-in route keys the same source apart
    plain = frontend.RequestPreprocessor(cfg, vocabs[0])
    assert plain.content_key(SOURCES[NAMES[0]]) != pre.content_key(SOURCES[NAMES[0]])
    assert pre.stats()["extractions"] == len(NAMES)
    # a repeat is a cache hit: no second round trip
    hits = pre.cache.hits
    pre.features(SOURCES[NAMES[0]])
    assert pre.cache.hits == hits + 1 and pre.stats()["extractions"] == len(NAMES)


def test_preprocessor_joern_unknown_source_is_a_counted_cached_failure(vocabs, stub_pools):
    cfg = config_mod.apply_overrides(config_mod.Config(), OVERRIDES)
    pool = stub_pools(frontend, size=1)
    pre = frontend.RequestPreprocessor(cfg, vocabs[0], use_joern=True, joern_pool=pool)
    with pytest.raises(frontend.FrontendError, match="could not be parsed"):
        pre.features("int other(void) { return 1; }\n")
    with pytest.raises(frontend.FrontendError, match="cached"):
        pre.features("int other(void) { return 1; }\n")
    assert pre.stats()["failures"] == 2 and pre.stats()["extractions"] == 1
    # the unreadable export is not a session fault: the session stays
    assert pool.replaced == 0
    pre.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.session().__enter__()


def test_preprocessor_builds_its_own_pool_from_the_config(vocabs, tmp_path, monkeypatch):
    """With no pool given, serve.joern_pool_size sessions of the `joern`
    on PATH, each bounded by serve.joern_timeout_s; without one on PATH
    both packages raise the same FrontendError."""
    over = OVERRIDES + ["serve.use_joern=true", "serve.joern_pool_size=2",
                        "serve.joern_timeout_s=2.0"]
    cfg = config_mod.apply_overrides(config_mod.Config(), over)
    rcfg = ref_config.apply_overrides(ref_config.Config(), over)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    msg = "serve.use_joern=true but no `joern` binary on PATH"
    for mod, c, v in ((frontend, cfg, vocabs[0]), (ref_frontend, rcfg, vocabs[1])):
        with pytest.raises(mod.FrontendError) as e:
            mod.RequestPreprocessor(c, v, use_joern=True)
        assert str(e.value) == msg
    joern_stub.write_stub(tmp_path / "bin")
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep + os.environ["PATH"])
    pre = frontend.RequestPreprocessor(cfg, vocabs[0], use_joern=cfg.serve.use_joern)
    try:
        assert pre.pool.size == 2
        out = [None, None]

        def score(i):
            out[i] = pre.features(SOURCES[NAMES[i]])

        threads = [threading.Thread(target=score, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(o is not None for o in out)
        sessions = list(pre.pool._free)
        assert 1 <= len(sessions) <= 2
        assert all(s.timeout == 2.0 and s.proc.args[1:] == ["--nocolors"] for s in sessions)
    finally:
        pre.close()
    assert all(s.proc.wait(timeout=5) is not None for s in sessions)


def test_session_pool_under_thread_stress():
    """48 borrowers over 4 sessions on 6 threads, every third lease failing,
    with a short switch interval: a session is never lent twice at once,
    at most `size` sessions are alive, every failure replaced one, and
    every borrower finished."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    lock = threading.Lock()
    alive, peak, lent = set(), [0], set()

    class FakeSession:
        def __init__(self, i):
            with lock:
                alive.add(self)
                peak[0] = max(peak[0], len(alive))

        def close(self):
            with lock:
                alive.discard(self)

    pool = frontend.SessionPool(FakeSession, size=4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def borrow(k):
        try:
            with pool.session() as s:
                with lock:
                    assert s not in lent
                    lent.add(s)
                time.sleep(random.random() * 1e-3)
                with lock:
                    lent.discard(s)
                if k % 3 == 0:
                    raise RuntimeError("session died")
        except RuntimeError:
            return False
        return True

    try:
        with ThreadPoolExecutor(6) as ex:
            done = [f.result(timeout=30) for f in [ex.submit(borrow, k) for k in range(48)]]
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert len(done) == 48 and done.count(False) == 16
    assert pool.replaced == 16 and peak[0] <= 4 and not alive and not lent
