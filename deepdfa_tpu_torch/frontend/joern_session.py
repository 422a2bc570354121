"""Persistent Joern session driver (optional external backend; the
port's copy of the reference's `deepdfa_tpu/frontend/joern_session.py`).

The reference drives a long-lived interactive Joern JVM over a pexpect pty
with per-worker workspaces (DDFA/sastvd/helpers/joern_session.py:35-121);
this driver provides the same capability on plain subprocess pipes:

    with JoernSession(worker_id=3) as s:
        s.import_code("/path/to/file.c")
        s.run_command('cpg.method.name.l')
        s.export_cpg_json("/path/to/file.c")   # -> .nodes.json/.edges.json

Export output is the format frontend/joern_io.py imports, so Joern-exact
CPGs flow into the same pipeline as the built-in frontend. The session is
only usable where a `joern` binary exists (it is an external JVM tool,
exactly as in the reference); `available()` reports that.
"""

from __future__ import annotations

import queue
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from deepdfa_tpu_torch.obs import trace as obs_trace

_MARKER = "===DEEPDFA_DONE==="

# scala snippet exporting nodes/edges json for the currently loaded cpg,
# mirroring the reference export surface (get_func_graph.sc): all nodes
# with their property map, all edges as [inNode, outNode, label] rows.
_EXPORT_TEMPLATE = r"""
{{
  import java.io.PrintWriter
  val nodes = cpg.all.map {{ n =>
    val m = scala.collection.mutable.Map[String, Any]("id" -> n.id, "_label" -> n.label)
    n.propertiesMap.forEach {{ (k, v) => m(k) = v }}
    m
  }}.l
  def esc(s: String) = s.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n").replace("\r", "")
  def jval(v: Any): String = v match {{
    case i: java.lang.Integer => i.toString
    case l: java.lang.Long => l.toString
    case s: String => "\"" + esc(s) + "\""
    case other => "\"" + esc(String.valueOf(other)) + "\""
  }}
  val nodesJson = nodes.map {{ m =>
    "{{" + m.map {{ case (k, v) =>
      val key = if (k == "LINE_NUMBER") "lineNumber" else if (k == "TYPE_FULL_NAME") "typeFullName"
        else if (k == "NAME") "name" else if (k == "CODE") "code" else if (k == "ORDER") "order" else k
      "\"" + key + "\": " + jval(v)
    }}.mkString(", ") + "}}"
  }}.mkString("[", ",\n", "]")
  new PrintWriter("{nodes_out}") {{ write(nodesJson); close }}
  val edgesJson = cpg.graph.edges().map {{ e =>
    "[" + e.inNode.id + ", " + e.outNode.id + ", \"" + e.label + "\", \"\"]"
  }}.l.mkString("[", ",\n", "]")
  new PrintWriter("{edges_out}") {{ write(edgesJson); close }}
}}
"""


# scala snippet exporting Joern's own reaching-definitions fixpoint per
# method (role of the reference's get_func_graph.sc / get_dataflow_output.sc
# solution export): {method fullName: {"in": {nodeId: [defIdx..]},
# "out": {...}}} where defIdx numbers the solver's definition domain.
_DATAFLOW_TEMPLATE = r"""
{{
  import java.io.PrintWriter
  import io.joern.dataflowengineoss.passes.reachingdef.{{DataFlowSolver, ReachingDefProblem}}
  def escDf(s: String) = s.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n").replace("\r", "")
  def nodeKey(node: Any): String = node match {{
    case n: io.shiftleft.codepropertygraph.generated.nodes.StoredNode => n.id.toString
    case other => escDf(String.valueOf(other))
  }}
  def setJson(m: scala.collection.Map[_, _]): String = m.map {{ case (node, defs) =>
    val ids = defs.asInstanceOf[scala.collection.Set[_]].map(String.valueOf(_)).toSeq.sorted
    "\"" + nodeKey(node) + "\": [" + ids.mkString(", ") + "]"
  }}.mkString("{{", ", ", "}}")
  val entries = cpg.method.l.map {{ m =>
    val problem = ReachingDefProblem.create(m)
    val solution = new DataFlowSolver().calculateMopSolutionForwards(problem)
    "\"" + escDf(m.fullName) + "\": {{\"in\": " + setJson(solution.in) +
      ", \"out\": " + setJson(solution.out) + "}}"
  }}
  new PrintWriter("{out}") {{ write(entries.mkString("{{", ", ", "}}")); close }}
}}
"""


def available() -> bool:
    return shutil.which("joern") is not None


class JoernTimeout(RuntimeError):
    """The JVM stopped responding within the per-command timeout."""


class JoernSession:
    def __init__(
        self,
        worker_id: int = 0,
        timeout: float = 300.0,
        binary: str = "joern",
        max_restarts: int = 1,
    ):
        """timeout: per-command bound — a hung JVM raises JoernTimeout
        instead of blocking the worker forever (the reference's pexpect
        driver has the same per-expect timeout, joern_session.py:87-102).
        binary: override for tests (a marker-echoing stub stands in for
        the real JVM to exercise the protocol).
        max_restarts: after a JoernTimeout the wedged JVM is killed and
        the session is DEAD; up to this many times per session a fresh
        JVM is spawned, the last importCode replayed, and the timed-out
        command retried ONCE — so one hung JVM does not fail a whole
        extraction batch. 0 restores the old fail-fast behaviour."""
        if binary == "joern" and not available():
            raise RuntimeError("joern binary not on PATH")
        self.timeout = timeout
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self._binary = binary
        self._last_import: str | None = None
        self.workspace = Path(tempfile.mkdtemp(prefix=f"joern-ws-{worker_id}-"))
        self._spawn()

    def _spawn(self) -> None:
        """Start (or restart) the JVM + reader thread and handshake."""
        argv = (
            [self._binary, "--nocolors"]
            if self._binary == "joern"
            else [self._binary]
        )
        self.proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=self.workspace,
            text=True,
            bufsize=1,
        )
        # reader thread: readline on a pipe cannot be interrupted, so all
        # reads flow through a queue that _exchange polls with a deadline.
        # Restart replaces the queue; an old reader drains into the old
        # queue and exits at EOF of its killed process.
        self._lines: queue.Queue[str | None] = queue.Queue()
        self._reader = threading.Thread(
            target=self._pump, args=(self.proc, self._lines), daemon=True
        )
        self._reader.start()
        self._drain_until_ready()

    # -- protocol ------------------------------------------------------------

    @staticmethod
    def _pump(proc, lines) -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)  # EOF sentinel

    def _drain_until_ready(self) -> None:
        self._exchange("1 + 1")

    def _exchange(self, cmd: str, timeout: float | None = None) -> str:
        """One command/marker round-trip on the CURRENT process; kills it
        and raises JoernTimeout on deadline. Each round-trip is a
        cat="joern" span in the unified trace (obs/trace.py) —
        JVM time is a first-class stage in the merged timeline."""
        with obs_trace.span("joern_exchange", cat="joern", cmd=cmd[:80]):
            return self._exchange_inner(cmd, timeout)

    def _exchange_inner(self, cmd: str, timeout: float | None = None) -> str:
        import time

        assert self.proc.stdin is not None
        deadline = time.monotonic() + (timeout or self.timeout)
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.write(f'println("{_MARKER}")\n')
        self.proc.stdin.flush()
        lines: list[str] = []
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.proc.kill()
                self.proc.wait(timeout=10)
                raise JoernTimeout(
                    f"joern command exceeded {timeout or self.timeout:.0f}s: "
                    f"{cmd[:120]!r}"
                )
            try:
                line = self._lines.get(timeout=min(remaining, 1.0))
            except queue.Empty:
                continue
            if line is None:
                raise RuntimeError("joern session terminated unexpectedly")
            if _MARKER in line and "println" not in line:
                break
            lines.append(line)
        return "".join(lines)

    def run_command(self, cmd: str, timeout: float | None = None) -> str:
        """Send one command; collect output up to the marker echo.

        On JoernTimeout the wedged JVM is killed; within the
        `max_restarts` budget a fresh JVM is spawned, the last
        importCode is replayed (project state dies with the JVM), and the
        command is retried once — a second timeout propagates."""
        import logging

        try:
            return self._exchange(cmd, timeout)
        except JoernTimeout:
            if self.restarts >= self.max_restarts:
                raise
            self.restarts += 1
            logging.getLogger(__name__).warning(
                "joern JVM hung; restart %d/%d and retrying %r",
                self.restarts, self.max_restarts, cmd[:80],
            )
            self._spawn()
            # replay the loaded project UNLESS the timed-out command was
            # the importCode itself — replaying and then retrying it
            # would import twice (and double the slowest operation's
            # chance of hitting the same timeout again)
            if self._last_import is not None and not cmd.startswith(
                "importCode("
            ):
                # replay under the session's own budget, not the failed
                # command's (possibly much shorter) per-command timeout —
                # an import that took 60s must not be bounded by a 10s
                # query timeout
                self._exchange(f'importCode("{self._last_import}")')
            return self._exchange(cmd, timeout)

    # -- operations ----------------------------------------------------------

    def import_code(self, path: str | Path) -> str:
        # remembered so a post-timeout JVM restart can reload the project
        # before retrying the command that timed out
        self._last_import = str(path)
        return self.run_command(f'importCode("{path}")')

    def export_cpg_json(self, source_path: str | Path) -> tuple[Path, Path]:
        """Export the loaded CPG next to `source_path` in the reference's
        .nodes.json/.edges.json layout (loadable by joern_io)."""
        nodes_out = str(source_path) + ".nodes.json"
        edges_out = str(source_path) + ".edges.json"
        script = _EXPORT_TEMPLATE.format(nodes_out=nodes_out, edges_out=edges_out)
        self.run_command(script)
        return Path(nodes_out), Path(edges_out)

    def export_dataflow_json(self, source_path: str | Path) -> Path:
        """Export Joern's reaching-definitions solution for the loaded CPG
        to `<source>.dataflow.json` (role of the reference's
        get_dataflow_output.sc; loadable by joern_io.load_joern_dataflow)."""
        out = str(source_path) + ".dataflow.json"
        self.run_command(_DATAFLOW_TEMPLATE.format(out=out))
        return Path(out)

    def export_cpg_bin(self, source_path: str | Path) -> Path:
        """Copy the loaded project's binary CPG next to `source_path` as
        `<source>.cpg.bin` (the reference exports the same artifact for
        re-import without re-parsing, get_func_graph.sc cpg.bin role).

        Joern names workspace projects after the imported file, so the
        project matching `source_path` is preferred; when absent (layout
        differences across joern versions) the fallback search is
        restricted to project directories whose name contains the imported
        file's name — a most-recent-anywhere pick could silently copy a
        stale or wrong project's CPG when the session has imported
        several files."""
        name = Path(source_path).name
        exact = self.workspace / "workspace" / name / "cpg.bin"
        if exact.exists():
            src = exact
        else:
            candidates = sorted(
                (
                    p
                    for p in self.workspace.rglob("cpg.bin")
                    if name in p.parent.name
                ),
                key=lambda p: p.stat().st_mtime,
            )
            if not candidates:
                raise RuntimeError(
                    f"no cpg.bin for project {name!r} under workspace "
                    f"{self.workspace}; import the file first"
                )
            src = candidates[-1]
        dest = Path(str(source_path) + ".cpg.bin")
        shutil.copyfile(src, dest)
        return dest

    def close(self) -> None:
        try:
            if self.proc.stdin is not None:
                self.proc.stdin.write(":exit\n")
                self.proc.stdin.flush()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
        shutil.rmtree(self.workspace, ignore_errors=True)

    def __enter__(self) -> "JoernSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
