"""A stand-in for Joern, for tests and `chip_smoke.py`: the five hand-built
Joern-schema exports of `tests/joern_fixtures.py` (the port's own copy, so
that `chip_smoke.py` never imports `tests/`) and a writer of stub `joern`
REPLs that speak the session protocol of `frontend/joern_session.py`.

This is test support, not a feature the JAX package lacks: neither the
machine the tests run on nor the machine with the card has Joern, so the
Joern route (`serve.use_joern`) is driven through these stubs there.

Each fixture encodes what the real Joern (v1.1.1072, the pin of the
original DDFA pipeline) emits for a small C function, at the granularity
the model consumes: statement-level CFG nodes with line numbers,
assignment CALLs with AST/ARGUMENT children (LHS IDENTIFIER first),
LOCALs carrying typeFullName, LITERAL/CALL descendants for the feature
extractor. Node ids use Joern's large-offset style. Built by hand from
Joern's schema, NOT derived from the built-in parser (that would make
agreement trivially 1.0).

`write_stub(directory)` writes an executable `joern` there: it takes
`--nocolors`, leaves on `:exit`, answers each `println("<marker>")` with the marker, echoes
other commands, remembers the last `importCode("<path>")`, and on the
export script (`JoernSession.export_cpg_json`) writes the fixture export
whose source equals the imported file's text to the script's two
`PrintWriter` paths; for any other source it writes nothing, and the
export cannot be loaded. With `wedge_flag=<path>`, the first stub process
(the flag file absent) creates the flag and wedges after its readiness
handshake; later processes behave normally, so a session with one
restart gets through.
"""

from __future__ import annotations

import json
import stat
import sys
import tempfile
from pathlib import Path


class JoernExportBuilder:
    def __init__(self, method_name: str, method_line: int = 1):
        self._next = 1000100
        self.nodes: list[dict] = []
        self.edges: list[list] = []
        self.method = self.node("METHOD", name=method_name, code=method_name,
                                line=method_line)
        self.ret = self.node("METHOD_RETURN", name="RET", code="RET",
                             line=method_line, order=99)

    def node(self, label, name="", code="", line=None, order=1, typ=None):
        nid = self._next
        self._next += 1
        row = {"id": nid, "_label": label, "name": name, "code": code,
               "order": order}
        if line is not None:
            row["lineNumber"] = line
        if typ is not None:
            row["typeFullName"] = typ
        self.nodes.append(row)
        return nid

    def edge(self, src, dst, etype):
        # export rows are [inNode, outNode, label, dataflow]: out -> in
        self.edges.append([dst, src, etype, ""])

    def ast(self, parent, child, argument=False):
        self.edge(parent, child, "AST")
        if argument:
            self.edge(parent, child, "ARGUMENT")

    def local(self, name, typ, line):
        nid = self.node("LOCAL", name=name, code=f"{typ} {name}", line=line,
                        typ=typ)
        self.ast(self.method, nid)
        return nid

    def identifier(self, name, typ, line, order=1):
        return self.node("IDENTIFIER", name=name, code=name, line=line,
                         order=order, typ=typ)

    def literal(self, text, line, order=2):
        return self.node("LITERAL", name="", code=text, line=line, order=order)

    def call(self, name, code, line, args, order=1):
        nid = self.node("CALL", name=name, code=code, line=line, order=order)
        self.ast(self.method, nid)
        for a in args:
            self.ast(nid, a, argument=True)
        return nid

    def subcall(self, name, code, line, args, order=2):
        """A nested (non-statement) call: child of an expression."""
        nid = self.node("CALL", name=name, code=code, line=line, order=order)
        for a in args:
            self.ast(nid, a, argument=True)
        return nid

    def assign(self, lhs_name, lhs_type, rhs_nodes, line, code):
        lhs = self.identifier(lhs_name, lhs_type, line, order=1)
        return self.call("<operator>.assignment", code, line,
                         [lhs, *rhs_nodes])

    def cfg(self, *chain):
        for a, b in zip(chain, chain[1:]):
            self.edge(a, b, "CFG")

    def write(self, tmp_path, stem):
        prefix = tmp_path / f"{stem}.c"
        (tmp_path / f"{stem}.c.nodes.json").write_text(json.dumps(self.nodes))
        (tmp_path / f"{stem}.c.edges.json").write_text(json.dumps(self.edges))
        return str(prefix)


SOURCES = {
    "assign_return": (
        "int f(int a) {\n"
        "  int x = a + 1;\n"
        "  return x;\n"
        "}\n"
    ),
    "if_else": (
        "int g(int a) {\n"
        "  int r = 0;\n"
        "  if (a > 0) {\n"
        "    r = a;\n"
        "  } else {\n"
        "    r = 0 - a;\n"
        "  }\n"
        "  return r;\n"
        "}\n"
    ),
    "while_call": (
        "int h(int n) {\n"
        "  int s = 0;\n"
        "  int i = 0;\n"
        "  while (i < n) {\n"
        "    s = s + bar(i);\n"
        "    i = i + 1;\n"
        "  }\n"
        "  return s;\n"
        "}\n"
    ),
    "switch_break": (
        "int sw(int x) {\n"
        "  int r = 0;\n"
        "  switch (x) {\n"
        "  case 0:\n"
        "    r = 1;\n"
        "    break;\n"
        "  default:\n"
        "    r = 2;\n"
        "  }\n"
        "  return r;\n"
        "}\n"
    ),
    "loop_continue": (
        "int lc(int n) {\n"
        "  int s = 0;\n"
        "  for (int i = 0; i < n; i++) {\n"
        "    if (n % 2)\n"
        "      continue;\n"
        "    s = s + i;\n"
        "  }\n"
        "  return s;\n"
        "}\n"
    ),
}


def build_assign_return(tmp_path):
    b = JoernExportBuilder("f")
    b.local("x", "int", 2)
    add = b.subcall(
        "<operator>.addition", "a + 1", 2,
        [b.identifier("a", "int", 2, 1), b.literal("1", 2, 2)],
    )
    asg = b.assign("x", "int", [add], 2, "x = a + 1")
    retv = b.identifier("x", "int", 3)
    ret = b.call("RETURN", "return x;", 3, [retv])
    b.nodes[-4 if False else 0] = b.nodes[0]  # no-op; keep ids stable
    # joern labels return statements RETURN, not CALL
    for n in b.nodes:
        if n["id"] == ret:
            n["_label"] = "RETURN"
            n["name"] = "return"
    b.cfg(b.method, asg, ret, b.ret)
    return b.write(tmp_path, "assign_return")


def build_if_else(tmp_path):
    b = JoernExportBuilder("g")
    b.local("r", "int", 2)
    asg0 = b.assign("r", "int", [b.literal("0", 2)], 2, "r = 0")
    cond = b.call(
        "<operator>.greaterThan", "a > 0", 3,
        [b.identifier("a", "int", 3, 1), b.literal("0", 3, 2)],
    )
    asg1 = b.assign("r", "int", [b.identifier("a", "int", 4, 2)], 4, "r = a")
    sub = b.subcall(
        "<operator>.subtraction", "0 - a", 6,
        [b.literal("0", 6, 1), b.identifier("a", "int", 6, 2)],
    )
    asg2 = b.assign("r", "int", [sub], 6, "r = 0 - a")
    retv = b.identifier("r", "int", 8)
    ret = b.call("RETURN", "return r;", 8, [retv])
    for n in b.nodes:
        if n["id"] == ret:
            n["_label"] = "RETURN"
            n["name"] = "return"
    b.cfg(b.method, asg0, cond)
    b.cfg(cond, asg1, ret, b.ret)
    b.cfg(cond, asg2, ret)
    return b.write(tmp_path, "if_else")


def build_while_call(tmp_path):
    b = JoernExportBuilder("h")
    b.local("s", "int", 2)
    b.local("i", "int", 3)
    asg_s = b.assign("s", "int", [b.literal("0", 2)], 2, "s = 0")
    asg_i = b.assign("i", "int", [b.literal("0", 3)], 3, "i = 0")
    cond = b.call(
        "<operator>.lessThan", "i < n", 4,
        [b.identifier("i", "int", 4, 1), b.identifier("n", "int", 4, 2)],
    )
    barc = b.subcall("bar", "bar(i)", 5, [b.identifier("i", "int", 5, 1)])
    add = b.subcall(
        "<operator>.addition", "s + bar(i)", 5,
        [b.identifier("s", "int", 5, 1), barc],
    )
    asg_body = b.assign("s", "int", [add], 5, "s = s + bar(i)")
    inc = b.subcall(
        "<operator>.addition", "i + 1", 6,
        [b.identifier("i", "int", 6, 1), b.literal("1", 6, 2)],
    )
    asg_inc = b.assign("i", "int", [inc], 6, "i = i + 1")
    retv = b.identifier("s", "int", 8)
    ret = b.call("RETURN", "return s;", 8, [retv])
    for n in b.nodes:
        if n["id"] == ret:
            n["_label"] = "RETURN"
            n["name"] = "return"
    b.cfg(b.method, asg_s, asg_i, cond, asg_body, asg_inc, cond)
    b.cfg(cond, ret, b.ret)
    return b.write(tmp_path, "while_call")


def build_switch_break(tmp_path):
    """Joern emits JUMP_TARGET nodes per case/default label and keeps
    break statements in the CFG as CONTROL_STRUCTURE nodes; the dispatch
    edges run switch-cond -> each jump target."""
    b = JoernExportBuilder("sw")
    b.local("r", "int", 2)
    asg0 = b.assign("r", "int", [b.literal("0", 2)], 2, "r = 0")
    swcond = b.identifier("x", "int", 3)
    b.ast(b.method, swcond)
    jt0 = b.node("JUMP_TARGET", name="case 0", code="case 0:", line=4)
    asg1 = b.assign("r", "int", [b.literal("1", 5)], 5, "r = 1")
    brk = b.node("CONTROL_STRUCTURE", name="break", code="break;", line=6)
    jt1 = b.node("JUMP_TARGET", name="default", code="default:", line=7)
    asg2 = b.assign("r", "int", [b.literal("2", 8)], 8, "r = 2")
    retv = b.identifier("r", "int", 10)
    ret = b.call("RETURN", "return r;", 10, [retv])
    for n in b.nodes:
        if n["id"] == ret:
            n["_label"] = "RETURN"
            n["name"] = "return"
    b.cfg(b.method, asg0, swcond, jt0, asg1, brk, ret, b.ret)
    b.cfg(swcond, jt1, asg2, ret)
    return b.write(tmp_path, "switch_break")


def build_loop_continue(tmp_path):
    """continue stays in Joern's CFG as a CONTROL_STRUCTURE node wired
    to the for-loop's update expression."""
    b = JoernExportBuilder("lc")
    b.local("s", "int", 2)
    asg_s = b.assign("s", "int", [b.literal("0", 2)], 2, "s = 0")
    b.local("i", "int", 3)
    asg_i = b.assign("i", "int", [b.literal("0", 3)], 3, "i = 0")
    cond = b.call(
        "<operator>.lessThan", "i < n", 3,
        [b.identifier("i", "int", 3, 1), b.identifier("n", "int", 3, 2)],
    )
    ifc = b.call(
        "<operator>.modulo", "n % 2", 4,
        [b.identifier("n", "int", 4, 1), b.literal("2", 4, 2)],
    )
    cont = b.node("CONTROL_STRUCTURE", name="continue", code="continue;",
                  line=5)
    add = b.subcall(
        "<operator>.addition", "s + i", 6,
        [b.identifier("s", "int", 6, 1), b.identifier("i", "int", 6, 2)],
    )
    asg_b = b.assign("s", "int", [add], 6, "s = s + i")
    inc = b.call(
        "<operator>.postIncrement", "i++", 3,
        [b.identifier("i", "int", 3, 1)],
    )
    retv = b.identifier("s", "int", 8)
    ret = b.call("RETURN", "return s;", 8, [retv])
    for n in b.nodes:
        if n["id"] == ret:
            n["_label"] = "RETURN"
            n["name"] = "return"
    b.cfg(b.method, asg_s, asg_i, cond, ifc, cont, inc, cond)
    b.cfg(ifc, asg_b, inc)
    b.cfg(cond, ret, b.ret)
    return b.write(tmp_path, "loop_continue")


BUILDERS = {
    "assign_return": build_assign_return,
    "if_else": build_if_else,
    "while_call": build_while_call,
    "switch_break": build_switch_break,
    "loop_continue": build_loop_continue,
}


def exports() -> dict[str, tuple[str, str]]:
    """{fixture name: (nodes.json text, edges.json text)}: the bytes each
    builder writes."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="joern-fixtures-") as d:
        for name, build in BUILDERS.items():
            prefix = build(Path(d))
            out[name] = (Path(prefix + ".nodes.json").read_text(),
                         Path(prefix + ".edges.json").read_text())
    return out


_STUB = r"""
import json, re, sys, time
from pathlib import Path

EXPORTS = json.loads(%(exports)r)
WEDGE_FLAG = %(wedge_flag)r

wedge = False
if WEDGE_FLAG is not None and not Path(WEDGE_FLAG).exists():
    Path(WEDGE_FLAG).touch()
    wedge = True
imported = None
writers = []
markers = 0
for raw in sys.stdin:
    line = raw.strip()
    if line == ":exit":
        break
    if line.startswith('println("'):
        markers += 1
        if wedge and markers > 1:
            time.sleep(3600)  # wedged after the readiness handshake
        if len(writers) == 2 and imported is not None:
            try:
                text = Path(imported).read_text()
            except OSError:
                text = None
            if text in EXPORTS:
                for path, payload in zip(writers, EXPORTS[text]):
                    Path(path).write_text(payload)
        writers = []
        print(line.split('"')[1], flush=True)
        continue
    m = re.match(r'importCode\("(.*)"\)$', line)
    if m:
        imported = m.group(1)
    writers.extend(re.findall(r'new PrintWriter\("([^"]*)"\)', line))
    print("echo: " + line, flush=True)
"""


def write_stub(directory: str | Path, name: str = "joern",
               wedge_flag: str | Path | None = None) -> Path:
    """An executable stub REPL `directory/name` serving the five fixture
    exports (see the module docstring); put `directory` first on PATH
    for `joern_session.available()` and the session pool to find it."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    table = {SOURCES[n]: list(texts) for n, texts in exports().items()}
    path = directory / name
    path.write_text("#!" + sys.executable + "\n" + _STUB % {
        "exports": json.dumps(table),
        "wedge_flag": None if wedge_flag is None else str(wedge_flag)})
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path
