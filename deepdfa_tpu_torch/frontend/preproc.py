"""Preprocessor conditional evaluation + object-like macro expansion.

The reference's Joern frontend preprocesses each function text with an
empty predefined-macro table before parsing (Eclipse-CDT semantics under
get_func_graph.sc's importCode); a hermetic frontend that skips directive
LINES but keeps every branch BODY (the round-2 behavior, tokens.py) sees
`#ifdef`/`#else` functions with both branches live — a CPG shape a real
preprocessor can never produce. This pass applies standard C-preprocessor
semantics to the conditional directives only:

- `#if` / `#elif` constant expressions are evaluated with unknown
  identifiers as 0 (ISO C 6.10.1p4), `defined(X)` / `defined X` resolved
  against the file-local `#define` table;
- `#ifdef` / `#ifndef` test that table;
- inactive branch lines are blanked (newlines kept, so line numbers in
  the CPG still match the original source);
- object-like `#define NAME <literal-or-id>` bodies are expanded in
  active code (token-boundary, outside string/char literals), matching
  what the reference's parser sees after real preprocessing. Unknown
  function-like macros are left intact — they parse as plain calls, the
  same recovery CDT applies when a macro definition is unavailable.

Expressions this mini-evaluator cannot decide default to ACTIVE (keep the
code visible) rather than dropping code on a guess.

The port's copy of the reference's `deepdfa_tpu/frontend/preproc.py`.
"""

from __future__ import annotations

import re

_DIRECTIVE_RE = re.compile(r"^\s*#\s*(\w+)(.*)$", re.DOTALL)
_DEFINE_RE = re.compile(r"^\s*(\w+)(\([^)]*\))?\s*(.*?)\s*$", re.DOTALL)
_DEFINED_RE = re.compile(r"\bdefined\s*(?:\(\s*(\w+)\s*\)|(\w+))")
_ID_RE = re.compile(r"\b[A-Za-z_]\w*\b")
_SIMPLE_BODY_RE = re.compile(
    r"^(?:\d[\w.]*|0[xX][0-9a-fA-F]+[uUlL]*|'(?:\\.|[^'])*'|\"(?:\\.|[^\"])*\"|[A-Za-z_]\w*|\([^()]*\))$"
)

# -- bounded #if expression evaluator ---------------------------------------
#
# Hostile dataset source reaches this code (ADVICE r3): Python eval() of a
# directive like `#if 9**9**9**9` or `#if 1<<(1<<40)` computes astronomical
# integers. This tiny recursive-descent evaluator implements exactly the C
# preprocessor operator set with hard caps on literal size, shift counts,
# and intermediate magnitude; anything outside it raises -> undecidable ->
# the branch stays active (the module's keep-code-visible default).

_NUM_TOK = re.compile(r"0[xX][0-9a-fA-F]+|\d+")
_OP_TOK = re.compile(r"<<|>>|<=|>=|==|!=|&&|\|\||[()?:~!+\-*/%<>&|^]")
_MAX_BITS = 128  # magnitude cap for literals and every intermediate


class _CondError(Exception):
    pass


def _cond_tokens(s: str) -> list[str]:
    toks: list[str] = []
    i, n = 0, len(s)
    while i < n:
        if s[i].isspace():
            i += 1
            continue
        m = _NUM_TOK.match(s, i) or _OP_TOK.match(s, i)
        if not m:
            raise _CondError(s[i])
        toks.append(m.group(0))
        i = m.end()
    return toks


class _CondParser:
    """Precedence-climbing parser for C preprocessor constant expressions:
    ternary > || > && > | > ^ > & > ==/!= > relational > shifts > +- >
    */% > unary.

    Syntax errors raise _CondError (the whole directive is undecidable).
    SEMANTIC failures (overflow past the magnitude cap, div-by-zero,
    out-of-range shift counts) evaluate to ``None`` and propagate, so
    they poison only the value that actually depends on them: real
    preprocessors accept `0 && 1/0` and `x ? y : 1/0` with the bad
    operand unselected, and short-circuit / arm selection must honor
    that."""

    _BINOPS: list[list[str]] = [
        ["||"], ["&&"], ["|"], ["^"], ["&"], ["==", "!="],
        ["<", ">", "<=", ">="], ["<<", ">>"], ["+", "-"], ["*", "/", "%"],
    ]

    def __init__(self, s: str):
        self.toks = _cond_tokens(s)
        self.pos = 0

    def _peek(self) -> str | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def _next(self) -> str:
        tok = self._peek()
        if tok is None:
            raise _CondError("eof")
        self.pos += 1
        return tok

    @staticmethod
    def _check(v: int | None) -> int | None:
        if v is not None and v.bit_length() > _MAX_BITS:
            return None
        return v

    def parse(self) -> int | None:
        v = self._ternary()
        if self._peek() is not None:
            raise _CondError(self._peek())
        return v

    def _ternary(self) -> int | None:
        cond = self._binary(0)
        if self._peek() != "?":
            return cond
        self._next()
        # parse both arms (structure must be consumed either way); only
        # the SELECTED arm's semantic failures matter
        then = self._ternary()
        if self._next() != ":":
            raise _CondError(":")
        other = self._ternary()
        if cond is None:
            return None
        return then if cond else other

    def _binary(self, level: int) -> int | None:
        if level == len(self._BINOPS):
            return self._unary()
        v = self._binary(level + 1)
        ops = self._BINOPS[level]
        while self._peek() in ops:
            op = self._next()
            r = self._binary(level + 1)
            if op == "||":
                # short-circuit: a decided-true left absorbs a poisoned
                # right (C never evaluates it); a poisoned LEFT poisons
                # the result (C evaluates left first)
                if v is None:
                    v = None
                else:
                    v = 1 if v else (None if r is None else int(bool(r)))
            elif op == "&&":
                if v is None:
                    v = None
                else:
                    v = 0 if not v else (None if r is None else int(bool(r)))
            elif v is None or r is None:
                v = None
            elif op == "|":
                v |= r
            elif op == "^":
                v ^= r
            elif op == "&":
                v &= r
            elif op == "==":
                v = int(v == r)
            elif op == "!=":
                v = int(v != r)
            elif op == "<":
                v = int(v < r)
            elif op == ">":
                v = int(v > r)
            elif op == "<=":
                v = int(v <= r)
            elif op == ">=":
                v = int(v >= r)
            elif op in ("<<", ">>"):
                if r < 0 or r > _MAX_BITS:
                    v = None
                else:
                    v = v << r if op == "<<" else v >> r
            elif op == "+":
                v += r
            elif op == "-":
                v -= r
            elif op == "*":
                v *= r
            elif r == 0:  # / %
                v = None
            else:
                # C truncates toward zero; Python floors
                q, rem = abs(v) // abs(r), abs(v) % abs(r)
                if op == "/":
                    v = q if (v < 0) == (r < 0) else -q
                else:
                    v = rem if v >= 0 else -rem
            v = self._check(v)
        return v

    def _unary(self) -> int | None:
        tok = self._next()
        if tok == "(":
            v = self._ternary()
            if self._next() != ")":
                raise _CondError(")")
            return v
        if tok == "!":
            v = self._unary()
            return None if v is None else int(not v)
        if tok == "~":
            v = self._unary()
            return self._check(None if v is None else ~v)
        if tok == "-":
            v = self._unary()
            return self._check(None if v is None else -v)
        if tok == "+":
            return self._unary()
        if _NUM_TOK.fullmatch(tok):
            if tok[:2].lower() == "0x":
                v = int(tok, 16)
            elif len(tok) > 1 and tok[0] == "0":
                v = int(tok, 8)  # C octal; digits 8/9 raise -> undecidable
            else:
                v = int(tok)
            return self._check(v)
        raise _CondError(tok)


def _eval_expr(expr: str, defines: dict[str, str]) -> bool | None:
    """Evaluate a #if/#elif constant expression; None = undecidable."""
    expr = _DEFINED_RE.sub(
        lambda m: "1" if (m.group(1) or m.group(2)) in defines else "0", expr
    )
    # substitute known object-like macros (one round is enough for the
    # config-flag style expressions these corpora contain), then ISO
    # semantics: remaining identifiers evaluate to 0
    expr = _ID_RE.sub(lambda m: defines.get(m.group(0), "0"), expr)
    expr = _ID_RE.sub("0", expr)
    # integer suffixes are legal C but not part of the literal value
    expr = re.sub(r"(\d)[uUlL]+", r"\1", expr)
    try:
        v = _CondParser(expr).parse()
    except (_CondError, ValueError):
        return None
    return None if v is None else bool(v)


def _visible_text(line: str, in_block: bool) -> tuple[str, bool]:
    """Replace comment interiors with spaces, as translation phase 3 does
    before directive processing (ISO C 5.1.1.2): a ``#if`` inside a
    ``/* */`` block is plain text, not a directive. Returns the visible
    text and the block-comment state after this line. String/char
    literals shield comment openers; ``//`` hides the rest of the line."""
    out: list[str] = []
    i, n = 0, len(line)
    while i < n:
        if in_block:
            j = line.find("*/", i)
            if j == -1:
                return "".join(out), True
            out.append(" ")
            i = j + 2
            in_block = False
            continue
        c = line[i]
        if c in "\"'":
            j = i + 1
            while j < n and line[j] != c:
                j += 2 if line[j] == "\\" else 1
            j = min(j + 1, n)
            out.append(line[i:j])
            i = j
            continue
        if line.startswith("//", i):
            break
        if line.startswith("/*", i):
            in_block = True
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out), in_block


def _expand_macros(line: str, defines: dict[str, str]) -> str:
    """Expand object-like macros outside string/char literals."""
    if not defines:
        return line
    out: list[str] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in "\"'":
            j = i + 1
            while j < n and line[j] != c:
                j += 2 if line[j] == "\\" else 1
            j = min(j + 1, n)
            out.append(line[i:j])
            i = j
            continue
        m = _ID_RE.match(line, i)
        if m:
            out.append(defines.get(m.group(0), m.group(0)))
            i = m.end()
            continue
        out.append(c)
        i += 1
    return "".join(out)


def evaluate_conditionals(code: str) -> str:
    """Resolve #if/#ifdef/#else/#endif regions; blank inactive lines.

    Line count and the content of active lines' positions are preserved,
    so downstream line numbers match the original source.
    """
    # splice continued directive lines (backslash-newline) logically but
    # keep physical structure by tracking how many lines each consumed
    lines = code.split("\n")
    out: list[str] = []
    defines: dict[str, str] = {}
    #: names that are defined (visible to #ifdef / defined()) but must not
    #: be text-expanded: function-like macros and complex object-like
    #: bodies, both left intact as CDT-style recovery
    no_expand: set[str] = set()
    # stack of (this_branch_active, any_branch_taken, parent_active)
    stack: list[list[bool]] = []

    def active() -> bool:
        return all(fr[0] for fr in stack)

    i = 0
    in_block = False  # /* */ state carried across lines
    while i < len(lines):
        line = lines[i]
        visible, next_block = _visible_text(line, in_block)
        if visible.lstrip().startswith("#"):
            # gather continuation lines (phase-2 splicing precedes
            # comment removal, so the backslash check is on raw text)
            full = line
            span = 1
            while full.rstrip().endswith("\\") and i + span < len(lines):
                full = full.rstrip()[:-1] + lines[i + span]
                span += 1
            # directives are parsed on comment-stripped text: `/* */`
            # interiors become spaces, `//` tails drop (phase 3)
            full, next_block = _visible_text(full, in_block)
            m = _DIRECTIVE_RE.match(full.strip())
            name = m.group(1) if m else ""
            rest = (m.group(2) if m else "").strip()
            parent = active()
            if name == "ifdef":
                cond = rest.split()[0] in defines if rest.split() else False
                stack.append([parent and cond, cond, parent])
            elif name == "ifndef":
                cond = rest.split()[0] not in defines if rest.split() else True
                stack.append([parent and cond, cond, parent])
            elif name == "if":
                v = _eval_expr(rest, defines)
                cond = True if v is None else v
                stack.append([parent and cond, cond, parent])
            elif name == "elif" and stack:
                fr = stack[-1]
                if fr[1]:
                    fr[0] = False
                else:
                    v = _eval_expr(rest, defines)
                    cond = True if v is None else v
                    fr[0] = fr[2] and cond
                    fr[1] = cond
            elif name == "else" and stack:
                fr = stack[-1]
                fr[0] = fr[2] and not fr[1]
                fr[1] = True
            elif name == "endif" and stack:
                stack.pop()
            elif name == "define" and parent:
                dm = _DEFINE_RE.match(rest)
                if dm and not dm.group(2):  # object-like
                    body = dm.group(3)
                    if body and _SIMPLE_BODY_RE.match(body):
                        defines[dm.group(1)] = body
                        no_expand.discard(dm.group(1))
                    elif not body:
                        # valueless annotation macro (`#define UNUSED`):
                        # a real preprocessor removes the name from the
                        # token stream, so expand it to nothing
                        defines[dm.group(1)] = ""
                        no_expand.discard(dm.group(1))
                    else:
                        # complex body we cannot safely expand: defined
                        # (for #ifdef) but the name stays visible
                        defines.setdefault(dm.group(1), "")
                        no_expand.add(dm.group(1))
                elif dm:  # function-like: left intact, parses as a call
                    defines.setdefault(dm.group(1), "")
                    no_expand.add(dm.group(1))
            elif name == "undef" and parent:
                nm = rest.split()[0] if rest.split() else ""
                defines.pop(nm, None)
                no_expand.discard(nm)
            # directive lines themselves are blanked (the lexer would
            # skip them anyway; blanking keeps native/python identical)
            for k in range(span):
                out.append("")
            i += span
            in_block = next_block
            continue
        in_block = next_block
        if active():
            out.append(
                _expand_macros(
                    line,
                    {k: v for k, v in defines.items() if k not in no_expand},
                )
            )
        else:
            out.append("")
        i += 1
    return "\n".join(out)
