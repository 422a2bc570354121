"""Repo walker + C/C++ function splitter (docs/scanning.md).

The serving frontend scores ONE function at a time (that is what the
training corpus taught the model); a repository is files of many. This
module bridges the two without a compiler toolchain:

- `walk_repo` discovers candidate sources under a root: configured
  suffixes only, hidden and excluded directories pruned anywhere in the
  tree, oversized files skipped (generated/amalgamated sources dominate
  scan time and drown findings), deterministic order, content hashed for
  the file-level incremental check.
- `split_functions` splits one translation unit into top-level function
  definitions by lexing, not parsing: comments, string/char literals and
  preprocessor lines are masked first (so braces inside them cannot
  corrupt nesting), then top-level `{...}` blocks whose header looks
  like `... name ( ... ) [const|noexcept|...]` are taken as functions.
  `namespace`/`extern "C"` blocks are transparent (functions inside are
  found); class/struct bodies are opaque (out-of-line methods are still
  found, in-class definitions are not — documented walker rule).

Each `FunctionSpan` carries the function's full source lines and its
1-based line range in the file, so per-node attributions (computed in
the function's own coordinates) map back to absolute file lines.

The port's copy of the JAX package's `deepdfa_tpu/scan/walker.py`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from pathlib import Path
from typing import Iterable

#: header tokens that can never be a function name: control/operator
#: keywords, attribute machinery, and reserved type/storage words (a
#: declarator like `int (*f(void))(int)` puts `int (` before `f (`)
_NOT_A_NAME = frozenset({
    "if", "for", "while", "switch", "do", "else", "return", "sizeof",
    "catch", "defined", "alignof", "decltype", "typeof",
    "__attribute__", "__declspec", "_Alignas", "static_assert",
    "_Static_assert", "asm", "__asm__", "noexcept", "throw",
    "int", "void", "char", "long", "short", "unsigned", "signed",
    "float", "double", "bool", "_Bool", "auto", "register", "volatile",
    "const", "static", "inline", "struct", "union", "enum",
    "template", "typename", "typedef",
})

#: tokens allowed between the closing `)` and the body `{`
_TRAILERS = frozenset({
    "const", "noexcept", "override", "final", "volatile", "restrict",
    "try", "&", "&&",
})

_IDENT_PAREN = re.compile(r"([A-Za-z_~][A-Za-z0-9_]*)\s*\(")


@dataclasses.dataclass(frozen=True)
class FunctionSpan:
    """One discovered function definition."""

    name: str
    start_line: int  # 1-based, inclusive (first header line)
    end_line: int  # 1-based, inclusive (closing brace line)
    code: str  # the full source lines start_line..end_line

    @property
    def n_lines(self) -> int:
        return self.end_line - self.start_line + 1


@dataclasses.dataclass(frozen=True)
class SourceFile:
    """One discovered source file."""

    path: Path  # absolute
    rel: str  # repo-relative, posix separators (the SARIF uri)
    text: str
    sha256: str


def mask_code(text: str) -> str:
    """A same-length copy with comment bodies, string/char literal
    contents, and preprocessor lines blanked (newlines preserved) —
    brace/paren scanning over the result cannot be fooled by `{` in a
    string or an unbalanced `#define`."""
    out = list(text)
    n = len(text)
    i = 0
    state = "normal"  # | line_comment | block_comment | string | char
    line_start = True  # at start-of-line modulo whitespace
    in_directive = False

    def blank(j: int) -> None:
        if out[j] != "\n":
            out[j] = " "

    while i < n:
        c = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        if state == "normal":
            if in_directive:
                # a preprocessor line runs to an unescaped newline
                if c == "\n" and text[i - 1 : i] != "\\":
                    in_directive = False
                    line_start = True
                else:
                    blank(i)
                i += 1
                continue
            if c == "/" and nxt == "/":
                state = "line_comment"
                blank(i)
                i += 1
            elif c == "/" and nxt == "*":
                state = "block_comment"
                blank(i)
                i += 1
            elif c == '"':
                state = "string"
            elif c == "'":
                state = "char"
            elif c == "#" and line_start:
                in_directive = True
                blank(i)
            if c == "\n":
                line_start = True
            elif not c.isspace():
                line_start = False
        elif state == "line_comment":
            if c == "\n":
                state = "normal"
                line_start = True
            else:
                blank(i)
        elif state == "block_comment":
            if c == "*" and nxt == "/":
                state = "normal"
                blank(i)
                i += 1
                blank(i)
                i += 1
                continue
            blank(i)
        else:  # string | char: keep the quotes, blank the contents
            quote = '"' if state == "string" else "'"
            if c == "\\":
                blank(i)
                i += 1
                if i < n:
                    blank(i)
                i += 1
                continue
            if c == quote:
                state = "normal"
            else:
                blank(i)
        i += 1
    return "".join(out)


def _header_name(header: str) -> str | None:
    """Function name from a masked header, or None when the header is
    not a function definition. The first `ident (`-shaped token that is
    not a keyword/attribute wins — this resolves `static inline int
    foo(...)`, `int (*f(void))(int)` (f), and attribute-macro prefixes."""
    if "(" not in header or "=" in header:
        return None
    # everything after the LAST ')' must be benign trailer tokens
    tail = header[header.rfind(")") + 1 :]
    for tok in tail.replace("->", " ").split():
        if tok not in _TRAILERS and not re.fullmatch(
            r"[A-Za-z_][A-Za-z0-9_:<>,\s]*", tok
        ):
            return None
    for m in _IDENT_PAREN.finditer(header):
        name = m.group(1)
        if name in _NOT_A_NAME:
            continue
        # qualified methods arrive as `Cls::method(` — the regex grabs
        # the trailing identifier already; reject pure operator spellings
        return name
    return None


def _is_transparent(header: str) -> bool:
    """Blocks the splitter descends into rather than consuming: C++
    namespaces and extern "C" linkage blocks (masked strings leave
    `extern ""`)."""
    toks = header.split()
    if not toks:
        return False
    if "namespace" in toks:
        return True
    return toks[0] == "extern" and '"' in header and "(" not in header


def split_functions(text: str, min_lines: int = 1) -> list[FunctionSpan]:
    """Top-level function definitions in one source text, in file
    order. Line numbers are 1-based and inclusive."""
    masked = mask_code(text)
    lines = text.split("\n")
    # line number of every character index, computed lazily via count
    out: list[FunctionSpan] = []
    n = len(masked)
    i = 0
    boundary = 0  # start of the current potential header (masked idx)
    depth_stack: list[str] = []  # "opaque" | "transparent" markers

    def line_of(idx: int) -> int:
        return masked.count("\n", 0, idx) + 1

    def at_top() -> bool:
        # function headers can start at file scope OR directly inside
        # transparent (namespace / extern "C") blocks — statement
        # boundaries must reset in both, or a `int g_x = 0;` inside an
        # extern block would poison the next function's header
        return not depth_stack or depth_stack[-1] == "transparent"

    while i < n:
        c = masked[i]
        if c in ";":
            if at_top():
                boundary = i + 1
        elif c == "}":
            if depth_stack:
                depth_stack.pop()
            if at_top():
                boundary = i + 1
        elif c == "{":
            header = masked[boundary:i]
            if at_top():
                if _is_transparent(header):
                    depth_stack.append("transparent")
                    boundary = i + 1
                    i += 1
                    continue
                name = _header_name(header)
                if name is not None:
                    end = _match_brace(masked, i)
                    if end is None:
                        break  # unbalanced tail: stop cleanly
                    start_idx = boundary + (len(header) - len(header.lstrip()))
                    start_line = line_of(start_idx)
                    end_line = line_of(end)
                    if end_line - start_line + 1 >= min_lines:
                        out.append(FunctionSpan(
                            name=name,
                            start_line=start_line,
                            end_line=end_line,
                            code="\n".join(
                                lines[start_line - 1 : end_line]
                            ),
                        ))
                    boundary = end + 1
                    i = end + 1
                    continue
            depth_stack.append("opaque")
            boundary = i + 1
        i += 1
    return out


def _match_brace(masked: str, open_idx: int) -> int | None:
    """Index of the `}` matching the `{` at open_idx, or None."""
    depth = 0
    for j in range(open_idx, len(masked)):
        if masked[j] == "{":
            depth += 1
        elif masked[j] == "}":
            depth -= 1
            if depth == 0:
                return j
    return None


def walk_repo(
    root: str | Path,
    suffixes: Iterable[str],
    exclude_dirs: Iterable[str],
    max_file_bytes: int,
    stats: dict | None = None,
) -> list[SourceFile]:
    """Deterministically ordered candidate sources under `root`.

    `stats` (optional dict) receives "files_seen", "files_too_large",
    "files_unreadable"."""
    root = Path(root).resolve()
    if not root.is_dir():
        raise FileNotFoundError(f"scan root {root} is not a directory")
    suffixes = {s.lower() for s in suffixes}
    exclude = set(exclude_dirs)
    if stats is None:
        stats = {}
    stats.update(files_seen=0, files_too_large=0, files_unreadable=0)
    out: list[SourceFile] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in exclude and not d.startswith(".")
        )
        for fn in sorted(filenames):
            p = Path(dirpath) / fn
            if p.suffix.lower() not in suffixes:
                continue
            stats["files_seen"] += 1
            try:
                if p.stat().st_size > max_file_bytes:
                    stats["files_too_large"] += 1
                    continue
                text = p.read_text(errors="replace")
            except OSError:
                stats["files_unreadable"] += 1
                continue
            out.append(SourceFile(
                path=p,
                rel=p.relative_to(root).as_posix(),
                text=text,
                sha256=hashlib.sha256(
                    text.encode("utf-8", "replace")
                ).hexdigest(),
            ))
    return out
