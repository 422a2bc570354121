"""C tokenizer for the built-in CPG frontend, with the six non-C
dialects CodeBLEU's structural matches parse (java, c#, js, go, php,
ruby: `DIALECT_OPERATORS`).

The port's copy of the reference's `deepdfa_tpu/frontend/tokens.py`;
its C++ lexer is the port's `native/` library, which lexes C only.
The original DeepDFA delegates all C parsing to the external Joern JVM;
this frontend runs hermetically in-process. The lexer handles the
C-function subset that appears in vulnerability datasets: comments, string
and char literals (with escapes), numeric literals (hex/octal/float/suffix),
all multi-char operators, and preprocessor-line skipping.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

KEYWORDS = {
    "auto", "break", "case", "char", "const", "continue", "default", "do",
    "double", "else", "enum", "extern", "float", "for", "goto", "if",
    "inline", "int", "long", "register", "restrict", "return", "short",
    "signed", "sizeof", "static", "struct", "switch", "typedef", "union",
    "unsigned", "void", "volatile", "while", "_Bool", "bool",
}

# longest-first so maximal munch works
OPERATORS = [
    "<<=", ">>=", "...",
    "::",
    "->", "++", "--", "<<", ">>", "<=", ">=", "==", "!=", "&&", "||",
    "+=", "-=", "*=", "/=", "%=", "&=", "^=", "|=",
    "+", "-", "*", "/", "%", "=", "<", ">", "!", "~", "&", "|", "^",
    "?", ":", ".", ",", ";", "(", ")", "[", "]", "{", "}",
]

#: extra multi-char operators per non-C dialect (CodeBLEU structural
#: matching parses java/c_sharp/js/go/php/ruby snippets through the same
#: frontend — eval/codebleu.py). Non-C dialects always lex through the
#: python path, so the native C++ lexer's bit-identical-on-C contract
#: (tests/test_native.py) is untouched.
DIALECT_OPERATORS: dict[str, list[str]] = {
    "c": [],
    "java": [">>>=", ">>>"],
    "cs": ["??=", "?.", "??", "=>"],
    "js": [">>>=", "===", "!==", ">>>", "??=", "**=", "?.", "??", "**", "=>"],
    "go": [":=", "<-", "&^=", "&^"],
    "php": ["===", "!==", "<=>", "?->", "??=", "**=", ".=", "??", "**", "=>"],
    "ruby": ["<=>", "===", "**=", "**", "=~", "!~", "=>", "&.", ".."],
}

#: dialects whose grammar ends statements at line end (Go's automatic
#: semicolon insertion; Ruby's newline termination). A ';' is inserted
#: when a line's last token can end an expression — Go spec §Semicolons:
#: after an identifier, literal, one of break/continue/fallthrough/
#: return, ++/--, or a closing bracket. Trailing binary operators keep
#: the statement open, exactly the rule both languages rely on.
_ASI_DIALECTS = frozenset(("go", "ruby"))
#: keywords that open a construct and therefore keep the line open
#: (ruby `loop do` / `x = if cond`; C-keyword collisions like `do`)
_ASI_CONTINUE_KW = frozenset(
    ("do", "else", "if", "for", "while", "switch", "case", "default",
     "goto", "struct", "union", "enum", "sizeof")
)


def _ends_statement(tok: Token) -> bool:
    if tok.kind in ("num", "str", "char", "id"):
        return True
    if tok.kind == "kw":
        # break/continue/return/`int` (go: `var x int`) end a line;
        # construct-openers don't
        return tok.text not in _ASI_CONTINUE_KW
    return tok.text in (")", "]", "}", "++", "--")


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # id | kw | num | str | char | op | eof
    text: str
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}:{self.text!r}@{self.line}"


class LexError(ValueError):
    pass


def strip_comments(code: str) -> str:
    """Replace comments with spaces, preserving line structure (the
    reference strips comments during dataset cleaning, datasets.py)."""
    out = []
    i, n = 0, len(code)
    while i < n:
        c = code[i]
        if c == "/" and i + 1 < n and code[i + 1] == "/":
            while i < n and code[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and code[i + 1] == "*":
            j = code.find("*/", i + 2)
            j = n if j == -1 else j + 2
            # keep newlines so line numbers survive
            out.extend(ch if ch == "\n" else " " for ch in code[i:j])
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and code[j] != c:
                j += 2 if code[j] == "\\" else 1
            j = min(j + 1, n)
            out.append(code[i:j])
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(code: str, backend: str = "auto", dialect: str = "c") -> list[Token]:
    """Tokenize C (or C++) source, or a snippet of another dialect.

    backend "auto" routes pure-ASCII input through the native C++ lexer
    (`deepdfa_tpu_torch/native`, built with g++ at first use; equal to
    the Python lexer on ASCII except that native Tokens carry col 0 and
    the end-of-file token sits on the last token's line). Non-ASCII
    input always takes the Python path, whose unicode identifier
    handling the native lexer does not replicate, and so does "auto" on
    a machine without g++. "python" forces the Python lexer (every Token
    carries its column); "native" forces the C++ one and raises on
    non-ASCII input or without g++.

    `dialect` selects extra multi-char operators (DIALECT_OPERATORS), php
    and ruby sigils, js/go backtick strings, and go/ruby newline
    semicolons; any dialect other than "c" lexes through the Python path
    whatever `backend` says, so the C path never moves.
    """
    if dialect != "c":
        if dialect not in DIALECT_OPERATORS:
            raise ValueError(f"unknown dialect {dialect!r}")
        return _tokenize_python(code, dialect)
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python":
        is_ascii = code.isascii()
        if backend == "native" and not is_ascii:
            raise ValueError("native lexer only supports ASCII input; use backend='auto'")
        if is_ascii:
            from deepdfa_tpu_torch import native

            if native.available():
                toks = native.lex_c_native(code)
                toks.append(Token("eof", "", toks[-1].line if toks else 1, 0))
                return toks
            if backend == "native":
                raise RuntimeError(
                    "native backend requested but g++ is not on PATH to build "
                    "libdeepdfa_native (python -m deepdfa_tpu_torch.native.build)")
    return _tokenize_python(code)


def _tokenize_python(code: str, dialect: str = "c") -> list[Token]:
    code = strip_comments(code)
    operators = (
        sorted(DIALECT_OPERATORS[dialect] + OPERATORS, key=len, reverse=True)
        if dialect != "c"
        else OPERATORS
    )
    asi = dialect in _ASI_DIALECTS
    toks: list[Token] = []
    line, col = 1, 1
    i, n = 0, len(code)

    def emit(kind, text, l, c):
        toks.append(Token(kind, text, l, c))

    while i < n:
        c = code[i]
        if c == "\n":
            if asi and toks and _ends_statement(toks[-1]):
                emit("op", ";", line, col)
            line += 1
            col = 1
            i += 1
            continue
        if c in " \t\r\f\v":
            i += 1
            col += 1
            continue
        if c == "#":  # preprocessor directive: skip to end of (continued) line
            while i < n and code[i] != "\n":
                if code[i] == "\\" and i + 1 < n and code[i + 1] == "\n":
                    i += 2
                    line += 1
                else:
                    i += 1
            continue
        start_l, start_c = line, col
        if (
            (
                c == "$"
                and dialect in ("php", "ruby")
                and i + 1 < n
                and (code[i + 1].isalpha() or code[i + 1] == "_")
            )
            or (
                c == "@"
                and dialect == "ruby"
                and i + 1 < n
                and (
                    code[i + 1].isalpha()
                    or code[i + 1] == "_"
                    or code[i + 1] == "@"
                )
            )
        ):
            # php/ruby variables: the sigil ($ / @ / @@) is part of the
            # identifier
            j = i + 1
            if c == "@" and code[j] == "@":
                j += 1
            while j < n and (code[j].isalnum() or code[j] == "_"):
                j += 1
            emit("id", code[i:j], start_l, start_c)
            col += j - i
            i = j
            continue
        if c == "`" and dialect in ("js", "go"):
            # js template literal / go raw string: one opaque string token
            j = i + 1
            while j < n and code[j] != "`":
                if dialect == "js" and code[j] == "\\":
                    j += 1
                if j < n and code[j] == "\n":
                    line += 1
                j += 1
            j = min(j + 1, n)
            emit("str", code[i:j], start_l, start_c)
            col += j - i
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (code[j].isalnum() or code[j] == "_"):
                j += 1
            text = code[i:j]
            emit("kw" if text in KEYWORDS else "id", text, start_l, start_c)
            col += j - i
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and code[i + 1].isdigit()):
            j = i
            if c == "0" and i + 1 < n and code[i + 1] in "xX":
                j = i + 2
                while j < n and (code[j].isdigit() or code[j] in "abcdefABCDEF"):
                    j += 1
            else:
                while j < n and (
                    code[j].isdigit()
                    or (
                        code[j] == "."
                        # ruby ranges: `1..9` is num op num, never `1..`
                        and not (
                            dialect == "ruby" and code[j : j + 2] == ".."
                        )
                    )
                ):
                    j += 1
                if j < n and code[j] in "eE":  # exponent
                    k = j + 1
                    if k < n and code[k] in "+-":
                        k += 1
                    if k < n and code[k].isdigit():
                        j = k
                        while j < n and code[j].isdigit():
                            j += 1
            while j < n and code[j] in "uUlLfF":
                j += 1
            emit("num", code[i:j], start_l, start_c)
            col += j - i
            i = j
            continue
        if c in "\"'":
            j = i + 1
            while j < n and code[j] != c:
                if code[j] == "\\":
                    j += 1
                if j < n and code[j] == "\n":
                    line += 1
                j += 1
            j = min(j + 1, n)
            emit("str" if c == '"' else "char", code[i:j], start_l, start_c)
            col += j - i
            i = j
            continue
        for op in operators:
            if code.startswith(op, i):
                if (
                    dialect == "ruby"
                    and op in ("?", "!")
                    and toks
                    and toks[-1].kind == "id"
                    and toks[-1].line == start_l
                    and toks[-1].col + len(toks[-1].text) == start_c
                ):
                    # ruby method-name suffixes: `empty?` / `save!` are
                    # one identifier (a spaced `x ? y : z` stays ternary)
                    toks[-1] = Token(
                        "id", toks[-1].text + op, start_l, toks[-1].col
                    )
                else:
                    emit("op", op, start_l, start_c)
                i += len(op)
                col += len(op)
                break
        else:
            # unknown byte (e.g. stray unicode): skip, stay robust
            i += 1
            col += 1
    toks.append(Token("eof", "", line, col))
    return toks


def iter_tokens(code: str) -> Iterator[Token]:
    yield from tokenize(code)
