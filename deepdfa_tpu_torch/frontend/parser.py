"""Recursive-descent C-function parser -> CPG-lite.

Parses a single C/C++ function (the unit of all DeepDFA datasets) into the
Joern-compatible CPG of frontend/cpg.py: expression ASTs with operator CALL
nodes, ARGUMENT edges with operand order, IDENTIFIER type annotation from a
scoped symbol table, and an expression-level CFG (post-order evaluation
chains per statement, branch/loop/switch/goto wiring, METHOD entry and
METHOD_RETURN exit).

Error recovery is Joern-like: statements that fail to parse become opaque
UNKNOWN nodes that still occupy their place in the CFG, so one weird line
never loses a whole function.

The port's copy of the reference's `deepdfa_tpu/frontend/parser.py`.
"""

from __future__ import annotations

from deepdfa_tpu_torch.frontend import cpg as C
from deepdfa_tpu_torch.frontend.tokens import Token, tokenize

TYPE_KEYWORDS = {
    "void", "char", "short", "int", "long", "float", "double", "signed",
    "unsigned", "_Bool", "bool", "struct", "union", "enum", "const",
    "volatile", "static", "register", "auto", "extern", "inline", "restrict",
    "typedef",
}

ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>="}

# binary precedence (higher binds tighter); assignment/conditional handled
# separately (right-assoc)
BIN_PREC = {
    "||": 1, "&&": 2, "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}

class ParseError(ValueError):
    pass


class _Scope:
    def __init__(self, parent=None):
        self.parent = parent
        self.vars: dict[str, str] = {}

    def lookup(self, name: str) -> str | None:
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None


# ---------------------------------------------------------------------------
# statement tree (intermediate, only for CFG construction)


class _Stmt:
    pass


class _Expr(_Stmt):
    def __init__(self, top: int | None):
        self.top = top  # CPG node id of the expression root (None = empty)


class _Seq(_Stmt):
    def __init__(self, body: list[_Stmt]):
        self.body = body


class _If(_Stmt):
    def __init__(self, cond: _Expr, then: _Stmt, els: _Stmt | None):
        self.cond, self.then, self.els = cond, then, els


class _While(_Stmt):
    def __init__(self, cond: _Expr, body: _Stmt):
        self.cond, self.body = cond, body


class _DoWhile(_Stmt):
    def __init__(self, body: _Stmt, cond: _Expr):
        self.body, self.cond = body, cond


class _For(_Stmt):
    def __init__(self, init, cond, update, body):
        self.init, self.cond, self.update, self.body = init, cond, update, body


class _Switch(_Stmt):
    #: cases: (is_default, label_code e.g. "case 0"/"default", line, body),
    #: in source order
    def __init__(self, cond: _Expr, cases: list[tuple[bool, str, int | None, _Stmt]], has_default: bool):
        self.cond, self.cases, self.has_default = cond, cases, has_default


class _Return(_Stmt):
    def __init__(self, expr: _Expr | None, node: int):
        self.expr, self.node = expr, node


class _Break(_Stmt):
    def __init__(self, line: int | None = None):
        self.line = line


class _Continue(_Stmt):
    def __init__(self, line: int | None = None):
        self.line = line


class _Goto(_Stmt):
    def __init__(self, label: str, node: int):
        self.label, self.node = label, node


class _Label(_Stmt):
    def __init__(self, name: str, line: int | None = None):
        self.name = name
        self.line = line


class _Try(_Stmt):
    #: handlers: (catch_node_id, body) per catch clause
    def __init__(self, body: _Stmt, handlers: list[tuple[int, _Stmt]]):
        self.body, self.handlers = body, handlers


class _Throw(_Stmt):
    def __init__(self, node: int):
        self.node = node


class _RangeFor(_Stmt):
    #: C++ range-for: `for (decl : expr) body`; expr_top is the per-
    #: iteration assignment call at the for line
    def __init__(self, expr: _Expr, body: _Stmt):
        self.expr, self.body = expr, body


# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, code: str):
        from deepdfa_tpu_torch.frontend.preproc import evaluate_conditionals

        # resolve #if/#ifdef regions + expand file-local object macros
        # BEFORE lexing (shared pre-pass, so the native and python
        # lexers stay bit-identical); line structure is preserved
        self.toks = tokenize(evaluate_conditionals(code))
        self.i = 0
        self.cpg: C.Cpg | None = None
        self.scope = _Scope()

    # -- token helpers -------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def at(self, text: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.text == text and t.kind in ("op", "kw")

    def eat(self, text: str | None = None) -> Token:
        t = self.peek()
        if text is not None and t.text != text:
            raise ParseError(f"expected {text!r}, got {t!r}")
        self.i += 1
        return t

    def at_eof(self) -> bool:
        return self.peek().kind == "eof"

    # -- type parsing --------------------------------------------------------

    def _at_type_start(self) -> bool:
        t = self.peek()
        if t.kind == "id" and self._at_new_delete():
            return False  # `delete p;` / `new T` statements are expressions
        if t.kind == "kw" and t.text in TYPE_KEYWORDS:
            return True
        # `Foo * bar` / `Foo bar` / `a::b::Foo* bar` typedef heuristic:
        # (possibly qualified) id, optional template args, then stars/refs,
        # then an id followed by a declarator-ish token
        if t.kind == "id":
            k = 1
            while self.peek(k).text == "::" and self.peek(k + 1).kind == "id":
                k += 2
            if self.peek(k).text == "<":
                k2 = self._match_angle(k)
                if k2 is not None:
                    k = k2
            while self.peek(k).text in ("*", "&"):
                k += 1
            nxt = self.peek(k)
            if nxt.kind == "id" and k > 0:
                after = self.peek(k + 1)
                if after.text in (";", "=", ",", "[", ")"):
                    return True
        return False

    # tokens that cannot occur in a template argument list: their presence
    # means the '<' was a comparison (e.g. `a < b && c > d;`)
    _NOT_TEMPLATE = frozenset(
        ("&&", "||", "==", "!=", "<=", ">=", "!", "+", "-", "/", "%", "?",
         "=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>=")
    )

    def _match_angle(self, k: int) -> int | None:
        """If peek(k) is '<' opening a plausible template argument list,
        return the offset just past the matching '>'; else None."""
        if self.peek(k).text != "<":
            return None
        depth = 0
        limit = k + 64
        while k < limit:
            t = self.peek(k)
            if (
                t.kind == "eof"
                or t.kind in ("str", "char")
                or t.text in (";", "{", "}")
                or t.text in self._NOT_TEMPLATE
            ):
                return None
            if t.text == "<":
                depth += 1
            elif t.text == ">":
                depth -= 1
                if depth == 0:
                    return k + 1
            elif t.text == ">>":
                depth -= 2
                if depth <= 0:
                    return k + 1
            k += 1
        return None

    @staticmethod
    def _join_type_tokens(toks: list[str]) -> str:
        """Join type tokens, spacing word-word boundaries (unsigned long)."""
        out = ""
        prev_word = False
        for t in toks:
            word = bool(t) and (t[0].isalpha() or t[0] == "_")
            if out and prev_word and word:
                out += " "
            out += t
            prev_word = word
        return out

    def _eat_angle_args(self) -> str:
        """Consume a balanced <...> run (pre-validated by _match_angle);
        returns its text incl. brackets."""
        end = self._match_angle(0)
        if end is None:
            return ""
        return self._join_type_tokens([self.eat().text for _ in range(end)])

    def _eat_qualified_name(self) -> str:
        """id(::id)* with optional trailing template args -> one name."""
        name = self.eat().text
        while self.at("::") and self.peek(1).kind == "id":
            self.eat()
            name += "::" + self.eat().text
        if self._match_angle(0) is not None:
            name += self._eat_angle_args()
        return name

    _QUALIFIERS = frozenset(
        ("const", "volatile", "static", "register", "auto", "extern",
         "inline", "restrict", "typedef")
    )

    def _parse_type(self, in_params: bool = False) -> str:
        """Consume type specifier tokens; return canonical type string.

        in_params: parameter lists have no initializers, so a bare id
        before ','/')' IS the type (`void f(Foo)`), whereas in statement
        position it is the declarator name (`static x = 1;`)."""
        parts: list[str] = []

        def saw_base() -> bool:
            return any(p not in self._QUALIFIERS for p in parts)

        while True:
            t = self.peek()
            if t.kind == "kw" and t.text in TYPE_KEYWORDS:
                if t.text in ("struct", "union", "enum"):
                    parts.append(self.eat().text)
                    if self.peek().kind == "id":
                        parts.append(self.eat().text)
                    # inline body {...}: skip it
                    if self.at("{"):
                        depth = 0
                        while True:
                            tt = self.eat()
                            if tt.text == "{":
                                depth += 1
                            elif tt.text == "}":
                                depth -= 1
                                if depth == 0:
                                    break
                            if tt.kind == "eof":
                                break
                    continue
                parts.append(self.eat().text)
                continue
            if t.kind == "id" and t.text == "decltype" and self.peek(1).text == "(":
                # C++ decltype(expr) as a type atom: keep the token text,
                # skip the parenthesized expression
                self.eat()
                depth = 0
                while not self.at_eof():
                    tt = self.eat()
                    if tt.text == "(":
                        depth += 1
                    elif tt.text == ")":
                        depth -= 1
                        if depth == 0:
                            break
                parts.append("decltype(...)")
                continue
            if t.kind == "id" and not saw_base():
                # don't eat the declarator NAME as a base type: plain id
                # directly followed by a declarator terminator is the
                # variable of an implicit-int decl (`static x = 1;`)
                if not in_params and self.peek(1).text in ("=", ";", ",", ")", "["):
                    break
                parts.append(self._eat_qualified_name())
                continue
            break
        base = " ".join(p for p in parts if p not in self._QUALIFIERS)
        return base or "ANY"

    def _parse_declarator(self, base: str) -> tuple[str | None, str]:
        """Parse `*|& name [dims]` -> (name, full type string)."""
        stars = 0
        while (
            self.at("*")
            or self.at("&")
            or (
                self.peek().kind == "kw"
                and self.peek().text in ("const", "restrict", "volatile")
            )
        ):
            if self.at("*"):
                stars += 1
            self.eat()  # '&' references keep the base type, like joern
        name = None
        if self.peek().kind == "id":
            name = self.eat().text
        arrays = 0
        while self.at("["):
            depth = 0
            while True:
                t = self.eat()
                if t.text == "[":
                    depth += 1
                elif t.text == "]":
                    depth -= 1
                    if depth == 0:
                        break
                if t.kind == "eof":
                    break
            arrays += 1
        full = base + "*" * stars + "[]" * arrays
        return name, full

    # -- expressions ---------------------------------------------------------

    def _node(self, label, name="", code="", line=None, type_full_name="ANY"):
        return self.cpg.add_node(
            label, name=name, code=code, line=line, type_full_name=type_full_name
        )

    def _call(self, name: str, code: str, line: int, args: list[int]) -> int:
        nid = self._node("CALL", name=name, code=code, line=line)
        for order, a in enumerate(args, start=1):
            self.cpg.nodes[a].order = order
            self.cpg.add_edge(nid, a, C.AST)
            self.cpg.add_edge(nid, a, C.ARGUMENT)
        return nid

    def _code(self, nid: int) -> str:
        return self.cpg.nodes[nid].code

    def _looks_like_cast(self) -> bool:
        """At '(' — is this `(type) expr`?"""
        if not self.at("("):
            return False
        k = 1
        t = self.peek(k)
        if t.kind == "kw" and t.text in TYPE_KEYWORDS:
            pass
        elif t.kind == "id":
            # (Foo*)x or (Foo)x — require '*' or ')' right after the id,
            # and the token after ')' must start an expression
            k2 = k + 1
            stars = 0
            while self.peek(k2).text == "*":
                stars += 1
                k2 += 1
            if self.peek(k2).text != ")":
                return False
            nxt = self.peek(k2 + 1)
            return stars > 0 and (
                nxt.kind in ("id", "num", "str", "char")
                or nxt.text in ("(", "*", "&", "!", "~", "-", "+", "++", "--")
            )
        else:
            return False
        return True

    def parse_expression(self) -> int:
        return self._parse_comma()

    def _parse_comma(self) -> int:
        first = self._parse_assign()
        if not self.at(","):
            return first
        items = [first]
        line = self.cpg.nodes[first].line
        while self.at(","):
            self.eat()
            items.append(self._parse_assign())
        code = ", ".join(self._code(x) for x in items)
        return self._call(C.COMMA, code, line, items)

    def _parse_assign(self) -> int:
        lhs = self._parse_conditional()
        t = self.peek()
        if t.kind == "op" and t.text in ASSIGN_OPS:
            op = self.eat().text
            rhs = self._parse_assign()
            code = f"{self._code(lhs)} {op} {self._code(rhs)}"
            return self._call(
                C.OP_NAMES[op], code, self.cpg.nodes[lhs].line, [lhs, rhs]
            )
        return lhs

    def _parse_conditional(self) -> int:
        cond = self._parse_binary(1)
        if not self.at("?"):
            return cond
        self.eat("?")
        then = self._parse_assign()
        self.eat(":")
        els = self._parse_conditional()
        code = f"{self._code(cond)} ? {self._code(then)} : {self._code(els)}"
        return self._call(
            C.CONDITIONAL, code, self.cpg.nodes[cond].line, [cond, then, els]
        )

    def _parse_binary(self, min_prec: int) -> int:
        lhs = self._parse_unary()
        while True:
            t = self.peek()
            prec = BIN_PREC.get(t.text) if t.kind == "op" else None
            if prec is None or prec < min_prec:
                return lhs
            op = self.eat().text
            rhs = self._parse_binary(prec + 1)
            code = f"{self._code(lhs)} {op} {self._code(rhs)}"
            lhs = self._call(
                C.OP_NAMES[op], code, self.cpg.nodes[lhs].line, [lhs, rhs]
            )

    def _parse_unary(self) -> int:
        t = self.peek()
        if t.kind == "op" and t.text in ("++", "--"):
            self.eat()
            operand = self._parse_unary()
            code = f"{t.text}{self._code(operand)}"
            return self._call(C.PRE_INC_DEC[t.text], code, t.line, [operand])
        if t.kind == "op" and t.text in ("!", "~", "-", "+", "*", "&"):
            self.eat()
            operand = self._parse_unary()
            code = f"{t.text}{self._code(operand)}"
            return self._call(C.UNARY_OP_NAMES[t.text], code, t.line, [operand])
        if t.kind == "kw" and t.text == "sizeof":
            self.eat()
            if self.at("("):
                # sizeof(type) or sizeof(expr): consume balanced parens
                depth = 0
                texts = []
                while True:
                    tt = self.eat()
                    texts.append(tt.text)
                    if tt.text == "(":
                        depth += 1
                    elif tt.text == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    if tt.kind == "eof":
                        break
                inner = " ".join(texts[1:-1])
                arg = self._node("UNKNOWN", code=inner, line=t.line)
                return self._call(C.SIZEOF, f"sizeof({inner})", t.line, [arg])
            operand = self._parse_unary()
            return self._call(
                C.SIZEOF, f"sizeof {self._code(operand)}", t.line, [operand]
            )
        if t.kind == "id" and self._at_new_delete():
            return self._parse_new_delete()
        if self._looks_like_cast():
            lp = self.eat("(")
            # in_params mode: the type is followed by ')' (a declarator
            # terminator), which statement mode refuses to consume
            base = self._parse_type(in_params=True)
            stars = 0
            while self.at("*"):
                self.eat()
                stars += 1
            self.eat(")")
            ty = base + "*" * stars
            operand = self._parse_unary()
            # joern cast: arg 1 = TYPE_REF, arg 2 = expression
            tref = self._node("TYPE_REF", code=ty, line=lp.line, type_full_name=ty)
            code = f"({ty}) {self._code(operand)}"
            return self._call(C.CAST, code, lp.line, [tref, operand])
        return self._parse_postfix()

    def _at_new_delete(self) -> bool:
        """Is this C++ operator new/delete (vs. 'new' as a plain C
        identifier, legal and common in old C code)?"""
        t = self.peek()
        if t.kind != "id" or t.text not in ("new", "delete"):
            return False
        nxt = self.peek(1)
        if t.text == "delete":
            # delete[] p / delete p — but not `delete(x)` C calls or
            # `delete->field` / `delete = x` identifier uses
            return (nxt.text == "[" and self.peek(2).text == "]") or (
                nxt.kind == "id"
            )
        # new <type-ish>: a type keyword, or an id that heads a type
        if nxt.kind == "kw" and nxt.text in TYPE_KEYWORDS:
            return True
        if nxt.kind == "id":
            after = self.peek(2)
            return after.text in ("(", "[", ";", ")", ",", "*", "::", "<")
        return False

    def _parse_new_delete(self) -> int:
        """C++ new/delete as joern-style operator calls."""
        t = self.eat()  # 'new' | 'delete'
        if t.text == "delete":
            arr = ""
            if self.at("[") and self.peek(1).text == "]":
                self.eat()
                self.eat()
                arr = "[]"
            operand = self._parse_unary()
            code = f"delete{arr} {self._code(operand)}"
            return self._call("<operator>.delete", code, t.line, [operand])
        # new Type, new Type(args), new Type[n] — class-name types are
        # consumed as qualified names (the statement-position terminator
        # guard in _parse_type would refuse `Obj` before ';'/'[')
        if self.peek().kind == "id":
            base = self._eat_qualified_name()
        else:
            base = self._parse_type(in_params=True)
        stars = 0
        while self.at("*"):
            self.eat()
            stars += 1
        ty = base + "*" * stars
        tref = self._node("TYPE_REF", code=ty, line=t.line, type_full_name=ty)
        args = [tref]
        code = f"new {ty}"
        if self.at("("):
            self.eat("(")
            while not self.at(")") and not self.at_eof():
                args.append(self._parse_assign())
                if self.at(","):
                    self.eat()
            if self.at(")"):
                self.eat(")")
            code += "(...)"
        elif self.at("["):
            self.eat("[")
            size = self.parse_expression()
            if self.at("]"):
                self.eat("]")
            args.append(size)
            code = f"new {ty}[{self._code(size)}]"
        return self._call("<operator>.new", code, t.line, args)

    def _parse_postfix(self) -> int:
        node = self._parse_primary()
        while True:
            t = self.peek()
            if self.at("("):
                # function call: node must be an identifier or expression
                self.eat("(")
                args = []
                if not self.at(")"):
                    args.append(self._parse_assign())
                    while self.at(","):
                        self.eat()
                        args.append(self._parse_assign())
                self.eat(")")
                callee = self.cpg.nodes[node]
                fname = callee.name if callee.label == "IDENTIFIER" else self._code(node)
                code = f"{fname}({', '.join(self._code(a) for a in args)})"
                # joern: the callee identifier is not an argument; drop the
                # identifier node for direct calls and name the CALL after it
                call = self._call(fname, code, callee.line or t.line, args)
                node = call
            elif self.at("["):
                self.eat("[")
                idx = self.parse_expression()
                self.eat("]")
                code = f"{self._code(node)}[{self._code(idx)}]"
                node = self._call(
                    C.INDEX_ACCESS, code, self.cpg.nodes[node].line, [node, idx]
                )
            elif self.at(".") or self.at("->"):
                op = self.eat().text
                fld = self.eat()
                fid = self._node("FIELD_IDENTIFIER", name=fld.text, code=fld.text, line=fld.line)
                code = f"{self._code(node)}{op}{fld.text}"
                name = C.FIELD_ACCESS if op == "." else C.INDIRECT_FIELD_ACCESS
                node = self._call(name, code, self.cpg.nodes[node].line, [node, fid])
            elif t.kind == "op" and t.text in ("++", "--"):
                self.eat()
                code = f"{self._code(node)}{t.text}"
                node = self._call(
                    C.POST_INC_DEC[t.text], code, self.cpg.nodes[node].line, [node]
                )
            else:
                return node

    _CXX_CASTS = ("static_cast", "dynamic_cast", "reinterpret_cast", "const_cast")

    def _parse_primary(self) -> int:
        t = self.peek()
        if t.kind == "id":
            if t.text in self._CXX_CASTS and self._match_angle(1) is not None:
                # static_cast<T>(expr) -> joern-style cast call
                self.eat()
                angle = self._eat_angle_args()
                ty = angle[1:-1]  # strip the outer <>
                self.eat("(")
                operand = self.parse_expression()
                self.eat(")")
                tref = self._node("TYPE_REF", code=ty, line=t.line, type_full_name=ty)
                code = f"{t.text}<{ty}>({self._code(operand)})"
                return self._call(C.CAST, code, t.line, [tref, operand])
            name = t.text
            self.eat()
            while self.at("::") and self.peek(1).kind == "id":
                self.eat()
                name += "::" + self.eat().text
            ty = self.scope.lookup(name) or "ANY"
            return self._node(
                "IDENTIFIER", name=name, code=name, line=t.line, type_full_name=ty
            )
        if t.kind == "num":
            self.eat()
            return self._node("LITERAL", code=t.text, line=t.line)
        if t.kind in ("str", "char"):
            self.eat()
            return self._node("LITERAL", code=t.text, line=t.line)
        if self.at("("):
            self.eat("(")
            inner = self.parse_expression()
            self.eat(")")
            return inner
        if t.kind == "kw" and t.text in ("true", "false"):
            self.eat()
            return self._node("LITERAL", code=t.text, line=t.line)
        raise ParseError(f"unexpected token {t!r}")

    # -- statements ----------------------------------------------------------

    def _skip_to_semicolon(self) -> None:
        depth = 0
        while not self.at_eof():
            t = self.peek()
            if t.text in ("(", "[", "{"):
                depth += 1
            elif t.text in (")", "]", "}"):
                if depth == 0:
                    return
                depth -= 1
            elif t.text == ";" and depth == 0:
                self.eat()
                return
            self.eat()

    def parse_statement(self) -> _Stmt:
        t = self.peek()
        start = self.i
        try:
            stmt = self._parse_statement_inner()
        except ParseError:
            # error recovery: opaque UNKNOWN node occupying CFG position
            self._skip_to_semicolon()
            node = self._node("UNKNOWN", code="<parse error>", line=t.line)
            stmt = _Expr(node)
        if self.i == start and not self.at_eof():
            # no progress (e.g. `volatile(...)` gnu-ism): consume defensively
            self._skip_to_semicolon()
            if self.i == start:
                self.eat()
        return stmt

    def _parse_statement_inner(self) -> _Stmt:
        t = self.peek()
        if self.at(";"):
            self.eat()
            return _Expr(None)
        if self.at("{"):
            return self._parse_block()
        if t.kind == "kw":
            if t.text == "if":
                return self._parse_if()
            if t.text == "while":
                return self._parse_while()
            if t.text == "do":
                return self._parse_do()
            if t.text == "for":
                return self._parse_for()
            if t.text == "switch":
                return self._parse_switch()
            if t.text == "return":
                self.eat()
                expr = None
                if not self.at(";"):
                    expr = _Expr(self.parse_expression())
                if self.at(";"):
                    self.eat()
                code = "return" + (f" {self._code(expr.top)}" if expr and expr.top is not None else "")
                node = self._node("RETURN", name="return", code=code, line=t.line)
                if expr and expr.top is not None:
                    self.cpg.add_edge(node, expr.top, C.AST)
                    self.cpg.add_edge(node, expr.top, C.ARGUMENT)
                    self.cpg.nodes[expr.top].order = 1
                return _Return(expr, node)
            if t.text == "break":
                self.eat()
                if self.at(";"):
                    self.eat()
                return _Break(t.line)
            if t.text == "continue":
                self.eat()
                if self.at(";"):
                    self.eat()
                return _Continue(t.line)
            if t.text == "goto":
                self.eat()
                label = self.eat().text
                if self.at(";"):
                    self.eat()
                node = self._node(
                    "CONTROL_STRUCTURE", name="goto",
                    code=f"goto {label};", line=t.line,
                )
                return _Goto(label, node)
        # C++ statement keywords are plain identifiers to the C lexer
        if t.kind == "id" and t.text == "try" and self.peek(1).text == "{":
            return self._parse_try()
        if t.kind == "id" and t.text == "throw":
            self.eat()
            if not self.at(";"):
                expr = self.parse_expression()
            else:
                expr = None
            if self.at(";"):
                self.eat()
            node = self._node(
                "CONTROL_STRUCTURE", name="throw",
                code="throw"
                + (f" {self._code(expr)};" if expr is not None else ";"),
                line=t.line,
            )
            if expr is not None:
                self.cpg.add_edge(node, expr, C.AST)
                self.cpg.add_edge(node, expr, C.ARGUMENT)
                self.cpg.nodes[expr].order = 1
            return _Throw(node)
        # label: `name:` followed by statement
        if t.kind == "id" and self.peek(1).text == ":" and self.peek(2).text != ":":
            self.eat()
            self.eat(":")
            return _Seq([_Label(t.text, t.line), self.parse_statement()])
        if self._at_type_start():
            return self._parse_declaration()
        # expression statement
        expr = self.parse_expression()
        if self.at(";"):
            self.eat()
        return _Expr(expr)

    def _parse_try(self) -> _Stmt:
        """`try { body } catch (param) { handler }...` — Joern keeps try/
        catch as CONTROL_STRUCTURE nodes; at line level the handlers are
        alternative paths entered via a `catch` node at the clause line;
        a `finally` block continues after."""
        self.eat()  # 'try'
        body = self._parse_block()
        handlers: list[tuple[int, _Stmt]] = []
        while self.peek().kind == "id" and self.peek().text == "catch":
            kw = self.eat()
            param_code = ""
            if self.at("("):
                depth = 0
                toks = []
                while not self.at_eof():
                    tok = self.eat()
                    if tok.text == "(":
                        depth += 1
                        if depth == 1:
                            continue
                    if tok.text == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    toks.append(tok.text)
                param_code = " ".join(toks)
            node = self._node(
                "CONTROL_STRUCTURE", name="catch",
                code=f"catch ({param_code})", line=kw.line,
            )
            handlers.append((node, self.parse_statement()))
        tr: _Stmt = _Try(body, handlers)
        if (
            self.peek().kind == "id"
            and self.peek().text == "finally"
            and self.peek(1).text == "{"
        ):
            self.eat()
            tr = _Seq([tr, self._parse_block()])
        return tr

    def _parse_block(self) -> _Stmt:
        self.eat("{")
        self.scope = _Scope(self.scope)
        body = []
        while not self.at("}") and not self.at_eof():
            body.append(self.parse_statement())
        if self.at("}"):
            self.eat()
        self.scope = self.scope.parent
        return _Seq(body)

    def _parse_paren_expr(self) -> _Expr:
        self.eat("(")
        e = self.parse_expression()
        self.eat(")")
        return _Expr(e)

    def _parse_if(self) -> _Stmt:
        self.eat("if")
        cond = self._parse_paren_expr()
        then = self.parse_statement()
        els = None
        if self.at("else"):
            self.eat()
            els = self.parse_statement()
        return _If(cond, then, els)

    def _parse_while(self) -> _Stmt:
        self.eat("while")
        cond = self._parse_paren_expr()
        body = self.parse_statement()
        return _While(cond, body)

    def _parse_do(self) -> _Stmt:
        self.eat("do")
        body = self.parse_statement()
        if self.at("while"):
            self.eat("while")
            cond = self._parse_paren_expr()
        else:
            cond = _Expr(None)
        if self.at(";"):
            self.eat()
        return _DoWhile(body, cond)

    def _at_range_for(self) -> bool:
        """After `for (` — does a ':' appear before the first ';' at
        depth 0 (C++ range-for)? `::` qualifiers don't count."""
        depth = 0
        quest = 0  # pending ternary '?'s — their ':' is not a range-for
        k = 0
        while True:
            t = self.peek(k)
            if t.kind == "eof" or t.text in (";", "{"):
                return False
            if t.text in ("(", "["):
                depth += 1
            elif t.text in (")", "]"):
                if depth == 0:
                    return False
                depth -= 1
            elif t.text == "?" and depth == 0:
                quest += 1
            elif t.text == ":" and depth == 0:
                if quest:
                    quest -= 1
                else:
                    return True
            k += 1

    def _bind_loop_var(
        self, name: str, full: str, rng: int, line: int | None
    ) -> int:
        """LOCAL + per-iteration `name = *(range)` assignment call
        (Joern's iterator desugaring) — the definition-site desugar of
        the range-for."""
        self.scope.vars[name] = full
        self._node(
            "LOCAL", name=name, code=f"{full} {name}", line=line,
            type_full_name=full,
        )
        ident = self._node(
            "IDENTIFIER", name=name, code=name, line=line,
            type_full_name=full,
        )
        return self._call(
            C.OP_NAMES["="], f"{name} = *({self._code(rng)})", line,
            [ident, rng],
        )

    def _parse_range_for(self) -> _Stmt:
        """`for (T x : expr) body` — per-iteration assignment at the for
        line (Joern's iterator desugaring yields an `<operator>.
        assignment` there), body loops back to it."""
        start = self.peek()
        base = self._parse_type()
        name, full = self._parse_declarator(base)
        if name is None:
            raise ParseError("range-for declarator")
        self.eat(":")
        rng = self.parse_expression()
        call = self._bind_loop_var(name, full, rng, start.line)
        self.eat(")")
        body = self.parse_statement()
        self.scope = self.scope.parent
        return _RangeFor(_Expr(call), body)

    def _parse_for(self) -> _Stmt:
        self.eat("for")
        self.eat("(")
        self.scope = _Scope(self.scope)
        if self._at_range_for():
            return self._parse_range_for()
        init: _Stmt | None = None
        if not self.at(";"):
            if self._at_type_start():
                init = self._parse_declaration(expect_semicolon=True)
            else:
                init = _Expr(self.parse_expression())
                self.eat(";")
        else:
            self.eat(";")
        cond = None
        if not self.at(";"):
            cond = _Expr(self.parse_expression())
        self.eat(";")
        update = None
        if not self.at(")"):
            update = _Expr(self.parse_expression())
        self.eat(")")
        body = self.parse_statement()
        self.scope = self.scope.parent
        return _For(init, cond, update, body)

    def _parse_switch(self) -> _Stmt:
        self.eat("switch")
        cond = self._parse_paren_expr()
        self.eat("{")
        cases: list[tuple[bool, str, int | None, _Stmt]] = []
        has_default = False
        cur: list[_Stmt] | None = None
        cur_is_default = False
        cur_label, cur_line = "", None
        while not self.at("}") and not self.at_eof():
            if self.at("case"):
                if cur is not None:
                    cases.append((cur_is_default, cur_label, cur_line, _Seq(cur)))
                kw = self.eat("case")
                # consume the constant expression up to ':'
                const_toks = []
                while not self.at(":") and not self.at_eof():
                    const_toks.append(self.eat().text)
                self.eat(":")
                cur = []
                cur_is_default = False
                cur_label = "case " + " ".join(const_toks)
                cur_line = kw.line
                continue
            if self.at("default"):
                if cur is not None:
                    cases.append((cur_is_default, cur_label, cur_line, _Seq(cur)))
                kw = self.eat("default")
                self.eat(":")
                cur = []
                cur_is_default = True
                cur_label, cur_line = "default", kw.line
                has_default = True
                continue
            stmt = self.parse_statement()
            if cur is None:
                cur = []
            cur.append(stmt)
        if cur is not None:
            cases.append((cur_is_default, cur_label, cur_line, _Seq(cur)))
        if self.at("}"):
            self.eat()
        return _Switch(cond, cases, has_default)

    def _parse_declaration(self, expect_semicolon: bool = True) -> _Stmt:
        start = self.peek()
        base = self._parse_type()
        stmts: list[_Stmt] = []
        while True:
            name, full = self._parse_declarator(base)
            if name is None:
                break
            self.scope.vars[name] = full
            self._node(
                "LOCAL", name=name, code=f"{full} {name}", line=start.line,
                type_full_name=full,
            )
            if self.at("="):
                self.eat("=")
                ident = self._node(
                    "IDENTIFIER", name=name, code=name, line=start.line,
                    type_full_name=full,
                )
                # brace initializer: Joern models `T a[] = {..}` as an
                # assignment whose RHS is <operator>.arrayInitializer, so
                # the declaration still yields a definition node
                if self.at("{"):
                    rhs = self._parse_brace_init(start.line)
                else:
                    rhs = self._parse_assign()
                code = f"{name} = {self._code(rhs)}"
                call = self._call(
                    C.OP_NAMES["="], code, start.line, [ident, rhs]
                )
                stmts.append(_Expr(call))
            if self.at(","):
                self.eat()
                continue
            break
        if expect_semicolon and self.at(";"):
            self.eat()
        return _Seq(stmts)

    def _parse_brace_init(self, line: int | None) -> int:
        """`{ e1, e2, {..}, ... }` -> <operator>.arrayInitializer CALL
        whose arguments are the element expressions (nested braces
        recurse). Designators (`[0] = x`, `.f = y`) parse via the normal
        assignment expression path."""
        self.eat("{")
        args: list[int] = []
        while not self.at("}") and not self.at_eof():
            if self.at("{"):
                args.append(self._parse_brace_init(line))
            else:
                args.append(self._parse_assign())
            if self.at(","):
                self.eat()
        if self.at("}"):
            self.eat()
        return self._call(
            "<operator>.arrayInitializer", "{...}", line, args
        )

    # -- function ------------------------------------------------------------

    #: Java-style method modifiers (id tokens, not C keywords) tolerated
    #: ahead of the return type, as the reference's C path does;
    #: `static`/`final` style C/C++ qualifiers are handled by _parse_type
    _JAVA_MODIFIERS = frozenset(
        ("public", "private", "protected", "abstract", "synchronized",
         "native", "strictfp", "transient", "final")
    )

    def parse_function(self) -> C.Cpg:
        """Parse `ret_type name(params) { body }` — C, the common C++
        method shapes (template preamble, qualified Foo::bar names,
        reference parameters), plus the method modifiers, `<T>`
        type-parameter lists and `throws` clauses the reference's C path
        tolerates."""
        while (
            self.peek().kind == "id"
            and self.peek().text in self._JAVA_MODIFIERS
            and self.peek(1).kind in ("id", "kw")
        ):
            self.eat()
        # optional template preamble: template <typename T, ...>
        if self.peek().kind == "id" and self.peek().text == "template":
            self.eat()
            end = self._match_angle(0)
            if end is not None:
                for _ in range(end):
                    self.eat()
        # Java generic method type parameters: `<T> T first(List<T> xs)`;
        # a `static` directly before `<` would otherwise be consumed by
        # _parse_type after the angle group it belongs in front of
        if (
            self.peek().kind == "kw"
            and self.peek().text in ("static", "inline")
            and self.peek(1).text == "<"
        ):
            self.eat()
        if self.at("<"):
            end = self._match_angle(0)
            if end is not None:
                for _ in range(end):
                    self.eat()
        # signature
        sig_start = self.peek()
        base = self._parse_type()
        stars = 0
        while self.at("*") or self.at("&"):
            if self.at("*"):
                stars += 1
            self.eat()
        if self.at("(") and base not in ("", "ANY"):
            # constructor: `Foo::Foo(...)` — the "return type" IS the name
            fname = base
            base = "void"
        elif self.at("::") and self.peek(1).text == "~":
            # destructor: `Foo::~Foo(...)`
            self.eat()
            self.eat()
            fname = base + "::~" + (self.eat().text if self.peek().kind == "id" else "")
            base = "void"
        elif self.peek().kind != "id":
            raise ParseError(f"expected function name, got {self.peek()!r}")
        else:
            fname = self.eat().text
            # attribute-macro recovery: real-world signatures carry
            # unknown annotation macros (`IMATH_HOSTDEVICE inline T
            # name(`, `static __inline__ __u8 *name(`) that _parse_type
            # consumed as the base type, leaving the TYPE in fname's
            # slot. Gather the id/*/& soup up to '('; the LAST
            # identifier is the function name, the rest is type — the
            # same recovery CDT applies to unexpanded macros. (operator
            # overloads keep their op tokens for the handler below.)
            def _soup_tok() -> bool:
                t = self.peek()
                return (
                    t.kind == "id"
                    or t.text in ("*", "&")
                    # `__fortify_function __wur char *gets(`: keyword
                    # type specifiers can FOLLOW the attribute macros
                    # (qualifiers are a subset of TYPE_KEYWORDS)
                    or (t.kind == "kw" and t.text in TYPE_KEYWORDS)
                )

            if fname != "operator" and _soup_tok():
                soup = [fname]
                while _soup_tok():
                    tok = self.eat().text
                    soup.append(tok)
                    if tok == "operator":
                        # `MYMACRO Vec operator*(`: the overload's op
                        # token belongs to the handler below, not soup
                        break
                id_positions = [
                    k for k, t in enumerate(soup) if t not in ("*", "&")
                ]
                fname = soup[id_positions[-1]]
                extra = [
                    t for k, t in enumerate(soup) if k != id_positions[-1]
                ]
                if extra:
                    prefix = "" if base in ("", "ANY") else base + " "
                    base = prefix + " ".join(extra)
            while self.at("::") and self.peek(1).kind in ("id", "op"):
                self.eat()
                if self.at("~"):  # destructor
                    self.eat()
                    fname += "::~" + self.eat().text
                else:
                    fname += "::" + self.eat().text
            if fname.split("::")[-1] == "operator":
                # operator overloads: operator== / operator[] / operator()
                if self.at("(") and self.peek(1).text == ")":
                    self.eat()
                    self.eat()
                    fname += "()"
                elif self.at("[") and self.peek(1).text == "]":
                    self.eat()
                    self.eat()
                    fname += "[]"
                else:
                    while self.peek().kind == "op" and not self.at("("):
                        fname += self.eat().text
        self.cpg = C.Cpg(fname)
        ret_type = base + "*" * stars
        method = self.cpg.add_node(
            "METHOD", name=fname, code=fname, line=sig_start.line,
            type_full_name=ret_type,
        )
        self.cpg.method_id = method
        self.eat("(")
        self.scope = _Scope()
        order = 1
        while not self.at(")") and not self.at_eof():
            if self.at("void") and self.peek(1).text == ")":
                self.eat()
                break
            if self.at("..."):
                self.eat()
                break
            param_start = self.i
            pbase = self._parse_type(in_params=True)
            pname, pfull = self._parse_declarator(pbase)
            if pname is None and self.i == param_start or not (
                self.at(",") or self.at(")")
            ):
                # unparsed declarator (function pointer, etc.): skip balanced
                # tokens to the next top-level ',' or ')'; salvage the last
                # identifier seen as the parameter name
                depth = 0
                last_id = None
                while not self.at_eof():
                    t = self.peek()
                    if t.text == "(" or t.text == "[":
                        depth += 1
                    elif t.text == ")" or t.text == "]":
                        if depth == 0:
                            break
                        depth -= 1
                    elif t.text == "," and depth == 0:
                        break
                    if t.kind == "id":
                        last_id = t.text
                    self.eat()
                if pname is None and last_id is not None:
                    pname, pfull = last_id, pbase + "*"
            if pname is not None:
                self.scope.vars[pname] = pfull
                pid = self.cpg.add_node(
                    "METHOD_PARAMETER_IN", name=pname, code=f"{pfull} {pname}",
                    line=self.peek().line, order=order, type_full_name=pfull,
                )
                self.cpg.add_edge(method, pid, C.AST)
                order += 1
            if self.at(","):
                self.eat()
            elif self.i == param_start:
                # a stray ']' stops both the type and the skip above; step
                # over it (the reference's parser loops here for ever)
                self.eat()
        if self.at(")"):
            self.eat(")")
        # tolerate everything between ) and the body: C++ `const`,
        # `noexcept(...)`, `override`, Java `throws A, B` — none of it
        # shapes the CFG. A constructor member-initializer list needs its
        # own balanced skip first: `: x_(1), y_{v}` contains brace groups
        # that must not be mistaken for the function body.
        while (
            not self.at("{") and not self.at(";") and not self.at(":")
            and not self.at_eof()
        ):
            self.eat()
        if self.at(":"):
            self.eat()
            while not self.at_eof():
                # qualified, possibly templated member/base name:
                # `Base<T>::Nested`, `ns::m_` — angle groups may be
                # followed by further :: segments, so keep scanning
                while (
                    self.peek().kind == "id" or self.at("::") or self.at("<")
                ):
                    if self.at("<"):
                        end = self._match_angle(0)
                        if end is None:
                            break
                        for _ in range(end):
                            self.eat()
                    else:
                        self.eat()
                if self.at("(") or self.at("{"):
                    open_t = self.peek().text
                    close_t = ")" if open_t == "(" else "}"
                    depth = 0
                    while not self.at_eof():
                        t = self.eat()
                        if t.text == open_t:
                            depth += 1
                        elif t.text == close_t:
                            depth -= 1
                            if depth == 0:
                                break
                if self.at(","):
                    self.eat()
                    continue
                break
        while not self.at("{") and not self.at(";") and not self.at_eof():
            self.eat()
        body = self._parse_block() if self.at("{") else _Seq([])
        return self._finish_function(sig_start.line, ret_type, body)

    def _finish_function(
        self, sig_line: int | None, ret_type: str, body: _Stmt
    ) -> C.Cpg:
        """Shared tail: METHOD_RETURN node, CFG wiring, and adoption of
        parentless expression roots under the METHOD node."""
        method = self.cpg.method_id
        mret = self.cpg.add_node(
            "METHOD_RETURN", name="RET", code="RET", line=sig_line,
            type_full_name=ret_type,
        )
        self.cpg.method_return_id = mret
        self.cpg.add_edge(method, mret, C.AST)
        _CfgBuilder(self.cpg).build(body)
        # AST: method -> top-level expression roots that lack an AST parent
        have_parent = {d for _, d, t in self.cpg.edges if t == C.AST}
        for n in self.cpg.nodes:
            if n.id != method and n.id not in have_parent:
                self.cpg.add_edge(method, n.id, C.AST)
        return self.cpg

class _CfgBuilder:
    """Wires CFG edges: expression chains in post-order, branches, loops,
    switches, gotos; METHOD -> first node, exits -> METHOD_RETURN."""

    def __init__(self, cpg: C.Cpg):
        self.cpg = cpg
        self.frontier: list[int] = [cpg.method_id]
        self.break_stack: list[list[int]] = []
        self.continue_stack: list[tuple[str, list[int] | int]] = []
        self.labels: dict[str, int] = {}
        self.pending_gotos: list[tuple[str, int]] = []

    def build(self, body: _Stmt) -> None:
        self.stmt(body)
        for nid in self.frontier:
            self.cpg.add_edge(nid, self.cpg.method_return_id, C.CFG)
        for label, node in self.pending_gotos:
            if label in self.labels:
                self.cpg.add_edge(node, self.labels[label], C.CFG)

    # -- expression chains --

    def _postorder(self, top: int) -> list[int]:
        out: list[int] = []

        def rec(n: int):
            for ch in sorted(
                self.cpg.successors(n, C.AST), key=lambda c: self.cpg.nodes[c].order
            ):
                rec(ch)
            out.append(n)

        rec(top)
        return out

    def emit_expr(self, top: int | None) -> None:
        if top is None:
            return
        chain = self._postorder(top)
        for nid in self.frontier:
            self.cpg.add_edge(nid, chain[0], C.CFG)
        for a, b in zip(chain, chain[1:]):
            self.cpg.add_edge(a, b, C.CFG)
        self.frontier = [chain[-1]]

    def _first_of(self, top: int) -> int:
        return self._postorder(top)[0]

    def _loop_back_to_body(
        self, marker: int, entry_frontier: list[int], conts: list[int]
    ) -> None:
        """Close a condition-less loop: find the body's first CFG node
        (the dst of the first CFG edge out of the entry frontier added
        after `marker`) and wire the current frontier plus deferred
        continues back to it."""
        first_body = None
        for src, dst, t in self.cpg.edges[marker:]:
            if t == C.CFG and src in entry_frontier:
                first_body = dst
                break
        if first_body is None:
            return
        for nid in self.frontier:
            self.cpg.add_edge(nid, first_body, C.CFG)
        for nid in conts:
            self.cpg.add_edge(nid, first_body, C.CFG)
        self.frontier = []

    # -- statements --

    def stmt(self, s: _Stmt) -> None:
        if isinstance(s, _Seq):
            for sub in s.body:
                self.stmt(sub)
        elif isinstance(s, _Expr):
            self.emit_expr(s.top)
        elif isinstance(s, _If):
            self.emit_expr(s.cond.top)
            cond_f = list(self.frontier)
            self.stmt(s.then)
            then_f = self.frontier
            if s.els is not None:
                self.frontier = cond_f
                self.stmt(s.els)
                self.frontier = then_f + self.frontier
            else:
                self.frontier = then_f + cond_f
        elif isinstance(s, _While):
            if s.cond.top is None:
                # condition-less loop (parse recovery): loop forever;
                # body end and continues wire back to the body's first
                # node, only breaks exit
                self.break_stack.append([])
                marker = len(self.cpg.edges)
                entry_frontier = list(self.frontier)
                self.continue_stack.append(("defer", []))
                self.stmt(s.body)
                _, conts = self.continue_stack.pop()
                self._loop_back_to_body(marker, entry_frontier, conts)
                self.frontier = self.break_stack.pop()
                return
            cond_first = self._first_of(s.cond.top)
            self.emit_expr(s.cond.top)
            cond_top = self.frontier[0]
            self.break_stack.append([])
            self.continue_stack.append(("node", cond_first))
            self.stmt(s.body)
            for nid in self.frontier:
                self.cpg.add_edge(nid, cond_first, C.CFG)
            self.frontier = [cond_top] + self.break_stack.pop()
            self.continue_stack.pop()
        elif isinstance(s, _DoWhile):
            body_entry_marker = len(self.cpg.edges)
            entry_frontier = list(self.frontier)
            self.break_stack.append([])
            self.continue_stack.append(("defer", []))
            self.stmt(s.body)
            _, conts = self.continue_stack.pop()
            if s.cond.top is not None:
                cond_first = self._first_of(s.cond.top)
                for nid in conts:
                    self.cpg.add_edge(nid, cond_first, C.CFG)
                self.emit_expr(s.cond.top)
                cond_top = self.frontier[0]
                # loop back: cond -> first body node (first CFG edge dst
                # added after marker)
                first_body = None
                for src, dst, t in self.cpg.edges[body_entry_marker:]:
                    if t == C.CFG and src in entry_frontier:
                        first_body = dst
                        break
                if first_body is not None:
                    self.cpg.add_edge(cond_top, first_body, C.CFG)
                self.frontier = [cond_top] + self.break_stack.pop()
            else:
                self.frontier = self.frontier + self.break_stack.pop()
        elif isinstance(s, _For):
            if s.init is not None:
                self.stmt(s.init)
            cond_first = None
            if s.cond is not None and s.cond.top is not None:
                cond_first = self._first_of(s.cond.top)
                self.emit_expr(s.cond.top)
                cond_top = self.frontier[0]
            self.break_stack.append([])
            update_first = (
                self._first_of(s.update.top)
                if s.update is not None and s.update.top is not None
                else cond_first
            )
            self.continue_stack.append(
                ("node", update_first) if update_first is not None else ("defer", [])
            )
            marker = len(self.cpg.edges)
            entry_frontier = list(self.frontier)
            self.stmt(s.body)
            # body end -> update -> cond
            if s.update is not None and s.update.top is not None:
                self.emit_expr(s.update.top)
            if cond_first is not None:
                for nid in self.frontier:
                    self.cpg.add_edge(nid, cond_first, C.CFG)
                self.frontier = [cond_top] + self.break_stack.pop()
                self.continue_stack.pop()
            else:
                # for(;;): body end (after any update) loops back to the
                # body's first node; deferred continues join it; only
                # breaks exit
                _, conts = self.continue_stack.pop()
                if not isinstance(conts, list):
                    conts = []
                self._loop_back_to_body(marker, entry_frontier, conts)
                self.frontier = self.break_stack.pop()
        elif isinstance(s, _Switch):
            self.emit_expr(s.cond.top)
            cond_f = list(self.frontier)
            self.break_stack.append([])
            fallthrough: list[int] = []
            for is_default, label_code, line, body in s.cases:
                # Joern emits a JUMP_TARGET per case/default label, in
                # the CFG: dispatch edges go switch-cond -> jump target,
                # and fallthrough runs prev body -> next jump target
                jt = self.cpg.add_node(
                    "JUMP_TARGET", name=label_code,
                    code=f"{label_code}:", line=line,
                )
                for nid in cond_f + fallthrough:
                    self.cpg.add_edge(nid, jt, C.CFG)
                self.frontier = [jt]
                self.stmt(body)
                fallthrough = self.frontier
            exits = self.break_stack.pop() + fallthrough
            if not s.has_default:
                exits += cond_f
            self.frontier = exits
        elif isinstance(s, _Return):
            if s.expr is not None and s.expr.top is not None:
                self.emit_expr(s.expr.top)
            for nid in self.frontier:
                self.cpg.add_edge(nid, s.node, C.CFG)
            self.cpg.add_edge(s.node, self.cpg.method_return_id, C.CFG)
            self.frontier = []
        elif isinstance(s, _Break):
            # Joern keeps break in the CFG as a CONTROL_STRUCTURE node
            node = self.cpg.add_node(
                "CONTROL_STRUCTURE", name="break", code="break;",
                line=s.line,
            )
            for nid in self.frontier:
                self.cpg.add_edge(nid, node, C.CFG)
            if self.break_stack:
                self.break_stack[-1].append(node)
            self.frontier = []
        elif isinstance(s, _Continue):
            node = self.cpg.add_node(
                "CONTROL_STRUCTURE", name="continue", code="continue;",
                line=s.line,
            )
            for nid in self.frontier:
                self.cpg.add_edge(nid, node, C.CFG)
            if self.continue_stack:
                kind, target = self.continue_stack[-1]
                if kind == "node":
                    self.cpg.add_edge(node, target, C.CFG)
                else:
                    target.append(node)
            self.frontier = []
        elif isinstance(s, _Try):
            # handlers are alternative paths: entered from the try entry
            # (any body statement may throw; the line-level simplification
            # branches at entry and at body exit) via the catch node
            entry_f = list(self.frontier)
            self.stmt(s.body)
            body_exits = list(self.frontier)
            all_exits = list(body_exits)
            for catch_node, handler in s.handlers:
                # dedup: an empty try body makes entry_f == body_exits
                for nid in dict.fromkeys(entry_f + body_exits):
                    self.cpg.add_edge(nid, catch_node, C.CFG)
                self.frontier = [catch_node]
                self.stmt(handler)
                all_exits.extend(self.frontier)
            self.frontier = all_exits
        elif isinstance(s, _Throw):
            # throw leaves the function (line level): no fall-through
            for nid in self.frontier:
                self.cpg.add_edge(nid, s.node, C.CFG)
            self.cpg.add_edge(s.node, self.cpg.method_return_id, C.CFG)
            self.frontier = []
        elif isinstance(s, _RangeFor):
            expr_first = self._first_of(s.expr.top)
            self.emit_expr(s.expr.top)
            expr_top = self.frontier[0]
            self.break_stack.append([])
            self.continue_stack.append(("node", expr_first))
            self.stmt(s.body)
            for nid in self.frontier:
                self.cpg.add_edge(nid, expr_first, C.CFG)
            self.frontier = [expr_top] + self.break_stack.pop()
            self.continue_stack.pop()
        elif isinstance(s, _Goto):
            for nid in self.frontier:
                self.cpg.add_edge(nid, s.node, C.CFG)
            self.pending_gotos.append((s.label, s.node))
            self.frontier = []
        elif isinstance(s, _Label):
            # a label is a CFG join point; materialize as a no-op node
            node = self.cpg.add_node(
                "JUMP_TARGET", name=s.name, code=f"{s.name}:",
                line=s.line,
            )
            self.labels[s.name] = node
            for nid in self.frontier:
                self.cpg.add_edge(nid, node, C.CFG)
            self.frontier = [node]
        else:
            raise TypeError(f"unknown stmt {s!r}")


def parse_function(code: str) -> C.Cpg:
    """Public entry: parse one C/C++ function into a CPG-lite.

    The reference's `dialect=` (java, c#, js, go, php and ruby snippets
    for CodeBLEU's syntax match) is not ported yet: ROADMAP queue A,
    item 3."""
    return Parser(code).parse_function()
