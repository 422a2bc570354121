"""Digit-exact CodeBLEU dataflow match for java + c_sharp.

The reference evaluator's dataflow subscore is defined by
`CodeT5/evaluator/CodeBLEU/parser/DFG.py` (DFG_java:180-355,
DFG_csharp:356-538) running over tree-sitter parse trees, plus the
filter/merge/normalize pipeline in `dataflow_match.py:70-150`. The
reaching-definitions solver (eval/codebleu.py's other languages)
approximates those triples: comparable, not digit-exact. This module is
the digit-exact path: a purpose-built mini-parser produces trees whose
node types, child order, and field layout mirror the tree-sitter java /
c_sharp grammars *for exactly the constructs the DFG rules inspect*,
and a faithful reimplementation of the DFG recursion + the
dataflow_match pipeline runs over them.

What the DFG semantics actually depend on (everything else in the
grammars is irrelevant — unknown constructs fall into the generic
visit-children-in-order branch, whose only observable effect is the
ordered leaf stream):

- the ordered LEAF stream = the token stream (token index is the triple
  identity);
- leaf typing: anonymous tokens (keywords/punctuation, type == text)
  are invisible to the variable logic; `identifier` leaves update the
  def state; literal leaves participate as parents but never define
  (tree-sitter quirk faithfully kept: `true`/`false` are anonymous in
  both grammars and thus invisible, while `null` lifts to a
  `null_literal` token whose type != text, so it DOES participate);
- the special node shapes: variable_declarator (java: name/value
  fields; c#: [name, equals_value_clause] children — the len==2 check
  at DFG.py:377), assignment_expression (left/right),
  update_expression (java) / postfix_unary_expression (c# — prefix
  ++x is NOT an increment in c#, DFG.py:359), if/else, for,
  enhanced_for (java name/value/body) / for_each (c# left/right/body),
  while;
- the for-statement second pass triggers on a child typed exactly
  "local_variable_declaration" (DFG.py:294/470) — c#'s for initializer
  is `variable_declaration` in its grammar, so the c# second pass NEVER
  fires; this quirk is replicated, not fixed.

The port's copy of the reference's `deepdfa_tpu/eval/dfg_parity.py`, over
the port's dialect lexer (frontend/tokens.py). The reference's goldens
(tests/test_dfg_parity.py) hold snippets whose normalized triples were
derived by executing DFG.py's logic by hand (tree-sitter is not a
dependency; the goldens cite the DFG.py lines they trace);
tests/test_torch_dfg_parity.py holds this copy to the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# comment stripping (dataflow_match.py applies the 'java' branch of
# remove_comments_and_docstrings to BOTH candidate and reference for
# every language — replicated byte-for-byte including the
# blank-line removal)
# ---------------------------------------------------------------------------

_COMMENT_RE = re.compile(
    r'//.*?$|/\*.*?\*/|\'(?:\\.|[^\\\'])*\'|"(?:\\.|[^\\"])*"',
    re.DOTALL | re.MULTILINE,
)


def remove_comments(source: str) -> str:
    def replacer(match):
        s = match.group(0)
        if s.startswith("/"):
            return " "  # a space, not an empty string (utils.py:55-57)
        return s

    out = _COMMENT_RE.sub(replacer, source)
    return "\n".join(x for x in out.split("\n") if x.strip() != "")


# ---------------------------------------------------------------------------
# mini-AST
# ---------------------------------------------------------------------------


@dataclass
class Node:
    """Tree-sitter-shaped node: ordered children (anonymous tokens
    included, as tree-sitter's .children does), optional named fields,
    and for leaves the token (idx, text)."""

    type: str
    children: list["Node"] = field(default_factory=list)
    fields: dict[str, "Node"] = field(default_factory=dict)
    idx: int | None = None
    text: str | None = None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def child_by_field_name(self, name: str):
        return self.fields.get(name)


def _leaves(node: Node, out: list[Node]) -> None:
    if node.is_leaf:
        out.append(node)
        return
    for c in node.children:
        _leaves(c, out)


def tree_to_variable_index(node: Node) -> list[Node]:
    """Reference utils.tree_to_variable_index: leaves whose type differs
    from their text (named tokens: identifiers + literals)."""
    leaves: list[Node] = []
    _leaves(node, leaves)
    return [lf for lf in leaves if lf.type != lf.text]


# ---------------------------------------------------------------------------
# tokenizer adapter: hermetic tokens -> typed leaves
# ---------------------------------------------------------------------------

#: tree-sitter-java anonymous keywords (grammar.js terminals). true/false
#: are anonymous token rules there; null lifts to null_literal.
JAVA_KEYWORDS = frozenset(
    """abstract assert boolean break byte case catch char class const
    continue default do double else enum extends final finally float for
    goto if implements import instanceof int interface long native new
    package private protected public return short static strictfp super
    switch synchronized this throw throws transient try void volatile
    while true false""".split()
)

#: tree-sitter-c-sharp anonymous terminals (the subset a method body can
#: meet; `var` is the anonymous implicit_type token, `in` the foreach
#: separator; true/false anonymous as in java)
CSHARP_KEYWORDS = frozenset(
    """abstract as base bool break byte case catch char checked class
    const continue decimal default delegate do double else enum event
    explicit extern finally fixed float for foreach goto if implicit in
    int interface internal is lock long namespace new object operator
    out override params private protected public readonly ref return
    sbyte sealed short sizeof stackalloc static string struct switch
    this throw try typeof uint ulong unchecked unsafe ushort using
    var virtual void volatile while true false""".split()
)

_PRIMITIVES = {
    "java": frozenset(
        "boolean byte char double float int long short void".split()
    ),
    "cs": frozenset(
        """bool byte char decimal double float int long object sbyte
        short string uint ulong ushort var void""".split()
    ),
}


def _lex(code: str, dialect: str) -> list[Node]:
    """Token stream as typed leaves, tree-sitter leaf-typing rules."""
    from deepdfa_tpu_torch.frontend.tokens import tokenize

    kws = JAVA_KEYWORDS if dialect == "java" else CSHARP_KEYWORDS
    leaves: list[Node] = []
    for t in tokenize(code, backend="python", dialect=dialect):
        if t.kind == "eof":
            break
        if t.kind in ("op",) or t.text in kws:
            ty = t.text  # anonymous: invisible to the variable logic
        elif t.text == "null":
            ty = "null_literal"
        elif t.kind == "id" or t.kind == "kw":
            ty = "identifier"
        elif t.kind == "num":
            ty = "decimal_integer_literal"
        elif t.kind == "str":
            ty = "string_literal"
        elif t.kind == "char":
            ty = "character_literal"
        else:
            ty = t.text
        leaves.append(Node(ty, idx=len(leaves), text=t.text))
    return leaves


# ---------------------------------------------------------------------------
# mini-parser (recursive descent over the typed leaves)
# ---------------------------------------------------------------------------

_ASSIGN_OPS = {
    "=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>=",
    ">>>=", "??=",
}
#: binary operator precedence (only relative order matters; the DFG
#: treats every binary_expression generically)
_BIN_PREC = {
    "||": 1, "&&": 2, "??": 2, "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6, "<": 7, ">": 7, "<=": 7, ">=": 7,
    "<<": 8, ">>": 8, ">>>": 8, "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}
_MODIFIERS = frozenset(
    """public private protected static final abstract native synchronized
    transient volatile strictfp readonly sealed virtual override internal
    extern unsafe const async partial""".split()
)


class _MiniParser:
    """Builds the tree-sitter-shaped tree the DFG rules need. Loose by
    design everywhere the DFG is insensitive (expression internals,
    modifiers, generics) and exact where it is not (the special node
    types, field layouts, and child order)."""

    def __init__(self, leaves: list[Node], dialect: str):
        self.toks = leaves
        self.i = 0
        self.d = dialect

    # -- cursor helpers --
    def peek(self, k: int = 0) -> Node | None:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def at(self, text: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t is not None and t.text == text

    def eat(self) -> Node:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> Node:
        if not self.at(text):
            got = self.peek()
            raise ValueError(
                f"dfg_parity parse: expected {text!r}, got "
                f"{got.text if got else 'EOF'!r} at {self.i}"
            )
        return self.eat()

    # -- entry --
    def parse_program(self) -> Node:
        items = []
        while self.peek() is not None:
            items.append(self.parse_statement())
        return Node("program", items)

    # -- types --
    def _looks_like_type_start(self) -> bool:
        t = self.peek()
        if t is None:
            return False
        if t.text in _PRIMITIVES[self.d]:
            return True
        return t.type == "identifier"

    def _scan_type_end(self, j: int) -> int | None:
        """Index just past a type starting at j, or None. Handles
        qualified names, one balanced <...> group, and [] suffixes."""
        t = self.toks[j] if j < len(self.toks) else None
        if t is None:
            return None
        if not (t.text in _PRIMITIVES[self.d] or t.type == "identifier"):
            return None
        j += 1
        while (
            j + 1 < len(self.toks)
            and self.toks[j].text == "."
            and self.toks[j + 1].type == "identifier"
        ):
            j += 2
        if j < len(self.toks) and self.toks[j].text == "<":
            depth = 0
            k = j
            while k < len(self.toks):
                tx = self.toks[k].text
                if tx == "<":
                    depth += 1
                elif tx == ">":
                    depth -= 1
                    if depth == 0:
                        k += 1
                        break
                elif tx in (";", "{", "}", ")", "=") or (
                    tx in _BIN_PREC and tx not in ("<", ">")
                ):
                    return None  # not a generic argument list
                k += 1
            else:
                return None
            j = k
        while (
            j + 1 < len(self.toks)
            and self.toks[j].text == "["
            and self.toks[j + 1].text == "]"
        ):
            j += 2
        return j

    def parse_type(self) -> Node:
        end = self._scan_type_end(self.i)
        if end is None:
            raise ValueError("dfg_parity parse: expected a type")
        kids = [self.eat() for _ in range(end - self.i)]
        return Node("type", kids)

    def _decl_lookahead(self) -> bool:
        """True when the cursor starts `Type name [=,;(]...` — a
        declaration (or method, resolved later)."""
        j = self.i
        while j < len(self.toks) and self.toks[j].text in _MODIFIERS:
            j += 1
        end = self._scan_type_end(j)
        if end is None or end >= len(self.toks):
            return False
        if self.toks[end].type != "identifier":
            return False
        nxt = self.toks[end + 1] if end + 1 < len(self.toks) else None
        return nxt is not None and nxt.text in ("=", ",", ";", "(")

    # -- statements --
    def parse_statement(self) -> Node:
        t = self.peek()
        if t is None:
            raise ValueError("dfg_parity parse: unexpected EOF")
        tx = t.text
        if tx == "{":
            return self.parse_block()
        if tx == ";":
            return Node("empty_statement", [self.eat()])
        if tx == "if":
            return self.parse_if()
        if tx == "while":
            return self.parse_while()
        if tx == "do":
            return self.parse_do()
        if tx == "for":
            return self.parse_for()
        if tx == "foreach" and self.d == "cs":
            return self.parse_foreach_cs()
        if tx in ("return", "throw"):
            kids = [self.eat()]
            if not self.at(";"):
                kids.append(self.parse_expression())
            kids.append(self.expect(";"))
            return Node(f"{tx}_statement", kids)
        if tx in ("break", "continue"):
            kids = [self.eat()]
            if self.peek() is not None and self.peek().type == "identifier":
                kids.append(self.eat())  # label
            kids.append(self.expect(";"))
            return Node(f"{tx}_statement", kids)
        if tx == "switch":
            return self.parse_switch()
        if tx == "try":
            return self.parse_try()
        if tx in ("class", "interface", "enum", "struct", "namespace"):
            return self.parse_class_like()
        if tx == "using" and self.d == "cs":
            kids = [self.eat()]
            while self.peek() is not None and not self.at(";"):
                kids.append(self.eat())
            kids.append(self.expect(";"))
            return Node("using_directive", kids)
        if self._decl_lookahead():
            return self.parse_declaration_or_method()
        # expression statement
        kids = [self.parse_expression()]
        kids.append(self.expect(";"))
        return Node("expression_statement", kids)

    def parse_block(self) -> Node:
        kids = [self.expect("{")]
        while not self.at("}"):
            kids.append(self.parse_statement())
        kids.append(self.expect("}"))
        return Node("block", kids)

    def parse_if(self) -> Node:
        kids = [self.expect("if"), self.parse_paren_expr(),
                self.parse_statement()]
        if self.at("else"):
            kids.append(self.eat())  # the 'else' LEAF the DFG rule keys on
            kids.append(self.parse_statement())
        return Node("if_statement", kids)

    def parse_while(self) -> Node:
        return Node("while_statement", [
            self.expect("while"), self.parse_paren_expr(),
            self.parse_statement(),
        ])

    def parse_do(self) -> Node:
        kids = [self.expect("do"), self.parse_statement(),
                self.expect("while"), self.parse_paren_expr(),
                self.expect(";")]
        return Node("do_statement", kids)

    def parse_for(self) -> Node:
        # java enhanced for: `for (Type name : expr) body`
        if self.d == "java":
            j = self.i + 2  # past `for (`
            depth = 1
            k = j
            colon = None
            while k < len(self.toks) and depth > 0:
                tx = self.toks[k].text
                if tx == "(":
                    depth += 1
                elif tx == ")":
                    depth -= 1
                elif tx == ";" and depth == 1:
                    break
                elif tx == ":" and depth == 1:
                    colon = k
                    break
                k += 1
            if colon is not None:
                kids = [self.expect("for"), self.expect("(")]
                ty = self.parse_type()
                name = self.eat()
                kids += [ty, name, self.expect(":")]
                value = self.parse_expression()
                kids += [value, self.expect(")")]
                body = self.parse_statement()
                kids.append(body)
                return Node(
                    "enhanced_for_statement", kids,
                    fields={"name": name, "value": value, "body": body},
                )
        kids = [self.expect("for"), self.expect("(")]
        decl_type = (
            "local_variable_declaration" if self.d == "java"
            else "variable_declaration"  # the c# grammar name — the
            # DFG's second-pass check never matches it (DFG.py:470)
        )
        if self.at(";"):
            kids.append(Node("empty_statement", [self.eat()]))
        elif self._decl_lookahead():
            kids.append(self.parse_declaration_or_method(
                node_type=decl_type, terminator=";"))
        else:
            kids.append(self.parse_expression())
            kids.append(self.expect(";"))
        if not self.at(";"):
            kids.append(self.parse_expression())
        kids.append(self.expect(";"))
        if not self.at(")"):
            kids.append(self.parse_expression())
            while self.at(","):
                kids.append(self.eat())
                kids.append(self.parse_expression())
        kids.append(self.expect(")"))
        kids.append(self.parse_statement())
        return Node("for_statement", kids)

    def parse_foreach_cs(self) -> Node:
        kids = [self.expect("foreach"), self.expect("(")]
        ty = self.parse_type()
        name = self.eat()
        kids += [ty, name, self.expect("in")]
        value = self.parse_expression()
        kids += [value, self.expect(")")]
        body = self.parse_statement()
        kids.append(body)
        return Node(
            "for_each_statement", kids,
            fields={"left": name, "right": value, "body": body},
        )

    def parse_switch(self) -> Node:
        kids = [self.expect("switch"), self.parse_paren_expr(),
                self.expect("{")]
        while not self.at("}"):
            if self.at("case"):
                kids.append(self.eat())
                kids.append(self.parse_expression())
                kids.append(self.expect(":"))
            elif self.at("default"):
                kids.append(self.eat())
                kids.append(self.expect(":"))
            else:
                kids.append(self.parse_statement())
        kids.append(self.expect("}"))
        return Node("switch_statement", kids)

    def parse_try(self) -> Node:
        kids = [self.expect("try"), self.parse_block()]
        while self.at("catch"):
            kids.append(self.eat())
            if self.at("("):
                kids.append(self.expect("("))
                kids.append(self.parse_type())
                if self.peek().type == "identifier":
                    kids.append(self.eat())
                kids.append(self.expect(")"))
            kids.append(self.parse_block())
        if self.at("finally"):
            kids.append(self.eat())
            kids.append(self.parse_block())
        return Node("try_statement", kids)

    def parse_class_like(self) -> Node:
        kids = [self.eat()]  # class/struct/... keyword
        while not self.at("{"):
            kids.append(self.eat())  # name, extends, generics — generic
        kids.append(self.expect("{"))
        while not self.at("}"):
            kids.append(self.parse_statement())
        kids.append(self.expect("}"))
        return Node("class_declaration", kids)

    def parse_declaration_or_method(
        self, node_type: str | None = None, terminator: str = ";"
    ) -> Node:
        kids: list[Node] = []
        while self.peek() is not None and self.peek().text in _MODIFIERS:
            kids.append(self.eat())
        ty = self.parse_type()
        kids.append(ty)
        if (
            self.peek() is not None
            and self.peek().type == "identifier"
            and self.at("(", 1)
        ):
            return self._parse_method(kids)
        decl_node_type = node_type or (
            "local_variable_declaration" if self.d == "java"
            else "variable_declaration"
        )
        while True:
            kids.append(self.parse_declarator())
            if self.at(","):
                kids.append(self.eat())
                continue
            break
        kids.append(self.expect(terminator))
        return Node(decl_node_type, kids)

    def parse_declarator(self) -> Node:
        name = self.eat()
        if name.type != "identifier":
            raise ValueError(
                f"dfg_parity parse: declarator name, got {name.text!r}"
            )
        if not self.at("="):
            return Node("variable_declarator", [name],
                        fields={"name": name})
        eq = self.eat()
        value = self.parse_expression(no_comma=True)
        if self.d == "java":
            # java grammar: declarator children include '=', value FIELD
            # is the expression itself
            return Node(
                "variable_declarator", [name, eq, value],
                fields={"name": name, "value": value},
            )
        # c# grammar: [identifier, equals_value_clause] — the len==2
        # shape DFG_csharp's def_statement branch checks (DFG.py:377)
        evc = Node("equals_value_clause", [eq, value])
        return Node("variable_declarator", [name, evc],
                    fields={"name": name})

    def _parse_method(self, kids: list[Node]) -> Node:
        kids.append(self.eat())  # method name (identifier leaf)
        params = [self.expect("(")]
        while not self.at(")"):
            pk: list[Node] = []
            while self.peek().text in _MODIFIERS | {"ref", "out", "final"}:
                pk.append(self.eat())
            pk.append(self.parse_type())
            pk.append(self.eat())  # param name
            params.append(Node("formal_parameter", pk))
            if self.at(","):
                params.append(self.eat())
        params.append(self.expect(")"))
        kids.append(Node("formal_parameters", params))
        if self.at("{"):
            kids.append(self.parse_block())
        else:
            kids.append(self.expect(";"))
        return Node("method_declaration", kids)

    # -- expressions --
    def parse_paren_expr(self) -> Node:
        return Node("parenthesized_expression", [
            self.expect("("), self.parse_expression(), self.expect(")"),
        ])

    def parse_expression(self, no_comma: bool = False) -> Node:
        return self._assignment(no_comma)

    def _assignment(self, no_comma: bool) -> Node:
        left = self._ternary(no_comma)
        t = self.peek()
        if t is not None and t.text in _ASSIGN_OPS:
            op = self.eat()
            right = self._assignment(no_comma)  # right-assoc
            return Node(
                "assignment_expression", [left, op, right],
                fields={"left": left, "right": right},
            )
        return left

    def _ternary(self, no_comma: bool) -> Node:
        cond = self._binary(0, no_comma)
        if self.at("?"):
            q = self.eat()
            then = self._assignment(no_comma)
            c = self.expect(":")
            els = self._assignment(no_comma)
            return Node("ternary_expression", [cond, q, then, c, els])
        return cond

    def _binary(self, min_prec: int, no_comma: bool) -> Node:
        left = self._unary(no_comma)
        while True:
            t = self.peek()
            if t is None or t.text not in _BIN_PREC:
                break
            prec = _BIN_PREC[t.text]
            if prec < min_prec:
                break
            op = self.eat()
            right = self._binary(prec + 1, no_comma)
            left = Node("binary_expression", [left, op, right])
        return left

    def _unary(self, no_comma: bool) -> Node:
        t = self.peek()
        if t is not None and t.text in ("++", "--"):
            op = self.eat()
            operand = self._unary(no_comma)
            ty = ("update_expression" if self.d == "java"
                  else "prefix_unary_expression")  # c# prefix is NOT an
            # increment statement for the DFG (DFG.py:359)
            return Node(ty, [op, operand])
        if t is not None and t.text in ("!", "~", "+", "-"):
            op = self.eat()
            return Node("unary_expression", [op, self._unary(no_comma)])
        if t is not None and t.text == "new":
            kids = [self.eat(), self.parse_type()]
            if self.at("("):
                kids.append(self._argument_list())
            elif self.at("{"):
                kids.append(self._array_initializer())
            return self._postfix(
                Node("object_creation_expression", kids), no_comma
            )
        if (
            t is not None and t.text == "("
            and self._cast_lookahead()
        ):
            kids = [self.eat(), self.parse_type(), self.expect(")")]
            kids.append(self._unary(no_comma))
            return Node("cast_expression", kids)
        return self._postfix(self._primary(), no_comma)

    def _cast_lookahead(self) -> bool:
        """`( Type )` followed by an operand — a cast, not parens."""
        end = self._scan_type_end(self.i + 1)
        if end is None or end >= len(self.toks):
            return False
        if self.toks[end].text != ")":
            return False
        nxt = self.toks[end + 1] if end + 1 < len(self.toks) else None
        if nxt is None:
            return False
        return (
            nxt.type in ("identifier", "decimal_integer_literal",
                         "string_literal", "character_literal",
                         "null_literal")
            or nxt.text in ("(", "!", "~", "new")
        )

    def _postfix(self, node: Node, no_comma: bool) -> Node:
        while True:
            if self.at("("):
                node = Node("method_invocation",
                            [node, self._argument_list()])
            elif self.at("["):
                lb = self.eat()
                idx = self.parse_expression()
                rb = self.expect("]")
                node = Node("array_access", [node, lb, idx, rb])
            elif self.at(".") or (self.d == "cs" and self.at("?.")):
                dot = self.eat()
                member = self.eat()
                node = Node("field_access", [node, dot, member])
            elif self.at("++") or self.at("--"):
                op = self.eat()
                ty = ("update_expression" if self.d == "java"
                      else "postfix_unary_expression")
                node = Node(ty, [node, op])
            else:
                return node

    def _argument_list(self) -> Node:
        kids = [self.expect("(")]
        while not self.at(")"):
            kids.append(self.parse_expression(no_comma=True))
            if self.at(","):
                kids.append(self.eat())
        kids.append(self.expect(")"))
        return Node("argument_list", kids)

    def _array_initializer(self) -> Node:
        kids = [self.expect("{")]
        while not self.at("}"):
            if self.at("{"):
                kids.append(self._array_initializer())
            else:
                kids.append(self.parse_expression(no_comma=True))
            if self.at(","):
                kids.append(self.eat())
        kids.append(self.expect("}"))
        return Node("array_initializer", kids)

    def _primary(self) -> Node:
        t = self.peek()
        if t is None:
            raise ValueError("dfg_parity parse: unexpected EOF in expr")
        if t.text == "(":
            return self.parse_paren_expr()
        return self.eat()  # identifier / literal / anonymous keyword


def parse_snippet(code: str, lang: str) -> Node:
    dialect = "java" if lang == "java" else "cs"
    leaves = _lex(code, dialect)
    return _MiniParser(leaves, dialect).parse_program()


# ---------------------------------------------------------------------------
# the DFG recursion (faithful port of DFG_java / DFG_csharp)
# ---------------------------------------------------------------------------


def _var_idx_code(nodes: list[Node]) -> list[tuple[int, str]]:
    return [(n.idx, n.text) for n in nodes]


def _merge_rounds(DFG):
    """The dedup-merge the reference applies after for/while/foreach
    double passes (DFG.py:293-302 et al.)."""
    dic = {}
    for x in DFG:
        key = (x[0], x[1], x[2])
        if key not in dic:
            dic[key] = [x[3], x[4]]
        else:
            dic[key][0] = list(set(dic[key][0] + x[3]))
            dic[key][1] = sorted(set(dic[key][1] + x[4]))
    return [
        (k[0], k[1], k[2], v[0], v[1])
        for k, v in sorted(dic.items(), key=lambda t: t[0][1])
    ]


def dfg_extract(root: Node, lang: str, states: dict) -> tuple[list, dict]:
    """(DFG, states) — the recursion of DFG_java (DFG.py:180) /
    DFG_csharp (DFG.py:356), structure preserved branch-for-branch."""
    java = lang == "java"
    assignment = ["assignment_expression"]
    def_statement = ["variable_declarator"]
    increment_statement = (
        ["update_expression"] if java else ["postfix_unary_expression"]
    )
    if_statement = ["if_statement", "else"]
    for_statement = ["for_statement"]
    enhanced_for = (
        ["enhanced_for_statement"] if java else ["for_each_statement"]
    )
    while_statement = ["while_statement"]
    states = states.copy()
    rec = dfg_extract

    if root.is_leaf or root.type in (
        "string_literal", "string", "character_literal"
    ):
        if not root.is_leaf:  # string node with internal children
            idx, code = root.idx, root.text
        else:
            idx, code = root.idx, root.text
        if root.type == code:
            return [], states
        elif code in states:
            return (
                [(code, idx, "comesFrom", [code], states[code].copy())],
                states,
            )
        else:
            if root.type == "identifier":
                states[code] = [idx]
            return [(code, idx, "comesFrom", [], [])], states

    if root.type in def_statement:
        if java:
            name = root.child_by_field_name("name")
            value = root.child_by_field_name("value")
        else:
            if len(root.children) == 2:
                name, value = root.children[0], root.children[1]
            else:
                name, value = root.children[0], None
        DFG = []
        if value is None:
            for idx, code in _var_idx_code(tree_to_variable_index(name)):
                DFG.append((code, idx, "comesFrom", [], []))
                states[code] = [idx]
            return sorted(DFG, key=lambda x: x[1]), states
        name_iv = _var_idx_code(tree_to_variable_index(name))
        value_iv = _var_idx_code(tree_to_variable_index(value))
        temp, states = rec(value, lang, states)
        DFG += temp
        for idx1, code1 in name_iv:
            for idx2, code2 in value_iv:
                DFG.append((code1, idx1, "comesFrom", [code2], [idx2]))
            states[code1] = [idx1]
        return sorted(DFG, key=lambda x: x[1]), states

    if root.type in assignment:
        left = root.child_by_field_name("left")
        right = root.child_by_field_name("right")
        DFG = []
        temp, states = rec(right, lang, states)
        DFG += temp
        name_iv = _var_idx_code(tree_to_variable_index(left))
        value_iv = _var_idx_code(tree_to_variable_index(right))
        for idx1, code1 in name_iv:
            for idx2, code2 in value_iv:
                DFG.append((code1, idx1, "computedFrom", [code2], [idx2]))
            states[code1] = [idx1]
        return sorted(DFG, key=lambda x: x[1]), states

    if root.type in increment_statement:
        DFG = []
        iv = _var_idx_code(tree_to_variable_index(root))
        for idx1, code1 in iv:
            for idx2, code2 in iv:
                DFG.append((code1, idx1, "computedFrom", [code2], [idx2]))
            states[code1] = [idx1]
        return sorted(DFG, key=lambda x: x[1]), states

    if root.type in if_statement:
        DFG = []
        current_states = states.copy()
        others_states = []
        flag = False
        tag = False
        if "else" in root.type:
            tag = True
        for child in root.children:
            if "else" in child.type:
                tag = True
            if child.type not in if_statement and flag is False:
                temp, current_states = rec(child, lang, current_states)
                DFG += temp
            else:
                flag = True
                temp, new_states = rec(child, lang, states)
                DFG += temp
                others_states.append(new_states)
        others_states.append(current_states)
        if tag is False:
            others_states.append(states)
        new_states = {}
        for dic in others_states:
            for key in dic:
                if key not in new_states:
                    new_states[key] = dic[key].copy()
                else:
                    new_states[key] += dic[key]
        for key in new_states:
            new_states[key] = sorted(set(new_states[key]))
        return sorted(DFG, key=lambda x: x[1]), new_states

    if root.type in for_statement:
        DFG = []
        for child in root.children:
            temp, states = rec(child, lang, states)
            DFG += temp
        flag = False
        for child in root.children:
            if flag:
                temp, states = rec(child, lang, states)
                DFG += temp
            elif child.type == "local_variable_declaration":
                flag = True
        return _merge_rounds(DFG), states

    if root.type in enhanced_for:
        if java:
            name = root.child_by_field_name("name")
            value = root.child_by_field_name("value")
        else:
            name = root.child_by_field_name("left")
            value = root.child_by_field_name("right")
        body = root.child_by_field_name("body")
        DFG = []
        for _ in range(2):
            temp, states = rec(value, lang, states)
            DFG += temp
            name_iv = _var_idx_code(tree_to_variable_index(name))
            value_iv = _var_idx_code(tree_to_variable_index(value))
            for idx1, code1 in name_iv:
                for idx2, code2 in value_iv:
                    DFG.append(
                        (code1, idx1, "computedFrom", [code2], [idx2])
                    )
                states[code1] = [idx1]
            temp, states = rec(body, lang, states)
            DFG += temp
        return _merge_rounds(DFG), states

    if root.type in while_statement:
        DFG = []
        for _ in range(2):
            for child in root.children:
                temp, states = rec(child, lang, states)
                DFG += temp
        return _merge_rounds(DFG), states

    DFG = []
    for child in root.children:
        temp, states = rec(child, lang, states)
        DFG += temp
    return sorted(DFG, key=lambda x: x[1]), states


# ---------------------------------------------------------------------------
# dataflow_match.py pipeline (get_data_flow filter/merge + normalize +
# corpus match), replicated exactly
# ---------------------------------------------------------------------------


def get_data_flow(code: str, lang: str) -> list:
    try:
        root = parse_snippet(code, lang)
        try:
            DFG, _ = dfg_extract(root, lang, {})
        except Exception:
            DFG = []
        DFG = sorted(DFG, key=lambda x: x[1])
        indexs = set()
        for d in DFG:
            if len(d[-1]) != 0:
                indexs.add(d[1])
            for x in d[-1]:
                indexs.add(x)
        dfg = [d for d in DFG if d[1] in indexs]
    except Exception:
        dfg = []
    # merge nodes (dataflow_match.py:100-110)
    dic = {}
    for d in dfg:
        if d[1] not in dic:
            dic[d[1]] = d
        else:
            dic[d[1]] = (
                d[0], d[1], d[2],
                list(set(dic[d[1]][3] + d[3])),
                list(set(dic[d[1]][4] + d[4])),
            )
    return [dic[d] for d in dic]


def normalize_dataflow(dataflow: list) -> list:
    """dataflow_match.py:129-145: sequential alpha-renaming, parents
    before the target var within each item."""
    var_dict: dict[str, str] = {}
    i = 0
    out = []
    for item in dataflow:
        var_name = item[0]
        relationship = item[2]
        par_vars = item[3]
        for name in par_vars:
            if name not in var_dict:
                var_dict[name] = "var_" + str(i)
                i += 1
        if var_name not in var_dict:
            var_dict[var_name] = "var_" + str(i)
            i += 1
        out.append(
            (var_dict[var_name], relationship,
             [var_dict[x] for x in par_vars])
        )
    return out


def corpus_dataflow_match(
    list_of_references, candidates, lang: str
) -> float:
    """Reference corpus_dataflow_match (dataflow_match.py:28-67) with
    the same comment-stripping, triple matching, and degenerate-0
    semantics."""
    match_count = 0
    total_count = 0
    for references_sample, candidate in zip(list_of_references, candidates):
        for reference in references_sample:
            try:
                candidate = remove_comments(candidate)
            except Exception:
                pass
            try:
                reference = remove_comments(reference)
            except Exception:
                pass
            cand_dfg = normalize_dataflow(get_data_flow(candidate, lang))
            ref_dfg = normalize_dataflow(get_data_flow(reference, lang))
            if len(ref_dfg) > 0:
                total_count += len(ref_dfg)
                for dataflow in ref_dfg:
                    if dataflow in cand_dfg:
                        match_count += 1
                        cand_dfg.remove(dataflow)
    if total_count == 0:
        return 0.0
    return match_count / total_count
