"""Translation-unit type registry: typedef aliases + struct member types
(the port's copy of the reference's `deepdfa_tpu/frontend/typeinfo.py`).

Role of the reference's Joern type script
(DDFA/storage/external/get_type.sc:4-52): `trueTypeDecl` follows typedef
aliases to the underlying type declaration, and `mapToMemberTypes`
recursively expands a struct/union into its "most grandchild" leaf types
— leaves being external (unknown-here) types or internal types without
members, with a seen-set guarding recursive structs. The reference drives
a Joern JVM per query (run_joern_gettype, joern.py:84-130); here a single
pass over the translation unit's token stream builds the registry and
queries are dictionary lookups.

Handled declaration shapes:
    typedef unsigned long size_t;
    typedef struct Foo Bar;            // alias to a tag
    typedef struct { int a; } Anon;    // anonymous struct alias
    struct Foo { int a; struct Baz b; char *name; };
    union/enum analogously (enums expand to no members)
"""

from __future__ import annotations

import dataclasses

from deepdfa_tpu_torch.frontend.tokens import Token, tokenize

_QUALIFIERS = frozenset(
    ("const", "volatile", "static", "extern", "inline", "restrict",
     "unsigned", "signed", "short", "long")
)
_TAGS = frozenset(("struct", "union", "enum"))


@dataclasses.dataclass
class StructInfo:
    name: str
    member_types: list[str]


class TypeRegistry:
    """Typedef aliases + struct member tables for one translation unit."""

    def __init__(self):
        self.aliases: dict[str, str] = {}
        self.structs: dict[str, StructInfo] = {}
        self._anon = 0

    # -- construction --------------------------------------------------------

    @classmethod
    def from_source(cls, code: str) -> "TypeRegistry":
        reg = cls()
        try:
            toks = tokenize(code)
        except Exception:
            return reg
        reg._scan(toks)
        return reg

    def _scan(self, toks: list[Token]) -> None:
        i = 0
        n = len(toks)
        while i < n:
            t = toks[i]
            if t.kind == "kw" and t.text == "typedef":
                i = self._typedef(toks, i + 1)
            elif t.kind == "kw" and t.text in _TAGS:
                i = self._tag_decl(toks, i)
            else:
                i += 1

    def _skip_braces(self, toks, i) -> tuple[int, list[Token]]:
        """From an opening '{', return (index after matching '}', body)."""
        depth = 0
        body = []
        while i < len(toks):
            t = toks[i]
            if t.text == "{":
                depth += 1
                if depth > 1:
                    body.append(t)
            elif t.text == "}":
                depth -= 1
                if depth == 0:
                    return i + 1, body
                body.append(t)
            else:
                if depth >= 1:
                    body.append(t)
            i += 1
        return i, body

    def _members(self, body: list[Token]) -> list[str]:
        """Member type names from a struct body (one per declaration)."""
        out = []
        j = 0
        while j < len(body):
            # collect the declaration-specifier run up to the declarator
            spec: list[str] = []
            tagged = False
            while j < len(body) and not (
                body[j].kind == "id" and spec and not tagged
            ):
                t = body[j]
                if t.text == ";":
                    j += 1
                    spec = []
                    tagged = False
                    continue
                if t.kind == "kw" and t.text in _TAGS:
                    tagged = True
                    j += 1
                    continue
                if t.kind == "kw" and t.text in _QUALIFIERS:
                    spec.append(t.text)
                    j += 1
                    continue
                if t.kind == "kw" or t.kind == "id":
                    spec.append(t.text)
                    if tagged or t.kind == "id":
                        # `struct X member;` / `MyType member;`
                        tagged = False
                        j += 1
                        break
                    j += 1
                    continue
                j += 1
            if not spec:
                continue
            # skip declarator tokens (pointers, names, arrays) to ';'
            while j < len(body) and body[j].text != ";":
                j += 1
            j += 1
            out.append(" ".join(spec) if len(spec) > 1 else spec[0])
        return out

    def _typedef(self, toks, i) -> int:
        """Parse one `typedef ... Name;` starting after the keyword."""
        underlying: str | None = None
        if i < len(toks) and toks[i].kind == "kw" and toks[i].text in _TAGS:
            tag_kw = toks[i].text
            i += 1
            tag_name = None
            if i < len(toks) and toks[i].kind == "id":
                tag_name = toks[i].text
                i += 1
            if i < len(toks) and toks[i].text == "{":
                i, body = self._skip_braces(toks, i)
                if tag_name is None:
                    tag_name = f"anonymous_type_{self._anon}"
                    self._anon += 1
                if tag_kw != "enum":
                    self.structs[tag_name] = StructInfo(
                        tag_name, self._members(body)
                    )
                else:
                    self.structs[tag_name] = StructInfo(tag_name, [])
            underlying = tag_name
        else:
            spec = []
            while i < len(toks) and (
                toks[i].kind == "kw"
                and toks[i].text in _QUALIFIERS | {"int", "char", "float",
                                                   "double", "void", "_Bool"}
                or (toks[i].kind == "id" and not spec)
            ):
                spec.append(toks[i].text)
                i += 1
            underlying = " ".join(spec) if spec else None
        # alias name: last identifier before ';' (skips '*' pointers).
        # A '(' in the declarator means a function/function-pointer
        # typedef — the last identifier would be a PARAMETER name, so
        # recording it would poison lookups; skip those entirely.
        alias = None
        is_function = False
        while i < len(toks) and toks[i].text != ";":
            if toks[i].text == "(":
                is_function = True
            if toks[i].kind == "id" and not is_function:
                alias = toks[i].text
            i += 1
        if alias and underlying and alias != underlying and not is_function:
            self.aliases[alias] = underlying
        return i + 1

    def _tag_decl(self, toks, i) -> int:
        """`struct Name { ... };` at top level (not a typedef)."""
        tag_kw = toks[i].text
        i += 1
        name = None
        if i < len(toks) and toks[i].kind == "id":
            name = toks[i].text
            i += 1
        if i < len(toks) and toks[i].text == "{":
            i, body = self._skip_braces(toks, i)
            if name is not None and tag_kw != "enum":
                self.structs[name] = StructInfo(name, self._members(body))
            elif name is not None:
                self.structs[name] = StructInfo(name, [])
        return i

    # -- queries -------------------------------------------------------------

    def resolve_alias(self, name: str) -> str:
        """Follow the typedef chain to the underlying type (trueTypeDecl
        role); cycle-safe, returns the input when it aliases nothing."""
        seen = set()
        while name in self.aliases and name not in seen:
            seen.add(name)
            name = self.aliases[name]
        return name

    def member_leaf_types(self, root: str) -> list[str]:
        """Recursive leaf member types of `root` (mapToMemberTypes role):
        leaves are types unknown to this unit ("external") or known types
        without members; recursion guards against self-referential
        structs with a seen-set. Sorted + deduped like the script."""
        out: list[str] = []
        seen: set[str] = set()

        def walk(name: str) -> None:
            name = self.resolve_alias(name)
            if name in seen:
                return
            seen.add(name)
            info = self.structs.get(name)
            if info is None:
                out.append(name)  # external leaf
                return
            if not info.member_types:
                out.append(name)  # memberless internal leaf
                return
            for mt in info.member_types:
                # strip tag keywords + qualifiers from member spellings
                base = [
                    w for w in mt.split()
                    if w not in _TAGS and w not in _QUALIFIERS
                ]
                walk(base[-1] if base else mt)

        walk(root)
        return sorted(set(out))
