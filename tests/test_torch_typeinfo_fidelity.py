"""The type registry and the CPG fidelity measures of the port
(deepdfa_tpu_torch/frontend/typeinfo.py, fidelity.py) against the
reference's, exactly, on the CPU.

- `TypeRegistry`: the reference tests' translation unit and its
  function-pointer, garbage and cycle cases, the fidelity corpus, 300
  seeded synthetic functions and 64 seeded declaration soups (typedef
  chains, tagged and anonymous structs and unions, enums, function
  pointer typedefs, qualifiers, pointers, arrays, stray tokens): the
  aliases, the struct tables, every alias resolution and every leaf
  expansion are the reference's, under the default (native) lexer and
  under the Python lexer of both packages;
- `compare_cpgs`, `agreement_report`, `fidelity_against_joern` (from
  exports and through a stub session), `cpg_line_spec`,
  `compare_to_spec`, `corpus_report` over tests/fidelity_corpus/ and the
  `main` shim's JSON: the port's dicts are the reference's.
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from deepdfa_tpu import native as ref_native  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.frontend import fidelity as ref_fidelity  # noqa: E402
from deepdfa_tpu.frontend import joern_io as ref_joern_io  # noqa: E402
from deepdfa_tpu.frontend import parser as ref_parser  # noqa: E402
from deepdfa_tpu.frontend import typeinfo as ref_typeinfo  # noqa: E402

from deepdfa_tpu_torch import native  # noqa: E402
from deepdfa_tpu_torch.frontend import fidelity, joern_io, parser, typeinfo  # noqa: E402
from deepdfa_tpu_torch.frontend.joern_session import JoernSession  # noqa: E402
from deepdfa_tpu_torch.testing import joern_stub  # noqa: E402

from joern_fixtures import BUILDERS, SOURCES  # noqa: E402

ROOT = Path(__file__).resolve().parent
CORPUS_DIR = ROOT / "fidelity_corpus"
CORPUS = {p.name: p.read_text() for p in sorted(CORPUS_DIR.glob("*.c*"))}

#: the reference tests' translation unit (tests/test_typeinfo.py)
SRC = """
typedef unsigned long size_t;
typedef size_t my_size;

struct Point { int x; int y; };
typedef struct Point PointT;

struct Inner { char *name; size_t len; };
struct Outer {
    struct Inner first;
    struct Point p;
    double weight;
    struct Outer *next;
};

typedef struct { int fd; } Handle;
enum Color { RED, GREEN };
"""

CASES = {
    "reference_unit": SRC,
    "function_pointers": ("typedef int (*cmp)(int a, int b);\n"
                          "typedef void fn(char c);\n"
                          "typedef unsigned int uint;\n"),
    "garbage": "@#$ not C at all {{{",
    "empty": "",
    "unterminated": "struct A { int x; struct B { char c;",
}

_BASE = ["int", "char", "long", "short", "float", "double", "void", "_Bool", "size_t",
         "uint8_t", "FILE", "u32"]
_QUAL = ["const", "volatile", "unsigned", "signed", "static", "long", "short"]


def _decl_soup(rng) -> str:
    """A seeded translation unit of type declarations and noise."""
    names = [f"T{i}" for i in range(8)]
    out = []
    for _ in range(int(rng.integers(4, 14))):
        kind = int(rng.integers(0, 8))
        pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
        if kind == 0:
            quals = " ".join(pick(_QUAL) for _ in range(int(rng.integers(0, 3))))
            out.append(f"typedef {quals} {pick(_BASE + names)} {pick(names)};")
        elif kind in (1, 2):
            tag = pick(["struct", "union", "struct"])
            members = []
            for _ in range(int(rng.integers(0, 5))):
                t = pick(_BASE + names + [f"struct {pick(names)}", f"union {pick(names)}"])
                q = pick(["", "const ", "unsigned ", "volatile "])
                ptr = pick(["", "*", "**"])
                arr = pick(["", "[4]", "[N]"])
                members.append(f"  {q}{t} {ptr}m{len(members)}{arr};")
            body = "{\n" + "\n".join(members) + "\n}"
            if kind == 1:
                out.append(f"{tag} {pick(names)} {body};")
            else:
                name = pick(names + [""])
                out.append(f"typedef {tag} {name} {body} {pick(names)};".replace("  ", " "))
        elif kind == 3:
            out.append(f"enum {pick(names)} {{ A{len(out)}, B{len(out)} }};")
        elif kind == 4:
            out.append(f"typedef {pick(_BASE)} (*{pick(names)})({pick(_BASE)} a, int b);")
        elif kind == 5:
            out.append(f"typedef struct {pick(names)} {pick(names)};")
        elif kind == 6:
            out.append(f"int f{len(out)}(int x) {{ struct {pick(names)} *p = 0; return x; }}")
        else:
            out.append(pick(["#define N 4", "static int g;", ";", "typedef ;", "struct ;"]))
    return "\n".join(out) + ("\n" if rng.random() < 0.5 else "")


def _units() -> dict[str, str]:
    units = dict(CASES)
    units.update({f"corpus/{k}": v for k, v in CORPUS.items()})
    for e in ref_synthetic.generate(300, seed=11):
        units[f"synthetic/{e.id}"] = e.before
    rng = np.random.default_rng(24)
    for i in range(64):
        units[f"soup/{i}"] = _decl_soup(rng)
    return units


UNITS = _units()


@contextlib.contextmanager
def python_paths():
    """Both packages' lexers without their native libraries."""
    saved = ref_native.available, native.available
    ref_native.available = native.available = lambda: False
    try:
        yield
    finally:
        ref_native.available, native.available = saved


def _registry_view(mod, code: str) -> dict:
    reg = mod.TypeRegistry.from_source(code)
    names = (sorted(reg.aliases) + sorted(reg.structs)
             + ["FILE", "int", "unknown_t", "T0", "T1", "Point", "Outer", "Handle"])
    return {
        "aliases": dict(reg.aliases),
        "structs": {k: (v.name, list(v.member_types)) for k, v in reg.structs.items()},
        "resolve": {n: reg.resolve_alias(n) for n in names},
        "leaves": {n: reg.member_leaf_types(n) for n in names},
    }


@pytest.mark.parametrize("lexer", ["default", "python"])
def test_type_registry_equals_reference(lexer):
    ctx = python_paths() if lexer == "python" else contextlib.nullcontext()
    differ = {}
    with ctx:
        for name, code in UNITS.items():
            got, want = _registry_view(typeinfo, code), _registry_view(ref_typeinfo, code)
            if got != want:
                differ[name] = (got, want)
    assert differ == {}
    # the soups reach every declaration shape
    soups = [typeinfo.TypeRegistry.from_source(v) for k, v in UNITS.items()
             if k.startswith("soup/")]
    assert sum(len(r.aliases) for r in soups) > 50 and sum(len(r.structs) for r in soups) > 50


def test_type_registry_reference_answers():
    """The reference tests' assertions, on the port."""
    reg = typeinfo.TypeRegistry.from_source(SRC)
    assert reg.resolve_alias("my_size") == "unsigned long"
    assert reg.resolve_alias("PointT") == "Point"
    assert reg.structs["Point"].member_types == ["int", "int"]
    assert reg.member_leaf_types("Outer") == ["char", "double", "int", "unsigned long"]
    assert reg.member_leaf_types("Handle") == ["int"]
    assert reg.member_leaf_types("Color") == ["Color"]
    reg.aliases.update(a="b", b="a")
    assert reg.resolve_alias("a") in ("a", "b")


# -- fidelity ---------------------------------------------------------------


@pytest.fixture
def exports(tmp_path):
    """{fixture name: export prefix} of the five Joern fixtures."""
    return {name: build(tmp_path) for name, build in BUILDERS.items()}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_compare_cpgs_equals_reference(exports, name):
    got = fidelity.compare_cpgs(parser.parse_function(SOURCES[name]),
                                joern_io.load_joern_cpg(exports[name]))
    want = ref_fidelity.compare_cpgs(ref_parser.parse_function(SOURCES[name]),
                                     ref_joern_io.load_joern_cpg(exports[name]))
    assert got == want
    same = parser.parse_function(SOURCES[name])
    assert fidelity.compare_cpgs(same, same) == ref_fidelity.compare_cpgs(
        ref_parser.parse_function(SOURCES[name]), ref_parser.parse_function(SOURCES[name]))


def test_agreement_report_and_fidelity_against_joern_equal_reference(exports):
    pairs = [(n, parser.parse_function(SOURCES[n]), joern_io.load_joern_cpg(exports[n]))
             for n in sorted(SOURCES)]
    ref_pairs = [(n, ref_parser.parse_function(SOURCES[n]),
                  ref_joern_io.load_joern_cpg(exports[n])) for n in sorted(SOURCES)]
    # the corpus functions against each other's CPG: every measure moves
    names = sorted(CORPUS)
    for a, b in zip(names, names[1:] + names[:1]):
        pairs.append((f"{a}~{b}", parser.parse_function(CORPUS[a]),
                      parser.parse_function(CORPUS[b])))
        ref_pairs.append((f"{a}~{b}", ref_parser.parse_function(CORPUS[a]),
                          ref_parser.parse_function(CORPUS[b])))
    got, want = fidelity.agreement_report(pairs), ref_fidelity.agreement_report(ref_pairs)
    assert got == want and json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert fidelity.agreement_report([]) == ref_fidelity.agreement_report([])
    sources = {n: SOURCES[n] for n in sorted(SOURCES)}
    assert fidelity.fidelity_against_joern(sources, exports) == \
        ref_fidelity.fidelity_against_joern(sources, exports)
    with pytest.raises(ValueError, match="no joern source"):
        fidelity.fidelity_against_joern({"x": "int f() { return 0; }"})


def test_fidelity_against_joern_through_a_session(tmp_path, exports):
    """A live session (the port's stub REPL) in place of the exports."""
    s = JoernSession(binary=str(joern_stub.write_stub(tmp_path / "bin")), timeout=2)
    try:
        got = fidelity.fidelity_against_joern(dict(SOURCES), session=s)
    finally:
        s.close()
    assert got == ref_fidelity.fidelity_against_joern(dict(SOURCES), exports)


@pytest.mark.parametrize("lexer", ["default", "python"])
def test_line_specs_and_corpus_report_equal_reference(lexer):
    expected = json.loads((CORPUS_DIR / "expected.json").read_text())
    ctx = python_paths() if lexer == "python" else contextlib.nullcontext()
    with ctx:
        for name, code in CORPUS.items():
            ours, theirs = parser.parse_function(code), ref_parser.parse_function(code)
            assert fidelity.cpg_line_spec(ours) == ref_fidelity.cpg_line_spec(theirs), name
            stem = Path(name).stem
            if stem in expected:
                assert fidelity.compare_to_spec(ours, expected[stem]) == \
                    ref_fidelity.compare_to_spec(theirs, expected[stem]), name
        got = fidelity.corpus_report(CORPUS_DIR)
        assert got == ref_fidelity.corpus_report(CORPUS_DIR)
    assert got["n_examples"] == sum(Path(n).stem in expected for n in CORPUS) > 50


def test_main_shim_prints_the_reference_report(tmp_path, capsys, exports):
    out = tmp_path / "report.json"
    fidelity.main(["--corpus", str(CORPUS_DIR), "--out", str(out)])
    printed = capsys.readouterr().out
    assert json.loads(printed) == json.loads(out.read_text()) == json.loads(
        json.dumps(ref_fidelity.corpus_report(CORPUS_DIR)))
    # C files with exports beside them: no session needed
    srcs = []
    for name, prefix in sorted(exports.items()):
        Path(prefix).write_text(SOURCES[name])
        srcs.append(prefix)
    fidelity.main(srcs)
    ours = json.loads(capsys.readouterr().out)
    ref_fidelity.main(srcs)
    assert ours == json.loads(capsys.readouterr().out)
