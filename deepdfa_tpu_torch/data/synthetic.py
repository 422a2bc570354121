"""Synthetic Big-Vul-style corpus generator.

The real Big-Vul/MSR CSV (188k C/C++ functions, ~45GB with artifacts) is an
external download; this generator produces structurally similar
(function, fixed-function, changed-lines, label) rows so every pipeline
stage — parsing, CFG, reaching defs, abstract-dataflow vocab, batching,
training — runs hermetically at any scale. Vulnerable variants inject the
classic C bug families the datasets are built around (unbounded string
copy, missing bounds/null checks, off-by-one, integer-size truncation);
the "fix" is the patched form, so diff labels mark the buggy lines exactly
like the reference's git-diff labeling.

The port's copy of the reference's `deepdfa_tpu/data/synthetic.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deepdfa_tpu_torch.data.diffs import vulnerable_lines
from deepdfa_tpu_torch.data.examples import Example

_TYPES = ["int", "unsigned int", "size_t", "long", "char", "short"]
_APIS = ["malloc", "free", "memcpy", "memset", "strlen", "strcpy", "strncpy",
         "snprintf", "read", "write", "calloc", "realloc"]


@dataclasses.dataclass
class SynthExample:
    id: int
    before: str
    after: str
    label: int
    vuln_lines: frozenset[int]
    #: corpus-v2 provenance: bug-family name ("" = plain filler negative,
    #: "lookalike:<fam>" = benign twin), and whether the label was flipped
    #: by injected label noise
    family: str = ""
    noisy: bool = False


def _body_lines(rng: np.random.Generator, n_stmts: int, vulnerable: bool):
    """Returns (before_lines, after_lines). Lines are function-body lines."""
    before: list[str] = []
    after: list[str] = []

    def both(s):
        before.append(s)
        after.append(s)

    both("    char buf[64];")
    both("    int i = 0;")
    both("    int total = 0;")
    both(f"    {_TYPES[int(rng.integers(0, len(_TYPES)))]} tmp = 0;")

    # Every bug family plants at least one *definition* statement with a
    # distinctive abstract-dataflow feature combination (api/datatype/
    # literal/operator) — DeepDFA's features only live on definition nodes,
    # which is exactly how the real datasets' vulnerable functions are
    # recognized (paper §4.1).
    bug = int(rng.integers(0, 4)) if vulnerable else -1
    if bug == 0:
        # unbounded copy: length taken but never clamped
        before.append("    total = strlen(src) + len;")
        before.append("    strcpy(buf, src);")
        after.append("    total = strlen(src);")
        after.append("    strncpy(buf, src, sizeof(buf) - 1);")
        after.append("    buf[sizeof(buf) - 1] = 0;")
    elif bug == 1:
        # missing bounds check on memcpy with sizeof-scaled length
        before.append("    tmp = len * sizeof(char);")
        before.append("    memcpy(buf, src, len);")
        after.append("    if (len > (int)sizeof(buf)) {")
        after.append("        len = (int)sizeof(buf);")
        after.append("    }")
        after.append("    memcpy(buf, src, len);")
    elif bug == 2:
        # off-by-one: index runs to len + 1
        before.append("    i = len + 1;")
        before.append("    total += src[i];")
        after.append("    i = len - 1;")
        after.append("    if (i >= 0) {")
        after.append("        total += src[i];")
        after.append("    }")
    elif bug == 3:
        # unchecked malloc deref
        before.append("    char *p = malloc(len);")
        before.append("    p[0] = 1;")
        after.append("    char *p = malloc(len);")
        after.append("    if (!p) {")
        after.append("        return -1;")
        after.append("    }")
        after.append("    p[0] = 1;")
        both("    free(p);")
    # benign filler statements
    for _ in range(n_stmts):
        k = int(rng.integers(0, 6))
        if k == 0:
            both(f"    tmp = tmp + {int(rng.integers(1, 100))};")
        elif k == 1:
            both(f"    total += i * {int(rng.integers(2, 9))};")
        elif k == 2:
            both("    if (total > tmp) {")
            both(f"        tmp = total - {int(rng.integers(1, 10))};")
            both("    }")
        elif k == 3:
            both(f"    while (i < {int(rng.integers(4, 32))}) {{")
            both("        i++;")
            both("    }")
        elif k == 4:
            api = _APIS[int(rng.integers(0, len(_APIS)))]
            both(f"    total ^= (int){api}(buf);" if api == "strlen"
                 else f"    memset(buf, 0, sizeof(buf));")
        else:
            both(f"    tmp ^= total >> {int(rng.integers(1, 5))};")
    both("    return total;")
    return before, after


def bigvul_stmt_sizes(
    n: int, seed: int = 0, median: float = 14.0, sigma: float = 1.2,
    max_stmts: int = 500,
) -> np.ndarray:
    """Big-Vul-like heavy-tail statement counts (lognormal, clipped).

    Real Big-Vul functions have a median of ~15 lines with a long tail into
    the hundreds — heavy enough that the reference drops its test batch size
    to 16 to fit the tail on GPU (DDFA/sastvd/linevd/datamodule.py:135-141).
    A lognormal with median 14 and sigma 1.2 reproduces that shape (p99 ≈
    230 statements, clipped at 500); benchmarks packed from these sizes are
    comparable to the reference's per-example timings in a way uniform
    2-12-statement toys are not.
    """
    rng = np.random.default_rng(seed)
    sizes = rng.lognormal(mean=float(np.log(median)), sigma=sigma, size=n)
    return np.clip(sizes.astype(np.int64), 2, max_stmts)


def generate(
    n: int,
    vuln_rate: float = 0.06,
    seed: int = 0,
    min_stmts: int = 2,
    max_stmts: int = 12,
    stmt_sizes: np.ndarray | None = None,
) -> list[SynthExample]:
    """Generate `n` examples with the dataset's ~6% positive rate.

    `stmt_sizes` (e.g. from `bigvul_stmt_sizes`) overrides the uniform
    [min_stmts, max_stmts] statement-count draw per example.
    """
    if stmt_sizes is not None and len(stmt_sizes) < n:
        raise ValueError(f"stmt_sizes has {len(stmt_sizes)} entries, need {n}")
    rng = np.random.default_rng(seed)
    out: list[SynthExample] = []
    for gid in range(n):
        vulnerable = bool(rng.random() < vuln_rate)
        if stmt_sizes is not None:
            n_stmts = int(stmt_sizes[gid])
        else:
            n_stmts = int(rng.integers(min_stmts, max_stmts + 1))
        bl, al = _body_lines(rng, n_stmts, vulnerable)
        fname = f"fn_{gid}"
        sig = f"int {fname}(char *src, int len)"
        before = sig + " {\n" + "\n".join(bl) + "\n}\n"
        after = sig + " {\n" + "\n".join(al) + "\n}\n"
        lines = frozenset(vulnerable_lines(before, after)) if vulnerable else frozenset()
        out.append(
            SynthExample(
                id=gid,
                before=before,
                after=after,
                label=int(vulnerable),
                vuln_lines=lines,
            )
        )
    return out


# ---------------------------------------------------------------------------
# corpus v2 (VERDICT r3 item 4): a synthetic task that CANNOT be solved by
# counting tokens/features.
#
# The round-3 corpus was suspiciously easy (test precision 1.000): every
# bug family's buggy form contained feature buckets its fixed form lacked,
# so a bag-of-subkeys classifier separates it linearly. v2 closes that in
# three ways:
#   - ORDER families: the vulnerable and fixed forms contain the SAME
#     statement multiset — only the order differs (guard dominates the use
#     in the fixed form; follows it in the buggy one). Identical subkey
#     histograms, distinguishable only through control/data flow — the
#     dynamics of paper Table 3 (DeepDFA wins via dataflow, not tokens).
#   - BENIGN LOOKALIKES: a configurable share of negatives embed the FIXED
#     form of a random family, so "contains memcpy/clamp/null-check tokens"
#     stops predicting the label for the additive families too.
#   - LABEL NOISE + randomized family placement among filler, killing
#     position heuristics and perfect separability.
# The trivial-baseline control lives in eval/trivial_baseline.py; the
# committed evidence is docs/convergence_run.json (scripts/train_flagship.py
# --corpus v2) where the GGNN must beat that control by a clear margin.

_CLAMP_GUARD = [
    "    if (len > (int)sizeof(buf)) {",
    "        len = (int)sizeof(buf);",
    "    }",
]


def _fam_clamp_order(v: bool) -> list[str]:
    use = ["    memcpy(buf, src, len);"]
    return use + _CLAMP_GUARD if v else _CLAMP_GUARD + use


def _fam_null_check_order(v: bool) -> list[str]:
    alloc = ["    char *p = malloc(len + 1);"]
    guard = ["    if (!p) {", "        return -1;", "    }"]
    use = ["    p[0] = 1;"]
    tail = ["    free(p);"]
    return alloc + (use + guard if v else guard + use) + tail


def _fam_use_after_free(v: bool) -> list[str]:
    alloc = ["    char *q = malloc(16);", "    if (!q) {",
             "        return -1;", "    }", "    q[0] = 2;"]
    use = ["    total += q[0];"]
    fr = ["    free(q);"]
    return alloc + (fr + use if v else use + fr)


def _fam_index_clamp_order(v: bool) -> list[str]:
    setl = ["    i = len;"]
    guard = ["    if (i >= (int)sizeof(buf)) {",
             "        i = (int)sizeof(buf) - 1;", "    }"]
    use = ["    total += buf[i];"]
    return setl + (use + guard if v else guard + use)


def _fam_unbounded_copy(v: bool) -> list[str]:
    if v:
        return ["    total = strlen(src) + len;", "    strcpy(buf, src);"]
    return ["    total = strlen(src);",
            "    strncpy(buf, src, sizeof(buf) - 1);",
            "    buf[sizeof(buf) - 1] = 0;"]


def _fam_missing_bounds(v: bool) -> list[str]:
    if v:
        return ["    tmp = len * sizeof(char);", "    memcpy(buf, src, len);"]
    return _CLAMP_GUARD + ["    memcpy(buf, src, len);"]


def _fam_off_by_one(v: bool) -> list[str]:
    if v:
        return ["    i = len + 1;", "    total += src[i];"]
    return ["    i = len - 1;", "    if (i >= 0) {",
            "        total += src[i];", "    }"]


def _fam_truncation(v: bool) -> list[str]:
    # integer-size truncation before an allocation-sized write
    if v:
        return ["    short n = (short)(len * 2);",
                "    char *w = malloc(n);",
                "    if (!w) {", "        return -1;", "    }",
                "    memset(w, 0, len * 2);", "    free(w);"]
    return ["    long n = (long)len * 2;",
            "    char *w = malloc(n);",
            "    if (!w) {", "        return -1;", "    }",
            "    memset(w, 0, n);", "    free(w);"]


#: order-sensitive families share the exact statement multiset between the
#: two forms; additive families differ in content but their fixed forms
#: also appear as benign lookalikes
V2_FAMILIES: dict[str, object] = {
    "clamp_order": _fam_clamp_order,
    "null_check_order": _fam_null_check_order,
    "use_after_free": _fam_use_after_free,
    "index_clamp_order": _fam_index_clamp_order,
    "unbounded_copy": _fam_unbounded_copy,
    "missing_bounds": _fam_missing_bounds,
    "off_by_one": _fam_off_by_one,
    "truncation": _fam_truncation,
}

#: safe API usages sprinkled into ANY example so raw API presence
#: (strcpy/memcpy/malloc/free) carries no label signal
_SAFE_FILLER = [
    ['    strcpy(buf, "ok");'],
    ["    memcpy(buf, src, sizeof(buf));"],
    ["    char *r = malloc(8);", "    if (r) {", "        r[0] = 1;",
     "        free(r);", "    }"],
    ["    total ^= (int)strlen(buf);"],
]


def _v2_filler_block(rng: np.random.Generator) -> list[str]:
    k = int(rng.integers(0, 8))
    if k == 0:
        return [f"    tmp = tmp + {int(rng.integers(1, 100))};"]
    if k == 1:
        return [f"    total += i * {int(rng.integers(2, 9))};"]
    if k == 2:
        return ["    if (total > tmp) {",
                f"        tmp = total - {int(rng.integers(1, 10))};", "    }"]
    if k == 3:
        return [f"    while (i < {int(rng.integers(4, 32))}) {{",
                "        i++;", "    }"]
    if k == 4:
        return [f"    tmp ^= total >> {int(rng.integers(1, 5))};"]
    if k == 5:
        return ["    memset(buf, 0, sizeof(buf));"]
    return list(_SAFE_FILLER[int(rng.integers(0, len(_SAFE_FILLER)))])


def generate_v2(
    n: int,
    vuln_rate: float = 0.06,
    seed: int = 0,
    min_stmts: int = 2,
    max_stmts: int = 12,
    stmt_sizes: np.ndarray | None = None,
    lookalike_rate: float = 0.5,
    label_noise: float = 0.0,
    families: list[str] | None = None,
) -> list[SynthExample]:
    """Corpus v2: order families + benign lookalikes + label noise.

    `families` restricts the bug families drawn (default all); the
    holdout-family generalization split is built by the caller from the
    per-example `family` field."""
    if stmt_sizes is not None and len(stmt_sizes) < n:
        raise ValueError(f"stmt_sizes has {len(stmt_sizes)} entries, need {n}")
    fam_names = list(families or V2_FAMILIES)
    rng = np.random.default_rng(seed)
    noise_rng = np.random.default_rng(seed + 101)
    out: list[SynthExample] = []
    for gid in range(n):
        vulnerable = bool(rng.random() < vuln_rate)
        if stmt_sizes is not None:
            n_stmts = int(stmt_sizes[gid])
        else:
            n_stmts = int(rng.integers(min_stmts, max_stmts + 1))

        decls = [
            "    char buf[64];",
            "    int i = 0;",
            "    int total = 0;",
            f"    {_TYPES[int(rng.integers(0, len(_TYPES)))]} tmp = 0;",
        ]
        blocks = [_v2_filler_block(rng) for _ in range(n_stmts)]
        family = ""
        fam_before: list[str] | None = None
        fam_after: list[str] | None = None
        if vulnerable:
            family = fam_names[int(rng.integers(0, len(fam_names)))]
            fam_fn = V2_FAMILIES[family]
            fam_before, fam_after = fam_fn(True), fam_fn(False)
        elif rng.random() < lookalike_rate:
            # benign twin: the FIXED form of a random family, unchanged
            fam = fam_names[int(rng.integers(0, len(fam_names)))]
            family = f"lookalike:{fam}"
            fam_before = fam_after = V2_FAMILIES[fam](False)
        pos = int(rng.integers(0, len(blocks) + 1))
        if fam_before is not None:
            blocks_before = blocks[:pos] + [fam_before] + blocks[pos:]
            blocks_after = blocks[:pos] + [fam_after] + blocks[pos:]
        else:
            blocks_before = blocks_after = blocks

        def _assemble(bls):
            body = [line for b in bls for line in b]
            sig = f"int fn_{gid}(char *src, int len)"
            return sig + " {\n" + "\n".join(decls + body) + "\n    return total;\n}\n"

        before = _assemble(blocks_before)
        after = _assemble(blocks_after)
        label = int(vulnerable)
        lines = (
            frozenset(vulnerable_lines(before, after)) if vulnerable else frozenset()
        )
        noisy = bool(label_noise and noise_rng.random() < label_noise)
        if noisy:
            label = 1 - label
            if label == 0:
                lines = frozenset()  # a "benign" label carries no line labels
        out.append(
            SynthExample(
                id=gid, before=before, after=after, label=label,
                vuln_lines=lines, family=family, noisy=noisy,
            )
        )
    return out


def to_examples(synth: list[SynthExample]) -> list[Example]:
    return [
        Example(
            id=s.id, code=s.before, label=float(s.label), vuln_lines=s.vuln_lines
        )
        for s in synth
    ]


def split_ids(
    n: int, seed: int = 0, train: float = 0.8, val: float = 0.1
) -> tuple[list[int], list[int], list[int]]:
    """Random disjoint train/val/test id splits (reference keeps fixed
    splits in csv; synthetic data splits by seeded permutation)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(n * train)
    n_val = int(n * val)
    return (
        perm[:n_train].tolist(),
        perm[n_train : n_train + n_val].tolist(),
        perm[n_train + n_val :].tolist(),
    )


def flagship_corpus(
    n_examples: int,
    seed: int = 7,
    vuln_rate: float = 0.06,
    limit_all: int = 1000,
    workers: int = 0,
):
    """GraphSpecs for the flagship benchmark workload: Big-Vul-tail CFG
    sizes through the FULL frontend pipeline at the flagship feature
    limits (limit_all 1000 -> input_dim 1002). The single definition
    shared by bench.py, scripts/bench_prefetch.py, and anything else
    that claims to measure "the flagship workload" — so the corpus can
    never silently diverge between benchmarks."""
    from deepdfa_tpu_torch.data.pipeline import build_dataset

    sizes = bigvul_stmt_sizes(n_examples, seed=seed)
    synth = generate(
        n_examples, vuln_rate=vuln_rate, seed=seed, stmt_sizes=sizes
    )
    specs, _ = build_dataset(
        to_examples(synth), train_ids=range(n_examples),
        limit_all=limit_all, limit_subkeys=limit_all, workers=workers,
    )
    return specs
