"""Dataset readers for the real corpora (Big-Vul/MSR, Devign).

Reproduces the reference's dataset construction semantics
(DDFA/sastvd/helpers/datasets.py:139-292 bigvul):
- comment stripping on before/after functions,
- per-example diff -> removed/added lines (in-process difflib instead of
  one `git diff --no-index` subprocess per row, git.py:12-165),
- vulnerable-row post-filters: drop no-change vulns, abnormal endings,
  mod_prop >= 0.7, functions of <= 5 lines,
- split partitions from a splits csv (id,split) or a seeded random split
  (datasets.py ds_partition / bigvul_rand_splits.csv).

Outputs the pipeline's `Example` rows; everything downstream (extraction,
vocab, batching) is dataset-agnostic.

The port's copy of the reference's `deepdfa_tpu/data/readers.py`, which
reads its csv files with pandas; the port has no pandas, so `_read_csv`
reads them with `csv` and keeps the pandas semantics the readers rely
on: an empty header cell at position i is the column `Unnamed: i`, a
missing cell or one of pandas' default NA strings is NaN (so `str()` of
it is "nan"), blank lines are skipped, and a quoted cell may span lines.
Column types are not inferred: ids and labels are converted where they
are read, as the reference's `int()`/`float()` calls do; the one column
whose values are compared and sorted, `cross_project_splits`'s
`project`, is typed as pandas types it (`_typed_column`).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import re
import sys
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from deepdfa_tpu_torch.data.diffs import labeled_diff, split_lines
from deepdfa_tpu_torch.data.examples import Example
from deepdfa_tpu_torch.frontend.tokens import strip_comments

NAN = float("nan")

#: the strings pandas' read_csv reads as NaN by default
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
))

Row = dict[str, object]


def _read_csv(path: str | Path) -> tuple[list[str], list[Row]]:
    """(columns, rows) of a csv file, each row a {column: str | NaN} dict."""
    limit = csv.field_size_limit()
    csv.field_size_limit(sys.maxsize)  # Big-Vul functions exceed the 128 KiB default
    try:
        with open(path, encoding="utf-8-sig", newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            columns = [c if c else f"Unnamed: {i}" for i, c in enumerate(header)]
            rows = []
            for cells in reader:
                if not cells:
                    continue
                cells = cells + [""] * (len(columns) - len(cells))
                rows.append({
                    c: NAN if v in NA_STRINGS else v for c, v in zip(columns, cells)
                })
    finally:
        csv.field_size_limit(limit)
    return columns, rows


def _isnan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _int(v) -> int:
    """int() of a cell as pandas would have typed it (int, or float when
    the text has a fraction or exponent); NaN raises, as in pandas."""
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            return int(float(v))
    return int(v)


def _num(v) -> float:
    return v if isinstance(v, float) else float(v)


def _clean_func(code: str) -> str:
    return strip_comments(str(code))


def _keep_vulnerable(
    before: str, removed: set[int], added: set[int]
) -> bool:
    if not removed and not added:
        return False  # vulnerable but no change recorded
    tail = before.strip()[-1:] if before.strip() else ""
    if tail not in ("}", ";"):
        return False
    if before.strip()[-2:] == ");":
        return False
    # line counts use the same \n-only numbering as the diff labels
    n_before = len(split_lines(before))
    n_lines = max(n_before, 1)
    mod_prop = (len(removed) + len(added)) / n_lines
    if mod_prop >= 0.7:
        return False
    if n_before <= 5:
        return False
    return True


def _read_with_ids(csv_path: str | Path, columns: tuple[str, ...]) -> list[Row]:
    """Read selected Big-Vul csv columns with the row index normalized to
    an `id` column (the unnamed first column 'Unnamed: 0', else the row
    number)."""
    names, rows = _read_csv(csv_path)
    keep = [c for c in columns if c in names]
    if "Unnamed: 0" in names:
        return [{"id": r["Unnamed: 0"], **{c: r[c] for c in keep}} for r in rows]
    return [{"id": i, **{c: r[c] for c in keep}} for i, r in enumerate(rows)]


def _stratified_sample(rows: list[Row], sample: int) -> list[Row]:
    """pandas' `groupby(vul != 0)` (False first), `g.sample(k,
    random_state=0)` per class, then back into row order."""
    per_class = max(1, sample // 2)
    picked: list[int] = []
    for positive in (False, True):
        group = [i for i, r in enumerate(rows) if (_num(r["vul"]) != 0) == positive]
        if group:
            k = min(per_class, len(group))
            draw = np.random.RandomState(0).choice(len(group), size=k, replace=False)
            picked.extend(group[j] for j in draw)
    return [rows[i] for i in sorted(picked)]


def read_bigvul(
    csv_path: str | Path,
    sample: int | None = None,
) -> list[Example]:
    """MSR_data_cleaned.csv schema: func_before/func_after/vul columns,
    row index as example id."""
    rows = _read_with_ids(csv_path, ("func_before", "func_after", "vul"))
    if sample:
        # stratified sample-mode corpus (sample_MSR_data.py:6-16: equal
        # seeded draws per class — head() on a ~6%-vul dataset would
        # yield almost no positives), in original row order, not
        # class-0-first: order-sensitive downstream consumers (seeded
        # random splits over row order) must see a stable corpus
        rows = _stratified_sample(rows, sample)
    out: list[Example] = []
    for row in rows:
        before = _clean_func(row["func_before"])
        after = _clean_func(row["func_after"])
        vul = _int(row["vul"])
        if vul:
            # one xdiff pass serves the vuln filters AND the labels
            removed, added, guards = labeled_diff(before, after)
            if not _keep_vulnerable(before, removed, added):
                continue
            lines = frozenset(removed if removed else guards)
        else:
            lines = frozenset()
        out.append(
            Example(id=_int(row["id"]), code=before, label=float(vul), vuln_lines=lines)
        )
    return out


def read_devign(json_path: str | Path, sample: int | None = None) -> list[Example]:
    """Devign function.json: [{"func": ..., "target": 0/1}, ...] — graph
    labels only (no line annotations in this dataset)."""
    rows = json.loads(Path(json_path).read_text())
    if sample:
        rows = rows[:sample]
    return [
        Example(
            id=i,
            code=_clean_func(r["func"]),
            label=float(r.get("target", 0)),
            vuln_lines=frozenset(),
        )
        for i, r in enumerate(rows)
    ]


def read_mutated(
    jsonl_path: str | Path,
    base_examples: Sequence[Example],
    flip: bool = False,
) -> list[Example]:
    """Mutated Big-Vul variants (reference datasets.py:104-126 mutated()):
    jsonl rows {"idx": <base id>, "source": ..., "target": ...} inner-join
    the base dataset on id; the mutated code replaces `before` (the
    `target` field, or `source` for the "_flip" subdatasets) while labels
    and line annotations carry over from the base example."""
    by_id = {e.id: e for e in base_examples}
    key = "source" if flip else "target"
    out: list[Example] = []
    with open(jsonl_path, encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            base = by_id.get(int(row["idx"]))
            if base is None:
                continue  # inner join: only examples with mutated code
            out.append(dataclasses.replace(base, code=_clean_func(row[key])))
    return out


def read_dbgbench(csv_path: str | Path, sample: int | None = None) -> list[Example]:
    """DbgBench real-bug eval corpus (reference paper Table 8; unixcoder
    linevul_main.py:142-145: func column is `code`, label derives from the
    source filename column `c` — buggy unless it contains "patched")."""
    _, rows = _read_csv(csv_path)
    if sample:
        rows = rows[:sample]
    out: list[Example] = []
    for i, row in enumerate(rows):
        label = float("patched" not in str(row["c"]))
        out.append(
            Example(
                id=_int(row.get("id", i)),
                code=_clean_func(row["code"]),
                label=label,
                vuln_lines=frozenset(),
            )
        )
    return out


def read_splits_csv(path: str | Path) -> dict[int, str]:
    """splits csv: columns (id/idx, split) with split in train/val/test
    (the reference's linevul_splits.csv / bigvul_rand_splits.csv shape)."""
    columns, rows = _read_csv(path)
    id_col = next(c for c in ("id", "idx", "example_id", columns[0]) if c in columns)
    split_col = next(c for c in ("split", "partition", columns[-1]) if c in columns)
    mapping = {}
    rename = {"valid": "val", "holdout": "test"}
    for row in rows:
        s = str(row[split_col]).lower()
        mapping[_int(row[id_col])] = rename.get(s, s)
    return mapping


_INT_CELL = re.compile(r"\s*[+-]?\d+\s*")


def _typed_column(rows: list[Row], column: str) -> list[Row]:
    """`column` typed as pandas types it: ints when every non-NaN cell
    parses as one (pandas makes such a column int64, or float64 beside a
    NaN; either sorts and compares as numbers), else the text as read."""
    cells = [r[column] for r in rows if not _isnan(r[column])]
    if not cells or not all(_INT_CELL.fullmatch(c) for c in cells):
        return rows
    return [r if _isnan(r[column]) else {**r, column: int(r[column])} for r in rows]


def cross_project_splits(
    csv_path: str | Path,
    test_projects: Sequence[str] | None = None,
    holdout_frac: float = 0.2,
    seed: int = 0,
) -> dict[int, str]:
    """Project-disjoint splits for cross-project generalization evaluation
    (reference paper Table 7: train on some projects, test on unseen ones).

    Reads the `project` column of the Big-Vul csv. Either pass explicit
    test_projects, or a seeded holdout_frac of projects becomes test and
    the rest splits train/val 90/10 by example."""
    rows = _typed_column(_read_with_ids(csv_path, ("project",)), "project")
    projects = sorted({r["project"] for r in rows if not _isnan(r["project"])})
    rng = np.random.default_rng(seed)
    if test_projects is None:
        n_test = max(1, int(len(projects) * holdout_frac))
        test_projects = [
            projects[i] for i in rng.permutation(len(projects))[:n_test]
        ]
    test_set = set(test_projects)
    out: dict[int, str] = {}
    for row in rows:
        if row["project"] in test_set:
            out[_int(row["id"])] = "test"
        else:
            out[_int(row["id"])] = "train" if rng.random() < 0.9 else "val"
    return out


def random_splits(
    ids: Iterable[int], seed: int = 0, train: float = 0.8, val: float = 0.1
) -> dict[int, str]:
    ids = np.array(sorted(ids))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ids))
    n_train = int(len(ids) * train)
    n_val = int(len(ids) * val)
    out: dict[int, str] = {}
    for k, i in enumerate(perm):
        split = "train" if k < n_train else ("val" if k < n_train + n_val else "test")
        out[int(ids[i])] = split
    return out


def partition(
    examples: list[Example], splits: dict[int, str]
) -> dict[str, list[Example]]:
    out: dict[str, list[Example]] = {"train": [], "val": [], "test": []}
    for ex in examples:
        s = splits.get(ex.id)
        if s in out:
            out[s].append(ex)
    # split disjointness is an invariant the reference asserts at runtime
    # (datamodule.py:74-78); ids are unique by construction here
    return out
