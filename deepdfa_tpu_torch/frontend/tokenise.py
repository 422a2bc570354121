"""IVDetect identifier tokenization (subtoken splitting; the port's copy
of the reference's `deepdfa_tpu/frontend/tokenise.py`).

Port of DDFA/sastvd/helpers/tokenise.py:4-35: split on special characters,
split camelCase boundaries, drop single-character subtokens. Used by the
IVDetect-style per-line feature extraction.
"""

from __future__ import annotations

import re

_SPEC_CHAR = re.compile(r"[^a-zA-Z0-9\s]")
_CAMEL = re.compile(r".+?(?:(?<=[a-z])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])|$)")


def tokenise(s: str) -> str:
    spec_split = re.split(_SPEC_CHAR, s)
    space_split = " ".join(spec_split).split()
    camel_split = [
        m.group(0) for tok in space_split for m in re.finditer(_CAMEL, tok)
    ]
    return " ".join(t for t in camel_split if len(t) > 1)


def tokenise_lines(s: str) -> list[str]:
    out = []
    for line in s.split("\n"):  # \n-only, like every line consumer here
        tok = tokenise(line)
        if tok:
            out.append(tok)
    return out
