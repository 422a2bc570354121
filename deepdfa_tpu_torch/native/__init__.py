"""ctypes bindings of the port's native host library (the port's
counterpart of the reference's `deepdfa_tpu/native/__init__.py`).

Loads `libdeepdfa_native-<hash>.so`, building it at first use
(`native/build.py`, g++), and exposes:

  rd_solve_native(...)  — bitset worklist reaching definitions
  lex_c_native(code)    — the C tokenizer, returning frontend Tokens
  available()           — whether the native path can be used

Each has a pure-Python equivalent (`frontend/reaching.py`,
`frontend/tokens.py`), the executable spec. `tokenize()` and
`ReachingDefinitions.solve()` dispatch here under backend "auto" (the
lexer for pure-ASCII input only: its fast path is byte-based). Native
Tokens carry col 0.

No fallback hides a fault: `available()` is False only on a machine
without g++; where g++ is on PATH and the build fails it raises with
the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from deepdfa_tpu_torch.native import build as _build


@functools.lru_cache()
def _lib():
    lib = ctypes.CDLL(str(_build.build()))
    lib.rd_solve.restype = ctypes.c_int64
    lib.rd_solve.argtypes = [
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.lex_c.restype = ctypes.c_int64
    lib.lex_c.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


@functools.lru_cache()
def available() -> bool:
    """True when the library loads (built now if missing); False only
    without g++ on PATH. Cached, as the dispatch asks once a call; a
    failed build raises, and is not cached."""
    if _build.compiler() is None and not _build.library_path().exists():
        return False
    _lib()
    return True


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def rd_solve_native(
    n_nodes: int,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    def_var: np.ndarray,
) -> dict[int, set[int]]:
    """IN sets per node as {node: set(def_node_ids)}.

    def_var: [n_nodes] int32, the variable id defined at each node (-1 if
    the node defines nothing)."""
    lib = _lib()
    edge_src = np.ascontiguousarray(edge_src, np.int32)
    edge_dst = np.ascontiguousarray(edge_dst, np.int32)
    def_var = np.ascontiguousarray(def_var, np.int32)
    site_nodes = np.flatnonzero(def_var >= 0)
    n_words = max(1, (len(site_nodes) + 63) // 64)
    out = np.zeros((n_nodes, n_words), np.uint64)
    n_sites = lib.rd_solve(
        n_nodes,
        len(edge_src),
        _ptr(edge_src, ctypes.c_int32),
        _ptr(edge_dst, ctypes.c_int32),
        _ptr(def_var, ctypes.c_int32),
        _ptr(out, ctypes.c_uint64),
    )
    if n_sites < 0:
        raise RuntimeError("rd_solve failed")
    assert n_sites == len(site_nodes)
    site_nodes = site_nodes.tolist()
    result: dict[int, set[int]] = {}
    for n, bits in enumerate(out.tolist()):
        sites: set[int] = set()
        for w, word in enumerate(bits):
            while word:
                b = word & -word
                sites.add(site_nodes[w * 64 + b.bit_length() - 1])
                word ^= b
        result[n] = sites
    return result


_KINDS = ["id", "kw", "num", "str", "char", "op"]


def lex_c_native(code: str):
    """Tokenize with the native lexer; frontend Token objects (col 0),
    without the trailing end-of-file token."""
    from deepdfa_tpu_torch.frontend.tokens import Token

    lib = _lib()
    raw = code.encode("utf-8", errors="replace")
    max_tokens = max(64, len(raw) + 1)
    kinds = np.zeros(max_tokens, np.int32)
    starts = np.zeros(max_tokens, np.int64)
    ends = np.zeros(max_tokens, np.int64)
    lines = np.zeros(max_tokens, np.int32)
    n = lib.lex_c(
        raw,
        len(raw),
        max_tokens,
        _ptr(kinds, ctypes.c_int32),
        _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64),
        _ptr(lines, ctypes.c_int32),
    )
    if n < 0:
        raise RuntimeError("lex_c: token budget exceeded")
    return [Token(_KINDS[k], raw[s:e].decode("utf-8", errors="replace"), ln, 0)
            for k, s, e, ln in zip(kinds[:n].tolist(), starts[:n].tolist(),
                                   ends[:n].tolist(), lines[:n].tolist())]
