"""Abstract-dataflow vocabulary: train-split hash -> embedding index.

Reimplements the reference's vocab pipeline
(DDFA/sastvd/helpers/datasets.py:587-692 abs_dataflow +
DDFA/sastvd/scripts/dbize_absdf.py):

1. per subkey, the "known" values are the limit_subkeys most frequent
   values over TRAIN-split definition nodes (datatype is single-valued,
   others multi-valued — `single` table, datasets.py:551-556);
2. each definition node gets an "all"-hash: json of
   {subkey: sorted set of values, unknown values replaced by "UNKNOWN"};
3. the vocab is the limit_all most frequent train all-hashes;
4. node feature index: 0 = not a definition, 1 = UNKNOWN hash,
   2 + rank = known hash (dbize_absdf.py:35-42; input_dim = limit_all + 2).

The flagship model uses four independent single-subkey vocabs
(feat `_ABS_DATAFLOW_{subkey}_all_...` per embedding table).

The port's copy of the reference's `deepdfa_tpu/frontend/vocab.py`.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Iterable, Mapping

Fields = list[tuple[str, str]]  # (subkey, value) pairs for one def node

SINGLE_VALUED = {"api": False, "datatype": True, "literal": False, "operator": False}

NOT_A_DEF = 0
UNKNOWN_IDX = 1


def _subkey_values(fields: Fields, subkey: str) -> list[str]:
    """Raw values of one subkey for a node, in stage-2 hash order (sorted)."""
    return sorted(v for k, v in fields if k == subkey)


def _node_all_hash(
    fields: Fields, subkey: str, known: set[str] | None
) -> str | None:
    """The "all" hash for one node and one subkey; None if the node has no
    values for this subkey (reference: hash.{subkey} is NaN after explode)."""
    values = _subkey_values(fields, subkey)
    if not values:
        return None
    if SINGLE_VALUED[subkey]:
        vals = [values[0]]
    else:
        vals = sorted(set(values))
    if known is not None:
        vals = [v if v in known else "UNKNOWN" for v in vals]
    return json.dumps({subkey: sorted(set(vals))})


@dataclasses.dataclass
class AbsDfVocab:
    """One subkey's hash->index vocabulary."""

    subkey: str
    limit_all: int
    limit_subkeys: int
    known_values: tuple[str, ...]  # top train values (freq order)
    hash_index: dict[str, int]  # all-hash -> rank (0-based)

    def __post_init__(self):
        self._known_set = frozenset(self.known_values)

    def encode(self, fields: Fields | None) -> int:
        """Embedding index for one node (0 not-def / 1 unknown / 2+rank)."""
        if fields is None:
            return NOT_A_DEF
        h = _node_all_hash(fields, self.subkey, self._known_set)
        if h is None:
            return NOT_A_DEF
        rank = self.hash_index.get(h)
        return UNKNOWN_IDX if rank is None else rank + 2

    @property
    def input_dim(self) -> int:
        return self.limit_all + 2

    def to_json(self) -> dict:
        return {
            "subkey": self.subkey,
            "limit_all": self.limit_all,
            "limit_subkeys": self.limit_subkeys,
            "known_values": list(self.known_values),
            "hashes": [h for h, _ in sorted(self.hash_index.items(), key=lambda kv: kv[1])],
        }

    @classmethod
    def from_json(cls, d: dict) -> "AbsDfVocab":
        return cls(
            subkey=d["subkey"],
            limit_all=d["limit_all"],
            limit_subkeys=d["limit_subkeys"],
            known_values=tuple(d["known_values"]),
            hash_index={h: i for i, h in enumerate(d["hashes"])},
        )


def build_vocab(
    train_node_fields: Iterable[Fields],
    subkey: str,
    limit_all: int | None = 1000,
    limit_subkeys: int | None = 1000,
) -> AbsDfVocab:
    """Build one subkey vocab from TRAIN-split definition-node fields."""
    train_node_fields = list(train_node_fields)

    # step 1: known values = most frequent train values
    counts: Counter[str] = Counter()
    for fields in train_node_fields:
        values = _subkey_values(fields, subkey)
        if not values:
            continue
        if SINGLE_VALUED[subkey]:
            counts[values[0]] += 1
        else:
            # reference explodes sorted set -> one count per distinct value
            for v in sorted(set(values)):
                counts[v] += 1
    most = counts.most_common(limit_subkeys)
    known = tuple(v for v, _ in most)

    # step 2+3: all-hash frequency over train
    known_set = set(known)
    hash_counts: Counter[str] = Counter()
    for fields in train_node_fields:
        h = _node_all_hash(fields, subkey, known_set)
        if h is not None:
            hash_counts[h] += 1
    top = hash_counts.most_common(limit_all)
    hash_index = {h: i for i, (h, _) in enumerate(top)}
    return AbsDfVocab(
        subkey=subkey,
        limit_all=limit_all if limit_all is not None else len(hash_index),
        limit_subkeys=limit_subkeys if limit_subkeys is not None else len(known),
        known_values=known,
        hash_index=hash_index,
    )


def build_vocabs(
    train_node_fields: Iterable[Fields],
    subkeys: Iterable[str] = ("api", "datatype", "literal", "operator"),
    limit_all: int | None = 1000,
    limit_subkeys: int | None = 1000,
) -> dict[str, AbsDfVocab]:
    cached = list(train_node_fields)
    return {
        sk: build_vocab(cached, sk, limit_all, limit_subkeys) for sk in subkeys
    }


def encode_nodes(
    vocabs: Mapping[str, AbsDfVocab],
    node_fields: Mapping[int, Fields],
    node_ids: Iterable[int],
    subkey_order: Iterable[str] = ("api", "datatype", "literal", "operator"),
) -> "np.ndarray":
    """Feature matrix [n_nodes, n_subkeys] of embedding indices."""
    import numpy as np

    order = list(subkey_order)
    ids = list(node_ids)
    out = np.zeros((len(ids), len(order)), np.int32)
    for i, nid in enumerate(ids):
        fields = node_fields.get(nid)
        for j, sk in enumerate(order):
            out[i, j] = vocabs[sk].encode(fields)
    return out
