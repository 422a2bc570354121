"""Readers and batching of the generation and clone tasks (the port's
copy of the reference's `deepdfa_tpu/data/gen_data.py`, CodeT5's
`_utils.py:168-310` formats), so the same task files drop in:

- summarize: jsonl with code_tokens / docstring_tokens (+ optional idx);
- translate, refine: "src_file,trg_file" paired line files;
- concode: jsonl with nl / code;
- defect as generation: jsonl with code / target, the target rendered as
  the strings "true" / "false";
- clone: tab-separated url pairs and a sibling data.jsonl of idx -> func.

A `GenBatch` is static-shape [B, S] / [B, T] int32 ids with a [B] row
mask, as numpy arrays until `to(device)`. The port runs on one card:
`batches_of` takes one shard (`num_shards > 1` raises).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GenExample:
    idx: int | str
    source: str
    target: str


@dataclasses.dataclass(frozen=True)
class CloneExample:
    source: str
    target: str
    label: int
    url1: str
    url2: str


def _collapse_ws(s: str) -> str:
    return " ".join(s.split())


def read_summarize_examples(filename: str, data_num: int = -1) -> list[GenExample]:
    examples = []
    with open(filename, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            js = json.loads(line.strip())
            code = _collapse_ws(" ".join(js["code_tokens"]).replace("\n", " "))
            nl = _collapse_ws(" ".join(js["docstring_tokens"]).replace("\n", ""))
            examples.append(GenExample(idx=js.get("idx", idx), source=code, target=nl))
            if idx + 1 == data_num:
                break
    return examples


def _read_paired(filename: str, data_num: int) -> list[GenExample]:
    src_file, trg_file = filename.split(",")
    examples = []
    with open(src_file) as f1, open(trg_file) as f2:
        for idx, (line1, line2) in enumerate(zip(f1, f2)):
            examples.append(GenExample(idx=idx, source=line1.strip(), target=line2.strip()))
            if idx + 1 == data_num:
                break
    return examples


def read_translate_examples(filename: str, data_num: int = -1) -> list[GenExample]:
    return _read_paired(filename, data_num)


def read_refine_examples(filename: str, data_num: int = -1) -> list[GenExample]:
    return _read_paired(filename, data_num)


def read_concode_examples(filename: str, data_num: int = -1) -> list[GenExample]:
    examples = []
    with open(filename) as f:
        for idx, line in enumerate(f):
            js = json.loads(line)
            examples.append(GenExample(idx=idx, source=js["nl"].strip(),
                                       target=js["code"].strip()))
            if idx + 1 == data_num:
                break
    return examples


def read_defect_gen_examples(filename: str, data_num: int = -1) -> list[GenExample]:
    """Defect detection as generation: the target is "true" / "false"."""
    examples = []
    with open(filename, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            js = json.loads(line.strip())
            target = {0: "false", 1: "true"}[int(js["target"])]
            examples.append(GenExample(idx=js.get("idx", idx), source=_collapse_ws(js["code"]),
                                       target=target))
            if idx + 1 == data_num:
                break
    return examples


def read_clone_examples(filename: str, data_num: int = -1) -> list[CloneExample]:
    """Tab-separated "url1\\turl2\\tlabel" rows; the code bodies come from
    the sibling data.jsonl; pairs with an unknown url are skipped."""
    data_jsonl = os.path.join(os.path.dirname(filename), "data.jsonl")
    url_to_code = {}
    with open(data_jsonl) as f:
        for line in f:
            js = json.loads(line.strip())
            url_to_code[str(js["idx"])] = _collapse_ws(js["func"])
    data = []
    with open(filename) as f:
        for line in f:
            url1, url2, label = line.strip().split("\t")
            if url1 not in url_to_code or url2 not in url_to_code:
                continue
            data.append(CloneExample(source=url_to_code[url1], target=url_to_code[url2],
                                     label=0 if label == "0" else 1, url1=url1, url2=url2))
            if len(data) == data_num:
                break
    return data


READERS = {
    "summarize": read_summarize_examples,
    "translate": read_translate_examples,
    "refine": read_refine_examples,
    "concode": read_concode_examples,
    "defect": read_defect_gen_examples,
}


def one_shard(num_shards: int) -> None:
    if num_shards != 1:
        raise NotImplementedError(
            f"num_shards={num_shards}: the port trains on one card; data-parallel "
            "sharding comes with the multi-device slice (ROADMAP queue A, item 9)"
        )


def to_tensor(x: Any, dev: torch.device) -> torch.Tensor:
    """x (a numpy array or a tensor) as a tensor on `dev`, dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@dataclasses.dataclass(frozen=True)
class GenBatch:
    source_ids: Any  # [B, S] int32
    target_ids: Any  # [B, T] int32
    row_mask: Any  # [B] bool (False = padding row)

    def to(self, device: str | torch.device) -> "GenBatch":
        """The same batch as torch tensors on `device` (dtypes kept)."""
        dev = torch.device(device)
        return GenBatch(to_tensor(self.source_ids, dev), to_tensor(self.target_ids, dev),
                        to_tensor(self.row_mask, dev))


def collate_gen(source_ids: np.ndarray, target_ids: np.ndarray, batch_rows: int,
                pad_id: int = 0) -> GenBatch:
    """The rows padded to `batch_rows` with pad-id rows (row mask False)."""
    n = source_ids.shape[0]
    if n > batch_rows:
        raise ValueError(f"{n} rows > batch_rows {batch_rows}")
    src = np.full((batch_rows, source_ids.shape[1]), pad_id, np.int32)
    tgt = np.full((batch_rows, target_ids.shape[1]), pad_id, np.int32)
    src[:n] = source_ids
    tgt[:n] = target_ids
    mask = np.zeros((batch_rows,), bool)
    mask[:n] = True
    return GenBatch(source_ids=src, target_ids=tgt, row_mask=mask)


def batches_of(source_ids: np.ndarray, target_ids: np.ndarray, num_shards: int,
               rows_per_shard: int, pad_id: int = 0,
               shuffle_seed: int | None = None) -> list[GenBatch]:
    """One epoch as GenBatches of `rows_per_shard` rows (the last one
    padded), in the order `np.random.default_rng(shuffle_seed)` shuffles
    the rows to (the reference's order), or in file order."""
    one_shard(num_shards)
    n = source_ids.shape[0]
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    return [collate_gen(source_ids[order[i:i + rows_per_shard]],
                        target_ids[order[i:i + rows_per_shard]], rows_per_shard, pad_id)
            for i in range(0, n, rows_per_shard)]
