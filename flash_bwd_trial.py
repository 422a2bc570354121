#!/usr/bin/env python3
"""Time tile layouts of kernels 6 and 7, the tensor-core flash dq and
dk/dv, against each other on one CUDA card, from copies of their source
that differ in a line or two.

    python3 flash_bwd_trial.py [--layouts LABEL ...] [--source LABEL=PATH ...] [--out FILE]

Run from the root of a checkout on a machine with the card and the CUDA
toolkit. The builds are copies of deepdfa_tpu_torch/csrc/flash_attention.cu
under build/deepdfa_tpu_torch/trial/LABEL/:

- as_is: the source unedited;
- uncapped: neither kernel's registers capped (`BwdMmaLayout::kDqBlocks`,
  `kDkvBlocks` 1), in place of 128 for four dq blocks an SM and 168 for
  three non-causal dk/dv blocks at D <= 64;
- dq_blocks3: dq capped at 168 registers for three blocks;
- sub64_uncapped: both kernels score a whole 64-column tile at a time,
  in place of 32-column parts (`kDqSub`, `kDkvSub`), uncapped: the first
  layout of this design;
- dq_rows128: the dq block at 128 query rows (8 warps) in place of 64
  (`kDqRows`), uncapped;
- dkv_keys128: the dk/dv block at 128 keys (8 warps), halving the
  re-reads of q and do, in place of 64 (`kDkvKeys`), uncapped;

(--layouts picks some of them; by default all) and each --source unedited
(an earlier tree's source). Each build's two libraries (non-causal and
causal) are compiled by the package's `cuda_build.build`, every build in
a process of its own, all started together. Each build is then loaded in
a process of its own (the package pointed at its copy through
`cuda_build.CSRC_DIR`) and called through `flash_dq` and `flash_dkv` at
the flagship training call (B 16, H 12, T 512, D 64, bf16, every key
live): plain (scale 1/8), at dropout 0.1 (the DeepDFA+LineVul training
call), with T5's bf16 [H, T, T] bias at scale 1.0 (the CodeT5+DeepDFA
training call), causal, and causal with the bias. The processes run one
at a time, forward then backward through the builds (a, b, ..., b, a);
each times every call as the median of 20 CUDA-event windows
(`chip_smoke.median_ms`), and a build's time is the mean of its two
medians. With the bias, kernel 8 (dbias) is timed beside them: it shares
their exponential (`bwd_p`). Beside each time, the largest difference of
dq, dk, dv (and dbias) from `attention_bwd_plain` on the same inputs
(the same Philox bits under dropout) over each one's largest magnitude,
and whether a repeat gave the same bits; for dq + dk/dv the mean over the two training calls weighted
by their launches on the main paths (MAIN_PATH_LAUNCHES). Prints one JSON
object with the card's name and power limit and each build's ptxas
registers and spills of its D 64 dq and dk/dv instances; --out writes it
to a file too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from flash_fwd_trial import LIBS, SOURCE, result, trial_dir, write_sources

ROOT = Path(__file__).resolve().parent


def _line(name: str, value: int) -> str:
    return f"  static constexpr int {name} = {value};"


_DQ_BLOCKS = "  static constexpr int kDqBlocks = D <= 64 ? 4 : 1;"
_DKV_BLOCKS = "  static constexpr int kDkvBlocks = D <= 64 && !kCausal ? 3 : 1;"
#: label: the edits (text, replacement) made to the source
_UNCAP_DQ = (_DQ_BLOCKS, _line("kDqBlocks", 1))
_UNCAP_DKV = (_DKV_BLOCKS, _line("kDkvBlocks", 1))
EDITS = {
    "as_is": (),
    "uncapped": (_UNCAP_DQ, _UNCAP_DKV),
    "dq_blocks3": ((_DQ_BLOCKS, _DQ_BLOCKS.replace("? 4", "? 3")),),
    "sub64_uncapped": ((_line("kDqSub", 32), _line("kDqSub", 64)),
                       (_line("kDkvSub", 32), _line("kDkvSub", 64)), _UNCAP_DQ, _UNCAP_DKV),
    "dq_rows128": ((_line("kDqRows", 64), _line("kDqRows", 128)), _UNCAP_DQ),
    "dkv_keys128": ((_line("kDkvKeys", 64), _line("kDkvKeys", 128)), _UNCAP_DKV),
}
#: launches of dq and of dk/dv on the main paths of one chip_smoke.py run:
#: ct (combined training) at dropout 0.1, 5t (T5 training) with the bias
MAIN_PATH_LAUNCHES = {"dropout": 276, "bias": 276}
SEED = 20241017


def child(what: str, label: str) -> dict:
    """In a process of its own, the package pointed at `label`'s copy:
    build both libraries and return ptxas's report of the D 64 dq and
    dk/dv instances, or time the calls."""
    from deepdfa_tpu_torch.nn import cuda_build

    cuda_build.CSRC_DIR = trial_dir(label)
    if what == "build":
        from chip_smoke import ptxas_summary

        report = cuda_build.build(LIBS)
        return {lib: {k: v for k, v in ptxas_summary(r["log"]).items()
                      if k.startswith(("flash_dq_bf16_mma<64", "flash_dkv_bf16_mma<64"))}
                for lib, r in report.items()}
    import torch

    from chip_smoke import median_ms
    from deepdfa_tpu_torch.nn import flash_attention as fa

    B, H, T, D = 16, 12, 512, 64
    gen = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(torch.bfloat16).cuda()
                   for _ in range(4))
    bias = (torch.randn(H, T, T, generator=gen) * 2.0).to(torch.bfloat16).cuda()
    mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
    calls = {"plain": {}, "dropout": {"dropout_rate": 0.1, "seed": SEED},
             "bias": {"scale": 1.0, "bias": bias}, "causal": {"causal": True},
             "causal_bias": {"scale": 1.0, "bias": bias, "causal": True}}
    out = {}
    with torch.inference_mode():
        for name, kw in calls.items():
            o, lse = fa.flash_fwd(q, k, v, mask, **kw)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            dbias_kw = {k: v for k, v in kw.items() if k != "bias"}

            def grads():
                g = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                     *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
                if "bias" in kw:
                    g += (fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, **dbias_kw),)
                return g

            got, again = grads(), grads()
            rate = kw.get("dropout_rate", 0.0)
            bits = fa.dropout_bits(SEED, B, H, T, T, q.device) if rate else None
            want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, kw.get("scale"), rate, bits,
                                          kw.get("bias"), kw.get("causal", False))
            del bits
            err = {w: ((g.float() - r.float()).abs().max()
                       / r.float().abs().max().clamp_min(1e-6)).item()
                   for w, g, r in zip(("dq", "dk", "dv", "dbias"), got, want)}
            out[name] = {
                "dq_ms": median_ms(torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw)),
                "dkv_ms": median_ms(torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do,
                                                                **kw)),
                "err_of_scale": err,
                "repeat_equal": all(torch.equal(x, y) for x, y in zip(got, again))}
            if "bias" in kw:
                out[name]["dbias_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                    q, k, v, mask, lse, delta, do, bias, **dbias_kw))
    return out


def run_child(what: str, label: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--child", what, label], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layouts", nargs="*", choices=list(EDITS), default=list(EDITS))
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of another flash_attention.cu to time")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", nargs=2, metavar=("WHAT", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.child:
        print(json.dumps(child(*args.child)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    sources = {label: (SOURCE, EDITS[label]) for label in args.layouts}
    for spec in args.source:
        label, _, path = spec.partition("=")
        sources[label] = (Path(path).resolve(), ())
    write_sources(sources)
    labels = list(sources)
    t0 = time.perf_counter()
    builds = {label: run_child("build", label) for label in labels}
    ptxas = {label: result(proc, "build", label) for label, proc in builds.items()}
    build_s = time.perf_counter() - t0
    runs = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        runs[label].append(result(run_child("time", label), "time", label))
        print(json.dumps({label: {c: [r["dq_ms"], r["dkv_ms"]]
                                  for c, r in runs[label][-1].items()}}), flush=True)
    by_call = {}
    for label, (first, second) in runs.items():
        for name in first:
            by_call.setdefault(name, {})[label] = {
                **{f: (first[name][f] + second[name][f]) / 2 for f in ("dq_ms", "dkv_ms")},
                "medians": [[r[name]["dq_ms"], r[name]["dkv_ms"]] for r in (first, second)],
                "err_of_scale": {w: max(first[name]["err_of_scale"][w],
                                        second[name]["err_of_scale"][w])
                                 for w in first[name]["err_of_scale"]},
                "repeat_equal": first[name]["repeat_equal"] and second[name]["repeat_equal"]}
            if "dbias_ms" in first[name]:
                by_call[name][label]["dbias_ms"] = (first[name]["dbias_ms"]
                                                    + second[name]["dbias_ms"]) / 2
    total = sum(MAIN_PATH_LAUNCHES.values())
    weighted = {label: sum(n * (by_call[c][label]["dq_ms"] + by_call[c][label]["dkv_ms"])
                           for c, n in MAIN_PATH_LAUNCHES.items()) / total for label in labels}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    line = json.dumps({"card": smi, "build_seconds": build_s, "ptxas": ptxas,
                       "main_path_launches": MAIN_PATH_LAUNCHES,
                       "weighted_dq_plus_dkv_ms": weighted, "calls": by_call})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
