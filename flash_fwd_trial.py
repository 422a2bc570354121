#!/usr/bin/env python3
"""Time tile layouts of kernel 5, the flash forward, against each other
on one CUDA card, from copies of its source that differ in one line.

    python3 flash_fwd_trial.py [--source LABEL=PATH ...] [--out FILE]

Run from the root of a checkout on a machine with the card and the CUDA
toolkit. The builds are copies of deepdfa_tpu_torch/csrc/flash_attention.cu
under build/deepdfa_tpu_torch/trial/LABEL/, each with one edit:

- rows64_warp16, rows128_warp16, rows128_warp32: every tensor-core
  instance at that many query rows a block and a warp (`FwdMmaLayout`;
  the source keeps 128 x 32 for the non-causal build at D <= 64, else
  64 x 16);
- fma_one_block: the fp32 FMA forward at D 64 launched with no register
  cap, one block an SM, in place of 128 registers and two;

and each --source unedited (an earlier tree's source). Each build's two
libraries (non-causal and causal) are compiled by the package's
`cuda_build.build`, every build in a process of its own, all started
together. Each build is then loaded in a process of its own (the package
pointed at its copy through `cuda_build.CSRC_DIR`) and called through
`flash_fwd`: bf16 at the flagship attention call (B 16, H 12, T 512,
D 64, every key live) plain, at dropout 0.1, with T5's bf16 [H, T, T]
bias at scale 1.0, with the bias and dropout 0.1, causal, and causal
with the bias; fp32 at the generation path's three calls (B 16, H 12,
D 64, scale 1.0: decoder T 128 causal with an fp32 bias, cross
128 x 256, encoder 256 with the bias). The processes run one at a time,
forward then backward through the builds (a, b, ..., b, a); each times
every call as the median of 20 CUDA-event windows behind a spin kernel
(`chip_smoke.median_ms`: host time is not counted), and a build's time
is the mean of its two medians. Beside each time, the largest
difference of o and of lse from `attention_plain` on the same inputs
(with the same Philox bits under dropout), and for the non-causal
flagship calls the mean weighted by their launches on the main paths
(MAIN_PATH_LAUNCHES). Prints one JSON object with the card's name and
power limit and each build's ptxas registers and spills of its D 64
forward instances; --out writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "deepdfa_tpu_torch" / "csrc" / "flash_attention.cu"
LIBS = ("flash_attention", "flash_attention_causal")

_ROWS = "  static constexpr int kRows = kWide ? 128 : 64;"
_WARP_ROWS = "  static constexpr int kWarpRows = kWide ? 32 : 16;"
_FMA_BOUNDS = "__launch_bounds__(kTileThreads, KS == 64 && sizeof(T) == 4 ? 2 : 1)\n" \
              "    flash_fwd_scalar"
#: label: the edits (text, replacement) made to the source
EDITS = {
    **{f"rows{r}_warp{w}": ((_ROWS, f"  static constexpr int kRows = {r};"),
                            (_WARP_ROWS, f"  static constexpr int kWarpRows = {w};"))
       for r, w in ((64, 16), (128, 16), (128, 32))},
    "fma_one_block": ((_FMA_BOUNDS, _FMA_BOUNDS.replace(
        "KS == 64 && sizeof(T) == 4 ? 2 : 1", "1")),),
}
#: launches of the tensor-core forward on the main paths of one
#: chip_smoke.py run, by call mix: cs (combined serving) plain, ct
#: (combined training) dropout 0.1, 5s and 5t (T5 serving and training)
#: bias; T5 has no attention-probs dropout (models/t5.py), so no main
#: path runs bias with dropout
MAIN_PATH_LAUNCHES = {"flagship": 84, "flagship_dropout": 612, "flagship_bias": 696}
SEED = 20241017


def trial_dir(label: str) -> Path:
    from deepdfa_tpu_torch.nn import cuda_build

    return cuda_build.BUILD_DIR / "trial" / label


def write_sources(sources: dict) -> None:
    """Each build's copy of the source, edited."""
    for label, (src, edits) in sources.items():
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"{label}: {old!r} is not in {src} exactly once")
            text = text.replace(old, new)
        out = trial_dir(label) / "flash_attention.cu"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)


def child(what: str, label: str) -> dict:
    """In a process of its own, the package pointed at `label`'s copy:
    build both libraries and return ptxas's report of the D 64
    forward instances, or time the calls."""
    from deepdfa_tpu_torch.nn import cuda_build

    cuda_build.CSRC_DIR = trial_dir(label)
    if what == "build":
        from chip_smoke import ptxas_summary

        report = cuda_build.build(LIBS)
        return {lib: {k: v for k, v in ptxas_summary(r["log"]).items()
                      if k.startswith(("flash_fwd_bf16_mma<64,", "flash_fwd_scalar<float, 64",
                                       "flash_fwd_scalar<bf16, 64"))}
                for lib, r in report.items()}
    import torch

    from chip_smoke import median_ms
    from deepdfa_tpu_torch.nn import flash_attention as fa

    out = {}
    with torch.inference_mode():
        for name, (q, k, v, mask, kw) in calls(torch).items():
            o, lse = fa.flash_fwd(q, k, v, mask, **kw)
            rate = kw.get("dropout_rate", 0.0)
            bits = fa.dropout_bits(SEED, *q.shape[:3], k.shape[2], q.device) if rate else None
            po, plse = fa.attention_plain(q, k, v, mask, kw.get("scale"), rate, bits,
                                          kw.get("bias"), kw.get("causal", False))
            del bits
            out[name] = {"ms": median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, **kw)),
                         "o_err": (o.float() - po.float()).abs().max().item(),
                         "lse_err": (lse - plse).abs().max().item()}
    return out


def calls(torch) -> dict:
    """name: (q, k, v, mask, flash_fwd keywords), the same on every
    build."""
    gen = torch.Generator().manual_seed(10)
    out = {}
    B, H, D = 16, 12, 64

    def qkv(Tq, Tk, dtype):
        q = torch.randn(B, H, Tq, D, generator=gen).to(dtype).cuda()
        k, v = (torch.randn(B, H, Tk, D, generator=gen).to(dtype).cuda() for _ in range(2))
        return q, k, v, torch.ones(B, Tk, dtype=torch.bool, device="cuda")

    flag = qkv(512, 512, torch.bfloat16)
    bias = (torch.randn(H, 512, 512, generator=gen) * 2.0).to(torch.bfloat16).cuda()
    drop = {"dropout_rate": 0.1, "seed": SEED}
    out["flagship"] = (*flag, {})
    out["flagship_dropout"] = (*flag, drop)
    out["flagship_bias"] = (*flag, {"scale": 1.0, "bias": bias})
    out["flagship_bias_dropout"] = (*flag, {"scale": 1.0, "bias": bias, **drop})
    out["flagship_causal"] = (*flag, {"causal": True})
    out["flagship_causal_bias"] = (*flag, {"scale": 1.0, "bias": bias, "causal": True})
    for name, Tq, Tk, biased, causal in (("gen_decoder_t128", 128, 128, True, True),
                                         ("gen_cross_t128x256", 128, 256, False, False),
                                         ("gen_encoder_t256", 256, 256, True, False)):
        args = qkv(Tq, Tk, torch.float32)
        b = torch.randn(H, Tq, Tk, generator=gen).cuda() if biased else None
        out[name] = (*args, {"scale": 1.0, "bias": b, "causal": causal})
    return out


def run_child(what: str, label: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--child", what, label], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def result(proc: subprocess.Popen, what: str, label: str) -> dict:
    stdout, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"{what} of {label} failed (exit {proc.returncode})")
    return json.loads(stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    sources = {label: (SOURCE, edits) for label, edits in EDITS.items()}
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
        print(json.dumps({label: {c: r["ms"] for c, r in runs[label][-1].items()}}), flush=True)
    by_call = {}
    for label, (first, second) in runs.items():
        for name in first:
            by_call.setdefault(name, {})[label] = {
                "ms": (first[name]["ms"] + second[name]["ms"]) / 2,
                "medians": [first[name]["ms"], second[name]["ms"]],
                "o_err": max(first[name]["o_err"], second[name]["o_err"]),
                "lse_err": max(first[name]["lse_err"], second[name]["lse_err"])}
    total = sum(MAIN_PATH_LAUNCHES.values())
    weighted = {label: sum(n * by_call[c][label]["ms"] for c, n in MAIN_PATH_LAUNCHES.items())
                / total for label in labels}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    line = json.dumps({"card": smi, "build_seconds": build_s, "ptxas": ptxas,
                       "main_path_launches": MAIN_PATH_LAUNCHES,
                       "weighted_noncausal_ms": weighted, "calls": by_call})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
