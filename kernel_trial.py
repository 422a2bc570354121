#!/usr/bin/env python3
"""Time layouts of the port's hand-written kernels against each other on
one CUDA card, from copies of their source that differ in a line or two.

    python3 kernel_trial.py fwd [--layouts LABEL ...] [--source LABEL=PATH ...] [--out FILE]
    python3 kernel_trial.py bwd [--layouts LABEL ...] [--source LABEL=PATH ...] [--out FILE]
    python3 kernel_trial.py dbias [--layouts LABEL ...] [--out FILE]
    python3 kernel_trial.py gru [--layouts LABEL ...] [--tree LABEL=PATH ...] [--out FILE]

Run from the root of a checkout on a machine with the card and the CUDA
toolkit. Each mode (TRIALS) names a source under deepdfa_tpu_torch/csrc,
its layouts (label: the edits, text and replacement, made to a copy of
it), the calls it times and the launches that weight them:

- fwd: kernel 5, the flash forward. rows64_warp16, rows128_warp16,
  rows128_warp32: every tensor-core instance at that many query rows a
  block and a warp (`FwdMmaLayout`; the source keeps 128 x 32 for the
  non-causal build at D <= 64, else 64 x 16); fma_one_block: the fp32 FMA
  forward at D 64 with no register cap, one block an SM. Called through
  `flash_fwd`: bf16 at the flagship attention call (B 16, H 12, T 512,
  D 64, every key live) plain, at dropout 0.1, with T5's bf16 [H, T, T]
  bias at scale 1.0, with the bias and dropout, causal, causal with the
  bias; fp32 at the generation path's three calls (B 16, H 12, D 64,
  scale 1.0: decoder T 128 causal with an fp32 bias, cross 128 x 256,
  encoder 256 with the bias). Beside each time, o's and lse's largest
  difference from `attention_plain` (the same Philox bits under dropout).
- bwd: kernels 6 and 7, the tensor-core dq and dk/dv. uncapped: neither
  kernel's registers capped (`BwdMmaLayout::kDqBlocks`, `kDkvBlocks` 1);
  dq_blocks3: dq capped for three blocks an SM; sub64_uncapped: a whole
  64-column tile scored at a time (`kDqSub`, `kDkvSub`); dq_rows128,
  dkv_keys128: 128-row dq or 128-key dk/dv blocks. Called through
  `flash_dq` and `flash_dkv` (and `flash_dbias` with the bias) at the
  flagship call: plain (scale 1/8), at dropout 0.1, with T5's bf16 bias
  at scale 1.0, causal, causal with the bias. Beside each time, each
  gradient's largest difference from `attention_bwd_plain` over its
  largest magnitude, and whether a repeat gave the same bits.
- dbias: kernel 8's FMA instance, the fp32 dbias (`flash_dbias_scalar`).
  dbias_no_split: each block over the whole batch (`kDbSplitBlocks` 0);
  dbias_split264, dbias_split1056: the batch cut for about 264 or 1056
  live blocks in place of 528; dbias_rows32, dbias_rows32_no_split:
  32-row tiles of 128 threads (`kDbRows`). Called at the generation
  paths' four fp32 calls (H 12, D 64, scale 1.0, an fp32 bias, every key
  live): train_gen's decoder (B 16, T 128, causal) and encoder (B 16,
  T 256), train_clone's encoder (B 32, T 256) and decoder (B 32, T 256,
  causal). Beside each time, dbias's largest difference from the plain
  one over its largest magnitude, repeat bits and the batch cut.
- gru: B3, the GGNN GRU backward (`ggnn_gru_bwd_f32`). w256, w1024: the
  weight pass's node chunks aimed at 256 or 1024 blocks
  (`kWTargetBlocks`) in place of 512; gates_uncapped, inputs_uncapped:
  the gate or the input pass without its register cap. Called through
  `gru_bwd` at the flagship batch (N 16384, d 128, seeded normal h and a,
  g at 1e-2, weights at d^-1/2, biases at 0.1). Beside each time, one
  call's device time by launch (`chip_smoke.launch_split`), each output's
  largest difference from `gru_bwd_plain` over its largest magnitude,
  whether every output is within the card gate (rtol 1e-4, atol 1e-5,
  scaled for the parameter cotangents), and repeat bits.

Every layout is a copy under build/deepdfa_tpu_torch/trial/MODE/LABEL/ (with
the headers beside the source); --layouts picks some (by default all,
`as_is` being the source unedited). --source adds another flash source,
unedited, with this tree's C interface (fwd, bwd); --tree adds another
checkout whose own package, wrapper and source, is timed as it is (gru:
an earlier tree whose B3 takes other arguments). Each build is
compiled by the package's `cuda_build.build`, every build in a process
of its own, all started together. Each is then loaded in a process of
its own; the processes run one at a time, forward then backward through
the builds (a, b, ..., b, a), each timing every call as the median of 20
CUDA-event windows behind a spin kernel (`chip_smoke.median_ms`: host
time is not counted), and a build's time is the mean of its two medians.
`weighted_ms` is the mean over the calls of the mode's `weights` (their
launches on the main paths of one chip_smoke.py run) of the timed
kernels' sum. Prints one JSON object with the card's name and power
limit and each build's ptxas registers and spills of the mode's
instances; --out writes it to a file too.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "deepdfa_tpu_torch" / "csrc"
FLASH_LIBS = ("flash_attention", "flash_attention_causal")
SEED = 20241017


def _line(name: str, value: int) -> str:
    return f"  static constexpr int {name} = {value};"


_ROWS = "  static constexpr int kRows = kWide ? 128 : 64;"
_WARP_ROWS = "  static constexpr int kWarpRows = kWide ? 32 : 16;"
_FMA_BOUNDS = "__launch_bounds__(kTileThreads, KS == 64 && sizeof(T) == 4 ? 2 : 1)\n" \
              "    flash_fwd_scalar"
_DQ_BLOCKS = "  static constexpr int kDqBlocks = D <= 64 ? 4 : 1;"
_DKV_BLOCKS = "  static constexpr int kDkvBlocks = D <= 64 && !kCausal ? 3 : 1;"
_UNCAP_DQ = (_DQ_BLOCKS, _line("kDqBlocks", 1))
_UNCAP_DKV = (_DKV_BLOCKS, _line("kDkvBlocks", 1))
_DB_SPLIT = "constexpr int kDbSplitBlocks = 528;"
_DB_ROWS = "constexpr int kDbRows = 64;"
_GATES = "__global__ void __launch_bounds__(kGateThreads, 2)\ngru_bwd_gates_kernel"
_INPUTS = "__global__ void __launch_bounds__(kInThreads, 2)\ngru_bwd_inputs_kernel"
_W_TARGET = "constexpr int kWTargetBlocks = 512;"

#: mode: source, libraries, ptxas prefixes reported, layouts (label: the
#: edits), the calls' weights (launches on the main paths of one
#: chip_smoke.py run) and the timed fields they weight. fwd: cs (combined
#: serving) plain, ct (combined training) dropout 0.1, 5s and 5t (T5
#: serving and training) bias; bwd: ct at dropout 0.1, 5t with the bias;
#: dbias: train_gen 20 steps x 12 at each of its calls, train_clone 8 x 12
TRIALS = {
    "fwd": {
        "source": "flash_attention.cu", "libs": FLASH_LIBS,
        "ptxas": ("flash_fwd_bf16_mma<64,", "flash_fwd_scalar<float, 64",
                  "flash_fwd_scalar<bf16, 64"),
        "layouts": {
            "as_is": (),
            **{f"rows{r}_warp{w}": ((_ROWS, f"  static constexpr int kRows = {r};"),
                                    (_WARP_ROWS, f"  static constexpr int kWarpRows = {w};"))
               for r, w in ((64, 16), (128, 16), (128, 32))},
            "fma_one_block": ((_FMA_BOUNDS, _FMA_BOUNDS.replace(
                "KS == 64 && sizeof(T) == 4 ? 2 : 1", "1")),),
        },
        "weights": {"flagship": 84, "flagship_dropout": 612, "flagship_bias": 696},
        "weighted": ("ms",),
    },
    "bwd": {
        "source": "flash_attention.cu", "libs": FLASH_LIBS,
        "ptxas": ("flash_dq_bf16_mma<64", "flash_dkv_bf16_mma<64"),
        "layouts": {
            "as_is": (),
            "uncapped": (_UNCAP_DQ, _UNCAP_DKV),
            "dq_blocks3": ((_DQ_BLOCKS, _DQ_BLOCKS.replace("? 4", "? 3")),),
            "sub64_uncapped": ((_line("kDqSub", 32), _line("kDqSub", 64)),
                               (_line("kDkvSub", 32), _line("kDkvSub", 64)), _UNCAP_DQ,
                               _UNCAP_DKV),
            "dq_rows128": ((_line("kDqRows", 64), _line("kDqRows", 128)), _UNCAP_DQ),
            "dkv_keys128": ((_line("kDkvKeys", 64), _line("kDkvKeys", 128)), _UNCAP_DKV),
        },
        "weights": {"dropout": 276, "bias": 276},
        "weighted": ("dq_ms", "dkv_ms"),
    },
    "dbias": {
        "source": "flash_attention.cu", "libs": FLASH_LIBS,
        "ptxas": ("flash_dbias_scalar",),
        "layouts": {
            "as_is": (),
            "dbias_no_split": ((_DB_SPLIT, _DB_SPLIT.replace("528", "0")),),
            "dbias_split264": ((_DB_SPLIT, _DB_SPLIT.replace("528", "264")),),
            "dbias_split1056": ((_DB_SPLIT, _DB_SPLIT.replace("528", "1056")),),
            "dbias_rows32": ((_DB_ROWS, _DB_ROWS.replace("64", "32")),),
            "dbias_rows32_no_split": ((_DB_ROWS, _DB_ROWS.replace("64", "32")),
                                      (_DB_SPLIT, _DB_SPLIT.replace("528", "0"))),
        },
        "weights": {"gen_decoder": 240, "gen_encoder": 240, "clone_encoder": 96,
                    "clone_decoder": 96},
        "weighted": ("ms",),
    },
    "gru": {
        "source": "ggnn_bwd.cu", "libs": ("ggnn_bwd",),
        "ptxas": ("gru_bwd", "reduce"),
        "layouts": {
            "as_is": (),
            "w256": ((_W_TARGET, _W_TARGET.replace("512", "256")),),
            "w1024": ((_W_TARGET, _W_TARGET.replace("512", "1024")),),
            "gates_uncapped": ((_GATES, _GATES.replace(", 2)", ")")),),
            "inputs_uncapped": ((_INPUTS, _INPUTS.replace(", 2)", ")")),),
        },
        "weights": {"flagship": 1},
        "weighted": ("ms",),
    },
}
#: the fp32 dbias calls of the dbias mode: (B, T, causal)
DBIAS_CALLS = {"gen_decoder": (16, 128, True), "gen_encoder": (16, 256, False),
               "clone_encoder": (32, 256, False), "clone_decoder": (32, 256, True)}
GRU_N, GRU_D = 16384, 128


def edited(mode: str, label: str, text: str) -> str:
    """`text` with the edits of `mode`'s layout `label`; each edit's text
    must occur exactly once."""
    for old, new in TRIALS[mode]["layouts"][label]:
        if text.count(old) != 1:
            raise ValueError(f"{mode} {label}: {old!r} is not in the source exactly once")
        text = text.replace(old, new)
    return text


def trial_dir(mode: str, label: str) -> Path:
    return ROOT / "build" / "deepdfa_tpu_torch" / "trial" / mode / label


def write_copy(mode: str, label: str, name: str, text: str, headers: Path) -> None:
    """A build's copy of the source `name`, with the headers of the
    directory `headers` beside it."""
    out = trial_dir(mode, label)
    out.mkdir(parents=True, exist_ok=True)
    (out / name).write_text(text)
    for h in headers.glob("*.cuh"):
        shutil.copy(h, out / h.name)


def smoke():
    """chip_smoke.py of this checkout (also for a --tree's package)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the calls of each mode, timed in a child process: {call: {field: value}}

def time_fwd(torch, cs) -> dict:
    from deepdfa_tpu_torch.nn import flash_attention as fa

    gen = torch.Generator().manual_seed(10)
    B, H, D = 16, 12, 64

    def qkv(Tq, Tk, dtype):
        q = torch.randn(B, H, Tq, D, generator=gen).to(dtype).cuda()
        k, v = (torch.randn(B, H, Tk, D, generator=gen).to(dtype).cuda() for _ in range(2))
        return q, k, v, torch.ones(B, Tk, dtype=torch.bool, device="cuda")

    flag = qkv(512, 512, torch.bfloat16)
    bias = (torch.randn(H, 512, 512, generator=gen) * 2.0).to(torch.bfloat16).cuda()
    drop = {"dropout_rate": 0.1, "seed": SEED}
    calls = {"flagship": (*flag, {}), "flagship_dropout": (*flag, drop),
             "flagship_bias": (*flag, {"scale": 1.0, "bias": bias}),
             "flagship_bias_dropout": (*flag, {"scale": 1.0, "bias": bias, **drop}),
             "flagship_causal": (*flag, {"causal": True}),
             "flagship_causal_bias": (*flag, {"scale": 1.0, "bias": bias, "causal": True})}
    for name, Tq, Tk, biased, causal in (("gen_decoder_t128", 128, 128, True, True),
                                         ("gen_cross_t128x256", 128, 256, False, False),
                                         ("gen_encoder_t256", 256, 256, True, False)):
        args = qkv(Tq, Tk, torch.float32)
        b = torch.randn(H, Tq, Tk, generator=gen).cuda() if biased else None
        calls[name] = (*args, {"scale": 1.0, "bias": b, "causal": causal})
    out = {}
    with torch.inference_mode():
        for name, (q, k, v, mask, kw) in calls.items():
            o, lse = fa.flash_fwd(q, k, v, mask, **kw)
            rate = kw.get("dropout_rate", 0.0)
            bits = fa.dropout_bits(SEED, *q.shape[:3], k.shape[2], q.device) if rate else None
            po, plse = fa.attention_plain(q, k, v, mask, kw.get("scale"), rate, bits,
                                          kw.get("bias"), kw.get("causal", False))
            del bits
            out[name] = {"ms": cs.median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, **kw)),
                         "o_err": (o.float() - po.float()).abs().max().item(),
                         "lse_err": (lse - plse).abs().max().item()}
    return out


def time_bwd(torch, cs) -> dict:
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
            out[name] = {
                "dq_ms": cs.median_ms(torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do,
                                                                 **kw)),
                "dkv_ms": cs.median_ms(torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do,
                                                                   **kw)),
                "err_of_scale": {w: ((g.float() - r.float()).abs().max()
                                     / r.float().abs().max().clamp_min(1e-6)).item()
                                 for w, g, r in zip(("dq", "dk", "dv", "dbias"), got, want)},
                "repeat_equal": all(torch.equal(x, y) for x, y in zip(got, again))}
            if "bias" in kw:
                out[name]["dbias_ms"] = cs.median_ms(torch, lambda: fa.flash_dbias(
                    q, k, v, mask, lse, delta, do, bias, **dbias_kw))
    return out


def time_dbias(torch, cs) -> dict:
    from deepdfa_tpu_torch.nn import flash_attention as fa

    H, D = 12, 64
    gen = torch.Generator().manual_seed(13)
    out = {}
    with torch.inference_mode():
        for name, (B, T, causal) in DBIAS_CALLS.items():
            q, k, v, do = (torch.randn(B, H, T, D, generator=gen).cuda() for _ in range(4))
            bias = (torch.randn(H, T, T, generator=gen) * 2.0).cuda()
            mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
            kw = {"scale": 1.0, "causal": causal}
            o, lse = fa.flash_fwd(q, k, v, mask, bias=bias, **kw)
            delta = (do * o).sum(-1, keepdim=True)
            got, again = (fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, **kw)
                          for _ in range(2))
            want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, bias=bias,
                                          causal=causal)[3]
            out[name] = {
                "ms": cs.median_ms(torch, lambda: fa.flash_dbias(q, k, v, mask, lse, delta, do,
                                                                 bias, **kw)),
                "err_of_scale": ((got - want).abs().max() / want.abs().max()).item(),
                "repeat_equal": torch.equal(got, again),
                "cut": cs.dbias_cut(fa, B, H, T, T, causal)}
            del q, k, v, do, bias, o, lse, delta, got, again, want
    return out


def time_gru(torch, cs) -> dict:
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    h, a = (torch.randn(GRU_N, GRU_D, generator=gen).cuda() for _ in range(2))
    g = (torch.randn(GRU_N, GRU_D, generator=gen) * 1e-2).cuda()
    s = GRU_D ** -0.5
    wih, whh = ((torch.randn(GRU_D, 3 * GRU_D, generator=gen) * s).cuda() for _ in range(2))
    bih, bhh = ((torch.randn(3 * GRU_D, generator=gen) * 0.1).cuda() for _ in range(2))
    args = (h, a, wih, whh, bih, bhh, g)
    with torch.inference_mode():
        got, again = gk.gru_bwd(*args), gk.gru_bwd(*args)
        want = gk.gru_bwd_plain(*args)
        torch.cuda.synchronize()
        err, within = {}, True
        for name, x, y in zip(("da", "dh", "dwih", "dwhh", "dbih", "dbhh"), got, want):
            scale = y.abs().max().item()
            err[name] = (x - y).abs().max().item() / max(scale, 1e-30)
            atol = cs.ATOL * max(1.0, scale) if name[:2] in ("dw", "db") else cs.ATOL
            within &= bool(torch.allclose(x, y, rtol=cs.RTOL, atol=atol))
        return {"flagship": {
            "ms": cs.median_ms(torch, lambda: gk.gru_bwd(*args)),
            "launch_split": cs.launch_split(torch, lambda: gk.gru_bwd(*args)),
            "err_of_scale": err, "within_gate": within,
            "repeat_equal": all(torch.equal(x, y) for x, y in zip(got, again))}}


TIMERS = {"fwd": time_fwd, "bwd": time_bwd, "dbias": time_dbias, "gru": time_gru}


def child(mode: str, what: str, label: str, tree: str | None) -> dict:
    """In a process of its own, the package pointed at `label`'s copy (or
    a --tree's package as it is): build the mode's libraries and return
    ptxas's report of its instances, or time its calls."""
    if tree:
        sys.path.insert(0, tree)
    from deepdfa_tpu_torch.nn import cuda_build

    if not tree:
        cuda_build.CSRC_DIR = trial_dir(mode, label)
    cs = smoke()
    trial = TRIALS[mode]
    if what == "build":
        report = cuda_build.build(trial["libs"])
        return {lib: {k: v for k, v in cs.ptxas_summary(r["log"]).items()
                      if k.startswith(trial["ptxas"])} for lib, r in report.items()}
    import torch

    return TIMERS[mode](torch, cs)


def run_child(mode: str, what: str, label: str, tree: str | None) -> subprocess.Popen:
    cmd = [sys.executable, __file__, mode, "--child", what, label]
    return subprocess.Popen(cmd + (["--tree-path", tree] if tree else []), cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def result(proc: subprocess.Popen, what: str, label: str) -> dict:
    stdout, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"{what} of {label} failed (exit {proc.returncode})")
    return json.loads(stdout.strip().splitlines()[-1])


def merge(first, second, key: str = ""):
    """One build's two runs of a call: times (`ms`, `*_ms`) as their mean
    beside both medians, errors (`*err*`) their larger, flags both, the
    rest (the batch cut, the launch split) the first run's."""
    if isinstance(first, dict) and "err" in key:
        return {k: merge(first[k], second[k], key) for k in first}
    if isinstance(first, bool):
        return first and second
    if key == "ms" or key.endswith("_ms"):
        return (first + second) / 2
    if "err" in key:
        return max(first, second)
    return first


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=list(TRIALS))
    ap.add_argument("--layouts", nargs="*")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of another flash_attention.cu to time (fwd, bwd)")
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of another checkout whose package to time (gru)")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", nargs=2, metavar=("WHAT", "LABEL"), help=argparse.SUPPRESS)
    ap.add_argument("--tree-path", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.child:
        print(json.dumps(child(args.mode, *args.child, args.tree_path)))
        return
    trial = TRIALS[args.mode]
    layouts = trial["layouts"] if args.layouts is None else args.layouts
    unknown = set(layouts) - set(trial["layouts"])
    if unknown:
        sys.exit(f"{args.mode} has no layouts {sorted(unknown)}: {list(trial['layouts'])}")
    if args.source and args.mode not in ("fwd", "bwd"):
        sys.exit("--source applies to fwd and bwd: an earlier tree's other kernels take "
                 "other arguments")
    if args.tree and args.mode != "gru":
        sys.exit("--tree applies to gru")
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    name = trial["source"]
    trees = {}
    for label in layouts:
        write_copy(args.mode, label, name, edited(args.mode, label, (CSRC / name).read_text()),
                   CSRC)
        trees[label] = None
    for spec in args.source:
        label, _, path = spec.partition("=")
        path = Path(path).resolve()
        write_copy(args.mode, label, name, path.read_text(), path.parent)
        trees[label] = None
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees[label] = str(Path(path).resolve())
    labels = list(trees)
    t0 = time.perf_counter()
    builds = {label: run_child(args.mode, "build", label, trees[label]) for label in labels}
    ptxas = {label: result(proc, "build", label) for label, proc in builds.items()}
    build_s = time.perf_counter() - t0
    runs = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        runs[label].append(result(run_child(args.mode, "time", label, trees[label]), "time",
                                  label))
        print(json.dumps({label: {c: {k: v for k, v in r.items() if k.endswith("ms")}
                                  for c, r in runs[label][-1].items()}}), flush=True)
    calls = {label: {c: {**{k: merge(first[c][k], second[c][k], k) for k in first[c]},
                         "medians": [{k: r[c][k] for k in first[c] if k.endswith("ms")}
                                     for r in (first, second)]}
                     for c in first}
             for label, (first, second) in runs.items()}
    weights = trial["weights"]
    weighted = {label: sum(n * sum(calls[label][c][f] for f in trial["weighted"])
                           for c, n in weights.items()) / sum(weights.values())
                for label in labels}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    line = json.dumps({"card": smi, "mode": args.mode, "build_seconds": build_s, "ptxas": ptxas,
                       "weights": weights, "weighted_fields": trial["weighted"],
                       "weighted_ms": weighted, "calls": calls})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
