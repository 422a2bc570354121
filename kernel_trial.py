#!/usr/bin/env python3
"""Time layouts of the port's hand-written kernels against each other on
one CUDA card, from copies of their source that differ in a line or two.

    python3 kernel_trial.py fwd [--layouts LABEL ...] [--source LABEL=PATH ...] [--out FILE]
    python3 kernel_trial.py bwd [--layouts LABEL ...] [--source LABEL=PATH ...] [--out FILE]
    python3 kernel_trial.py dbias [--layouts LABEL ...] [--out FILE]
    python3 kernel_trial.py dbias_mma [--layouts LABEL ...] [--out FILE]
    python3 kernel_trial.py dmsg [--layouts LABEL ...] [--tree LABEL=PATH ...] [--out FILE]
    python3 kernel_trial.py gru [--layouts LABEL ...] [--tree LABEL=PATH ...] [--out FILE]
    python3 kernel_trial.py step [--layouts LABEL ...] [--tree LABEL=PATH ...] [--out FILE]

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
- dbias_mma: kernel 8's tensor-core instance, the bf16 dbias
  (`flash_dbias_bf16_mma`, `DbiasMmaLayout`; the source keeps 64 x 64
  blocks of 8 warps of 16 rows x 32 keys and cuts the batch for about
  528 live blocks). split264, no_split: the cut aimed at 264 blocks, or
  none (`kDbMmaSplitBlocks`); rows128, keys128: 128-row or 128-key blocks
  of 16 warps at D <= 64; wk64 (and _sub64): warps of 64 keys (scored 32
  or 64 at a time, `kSub`); rows128_wk64_split264: 128 x 64 blocks of 8
  such warps, the cut at 264; rows128_keys128_wk64: 128 x 128 blocks of
  16 such warps.
  Called through `flash_dbias` at the T5 training path's three buckets
  (H 12, D 64, a bf16 bias, scale 1.0, every key live, token budget
  8192: B 64 at T 128, 32 at 256, 16 at 512), and at T 512 at dropout
  0.1 and causal (timed, not weighted: no main path runs them). Beside
  each time, dbias's largest difference from the plain one over its
  largest magnitude, repeat bits and the batch cut.
- dmsg: B4, the GGNN transposed message (`ggnn_dmsg_f32`). tn4: a
  thread's product micro-tile 4 nodes x 4 columns (64-column panels) in
  place of 8 x 4 (`kMsgTN`); k64: 64 k a ring unit in place of 32
  (`kMsgK`); tn4_k64: both; uncapped: no register cap of two blocks an
  SM. Called through `dmsg` at the flagship batch (N 16384, E 65536, d
  128, T 1; seeded normal da at 1e-2, Wm at d^-1/2) and at a hub batch
  (the same sizes, a quarter of the edges leaving one node; timed, not
  weighted): `ms` is step_bwd's call, B4 added into B3's dh (for a
  --tree whose `dmsg` takes no dh, B4 alone plus the separate add that
  step_bwd made), `fresh_ms` B4 alone. Beside each time, the largest
  difference from `dmsg_plain` over its largest magnitude, whether it is
  within the card gate (rtol 1e-4, atol 1e-5) and repeat bits; the
  flagship call's device time split by launch. `--tree parent=<an
  earlier checkout>` times that tree's B4 (an earlier design's own
  wrapper and kernels) in the same call.
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
- step: kernels 1 and 2, the GGNN forward step (`ggnn_step_kernel`,
  `ggnn_fused_kernel`). gru_4x4, gru_16x1: a thread's micro-tile of a
  GRU product 4 nodes x 4 columns or 16 x 1 (3 gates) in place of 8 x 2
  (`kGruCols`); gru_k4: a and h read 4 k a load in place of 2
  (`kGruK`); ring3: a three-stage GRU weight ring in place of
  two (`kRing`); int8_fma: the int8 mxu messages as fp32 FMA chains in
  place of the integer tensor cores (`kImmaMessages`); uncapped: no
  register cap of two blocks an SM (`min_blocks`); inline: the step body
  inlined into both kernels (`step_tile` not `__noinline__`). At the flagship batch
  (N 16384, E 65536, d 128; seeded normal h, weights at d^-1/2, biases
  at 0.1), kernel 1 timed under fp32, bf16 and int8 fold and fp32 and
  int8 mxu (edge block 512), kernel 2 for 5 steps under fp32 fold and
  int8 mxu; int8 mxu also split by launch (the quantizing table, the
  pre-pass, the step). At that batch and a 3-edge-type one, every
  instance (fp32, bf16, int8 x fold, mxu) of kernel 1 (h', a) and of
  kernel 2 (h_out and the chain of 5 steps) is hashed: `bits_equal`
  says, for each build, whether each hash equals the `parent` tree's
  (or the first build's) and its own second run's; kernel 1's h' is also
  held to its plain version at the card gate (rtol 1e-4, atol 1e-5). The
  build report adds, per build, the SASS functions that hold IMMA
  instructions (cuobjdump) and how many.

Every layout is a copy under build/deepdfa_tpu_torch/trial/MODE/LABEL/ (with
the headers beside the source); --layouts picks some (by default all,
`as_is` being the source unedited). --source adds another flash source,
unedited, with this tree's C interface (fwd, bwd); --tree adds another
checkout whose own package, wrapper and source, is timed as it is (gru,
step, dmsg: an earlier tree whose kernels take other arguments). Each build is
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
_DBM_ROWS = "  static constexpr int kRows = 64;"
_DBM_ROWS128 = (_DBM_ROWS, "  static constexpr int kRows = D <= 64 ? 128 : 64;")
_DBM_KEYS = "  static constexpr int kKeys = 64;"
_DBM_SUB = "  static constexpr int kSub = 32;"
_DBM_WK = "  static constexpr int kWarpKeys = 32;"
_DBM_WK64 = (_DBM_WK, _DBM_WK.replace("32", "64"))
_DBM_KEYS128 = (_DBM_KEYS, "  static constexpr int kKeys = D <= 64 ? 128 : 64;")
_DBM_SPLIT = "constexpr int kDbMmaSplitBlocks = 528;"
_MSG_TN = "constexpr int kMsgTN = 8;"
_MSG_K = "constexpr int kMsgK = 32;"
_MSG_BOUNDS = "__global__ void __launch_bounds__(kMsgThreads, 2)\ndmsg_kernel"
_COLS = "constexpr int kGruCols = 2;"
_GRU_K = "constexpr int kGruK = 2;"
_RING = "constexpr int kRing = 2;"
_IMMA = "constexpr bool kImmaMessages = true;"
_STEP_TILE = "__device__ __noinline__ void step_tile("
_MIN_BLOCKS = ("constexpr int min_blocks(int d) { return 2 * (smem_bytes(d) + 1024) <= 228 * 1024 "
               "? 2 : 1; }")

#: mode: source, libraries, ptxas prefixes reported, layouts (label: the
#: edits), the calls' weights (launches on the main paths of one
#: chip_smoke.py run) and the timed fields they weight. fwd: cs (combined
#: serving) plain, ct (combined training) dropout 0.1, 5s and 5t (T5
#: serving and training) bias; bwd: ct at dropout 0.1, 5t with the bias;
#: dbias: train_gen 20 steps x 12 at each of its calls, train_clone 8 x 12;
#: dbias_mma: train_t5's 12 a step at each bucket (6 steps at T 128 and at
#: T 256, 11 at T 512, warm-up included); dmsg: B4's launches on the main
#: paths; step: each instance's launches on the main paths (PERF.md,
#: kernel table)
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
    "dbias_mma": {
        "source": "flash_attention.cu", "libs": FLASH_LIBS,
        "ptxas": ("flash_dbias_bf16_mma<64",),
        "layouts": {
            "as_is": (),
            "split264": ((_DBM_SPLIT, _DBM_SPLIT.replace("528", "264")),),
            "no_split": ((_DBM_SPLIT, _DBM_SPLIT.replace("528", "0")),),
            "rows128": (_DBM_ROWS128,),
            "keys128": (_DBM_KEYS128,),
            "wk64": (_DBM_WK64,),
            "wk64_sub64": (_DBM_WK64, (_DBM_SUB, _DBM_SUB.replace("32", "64"))),
            "rows128_wk64_split264": (_DBM_ROWS128, _DBM_WK64,
                                      (_DBM_SPLIT, _DBM_SPLIT.replace("528", "264"))),
            "rows128_keys128_wk64": (_DBM_ROWS128, _DBM_KEYS128, _DBM_WK64),
        },
        "weights": {"t128": 72, "t256": 72, "t512": 132},
        "weighted": ("ms",),
    },
    "dmsg": {
        "source": "ggnn_bwd.cu", "libs": ("ggnn_bwd",),
        "ptxas": ("dmsg",),
        "layouts": {
            "as_is": (),
            "tn4": ((_MSG_TN, _MSG_TN.replace("8;", "4;")),),
            "k64": ((_MSG_K, _MSG_K.replace("32;", "64;")),),
            "tn4_k64": ((_MSG_TN, _MSG_TN.replace("8;", "4;")),
                        (_MSG_K, _MSG_K.replace("32;", "64;"))),
            "uncapped": ((_MSG_BOUNDS, _MSG_BOUNDS.replace(", 2)", ")")),),
        },
        "weights": {"flagship": 650},
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
    "step": {
        "source": "ggnn_step.cu", "libs": ("ggnn_step",),
        "ptxas": ("ggnn_step_kernel<128,", "ggnn_fused_kernel<128,", "step_tile<128,",
                  "mxu_colmax_kernel<128>", "mxu_colmax_warp<128"),
        "layouts": {
            "as_is": (),
            "gru_4x4": ((_COLS, _COLS.replace("2;", "4;")),),
            "gru_16x1": ((_COLS, _COLS.replace("2;", "1;")),),
            "gru_k4": ((_GRU_K, _GRU_K.replace("2;", "4;")),),
            "ring3": ((_RING, _RING.replace("2;", "3;")),),
            "int8_fma": ((_IMMA, _IMMA.replace("true", "false")),),
            "uncapped": ((_MIN_BLOCKS, "constexpr int min_blocks(int) { return 1; }"),),
            "inline": ((_STEP_TILE, _STEP_TILE.replace("__noinline__", "__forceinline__")),),
        },
        "weights": {"step_fold_fp32": 650, "step_fold_bf16": 200, "step_fold_int8": 75,
                    "step_mxu_fp32": 135, "step_mxu_int8": 260, "fused_fold_fp32": 65,
                    "fused_mxu_int8": 59},
        "weighted": ("ms",),
    },
}
#: the fp32 dbias calls of the dbias mode: (B, T, causal)
DBIAS_CALLS = {"gen_decoder": (16, 128, True), "gen_encoder": (16, 256, False),
               "clone_encoder": (32, 256, False), "clone_decoder": (32, 256, True)}
#: the bf16 dbias calls of the dbias_mma mode: (B, T, dropout rate, causal)
DBIAS_MMA_CALLS = {"t128": (64, 128, 0.0, False), "t256": (32, 256, 0.0, False),
                   "t512": (16, 512, 0.0, False), "t512_dropout": (16, 512, 0.1, False),
                   "t512_causal": (16, 512, 0.0, True)}
#: the dmsg mode's batches (N, E, d) and the hub batch's share of edges
#: leaving one node
MSG_N, MSG_E, MSG_D, MSG_HUB = 16384, 65536, 128, 0.25
GRU_N, GRU_D = 16384, 128
#: the step mode's batch and edge block; its timed kernel-1 instances
#: (scatter, policy) and kernel-2 ones, 5 steps
STEP_N, STEP_E, STEP_BLOCK, STEP_STEPS = 16384, 65536, 512, 5
STEP_TIMED = (("fold", "fp32"), ("fold", "bf16"), ("fold", "int8"), ("mxu", "fp32"),
              ("mxu", "int8"))
FUSED_TIMED = (("fold", "fp32"), ("mxu", "int8"))


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


def time_dbias_mma(torch, cs) -> dict:
    from deepdfa_tpu_torch.nn import flash_attention as fa

    H, D = 12, 64
    gen = torch.Generator().manual_seed(15)
    out = {}
    with torch.inference_mode():
        for name, (B, T, rate, causal) in DBIAS_MMA_CALLS.items():
            q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(torch.bfloat16).cuda()
                           for _ in range(4))
            bias = (torch.randn(H, T, T, generator=gen) * 2.0).to(torch.bfloat16).cuda()
            mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
            kw = {"scale": 1.0, "causal": causal, "dropout_rate": rate, "seed": SEED}
            o, lse = fa.flash_fwd(q, k, v, mask, bias=bias, **kw)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            got, again = (fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, **kw)
                          for _ in range(2))
            bits = fa.dropout_bits(SEED, B, H, T, T, q.device) if rate else None
            want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, rate, bits, bias,
                                          causal)[3]
            del bits
            out[name] = {
                "ms": cs.median_ms(torch, lambda: fa.flash_dbias(q, k, v, mask, lse, delta, do,
                                                                 bias, **kw)),
                "err_of_scale": ((got - want).abs().max() / want.abs().max()).item(),
                "repeat_equal": torch.equal(got, again),
                "cut": cs.dbias_cut(fa, B, H, T, T, causal, D, mma=True)}
            del q, k, v, do, bias, o, lse, delta, got, again, want
    return out


def msg_batches(torch, gk, cs, rng) -> dict:
    """{name: EdgeIndex} of the dmsg mode: the flagship batch of
    `chip_smoke.full_batch` and a hub batch of the same sizes, every edge
    live and dst-sorted, MSG_HUB of them leaving node 7."""
    b = cs.full_batch(rng, MSG_N, MSG_E, 1).to("cuda")
    out = {"flagship": gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, None, MSG_N, 1,
                                        transpose=True)}
    src = rng.integers(0, MSG_N, MSG_E)
    src[rng.random(MSG_E) < MSG_HUB] = 7
    dst = torch.from_numpy(rng.integers(0, MSG_N, MSG_E)).sort().values.to(torch.int32)
    out["hub"] = gk.prepare_edges(torch.from_numpy(src).to(torch.int32).cuda(), dst.cuda(),
                                  torch.ones(MSG_E, dtype=torch.bool, device="cuda"), None,
                                  MSG_N, 1, transpose=True)
    return out


def time_dmsg(torch, cs) -> dict:
    import inspect

    import numpy as np

    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(16)
    da = (torch.randn(MSG_N, MSG_D, generator=gen) * 1e-2).cuda()
    dh0 = (torch.randn(MSG_N, MSG_D, generator=gen) * 1e-2).cuda()
    wm = (torch.randn(1, MSG_D, MSG_D, generator=gen) * MSG_D ** -0.5).cuda()
    into_dh = "dh" in inspect.signature(gk.dmsg).parameters
    out = {}
    with torch.inference_mode():
        for name, edges in msg_batches(torch, gk, cs, rng).items():
            if into_dh:
                def call(dh):
                    return gk.dmsg(da, edges, wm, dh)
            else:  # an earlier tree: B4, then step_bwd's separate add
                def call(dh):
                    return dh + gk.dmsg(da, edges, wm)
            got, again = call(dh0.clone()), call(dh0.clone())
            want = gk.dmsg_plain(da, edges, wm) + dh0
            dh = dh0.clone()
            out[name] = {
                "ms": cs.median_ms(torch, lambda: call(dh)),
                "fresh_ms": cs.median_ms(torch, lambda: gk.dmsg(da, edges, wm)),
                "err_of_scale": ((got - want).abs().max() / want.abs().max()).item(),
                "within_gate": bool(torch.allclose(got, want, rtol=cs.RTOL, atol=cs.ATOL)),
                "repeat_equal": torch.equal(got, again)}
            if name == "flagship":
                out[name]["launch_split"] = cs.launch_split(torch, lambda: call(dh))
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


def time_step(torch, cs) -> dict:
    import hashlib

    import numpy as np

    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    def digest(*xs) -> str:
        h = hashlib.sha256()
        for x in xs:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(14)
    out = {}
    with torch.inference_mode():
        for batch, t in (("flagship", 1), ("etypes3", 3)):
            _, edges, h, params = cs.ggnn_case(torch, gen, cs.full_batch(rng, STEP_N, STEP_E, t), t)
            for scatter in ("fold", "mxu"):
                for accum in ("fp32", "bf16", "int8"):
                    kw = {"accum": accum, "scatter": scatter,
                          "block_e": STEP_BLOCK if scatter == "mxu" else 0}
                    h1, a1 = gk.ggnn_step(h, edges, *params, with_aggregate=True, **kw)
                    hf, chain = gk.ggnn_fused(h, edges, *params, n_steps=STEP_STEPS,
                                              with_chain=True, **kw)
                    want, _ = gk.ggnn_step_plain(h, edges, *params, accum, scatter,
                                                 kw["block_e"])
                    out[f"{batch}_{scatter}_{accum}"] = {
                        "step_digest": digest(h1, a1), "fused_digest": digest(hf, chain),
                        "step_err": (h1 - want).abs().max().item(),
                        "within_gate": bool(torch.allclose(h1, want, rtol=cs.RTOL,
                                                           atol=cs.ATOL))}
                    del h1, a1, hf, chain, want
                    if batch != "flagship":
                        continue
                    if (scatter, accum) in STEP_TIMED:
                        out[f"step_{scatter}_{accum}"] = {"ms": cs.median_ms(
                            torch, lambda: gk.ggnn_step(h, edges, *params, **kw))}
                    if (scatter, accum) in FUSED_TIMED:
                        out[f"fused_{scatter}_{accum}"] = {"ms": cs.median_ms(
                            torch, lambda: gk.ggnn_fused(h, edges, *params, n_steps=STEP_STEPS,
                                                         **kw))}
                    if (scatter, accum) == ("mxu", "int8"):
                        out["step_mxu_int8"]["launch_split"] = cs.launch_split(
                            torch, lambda: gk.ggnn_step(h, edges, *params, **kw))
    return out


def imma_counts(cuda_build, lib: str) -> dict:
    """{SASS function: IMMA instructions} of the built library `lib`, for
    the functions that hold any (cuobjdump beside nvcc)."""
    import re

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cuda_build.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"\bIMMA\b", line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


TIMERS = {"fwd": time_fwd, "bwd": time_bwd, "dbias": time_dbias, "dbias_mma": time_dbias_mma,
          "dmsg": time_dmsg, "gru": time_gru, "step": time_step}


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
        out = {lib: {k: v for k, v in cs.ptxas_summary(r["log"]).items()
                     if k.startswith(trial["ptxas"])} for lib, r in report.items()}
        if mode == "step":
            out["imma"] = imma_counts(cuda_build, "ggnn_step")
        return out
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
    beside both medians, errors (`*err*`) their larger, flags both, a
    hash (`*digest`) itself where both runs agree and "differs" where
    not, the rest (the batch cut, the launch split) the first run's."""
    if key.endswith("digest"):
        return first if first == second else "differs"
    if isinstance(first, dict) and "err" in key:
        return {k: merge(first[k], second[k], key) for k in first}
    if isinstance(first, bool):
        return first and second
    if key == "ms" or key.endswith("_ms"):
        return (first + second) / 2
    if "err" in key:
        return max(first, second)
    return first


def bits_equal(calls: dict, ref: str) -> dict:
    """{build: {call: {hash field: equal}}} for the calls that carry
    hashes: a hash equals `ref`'s and is the same on both runs of the
    build ("differs" never equals)."""
    out = {}
    for label, by_call in calls.items():
        for call, fields in by_call.items():
            for k, v in fields.items():
                if k.endswith("digest"):
                    want = calls[ref][call][k]
                    out.setdefault(label, {}).setdefault(call, {})[k] = (
                        v == want and v != "differs")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=list(TRIALS))
    ap.add_argument("--layouts", nargs="*")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of another flash_attention.cu to time (fwd, bwd)")
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of another checkout whose package to time (gru, step, "
                         "dmsg)")
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
    if args.tree and args.mode not in ("gru", "step", "dmsg"):
        sys.exit("--tree applies to gru, step and dmsg")
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
    bits = bits_equal(calls, "parent" if "parent" in calls else labels[0])
    weighted = {label: sum(n * sum(calls[label][c][f] for f in trial["weighted"])
                           for c, n in weights.items()) / sum(weights.values())
                for label in labels}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    line = json.dumps({"card": smi, "mode": args.mode, "build_seconds": build_s, "ptxas": ptxas,
                       "weights": weights, "weighted_fields": trial["weighted"],
                       "weighted_ms": weighted, **({"bits_equal": bits} if bits else {}),
                       "calls": calls})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
