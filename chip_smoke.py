#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`deepdfa_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and
the CUDA toolkit; it needs no install, no network and no JAX. Each phase
prints one JSON line; any failure exits non-zero before the last line.

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel source of the package from csrc/,
   one nvcc each, all started together;
3. kernel ggnn_step — the forward kernel against its plain PyTorch
   version on the card (fp32, rtol 1e-4, atol 1e-5) at the flagship
   batch (N 16384, E 65536, d 128, T 1), a T = 3 batch and the
   all-padding batch; median times over 20 CUDA-event runs and the
   card's bound;
4. kernel ggnn_gru_bwd, kernel ggnn_dmsg — the two backward kernels
   (B3, B4) against their plain versions at the same three batches, the
   same way (the parameter cotangents, sums over every node, are held
   with atol 1e-5 times their largest magnitude); B4 both alone and
   added into B3's dh, as step_bwd calls it; their times beside their
   first designs' (GRU_BWD_BASELINE_MS, DMSG_BASELINE_MS), and on lines
   before the phase's, one B3 call's and one B4 call's device time split
   by launch (torch.profiler);
5. serve   — a flagship-width DeepDFA (hidden 32, 5 steps, input_dim
   1002, random weights from a seeded generator) behind a started
   DynamicBatcher answers seeded synthetic requests; every probability
   is finite and in (0, 1), matches the same model on the CPU (plain
   path, rtol 1e-4, atol 1e-5), and the kernel ran n_steps times per
   executed batch;
6. profile — where one full serving batch's time goes: host stages,
   device time by kernel (torch.profiler) and the device's idle share;
7. train   — GraphTrainer.fit of a flagship-width DeepDFA (AdamW, lr
   1e-3, wd 1e-2) on seeded labelled graphs of 10-400 nodes, packed by
   the bucket planner at 256 graphs / 16384 nodes / 65536 edges: 20
   steps over 4 fixed batches. Every loss is finite and the last epoch's
   mean is below the first's; each of the three kernels launched
   steps x 5 times (plus 5 forward launches per evaluated batch); two
   backward passes on one batch give bit-equal gradients; the first 3
   steps on the CPU plain path match the card's losses (rtol 1e-4) and
   step-1 gradients (1e-4 of each leaf's scale); median ms per step
   split into host pack, forward, backward and optimiser, and graphs/s;
7a. kernel ggnn_step_policy — kernel 1's bf16 and int8 instances
   against the plain version of the same policy on the card (the same
   rounded or quantized rows: rtol 1e-4, atol 1e-5) at the three
   batches of phase 3, the same bits on a rerun, the aggregate moved off
   fp32's; times, plain times and bounds at the flagship batch;
7b. kernel ggnn_fused — kernel 2 (5 steps in one cooperative launch)
   under fp32, bf16 and int8 at the same three batches: h_out, with and
   without the chain, and every chain plane the bits of 5 launches of
   kernel 1 of the policy, the same bits on a repeat, and each of its
   steps within rtol 1e-4 / atol 1e-5 of the plain step from that step's
   input (five plain steps from the first input are not compared: a
   rounding or a quantum can flip between two fp32 summation orders and
   spread); times with and without the chain beside the 5 step
   launches', one step in one launch beside one step launch, the plain
   version's and the bounds; the residency against the card's L2, and
   its blocks an SM and grid;
7c. serve_bf16, serve_fused, serve_int8, serve_int8_fused — phase 5's
   model and requests through score_graphs with model.ggnn_kernel=true
   under (bf16, per_step), (fp32, fused), (int8, per_step), (int8,
   fused), each counted from 0: every request scored, no fused fallback,
   the variant's kernel n_steps times (fused: once) a batch and no other,
   scores within 5e-2 of scale of phase 5's fp32 scores and, for a
   policy, not equal to them; requests/s and p50/p99; then
   serve_variants: on fixed batches (the offline drive) the fused scores
   are the bits of the per-step scores of the same policy;
7d. train_fused, train_bf16 — phase 7's fit with model.ggnn_kernel=true
   under (fp32, fused) and (bf16, per_step), 20 AdamW steps, counted from
   0: losses finite and falling, the launches the unroll implies (fused:
   one launch with the chain a step and one without an eval batch, then
   5 kernel-1 recomputes, 5 B3 and 5 B4 a step), step-1 gradients of the
   fused unroll the bits of the per-step one, median step ms;
7e. kernel ggnn_step_mxu — kernel 1's mxu instances (fp32, bf16, int8;
   edge block 512) against the plain mxu version of the same policy on
   the card (rtol 1e-4, atol 1e-5) at the three batches of phase 3, int8
   also at edge blocks 128 and 1024 on the flagship batch (each against
   its own plain version, and not block 512's aggregate), the same bits
   on a rerun, the int8 mxu aggregate not the int8 fold one; times, the
   fold instance's times, plain times and bounds at the flagship batch,
   and one int8 call's device time split by launch (the quantizing
   table, the pre-pass, the step);
7f. kernel ggnn_fused_mxu — kernel 2's mxu instances (5 steps) under each
   policy at the same batches: h_out, with and without the chain, and
   every chain plane the bits of 5 launches of kernel 1's mxu instance,
   the same bits on a repeat, each step within rtol 1e-4 / atol 1e-5 of
   the plain mxu step from that step's input; times, bounds, the
   residency against the card's L2, and its blocks an SM and grid;
7g. serve_mxu, serve_mxu_int8, serve_mxu_int8_fused — phase 5's model and
   requests through score_graphs under (fp32, mxu, per_step), (int8,
   mxu, per_step), (int8, mxu, fused), each counted from 0: every request
   scored, no fused fallback, only the variant's kernel, n_steps times
   (fused: once) a batch; scores within 5e-2 of scale of phase 5's fp32
   fold scores, the int8 mxu scores not serve_int8's;
7h. train_mxu — phase 7's fit under (int8, mxu, per_step), 20 AdamW
   steps counted from 0: losses finite and falling, the instance's, B3's
   and B4's launches and no other, two backward passes the same bits,
   each of the first 3 losses of a fresh run within rtol 1e-4 of the CPU
   plain path's loss from that step's parameters (the free CPU
   trajectory beside it is reported: an int8 quantum that flips between
   two fp32 summation orders spreads through AdamW), median step ms;
7i. tune — `cli tune` at the flagship serving budgets (16384 x 65536,
   d 128, 5 steps) over the card-legal grid, counted from 0, under a
   temporary storage root: every candidate timed with its numerics
   verdict, a winner, a valid tuned.json (its candidate table on the
   line tune_candidates); then `cli train` (flagship model,
   ggnn_kernel=true, tune.enabled=true, 2 epochs on 120 seeded graphs in
   a graph store there, written with the port's GraphStore.write) prints
   the overrides it applied, saves them in its config and launches the
   winner's kernel;
7j. pipeline — the port's own data path at the flagship config, under a
   temporary storage root: 2048 seeded synthetic functions at Big-Vul
   tail sizes (`data/synthetic.py:bigvul_stmt_sizes`, median 14
   statements, clipped at 500) written as a Devign-format json, then
   `cli prepare --source <json>` and `cli extract --workers 4` (the C
   frontend over every function, the train split's vocabularies, the
   graph store), each in a process of its own; every example is a graph
   or a missing id, every
   feature lies inside input_dim 1002; then `cli train` of the flagship
   model (hidden 32, 5 steps, node budget 16384) on the card, 2 epochs
   over every train graph (data.undersample=false), and `cli test`,
   counted from 0: losses finite, kernel 1 5 times a
   forward batch (train steps, validation batches, and each test batch
   twice: `test --export` evaluates, then exports), B3 and B4 5 times a
   train step and no other kernel, the test split's
   probabilities on the card within rtol 1e-4 / atol 1e-5 of the same
   checkpoint's on the CPU plain path; prepare and extract seconds,
   functions/s of extraction on the card machine's host, graphs and
   nodes, the median ms and graphs/s of a train step timed alone
   (synchronized before and after), and the training loop's own rate
   (train graphs over each epoch's seconds, evaluation outside them);
7k. serve_source — scoring and serving C sources over the pipeline's run
   and storage root: the test split's functions written as .c files with
   8 texts the frontend cannot parse, `cli score` on the card (every
   extracted function ok, every text a failed row, each probability
   within rtol 1e-4 / atol 1e-5 of `cli test --export`'s on the card and,
   for the first 64 sources, of `cli score --device cpu`'s, kernel 1
   n_steps times a batch in the scoring window and no other kernel); `cli
   serve --port 0` as a subprocess: /healthz (checkpoint tag, step,
   config digest) and /stats 200, malformed JSON 400, an unknown route
   404, an unparseable function 422, then 128 /score requests drawn from
   the test split by
   8 client threads, every one 200 with `cli score`'s probability
   (rtol 1e-4), and the same requests again, every one a feature-cache
   hit; requests/s, p50/p99 and mean batch occupancy of both passes;
   then `cli train-combined` for 2 steps at codebert-base width (hash
   tokenizer) on the pipeline's examples, and `cli score --family
   combined` over 16 of the files from the run's model_cfg.json on the
   card (kernel 5 once an encoder layer and kernel 1 n_steps times a
   batch) and over 4 of them on the CPU, warming the top bucket alone
   (within 2e-2); the frontend's median ms a
   function and `score`'s requests/s and p50/p99, beside nvidia-smi's
   name and power limit;
7l. bpe — the shipped byte-level BPE vocabulary (`data/assets/bpe_c/`)
   over the pipeline's test functions on the host: build seconds,
   tokens a function (median, p90, max, the share past 512) and encode
   µs a function, cold and warm;
7m. train_attn_saved — one training step (forward + backward) under
   remat "full" and under "attn_saved" from the same weights, batch and
   dropout seed, for the combined model at codebert-base width (16 x 512
   BPE ids of the pipeline's test functions, bf16, dropout 0.1, encoder
   weights from a random HF-layout state dict through the CLI's
   `--pretrained` loader), the T5 defect model (codet5-base width, bf16)
   and the generation model (fp32, 16 rows of 256 -> 128): the same loss
   and gradients to the bit, kernel 5 once a layer's attention call
   instead of twice with dq, dk/dv and dbias unchanged; each policy's
   synchronized step (median of 3) and its peak memory above the
   weights;
7n. cascade — stage 2 trained by `cli train-combined --tokenizer <the
   shipped BPE> --pretrained <that state dict> --remat-policy attn_saved`
   (codebert-base width, buckets 128/256/512) on serve_source's derived
   dataset; `cli score` of the val split joined with its labels, `cli
   cascade-calibrate --target-escalation 0.3`; with its overrides `cli
   score` of the test split's functions in cascade mode on the card and
   on the CPU beside the GGNN alone and the combined model alone (rows
   not escalated the GGNN's probability to the bit, escalated rows
   within 2e-2 of the combined model alone, the counters adding up, the
   same stages on the CPU for the first 8, its stage 2 warming the top
   bucket alone); `cli serve` for each of the three under 256
   requests from 8 client threads (seed 17); the escalation rates,
   requests/s and p50/p99 offline and over HTTP, kernel 1's and kernel
   5's launches;
7o. localize_ggnn — GGNN node attributions (eval/localize.py:
   ggnn_score_fn) of phase 5's model on the profile phase's full serving
   batch (16 graphs, 16384 nodes, 65536 edges), each of the five methods
   (path methods at 8 steps) on the card against the CPU plain path
   (probabilities rtol 1e-4 / atol 1e-5, node scores within 1e-4 of each
   graph's largest |score|), padding zero, the same bits on a repeat,
   counted from 0: kernel 1 with the aggregate, B3 and B4 n_steps times a
   gradient evaluation (1 for saliency and input_x_gradient, 8 for
   deeplift and lig), kernel 1 without it n_steps times a forward alone
   (attention, and the path methods' probabilities), B3 and B4 at 0 under
   attention; saliency under ggnn_kernel_unroll=fused the per-step bits;
   one gradient evaluation with every parameter requiring a gradient and
   with none (the same cotangent, the device kernels the input-only
   backward saves, both times); ms a batch and functions/s per method
   and one profiled saliency and lig batch (device busy time, idle share);
7p. serve_lines — `cli serve` over the pipeline's checkpoint without
   serve.lines ({"lines": true} answered 400, healthz lines false) and
   with it (saliency, 8 steps, top 10): 128 requests from 8 client
   threads, every other one with {"lines": true}, each lines answer the
   offline attribution of that function alone at rung 1 to the bit;
   requests/s and p50/p99 with and without lines; the launches of 32
   lines requests through the same service in-process;
7q. localize_combined — `cli localize` of the cascade's stage-2 run
   (codebert-base width, the shipped BPE, T 512, graphs) over 2
   functions with labelled lines, each of the seven methods: the
   report's keys and finite metrics, one IFA line a function, kernel 5
   once a layer an evaluation, dq and dk/dv once a layer an evaluation
   (no remat replay), kernel 8 at 0, the graph encoder's kernel 1
   without the aggregate; seconds a function; on 2 functions saliency
   and lig (4 steps) in fp32 on the card against the CPU (1e-3 of each
   row's largest |score|) and bf16 against fp32 on the card (5e-2);
7r. localize_t5 — saliency and lig (4 steps) of a codet5-base-width
   DefectModel (bf16, graphs) on 4 rows of 512 tokens: kernels 5, 6 and
   7 once a layer an evaluation, kernel 8 at 0, seconds; a 2-layer fp32
   model of the same width on the card against the CPU (2e-2, the T5
   gradient check's fp32 bound: a flipped ReLU gate moves a row);
7s. native — the native C++ lexer and solver (`deepdfa_tpu_torch/
   native/`, g++ at first use) on the pipeline's 2048 functions: `cli
   extract --workers 4` again natively (the library built) and on the
   Python path (the native library switched off in that process and its
   workers) under two more storage roots, each store, vocabulary and
   missing-id list equal to the pipeline phase's extraction (whose
   workers built the library); seconds and functions/s each way; in this
   process each extraction stage's seconds and share (lex, parse,
   reaching definitions, dependences, abstract dataflow, encoding,
   store) over 128 functions under each backend;
7t. serve_pipelined — phase 5's model and requests (x 8) through
   `score_all` at serve.pipeline_depth 0, 1 and 2 (the same bits at
   every depth, the in-flight peak the depth, kernel 1 n_steps times a
   batch) and through a started batcher with 8 submitting threads at
   depths 0 and 2 (within rtol 1e-4 / atol 1e-5); requests/s, p50/p99
   and the DeviceWindow idle fraction of each; serve_lines (7p) also
   runs its lines server at depth 2 (every lines answer the offline
   bits) and counts its in-process launches serial and pipelined;
7u. serve_int8_entry — the quantized `tag@int8` entry (apart from 7c's
   serve_int8, the int8 message policy): `cli score` with the fp32 entry,
   then with `--override serve.checkpoint='"best@int8"'`, over
   serve_source's files on the card and the CPU: the calibration
   drift within 5e-2, the bytes fraction, card vs CPU within rtol 1e-4 /
   atol 1e-5, each probability within 5e-2 of the fp32 entry's, kernel
   1 n_steps times a batch; then the cascade's `cli score` with its
   stage 2 as `best@int8` (its drift and bytes fraction, the fp32
   cascade's stages, each escalated probability's distance to the fp32
   stage 2's, kernels 1 and 5);
7v. train_prefetch — the pipeline's `cli train` again at
   train.prefetch_batches=0, and at 2 with data.pack_workers=4 and
   data.packed_cache=true (both epochs replay the stream the step-count
   estimate wrote): every step's loss the pipeline run's (prefetch 2,
   the default) to the bit, the loop's graphs/s and the epochs' host
   load, pack, place and wait seconds; a window of 24 steps at prefetch
   0 and 2 under torch.profiler (device busy time, idle share);
7w. struct_feats — the structural-feature GGNN at the flagship recipe's
   width (scripts/train_flagship.py: hidden 32, 5 steps, cfg+dep,
   struct channels; d = 9 x 32 = 288): `cli extract` (a subprocess) of
   the pipeline's first 1024 functions with data.feat.struct_feats=true
   (9 columns a node, each struct column inside its vocabulary), `cli
   train` of one epoch on the card (finite losses; kernel 1, B3, B4
   n_steps times a step), `cli score` of the test functions on the card
   and the CPU plain path (rtol 1e-4, atol 1e-5); then kernel 1 under
   every policy and scatter, kernel 2, B3 (and its input-only form) and
   B4 at d 288 and T 3 on the flagship batch against their plain
   versions, kernels 1, 2, B3 and B4 timed beside their bounds;
7x. scan — `cli scan --lines` on the card with that run over a
   repository of 320 of its functions in 40 files (nested directories,
   a decoy in .git and third_party, a generated file past
   scan.max_file_kb): cold, then after one function is edited (one
   extraction, the rest reused, the unedited findings unchanged); both
   SARIF documents valid, every finding attributed to lines inside its
   function and its probability `cli score`'s for the same function
   (rtol 1e-4, atol 1e-5); the seconds by stage and functions/s of both
   scans;
7y. dataflow_bits — the reaching-definitions bit supervision: `cli
   extract` of the first 512 of 7w's functions with data.feat.max_defs=64, `cli
   train` of one epoch under model.label_style=dataflow_solution_out at
   the flagship recipe (hidden 32, 5 steps, d 128; kernel 1, B3, B4 and
   the bit propagation's segment-sum kernel, csrc/setops.cu, counted;
   losses finite and falling) and `cli test`; the propagation without
   its gate and with n_steps = the largest graph + 1 on the card equals
   the stored IN and OUT bits of one packed batch within 1e-5 (relu and
   simple unions), twice to the bit; the trained model's node logits on
   the card those of the CPU plain path (1e-5); a step's gradients the
   same bits twice; the segment-sum kernel against its plain version
   (exactly) and index_add_ on a flagship training batch, timed;
7z. bf16_params — model.param_dtype=bfloat16 on the pipeline's store:
   `cli train` of one epoch on the card, every floating leaf of the
   checkpoint bf16, `cli score` of the test functions on the card and
   the CPU plain path (1e-5), the same weights upcast into an fp32 model
   (5e-2), one saliency localization batch;
7za. runtime_hooks_train — the resilient runtime: `cli train` on the
   pipeline's store (one epoch, inline input, a step checkpoint every 2
   steps) under DEEPDFA_FAULTS nan@3,nan@4; again with sigterm@6 (exit
   143) and resumed by a second `cli train`, whose final weights,
   moments and counts equal the first run's to the bit, both with steps
   3 and 4 skipped and no rollback; nan@3,4,5 at max_consecutive_bad 3
   rolls back once with the LR cooled to 0.5; a stalled source under a
   5 s watchdog exits 113 (a subprocess) with a valid postmortem; then
   8 guarded steps make as many synchronizing calls as 8 unguarded ones
   (torch.cuda.set_sync_debug_mode), a step of each timed (A B B A), a
   step checkpoint's seconds and bytes;
7zb. efficiency — `cli test --profile --xprof-dir` on that run prints
   Table 5's record, its counted FLOPs equal the CPU count of the same
   batch exactly and its trace names ggnn_step_kernel; `cli score` with
   obs.ledger and obs.ledger_ceilings books one ledger site a warmed
   rung, every ledger_mfu in (0, 1.05]; `cli train-combined` at
   codebert-base width, 4 steps under the resilient runtime and the
   ledger with nan@2: the step skipped, the flash kernels launched, the
   ledger holding the step's site; the bounded health probe answers ok
   inside 120 s. Every phase line carries its seconds since the one
   before (`since_last_phase_s`);
7zc. joern_and_tools — on the same root and checkpoint (d 128): (a) `cli
   score` in-process with serve.use_joern=true, a pool of 2 and a stub
   `joern` REPL on PATH (deepdfa_tpu_torch/testing/joern_stub.py: the five
   hand-built Joern fixture exports; neither machine has Joern) over the
   five fixture sources, a repeat of each and a source the stub does not
   know, on the card and on the CPU plain path: the fixtures and repeats
   scored (each through an import and an export round trip, the repeats
   cache hits), the unknown source one counted failure, card vs CPU
   within 1e-5, kernel 1 n_steps times a batch; then, with the shared
   feature cache dropped, a stub that wedges after its handshake under
   serve.joern_timeout_s=2: one JoernTimeout, one restart, the five
   scored with (a)'s probabilities; (b) `Tuner` over `random_search` of
   train.optim.learning_rate, 2 trials of GraphTrainer on the card (4
   steps, 2 validation batches) logging through RunLogger: a 2-row
   trial ledger of finite values, each trial's launches, TensorBoard
   where it imports; (c) `cli run-exp --tasks deepdfa --seeds 0 1` (1
   epoch): two `cli train` subprocesses on the card under the storage
   root, 2 summary rows with rc 0 and a parsed result, their launches
   read from each subprocess's counters at its exit (a sitecustomize
   the script writes); (d) `cli coverage`, `logistic_control` on the
   store's splits beside the GGNN's test metrics (the pipeline's card
   probabilities), `cli ivdetect` over 16 test functions; each part's
   seconds and the phase's;
8. kernel flash_fwd — the flash-attention forward kernel against its
   plain version on the card: the flagship serving shape (B 16, H 12,
   T 512, D 64) in bf16, the T = 256 and T = 128 bucket shapes, an fp32
   case and a bf16 batch with ragged masks and one all-padding row
   (o within 2e-2 in bf16 and 1e-5 in fp32, lse within 1e-5, o == 0 on
   the padding row); median times of 20 CUDA-event runs, the plain
   version's, one scaled_dot_product_attention call's (the yardstick,
   never called by the port) and the card's bound; then the flagship
   call at dropout 0.1 against the plain version with the seed's Philox
   bits, and the keep fraction of its 50 M bits within 0.9 +- 0.002,
   with one scaled_dot_product_attention call's time at that rate and
   the backend that ran it;
9. serve_combined — score_combined on the combined DeepDFA+LineVul
   model at codebert-base width (768 wide, 12 layers, bf16 activations,
   vocab 50265) with the flagship graph encoder (d 128, 5 steps), random
   weights from a seeded generator, buckets 128/256/512 at token budget
   8192 (64/32/16 rows), answering 64 seeded requests spread over the
   three buckets, each with a seeded graph. Every probability is finite
   and in (0, 1); the flash kernel ran 12 times and the GGNN step 5
   times per batch; 3 requests re-scored alone match their batched
   scores (text-only: the same bits; with graphs within 1e-5); 4
   requests through a 2-layer model of the same width and seed give
   logits within 5e-3 between the card and the CPU plain path; then a
   load window of 768 such requests (256 a bucket, so every bucket runs
   several full batches, arriving at once) gives requests/s, p50/p99
   and the tokenizing time, which precedes the batcher's window;
10. profile_combined — one full 512-token batch split into host
   collate, copies, forward to sync and fetch; device time by kernel
   (flash, GGNN step, matmuls, the rest) and the idle share;
11. kernel flash_bwd — the backward kernels dq and dk/dv against the
   plain backward on the card, at dropout 0 and 0.1 (one seed, the same
   mask in both), at the flagship training call, the T = 256 and 128
   buckets, fp32, and a ragged bf16 batch with an all-padding row (its
   gradients exactly 0); each gradient within 2e-2 of its largest
   magnitude in bf16 (1e-4 in fp32), the same bits on a rerun; times of
   both kernels at both rates, the plain backward's, the backward of one
   scaled_dot_product_attention call, and the bounds;
12. train_combined — CombinedTrainer.fit of the combined model at
   codebert-base width (bf16 activations, dropout 0.1, remat "full")
   with the flagship graph encoder, random weights from seed 0, AdamW
   at lr 1e-4 without warmup, clip 1.0: 20 steps over 4 fixed bucketed
   batches (512, 512, 256, 128 tokens at token budget 8192) of seeded
   labelled texts with graphs, 5 epochs. Every loss finite and the last
   epoch's mean below the first's; per step 24 flash forward launches
   (12 layers and their 12 replays under remat), 12 dq, 12 dk/dv and 5
   each of the GGNN step, B3 and B4 (the warm-up runs one step per
   bucket, an eval batch 12 flash and 5 GGNN launches); two backward
   passes with one seed give the same bits; a 2-layer model of the same
   width with dropout 0 gives the same first two losses (5e-3) and
   step-1 gradients (2e-2 of each leaf's scale) on the card and on the
   CPU plain path; a step split (host collate, copies, forward,
   backward, optimiser), tokens/s, examples/s, peak memory with remat
   on and off, and one profiled step;
13. kernel flash_bias — kernels 5-7 with T5's additive [H, T, T] bias
   and kernel 8 (dbias) against the plain versions at the T5 flagship
   call (B 16, H 12, T 512, D 64, bf16, scale 1.0), at dropout 0 and 0.1:
   every key live, ragged keys with an all-padding row, and ragged keys
   with the training path's strided operands; o within 2e-2, lse within
   1e-5 + 1e-5 |lse|, each gradient and dbias within 2e-2 of its largest
   magnitude, the same bits on a repeat; the four kernels' times with the
   bias, the plain versions', one scaled_dot_product_attention call with
   the bias as a float attn_mask (forward, and backward with the mask
   requiring grad; the backward at dropout 0.1 too, with its backend)
   and the bounds;
14. serve_t5 — phase 9 for the CodeT5+DeepDFA defect model at
   codet5-base width (768 wide, 12 layers of 12 x 64 heads, FFN 3072,
   32 relative buckets, vocab 32100, bf16 activations) with the flagship
   graph encoder and the T5-framed hash tokenizer (pad 0, eos 2): the
   biased flash kernel 12 times and the GGNN step 5 times a batch, the
   same alone-vs-batched and 2-layer card-vs-CPU checks, the 768-request
   load window;
15. profile_t5 — phase 10 for the defect model;
16. train_t5 — phase 12 for the defect model (remat "full", hidden
   dropout 0.1; T5 has no attention-probs dropout): per step 24 biased
   flash forward launches, 12 dq, 12 dk/dv, 12 dbias and 5 of each GGNN
   kernel;
17. kernel flash_causal — kernels 5-8 with the causal mask (the causal
   build of the flash source) against the plain versions: bf16 (D 64)
   and fp32, with and without the bias, ragged T = 200 with padded keys
   at the end and at the start (queries without a live key: o = 0, dq =
   0), dbias exactly 0 above the diagonal, the same bits on a repeat,
   and the clone path's two fp32 biased calls (B 32, T 256: the encoder
   with ragged rows, the causal decoder), where the fp32 dbias cuts the
   batch into runs of more than one row;
   times, plain and library times (scaled_dot_product_attention with
   is_causal, or a float attn_mask holding bias and -inf) and bounds
   over the live pairs at the flagship call (B 16, H 12, T 512, bf16,
   with and without the bias) and at the gen path's fp32 calls (decoder
   T 128 causal with the bias, cross 128 x 256, encoder 256 with the
   bias); this run's unbiased non-causal flagship times beside the ones
   PERF.md records from before the causal build, its fp32 dq and dk/dv
   times at the gen calls beside the first FMA version's
   (FP32_BWD_BASELINE_MS), and its forward times at the gen calls and
   the flagship call (plain, bias, causal, causal + bias, dropout 0.1)
   beside the first design's (FWD_BASELINE_MS), its fp32 dbias times
   at the decoder and encoder calls beside the first FMA dbias's
   (FP32_DBIAS_BASELINE_MS), the batch cut of every fp32 biased case
   (slices, rows a slice), with the
   registers and spills from the build of every forward instance at D
   64, the register-tiled fp32 dq, dk/dv and dbias, the bf16 FMA dbias,
   every width's B3 passes and every width's instances of GGNN kernel 1
   with its step bodies and the int8 pre-pass (none may spill; the GGNN
   ones reported at d 128), and every width's instances of kernel 2 with
   their spills (reported);
18. train_gen — `train-gen`'s path (the CLI's hash tokenizer at vocab
   32100, reader and codet5-base-width model in fp32, 12 + 12 layers)
   through GenTrainer.fit: 4 batches of 16 summarize rows (256 -> 128
   tokens), 5 epochs with a dev batch, AdamW lr 1e-4, dropout 0.1. Every
   loss finite, the last epoch's mean below the first's; per step 72
   flash forward launches (encoder, decoder self- and cross-attention,
   each with its remat replay), 36 dq, 36 dk/dv, 24 dbias; two backward
   passes with one seed give the same bits; a 2+2-layer model (dropout
   0) gives the same two losses (5e-3) and step-1 gradients (2e-2 of each
   leaf's scale) on the card and the CPU plain path; a step split,
   tokens/s, peak memory and a profiled step; 6 bf16 steps;
19. decode_gen — GenTrainer.decode (beam 5, max length 128) of the
   trained model over 2 batches of 16 sources: sequences/s, 12 encoder
   flash launches a batch; a 2+2-layer fp32 model's _decode_step logits
   at every step within 1e-3 of scale card vs CPU, and its beam ids equal
   where every step's top-K margin exceeds 1e-4;
20. train_clone — `train-clone`'s path: the reference's clone files,
   CloneTrainer at codet5-base width (fp32), 8 steps on 16 pairs of 256
   tokens; every loss finite; the gen step's launches per step; one
   profiled step (device busy time, idle share, device ms by group);
19a. codebleu — `cli codebleu --lang c` (host only) scores decode_gen's
   beam-search outputs against their targets (the hash tokenizer's ids
   mapped back to the corpus's words): every component finite and in
   [0, 1]; the decoded examples' source code (each framed in a function
   that defines and returns a variable) as both --refs and --hyp gives
   1.0 in every component; fixed java, c# and python pairs give
   the reference package's values exactly (CODEBLEU_PINNED);
19b. gen_runtime — `train-gen` under the resilient runtime. At full depth
   (phase 18's model and batches, in-process): the synchronizing calls
   of 8 guarded steps (the runner reading each ok flag a step late) and
   of 8 unguarded ones, which must be equal; each step's ms (8 of each
   kind, in rounds A B B A of 4) and the guard's cost a step (the
   medians' difference); one step checkpoint's
   seconds and bytes; 4 guarded steps of GenTrainer.fit under the
   ledger (obs.ledger, measured ceilings): the step's site
   `train_step/<signature>`, its counted TFLOP and its MFU in
   (0, LEDGER_MFU_MAX]. At 2 + 2 layers of the same width (the depth cut
   that holds the step checkpoints' writes down), `cli train-gen`
   in-process over one epoch of GEN_RT_BATCHES batches with a step
   checkpoint every GEN_RT_STEP_EVERY steps: (a) DEEPDFA_FAULTS=
   GEN_RT_NAN; (b) the same plus sigterm@GEN_RT_SIGTERM_AT exits 143 and
   a second command resumes it; (b)'s final weights, moments and counts
   equal (a)'s to the bit, both records show the two planned steps
   skipped and no rollback; (c) nan@3,4,5 at max_consecutive_bad=3 rolls
   back once with the LR cooled to 0.5;
20a. moe_combined — phase 12's model with the MoE adapter (8 experts,
   top 2) on its 16-row T 512 batches: 4 CombinedTrainer steps (bf16,
   dropout 0.1) and one serving forward through score_combined, kernels
   5-7 and the GGNN kernels counted; finite losses and aux; the MoE
   block on the last step's [CLS] rows in fp32 gives the same dispatch,
   and outputs and aux within 1e-5, on the card and the CPU; the block
   and a step's gradients the same bits on a repeat;
21. kernels — every kernel with its launches on the fifty-seven main
   paths (serve, train, serve_combined, train_combined, serve_t5,
   train_t5, train_gen, decode_gen, gen_runtime_full, gen_runtime_faults,
   gen_runtime_resume, train_clone, the six of 7c-7d, the
   four of 7g-7h, tune, tune_train, pipeline, serve_source,
   train_attn_saved, cascade_train, cascade, localize_ggnn, serve_lines,
   localize_combined, localize_t5, serve_pipelined,
   serve_lines_pipelined, serve_int8_entry, cascade_int8,
   train_prefetch, struct_train, struct_score, scan, bits_train,
   bits_test, bf16_train, bf16_score, bf16_localize, moe_train,
   moe_serve, hooks_train, hooks_resume, hooks_test_profile, hooks_score,
   hooks_train_combined, jo, jo_restart, tn and rx, each counted from 0,
   and by path),
   error, time, plain time, bound and library time; the flash rows add
   their biased times as bias_* and their causal and gen-path times under
   by_call; ggnn_step_bf16, ggnn_step_int8 and ggnn_step_mxu* are kernel
   1's instances (the mxu rows add their fold instance's fold_ms),
   ggnn_fused and ggnn_fused_mxu kernel 2's (fp32 without the chain,
   by_policy and chain the rest); the d288 entry of the ggnn_step,
   ggnn_fused, ggnn_gru_bwd and ggnn_dmsg rows holds their time, plain
   time, bound and error at d 288 (phase 7w) and their launches on the
   struct_feats and scan paths, which run only the d 288 model;
   setops_gather_sum is the bit propagation's segment sum, which
   replaces no TPU kernel (the reference's jax.ops.segment_sum).

The line before the last is nvidia-smi's "name, power.limit"; the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --phase train_clone [--phase ...]

runs only the named training phases (train, train_gen, train_clone) on
a fresh seed after phases 1-2, and prints their lines and no last line:
set beside another checkout's package (copy this script into that
checkout and run it there), it gives both trees' profiled steps from one
script.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_CONFIG = ROOT / "configs" / "bigvul_deepdfa.json"
COMBINED_CONFIG = ROOT / "configs" / "bigvul_combined.json"
RTOL, ATOL = 1e-4, 1e-5
# published H100 SXM peaks (dense): fp32 outside the tensor cores, bf16
# on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
COMBINED_BUCKETS = [128, 256, 512]
COMBINED_REQUESTS = 64
COMBINED_LOAD_REQUESTS = 768  # 256 a bucket: 4-16 full batches each
# card vs CPU logits of the 2-layer bf16 check (its probabilities agree
# to ~5e-4 on an H100, where the logits are ~0.3 in size)
COMBINED_LOGIT_TOL = 5e-3
# 2-layer combined training, card vs CPU plain path (bf16 activations):
# the first two losses (absolute) and step-1 gradients (of each leaf's scale)
COMBINED_TRAIN_LOSS_TOL, COMBINED_TRAIN_GRAD_TOL = 5e-3, 2e-2
C_WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
           "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n",
           "size_t", "->", "next", "while", "<", "for", "i", "++", "NULL", "&", "ptr")
TIMED_RUNS = 20
# attention-probs dropout of the training path (TransformerConfig's rate)
DROPOUT_RATE, DROPOUT_SEED = 0.1, 20241017
N_REQUESTS = 96
TRAIN_BATCHES, TRAIN_EPOCHS = 4, 5
CPU_STEPS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


#: the script's start on the host clock; each phase line carries its
#: seconds since (`t_s`), so a run shows where its time limit goes
T_START = time.perf_counter()


_LAST_EMIT = [T_START]


def emit(record: dict) -> None:
    if "phase" in record:
        now = time.perf_counter()
        record = {**record, "t_s": round(now - T_START, 1),
                  "since_last_phase_s": round(now - _LAST_EMIT[0], 1)}
        _LAST_EMIT[0] = now
    print(json.dumps(record), flush=True)


def synthetic_graph(rng, gid: int, n: int, input_dim: int, n_etypes: int = 1,
                    signal: bool = False):
    """A CFG-like graph: a fall-through chain plus random jumps, about
    1.5 edges per node. With `signal`, every other graph carries token 7
    on one node, which is its vulnerable node and makes its label 1 (a
    learnable signal, as in tests/test_train.py)."""
    import numpy as np

    from deepdfa_tpu_torch.graphs import GraphSpec

    extra = max(0, int(round(1.5 * n)) - (n - 1))
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, extra)]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, extra)]).astype(np.int32)
    feats = rng.integers(0 if not signal else 8, input_dim, (n, 4)).astype(np.int32)
    vuln = np.zeros((n,), np.int32)
    if signal and gid % 2 == 0:
        k = int(rng.integers(0, n))
        feats[k, 0] = 7
        vuln[k] = 1
    return GraphSpec(
        graph_id=gid,
        node_feats=feats,
        node_vuln=vuln,
        edge_src=src,
        edge_dst=dst,
        label=float(vuln.max()) if signal else float(gid % 2),
        edge_type=(
            rng.integers(0, n_etypes, src.shape[0]).astype(np.int32)
            if n_etypes > 1 else None
        ),
    )


def full_batch(rng, node_budget: int, edge_budget: int, n_etypes: int):
    """As many seeded graphs of 10-400 nodes as the budgets hold."""
    from deepdfa_tpu_torch.graphs import pack

    graphs, nodes, edges = [], 0, 0
    while True:
        g = synthetic_graph(rng, len(graphs), int(rng.integers(10, 401)), 1002, n_etypes)
        if nodes + g.num_nodes > node_budget or edges + g.num_edges + g.num_nodes > edge_budget:
            break
        graphs.append(g)
        nodes += g.num_nodes
        edges += g.num_edges + g.num_nodes
    return pack(graphs, 256, node_budget, edge_budget)


def median_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of `fn` over `runs` CUDA-event windows. A spin
    kernel queued ahead of each window keeps the card busy while the
    host enqueues, so host-side wrapper time is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def roofline(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over the
    card's peak for their type (fp32 unless given) and the bytes over
    its HBM rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_bound(n: int, e_live: int, d: int, t: int, with_aggregate: bool):
    """(bound_ms, bound_by) of one fp32 fold GGNN step, from the
    package's work formula (`nn/ggnn_kernel.py:step_work`, the one the
    counted cost reads)."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    return roofline(*gk.step_work(n, e_live, d, t, with_aggregate))


def kernel_phase(torch, rng):
    from deepdfa_tpu_torch.graphs import pack
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    d = 128
    gen = torch.Generator().manual_seed(1)
    cases = {
        "flagship": full_batch(rng, 16384, 65536, 1),
        "etypes3": full_batch(rng, 16384, 65536, 3),
        "all_padding": pack([], 16, 16384, 65536),
    }
    report, worst = {}, 0.0
    timing = None
    for name, batch in cases.items():
        t = 3 if name == "etypes3" else 1
        b = batch.to("cuda")
        n, e = b.node_budget, b.edge_budget
        scale = d ** -0.5
        h = torch.randn(n, d, generator=gen).cuda()
        wm = (torch.randn(t, d, d, generator=gen) * scale).cuda()
        bm = (torch.randn(t, d, generator=gen) * 0.1).cuda()
        wih = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        whh = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        bih = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        bhh = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        params = (wm, bm, wih, whh, bih, bhh)
        edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t)
        e_live = int(b.edge_mask.sum())
        if int(edges.rowptr[-1]) != e_live:
            fail(f"{name}: rowptr[N] {int(edges.rowptr[-1])} != live edges {e_live}")
        with torch.inference_mode():
            h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True)
            h_k2, a_none = gk.ggnn_step(h, edges, *params)
            h_p, a_p = gk.ggnn_step_plain(h, edges, *params)
        torch.cuda.synchronize()
        if a_none is not None:
            fail(f"{name}: aggregate returned without being asked for")
        for what, got, want in (("h", h_k, h_p), ("a", a_k, a_p), ("h_no_a", h_k2, h_p)):
            if not torch.isfinite(got).all():
                fail(f"{name}: kernel {what} has non-finite values")
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                fail(f"{name}: kernel {what} differs from the plain version, max abs err {err}")
            report[f"{name}_{what}_max_abs_err"] = err
        if name == "flagship":
            with torch.inference_mode():
                ms = median_ms(torch, lambda: gk.ggnn_step(h, edges, *params))
                plain_ms = median_ms(torch, lambda: gk.ggnn_step_plain(h, edges, *params))
            bound_ms, bound_by = step_bound(n, e_live, d, t, with_aggregate=False)
            timing = {
                "n": n, "e": e, "e_live": e_live, "d": d, "n_etypes": t,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "blocks": gk.block_sizes(n)[1],
            }
    emit({"phase": "kernel ggnn_step", "ok": True, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report, **timing})
    return worst, timing


def serve_phase(torch, rng):
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import DynamicBatcher, GgnnExecutor, score_graphs

    cfg = load(FLAGSHIP_CONFIG)
    input_dim = cfg.data.feat.input_dim
    model = DeepDFA.from_config(
        cfg.model, input_dim, generator=torch.Generator().manual_seed(0)
    )
    model_cpu = copy.deepcopy(model)
    specs = [
        synthetic_graph(rng, i, int(rng.integers(10, 401)), input_dim)
        for i in range(N_REQUESTS)
    ]
    gk.LAUNCHES = 0
    summary = score_graphs(model, specs, cfg, device="cuda")
    launches = gk.LAUNCHES
    probs = np.asarray(summary.pop("probs"), dtype=np.float64)
    if summary["serve_scored"] != len(specs) or not np.all(np.isfinite(probs)):
        fail(f"serve: {summary['serve_failed_requests']} requests failed or non-finite")
    if not np.all((probs > 0.0) & (probs < 1.0)):
        fail("serve: a probability outside (0, 1)")
    want = summary["serve_batches"] * cfg.model.n_steps
    if summary["ggnn_step_launches"] != want:
        fail(f"serve: {summary['ggnn_step_launches']} kernel launches, "
             f"expected batches x n_steps = {want}")
    # the same model on the CPU, plain path, offline drive
    node_budget = cfg.serve.node_budget or cfg.data.batch.node_budget
    edge_budget = cfg.serve.edge_budget or cfg.data.batch.edge_budget
    cpu = GgnnExecutor(model_cpu, node_budget, edge_budget,
                       cfg.serve.max_batch_graphs, device="cpu")
    ref = np.asarray([r.wait(600) for r in DynamicBatcher(cpu).score_all(specs)])
    err = float(np.abs(probs - ref).max())
    if not np.allclose(probs, ref, rtol=RTOL, atol=ATOL):
        fail(f"serve: probabilities differ from the CPU plain path, max abs err {err}")
    emit({"phase": "serve", "ok": True, "requests": len(specs),
          "kernel_launches": launches, "cpu_max_abs_err": err,
          "node_budget": node_budget, "edge_budget": edge_budget,
          "max_batch_graphs": cfg.serve.max_batch_graphs, **summary})
    return (launches, model, specs, probs, (node_budget, edge_budget),
            cfg.serve.max_batch_graphs)


def profile_phase(torch, model, specs, budgets) -> None:
    """Where one full serving batch's time goes: host stages timed with
    synchronize (median of 10), then one batch under torch.profiler for
    device time by kernel and the device's idle share of the batch."""
    from torch.profiler import ProfilerActivity, profile

    from deepdfa_tpu_torch.serve import GgnnExecutor
    from deepdfa_tpu_torch.serve.batcher import DeviceResult

    ex = GgnnExecutor(model, *budgets, len(specs), device="cuda")
    ex.warmup()
    stages = {"pack_ms": [], "to_device_ms": [], "forward_ms": [], "fetch_ms": [], "batch_ms": []}
    for _ in range(10):
        t0 = time.perf_counter()
        _, (_, batch) = ex.pack_chunk("graph", specs)
        t1 = time.perf_counter()
        b = batch.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            probs = torch.sigmoid(ex.model(b))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ex.fetch(DeviceResult((probs,)), len(specs))
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
            stages[k].append(1e3 * v)
    _, packed = ex.pack_chunk("graph", specs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.fetch(ex.dispatch("graph", packed), len(specs))
        profiled_ms = 1e3 * (time.perf_counter() - t0)

    emit({"phase": "profile", "graphs": len(specs),
          **{k: statistics.median(v) for k, v in stages.items()},
          **device_profile(prof, profiled_ms)})


def device_profile(prof, window_ms: float) -> dict:
    """Device busy time, idle share of the window and the top kernels
    by device time, from a torch.profiler run over that window."""

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels and copies only: an operator's own row and a user-annotated
    # range (the optimizer's step) repeat their kernels' time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {"profiled_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / window_ms) if window_ms > 0 else None,
            "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top},
            "top_device_calls": {e.key[:60]: e.count for e in top}}


def gru_bwd_bound(n: int, d: int):
    """(bound_ms, bound_by) of B3 (`nn/ggnn_kernel.py:gru_bwd_work`)."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    return roofline(*gk.gru_bwd_work(n, d))


def dmsg_bound(n: int, e_live: int, d: int, t: int, add: bool = False):
    """(bound_ms, bound_by) of B4 (`nn/ggnn_kernel.py:dmsg_work`)."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    return roofline(*gk.dmsg_work(n, e_live, d, t, add))


def launch_split(torch, fn, calls: int = 10) -> dict:
    """{kernel: {"ms", "launches"}} a call of `fn`: the device time and
    launches of each kernel it runs (copies too), from torch.profiler over
    `calls` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and us > 0 and \
                not getattr(e, "is_user_annotation", False):
            out[e.key[:70]] = {"ms": us / 1e3 / calls, "launches": e.count / calls}
    return out


def bwd_kernel_phase(torch, rng):
    """B3 and B4 against their plain versions at the flagship, T = 3
    and all-padding batches, B4 alone (dh_msg) and added into B3's dh
    (dh_added, step_bwd's call); timings at the flagship batch beside the
    first designs' (GRU_BWD_BASELINE_MS, DMSG_BASELINE_MS: B4's `ms` is
    the call into dh, `fresh_ms` alone, `fresh_add_ms` alone plus the
    separate add that step_bwd made before B4 added into dh), and each
    kernel's device time split by launch on a line of its own before the
    phase's lines."""
    from deepdfa_tpu_torch.graphs import pack
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    d = 128
    gen = torch.Generator().manual_seed(2)
    cases = {
        "flagship": full_batch(rng, 16384, 65536, 1),
        "etypes3": full_batch(rng, 16384, 65536, 3),
        "all_padding": pack([], 16, 16384, 65536),
    }
    names = ("da", "dh", "dwih", "dwhh", "dbih", "dbhh")
    reports = {"ggnn_gru_bwd": {}, "ggnn_dmsg": {}}
    worst = {"ggnn_gru_bwd": 0.0, "ggnn_dmsg": 0.0}
    timing = {}
    for name, batch in cases.items():
        t = 3 if name == "etypes3" else 1
        b = batch.to("cuda")
        n = b.node_budget
        scale = d ** -0.5
        h, a = (torch.randn(n, d, generator=gen).cuda() for _ in range(2))
        g = (torch.randn(n, d, generator=gen) * 1e-2).cuda()
        wm = (torch.randn(t, d, d, generator=gen) * scale).cuda()
        wih = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        whh = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        bih = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        bhh = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        gru = (wih, whh, bih, bhh)
        edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t,
                                 transpose=True)
        e_live = int(b.edge_mask.sum())
        if int(edges.srcptr[-1]) != e_live:
            fail(f"{name}: srcptr[N] {int(edges.srcptr[-1])} != live edges {e_live}")
        with torch.inference_mode():
            got = gk.gru_bwd(h, a, *gru, g)
            want = gk.gru_bwd_plain(h, a, *gru, g)
            got_msg = gk.dmsg(a, edges, wm)
            want_msg = gk.dmsg_plain(a, edges, wm)
            got_add = gk.dmsg(a, edges, wm, got[1].clone())
            want_add = gk.dmsg_plain(a, edges, wm, got[1].clone())
            again = (gk.gru_bwd(h, a, *gru, g), gk.dmsg(a, edges, wm),
                     gk.dmsg(a, edges, wm, got[1].clone()))
        torch.cuda.synchronize()
        checks = [("ggnn_gru_bwd", k, x, y) for k, x, y in zip(names, got, want)]
        checks += [("ggnn_dmsg", "dh_msg", got_msg, want_msg),
                   ("ggnn_dmsg", "dh_added", got_add, want_add)]
        for kernel, what, x, y in checks:
            if not torch.isfinite(x).all():
                fail(f"{name}: {kernel} {what} has non-finite values")
            err = (x - y).abs().max().item()
            # parameter cotangents sum over every node: atol scales with them
            atol = ATOL * max(1.0, y.abs().max().item()) if what.startswith("dw") or \
                what.startswith("db") else ATOL
            if not torch.allclose(x, y, rtol=RTOL, atol=atol):
                fail(f"{name}: {kernel} {what} differs from the plain version, max abs err {err}")
            worst[kernel] = max(worst[kernel], err)
            reports[kernel][f"{name}_{what}_max_abs_err"] = err
        if not (all(torch.equal(x, y) for x, y in zip(got, again[0]))
                and torch.equal(got_msg, again[1]) and torch.equal(got_add, again[2])):
            fail(f"{name}: a backward kernel gave other bits on a rerun")
        if name == "flagship":
            with torch.inference_mode():
                timing["ggnn_gru_bwd"] = {
                    "ms": median_ms(torch, lambda: gk.gru_bwd(h, a, *gru, g)),
                    "plain_ms": median_ms(torch, lambda: gk.gru_bwd_plain(h, a, *gru, g)),
                    **dict(zip(("bound_ms", "bound_by"), gru_bwd_bound(n, d))),
                }
                base = GRU_BWD_BASELINE_MS["ggnn_gru_bwd"]
                timing["ggnn_gru_bwd"].update(
                    baseline_ms=base, baseline_over_ms=base / timing["ggnn_gru_bwd"]["ms"])
                split = launch_split(torch, lambda: gk.gru_bwd(h, a, *gru, g))
                # B4 adds into a dh of its own here: the values grow over
                # the runs, the work does not
                dh = got[1].clone()
                fresh = median_ms(torch, lambda: gk.dmsg(a, edges, wm))
                timing["ggnn_dmsg"] = {
                    "ms": median_ms(torch, lambda: gk.dmsg(a, edges, wm, dh)),
                    "plain_ms": median_ms(torch, lambda: gk.dmsg_plain(a, edges, wm, dh)),
                    **dict(zip(("bound_ms", "bound_by"),
                               dmsg_bound(n, e_live, d, t, add=True))),
                    "fresh_ms": fresh,
                    "fresh_add_ms": median_ms(torch, lambda: dh + gk.dmsg(a, edges, wm)),
                    "fresh_bound_ms": dmsg_bound(n, e_live, d, t)[0],
                    "baseline_ms": DMSG_BASELINE_MS["ggnn_dmsg"],
                    "baseline_over_fresh_ms": DMSG_BASELINE_MS["ggnn_dmsg"] / fresh,
                }
                msg_split = launch_split(torch, lambda: gk.dmsg(a, edges, wm, dh))
            shape = {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d, "n_etypes": t}
    emit({"phase": "kernel ggnn_gru_bwd launches", **shape, "device_ms_by_launch": split,
          "device_ms": sum(x["ms"] for x in split.values())})
    emit({"phase": "kernel ggnn_dmsg launches", **shape, "added_into_dh": True,
          "device_ms_by_launch": msg_split,
          "device_ms": sum(x["ms"] for x in msg_split.values())})
    for kernel in reports:
        emit({"phase": f"kernel {kernel}", "ok": True, "rtol": RTOL, "atol": ATOL,
              "max_abs_err": worst[kernel], **reports[kernel], **shape, **timing[kernel],
              **({"weight_pass_splits": gk._library("ggnn_bwd").ggnn_gru_bwd_splits(
                  shape["n"], shape["d"])} if kernel == "ggnn_gru_bwd" else {})})
    return worst, timing


def train_batches(cfg, rng):
    """TRAIN_BATCHES fixed batches packed by the bucket planner from
    seeded labelled graphs of 10-400 nodes."""
    from deepdfa_tpu_torch.graphs import shard_bucket_batches

    bcfg = cfg.data.batch
    specs, nodes = [], 0
    while nodes < TRAIN_BATCHES * bcfg.node_budget * 0.97:
        g = synthetic_graph(rng, len(specs), int(rng.integers(10, 401)),
                            cfg.data.feat.input_dim, signal=True)
        specs.append(g)
        nodes += g.num_nodes
    batches = list(shard_bucket_batches(specs, bcfg.graphs_per_batch, bcfg.node_budget,
                                        bcfg.edge_budget))[:TRAIN_BATCHES]
    if len(batches) < TRAIN_BATCHES:
        fail(f"train: packed {len(batches)} batches, need {TRAIN_BATCHES}")
    return specs, batches


def leaf_errors(got: dict, want: dict) -> dict:
    """max |got - want| / max |want| per parameter; each scale floored at
    1e-3 of the largest gradient (the gate's bias gradient vanishes)."""
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    return {k: (got[k] - w).abs().max().item() / max(w.abs().max().item(), floor)
            for k, w in want.items()}


def train_phase(torch, rng):
    """The training main path through GraphTrainer.fit on the card, its
    checks, a CPU cross-check and a per-step time split."""
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = load(FLAGSHIP_CONFIG)
    input_dim = cfg.data.feat.input_dim
    n_steps = cfg.model.n_steps
    specs, batches = train_batches(cfg, rng)
    graphs = [int(b.graph_mask.sum()) for b in batches]
    model = DeepDFA.from_config(cfg.model, input_dim)
    trainer = GraphTrainer(model, cfg, device="cuda")
    state = trainer.init_state(seed=0)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    records = []

    gk.LAUNCHES = gk.GRU_BWD_LAUNCHES = gk.DMSG_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                max_epochs=TRAIN_EPOCHS, log_fn=records.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"ggnn_step": gk.LAUNCHES, "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES,
                "ggnn_dmsg": gk.DMSG_LAUNCHES}
    epochs = [r for r in records if "epoch" in r]
    want = {"ggnn_step": (steps + TRAIN_EPOCHS) * n_steps,  # + one eval batch an epoch
            "ggnn_gru_bwd": steps * n_steps, "ggnn_dmsg": steps * n_steps}
    if launches != want:
        fail(f"train: kernel launches {launches}, expected {want}")
    losses = [r["train_loss"] for r in epochs]
    if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
        fail(f"train: a non-finite loss in {epochs}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: epoch means {losses}")

    # two backward passes on one batch: the same bits
    b0 = batches[0].to(trainer.device)

    def grads():
        trainer.forward_loss(state, b0).backward()
        return {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail("train: two backward passes on one batch gave other gradients")

    # the first CPU_STEPS steps on the CPU plain path against the card
    cpu_model = DeepDFA.from_config(cfg.model, input_dim)
    cpu = GraphTrainer(cpu_model, cfg, device="cpu")
    cpu_state = cpu.init_state(params=init)
    card = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device="cuda")
    card_state = card.init_state(params=init)
    loss_pairs, grad_err = [], None
    for i in range(CPU_STEPS):
        pair = []
        for tr, st in ((card, card_state), (cpu, cpu_state)):
            loss = tr.forward_loss(st, batches[i].to(tr.device))
            loss.backward()
            pair.append((loss.item(), {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}))
            st.apply_gradients()
        loss_pairs.append((pair[0][0], pair[1][0]))
        if i == 0:
            grad_err = max(leaf_errors(pair[0][1], pair[1][1]).values())
    loss_err = max(abs(a - b) / abs(b) for a, b in loss_pairs)
    if loss_err > 1e-4 or grad_err > 1e-4:
        fail(f"train: card vs CPU losses {loss_pairs} (rel {loss_err}), step-1 "
             f"gradient rel err {grad_err}")

    # where a step's time goes: median of 10, synchronized at each stage
    from deepdfa_tpu_torch.graphs import shard_bucket_batches

    bcfg = cfg.data.batch
    split = {"host_pack_ms": [], "to_device_ms": [], "forward_ms": [], "backward_ms": [],
             "optimizer_ms": [], "step_ms": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        t_a = time.perf_counter()
        batch = next(iter(shard_bucket_batches(specs, bcfg.graphs_per_batch,
                                               bcfg.node_budget, bcfg.edge_budget)))
        t_b = time.perf_counter()
        batch = batch.to(trainer.device)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        loss = trainer.forward_loss(state, batch)
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t_f = time.perf_counter()
        for k, v in zip(split, (t_b - t_a, t_c - t_b, t_d - t_c, t_e - t_d, t_f - t_e, t_f - t_a)):
            split[k].append(1e3 * v)
    med = {k: statistics.median(v) for k, v in split.items()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    emit({"phase": "train", "ok": True, "steps": steps, "epochs": TRAIN_EPOCHS,
          "graphs_per_batch": graphs, "node_budget": bcfg.node_budget,
          "edge_budget": bcfg.edge_budget, "epoch_train_loss": losses,
          "epoch_val_loss": [r["val_loss"] for r in epochs],
          "kernel_launches": launches, "grads_bit_equal": True,
          "cpu_losses": loss_pairs, "cpu_loss_rel_err": loss_err,
          "cpu_step1_grad_rel_err": grad_err, "fit_seconds": fit_s,
          "fit_graphs_per_sec": sum(graphs) * TRAIN_EPOCHS / fit_s, **med,
          "graphs_per_sec": graphs[0] / (med["step_ms"] / 1e3),
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
          "profiled_step": {**device_profile(prof, profiled_ms),
                            "device_ms_by_group": device_groups(prof)}})
    return launches


# ---------------------------------------------------------------------------
# kernel 1's bf16/int8 instances, kernel 2 (the whole unroll) and the
# GGNN paths under the message policies and the fused unroll

#: the serving and training paths under ggnn_kernel=true: (accum, unroll)
SERVE_VARIANTS = {"serve_bf16": ("bf16", "per_step"), "serve_fused": ("fp32", "fused"),
                  "serve_int8": ("int8", "per_step"), "serve_int8_fused": ("int8", "fused")}
TRAIN_VARIANTS = {"train_fused": ("fp32", "fused"), "train_bf16": ("bf16", "per_step")}
#: the step counter of each policy and the kernels-line row it feeds
POLICY_ROWS = {"fp32": ("LAUNCHES", "ggnn_step"), "bf16": ("BF16_LAUNCHES", "ggnn_step_bf16"),
               "int8": ("INT8_LAUNCHES", "ggnn_step_int8")}
#: bf16/int8 scores against the fp32 scores, of their scale (the
#: reference's INT8_DRIFT_BOUND, and its bf16 rung)
POLICY_SCORE_TOL = 5e-2
FUSED_STEPS = 5


def variant_config(cfg, accum: str, unroll: str, scatter: str = "auto"):
    from deepdfa_tpu_torch.core import apply_overrides

    return apply_overrides(cfg, ["model.ggnn_kernel=true", f'model.ggnn_kernel_accum="{accum}"',
                                 f'model.ggnn_kernel_unroll="{unroll}"',
                                 f'model.ggnn_kernel_scatter="{scatter}"'])


def ggnn_case(torch, gen, batch, t: int, d: int = 128):
    """(batch on the card, edges, h, the six step weights) from seeded
    normal draws, as kernel_phase draws them."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    b = batch.to(CARD)
    n = b.node_budget
    scale = d ** -0.5
    h = torch.randn(n, d, generator=gen).to(CARD)
    params = [(torch.randn(*shape, generator=gen) * sc).to(CARD) for shape, sc in (
        ((t, d, d), scale), ((t, d), 0.1), ((d, 3 * d), scale), ((d, 3 * d), scale),
        ((3 * d,), 0.1), ((3 * d,), 0.1))]
    edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t)
    return b, edges, h, params


def ggnn_cases(rng) -> dict:
    from deepdfa_tpu_torch.graphs import pack

    return {"flagship": (full_batch(rng, 16384, 65536, 1), 1),
            "etypes3": (full_batch(rng, 16384, 65536, 3), 3),
            "all_padding": (pack([], 16, 16384, 65536), 1)}


def policy_step_bound(n: int, e_live: int, d: int, t: int, accum: str):
    """step_bound without the aggregate, with Wm in the policy's type
    (`nn/ggnn_kernel.py:policy_step_work`)."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    return roofline(*gk.policy_step_work(n, e_live, d, t, accum))


def fused_bound(n: int, e_live: int, d: int, t: int, accum: str, n_steps: int, chain: bool):
    """(bound_ms, bound_by) of kernel 2 (`nn/ggnn_kernel.py:fused_work`)."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    return roofline(*gk.fused_work(n, e_live, d, t, accum, n_steps, chain))


def step_check(torch, what: str, got, want) -> float:
    """got vs want at rtol/atol; the max abs error."""
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"{what}: differs from the plain version, max abs err {err}")
    return err


def policy_kernel_phase(torch, rng):
    """Kernel 1's bf16 and int8 instances against the plain version of
    the same policy on the card, at the flagship, T = 3 and all-padding
    batches; the same bits on a rerun; times at the flagship batch."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(3)
    report, worst, timing = {}, {"bf16": 0.0, "int8": 0.0}, {}
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        for accum in ("bf16", "int8"):
            with torch.inference_mode():
                h_k, a_k = gk.ggnn_step(h, edges, *params, accum=accum, with_aggregate=True)
                h_p, a_p = gk.ggnn_step_plain(h, edges, *params, accum)
                again, _ = gk.ggnn_step(h, edges, *params, accum=accum)
                _, a32 = gk.ggnn_step(h, edges, *params, with_aggregate=True)
            torch.cuda.synchronize()
            for what, got, want in (("h", h_k, h_p), ("a", a_k, a_p)):
                err = step_check(torch, f"{name} {accum} step {what}", got, want)
                worst[accum] = max(worst[accum], err)
                report[f"{accum}_{name}_{what}_max_abs_err"] = err
            if not torch.equal(again, h_k):
                fail(f"{name}: the {accum} step gave other bits on a rerun")
            if name != "all_padding" and torch.equal(a_k, a32):
                fail(f"{name}: the {accum} aggregate equals the fp32 one (policy not engaged)")
            report[f"{accum}_{name}_a_vs_fp32_max_abs"] = (a_k - a32).abs().max().item()
            if name == "flagship":
                with torch.inference_mode():
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_step(h, edges, *params, accum=accum)),
                        "plain_ms": median_ms(
                            torch, lambda: gk.ggnn_step_plain(h, edges, *params, accum)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   policy_step_bound(n, e_live, d, t, accum))),
                        "shape": {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d,
                                  "n_etypes": t},
                    }
    emit({"phase": "kernel ggnn_step_policy", "ok": True, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report, "timing": timing})
    return worst, timing


def fused_grid(torch, gk, accum: str, scatter: str, n: int, d: int) -> dict:
    """Kernel 2's blocks an SM and the cooperative grid it launches at n
    nodes (at most one block a tile); nothing off the card."""
    if CARD != "cuda":
        return {}
    per_sm = gk.fused_blocks_per_sm(accum, scatter, d, torch.device(CARD))
    sms = torch.cuda.get_device_properties(CARD).multi_processor_count
    return {"blocks_per_sm": per_sm, "grid": min(-(-n // gk.NODE_TILE), per_sm * sms)}


def fused_kernel_phase(torch, rng):
    """Kernel 2 at the flagship, T = 3 and all-padding batches under each
    policy: h_out, with and without the chain, and every chain plane the
    bits of FUSED_STEPS launches of kernel 1, the same bits on a repeat;
    each of its steps against the plain step of the same policy from that
    step's input (its chain plane) at rtol/atol. Five plain steps from
    the first input are not compared: a bf16 rounding or an int8 quantum
    of a state element near its boundary can flip between two fp32
    summation orders and spread. Times at the flagship batch beside the
    FUSED_STEPS step launches, one step in one launch, and the bound."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(4)
    report, worst, timing = {}, 0.0, {}
    S = FUSED_STEPS
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        for accum in ("fp32", "bf16", "int8"):
            with torch.inference_mode():
                states = [h]
                for _ in range(S):
                    states.append(gk.ggnn_step(states[-1], edges, *params, accum=accum)[0])
                h_f, chain = gk.ggnn_fused(h, edges, *params, n_steps=S, accum=accum,
                                           with_chain=True)
                h_nc, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, accum=accum)
                h_again, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, accum=accum)
                # the plain step from each of the kernel's own step inputs
                plain = [gk.ggnn_step_plain(chain[s], edges, *params, accum)[0]
                         for s in range(S)]
            torch.cuda.synchronize()
            if not (torch.equal(h_f, states[-1]) and torch.equal(h_nc, h_f)):
                fail(f"{name} {accum}: the fused kernel's h_out differs from {S} step launches")
            if not all(torch.equal(chain[s], states[s]) for s in range(S)):
                fail(f"{name} {accum}: the fused kernel's chain differs from the step inputs")
            if not torch.equal(h_again, h_f):
                fail(f"{name} {accum}: the fused kernel gave other bits on a repeat")
            outs = [*chain[1:], h_f]
            err = max(step_check(torch, f"{name} {accum} fused step {s}", outs[s], plain[s])
                      for s in range(S))
            worst = max(worst, err)
            report[f"{accum}_{name}_max_abs_err"] = err
            if name == "flagship":
                def steps(accum=accum):
                    x = h
                    for _ in range(S):
                        x = gk.ggnn_step(x, edges, *params, accum=accum)[0]

                with torch.inference_mode():
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, accum=accum)),
                        "chain_ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, accum=accum, with_chain=True)),
                        "step_launches_ms": median_ms(torch, steps),
                        "plain_ms": median_ms(torch, lambda: gk.ggnn_fused_plain(
                            h, edges, *params, n_steps=S, accum=accum)),
                        # one step in one cooperative launch, beside one launch of kernel 1
                        "one_step_ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=1, accum=accum)),
                        "one_step_launch_ms": median_ms(torch, lambda: gk.ggnn_step(
                            h, edges, *params, accum=accum)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   fused_bound(n, e_live, d, t, accum, S, False))),
                        "chain_bound_ms": fused_bound(n, e_live, d, t, accum, S, True)[0],
                        "residency_bytes": gk.fused_residency_bytes(n, d, accum, S),
                        **fused_grid(torch, gk, accum, "fold", n, d),
                    }
    emit({"phase": "kernel ggnn_fused", "ok": True, "n_steps": S, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report,
          "l2_budget_bytes": gk.fused_budget_bytes(torch.device(CARD)), "timing": timing})
    return worst, timing


def serve_variants_phase(torch, model, specs, fp32_probs):
    """score_graphs of the serve phase's model and requests under each
    SERVE_VARIANTS entry (ggnn_kernel=true), each path's launches counted
    from 0: every request scored, no fused fallback, the variant's kernel
    n_steps times (or once, fused) per batch, scores within
    POLICY_SCORE_TOL of scale of the fp32 scores; then the same requests
    offline (fixed batches): fused scores the bits of per-step scores of
    the same policy."""
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import DynamicBatcher, GgnnExecutor, score_graphs
    from deepdfa_tpu_torch.serve.driver import SUMMARY_KEYS

    cfg = load(FLAGSHIP_CONFIG)
    node_budget = cfg.serve.node_budget or cfg.data.batch.node_budget
    edge_budget = cfg.serve.edge_budget or cfg.data.batch.edge_budget
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def offline(m):
        ex = GgnnExecutor(m, node_budget, edge_budget, cfg.serve.max_batch_graphs, device=CARD)
        return np.asarray([r.wait(600) for r in DynamicBatcher(ex).score_all(specs)])

    fixed = {("fp32", "per_step"): offline(model)}
    paths, online = {}, {}
    for path, (accum, unroll) in SERVE_VARIANTS.items():
        vcfg = variant_config(cfg, accum, unroll)
        vmodel = DeepDFA.from_config(vcfg.model, cfg.data.feat.input_dim)
        vmodel.load_state_dict(weights)
        gk.reset_launch_counts()
        summary = score_graphs(vmodel, specs, vcfg, device=CARD)
        counts = gk.launch_counts()
        probs = np.asarray(summary.pop("probs"), dtype=np.float64)
        if summary["serve_scored"] != len(specs) or not np.all(np.isfinite(probs)):
            fail(f"{path}: {summary['serve_failed_requests']} requests failed or non-finite")
        if counts["FUSED_FALLBACKS"]:
            fail(f"{path}: {counts['FUSED_FALLBACKS']} fused unrolls fell back to per step")
        # the summary counts the scoring window, `counts` the warm-up too
        scored = {k: v for k, v in summary.items() if k.startswith("ggnn_")}
        counter, row = ("FUSED_LAUNCHES", "ggnn_fused") if unroll == "fused" else \
            POLICY_ROWS[accum]
        key = SUMMARY_KEYS[counter]
        want = summary["serve_batches"] * (1 if unroll == "fused" else cfg.model.n_steps)
        if scored[key] != want or any(v for k, v in scored.items() if k != key):
            fail(f"{path}: launches {scored}, expected {key} = {want} and no other")
        drift = float(np.abs(probs - fp32_probs).max()) / float(np.abs(fp32_probs).max())
        if drift > POLICY_SCORE_TOL or (accum != "fp32" and drift == 0.0):
            fail(f"{path}: scores {drift} of scale from the fp32 scores (limit "
                 f"{POLICY_SCORE_TOL}, and a policy must move them)")
        fixed[accum, unroll] = offline(vmodel)
        online[accum, unroll] = probs
        paths[path] = {row: counts[counter]}
        emit({"phase": path, "ok": True, "accum": accum, "unroll": unroll,
              "requests": len(specs), "launches": counts, "score_drift_vs_fp32": drift,
              **summary})
    for accum in ("fp32", "int8"):
        if not np.array_equal(fixed[accum, "fused"], fixed[accum, "per_step"]):
            fail(f"serve {accum}: fused scores differ from per-step scores on fixed batches")
    emit({"phase": "serve_variants", "ok": True, "fused_bit_equal_per_step": ["fp32", "int8"],
          "offline_drift_vs_fp32": {f"{a}_{u}": float(np.abs(p - fixed["fp32", "per_step"]).max())
                                    for (a, u), p in fixed.items()}})
    return paths, online


def train_variants_phase(torch, rng):
    """GraphTrainer.fit under each TRAIN_VARIANTS entry (ggnn_kernel=true)
    on the train phase's kind of batches, 20 AdamW steps, launches
    counted from 0: losses finite and falling, each kernel's launches as
    the unroll implies; step-1 gradients of the fused unroll the bits of
    the per-step one of the same policy on one batch; median step ms of
    train_step on batches already on the card, and of the fp32 per-step
    model the same way (the train phase's step_ms counts host packing
    and copies too)."""
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = load(FLAGSHIP_CONFIG)
    input_dim, n_steps = cfg.data.feat.input_dim, cfg.model.n_steps
    _, batches = train_batches(cfg, rng)
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    on_card = [b.to(CARD) for b in batches]

    def step_ms(trainer, state) -> float:
        times = []
        for i in range(10):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            trainer.train_step(state, on_card[i % TRAIN_BATCHES])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t_a))
        return statistics.median(times)

    base = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device=CARD)
    base_ms = step_ms(base, base.init_state(seed=0))
    del base
    paths = {}
    for path, (accum, unroll) in TRAIN_VARIANTS.items():
        vcfg = variant_config(cfg, accum, unroll)
        model = DeepDFA.from_config(vcfg.model, input_dim)
        trainer = GraphTrainer(model, vcfg, device=CARD)
        state = trainer.init_state(seed=0)
        init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        records = []
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                    max_epochs=TRAIN_EPOCHS, log_fn=records.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = gk.launch_counts()
        step_counter, step_row = POLICY_ROWS[accum]
        evals = TRAIN_EPOCHS  # one eval batch an epoch
        if unroll == "fused":
            # the forward: one launch with the chain a step, one without an
            # eval batch; the backward recomputes each step's aggregate
            want = {"FUSED_LAUNCHES": steps + evals, "FUSED_CHAIN_LAUNCHES": steps,
                    step_counter: steps * n_steps}
            launched = {"ggnn_fused": counts["FUSED_LAUNCHES"], step_row: counts[step_counter]}
        else:
            want = {step_counter: (steps + evals) * n_steps}
            launched = {step_row: counts[step_counter]}
        want |= {"GRU_BWD_LAUNCHES": steps * n_steps, "DMSG_LAUNCHES": steps * n_steps}
        if any(counts[k] != v for k, v in want.items()) or counts["FUSED_FALLBACKS"]:
            fail(f"{path}: kernel launches {counts}, expected {want}")
        launched |= {"ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"],
                     "ggnn_dmsg": counts["DMSG_LAUNCHES"]}
        epochs = [r for r in records if "epoch" in r]
        losses = [r["train_loss"] for r in epochs]
        if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
            fail(f"{path}: a non-finite loss in {epochs}")
        if not losses[-1] < losses[0]:
            fail(f"{path}: the loss did not fall: epoch means {losses}")
        report = {}
        if unroll == "fused":
            b0 = batches[0].to(CARD)
            grads = {}
            for u in ("per_step", "fused"):
                m = DeepDFA.from_config(variant_config(cfg, accum, u).model, input_dim)
                tr = GraphTrainer(m, variant_config(cfg, accum, u), device=CARD)
                st = tr.init_state(params=init)
                loss = tr.forward_loss(st, b0)
                loss.backward()
                grads[u] = {"loss": loss.detach()} | {
                    k: p.grad.detach().clone() for k, p in m.named_parameters()}
            if not all(torch.equal(grads["fused"][k], g) for k, g in grads["per_step"].items()):
                fail(f"{path}: step-1 gradients of the fused unroll differ from per-step")
            report["step1_grads_bit_equal_per_step"] = True
        paths[path] = launched
        emit({"phase": path, "ok": True, "accum": accum, "unroll": unroll, "steps": steps,
              "epoch_train_loss": losses, "epoch_val_loss": [r["val_loss"] for r in epochs],
              "launches": counts, "fit_seconds": fit_s, "step_ms": step_ms(trainer, state),
              "fp32_per_step_step_ms": base_ms, **report})
    return paths


# ---------------------------------------------------------------------------
# the mxu scatter of kernels 1 and 2, and the tune entry point

#: kernel 1's mxu instances: the counter of each policy and its row
MXU_ROWS = {"fp32": ("MXU_LAUNCHES", "ggnn_step_mxu"),
            "bf16": ("MXU_BF16_LAUNCHES", "ggnn_step_mxu_bf16"),
            "int8": ("MXU_INT8_LAUNCHES", "ggnn_step_mxu_int8")}
#: every GGNN kernel row of the kernels line and its counter
GGNN_ROWS = {"ggnn_step": "LAUNCHES", "ggnn_step_bf16": "BF16_LAUNCHES",
             "ggnn_step_int8": "INT8_LAUNCHES", **{r: c for c, r in MXU_ROWS.values()},
             "ggnn_fused": "FUSED_LAUNCHES", "ggnn_fused_mxu": "FUSED_MXU_LAUNCHES",
             "ggnn_gru_bwd": "GRU_BWD_LAUNCHES", "ggnn_dmsg": "DMSG_LAUNCHES"}
SERVE_MXU = {"serve_mxu": ("fp32", "per_step"), "serve_mxu_int8": ("int8", "per_step"),
             "serve_mxu_int8_fused": ("int8", "fused")}
MXU_BLOCK = 512  # the reference's default edge block
MXU_INT8_BLOCKS = (128, 1024)  # int8 at other blocks: other numbers
#: the card's peak for the message products of each policy (fp32 FMA,
#: bf16 and int8 on the tensor cores); the GRU stays fp32
MSG_PEAK = {"fp32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_FLOPS, "int8": 1979e12}


def mxu_bound(n: int, e_live: int, d: int, t: int, accum: str, n_steps: int = 1,
              chain: bool = False):
    """(bound_ms, bound_by) of n_steps mxu steps (`nn/ggnn_kernel.py:
    mxu_work`): the messages' products at the policy's peak (MSG_PEAK),
    the GRU's and the sums' at the fp32 peak, against its bytes."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    msg, other, nbytes = gk.mxu_work(n, e_live, d, t, accum, n_steps, chain)
    t_ops = (msg / MSG_PEAK[accum] + other / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mxu_kernel_phase(torch, rng):
    """Kernel 1's mxu instances against the plain mxu of the same policy
    on the card at the three batches of phase 3 (fp32 rtol/atol: the
    plain matmuls sum the message products in another order; int8's
    products and quanta are exact), int8 also at edge blocks 128 and 1024
    on the flagship batch, each against its own plain version and not
    equal to block 512's; the same bits on a rerun; int8 mxu not equal to
    int8 fold; times at the flagship batch."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(5)
    report, worst, timing = {}, dict.fromkeys(MXU_ROWS, 0.0), {}
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        aggs = {}
        for accum in MXU_ROWS:
            blocks = (MXU_BLOCK, *MXU_INT8_BLOCKS) if accum == "int8" and name == "flagship" \
                else (MXU_BLOCK,)
            for be in blocks:
                kw = dict(accum=accum, scatter="mxu", block_e=be)
                with torch.inference_mode():
                    h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True, **kw)
                    h_p, a_p = gk.ggnn_step_plain(h, edges, *params, accum, "mxu", be)
                    again, _ = gk.ggnn_step(h, edges, *params, **kw)
                torch.cuda.synchronize()
                for what, got, want in (("h", h_k, h_p), ("a", a_k, a_p)):
                    err = step_check(torch, f"{name} mxu {accum} be{be} step {what}", got, want)
                    worst[accum] = max(worst[accum], err)
                    report[f"{accum}_be{be}_{name}_{what}_max_abs_err"] = err
                if not torch.equal(again, h_k):
                    fail(f"{name}: the mxu {accum} step gave other bits on a rerun")
                aggs[accum, be] = a_k
            if accum == "int8" and name != "all_padding":
                with torch.inference_mode():
                    _, a_fold = gk.ggnn_step(h, edges, *params, accum="int8", with_aggregate=True)
                if torch.equal(a_fold, aggs["int8", MXU_BLOCK]):
                    fail(f"{name}: the int8 mxu aggregate equals the int8 fold one")
                report[f"int8_{name}_mxu_vs_fold_max_abs"] = \
                    (a_fold - aggs["int8", MXU_BLOCK]).abs().max().item()
            if name == "flagship":
                with torch.inference_mode():
                    kw = dict(accum=accum, scatter="mxu", block_e=MXU_BLOCK)
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_step(h, edges, *params, **kw)),
                        "plain_ms": median_ms(torch, lambda: gk.ggnn_step_plain(
                            h, edges, *params, accum, "mxu", MXU_BLOCK)),
                        "fold_ms": median_ms(torch, lambda: gk.ggnn_step(
                            h, edges, *params, accum=accum)),
                        **dict(zip(("bound_ms", "bound_by"), mxu_bound(n, e_live, d, t, accum))),
                        "shape": {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d,
                                  "n_etypes": t, "block_e": MXU_BLOCK},
                    }
                    if accum == "int8":  # the quantizing table, the pre-pass, the step
                        timing[accum]["launch_split"] = launch_split(
                            torch, lambda: gk.ggnn_step(h, edges, *params, **kw))
        if name == "flagship":
            for be in MXU_INT8_BLOCKS:
                if torch.equal(aggs["int8", be], aggs["int8", MXU_BLOCK]):
                    fail(f"flagship: the int8 mxu aggregate at block {be} equals block "
                         f"{MXU_BLOCK}'s")
                report[f"int8_be{be}_vs_be{MXU_BLOCK}_max_abs"] = \
                    (aggs["int8", be] - aggs["int8", MXU_BLOCK]).abs().max().item()
    emit({"phase": "kernel ggnn_step_mxu", "ok": True, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report, "timing": timing})
    return worst, timing


def mxu_fused_kernel_phase(torch, rng):
    """Kernel 2's mxu instances at the three batches under each policy:
    h_out, with and without the chain, and every chain plane the bits of
    FUSED_STEPS launches of kernel 1's mxu instance, the same bits on a
    repeat; each step against the plain mxu step from that step's input
    (fused_kernel_phase's rule); times at the flagship batch and
    the residency against the card's L2."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(6)
    report, worst, timing = {}, 0.0, {}
    S = FUSED_STEPS
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        for accum in MXU_ROWS:
            kw = dict(accum=accum, scatter="mxu", block_e=MXU_BLOCK)
            with torch.inference_mode():
                states = [h]
                for _ in range(S):
                    states.append(gk.ggnn_step(states[-1], edges, *params, **kw)[0])
                h_f, chain = gk.ggnn_fused(h, edges, *params, n_steps=S, with_chain=True, **kw)
                h_nc, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, **kw)
                h_again, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, **kw)
                plain = [gk.ggnn_step_plain(chain[s], edges, *params, accum, "mxu", MXU_BLOCK)[0]
                         for s in range(S)]
            torch.cuda.synchronize()
            if not (torch.equal(h_f, states[-1]) and torch.equal(h_nc, h_f)):
                fail(f"{name} mxu {accum}: kernel 2's h_out differs from {S} step launches")
            if not all(torch.equal(chain[s], states[s]) for s in range(S)):
                fail(f"{name} mxu {accum}: kernel 2's chain differs from the step inputs")
            if not torch.equal(h_again, h_f):
                fail(f"{name} mxu {accum}: kernel 2 gave other bits on a repeat")
            outs = [*chain[1:], h_f]
            err = max(step_check(torch, f"{name} mxu {accum} fused step {s}", outs[s], plain[s])
                      for s in range(S))
            worst = max(worst, err)
            report[f"{accum}_{name}_max_abs_err"] = err
            if name == "flagship":
                def steps(kw=kw):
                    x = h
                    for _ in range(S):
                        x = gk.ggnn_step(x, edges, *params, **kw)[0]

                with torch.inference_mode():
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, **kw)),
                        "chain_ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, with_chain=True, **kw)),
                        "step_launches_ms": median_ms(torch, steps),
                        "plain_ms": median_ms(torch, lambda: gk.ggnn_fused_plain(
                            h, edges, *params, n_steps=S, **kw)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   mxu_bound(n, e_live, d, t, accum, S))),
                        "chain_bound_ms": mxu_bound(n, e_live, d, t, accum, S, True)[0],
                        "residency_bytes": gk.fused_residency_bytes(
                            n, d, accum, S, scatter="mxu", n_eb=b.edge_budget // MXU_BLOCK,
                            n_etypes=t),
                        **fused_grid(torch, gk, accum, "mxu", n, d),
                    }
    emit({"phase": "kernel ggnn_fused_mxu", "ok": True, "n_steps": S, "rtol": RTOL,
          "atol": ATOL, "max_abs_err": worst, **report,
          "l2_budget_bytes": gk.fused_budget_bytes(torch.device(CARD)), "timing": timing})
    return worst, timing


def serve_mxu_phase(torch, model, specs, fp32_probs, int8_fold_probs):
    """score_graphs of the serve phase's model and requests under each
    SERVE_MXU entry, launches counted from 0: every request scored, no
    fused fallback, the variant's kernel n_steps times (fused: once) a
    batch and no other, scores within POLICY_SCORE_TOL of scale of the
    fp32 fold scores, and the int8 mxu scores not the int8 fold ones."""
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import score_graphs
    from deepdfa_tpu_torch.serve.driver import SUMMARY_KEYS

    cfg = load(FLAGSHIP_CONFIG)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    paths = {}
    for path, (accum, unroll) in SERVE_MXU.items():
        vcfg = variant_config(cfg, accum, unroll, "mxu")
        vmodel = DeepDFA.from_config(vcfg.model, cfg.data.feat.input_dim)
        vmodel.load_state_dict(weights)
        gk.reset_launch_counts()
        summary = score_graphs(vmodel, specs, vcfg, device=CARD)
        counts = gk.launch_counts()
        probs = np.asarray(summary.pop("probs"), dtype=np.float64)
        if summary["serve_scored"] != len(specs) or not np.all(np.isfinite(probs)):
            fail(f"{path}: {summary['serve_failed_requests']} requests failed or non-finite")
        if counts["FUSED_FALLBACKS"]:
            fail(f"{path}: {counts['FUSED_FALLBACKS']} fused unrolls fell back to per step")
        counter, row = ("FUSED_MXU_LAUNCHES", "ggnn_fused_mxu") if unroll == "fused" \
            else MXU_ROWS[accum]
        key = SUMMARY_KEYS[counter]
        scored = {k: v for k, v in summary.items() if k.startswith("ggnn_")}
        want = summary["serve_batches"] * (1 if unroll == "fused" else cfg.model.n_steps)
        if scored[key] != want or any(v for k, v in scored.items() if k != key):
            fail(f"{path}: launches {scored}, expected {key} = {want} and no other")
        drift = float(np.abs(probs - fp32_probs).max()) / float(np.abs(fp32_probs).max())
        if drift > POLICY_SCORE_TOL:
            fail(f"{path}: scores {drift} of scale from the fp32 fold scores (limit "
                 f"{POLICY_SCORE_TOL})")
        vs_fold = None
        if accum == "int8":
            vs_fold = float(np.abs(probs - int8_fold_probs).max())
            if vs_fold == 0.0:
                fail(f"{path}: the int8 mxu scores equal the int8 fold scores")
        paths[path] = {row: counts[counter]}
        emit({"phase": path, "ok": True, "accum": accum, "scatter": "mxu", "unroll": unroll,
              "requests": len(specs), "launches": counts, "score_drift_vs_fp32_fold": drift,
              "int8_mxu_vs_int8_fold_max_abs": vs_fold, **summary})
    return paths


def train_mxu_phase(torch, rng):
    """GraphTrainer.fit under (int8, mxu, per_step), TRAIN_BATCHES x
    TRAIN_EPOCHS AdamW steps, launches counted from 0: losses finite and
    falling, kernel 1's int8 mxu instance (steps + evals) x n_steps
    times, B3 and B4 steps x n_steps; two backward passes on one batch
    the same bits; each of the first CPU_STEPS losses within rtol 1e-4 of
    the CPU plain path's from the same parameters (a free CPU trajectory
    from the same start is reported beside it); median step ms."""
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = variant_config(load(FLAGSHIP_CONFIG), "int8", "per_step", "mxu")
    input_dim, n_steps = cfg.data.feat.input_dim, cfg.model.n_steps
    _, batches = train_batches(cfg, rng)
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    model = DeepDFA.from_config(cfg.model, input_dim)
    trainer = GraphTrainer(model, cfg, device=CARD)
    state = trainer.init_state(seed=0)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    records = []
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                max_epochs=TRAIN_EPOCHS, log_fn=records.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = gk.launch_counts()
    want = {"MXU_INT8_LAUNCHES": (steps + TRAIN_EPOCHS) * n_steps,
            "AGGREGATE_LAUNCHES": steps * n_steps,
            "GRU_BWD_LAUNCHES": steps * n_steps, "DMSG_LAUNCHES": steps * n_steps}
    others = {k: v for k, v in counts.items() if k not in want and v}
    if any(counts[k] != v for k, v in want.items()) or others:
        fail(f"train_mxu: kernel launches {counts}, expected {want} and no other")
    epochs = [r for r in records if "epoch" in r]
    losses = [r["train_loss"] for r in epochs]
    if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
        fail(f"train_mxu: a non-finite loss in {epochs}")
    if not losses[-1] < losses[0]:
        fail(f"train_mxu: the loss did not fall: epoch means {losses}")
    b0 = batches[0].to(CARD)

    def grads():
        trainer.forward_loss(state, b0).backward()
        return {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail("train_mxu: two backward passes on one batch gave other gradients")
    # the first CPU_STEPS steps: the card's trajectory against the CPU
    # plain path's loss from the card's parameters of that step (gated), and
    # against a free CPU trajectory from the same start (reported): under
    # int8 an element near a quantum's edge rounds the other way in the two
    # fp32 summation orders, and AdamW's normalized update spreads the flip
    cpu = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device="cpu")
    cpu_state = cpu.init_state(params=init)
    card = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device=CARD)
    card_state = card.init_state(params=init)
    synced = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device="cpu")
    loss_pairs, free_pairs = [], []
    for i in range(CPU_STEPS):
        here = {k: v.detach().cpu().clone() for k, v in card.model.state_dict().items()}
        with torch.no_grad():
            want = synced.forward_loss(synced.init_state(params=here),
                                       batches[i].to("cpu")).item()
        pair = []
        for tr, st in ((card, card_state), (cpu, cpu_state)):
            loss = tr.forward_loss(st, batches[i].to(tr.device))
            loss.backward()
            pair.append(loss.item())
            st.apply_gradients()
        loss_pairs.append((pair[0], want))
        free_pairs.append(tuple(pair))
    loss_err = max(abs(a - b) / abs(b) for a, b in loss_pairs)
    free_err = max(abs(a - b) / abs(b) for a, b in free_pairs)
    if loss_err > 1e-4:
        fail(f"train_mxu: card vs CPU losses from the card's parameters {loss_pairs} "
             f"(rel {loss_err})")
    on_card = [b.to(CARD) for b in batches]
    times = []
    for i in range(10):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        trainer.train_step(state, on_card[i % TRAIN_BATCHES])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t_a))
    emit({"phase": "train_mxu", "ok": True, "accum": "int8", "scatter": "mxu", "steps": steps,
          "epoch_train_loss": losses, "epoch_val_loss": [r["val_loss"] for r in epochs],
          "launches": counts, "grads_bit_equal": True, "cpu_losses": loss_pairs,
          "cpu_loss_rel_err": loss_err, "free_cpu_losses": free_pairs,
          "free_cpu_loss_rel_err": free_err, "fit_seconds": fit_s,
          "step_ms": statistics.median(times)})
    return {"ggnn_step_mxu_int8": counts["MXU_INT8_LAUNCHES"],
            "ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"], "ggnn_dmsg": counts["DMSG_LAUNCHES"]}


def tune_phase(torch, rng):
    """`cli tune` at the flagship serving budgets (16384 x 65536, d 128,
    5 steps) over the card-legal grid, counted from 0: every candidate
    timed with a verdict, a winner, a valid tuned.json under a temporary
    storage root (its candidate table on a line of its own); then `cli
    train` of the flagship model (ggnn_kernel=true) with
    tune.enabled=true on seeded graphs in a graph store there: the
    overrides it applied printed and in its saved config, the winner's
    kernel launched, finite losses."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.tune import cache as tune_cache

    def run_cli(argv) -> list[str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        return out.getvalue().splitlines()

    saved_env = os.environ.get("DEEPDFA_TPU_STORAGE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DEEPDFA_TPU_STORAGE"] = tmp
        try:
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            lines = run_cli(["tune", "--config", str(FLAGSHIP_CONFIG), "--device", CARD])
            tune_s = time.perf_counter() - t0
            tune_counts = gk.launch_counts()
            report = json.loads(lines[-1])
            path = Path(tmp) / "tuned.json"
            verdict = tune_cache.validate_tuned_file(path)
            if not (report["valid"] and verdict["ok"]):
                fail(f"tune: tuned.json invalid: {verdict['problems']}")
            rec = tune_cache.load_tuned(path)["records"][-1]
            sig = report["kernel"]["signature"]
            srec = rec["kernel"][sig]
            rows = srec["candidates"]
            untimed = [r["candidate"] for r in rows
                       if "step_us" not in r or not isinstance(r.get("numerics"), dict)]
            if untimed or not rows or srec.get("winner") is None:
                fail(f"tune: candidates without a time or verdict {untimed}, winner "
                     f"{srec.get('winner')}")
            emit({"phase": "tune_candidates", "signature": sig, "hardware": rec["hardware"],
                  "lax_step_us": srec["lax_step_us"], "winner": srec["winner"],
                  "candidates": [{k: r.get(k) for k in ("candidate", "step_us",
                                                        "mfu_vs_measured_ceiling")}
                                 | {"rel_err": r["numerics"]["rel_err"],
                                    "ok": r["numerics"]["ok"]} for r in rows],
                  "pruned": len(srec["pruned"])})
            # cli train on the tuned layout
            cfg = load(FLAGSHIP_CONFIG)
            graphs = [synthetic_graph(rng, i, int(rng.integers(10, 401)),
                                      cfg.data.feat.input_dim, signal=True) for i in range(120)]
            out = Path(tmp) / "processed" / cfg.data.dataset
            GraphStore(out / cli.graphs_dirname(cfg)).write(graphs)
            (out / "splits.json").write_text(json.dumps(
                {str(g.graph_id): "val" if g.graph_id % 4 == 3 else "train" for g in graphs}))
            tcfg = config_mod.apply_overrides(cfg, [
                'run_name="tune-train"', "model.ggnn_kernel=true", "train.max_epochs=2",
                "train.checkpoint_every_epochs=1", "tune.enabled=true"])
            cfg_path = Path(tmp) / "train.json"
            config_mod.to_json(tcfg, cfg_path)
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            lines = run_cli(["train", "--config", str(cfg_path), "--device", CARD])
            train_s = time.perf_counter() - t0
            train_counts = gk.launch_counts()
            applied = json.loads(next(x for x in lines if x.startswith("[tune] "))[7:])
            saved = load(Path(tmp) / "runs" / "tune-train" / "config.json")
            layout = tune_cache.kernel_layout_from(rec, *map(int, sig.split("x")))
            m = saved.model
            if not applied["matched"] or not applied["overrides"] or (
                    m.ggnn_kernel_scatter, m.ggnn_kernel_accum, m.ggnn_kernel_unroll,
                    m.ggnn_kernel_block_edges) != (layout["scatter"], layout["accum"],
                                                   layout["unroll"], layout["block_e"]):
                fail(f"tune: cli train applied {applied}, saved {m}, winner {layout}")
            scatter, accum = layout["scatter"], layout["accum"]
            if layout["unroll"] == "fused":
                row = "ggnn_fused_mxu" if scatter == "mxu" else "ggnn_fused"
            else:
                row = (MXU_ROWS[accum][1] if scatter == "mxu"
                       else POLICY_ROWS[accum][1])
            log = (Path(tmp) / "runs" / "tune-train" / "train_log.jsonl").read_text()
            epochs = [json.loads(x) for x in log.splitlines() if '"epoch"' in x]
            losses = [r["train_loss"] for r in epochs]
            if train_counts[GGNN_ROWS[row]] <= 0 or not epochs or not all(
                    math.isfinite(x) for x in losses):
                fail(f"tune: cli train launched {train_counts}, winner row {row}, "
                     f"losses {losses}")
        finally:
            if saved_env is None:
                os.environ.pop("DEEPDFA_TPU_STORAGE", None)
            else:
                os.environ["DEEPDFA_TPU_STORAGE"] = saved_env
    forward_rows = [r for r in GGNN_ROWS if r not in ("ggnn_gru_bwd", "ggnn_dmsg")]
    emit({"phase": "tune", "ok": True, "tune_seconds": tune_s, "report": report,
          "launches": tune_counts, "train_applied": applied, "train_winner_row": row,
          "train_launches": train_counts, "train_epoch_loss": losses, "train_seconds": train_s})
    tune_paths = {"tune": {r: tune_counts[GGNN_ROWS[r]] for r in forward_rows},
                  "tune_train": {r: train_counts[GGNN_ROWS[r]]
                                 for r in (row, "ggnn_gru_bwd", "ggnn_dmsg")}}
    return tune_paths


PIPELINE_FUNCTIONS = 2048
PIPELINE_WORKERS = 4
PIPELINE_EPOCHS = 2
# card vs CPU plain path on the test split's probabilities
PIPELINE_RTOL, PIPELINE_ATOL = 1e-4, 1e-5


def run_port_cli(args: list[str], env: dict, timeout: int = 900) -> float:
    """`python -m deepdfa_tpu_torch.cli ARGS` in a process of its own (its
    extraction pool forks from a process without a CUDA context); its
    wall seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "deepdfa_tpu_torch.cli", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        fail(f"pipeline: cli {args[0]} exited {res.returncode}: {res.stderr[-2000:]}")
    return time.perf_counter() - t0


def predictions(path: Path) -> dict:
    import csv

    with path.open() as f:
        return {int(r["id"]): float(r["prob"]) for r in csv.DictReader(f)}


@contextlib.contextmanager
def storage_root(root: Path):
    """DEEPDFA_TPU_STORAGE set to `root` inside the block, restored after."""
    import os

    saved = os.environ.get("DEEPDFA_TPU_STORAGE")
    os.environ["DEEPDFA_TPU_STORAGE"] = str(root)
    try:
        yield dict(os.environ)
    finally:
        if saved is None:
            os.environ.pop("DEEPDFA_TPU_STORAGE", None)
        else:
            os.environ["DEEPDFA_TPU_STORAGE"] = saved


def pipeline_phase(torch, tmp: Path):
    """The port's own data path: `prepare` of PIPELINE_FUNCTIONS seeded
    synthetic functions at Big-Vul tail sizes (a Devign-format json) and
    `extract --workers 4` at the flagship config, each a subprocess under
    the storage root `tmp` (kept for serve_source); then `cli
    train` of the flagship model on the card in-process (2 epochs over
    every train graph: data.undersample=false, or an epoch is one step) and
    `cli test`, counted from 0: every example a graph or a missing id,
    every feature inside input_dim, losses finite, kernel 1 n_steps
    times a forward batch and B3, B4 n_steps times a backward batch, and
    the test split's probabilities on the card those of the same
    checkpoint on the CPU plain path. Returns (launches, the card's test
    probabilities by id, extract's seconds)."""
    import io

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.data import load_examples, synthetic
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import loop

    cfg = config_mod.apply_overrides(load(FLAGSHIP_CONFIG), [
        'run_name="pipeline"', f"train.max_epochs={PIPELINE_EPOCHS}",
        "train.log_every_steps=1", "data.undersample=false"])
    n_steps = cfg.model.n_steps
    with storage_root(tmp) as env:
        cfg_path = Path(tmp) / "pipeline.json"
        config_mod.to_json(cfg, cfg_path)
        seed = cfg.data.seed
        source = Path(tmp) / "bigvul_sized.json"
        synth = synthetic.generate(
            PIPELINE_FUNCTIONS, seed=seed,
            stmt_sizes=synthetic.bigvul_stmt_sizes(PIPELINE_FUNCTIONS, seed=seed))
        source.write_text(json.dumps([{"func": x.before, "target": x.label}
                                      for x in synth]))
        prepare_s = run_port_cli(["prepare", "--source", str(source), "--config",
                                  str(cfg_path)], env)
        extract_s = run_port_cli(["extract", "--workers", str(PIPELINE_WORKERS),
                                  "--config", str(cfg_path)], env)
        out = Path(tmp) / "processed" / cfg.data.dataset
        store_dir = out / cli.graphs_dirname(cfg)
        examples = {e.id for e in load_examples(out / "examples.pkl")}
        graphs = GraphStore(store_dir).load_all()
        missing = {int(x) for x in (store_dir / "missing_ids.txt").read_text().split()}
        if set(graphs) | missing != examples or set(graphs) & missing:
            fail(f"pipeline: {len(examples)} examples, {len(graphs)} graphs, "
                 f"{len(missing)} missing ids do not add up")
        feats = np.concatenate([g.node_feats for g in graphs.values()])
        input_dim = cfg.data.feat.input_dim
        vocab = json.loads((out / f"vocab{cfg.data.feat.name}.json").read_text())
        if (feats.shape[1] != 4 or feats.min() < 0 or feats.max() >= input_dim
                or max(len(v["hashes"]) for v in vocab.values()) > cfg.data.feat.limit_all):
            fail(f"pipeline: features {feats.shape} in [{feats.min()}, {feats.max()}] "
                 f"exceed input_dim {input_dim}")
        splits = cli.load_graph_splits(cfg)
        val_batches = len(cli.epoch_batches(cfg, splits["val"], phase="eval"))
        test_batches = len(cli.epoch_batches(cfg, splits["test"], phase="eval"))

        # cli train on the card, each step timed (the loop syncs on every
        # logged loss anyway at log_every_steps=1)
        step_ms, step_graphs = [], []
        train_step = loop.GraphTrainer.train_step

        def timed_step(self, state, batch):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            loss = train_step(self, state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t_a))
            step_graphs.append(int(batch.graph_mask.sum()))
            return loss

        gk.reset_launch_counts()
        loop.GraphTrainer.train_step = timed_step
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["train", "--config", str(cfg_path), "--device", CARD])
        finally:
            loop.GraphTrainer.train_step = train_step
        train_s = time.perf_counter() - t0
        train_counts = gk.launch_counts()
        run = Path(tmp) / "runs" / "pipeline"
        log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
        epochs = [r for r in log if "epoch" in r]
        steps = sum("step" in r for r in log)
        # the loop's own rate: each epoch's train graphs over its
        # epoch_seconds (steps and host packing; validation after)
        epoch_graphs, done = [], 0
        for r in log:
            if "epoch" in r:
                n_before = sum(len(x) for x in epoch_graphs)
                epoch_graphs.append(step_graphs[n_before:done])
            elif "step" in r:
                done += 1
        losses = [r[k] for r in epochs for k in ("train_loss", "val_loss")]
        if len(epochs) != PIPELINE_EPOCHS or steps != len(step_ms) or not all(
                math.isfinite(x) for x in losses + [r["loss"] for r in log if "step" in r]):
            fail(f"pipeline: train logged {epochs}, {steps} steps ({len(step_ms)} timed)")

        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["test", "--device", CARD, "--export", 'run_name="pipeline"'])
        test_s = time.perf_counter() - t0
        test_counts = gk.launch_counts()
        card_probs = predictions(run / "predictions_test.csv")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["test", "--device", "cpu", "--export", 'run_name="pipeline"'])
        cpu_probs = predictions(run / "predictions_test.csv")
    fwd = n_steps * (steps + PIPELINE_EPOCHS * val_batches)
    want = {"LAUNCHES": fwd, "AGGREGATE_LAUNCHES": n_steps * steps,
            "GRU_BWD_LAUNCHES": n_steps * steps, "DMSG_LAUNCHES": n_steps * steps}
    got = {k: train_counts[k] for k in want}
    others = {k: v for k, v in train_counts.items() if k not in want and v}
    if got != want or others:
        fail(f"pipeline: train launched {train_counts}, expected {want} ({steps} steps, "
             f"{val_batches} val batches an epoch)")
    # `test --export` runs every batch twice: the evaluation, then the export
    want_test = {"LAUNCHES": 2 * n_steps * test_batches}
    if {k: v for k, v in test_counts.items() if v} != want_test:
        fail(f"pipeline: test launched {test_counts}, expected {want_test}")
    ids = sorted(card_probs)
    if ids != sorted(cpu_probs) or ids != sorted(g.graph_id for g in splits["test"]):
        fail("pipeline: the card and CPU test predictions cover other ids")
    card_p = np.array([card_probs[i] for i in ids])
    cpu_p = np.array([cpu_probs[i] for i in ids])
    prob_err = float(np.max(np.abs(card_p - cpu_p)))
    if not np.all(np.isfinite(card_p)) or not np.allclose(card_p, cpu_p, rtol=PIPELINE_RTOL,
                                                           atol=PIPELINE_ATOL):
        fail(f"pipeline: card vs CPU test probabilities differ by up to {prob_err}")
    nodes = int(sum(g.num_nodes for g in graphs.values()))
    emit({"phase": "pipeline", "ok": True, "functions": len(examples), "graphs": len(graphs),
          "missing_ids": len(missing), "nodes": nodes,
          "edges": int(sum(g.num_edges for g in graphs.values())),
          "max_feature": int(feats.max()), "input_dim": input_dim,
          "prepare_seconds": prepare_s, "extract_seconds": extract_s,
          "extract_workers": PIPELINE_WORKERS,
          "extract_functions_per_sec": len(examples) / extract_s,
          "splits": {k: len(v) for k, v in splits.items()}, "train_steps": steps,
          "val_batches": val_batches, "test_batches": test_batches,
          "epoch_train_loss": [r["train_loss"] for r in epochs],
          "epoch_val_loss": [r["val_loss"] for r in epochs],
          "train_seconds": train_s, "test_seconds": test_s,
          "train_launches": {k: train_counts[k] for k in want}, "test_launches": test_counts,
          "synced_step_ms": statistics.median(step_ms),
          "synced_step_graphs_per_sec": sum(step_graphs) / (sum(step_ms) / 1e3),
          "epoch_seconds": [r["epoch_seconds"] for r in epochs],
          "epoch_host_pack_seconds": [r["host_pack_seconds"] for r in epochs],
          "loop_graphs_per_sec": [sum(g) / r["epoch_seconds"]
                                  for g, r in zip(epoch_graphs, epochs)],
          "train_outside_epochs_seconds": train_s - sum(r["epoch_seconds"] for r in epochs),
          "test_prob_max_abs_err": prob_err, "test_examples": len(ids)})
    return {"ggnn_step": train_counts["LAUNCHES"] + test_counts["LAUNCHES"],
            "ggnn_gru_bwd": train_counts["GRU_BWD_LAUNCHES"],
            "ggnn_dmsg": train_counts["DMSG_LAUNCHES"]}, card_probs, extract_s


#: serve_source: the HTTP load and its clients (512 requests until the
#: runtime hooks' phases, 256 until the generation runtime's), the
#: combined run's steps
SERVE_LOAD_REQUESTS, SERVE_CLIENTS = 128, 8
#: (16 files since the cascade phase; the CPU pass at codebert-base width
#: takes ~1.5 s a file, so it scores the first 4 of them since the runtime
#: hooks' phases, and the GGNN's CPU pass the first 64 of the 206 test
#: functions: the script aims at half its time limit)
SERVE_COMBINED_TRAIN, SERVE_COMBINED_VAL, SERVE_COMBINED_FILES = 32, 16, 16
SERVE_COMBINED_CPU_FILES = 4
SERVE_SOURCE_CPU_FUNCTIONS = 64
SERVE_COMBINED_ENCODER = "codebert-base"
# combined scores, card (bf16) vs the CPU plain path
SERVE_COMBINED_TOL = 2e-2
#: texts the C frontend cannot turn into a graph (422 over HTTP)
UNPARSEABLE_TEXTS = ("not a function @@@", "", "}}}} ;;", "int x;", "#include <x.h>",
                     "return 1;", "x = 1", "if (x) { y(); }")


def cli_summary(cli, args: list[str]) -> dict:
    """`cli.main(args)` in this process; the JSON summary it prints last."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(args)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def score_rows(path: Path) -> dict:
    """{name: row} of a scores.jsonl."""
    return {r["name"]: r for r in map(json.loads, path.read_text().splitlines())}


def http_call(port: int, method: str, path: str, body: bytes | None = None):
    """(status, JSON body, seconds) of one request to localhost:port."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, json.loads(data or b"{}"), time.perf_counter() - t0


def http_load(port: int, codes: list[str]) -> dict:
    """POST /score of every code from SERVE_CLIENTS threads; statuses,
    probabilities and client latencies in submission order, and the wall
    seconds of the whole load."""
    from concurrent.futures import ThreadPoolExecutor

    def one(code):
        st, body, dt = http_call(port, "POST", "/score", json.dumps({"code": code}).encode())
        return st, body.get("prob"), dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        got = list(pool.map(one, codes))
    wall = time.perf_counter() - t0
    lat = sorted(dt for _, _, dt in got)
    return {"status": [st for st, _, _ in got], "probs": [p for _, p, _ in got],
            "seconds": wall, "requests_per_sec": len(codes) / wall,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]}


def serve_source_phase(torch, tmp: Path, card_test_probs: dict, smi: str) -> dict:
    """Scoring and serving C sources on the card over the pipeline
    phase's run (storage root `tmp`): `cli score` of the test split's
    functions written as .c files plus the unparseable texts, on the card
    and on the CPU plain path, held against `cli test --export`'s card
    probabilities (`card_test_probs`) and each other; `cli serve` as a
    subprocess on a free port under HTTP load; `cli train-combined` for 2
    steps at codebert-base width on the pipeline's examples and `cli
    score --family combined` on the card and the CPU. Returns the launches
    of the card's scoring runs."""
    import io
    import signal

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.data import load_examples
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    run = tmp / "runs" / "pipeline"
    cfg = config_mod.load(run / "config.json")
    n_steps = cfg.model.n_steps
    out = tmp / "processed" / cfg.data.dataset
    splits = json.loads((out / "splits.json").read_text())
    examples = {e.id: e for e in load_examples(out / "examples.pkl")}
    graphs = set(GraphStore(out / cli.graphs_dirname(cfg)).load_all())
    test_ids = sorted(int(k) for k, v in splits.items() if v == "test")
    src = tmp / "serve_src"
    src.mkdir()
    for i in test_ids:
        (src / f"fn_{i:06d}.c").write_text(examples[i].code)
    for k, text in enumerate(UNPARSEABLE_TEXTS):
        (src / f"zz_unparseable_{k}.c").write_text(text)
    want_ok = {str(src / f"fn_{i:06d}.c") for i in test_ids if i in graphs}
    run_arg = ["--override", 'run_name="pipeline"']
    report: dict = {"phase": "serve_source", "nvidia_smi": smi,
                    "test_functions": len(test_ids), "unparseable": len(UNPARSEABLE_TEXTS)}
    paths: dict = {}
    with storage_root(tmp) as env:
        # 1. cli score from source, on the card, then on the CPU
        (run / "serve_log.jsonl").unlink(missing_ok=True)
        gk.reset_launch_counts()
        card = cli_summary(cli, ["score", str(src), "--out", str(tmp / "scores_card.jsonl"),
                                 "--device", CARD, "--override", "serve.request_log=true",
                                 *run_arg])
        counts = gk.launch_counts()
        log = [json.loads(x) for x in (run / "serve_log.jsonl").read_text().splitlines()]
        frontend_ms = [e["request"]["frontend_ms"] for e in log
                       if "request" in e and e["request"]["status"] == 200]
        card_rows = score_rows(tmp / "scores_card.jsonl")
        # the CPU plain path over the first SERVE_SOURCE_CPU_FUNCTIONS
        # sources (the card scores them all)
        cpu_src = tmp / "serve_src_cpu"
        cpu_src.mkdir()
        for name in sorted(p.name for p in src.iterdir())[:SERVE_SOURCE_CPU_FUNCTIONS]:
            (cpu_src / name).write_text((src / name).read_text())
        cpu = cli_summary(cli, ["score", str(cpu_src), "--out", str(tmp / "scores_cpu.jsonl"),
                                "--device", "cpu", *run_arg])
        cpu_rows = {str(src / Path(n).name): r
                    for n, r in score_rows(tmp / "scores_cpu.jsonl").items()}
        ok = {n for n, r in card_rows.items() if r["ok"]}
        if ok != want_ok or {n for n, r in cpu_rows.items() if r["ok"]} != \
                want_ok & set(cpu_rows):
            fail(f"serve_source: {len(ok)} sources scored on the card, {len(want_ok)} expected "
                 f"(every extracted test function; the {len(UNPARSEABLE_TEXTS)} texts fail)")
        names = sorted(want_ok)
        got = np.array([card_rows[n]["prob"] for n in names])
        want = np.array([card_test_probs[int(Path(n).stem[3:])] for n in names])
        on_cpu = [n for n in names if n in cpu_rows]
        plain = np.array([cpu_rows[n]["prob"] for n in on_cpu])
        got_cpu = np.array([card_rows[n]["prob"] for n in on_cpu])
        err_test = float(np.max(np.abs(got - want)))
        err_cpu = float(np.max(np.abs(got_cpu - plain)))
        if not on_cpu or not (np.allclose(got, want, rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL)
                              and np.allclose(got_cpu, plain, rtol=PIPELINE_RTOL,
                                              atol=PIPELINE_ATOL)):
            fail(f"serve_source: scores from source differ from `test --export` by {err_test} "
                 f"and from the CPU plain path by {err_cpu}")
        # the scoring window launched kernel 1 n_steps times a batch and no
        # other kernel; the service's warm-up ran each ladder rung once
        window = {k: v for k, v in card.items() if k.endswith("_launches") and v}
        warm = {k: v for k, v in counts.items() if v} == {
            "LAUNCHES": card["ggnn_step_launches"] + n_steps * len(cli_ladder(cfg))}
        if window != {"ggnn_step_launches": n_steps * card["serve_batches"]} or not warm:
            fail(f"serve_source: score launched {window} in its window, {counts} in all; "
                 f"expected {n_steps} x {card['serve_batches']} batches and no other kernel")
        paths["ggnn_step"] = counts["LAUNCHES"]
        report.update(
            scored=card["serve_scored"], failed=card["serve_failed_requests"],
            score_requests_per_sec=card["serve_requests_per_sec"],
            score_p50_ms=card["serve_latency_p50_ms"], score_p99_ms=card["serve_latency_p99_ms"],
            score_batches=card["serve_batches"],
            score_batch_occupancy_mean=card["serve_batch_occupancy_mean"],
            score_launches=card["ggnn_step_launches"],
            frontend_ms_median=statistics.median(frontend_ms),
            frontend_ms_p99=sorted(frontend_ms)[int(0.99 * len(frontend_ms))],
            vs_test_export_max_abs_err=err_test, vs_cpu_max_abs_err=err_cpu,
            cpu_functions=len(on_cpu), cpu_requests_per_sec=cpu["serve_requests_per_sec"])

        # 2. cli serve as a subprocess on a free port, under HTTP load
        err_log = tmp / "serve_stderr.log"
        with err_log.open("w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve", "--port", "0",
                 "--device", CARD, *run_arg],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            t0 = time.perf_counter()
            line = proc.stdout.readline()
            if not line:
                fail(f"serve_source: cli serve ended: {err_log.read_text()[-3000:]}")
            hello = json.loads(line)
            port = hello["port"]
            report["serve_start_seconds"] = time.perf_counter() - t0
            h_st, health, _ = http_call(port, "GET", "/healthz")
            s_st, _, _ = http_call(port, "GET", "/stats")
            bad_st = http_call(port, "POST", "/score", b"{not json")[0]
            route_st = http_call(port, "GET", "/no-such-route")[0]
            unparse_st = http_call(port, "POST", "/score",
                                   json.dumps({"code": UNPARSEABLE_TEXTS[0]}).encode())[0]
            statuses = (h_st, s_st, bad_st, route_st, unparse_st)
            if statuses != (200, 200, 400, 404, 422) or any(
                    health.get(k) is None for k in ("checkpoint", "checkpoint_step",
                                                    "config_digest")):
                fail(f"serve_source: healthz/stats/bad json/route/unparseable answered "
                     f"{statuses}; healthz {health}")
            rng = np.random.default_rng(16)
            picks = [names[i] for i in rng.integers(0, len(names), SERVE_LOAD_REQUESTS)]
            codes = [Path(n).read_text() for n in picks]
            want_http = np.array([card_rows[n]["prob"] for n in picks])
            passes = {}
            for name in ("load", "cached"):
                before = http_call(port, "GET", "/stats")[1]
                res = http_load(port, codes)
                after = http_call(port, "GET", "/stats")[1]
                if set(res["status"]) != {200}:
                    fail(f"serve_source: the {name} pass answered {sorted(set(res['status']))}")
                probs = np.array(res["probs"])
                if not np.allclose(probs, want_http, rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL):
                    fail(f"serve_source: HTTP scores differ from `cli score`'s by "
                         f"{float(np.max(np.abs(probs - want_http)))}")
                hits = after["feature_cache_hits"] - before["feature_cache_hits"]
                misses = after["feature_cache_misses"] - before["feature_cache_misses"]
                passes[name] = {
                    **{k: res[k] for k in ("seconds", "requests_per_sec", "p50_ms", "p99_ms")},
                    "cache_hit_share": hits / (hits + misses),
                    "batches": after["batches"] - before["batches"],
                    "batch_occupancy_mean": after["batch_occupancy_mean"],
                    "max_abs_err": float(np.max(np.abs(probs - want_http)))}
            if passes["cached"]["cache_hit_share"] != 1.0:
                fail(f"serve_source: the repeat pass hit the feature cache "
                     f"{passes['cached']['cache_hit_share']} of the time")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            if rc != 0:
                fail(f"serve_source: cli serve exited {rc} on SIGTERM: "
                     f"{err_log.read_text()[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        report.update(http_healthz=health, http=passes)

        # 3. the combined family: 2 train-combined steps, then score
        ids = {s: sorted(int(k) for k, v in splits.items() if v == s and int(k) in graphs)
               for s in ("train", "val")}
        ds = tmp / "processed" / "pipeline-combined"
        ds.mkdir()
        for name in ("examples.pkl", f"vocab{cfg.data.feat.name}.json",
                     cli.graphs_dirname(cfg)):
            (ds / name).symlink_to(out / name)
        (ds / "splits.json").write_text(json.dumps(
            {**{str(i): "train" for i in ids["train"][:SERVE_COMBINED_TRAIN]},
             **{str(i): "val" for i in ids["val"][:SERVE_COMBINED_VAL]}}))
        ccfg = config_mod.apply_overrides(load(COMBINED_CONFIG), [
            'run_name="serve-combined"', 'data.dataset="pipeline-combined"',
            "train.max_epochs=1", "train.log_every_steps=1"])
        ccfg_path = tmp / "serve_combined.json"
        config_mod.to_json(ccfg, ccfg_path)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["train-combined", "--config", str(ccfg_path), "--encoder",
                      SERVE_COMBINED_ENCODER, "--max-length", "512", "--device", CARD])
        crun = tmp / "runs" / "serve-combined"
        steps = sum("step" in json.loads(x)
                    for x in (crun / "train_log.jsonl").read_text().splitlines())
        if steps != 2 or not (crun / "model_cfg.json").exists():
            fail(f"serve_source: train-combined took {steps} steps (2 expected) or wrote no "
                 "model_cfg.json")
        report["combined_train_seconds"] = time.perf_counter() - t0
        csrc = tmp / "serve_src_combined"
        csrc.mkdir()
        for n in names[:SERVE_COMBINED_FILES]:
            (csrc / Path(n).name).write_text(Path(n).read_text())
        crun_arg = ["--family", "combined", "--override", 'run_name="serve-combined"',
                    "--override", f"data.seq_buckets={json.dumps(COMBINED_BUCKETS)}"]
        gk.reset_launch_counts()
        reset_flash(fa)
        comb = cli_summary(cli, ["score", str(csrc), "--out", str(tmp / "comb_card.jsonl"),
                                 "--device", CARD, *crun_arg])
        ccounts = {"ggnn_step": gk.LAUNCHES, "flash_fwd": fa.LAUNCHES}
        csrc_cpu = tmp / "serve_src_combined_cpu"
        csrc_cpu.mkdir()
        for n in names[:SERVE_COMBINED_CPU_FILES]:
            (csrc_cpu / Path(n).name).write_text(Path(n).read_text())
        t0 = time.perf_counter()
        # the CPU pass warms the top bucket alone (the card's warms three):
        # on the host each bucket's warm-up costs ~20 s at codebert-base width
        comb_cpu = cli_summary(cli, ["score", str(csrc_cpu), "--out",
                                     str(tmp / "comb_cpu.jsonl"), "--device", "cpu",
                                     *crun_arg[:-1], f"data.seq_buckets={COMBINED_BUCKETS[-1:]}"])
        comb_cpu_s = time.perf_counter() - t0
        rows_card = {Path(n).name: r for n, r in score_rows(tmp / "comb_card.jsonl").items()}
        rows_cpu = {Path(n).name: r for n, r in score_rows(tmp / "comb_cpu.jsonl").items()}
        layers = json.loads((crun / "model_cfg.json").read_text())["encoder"]["num_layers"]
        if comb["serve_scored"] != SERVE_COMBINED_FILES or comb_cpu["serve_scored"] != \
                SERVE_COMBINED_CPU_FILES:
            fail(f"serve_source: combined scored {comb['serve_scored']} on the card (of "
                 f"{SERVE_COMBINED_FILES}), {comb_cpu['serve_scored']} on the CPU (of "
                 f"{SERVE_COMBINED_CPU_FILES})")
        cp = np.array([rows_card[n]["prob"] for n in sorted(rows_cpu)])
        pp = np.array([rows_cpu[n]["prob"] for n in sorted(rows_cpu)])
        comb_err = float(np.max(np.abs(cp - pp)))
        if not np.all(np.isfinite(cp)) or comb_err > SERVE_COMBINED_TOL:
            fail(f"serve_source: combined card vs CPU scores differ by {comb_err}")
        if (comb["flash_fwd_launches"] != layers * comb["serve_batches"]
                or comb["ggnn_step_launches"] != n_steps * comb["serve_batches"]):
            fail(f"serve_source: combined score launched {comb['flash_fwd_launches']} flash "
                 f"and {comb['ggnn_step_launches']} GGNN kernels over {comb['serve_batches']} "
                 f"batches ({layers} layers, {n_steps} steps)")
        paths["ggnn_step"] += ccounts["ggnn_step"]
        paths["flash_fwd"] = ccounts["flash_fwd"]
        report["combined"] = {
            "functions": SERVE_COMBINED_FILES, "encoder": SERVE_COMBINED_ENCODER,
            "layers": layers, "batches": comb["serve_batches"],
            "flash_fwd_launches": comb["flash_fwd_launches"],
            "ggnn_step_launches": comb["ggnn_step_launches"],
            "requests_per_sec": comb["serve_requests_per_sec"],
            "p50_ms": comb["serve_latency_p50_ms"], "p99_ms": comb["serve_latency_p99_ms"],
            "vs_cpu_max_abs_err": comb_err, "cpu_functions": SERVE_COMBINED_CPU_FILES,
            "cpu_seconds": comb_cpu_s}
    report["launches"] = paths
    emit(report)
    return paths


#: bpe, train_attn_saved and cascade: the shipped BPE vocabulary, the
#: generation model's rows, and the cascade's calibration target, HTTP
#: load (seed 17) and combined card-vs-alone bound (serve_source's)
BPE_DIR = ROOT / "deepdfa_tpu_torch" / "data" / "assets" / "bpe_c"
ATTN_SAVED_TIMED = 2
CASCADE_TARGET_ESCALATION = 0.3
CASCADE_HTTP_SEED = 17
#: test functions of the cascade's CPU run (its stage 2 at codebert-base
#: width costs ~1.4 s an escalated row on the host; 64 until the
#: struct_feats and scan phases came, 32 until the runtime hooks' phases)
CASCADE_CPU_FUNCTIONS = 4


def pipeline_split(tmp: Path, split: str) -> list:
    """The pipeline run's examples of `split` that have a graph, by id."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.data import load_examples
    from deepdfa_tpu_torch.graphs import GraphStore

    cfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    out = tmp / "processed" / cfg.data.dataset
    splits = json.loads((out / "splits.json").read_text())
    graphs = set(GraphStore(out / cli.graphs_dirname(cfg)).load_all())
    examples = {e.id: e for e in load_examples(out / "examples.pkl")}
    return [examples[i] for i in sorted(int(k) for k, v in splits.items()
                                        if v == split and int(k) in graphs)]


def bpe_phase(tmp: Path) -> None:
    """The shipped byte-level BPE (`data/assets/bpe_c/`) over the pipeline
    phase's test functions on the host: the tokenizer's build seconds,
    tokens a function (untruncated: median, p90, max; the share past a
    512-token frame) and encode µs a function, cold (first pass) and warm
    (every chunk cached)."""
    import numpy as np

    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer

    codes = [e.code for e in pipeline_split(tmp, "test")]
    t0 = time.perf_counter()
    tok = BpeTokenizer.from_dir(BPE_DIR)
    build_s = time.perf_counter() - t0
    passes = {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        ids = [tok.encode(c, 1 << 16) for c in codes]
        passes[name] = 1e6 * (time.perf_counter() - t0) / len(codes)
    n = np.array([int((x != tok.pad_id).sum()) for x in ids])
    if not codes or n.min() < 3 or not all(
            int(x[0]) == tok.cls_id and int(x[k - 1]) == tok.sep_id for x, k in zip(ids, n)):
        fail(f"bpe: {len(codes)} functions, token counts from {n.min()}: a row lacks its frame")
    emit({"phase": "bpe", "ok": True, "vocab_size": tok.vocab_size, "functions": len(codes),
          "build_seconds": build_s, "tokens_median": float(np.median(n)),
          "tokens_p90": float(np.percentile(n, 90)), "tokens_max": int(n.max()),
          "share_past_512": float(np.mean(n > 512)),
          "chars_per_token": float(sum(map(len, codes)) / n.sum()),
          "encode_us_per_function_cold": passes["cold"],
          "encode_us_per_function_warm": passes["warm"]})


def hf_roberta_state_dict(torch, enc_cfg, seed: int = 0) -> dict:
    """A Hugging Face `RobertaModel` state_dict at `enc_cfg`'s width with
    random values from `seed`, under the `roberta.` prefix (the layout
    of a codebert-base checkpoint; its weights are not in the
    repository)."""
    g = torch.Generator().manual_seed(seed)
    D, F = enc_cfg.hidden_size, enc_cfg.intermediate_size

    def w(*shape, base=0.0):
        return base + 0.02 * torch.randn(shape, generator=g)

    sd = {"embeddings.word_embeddings.weight": w(enc_cfg.vocab_size, D),
          "embeddings.position_embeddings.weight": w(enc_cfg.max_position_embeddings, D),
          "embeddings.token_type_embeddings.weight": w(enc_cfg.type_vocab_size, D),
          "embeddings.LayerNorm.weight": w(D, base=1.0), "embeddings.LayerNorm.bias": w(D),
          "pooler.dense.weight": w(D, D), "pooler.dense.bias": w(D)}
    for i in range(enc_cfg.num_layers):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(D, D), w(D)
        sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"] = w(F, D), w(F)
        sd[p + "output.dense.weight"], sd[p + "output.dense.bias"] = w(D, F), w(D)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = w(D, base=1.0), w(D)
    return {"roberta." + k: v for k, v in sd.items()}


def write_hf_roberta(torch, tmp: Path, enc_cfg) -> Path:
    """The smoke's HF-layout state dict at `enc_cfg`'s width (codebert-base
    on the main path), written once under `tmp`: what `--pretrained`
    loads."""
    path = tmp / f"hf_roberta_{enc_cfg.hidden_size}x{enc_cfg.num_layers}_{enc_cfg.vocab_size}.pt"
    if not path.exists():
        torch.save(hf_roberta_state_dict(torch, enc_cfg), path)
    return path


def bpe_rows(tmp: Path, tok, rows: int, length: int) -> list[str]:
    """`rows` texts of the pipeline's test functions, each as many
    functions joined as fill `length` BPE tokens."""
    codes = [e.code for e in pipeline_split(tmp, "test")]
    out, k = [], 0
    for _ in range(rows):
        text = ""
        while int((tok.encode(text, length + 1) != tok.pad_id).sum()) <= length:
            text += codes[k % len(codes)] + "\n"
            k += 1
        out.append(text)
    return out


def attn_saved_case(torch, rng, tmp: Path, model: str, policy: str):
    """(trainer, state, batch on the card) of `model` under remat
    `policy` at the train phase's flagship batch: "combined" (codebert-base
    width, bf16, dropout 0.1, 16 x 512 BPE ids of the pipeline's test
    functions, encoder weights from `hf_path` through the CLI's
    `--pretrained` loader; the HF-layout weights are written at the
    model's width), "t5" (the defect model at codet5-base width,
    bf16, 16 x 512 hash ids) or "gen" (the generation model, fp32, 16
    rows of 256 -> 128, through the CLI's `_gen_setup`). One seed, so
    every policy starts from the same weights; the rng draws the same
    batch for both when it is re-seeded by the caller."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.data import collate
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer
    from deepdfa_tpu_torch.train import CombinedTrainer

    if model == "gen":
        args = gen_args()
        args.remat_policy = policy
        cfg = gen_config()
        path = summarize_corpus(rng, GEN_ROWS)
        tok, gcfg, trainer, state, rows = cli._gen_setup(args, cfg, total_steps=1)
        _, src, tgt = cli._gen_encode_file(args, tok, "summarize", str(path))
        batch = gen_data.batches_of(src, tgt, 1, rows, pad_id=tok.pad_id)[0]
        return trainer, state, batch.to(trainer.device)
    arch = "t5" if model == "t5" else "roberta"
    cfg, mcfg = combined_train_setup(torch, arch=arch)
    mcfg = dataclasses.replace(mcfg, encoder=dataclasses.replace(mcfg.encoder,
                                                                 remat_policy=policy))
    if arch == "t5":
        tok = tokenizer("t5")
        texts = [c_like_text(rng, 600) for _ in range(16)]
    else:
        tok = BpeTokenizer.from_dir(BPE_DIR)
        texts = bpe_rows(tmp, tok, 16, 512)
    ids = tok.batch_encode(texts, 512)
    if (ids == tok.pad_id).any():
        fail(f"train_attn_saved: a {model} row is shorter than 512 tokens")
    graphs = {i: dataclasses.replace(synthetic_graph(rng, i, int(rng.integers(10, 151)),
                                                     cfg.data.feat.input_dim, signal=True),
                                     graph_id=i) for i in range(16)}
    bcfg = cfg.data.batch
    batch = collate(ids, [i % 2 for i in range(16)], list(range(16)), graphs, 16,
                    bcfg.node_budget, bcfg.edge_budget, pad_id=tok.pad_id)
    trainer = CombinedTrainer(cfg, mcfg, total_steps=1, device=CARD)
    state = trainer.init_state(seed=0)
    if arch == "roberta":
        hf_path = write_hf_roberta(torch, tmp, mcfg.encoder)
        state = trainer.load_encoder(state, cli.encoder_from_hf(mcfg.encoder, hf_path))
    return trainer, state, batch.to(trainer.device)


def train_attn_saved_phase(torch, tmp: Path) -> dict:
    """remat_policy "full" against "attn_saved" on one training step
    (forward and backward) of each of three models at the flagship batch
    (`attn_saved_case`), both trainers alive, from the same weights,
    batch and dropout seed: the loss and every gradient the same bits;
    kernel 5 launched once a layer's attention call instead of twice, dq,
    dk/dv and dbias as often. Each policy's synchronized step (forward +
    backward; after a warm-up each, timed in turns full, attn_saved,
    attn_saved, full, ATTN_SAVED_TIMED times; medians), its device busy
    time and kernel 5's device time in one profiled step, and its memory
    above the weights and optimiser state with no gradient allocated: at
    the end of the forward (the saved activations, the stash included)
    and at the step's peak (torch.cuda.max_memory_allocated). Returns the
    attn_saved steps' launches (the path's)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule

    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    per_layer = {"combined": 1, "t5": 1, "gen": 3}  # flash calls a layer's forward
    policies = ("full", "attn_saved")
    seed = fold_seed(DROPOUT_SEED, 1)
    report = {"phase": "train_attn_saved"}
    path: dict = {}
    for model in ("combined", "t5", "gen"):
        cases = {p: attn_saved_case(torch, np.random.default_rng(21), tmp, model, p)
                 for p in policies}
        for trainer, state, _ in cases.values():
            state.model.zero_grad(set_to_none=True)
        runs: dict = {p: {} for p in policies}
        grads = {}
        for policy in policies:
            trainer, state, batch = cases[policy]
            trainer.forward_loss(state, batch, seed).backward()  # warm-up
            state.model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_flash(fa)
            gk.reset_launch_counts()
            loss = trainer.forward_loss(state, batch, seed)
            torch.cuda.synchronize()
            forward_end = torch.cuda.memory_allocated() - base
            loss.backward()
            torch.cuda.synchronize()
            counts = {**flash_counts(fa), "ggnn_step": gk.LAUNCHES,
                      "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES, "ggnn_dmsg": gk.DMSG_LAUNCHES}
            runs[policy].update(loss=loss.item(), launches=counts,
                                forward_end_mb=forward_end / 2**20,
                                peak_mb=(torch.cuda.max_memory_allocated() - base) / 2**20)
            grads[policy] = (loss.detach(), grads_of(state))
            state.model.zero_grad(set_to_none=True)
            del loss
        (l1, g1), (l2, g2) = grads["full"], grads["attn_saved"]
        if not (torch.equal(l1, l2) and g1.keys() == g2.keys()
                and all(torch.equal(g1[k], g2[k]) for k in g1)):
            fail(f"train_attn_saved: {model}'s loss or gradients under attn_saved differ "
                 "from full's")
        del grads, g1, g2
        trainer = cases["full"][0]
        layers = (trainer.gen_cfg.encoder.num_layers if model == "gen"
                  else trainer.model_cfg.encoder.num_layers)
        want = per_layer[model] * layers
        c_full, c_saved = runs["full"]["launches"], runs["attn_saved"]["launches"]
        if (c_full["flash_fwd"], c_saved["flash_fwd"]) != (2 * want, want) or \
                {k: v for k, v in c_full.items() if k != "flash_fwd"} != \
                {k: v for k, v in c_saved.items() if k != "flash_fwd"}:
            fail(f"train_attn_saved: {model} launched {c_full} under full and {c_saved} "
                 "under attn_saved")
        for k, v in c_saved.items():
            path[k] = path.get(k, 0) + v
        times = {p: [] for p in policies}
        for _ in range(ATTN_SAVED_TIMED):
            for policy in ("full", "attn_saved", "attn_saved", "full"):
                trainer, state, batch = cases[policy]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.forward_loss(state, batch, seed).backward()
                torch.cuda.synchronize()
                times[policy].append(1e3 * (time.perf_counter() - t0))
        for p in policies:
            runs[p].update(step_ms=statistics.median(times[p]), step_ms_all=times[p])
            # one profiled step (after a dropped warm one): device busy time
            trainer, state, batch = cases[p]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                trainer.forward_loss(state, batch, seed).backward()
                torch.cuda.synchronize()
                prof.step()
                t0 = time.perf_counter()
                trainer.forward_loss(state, batch, seed).backward()
                torch.cuda.synchronize()
                profiled_ms = 1e3 * (time.perf_counter() - t0)
            dev, groups = device_profile(prof, profiled_ms), device_groups(prof)
            runs[p].update(device_busy_ms=dev["device_busy_ms"],
                           device_idle_share=dev["device_idle_share"],
                           flash_fwd_device_ms=groups["flash_fwd"]["ms"],
                           flash_fwd_traced_calls=groups["flash_fwd"]["calls"])
        runs.update(
            saved_ms=runs["full"]["step_ms"] - runs["attn_saved"]["step_ms"],
            saved_device_ms=runs["full"]["device_busy_ms"] - runs["attn_saved"]["device_busy_ms"],
            saved_flash_fwd_device_ms=runs["full"]["flash_fwd_device_ms"]
            - runs["attn_saved"]["flash_fwd_device_ms"],
            extra_forward_end_mb=runs["attn_saved"]["forward_end_mb"]
            - runs["full"]["forward_end_mb"],
            extra_peak_mb=runs["attn_saved"]["peak_mb"] - runs["full"]["peak_mb"],
            bits_equal=True)
        report[model] = runs
        del cases, trainer, state, batch
        torch.cuda.empty_cache()
    report["launches"] = path
    emit(report)
    return path


def write_sources(directory: Path, examples) -> dict:
    """Each example's code as `fn_<id>.c` under `directory`; {path: id}."""
    directory.mkdir()
    out = {}
    for e in examples:
        path = directory / f"fn_{e.id:06d}.c"
        path.write_text(e.code)
        out[str(path)] = e.id
    return out


@contextlib.contextmanager
def port_server(tmp: Path, env: dict, args: list[str], what: str):
    """`cli serve --port 0 ARGS` as a subprocess; yields (port, seconds
    to listen), then SIGTERM and exit 0."""
    import signal

    err_log = tmp / f"serve_{what}.log"
    with err_log.open("w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve", "--port", "0", *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        if not line:
            fail(f"cli serve ({what}) ended: {err_log.read_text()[-3000:]}")
        yield json.loads(line)["port"], time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=120) != 0:
            fail(f"cli serve ({what}) exited {proc.returncode} on SIGTERM: "
                 f"{err_log.read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def http_cascade_load(port: int, codes: list[str]) -> dict:
    """http_load keeping every response body."""
    from concurrent.futures import ThreadPoolExecutor

    def one(code):
        return http_call(port, "POST", "/score", json.dumps({"code": code}).encode())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        got = list(pool.map(one, codes))
    wall = time.perf_counter() - t0
    lat = sorted(dt for _, _, dt in got)
    return {"status": [st for st, _, _ in got], "bodies": [b for _, b, _ in got],
            "seconds": wall, "requests_per_sec": len(codes) / wall,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]}


def cascade_phase(torch, tmp: Path, smi: str) -> dict:
    """The two-stage cascade over the pipeline's run (stage 1, the
    flagship GGNN) and a combined stage 2 at codebert-base width that
    `cli train-combined --tokenizer <the shipped BPE> --pretrained <the
    smoke's HF-layout state dict> --remat-policy attn_saved` trains on
    serve_source's derived dataset (buckets 128/256/512; one epoch).
    `cli score` of the val split's functions, joined with their labels,
    feeds `cli cascade-calibrate --target-escalation 0.3`; with its
    overrides `cli score` runs the cascade over the test split's
    functions on the card and on the CPU, beside the GGNN alone and the
    combined model alone on the same files (in-process after serve_source:
    every function's features come from the shared feature cache, so
    these offline rates leave the frontend out); then `cli serve` (GGNN alone,
    combined alone, cascade) each under 128 requests from 8 client
    threads (test functions drawn with seed 17). Gates: every row not
    escalated is the GGNN alone's probability to the bit, every escalated
    row within serve_source's combined bound of the combined model
    alone's, requests = screened + escalations + sheds + failures, the
    CPU cascade decides the same stages (on the first
    CASCADE_CPU_FUNCTIONS, its stage 2 warming the top bucket alone), the
    HTTP cascade's stage follows
    its own stage-1 score and the band, kernel 5 once an encoder layer a
    stage-2 batch and kernel 1 n_steps times a stage-1 batch. Returns the
    launches of the training run and of the card's cascade scoring, and
    the cascade's `cli score` arguments."""
    import io

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.data import lengths_for, plan_bucketed_batches
    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer
    from deepdfa_tpu_torch.eval import calibrate
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    n_steps = pcfg.model.n_steps
    val, test = pipeline_split(tmp, "val"), pipeline_split(tmp, "test")
    labels = {e.id: int(e.label or 0) for e in val + test}
    run_arg = ["--override", 'run_name="pipeline"']
    report: dict = {"phase": "cascade", "nvidia_smi": smi, "val_functions": len(val),
                    "test_functions": len(test)}
    paths: dict = {}
    with storage_root(tmp) as env:
        # 1. stage 2: BPE ids, HF-layout weights, attn_saved layer checkpoints
        ccfg = config_mod.apply_overrides(load(COMBINED_CONFIG), [
            'run_name="cascade-combined"', 'data.dataset="pipeline-combined"',
            "train.max_epochs=1", "train.log_every_steps=1",
            f"data.seq_buckets={json.dumps(COMBINED_BUCKETS)}"])
        ccfg_path = tmp / "cascade_combined.json"
        config_mod.to_json(ccfg, ccfg_path)
        train_args = ["train-combined", "--config", str(ccfg_path), "--encoder",
                      SERVE_COMBINED_ENCODER, "--max-length", "512", "--tokenizer", str(BPE_DIR),
                      "--remat-policy", "attn_saved", "--device", CARD]
        # the state dict at the width the command builds
        enc_cfg = cli.combined_setup(cli.build_parser().parse_args(train_args), ccfg)[1].encoder
        hf_path = write_hf_roberta(torch, tmp, enc_cfg)
        gk.reset_launch_counts()
        reset_flash(fa)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([*train_args, "--pretrained", str(hf_path)])
        train_s = time.perf_counter() - t0
        train_counts = {**flash_counts(fa), "ggnn_step": gk.LAUNCHES,
                        "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES, "ggnn_dmsg": gk.DMSG_LAUNCHES}
        crun = tmp / "runs" / "cascade-combined"
        log = [json.loads(x) for x in (crun / "train_log.jsonl").read_text().splitlines()]
        steps = sum("step" in r for r in log)
        warm = sum(r.get("warmup_signatures", 0) for r in log)
        manifest = json.loads((crun / "model_cfg.json").read_text())
        L = manifest["encoder"]["num_layers"]
        # the val split's bucket batches: forward only
        tok = BpeTokenizer.from_dir(BPE_DIR)
        cout = tmp / "processed" / "pipeline-combined"
        csplits = json.loads((cout / "splits.json").read_text())
        by_id = {e.id: e for e in pipeline_split(tmp, "val") + pipeline_split(tmp, "train")}
        val_ids = sorted(int(k) for k, v in csplits.items() if v == "val")
        ids = {i: tok.encode(by_id[i].code, 512) for i in val_ids}
        bcfg = ccfg.data.batch
        n_eval = sum(1 for _ in plan_bucketed_batches(
            lengths_for(ids, val_ids, tok.pad_id), val_ids, COMBINED_BUCKETS,
            ccfg.data.token_budget, 1, bcfg.node_budget, bcfg.edge_budget))
        trained = steps + warm
        want = {"flash_fwd": L * (trained + n_eval), "flash_dq": L * trained,
                "flash_dkv": L * trained, "flash_dbias": 0}
        if manifest["tokenizer"]["kind"] != "bpe" or steps < 1 or \
                {k: train_counts[k] for k in want} != want:
            fail(f"cascade: train-combined took {steps} steps ({warm} warm-ups, {n_eval} eval "
                 f"batches), launched {train_counts}, expected {want}; tokenizer "
                 f"{manifest['tokenizer']}")
        paths["cascade_train"] = {k: v for k, v in train_counts.items() if v}
        report["stage2"] = {"steps": steps, "warmup_signatures": warm, "eval_batches": n_eval,
                            "train_seconds": train_s, "layers": L, "launches": train_counts,
                            "tokenizer": manifest["tokenizer"]["kind"],
                            "vocab_size": manifest["encoder"]["vocab_size"]}

        # 2. calibration on the val split (the GGNN alone, on the card)
        val_files = write_sources(tmp / "cascade_val", val)
        val_scores = tmp / "cascade_val_scores.jsonl"
        cli_summary(cli, ["score", str(tmp / "cascade_val"), "--out", str(val_scores),
                          "--device", CARD, *run_arg])
        vrows = score_rows(val_scores)
        joined = tmp / "cascade_val_joined.jsonl"
        joined.write_text("".join(json.dumps({"prob": r["prob"],
                                              "label": labels[val_files[n]]}) + "\n"
                                  for n, r in vrows.items() if r["ok"]))
        calib = cli_summary(cli, ["cascade-calibrate", "--scores", str(joined),
                                  "--target-escalation", str(CASCADE_TARGET_ESCALATION)])
        band, temp = tuple(calib["band"]), calib["temperature"]
        casc_args = [*run_arg, "--override", "serve.cascade=true",
                     *[a for o in calib["overrides"] for a in ("--override", o)],
                     "--override", f"serve.cascade_run_dir={json.dumps(str(crun))}"]
        comb_args = ["--family", "combined", "--override", 'run_name="cascade-combined"']

        # 3. the test split: GGNN alone, combined alone, the cascade (card, CPU)
        src = tmp / "cascade_src"
        write_sources(src, test)
        cpu_src = tmp / "cascade_src_cpu"
        write_sources(cpu_src, test[:CASCADE_CPU_FUNCTIONS])
        offline = {}
        for name, args in (("ggnn", run_arg), ("combined", comb_args)):
            offline[name] = cli_summary(cli, ["score", str(src), "--out",
                                              str(tmp / f"cascade_{name}.jsonl"), "--device",
                                              CARD, *args])
        alone = score_rows(tmp / "cascade_ggnn.jsonl")
        comb_alone = score_rows(tmp / "cascade_combined.jsonl")
        log_path = tmp / "runs" / "pipeline" / "serve_log.jsonl"
        log_path.unlink(missing_ok=True)
        gk.reset_launch_counts()
        reset_flash(fa)
        casc = cli_summary(cli, ["score", str(src), "--out", str(tmp / "cascade_card.jsonl"),
                                 "--device", CARD, "--override", "serve.request_log=true",
                                 *casc_args])
        paths["cascade"] = {"ggnn_step": gk.LAUNCHES, "flash_fwd": fa.LAUNCHES}
        rows = score_rows(tmp / "cascade_card.jsonl")
        entries = [json.loads(x)["request"] for x in log_path.read_text().splitlines()
                   if '"request"' in x]
        # the CPU pass's stage 2 warms its top bucket alone: a copy of the
        # stage-2 run (its files linked) whose config keeps that edge
        cpu_run = tmp / "runs" / "cascade-combined-cpu"
        cpu_run.mkdir()
        for item in crun.iterdir():
            if item.name != "config.json":
                (cpu_run / item.name).symlink_to(item)
        config_mod.to_json(config_mod.apply_overrides(
            config_mod.load(crun / "config.json"),
            [f"data.seq_buckets={COMBINED_BUCKETS[-1:]}"]), cpu_run / "config.json")
        t0 = time.perf_counter()
        casc_cpu = cli_summary(cli, ["score", str(cpu_src), "--out",
                                     str(tmp / "cascade_cpu.jsonl"), "--device", "cpu",
                                     *casc_args[:-1],
                                     f"serve.cascade_run_dir={json.dumps(str(cpu_run))}"])
        cpu_s = time.perf_counter() - t0
        rows_cpu = {str(src / Path(n).name): r
                    for n, r in score_rows(tmp / "cascade_cpu.jsonl").items()}
        names = sorted(rows)
        if not all(rows[n]["ok"] for n in names) or len(names) != len(test) or \
                len(rows_cpu) != min(len(test), CASCADE_CPU_FUNCTIONS):
            fail(f"cascade: {sum(r['ok'] for r in rows.values())} of {len(test)} rows scored")
        stage = {n: rows[n]["stage"] for n in names}
        up = [n for n in names if stage[n] == 2]
        screened = [n for n in names if stage[n] == 1 and not rows[n].get("cascade_shed")
                    and not rows[n].get("cascade_failed")]
        bits = all(rows[n]["stage1_prob"] == alone[n]["prob"] for n in names) and all(
            rows[n]["prob"] == alone[n]["prob"] for n in names if stage[n] == 1)
        comb_err = max((abs(rows[n]["prob"] - comb_alone[n]["prob"]) for n in up), default=0.0)
        c = casc["cascade"]
        if not bits:
            fail("cascade: a row not escalated differs from the GGNN alone's probability")
        if comb_err > SERVE_COMBINED_TOL:
            fail(f"cascade: an escalated row differs from the combined model alone by {comb_err}")
        if c["requests"] != len(screened) + c["escalations"] + c["sheds"] + c["failures"] or \
                c["requests"] != len(names) or c["escalations"] != len(up):
            fail(f"cascade: counters {c} do not add up over {len(names)} rows "
                 f"({len(screened)} screened, {len(up)} escalated)")
        if any(r["stage"] != stage[n] for n, r in rows_cpu.items()):
            fail("cascade: the CPU cascade decided other stages than the card's")
        # kernel 1 n_steps a stage-1 batch, and a stage-2 batch of a
        # model with its graph branch
        s2_steps = manifest["model"]["graph_n_steps"] * manifest["model"]["use_graph"]
        if casc["ggnn_step_launches"] != n_steps * casc["serve_batches"] + s2_steps * c[
                "stage2_batches"] or casc["flash_fwd_launches"] != L * c["stage2_batches"]:
            fail(f"cascade: score launched {casc['ggnn_step_launches']} GGNN and "
                 f"{casc['flash_fwd_launches']} flash kernels over {casc['serve_batches']} and "
                 f"{c['stage2_batches']} batches ({n_steps} steps, {L} layers)")
        total_ms = sorted(e["latency_ms"] + e.get("cascade_stage2_ms", 0.0) for e in entries
                          if e["status"] == 200)
        report["offline"] = {
            **{name: {"requests_per_sec": s["serve_requests_per_sec"],
                      "p50_ms": s["serve_latency_p50_ms"], "p99_ms": s["serve_latency_p99_ms"],
                      "batches": s["serve_batches"], "seconds": s["serve_seconds"]}
               for name, s in offline.items()},
            "cascade": {"requests_per_sec": casc["serve_requests_per_sec"],
                        "seconds": casc["serve_seconds"],
                        "p50_ms": total_ms[len(total_ms) // 2],
                        "p99_ms": total_ms[min(len(total_ms) - 1, int(0.99 * len(total_ms)))],
                        "stage1_batches": casc["serve_batches"],
                        "stage2_batches": c["stage2_batches"]},
            "cascade_cpu_functions": len(rows_cpu), "cascade_cpu_seconds": cpu_s,
            "cascade_cpu_escalated": casc_cpu["cascade"]["escalations"]}
        report.update(
            calibration={k: calib[k] for k in ("temperature", "band", "dev_escalation_rate",
                                               "dev_auc", "dev_nll", "n")},
            test_escalation_rate=c["escalation_rate"], rows_stage1=len(names) - len(up),
            rows_stage2=len(up), counters=c, escalated_vs_combined_max_abs_err=comb_err,
            launches=paths["cascade"], kernel_launches_in_window={
                "ggnn_step": casc["ggnn_step_launches"],
                "flash_fwd": casc["flash_fwd_launches"]})

        # 4. HTTP: the GGNN alone, the combined model alone, the cascade
        rng = np.random.default_rng(CASCADE_HTTP_SEED)
        picks = [names[i] for i in rng.integers(0, len(names), SERVE_LOAD_REQUESTS)]
        codes = [Path(n).read_text() for n in picks]
        http = {}
        for name, args in (("ggnn", run_arg), ("combined", comb_args), ("cascade", casc_args)):
            with port_server(tmp, env, ["--device", CARD, *args], name) as (port, start_s):
                res = http_cascade_load(port, codes)
                stats = http_call(port, "GET", "/stats")[1]
                health = http_call(port, "GET", "/healthz")[1]
            if set(res["status"]) != {200}:
                fail(f"cascade: HTTP ({name}) answered {sorted(set(res['status']))}")
            http[name] = {k: res[k] for k in ("seconds", "requests_per_sec", "p50_ms", "p99_ms")}
            http[name].update(start_seconds=start_s, batches=stats["batches"],
                              batch_occupancy_mean=stats["batch_occupancy_mean"])
            if name == "cascade":
                bodies = res["bodies"]
                hc = stats["cascade"]
                cal_http = calibrate.temperature_scale([b["stage1_prob"] for b in bodies], temp)
                follows = all((b["stage"] == 2) == (calibrate.in_band(p, band)
                                                    and not b.get("cascade_shed")
                                                    and not b.get("cascade_failed"))
                              for b, p in zip(bodies, cal_http))
                p1_err = max(abs(b["stage1_prob"] - alone[n]["prob"])
                             for b, n in zip(bodies, picks))
                n_up = sum(b["stage"] == 2 for b in bodies)
                n_screened = sum(b["stage"] == 1 and not b.get("cascade_shed")
                                 and not b.get("cascade_failed") for b in bodies)
                if not follows or p1_err > PIPELINE_ATOL + PIPELINE_RTOL or \
                        hc["requests"] != len(codes) or hc["escalations"] != n_up or \
                        hc["requests"] != n_screened + hc["escalations"] + hc["sheds"] + \
                        hc["failures"]:
                    fail(f"cascade: HTTP stages follow the band {follows}, stage-1 error "
                         f"{p1_err}, counters {hc} over {n_up} escalated of {len(codes)}")
                http[name].update(counters=hc, escalation_rate=hc["escalation_rate"],
                                  stage1_vs_offline_max_abs_err=p1_err,
                                  healthz_cascade={k: health["cascade"][k] for k in (
                                      "band", "temperature", "stage2_family",
                                      "stage2_checkpoint_step")})
        report["http"] = http
    emit(report)
    return paths, casc_args


#: localize_ggnn, serve_lines, localize_combined, localize_t5: the GGNN
#: path methods' Riemann steps (serve.lines_steps' default) and each
#: method's gradient evaluations a batch; card vs CPU node scores (of each
#: graph's largest |score|), token scores card fp32 vs CPU fp32 and card
#: bf16 vs card fp32 (of each row's largest |score|; the T5 defect model's
#: card-vs-CPU bound is its fp32 gradient check's, train_combined's 2e-2:
#: an fp32 reassociation flips a ReLU gate near 0, and eos pooling feeds
#: the last FFN one token a row); cli localize's functions and the
#: evaluations a function its defaults give
LOCALIZE_STEPS = 8
LOCALIZE_EVALS = {"attention": 0, "saliency": 1, "input_x_gradient": 1,
                  "deeplift": LOCALIZE_STEPS, "lig": LOCALIZE_STEPS}
LOCALIZE_SCORE_TOL = 1e-4
LOCALIZE_TOKEN_TOL = {"card_fp32_vs_cpu": 1e-3, "bf16_vs_fp32": 5e-2,
                      "t5_card_fp32_vs_cpu": COMBINED_TRAIN_GRAD_TOL}
LOCALIZE_TIMED = 5
#: functions of `cli localize` (cut from 32 to 16, then to 8 when the
#: struct_feats and scan phases came, then to 4 for the runtime hooks'
#: phases: the script's time limit)
LOCALIZE_COMBINED_LIMIT = 2
LOCALIZE_CLI_EVALS = {"attention": 0, "saliency": 1, "input_x_gradient": 1, "lig": 20,
                      "deeplift": 20, "deeplift_shap": 8 * 5, "gradient_shap": 8}
LOCALIZE_CHECK_STEPS = 4
SERVE_LINES_SEED, SERVE_LINES_COUNTED = 18, 32


def device_kernels(prof) -> int:
    """Device kernels (and copies) a torch.profiler run launched."""
    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False))


def timed_ms(torch, fn, runs: int = LOCALIZE_TIMED) -> float:
    """Median host milliseconds of `fn` between two synchronizes."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def localize_ggnn_phase(torch, model, specs, budgets, smi: str) -> dict:
    """GGNN node attributions (eval/localize.py:ggnn_score_fn) of phase
    5's flagship-width model on one full serving batch (the profile
    phase's 16 graphs at 16384 nodes / 65536 edges): for each method, the
    card against the CPU plain path (probabilities rtol 1e-4 / atol 1e-5,
    node scores within LOCALIZE_SCORE_TOL of each graph's scale), padding
    zero, the same bits on a repeat, and kernel 1 (with the aggregate for
    each gradient evaluation, without it for a forward alone), B3 and B4
    launched exactly as the method's evaluations say; saliency under
    ggnn_kernel_unroll=fused the per-step scores' bits; one gradient
    evaluation with and without parameters requiring gradients (the
    input-only backward: the same rows cotangent, the kernels it saves);
    ms a batch and functions/s per method, and one profiled saliency and
    lig batch (device busy time and idle share). Returns the launches."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.eval.localize import GGNN_METHODS, ggnn_score_fn
    from deepdfa_tpu_torch.graphs import pack
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    t_phase = time.perf_counter()
    cfg = load(FLAGSHIP_CONFIG)
    n_steps = cfg.model.n_steps
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def fresh(device, **kw):
        m = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim, **kw)
        m.load_state_dict(weights)
        return m.to(device).eval()

    packed = pack(specs, len(specs), *budgets)
    card_b, cpu_b = packed.to(CARD), packed.to("cpu")
    graph, mask = np.asarray(packed.node_graph), np.asarray(packed.node_mask)
    on_card, on_cpu = fresh(CARD), fresh("cpu")
    report: dict = {"phase": "localize_ggnn", "nvidia_smi": smi, "graphs": len(specs),
                    "nodes": int(mask.sum()), "node_budget": budgets[0],
                    "edge_budget": budgets[1], "n_steps": n_steps,
                    "path_steps": LOCALIZE_STEPS, "methods": {}}
    launched = dict.fromkeys(("ggnn_step", "ggnn_gru_bwd", "ggnn_dmsg"), 0)
    results = {}
    for method in GGNN_METHODS:
        run = ggnn_score_fn(method, on_card, LOCALIZE_STEPS)
        gk.reset_launch_counts()
        probs, scores = run(card_b)
        torch.cuda.synchronize()
        counts = {k: v for k, v in gk.launch_counts().items() if v}
        evals = LOCALIZE_EVALS[method]
        forward_alone = method in ("attention", "deeplift", "lig")
        want = {k: v for k, v in {
            "LAUNCHES": n_steps * (evals + forward_alone), "AGGREGATE_LAUNCHES": n_steps * evals,
            "GRU_BWD_LAUNCHES": n_steps * evals, "DMSG_LAUNCHES": n_steps * evals}.items() if v}
        if counts != want:
            fail(f"localize_ggnn: {method} launched {counts}, expected {want}")
        for row, counter in (("ggnn_step", "LAUNCHES"), ("ggnn_gru_bwd", "GRU_BWD_LAUNCHES"),
                             ("ggnn_dmsg", "DMSG_LAUNCHES")):
            launched[row] += counts.get(counter, 0)
        again = run(card_b)
        if not (torch.equal(again[0], probs) and torch.equal(again[1], scores)):
            fail(f"localize_ggnn: {method} gave other bits on a repeat")
        cpu_p, cpu_s = (x.numpy() for x in ggnn_score_fn(method, on_cpu, LOCALIZE_STEPS)(cpu_b))
        p, s = probs.cpu().numpy(), scores.cpu().numpy()
        results[method] = (p, s)
        scale = np.zeros(len(specs) + 1)
        np.maximum.at(scale, graph, np.abs(cpu_s))
        score_err = float(np.max(np.abs(s - cpu_s)[mask] / scale[graph][mask]))
        prob_err = float(np.max(np.abs(p - cpu_p)))
        if not np.allclose(p, cpu_p, rtol=RTOL, atol=ATOL) or score_err > LOCALIZE_SCORE_TOL:
            fail(f"localize_ggnn: {method} card vs CPU: probabilities {prob_err}, node scores "
                 f"{score_err} of scale (limit {LOCALIZE_SCORE_TOL})")
        if np.any(s[~mask] != 0) or not np.all(np.isfinite(s)) or not np.abs(s[mask]).max() > 0:
            fail(f"localize_ggnn: {method} scores padding or are not finite")
        ms = timed_ms(torch, lambda: run(card_b))
        report["methods"][method] = {
            "evaluations": evals, "launches": counts, "ms_a_batch": ms,
            "functions_per_sec": len(specs) / ms * 1e3,
            "vs_cpu_prob_max_abs_err": prob_err, "vs_cpu_score_err_of_scale": score_err}

    # saliency through kernel 2: the forward with the chain, the backward
    # recomputing each step's aggregate with kernel 1
    fused = fresh(CARD, ggnn_kernel=True, ggnn_kernel_unroll="fused")
    gk.reset_launch_counts()
    f_p, f_s = (x.cpu().numpy() for x in ggnn_score_fn("saliency", fused, LOCALIZE_STEPS)(card_b))
    fused_counts = {k: v for k, v in gk.launch_counts().items() if v}
    want = {"FUSED_LAUNCHES": 1, "FUSED_CHAIN_LAUNCHES": 1, "LAUNCHES": n_steps,
            "AGGREGATE_LAUNCHES": n_steps, "GRU_BWD_LAUNCHES": n_steps, "DMSG_LAUNCHES": n_steps}
    sal_p, sal_s = results["saliency"]
    if fused_counts != want or not (np.array_equal(f_p, sal_p) and np.array_equal(f_s, sal_s)):
        fail(f"localize_ggnn: fused saliency launched {fused_counts} (expected {want}); the "
             f"per-step bits: {np.array_equal(f_p, sal_p)}, {np.array_equal(f_s, sal_s)}")
    for row, counter in (("ggnn_step", "LAUNCHES"), ("ggnn_gru_bwd", "GRU_BWD_LAUNCHES"),
                         ("ggnn_dmsg", "DMSG_LAUNCHES")):
        launched[row] += fused_counts.get(counter, 0)
    launched["ggnn_fused"] = fused_counts.get("FUSED_LAUNCHES", 0)
    report["fused_saliency"] = {"launches": fused_counts, "bits_equal_per_step": True}

    # the input-only backward: one saliency gradient with every parameter
    # requiring a gradient (the weight passes run) and with none
    def rows_grad(m):
        with torch.no_grad():
            rows = m.embedding(card_b.node_feats)
        r = rows.requires_grad_(True)
        out = torch.cat([m.ggnn(card_b, r), r], dim=-1)
        (g,) = torch.autograd.grad(m.head(m.pooling(card_b, out)).sum(), r)
        return g

    backward = {}
    grads = {}
    for name, needs in (("with_weights", True), ("input_only", False)):
        m = fresh(CARD).requires_grad_(needs)
        grads[name] = rows_grad(m)
        torch.cuda.synchronize()  # the window holds this evaluation's kernels alone
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rows_grad(m)
            torch.cuda.synchronize()
        backward[name] = {"device_kernels": device_kernels(prof),
                          "ms": timed_ms(torch, lambda: rows_grad(m))}
    if not torch.equal(grads["with_weights"], grads["input_only"]):
        fail("localize_ggnn: the input-only backward changed the rows' cotangent")
    backward["kernels_saved"] = (backward["with_weights"]["device_kernels"]
                                 - backward["input_only"]["device_kernels"])
    report["input_only_backward"] = backward

    # where one batch's time goes
    for method in ("saliency", "lig"):
        run = ggnn_score_fn(method, on_card, LOCALIZE_STEPS)
        run(card_b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(card_b)[1].cpu()
            window = 1e3 * (time.perf_counter() - t0)
        report["methods"][method]["profile"] = device_profile(prof, window)
    report.update(launches=launched, phase_seconds=time.perf_counter() - t_phase)
    emit(report)
    return {"localize_ggnn": launched}


def serve_lines_phase(torch, tmp: Path, smi: str) -> dict:
    """`serve.lines` over the pipeline run's flagship checkpoint (storage
    root `tmp`): `cli serve` without the option (healthz lines false,
    {"lines": true} answered 400, then SERVE_LOAD_REQUESTS test-split
    functions from SERVE_CLIENTS threads) and with it (saliency,
    LOCALIZE_STEPS, top 10: healthz names the method; the same requests,
    every other one carrying {"lines": true}), each a subprocess on the
    card. Every lines answer equals the offline ggnn_score_fn of that
    function alone at rung 1 on the same checkpoint, to the bit.
    Requests/s and p50/p99, with lines and without; then the launches of
    SERVE_LINES_COUNTED lines requests through the same service in this
    process (kernel 1 n_steps times a scoring batch and, with the
    aggregate, n_steps times a request; B3 and B4 n_steps times a
    request). Returns those launches."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core.config import serve_budgets
    from deepdfa_tpu_torch.eval.localize import ggnn_score_fn, node_line_attributions
    from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, pack
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve.frontend import RequestPreprocessor
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import BackgroundServer, ScoringService

    t_phase = time.perf_counter()
    run_dir = tmp / "runs" / "pipeline"
    pcfg = config_mod.load(run_dir / "config.json")
    n_steps = pcfg.model.n_steps
    lines_over = ["serve.lines=true", 'serve.lines_method="saliency"',
                  f"serve.lines_steps={LOCALIZE_STEPS}", "serve.lines_top_k=10"]
    lcfg = config_mod.apply_overrides(pcfg, lines_over)
    test = pipeline_split(tmp, "test")
    rng = np.random.default_rng(SERVE_LINES_SEED)
    codes = [test[i].code for i in rng.integers(0, len(test), SERVE_LOAD_REQUESTS)]
    flags = [i % 2 == 0 for i in range(len(codes))]
    run_arg = ["--override", 'run_name="pipeline"']
    report: dict = {"phase": "serve_lines", "nvidia_smi": smi, "requests": len(codes),
                    "lines_requests": sum(flags), "clients": SERVE_CLIENTS, "method": "saliency",
                    "lines_steps": LOCALIZE_STEPS, "top_k": 10}

    def load(port, lines_flags):
        def one(args):
            code, lines = args
            body = {"code": code, **({"lines": True} if lines else {})}
            return http_call(port, "POST", "/score", json.dumps(body).encode())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            got = list(pool.map(one, zip(codes, lines_flags)))
        return got, time.perf_counter() - t0

    def quantiles(lat) -> dict:
        lat = sorted(lat)
        return {"p50_ms": 1e3 * lat[len(lat) // 2],
                "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]}

    with storage_root(tmp) as env:
        # the offline program: each function alone at rung 1, on the card
        registry = ModelRegistry(run_dir, cfg=pcfg, device=CARD)
        pre = RequestPreprocessor(pcfg, registry.vocabs)
        run = ggnn_score_fn("saliency", registry.model(), LOCALIZE_STEPS)
        nb, eb = serve_budgets(pcfg)
        offline = {}
        for code in {c for c, f in zip(codes, flags) if f}:
            feats = pre.features_full(code)
            batch = pack([feats.spec], 1, nb, eb, feat_width=NUM_SUBKEY_FEATS,
                         etypes=pcfg.model.n_etypes > 1)
            scores = run(batch.to(CARD))[1].cpu().numpy()
            offline[code] = node_line_attributions(scores[:feats.spec.num_nodes],
                                                   feats.node_lines, top_k=10)

        with port_server(tmp, env, ["--device", CARD, *run_arg], "plain") as (port, start_s):
            health = http_call(port, "GET", "/healthz")[1]
            refused = http_call(port, "POST", "/score",
                                json.dumps({"code": codes[0], "lines": True}).encode())[0]
            plain, wall = load(port, [False] * len(codes))
        if health.get("lines") is not False or refused != 400 or \
                {st for st, _, _ in plain} != {200}:
            fail(f"serve_lines: a server without serve.lines reported lines "
                 f"{health.get('lines')}, answered {{\"lines\": true}} with {refused} and its "
                 f"load with {sorted({st for st, _, _ in plain})}")
        report["without_lines"] = {"requests_per_sec": len(codes) / wall, "start_seconds": start_s,
                                   "lines_request_status": refused,
                                   **quantiles([dt for _, _, dt in plain])}
        over = [a for o in lines_over for a in ("--override", o)]
        with port_server(tmp, env, ["--device", CARD, *run_arg, *over], "lines") as (port,
                                                                                   start_s):
            health = http_call(port, "GET", "/healthz")[1]
            mixed, wall = load(port, flags)
            stats = http_call(port, "GET", "/stats")[1]
        if health.get("lines") is not True or health.get("lines_method") != "saliency":
            fail(f"serve_lines: healthz says lines {health.get('lines')}, method "
                 f"{health.get('lines_method')}")
        if {st for st, _, _ in mixed} != {200}:
            fail(f"serve_lines: the mixed load answered {sorted({st for st, _, _ in mixed})}")
        wrong = sum(body.get("lines") != (offline[c] if f else None)
                    for (_, body, _), c, f in zip(mixed, codes, flags))
        if wrong:
            fail(f"serve_lines: {wrong} of {len(codes)} answers differ from the offline "
                 "attribution of the function alone at rung 1 (or carry lines unasked)")
        report["with_lines"] = {
            "requests_per_sec": len(codes) / wall, "start_seconds": start_s,
            "lines": quantiles([dt for (_, _, dt), f in zip(mixed, flags) if f]),
            "score_only": quantiles([dt for (_, _, dt), f in zip(mixed, flags) if not f]),
            "localize_stats": stats.get("localize"), "bits_equal_offline": True,
            "distinct_functions_attributed": len(offline)}

        # again with the pipelined batcher (serve.pipeline_depth=2)
        piped_over = [*over, "--override", "serve.pipeline_depth=2"]
        with port_server(tmp, env, ["--device", CARD, *run_arg, *piped_over],
                         "lines_pipelined") as (port, start_s):
            piped, wall = load(port, flags)
            stats = http_call(port, "GET", "/stats")[1]
        wrong = sum(body.get("lines") != (offline[c] if f else None)
                    for (_, body, _), c, f in zip(piped, codes, flags))
        if {st for st, _, _ in piped} != {200} or wrong or stats.get("pipeline_depth") != 2:
            fail(f"serve_lines: at pipeline_depth 2 the load answered "
                 f"{sorted({st for st, _, _ in piped})}, {wrong} lines answers differ from "
                 f"the offline attribution, /stats depth {stats.get('pipeline_depth')}")
        report["with_lines_pipelined"] = {
            "pipeline_depth": 2, "requests_per_sec": len(codes) / wall,
            "start_seconds": start_s,
            "lines": quantiles([dt for (_, _, dt), f in zip(piped, flags) if f]),
            "score_only": quantiles([dt for (_, _, dt), f in zip(piped, flags) if not f]),
            "batches": stats["batches"], "in_flight_peak": stats["pipeline_in_flight_peak"],
            "device_idle_fraction": stats["pipeline_device_idle_fraction"],
            "localize_stats": stats.get("localize"), "bits_equal_offline": True}

        # the launches of lines requests, through the same service in-process,
        # serial and pipelined
        counted = {}
        for name, cfg_ in (("serve_lines", lcfg), ("serve_lines_pipelined",
                           config_mod.apply_overrides(lcfg, ["serve.pipeline_depth=2"]))):
            service = ScoringService(ModelRegistry(run_dir, cfg=cfg_, device=CARD), cfg_)
            server = BackgroundServer(service)
            try:
                gk.reset_launch_counts()
                for code in codes[:SERVE_LINES_COUNTED]:
                    if server.request("POST", "/score", {"code": code, "lines": True})[0] != 200:
                        fail("serve_lines: an in-process lines request failed")
                torch.cuda.synchronize()
                counts = {k: v for k, v in gk.launch_counts().items() if v}
                batches = service.batcher.batches_run
            finally:
                server.close()
            n = SERVE_LINES_COUNTED
            want = {"LAUNCHES": n_steps * (batches + n), "AGGREGATE_LAUNCHES": n_steps * n,
                    "GRU_BWD_LAUNCHES": n_steps * n, "DMSG_LAUNCHES": n_steps * n}
            if counts != want:
                fail(f"{name}: {n} lines requests in {batches} scoring batches launched "
                     f"{counts}, expected {want}")
            counted[name] = ({"ggnn_step": counts.get("LAUNCHES", 0),
                              "ggnn_gru_bwd": counts.get("GRU_BWD_LAUNCHES", 0),
                              "ggnn_dmsg": counts.get("DMSG_LAUNCHES", 0)}, batches)
    launched, batches = counted["serve_lines"]
    report.update(counted_requests=n, counted_batches=batches, launches=launched,
                  launches_pipelined=counted["serve_lines_pipelined"][0],
                  phase_seconds=time.perf_counter() - t_phase)
    emit(report)
    return {name: launches for name, (launches, _) in counted.items()}


def localize_combined_phase(torch, tmp: Path, smi: str) -> dict:
    """`cli localize --device cuda` over the cascade phase's stage-2 run
    (codebert-base width, the shipped BPE, T 512, its graph branch) on a
    dataset of the pipeline's functions that carry labelled lines (the
    pipeline wrote a Devign json, which has none: the lines come from the
    same seeded synthetic draw) outside that run's training subset, all
    of them in the test split, --limit LOCALIZE_COMBINED_LIMIT; each of
    the seven methods in this process, counted from 0: the report's keys,
    n_examples, finite metrics, one IFA line an example, kernel 5 once an
    encoder layer an evaluation (the attention method: a forward), dq and
    dk/dv once a layer an evaluation (no remat replay), kernel 8 at 0,
    and kernel 1 graph_n_steps times an evaluation (the graph encoder,
    without the aggregate); seconds a function. Then 2 of the functions
    in-process, saliency and lig at LOCALIZE_CHECK_STEPS: the model in
    fp32 on the card against the CPU, and bf16 against fp32 on the card
    (LOCALIZE_TOKEN_TOL). Returns the launches."""
    import dataclasses
    import io
    import pickle

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.data import collate, load_examples, synthetic
    from deepdfa_tpu_torch.eval import localize as L
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.models import CombinedModel
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    out = tmp / "processed" / pcfg.data.dataset
    seed = pcfg.data.seed
    synth = synthetic.generate(PIPELINE_FUNCTIONS, seed=seed,
                               stmt_sizes=synthetic.bigvul_stmt_sizes(PIPELINE_FUNCTIONS,
                                                                      seed=seed))
    examples = [dataclasses.replace(e, vuln_lines=synth[e.id].vuln_lines)
                if e.code == synth[e.id].before else e
                for e in load_examples(out / "examples.pkl")]
    graphs = set(GraphStore(out / cli.graphs_dirname(pcfg)).load_all())
    trained = json.loads((tmp / "processed" / "pipeline-combined" / "splits.json").read_text())
    split = {str(e.id): "test" for e in examples
             if e.vuln_lines and e.id in graphs and str(e.id) not in trained}
    ds = tmp / "processed" / "pipeline-localize"
    ds.mkdir()
    with (ds / "examples.pkl").open("wb") as f:
        pickle.dump(examples, f)
    for name in (f"vocab{pcfg.data.feat.name}.json", cli.graphs_dirname(pcfg)):
        (ds / name).symlink_to(out / name)
    (ds / "splits.json").write_text(json.dumps(split))
    ccfg = config_mod.apply_overrides(config_mod.load(tmp / "cascade_combined.json"),
                                      ['data.dataset="pipeline-localize"'])
    cfg_path = tmp / "localize_combined.json"
    config_mod.to_json(ccfg, cfg_path)
    crun = tmp / "runs" / "cascade-combined"
    manifest = json.loads((crun / "model_cfg.json").read_text())
    layers = manifest["encoder"]["num_layers"]
    graph_steps = manifest["model"]["graph_n_steps"] * manifest["model"]["use_graph"]
    n = min(LOCALIZE_COMBINED_LIMIT, len(split))
    base = ["localize", "--config", str(cfg_path), "--encoder", SERVE_COMBINED_ENCODER,
            "--tokenizer", str(BPE_DIR), "--max-length", "512",
            "--limit", str(LOCALIZE_COMBINED_LIMIT), "--device", CARD]
    report: dict = {"phase": "localize_combined", "nvidia_smi": smi, "functions": n,
                    "labelled_candidates": len(split), "layers": layers, "methods": {}}
    if n < 2:
        fail(f"localize_combined: {len(split)} functions carry labelled lines")
    keys = {"top_1_acc", "top_3_acc", "top_5_acc", "top_10_acc", "ifa",
            "effort_at_20_recall", "recall_at_1_loc", "n_examples", "method"}
    launched = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv", "ggnn_step"), 0)
    calls: list[float] = []
    token_scores = L.token_scores

    def timed_scores(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = token_scores(*a, **k)  # numpy: synchronized
        calls.append(time.perf_counter() - t0)
        return got

    with storage_root(tmp):
        L.token_scores = timed_scores
        try:
            for method in L.METHODS:
                calls.clear()
                gk.reset_launch_counts()
                reset_flash(fa)
                printed = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    cli.main([*base, "--method", method])
                seconds = time.perf_counter() - t0
                rep = json.loads(printed.getvalue())
                counts = {**flash_counts(fa), "ggnn_step": gk.LAUNCHES,
                          "ggnn_aggregate": gk.AGGREGATE_LAUNCHES,
                          "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES, "ggnn_dmsg": gk.DMSG_LAUNCHES}
                evals = LOCALIZE_CLI_EVALS[method]
                want = {"flash_fwd": layers * n * max(evals, 1), "flash_dq": layers * n * evals,
                        "flash_dkv": layers * n * evals, "flash_dbias": 0,
                        "ggnn_step": graph_steps * n * evals, "ggnn_aggregate": 0,
                        "ggnn_gru_bwd": 0, "ggnn_dmsg": 0}
                ifa = (crun / "ifa_records" / f"ifa_{method}.txt").read_text().split()
                saved = json.loads((crun / f"localize_test_{method}.json").read_text())
                if set(rep) != keys or rep != saved or rep["n_examples"] != n or \
                        rep["method"] != method or len(ifa) != n or not all(
                        math.isfinite(rep[k]) for k in keys - {"n_examples", "method"}):
                    fail(f"localize_combined: {method} reported {rep} ({len(ifa)} IFA lines)")
                if counts != want:
                    fail(f"localize_combined: {method} launched {counts}, expected {want}")
                for k in launched:
                    launched[k] += counts[k]
                report["methods"][method] = {
                    "evaluations_a_function": evals, "seconds": seconds,
                    "seconds_a_function": statistics.median(calls),
                    "seconds_a_function_max": max(calls), "report": rep, "launches": counts}
        finally:
            L.token_scores = token_scores

    # 2 functions in-process: fp32 on the card against the CPU, bf16
    # against fp32 on the card
    args = cli.build_parser().parse_args([*base, "--method", "saliency"])
    tok, mcfg = cli.combined_setup(args, ccfg)
    f32 = dataclasses.replace(mcfg, encoder=dataclasses.replace(mcfg.encoder, dtype="float32"))
    state = CheckpointManager(crun / cli.COMBINED_CHECKPOINTS_DIR).restore("best")["model"]

    def build(cfg, device):
        m = CombinedModel(cfg)
        m.load_state_dict(state)
        return m.to(device).eval()

    models = {"bf16": build(mcfg, CARD), "fp32": build(f32, CARD), "cpu": build(f32, "cpu")}
    by_id = {e.id: e for e in examples}
    graph_specs = GraphStore(out / cli.graphs_dirname(pcfg)).load_all()
    bcfg = ccfg.data.batch
    check: dict = {}
    for i in sorted(int(k) for k in split)[:2]:
        ids, _ = tok.encode_with_lines(by_id[i].code, max_length=512)
        b = collate(ids[None], [1], [i], graph_specs, 1, bcfg.node_budget, bcfg.edge_budget,
                    pad_id=tok.pad_id)
        for method in ("saliency", "lig"):
            got = {}
            for name, m in models.items():
                d = b.to("cpu" if name == "cpu" else CARD)
                got[name] = L.token_scores(method, "roberta", m, d.input_ids, d.graphs,
                                           d.has_graph, n_steps=LOCALIZE_CHECK_STEPS)
            errs = {"card_fp32_vs_cpu": float(np.max(np.abs(got["fp32"] - got["cpu"]))
                                              / np.max(np.abs(got["cpu"]))),
                    "bf16_vs_fp32": float(np.max(np.abs(got["bf16"] - got["fp32"]))
                                          / np.max(np.abs(got["fp32"])))}
            for k, v in errs.items():
                check[f"{method}_{k}"] = max(v, check.get(f"{method}_{k}", 0.0))
                if not v <= LOCALIZE_TOKEN_TOL[k]:
                    fail(f"localize_combined: {method} {k} {v} of scale "
                         f"(limit {LOCALIZE_TOKEN_TOL[k]})")
    report.update(check_functions=2, check_steps=LOCALIZE_CHECK_STEPS, check_err_of_scale=check,
                  launches=launched, phase_seconds=time.perf_counter() - t_phase)
    emit(report)
    return {"localize_combined": launched}


def localize_t5_phase(torch, rng, smi: str) -> dict:
    """Token attributions of a codet5-base-width DefectModel (seeded
    weights, bf16, the flagship graph encoder) on 4 rows of 512 T5-framed
    tokens with graphs, saliency and lig (LOCALIZE_CHECK_STEPS), counted
    from 0: kernel 5 once a layer an evaluation, dq and dk/dv once a layer
    an evaluation, kernel 8 at 0 (the relative bias takes no gradient),
    and the seconds of each; then a 2-layer model of the same width in
    fp32 on the card against the CPU (LOCALIZE_TOKEN_TOL's T5 bound; the
    max and the 99th percentile of the error). Returns the launches."""
    import dataclasses

    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.data import collate
    from deepdfa_tpu_torch.eval import localize as L
    from deepdfa_tpu_torch.models import DefectModel
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    t_phase = time.perf_counter()
    cfg = load(COMBINED_CONFIG)
    tok = tokenizer("t5")
    rows = 4
    ids = tok.batch_encode([c_like_text(rng, 700) for _ in range(rows)], 512)
    specs = {i: synthetic_graph(rng, i, int(rng.integers(10, 401)), cfg.data.feat.input_dim)
             for i in range(rows)}
    batch = collate(ids, [0] * rows, list(range(rows)), specs, rows,
                    cfg.data.batch.node_budget, cfg.data.batch.edge_budget, pad_id=tok.pad_id)
    card_b = batch.to(CARD)
    model = combined_model(torch, arch="t5").to(CARD)
    layers, graph_steps = model.cfg.encoder.num_layers, model.cfg.graph_n_steps
    report: dict = {"phase": "localize_t5", "nvidia_smi": smi, "rows": rows, "T": 512,
                    "layers": layers, "steps": LOCALIZE_CHECK_STEPS, "methods": {}}
    launched = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv", "ggnn_step"), 0)
    for method in ("saliency", "lig"):
        evals = 1 if method == "saliency" else LOCALIZE_CHECK_STEPS
        gk.reset_launch_counts()
        reset_flash(fa)
        t0 = time.perf_counter()
        scores = L.token_scores(method, "t5", model, card_b.input_ids, card_b.graphs,
                                card_b.has_graph, n_steps=LOCALIZE_CHECK_STEPS)
        seconds = time.perf_counter() - t0
        counts = {**flash_counts(fa), "ggnn_step": gk.LAUNCHES,
                  "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES}
        want = {"flash_fwd": layers * evals, "flash_dq": layers * evals,
                "flash_dkv": layers * evals, "flash_dbias": 0, "ggnn_step": graph_steps * evals,
                "ggnn_gru_bwd": 0}
        if counts != want or not np.all(np.isfinite(scores)):
            fail(f"localize_t5: {method} launched {counts}, expected {want}")
        for k in launched:
            launched[k] += counts[k]
        report["methods"][method] = {"evaluations": evals, "launches": counts,
                                     "seconds_a_batch": seconds,
                                     "ms_an_evaluation": 1e3 * seconds / evals}
    del model
    small = model_config("t5", layers=2)
    f32 = dataclasses.replace(small, encoder=dataclasses.replace(small.encoder, dtype="float32"))
    ref = DefectModel(f32, generator=torch.Generator().manual_seed(0)).eval()
    on_card = copy.deepcopy(ref).to(CARD)
    errs = {}
    cpu_b = batch.to("cpu")
    for method in ("saliency", "lig"):
        got = L.token_scores(method, "t5", on_card, card_b.input_ids, card_b.graphs,
                             card_b.has_graph, n_steps=LOCALIZE_CHECK_STEPS)
        want = L.token_scores(method, "t5", ref, cpu_b.input_ids, cpu_b.graphs,
                              cpu_b.has_graph, n_steps=LOCALIZE_CHECK_STEPS)
        err = np.abs(got - want) / np.abs(want).max(-1, keepdims=True)
        errs[method] = {"max": float(err.max()), "p99": float(np.quantile(err, 0.99))}
        if not errs[method]["max"] <= LOCALIZE_TOKEN_TOL["t5_card_fp32_vs_cpu"]:
            fail(f"localize_t5: {method} card vs CPU (2 layers, fp32) {errs[method]} of scale "
                 f"(limit {LOCALIZE_TOKEN_TOL['t5_card_fp32_vs_cpu']})")
    report.update(card_fp32_vs_cpu_err_of_scale=errs, launches=launched,
                  phase_seconds=time.perf_counter() - t_phase)
    emit(report)
    return {"localize_t5": launched}

#: native: the functions of the in-process stage split (each backend),
#: after a warm-up pass of each over other functions
NATIVE_STAGE_FUNCTIONS = 128
NATIVE_WARM_FUNCTIONS = 32
#: serve_pipelined: the depths of the offline drive, the started drive's,
#: phase 5's requests repeated this many times, and the client threads
PIPELINED_DEPTHS = (0, 1, 2)
PIPELINED_ROUNDS = 3
PIPELINED_ONLINE_DEPTHS = (0, 2)
PIPELINED_REPEATS = 8
#: serve_int8_entry: the int8 entry's calibration drift bound (serve's default)
#: and the card-vs-CPU tolerance of its scores
INT8_DRIFT_BOUND = 5e-2
INT8_RTOL, INT8_ATOL = 1e-4, 1e-5
#: train_prefetch: the input pipeline of the pipeline's `cli train`, and
#: the steps of each profiled window
PREFETCH_RUNS = {"prefetch_0": ["train.prefetch_batches=0"],
                 "prefetch_2_pool_cache": ["train.prefetch_batches=2", "data.pack_workers=4",
                                           "data.packed_cache=true"]}
PREFETCH_PROFILED_STEPS = 24


def python_frontend_cli(args: list[str], env: dict, timeout: int = 900) -> float:
    """`run_port_cli` with the port's native library switched off in the
    process and in the workers it forks (the frontend's Python path);
    its wall seconds."""
    probe = ("import sys; from deepdfa_tpu_torch import native; "
             "native.available = lambda: False; "
             "from deepdfa_tpu_torch.cli import main; main(sys.argv[1:])")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", probe, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        fail(f"native: the Python-path cli {args[0]} exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    return time.perf_counter() - t0


def frontend_stages(examples, native_on: bool) -> dict:
    """Seconds of each extraction stage over `examples` in this process,
    under the native or the Python lexer and solver: lex (conditionals
    and tokens), parse (the rest of parse_function), reaching
    definitions and dependences (not on the flagship cfg path, measured
    for their share), abstract dataflow (graph_from_cpg), encoding
    (to_graph_spec against vocabularies built from these graphs) and
    store (one GraphStore.write)."""
    import tempfile as tf

    from deepdfa_tpu_torch import native
    from deepdfa_tpu_torch.data import pipeline
    from deepdfa_tpu_torch.frontend import deps, parser, preproc, reaching, tokens, vocab
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.nn.embedding import SUBKEY_ORDER

    saved = native.available
    if not native_on:
        native.available = lambda: False
    try:
        t = dict.fromkeys(("lex", "parse", "reaching_definitions", "dependences",
                           "abstract_dataflow", "encoding", "store"), 0.0)
        graphs = []
        for e in examples:
            t0 = time.perf_counter()
            tokens.tokenize(preproc.evaluate_conditionals(e.code))
            t1 = time.perf_counter()
            try:
                cpg = parser.parse_function(e.code)
            except ValueError:
                t["parse"] += time.perf_counter() - t1
                t["lex"] += t1 - t0
                continue
            t2 = time.perf_counter()
            reaching.ReachingDefinitions(cpg).solve()
            t3 = time.perf_counter()
            deps.data_dependences(cpg)
            deps.control_dependences(cpg)
            t4 = time.perf_counter()
            g = pipeline.graph_from_cpg(cpg, e.id, set(e.vuln_lines) or None, label=e.label)
            t5 = time.perf_counter()
            # parse_function lexes again inside: its lex share moves to lex
            t["lex"] += t1 - t0
            t["parse"] += max(0.0, (t2 - t1) - (t1 - t0))
            t["reaching_definitions"] += t3 - t2
            t["dependences"] += t4 - t3
            t["abstract_dataflow"] += t5 - t4
            if g is not None:
                graphs.append(g)
        vocabs = vocab.build_vocabs([f for g in graphs for f in g.def_fields.values()],
                                    SUBKEY_ORDER)
        t0 = time.perf_counter()
        specs = [pipeline.to_graph_spec(g, vocabs) for g in graphs]
        t["encoding"] = time.perf_counter() - t0
        with tf.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            GraphStore(Path(d)).write(specs)
            t["store"] = time.perf_counter() - t0
    finally:
        native.available = saved
    total = sum(t.values())
    cfg_path = ("lex", "parse", "abstract_dataflow", "encoding", "store")
    return {"seconds": t, "share": {k: v / total for k, v in t.items()},
            "total_seconds": total, "functions": len(examples), "graphs": len(graphs),
            "functions_per_sec": len(examples) / total,
            # the flagship gtype "cfg" runs no reaching definitions or dependences
            "cfg_path_ms_a_function": 1e3 * sum(t[k] for k in cfg_path) / len(examples)}


def native_phase(torch, tmp: Path, native_extract_s: float, smi: str) -> None:
    """The native C++ lexer and solver on the pipeline phase's functions:
    `cli extract --workers 4` again into two more storage roots holding
    the same prepare outputs, first native (the library built: the
    pipeline phase's extraction, timed there too, had its 4 workers build
    it with g++), then on the Python path (the port's native library
    switched off), each store, vocabulary and missing-id list equal to the
    pipeline's; then, in this process on the host, each extraction
    stage's seconds and share over NATIVE_STAGE_FUNCTIONS functions under
    each backend, both warmed first on NATIVE_WARM_FUNCTIONS others."""
    import shutil

    from deepdfa_tpu_torch import cli, native
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.data import load_examples
    from deepdfa_tpu_torch.graphs import GraphStore

    if not native.available():
        fail("native: the native library did not build (g++ missing)")
    cfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    src = tmp / "processed" / cfg.data.dataset
    store = cli.graphs_dirname(cfg)
    vocab_name = f"vocab{cfg.data.feat.name}.json"
    seconds, equal = {"native_with_build": native_extract_s}, {}
    for backend, run in (("native", run_port_cli), ("python", python_frontend_cli)):
        root = tmp / f"{backend}_frontend"
        dst = root / "processed" / cfg.data.dataset
        dst.mkdir(parents=True)
        for p in src.iterdir():
            if p.is_file() and not p.name.startswith("vocab"):
                shutil.copy(p, dst / p.name)
        with storage_root(root) as env:
            seconds[backend] = run(["extract", "--workers", str(PIPELINE_WORKERS),
                                    "--config", str(tmp / "pipeline.json")], env)
        missing = [(d / store / "missing_ids.txt").read_text() for d in (src, dst)]
        equal[backend] = {
            "store_digest": GraphStore(src / store).digest() == GraphStore(dst / store).digest(),
            "vocabularies": (src / vocab_name).read_text() == (dst / vocab_name).read_text(),
            "missing_ids": missing[0] == missing[1]}
    if not all(v for e in equal.values() for v in e.values()):
        fail(f"native: an extraction differs from the pipeline's: {equal}")
    n = len(load_examples(src / "examples.pkl"))
    examples = sorted(load_examples(src / "examples.pkl"), key=lambda e: e.id)
    subset = examples[:NATIVE_STAGE_FUNCTIONS]
    for native_on in (True, False):  # warm both paths (imports, caches) before timing
        frontend_stages(examples[-NATIVE_WARM_FUNCTIONS:], native_on)
    stages = {"native": frontend_stages(subset, True), "python": frontend_stages(subset, False)}
    emit({"phase": "native", "ok": True, "nvidia_smi": smi, "functions": n,
          "workers": PIPELINE_WORKERS, "outputs_equal": equal, "extract_seconds": seconds,
          "extract_functions_per_sec": {k: n / v for k, v in seconds.items()},
          "stage_split": stages,
          "stage_speedup": {k: stages["python"]["seconds"][k] / v
                            for k, v in stages["native"]["seconds"].items() if v > 0}})


def serve_pipelined_phase(torch, model, specs, budgets, max_graphs, smi: str) -> dict:
    """Phase 5's model and requests (repeated PIPELINED_REPEATS times)
    through `score_all` at depths 0, 1 and 2, PIPELINED_ROUNDS rounds in
    rotated order (the same bits at every depth, the in-flight peak the
    depth, kernel 1 n_steps times a batch; each depth's median run and
    every run's rate),
    and through a started batcher with SERVE_CLIENTS submitting threads
    at depths 0 and 2 (within rtol 1e-4 / atol 1e-5 of the offline
    scores: the batches form by arrival); requests/s, p50/p99 and the
    DeviceWindow idle fraction of each. Returns the launches of the
    depth-2 offline drive."""
    import threading

    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import DynamicBatcher, GgnnExecutor

    n_steps = load(FLAGSHIP_CONFIG).model.n_steps
    ex = GgnnExecutor(model, *budgets, max_graphs, device=CARD)
    ex.warmup()
    load = list(specs) * PIPELINED_REPEATS
    report: dict = {"phase": "serve_pipelined", "nvidia_smi": smi, "requests": len(load),
                    "offline": {}, "online": {}}

    def summary(batcher, reqs, wall) -> dict:
        lat = sorted(r.latency_s for r in reqs)
        st = batcher.stats()
        return {"requests_per_sec": len(reqs) / wall, "seconds": wall,
                "p50_ms": 1e3 * lat[len(lat) // 2],
                "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                "batches": st["batches"], "in_flight_peak": st["pipeline_in_flight_peak"],
                "device_idle_fraction": st["pipeline_device_idle_fraction"],
                "device_busy_s": st["pipeline_device_busy_s"],
                "overlap_seconds": st["pipeline_overlap_seconds"],
                "fetch_seconds": st["pipeline_fetch_seconds"]}

    results, launches, runs = {}, {}, {d: [] for d in PIPELINED_DEPTHS}
    # rounds with the depths in rotated order: host times drift within a call
    for r in range(PIPELINED_ROUNDS):
        for depth in PIPELINED_DEPTHS[r % 3:] + PIPELINED_DEPTHS[:r % 3]:
            # no flush timer: a group runs when full, the tail at the drain, so
            # every run forms the same batches whatever the host's pace
            batcher = DynamicBatcher(ex, queue_limit=len(load), max_batch_delay_s=3600.0,
                                     pipeline_depth=depth)
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            reqs = batcher.score_all(load)
            wall = time.perf_counter() - t0
            launches[depth] = gk.LAUNCHES
            batcher.close()
            if results.setdefault(depth, [q.result for q in reqs]) != [q.result for q in reqs]:
                fail(f"serve_pipelined: depth {depth}'s scores changed between rounds")
            runs[depth].append(summary(batcher, reqs, wall))
            if launches[depth] != n_steps * batcher.batches_run:
                fail(f"serve_pipelined: depth {depth} launched kernel 1 {launches[depth]} "
                     f"times over {batcher.batches_run} batches")
            if depth and batcher.stats()["pipeline_in_flight_peak"] != depth:
                fail(f"serve_pipelined: depth {depth} peaked at "
                     f"{batcher.stats()['pipeline_in_flight_peak']} batches in flight")
    for depth, rs in runs.items():
        report["offline"][f"depth_{depth}"] = {
            **min(rs, key=lambda x: abs(x["requests_per_sec"] - statistics.median(
                y["requests_per_sec"] for y in rs))),
            "requests_per_sec_runs": [x["requests_per_sec"] for x in rs]}
    if any(results[d] != results[0] for d in PIPELINED_DEPTHS):
        fail("serve_pipelined: a depth's scores differ from depth 0's bits")
    want = np.array(results[0])
    for depth in PIPELINED_ONLINE_DEPTHS:
        batcher = DynamicBatcher(ex, queue_limit=len(load), pipeline_depth=depth)
        batcher.start()
        out: list = [None] * len(load)

        def client(k):
            for i in range(k, len(load), SERVE_CLIENTS):
                out[i] = batcher.submit(load[i])
                out[i].wait(600)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        batcher.close()
        got = np.array([r.result for r in out])
        err = float(np.max(np.abs(got - want)))
        if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"serve_pipelined: the started batcher at depth {depth} differs from the "
                 f"offline scores by {err}")
        report["online"][f"depth_{depth}"] = {**summary(batcher, out, wall),
                                              "max_abs_err_vs_offline": err,
                                              "bits_equal_offline": bool(np.array_equal(got,
                                                                                        want))}
    report.update(bits_equal_across_depths=True, launches=launches,
                  kernel1_per_batch=n_steps)
    emit(report)
    return {"serve_pipelined": {"ggnn_step": launches[2]}}


def serve_int8_entry_phase(torch, tmp: Path, casc_args: list[str], smi: str) -> dict:
    """The quantized `tag@int8` entry (named apart from phase 7c's
    serve_int8, kernel 1's int8 message policy): `cli score` over
    serve_source's files (the pipeline's run) with the fp32 entry, then
    `--override serve.checkpoint="best@int8"` on the card and on the CPU:
    the calibration drift within serve.quant_drift_bound, the bytes
    fraction, card against CPU within rtol 1e-4 / atol 1e-5, each
    probability within the drift bound of the fp32 entry's (serve_source's
    card rows), kernel 1 n_steps times a batch; then the cascade phase's
    `cli score` with its stage 2 as `best@int8`: its stage-2 drift and
    bytes fraction, the same stages as the fp32 cascade, each escalated
    probability's distance to the fp32 stage 2's. Returns both launches."""
    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    n_steps = pcfg.model.n_steps
    run_arg = ["--override", 'run_name="pipeline"']
    int8 = ["--override", 'serve.checkpoint="best@int8"']
    src = tmp / "serve_src"
    report: dict = {"phase": "serve_int8_entry", "nvidia_smi": smi}
    paths: dict = {}
    with storage_root(tmp):
        # the fp32 entry in the same call, features from the same cache
        fp32_run = cli_summary(cli, ["score", str(src), "--out", str(tmp / "fp32_again.jsonl"),
                                     "--device", CARD, *run_arg])
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        card = cli_summary(cli, ["score", str(src), "--out", str(tmp / "int8_card.jsonl"),
                                 "--device", CARD, *run_arg, *int8])
        card_s = time.perf_counter() - t0
        paths["serve_int8_entry"] = {"ggnn_step": gk.LAUNCHES}
        cpu = cli_summary(cli, ["score", str(src), "--out", str(tmp / "int8_cpu.jsonl"),
                                "--device", "cpu", *run_arg, *int8])
        rows, cpu_rows = score_rows(tmp / "int8_card.jsonl"), score_rows(tmp / "int8_cpu.jsonl")
        fp32 = score_rows(tmp / "scores_card.jsonl")
        names = sorted(n for n, r in fp32.items() if r["ok"])
        if sorted(n for n, r in rows.items() if r["ok"]) != names:
            fail("serve_int8_entry: the int8 entry scored other files than the fp32 one")
        got = np.array([rows[n]["prob"] for n in names])
        plain = np.array([cpu_rows[n]["prob"] for n in names])
        ref = np.array([fp32[n]["prob"] for n in names])
        q = card["quant"]
        err_cpu = float(np.max(np.abs(got - plain)))
        err_fp32 = float(np.max(np.abs(got - ref)))
        if not (0 <= q["quant_drift"] <= INT8_DRIFT_BOUND == q["quant_drift_bound"]):
            fail(f"serve_int8_entry: calibration drift {q}")
        if not np.allclose(got, plain, rtol=INT8_RTOL, atol=INT8_ATOL):
            fail(f"serve_int8_entry: card vs CPU int8 scores differ by {err_cpu}")
        if err_fp32 > INT8_DRIFT_BOUND:
            fail(f"serve_int8_entry: an int8 score is {err_fp32} from the fp32 entry's")
        if card["ggnn_step_launches"] != n_steps * card["serve_batches"]:
            fail(f"serve_int8_entry: kernel 1 launched {card['ggnn_step_launches']} times over "
                 f"{card['serve_batches']} batches")
        report.update(functions=len(names), quant=q, cpu_quant=cpu["quant"],
                      card_vs_cpu_max_abs_err=err_cpu, vs_fp32_max_abs_err=err_fp32,
                      vs_fp32_mean_abs_err=float(np.mean(np.abs(got - ref))),
                      requests_per_sec=card["serve_requests_per_sec"], seconds=card_s,
                      p50_ms=card["serve_latency_p50_ms"], p99_ms=card["serve_latency_p99_ms"],
                      batches=card["serve_batches"], fp32_entry={
                          k: fp32_run[f"serve_{k}"] for k in (
                              "requests_per_sec", "latency_p50_ms", "latency_p99_ms",
                              "batches")})

        # the cascade's stage 2 as best@int8
        fp32_casc = score_rows(tmp / "cascade_card.jsonl")
        gk.reset_launch_counts()
        reset_flash(fa)
        casc = cli_summary(cli, ["score", str(tmp / "cascade_src"), "--out",
                                 str(tmp / "cascade_int8.jsonl"), "--device", CARD, *casc_args,
                                 "--override", 'serve.cascade_checkpoint="best@int8"'])
        paths["cascade_int8"] = {"ggnn_step": gk.LAUNCHES, "flash_fwd": fa.LAUNCHES}
        crows = score_rows(tmp / "cascade_int8.jsonl")
        c = casc["cascade"]
        if set(crows) != set(fp32_casc) or not all(r["ok"] for r in crows.values()) or any(
                crows[n]["stage"] != fp32_casc[n]["stage"] for n in crows):
            fail("serve_int8_entry: the int8 stage-2 cascade decided other rows or stages")
        up = [n for n in crows if crows[n]["stage"] == 2]
        errs = [abs(crows[n]["prob"] - fp32_casc[n]["prob"]) for n in up]
        s2q = c["stage2_quant"]
        if not 0 <= s2q["quant_drift"] <= s2q["quant_drift_bound"] or not all(
                math.isfinite(crows[n]["prob"]) for n in up) or not up:
            fail(f"serve_int8_entry: stage 2 {s2q}, {len(up)} escalated rows")
        report["cascade_stage2"] = {
            "quant": s2q, "escalated": len(up), "stage2_batches": c["stage2_batches"],
            "vs_fp32_stage2_max_abs_err": max(errs), "vs_fp32_stage2_mean_abs_err":
                float(np.mean(errs)), "requests_per_sec": casc["serve_requests_per_sec"],
            "launches": paths["cascade_int8"]}
    emit(report)
    return paths


def train_prefetch_phase(torch, tmp: Path, smi: str) -> dict:
    """The pipeline's `cli train` (its config and store: 2 epochs over
    every train graph) again under the input pipeline's knobs of
    PREFETCH_RUNS: inline (train.prefetch_batches=0), and prefetched with
    a pool of 4 spawned packers and the packed-batch cache (the
    step-count estimate packs and writes the stream, both epochs replay
    it); every step's loss the pipeline phase's run's (prefetch 2, the
    default) to the bit, launches counted from 0 around the last run;
    the loop's graphs/s and the epoch records' host seconds; then a
    window of PREFETCH_PROFILED_STEPS steps under torch.profiler at
    prefetch 0, 2, 2, 0 (device busy time, idle share). Returns the
    launches."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    def log_of(run: str):
        log = [json.loads(x) for x in
               (tmp / "runs" / run / "train_log.jsonl").read_text().splitlines()]
        return [r["loss"] for r in log if "step" in r], [r for r in log if "epoch" in r]

    want, _ = log_of("pipeline")
    report: dict = {"phase": "train_prefetch", "nvidia_smi": smi, "runs": {}}
    with storage_root(tmp):
        pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
        splits = cli.load_graph_splits(pcfg)
        graphs = sum(int(b.graph_mask.sum()) for b in cli.epoch_batches(pcfg, splits["train"], 0))
        for name, over in PREFETCH_RUNS.items():
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["train", "--config", str(tmp / "pipeline.json"), "--device", CARD,
                          f"run_name=\"{name}\"", *over])
            seconds = time.perf_counter() - t0
            counts = gk.launch_counts()
            losses, epochs = log_of(name)
            if losses != want:
                fail(f"train_prefetch: {name}'s losses differ from the pipeline run's "
                     f"({len(losses)} vs {len(want)} steps)")
            report["runs"][name] = {
                "overrides": over, "seconds": seconds, "steps": len(losses),
                "loop_graphs_per_sec": [graphs / r["epoch_seconds"] for r in epochs],
                **{k: [r[k] for r in epochs] for k in (
                    "epoch_seconds", "host_load_seconds", "host_pack_seconds",
                    "host_place_seconds", "input_wait_seconds", "input_wait_fraction")}}
        cached = report["runs"]["prefetch_2_pool_cache"]
        if not all(s > 0 for s in cached["host_load_seconds"]) or any(cached["host_pack_seconds"]):
            fail(f"train_prefetch: the cached run's epochs did not replay the cache: {cached}")
        n_steps = pcfg.model.n_steps
        steps = len(want)
        if counts["GRU_BWD_LAUNCHES"] != n_steps * steps or \
                counts["DMSG_LAUNCHES"] != n_steps * steps:
            fail(f"train_prefetch: launched {counts} over {steps} steps")
        paths = {"train_prefetch": {"ggnn_step": counts["LAUNCHES"],
                                    "ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"],
                                    "ggnn_dmsg": counts["DMSG_LAUNCHES"]}}
        batches = cli.epoch_batches(pcfg, splits["train"], 0)[:PREFETCH_PROFILED_STEPS]
        report["profiled"] = {}
        for order, depth in enumerate((0, 2, 2, 0)):
            cfg = config_mod.apply_overrides(pcfg, [f"train.prefetch_batches={depth}"])
            trainer = GraphTrainer(cli._model(cfg), cfg, total_steps=2 * len(batches),
                                   device=CARD)
            state = trainer.init_state()
            trainer.fit(state, lambda epoch: iter(batches[:4]), max_epochs=1)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.fit(state, lambda epoch: iter(batches), max_epochs=1)
                torch.cuda.synchronize()
                window_ms = 1e3 * (time.perf_counter() - t0)
            report["profiled"][f"prefetch_{depth}_{'ab'[order // 2]}"] = {
                "steps": len(batches), "ms_a_step": window_ms / len(batches),
                **device_profile(prof, window_ms)}
    report.update(train_graphs_an_epoch=graphs, losses_equal_pipeline_run=True,
                  launches=paths["train_prefetch"])
    emit(report)
    return paths


#: struct_feats: the pipeline's first STRUCT_FUNCTIONS functions as a
#: dataset of their own, extracted with the structural channels and
#: trained at the flagship recipe (scripts/train_flagship.py: hidden 32,
#: 5 steps, cfg+dep, struct channels: d = 9 x 32 = 288) for one epoch;
#: `cli score` of its test functions runs at the serve budgets below, so
#: the CPU plain pass stays short
STRUCT_FUNCTIONS = 1024
STRUCT_DATASET = "pipeline-struct"
STRUCT_RUN = "struct"
STRUCT_OVERRIDES = ["model.struct_feats=true", "data.feat.struct_feats=true",
                    'data.gtype="cfg+dep"', "model.n_etypes=3", "model.hidden_dim=32",
                    "model.n_steps=5", "train.max_epochs=1", "train.log_every_steps=1",
                    "data.undersample=false"]
STRUCT_SERVE = ["serve.node_budget=4096", "serve.edge_budget=16384"]
#: scan: SCAN_FUNCTIONS of the struct dataset's functions, SCAN_PER_FILE a
#: file, over nested directories, plus a decoy in an excluded directory and
#: a generated file past scan.max_file_kb
SCAN_FUNCTIONS = 320
SCAN_PER_FILE = 8


def struct_feats_phase(torch, tmp: Path, smi: str) -> dict:
    """The structural-feature GGNN at the flagship recipe's width on the
    pipeline's storage root `tmp`: `cli extract` (a subprocess) of its
    first STRUCT_FUNCTIONS functions with `data.feat.struct_feats=true`
    (every node 4 + 5 columns, each struct column inside its vocabulary),
    `cli train` of one epoch on the card (d 288: kernel 1 n_steps times a
    forward batch, B3 and B4 n_steps times a backward batch, finite falling
    losses) and `cli score` of the test split's functions on the card and
    on the CPU plain path (fp32 gate). Then kernels 1 (fp32, every policy
    checked), 2, B3 and B4 at d 288 against their plain versions on the
    flagship batch with T 3 (the recipe's cfg+dep), timed beside their
    bounds. Returns (the launches of the train and score runs, the d 288
    rows)."""
    import io
    import pickle

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.data import load_examples
    from deepdfa_tpu_torch.frontend.structfeat import STRUCT_VOCAB
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    t_phase = time.perf_counter()
    pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    src_dir = tmp / "processed" / pcfg.data.dataset
    out = tmp / "processed" / STRUCT_DATASET
    out.mkdir(parents=True)
    examples = load_examples(src_dir / "examples.pkl")[:STRUCT_FUNCTIONS]
    ids = {str(e.id) for e in examples}
    with (out / "examples.pkl").open("wb") as f:
        pickle.dump(examples, f)
    splits = {k: v for k, v in json.loads((src_dir / "splits.json").read_text()).items()
              if k in ids}
    (out / "splits.json").write_text(json.dumps(splits))
    cfg = config_mod.apply_overrides(load(FLAGSHIP_CONFIG), [
        f'run_name="{STRUCT_RUN}"', f'data.dataset="{STRUCT_DATASET}"', *STRUCT_OVERRIDES])
    d = cfg.model.hidden_dim * (4 + len(STRUCT_VOCAB))
    report: dict = {"phase": "struct_feats", "nvidia_smi": smi, "functions": len(examples),
                    "d": d, "n_etypes": cfg.model.n_etypes}
    with storage_root(tmp) as env:
        cfg_path = tmp / "struct.json"
        config_mod.to_json(cfg, cfg_path)
        extract_s = run_port_cli(["extract", "--workers", str(PIPELINE_WORKERS), "--config",
                                  str(cfg_path)], env)
        store_dir = out / cli.graphs_dirname(cfg)
        graphs = GraphStore(store_dir).load_all()
        feats = np.concatenate([g.node_feats for g in graphs.values()])
        struct = feats[:, 4:]
        if feats.shape[1] != 9 or not all(
                0 <= struct[:, j].min() and struct[:, j].max() < v
                for j, v in enumerate(STRUCT_VOCAB)):
            fail(f"struct_feats: features {feats.shape}, struct columns outside "
                 f"{STRUCT_VOCAB}")
        if any(g.edge_type is None for g in graphs.values()):
            fail("struct_feats: a cfg+dep graph without edge types")
        report.update(graphs=len(graphs), nodes=int(feats.shape[0]), extract_seconds=extract_s,
                      struct_histogram=[np.bincount(struct[:, j], minlength=v).tolist()
                                        for j, v in enumerate(STRUCT_VOCAB)])

        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["train", "--config", str(cfg_path), "--device", CARD])
        train_s = time.perf_counter() - t0
        train_counts = gk.launch_counts()
        run = tmp / "runs" / STRUCT_RUN
        log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in log if "step" in r]
        steps = len(losses)
        n_steps = cfg.model.n_steps
        val_batches = len(cli.epoch_batches(cfg, cli.load_graph_splits(cfg)["val"],
                                            phase="eval"))
        want = {"LAUNCHES": n_steps * (steps + val_batches), "GRU_BWD_LAUNCHES": n_steps * steps,
                "DMSG_LAUNCHES": n_steps * steps}
        if steps < 2 or not all(math.isfinite(x) for x in losses) or \
                {k: train_counts[k] for k in want} != want:
            fail(f"struct_feats: train ran {steps} steps, losses {losses}, launched "
                 f"{train_counts}, expected {want}")
        model_cfg = config_mod.load(run / "config.json").model
        if not model_cfg.struct_feats:
            fail("struct_feats: the run's config lost model.struct_feats")
        report.update(train_seconds=train_s, train_steps=steps, train_losses=losses,
                      train_launches={k: train_counts[k] for k in want})

        # cli score of the test split's functions, on the card, then on the CPU
        test_ids = sorted(int(k) for k, v in splits.items() if v == "test" and int(k) in graphs)
        by_id = {e.id: e for e in examples}
        fns = tmp / "struct_src"
        names = write_sources(fns, [by_id[i] for i in test_ids])
        serve_args = ["--override", f'run_name="{STRUCT_RUN}"',
                      *(a for o in STRUCT_SERVE for a in ("--override", o))]
        gk.reset_launch_counts()
        card = cli_summary(cli, ["score", str(fns), "--out", str(tmp / "struct_card.jsonl"),
                                 "--device", CARD, *serve_args])
        score_counts = gk.launch_counts()
        cpu = cli_summary(cli, ["score", str(fns), "--out", str(tmp / "struct_cpu.jsonl"),
                                "--device", "cpu", *serve_args])
        card_rows = score_rows(tmp / "struct_card.jsonl")
        cpu_rows = score_rows(tmp / "struct_cpu.jsonl")
        if not all(card_rows[n]["ok"] and cpu_rows[n]["ok"] for n in names):
            fail("struct_feats: a test function failed to score")
        card_p = np.array([card_rows[n]["prob"] for n in names])
        cpu_p = np.array([cpu_rows[n]["prob"] for n in names])
        err = float(np.abs(card_p - cpu_p).max())
        if not np.all(np.isfinite(card_p)) or not np.allclose(card_p, cpu_p, rtol=RTOL,
                                                               atol=ATOL):
            fail(f"struct_feats: card vs CPU probabilities differ by up to {err}")
        if score_counts["LAUNCHES"] <= 0 or score_counts["LAUNCHES"] % n_steps:
            fail(f"struct_feats: cli score launched {score_counts}")
        report["score"] = {
            "functions": len(names), "card_vs_cpu_max_abs_err": err,
            **{f"card_{k}": card[k] for k in ("serve_seconds", "serve_requests_per_sec",
                                              "serve_batches", "ggnn_step_launches")},
            "cpu_serve_seconds": cpu["serve_seconds"]}

    # the kernels at d 288 on the flagship batch, T 3 as the recipe runs
    rng = np.random.default_rng(23)
    gen = torch.Generator().manual_seed(23)
    t = cfg.model.n_etypes
    b, edges, h, params = ggnn_case(torch, gen, full_batch(rng, 16384, 65536, t), t, d)
    n, e_live = b.node_budget, int(b.edge_mask.sum())
    tedges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t,
                              transpose=True)
    wm, _, wih, whh, bih, bhh = params
    a = torch.randn(n, d, generator=gen).to(CARD)
    g = (torch.randn(n, d, generator=gen) * 1e-2).to(CARD)
    errs = {}
    with torch.inference_mode():
        for accum in ("fp32", "bf16", "int8"):
            for scatter in ("fold", "mxu"):
                kw = dict(accum=accum, scatter=scatter)
                h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True, **kw)
                want_h, want_a = gk.ggnn_step_plain(
                    h, edges, *params, accum, scatter,
                    gk.edge_block(b.edge_budget) if scatter == "mxu" else 0)
                torch.cuda.synchronize()
                errs[f"step_{accum}_{scatter}"] = max(
                    step_check(torch, f"struct_feats d {d} step {accum} {scatter} {w}", x, y)
                    for w, x, y in (("h", h_k, want_h), ("a", a_k, want_a)))
        h_f, _ = gk.ggnn_fused(h, edges, *params, n_steps=n_steps)
        states = [h]
        for _ in range(n_steps):
            states.append(gk.ggnn_step(states[-1], edges, *params)[0])
        plain_f, _ = gk.ggnn_fused_plain(h, edges, *params, n_steps=n_steps)
        torch.cuda.synchronize()
        if not torch.equal(h_f, states[-1]):
            fail(f"struct_feats: kernel 2 at d {d} differs from {n_steps} launches of kernel 1")
        errs["fused"] = step_check(torch, f"struct_feats d {d} fused", h_f, plain_f)
        got_b3 = gk.gru_bwd(h, a, wih, whh, bih, bhh, g)
        want_b3 = gk.gru_bwd_plain(h, a, wih, whh, bih, bhh, g)
        got_in = gk.gru_bwd(h, a, wih, whh, bih, bhh, g, weights=False)
        got_b4 = gk.dmsg(a, tedges, wm, got_b3[1].clone())
        want_b4 = gk.dmsg_plain(a, tedges, wm, got_b3[1].clone())
        torch.cuda.synchronize()
        errs["gru_bwd"] = 0.0
        for what, x, y in zip(("da", "dh", "dwih", "dwhh", "dbih", "dbhh"), got_b3, want_b3):
            tol = ATOL * max(1.0, y.abs().max().item()) if what[:2] in ("dw", "db") else ATOL
            err = (x - y).abs().max().item()
            if not torch.isfinite(x).all() or not torch.allclose(x, y, rtol=RTOL, atol=tol):
                fail(f"struct_feats: B3 at d {d} {what} differs from the plain version by {err}")
            errs["gru_bwd"] = max(errs["gru_bwd"], err)
        if not (torch.equal(got_in[0], got_b3[0]) and torch.equal(got_in[1], got_b3[1])):
            fail(f"struct_feats: B3's input-only form at d {d} changed da or dh")
        errs["dmsg"] = step_check(torch, f"struct_feats d {d} B4", got_b4, want_b4)
        rows = {
            "ggnn_step": {"ms": median_ms(torch, lambda: gk.ggnn_step(h, edges, *params)),
                          "plain_ms": median_ms(torch, lambda: gk.ggnn_step_plain(
                              h, edges, *params)),
                          **dict(zip(("bound_ms", "bound_by"),
                                     step_bound(n, e_live, d, t, with_aggregate=False)))},
            "ggnn_fused": {"ms": median_ms(torch, lambda: gk.ggnn_fused(
                               h, edges, *params, n_steps=n_steps)),
                           "plain_ms": median_ms(torch, lambda: gk.ggnn_fused_plain(
                               h, edges, *params, n_steps=n_steps)),
                           **dict(zip(("bound_ms", "bound_by"),
                                      fused_bound(n, e_live, d, t, "fp32", n_steps, False))),
                           **fused_grid(torch, gk, "fp32", "fold", n, d)},
            "ggnn_gru_bwd": {"ms": median_ms(torch, lambda: gk.gru_bwd(h, a, wih, whh, bih, bhh,
                                                                       g)),
                             "plain_ms": median_ms(torch, lambda: gk.gru_bwd_plain(
                                 h, a, wih, whh, bih, bhh, g)),
                             "input_only_ms": median_ms(torch, lambda: gk.gru_bwd(
                                 h, a, wih, whh, bih, bhh, g, weights=False)),
                             **dict(zip(("bound_ms", "bound_by"), gru_bwd_bound(n, d)))},
        }
        dh = got_b3[1].clone()
        rows["ggnn_dmsg"] = {"ms": median_ms(torch, lambda: gk.dmsg(a, tedges, wm, dh)),
                             "plain_ms": median_ms(torch, lambda: gk.dmsg_plain(
                                 a, tedges, wm, dh)),
                             **dict(zip(("bound_ms", "bound_by"),
                                        dmsg_bound(n, e_live, d, t, add=True)))}
    for name, row in rows.items():
        row["max_abs_err"] = errs[{"ggnn_step": "step_fp32_fold", "ggnn_fused": "fused",
                                   "ggnn_gru_bwd": "gru_bwd", "ggnn_dmsg": "dmsg"}[name]]
    report.update(kernels={"n": n, "e": b.edge_budget, "e_live": e_live, "d": d, "n_etypes": t,
                           "max_abs_err": errs, "rows": rows},
                  phase_seconds=time.perf_counter() - t_phase)
    paths = {"struct_train": {"ggnn_step": train_counts["LAUNCHES"],
                              "ggnn_gru_bwd": train_counts["GRU_BWD_LAUNCHES"],
                              "ggnn_dmsg": train_counts["DMSG_LAUNCHES"]},
             "struct_score": {"ggnn_step": score_counts["LAUNCHES"]}}
    report["launches"] = paths
    emit(report)
    return paths, rows


def scan_phase(torch, tmp: Path, smi: str) -> dict:
    """`cli scan --lines` on the card with the struct_feats phase's run
    (d 288) over a repository written from SCAN_FUNCTIONS of its
    functions: cold (every function extracted, scored and attributed:
    kernel 1, B3 and B4 at d 288, counted from 0), then again after one
    function is edited (one extraction, every other function reused).
    Each scan's SARIF valid, every finding's probability the one `cli
    score` gives the same function on the card (fp32 gate) and every
    finding of the re-scan the cold scan's but the edited one. Returns
    the cold scan's launches."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.data import load_examples
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.scan import validate_sarif
    from deepdfa_tpu_torch.scan.walker import split_functions

    t_phase = time.perf_counter()
    examples = load_examples(tmp / "processed" / STRUCT_DATASET / "examples.pkl")
    examples = examples[-SCAN_FUNCTIONS:]
    repo = tmp / "scan_repo"
    for k in range(0, len(examples), SCAN_PER_FILE):
        sub = repo / "src" / ("core" if k % (2 * SCAN_PER_FILE) == 0 else "util") / \
            f"part_{k // (4 * SCAN_PER_FILE)}"
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"mod_{k // SCAN_PER_FILE:03d}.c").write_text(
            "\n".join(e.code for e in examples[k:k + SCAN_PER_FILE]) + "\n")
    (repo / ".git").mkdir()
    (repo / ".git" / "decoy.c").write_text("int decoy(void) { return 1; }\n")
    (repo / "third_party").mkdir()
    (repo / "third_party" / "vendored.c").write_text("int vendored(void) { return 2; }\n")
    (repo / "gen").mkdir()
    (repo / "gen" / "amalgamated.c").write_text("int filler;\n" * (1024 * 1024 // 12 + 1))
    # each function alone, for `cli score`
    fns = tmp / "scan_fns"
    fns.mkdir()
    spans = {}
    for path in sorted(repo.glob("src/**/*.c")):
        for sp in split_functions(path.read_text()):
            rel = path.relative_to(repo).as_posix()
            spans[(rel, sp.name, sp.start_line)] = sp
            (fns / f"{len(spans):04d}.c").write_text(sp.code)
    run_arg = ["--override", f'run_name="{STRUCT_RUN}"',
               *(a for o in STRUCT_SERVE for a in ("--override", o))]
    report: dict = {"phase": "scan", "nvidia_smi": smi, "functions_written": len(examples),
                    "files": len(list(repo.glob("src/**/*.c"))), "functions_split": len(spans)}
    with storage_root(tmp):
        gk.reset_launch_counts()
        cold = cli_summary(cli, ["scan", str(repo), "--lines", "--device", CARD, *run_arg])
        counts = gk.launch_counts()
        findings = [json.loads(x) for x in Path(cold["scores_path"]).read_text().splitlines()]
        sarif_cold = json.loads(Path(cold["sarif_path"]).read_text())
        score = cli_summary(cli, ["score", str(fns), "--out", str(tmp / "scan_scores.jsonl"),
                                  "--device", CARD, *run_arg])
        # one statement into the second function of the first file: its
        # later functions move down a line, their bytes unchanged
        target = sorted(repo.glob("src/**/*.c"))[0]
        text = target.read_text()
        edited = split_functions(text)[1]
        lines = text.split("\n")
        lines.insert(edited.start_line, "  int scan_smoke_edited = 1;")
        target.write_text("\n".join(lines))
        edited_file, edited_fn = target.relative_to(repo).as_posix(), edited.name
        incr = cli_summary(cli, ["scan", str(repo), "--lines", "--device", CARD, *run_arg])
        findings2 = [json.loads(x) for x in Path(incr["scores_path"]).read_text().splitlines()]
        sarif_incr = json.loads(Path(incr["sarif_path"]).read_text())
    rows = score_rows(tmp / "scan_scores.jsonl")
    by_code = {sp.code: rows[str(fns / f"{k + 1:04d}.c")] for k, sp in enumerate(spans.values())}
    problems = validate_sarif(sarif_cold) + validate_sarif(sarif_incr)
    if problems:
        fail(f"scan: invalid SARIF: {problems}")
    n = len(spans)
    if (cold["scan_functions"] != n or cold["scan_extracted"] != n or cold["scan_reused"]
            or cold["scan_scored"] != n or cold["scan_files"] != report["files"]
            or cold["scan_files_skipped"] != 1):
        fail(f"scan: the cold scan's counts {cold} do not match {n} functions in "
             f"{report['files']} files and one oversized file")
    if incr["scan_extracted"] != 1 or incr["scan_reused"] != n - 1 or \
            incr["scan_functions"] != n:
        fail(f"scan: the re-scan after one edit extracted {incr['scan_extracted']} and "
             f"reused {incr['scan_reused']} of {n}")
    if not all(f["ok"] and f.get("lines") for f in findings):
        fail("scan: a finding without a probability or line attributions")
    worst = 0.0
    for f in findings:
        sp = spans[(f["file"], f["function"], f["start_line"])]
        row = by_code[sp.code]
        if not row["ok"]:
            fail(f"scan: cli score could not score {f['function']} of {f['file']}")
        err = abs(f["prob"] - row["prob"])
        worst = max(worst, err)
        if err > ATOL + RTOL * abs(row["prob"]):
            fail(f"scan: {f['file']}:{f['function']} scanned {f['prob']}, scored {row['prob']}")
        if not all(sp.start_line <= la["line"] <= sp.end_line for la in f["lines"]):
            fail(f"scan: a line attribution of {f['function']} lies outside its function")
    same = {(f["file"], f["function"]): f["prob"] for f in findings}
    changed = [f for f in findings2 if (f["file"], f["function"]) != (edited_file, edited_fn)
               and f["prob"] != same[(f["file"], f["function"])]]
    if changed:
        fail(f"scan: the re-scan changed {len(changed)} unedited findings")
    for k in ("ggnn_step", "ggnn_gru_bwd", "ggnn_dmsg"):
        key = {"ggnn_step": "LAUNCHES", "ggnn_gru_bwd": "GRU_BWD_LAUNCHES",
               "ggnn_dmsg": "DMSG_LAUNCHES"}[k]
        if counts[key] <= 0:
            fail(f"scan: the cold scan launched {k} no time: {counts}")
    split = ("walk", "split", "frontend", "score", "attribute", "write")
    report.update(
        cold={**{k: cold[f"scan_{k}"] for k in ("seconds", "functions_per_sec", "findings",
                                                "cache_hit_fraction")},
              "seconds_by_stage": {s: cold[f"scan_{s}_seconds"] for s in split}},
        incremental={**{k: incr[f"scan_{k}"] for k in ("seconds", "functions_per_sec",
                                                       "extracted", "reused",
                                                       "incremental_skip_fraction")},
                     "seconds_by_stage": {s: incr[f"scan_{s}_seconds"] for s in split}},
        sarif_results=len(sarif_cold["runs"][0]["results"]),
        findings_with_lines=sum(1 for f in findings if f.get("lines")),
        scan_vs_score_max_abs_err=worst, score_requests_per_sec=score["serve_requests_per_sec"],
        edited=[edited_file, edited_fn],
        launches={"LAUNCHES": counts["LAUNCHES"], "GRU_BWD_LAUNCHES": counts["GRU_BWD_LAUNCHES"],
                  "DMSG_LAUNCHES": counts["DMSG_LAUNCHES"]},
        phase_seconds=time.perf_counter() - t_phase)
    emit(report)
    return {"scan": {"ggnn_step": counts["LAUNCHES"], "ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"],
                     "ggnn_dmsg": counts["DMSG_LAUNCHES"]}}


#: dataflow_bits: the pipeline's first BITS_FUNCTIONS functions as a
#: dataset of their own extracted with the reaching-definitions bits of
#: BITS_MAX_DEFS definition sites, trained one epoch under
#: dataflow_solution_out at the flagship recipe (hidden 32, 5 steps, d
#: 128); 512, not struct_feats' 1024, to keep the script inside its limit
BITS_FUNCTIONS = 512
BITS_DATASET = "pipeline-bits"
BITS_RUN = "bits"
BITS_MAX_DEFS = 64
BITS_OVERRIDES = [f"data.feat.max_defs={BITS_MAX_DEFS}", "model.label_style=dataflow_solution_out",
                  "train.max_epochs=1", "train.log_every_steps=1", "data.undersample=false"]
#: exact-solver labels, and the card against the CPU plain path
BITS_TOL = 1e-5
#: bf16_params: the pipeline's flagship store trained one epoch with the
#: parameters stored in bfloat16; the card against the CPU plain path
#: within BITS_TOL, the same weights upcast into an fp32 model within
#: BF16_VS_FP32_TOL
BF16_RUN = "bf16"
BF16_VS_FP32_TOL = 5e-2
#: moe_combined: the combined training path at codebert-base width with
#: the MoE adapter, MOE_STEPS steps on 16-row T 512 batches
MOE_EXPERTS, MOE_TOP_K, MOE_STEPS = 8, 2, 4
MOE_TOL = 1e-5


def subset_dataset(tmp: Path, dataset: str, n: int):
    """The pipeline dataset's first `n` functions as `dataset` under the
    storage root `tmp` (examples.pkl and splits.json); (examples, splits)."""
    import pickle

    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.data import load_examples

    pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    src_dir = tmp / "processed" / pcfg.data.dataset
    out = tmp / "processed" / dataset
    out.mkdir(parents=True)
    examples = load_examples(src_dir / "examples.pkl")[:n]
    ids = {str(e.id) for e in examples}
    with (out / "examples.pkl").open("wb") as f:
        pickle.dump(examples, f)
    splits = {k: v for k, v in json.loads((src_dir / "splits.json").read_text()).items()
              if k in ids}
    (out / "splits.json").write_text(json.dumps(splits))
    return examples, splits


def run_log(run: Path) -> list:
    return [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]


def gather_sum_bound(n: int, e_live: int, b: int):
    """The least time of one fixed-order segment sum
    (`nn/setops.py:gather_sum_work`)."""
    from deepdfa_tpu_torch.nn import setops

    return roofline(*setops.gather_sum_work(n, e_live, b))


def dataflow_bits_phase(torch, tmp: Path, smi: str):
    """The dataflow_solution_out path on the pipeline's storage root: `cli
    extract` (a subprocess) of BITS_FUNCTIONS functions with
    `data.feat.max_defs=64`, `cli train` of one epoch on the card at the
    flagship recipe (kernel 1, B3, B4 and the segment-sum kernel counted,
    the step losses finite and falling) and `cli test`. Checks: without
    the gate and with n_steps = the batch's largest graph + 1,
    `BitvectorPropagation` (both unions) on the card gives the stored IN
    and OUT bits of one packed batch of the CFG edges (packed without the
    self-loops the model's batches carry) within BITS_TOL, twice to the
    bit; the trained model's node logits on the card are those of the CPU
    plain path within BITS_TOL; a training step's gradients repeat to the
    bit. Then the segment-sum kernel against its plain version on a
    flagship training batch, timed beside its bound and `index_add_`.
    Returns (the paths' launches, the kernel's row)."""
    import io

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.graphs import GraphStore, pack
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.nn import setops
    from deepdfa_tpu_torch.nn.bitprop import BitvectorPropagation
    from deepdfa_tpu_torch.train import CheckpointManager, GraphTrainer

    t_phase = time.perf_counter()
    examples, _ = subset_dataset(tmp, BITS_DATASET, BITS_FUNCTIONS)
    cfg = config_mod.apply_overrides(load(FLAGSHIP_CONFIG), [
        f'run_name="{BITS_RUN}"', f'data.dataset="{BITS_DATASET}"', *BITS_OVERRIDES])
    n_steps = cfg.model.n_steps
    report: dict = {"phase": "dataflow_bits", "nvidia_smi": smi, "functions": len(examples),
                    "max_defs": BITS_MAX_DEFS, "label_style": cfg.model.label_style,
                    "d": 4 * cfg.model.hidden_dim}

    def counts() -> dict:
        return {**gk.launch_counts(), "SETOPS": setops.LAUNCHES}

    def reset() -> None:
        gk.reset_launch_counts()
        setops.reset_launch_counts()

    with storage_root(tmp) as env:
        cfg_path = tmp / "bits.json"
        config_mod.to_json(cfg, cfg_path)
        extract_s = run_port_cli(["extract", "--workers", str(PIPELINE_WORKERS), "--config",
                                  str(cfg_path)], env)
        graphs = GraphStore(tmp / "processed" / BITS_DATASET / cli.graphs_dirname(cfg)).load_all()
        if any(g.node_gen is None or g.node_gen.shape[1] != BITS_MAX_DEFS
               for g in graphs.values()):
            fail("dataflow_bits: a graph of the store without its bits")
        set_bits = int(sum(g.node_bits_out.sum() for g in graphs.values()))
        report.update(graphs=len(graphs), extract_seconds=extract_s, label_bits_set=set_bits,
                      nodes=int(sum(g.num_nodes for g in graphs.values())))
        if set_bits <= 0:
            fail("dataflow_bits: the store has no reaching definition")

        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["train", "--config", str(cfg_path), "--device", CARD])
        train_s = time.perf_counter() - t0
        train_counts = counts()
        run = tmp / "runs" / BITS_RUN
        losses = [r["loss"] for r in run_log(run) if "step" in r]
        steps = len(losses)
        splits = cli.load_graph_splits(cfg)
        val_batches = len(cli.epoch_batches(cfg, splits["val"], phase="eval"))
        test_batches = len(cli.epoch_batches(cfg, splits["test"], phase="eval"))
        # the segment sum: n_steps a forward batch, n_steps - 1 a backward
        # (the first step's input is the stored gen bits, which take no gradient)
        want = {"LAUNCHES": n_steps * (steps + val_batches), "GRU_BWD_LAUNCHES": n_steps * steps,
                "DMSG_LAUNCHES": n_steps * steps,
                "SETOPS": n_steps * (steps + val_batches) + (n_steps - 1) * steps}
        if steps < 2 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] \
                or {k: train_counts[k] for k in want} != want:
            fail(f"dataflow_bits: train ran {steps} steps, losses {losses}, launched "
                 f"{train_counts}, expected {want}")
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["test", "--device", CARD, f'run_name="{BITS_RUN}"'])
        test_s = time.perf_counter() - t0
        test_counts = counts()
        metrics = json.loads((run / "test_metrics_test.json").read_text())
        want_test = {"LAUNCHES": n_steps * test_batches, "SETOPS": n_steps * test_batches}
        if {k: test_counts[k] for k in want_test} != want_test or \
                not math.isfinite(metrics["loss"]):
            fail(f"dataflow_bits: test launched {test_counts} (expected {want_test}), "
                 f"metrics {metrics}")
        report.update(train_seconds=train_s, train_steps=steps, train_losses=losses,
                      train_launches={k: train_counts[k] for k in want}, test_seconds=test_s,
                      test_batches=test_batches, test_launches=want_test,
                      test_metrics={k: metrics[k] for k in ("loss", "acc", "f1", "precision",
                                                             "recall")})

        # the exact simulator on one packed batch of the stored CFG edges
        bcfg = cfg.data.batch
        chosen, nodes, edges = [], 0, 0
        for g in sorted(graphs.values(), key=lambda g: g.graph_id):
            if (len(chosen) < bcfg.graphs_per_batch and nodes + g.num_nodes <= bcfg.node_budget
                    and edges + g.num_edges <= bcfg.edge_budget):
                chosen.append(g)
                nodes, edges = nodes + g.num_nodes, edges + g.num_edges
        b = pack(chosen, bcfg.graphs_per_batch, bcfg.node_budget, bcfg.edge_budget,
                 add_self_loops=False).to(CARD)
        exact_steps = max(g.num_nodes for g in chosen) + 1
        live = b.node_mask[:, None]
        exact = {}
        t0 = time.perf_counter()
        with torch.inference_mode():
            for union in ("relu", "simple"):
                prop = BitvectorPropagation(exact_steps, union)
                runs = [prop(b.node_gen, b.node_kill, b.edge_src, b.edge_dst, b.edge_mask)
                        for _ in range(2)]
                (i1, o1), (i2, o2) = runs
                err = max(float(((i1 - b.node_bits_in).abs() * live).max()),
                          float(((o1 - b.node_bits_out).abs() * live).max()))
                if err > BITS_TOL or not (torch.equal(i1, i2) and torch.equal(o1, o2)):
                    fail(f"dataflow_bits: the {union} propagation on the card is {err} from the "
                         "stored labels, or a repeat gave other bits")
                exact[union] = err
        torch.cuda.synchronize()
        report["exact_solver"] = {"graphs": len(chosen), "nodes": nodes, "edges": edges,
                                  "n_steps": exact_steps, "max_abs_err": exact,
                                  "bits_equal_on_repeat": True,
                                  "seconds": time.perf_counter() - t0}

        # the trained model: node logits on the card and on the CPU
        state = CheckpointManager(run / cli.CHECKPOINTS_DIR).restore("best")["model"]
        batch = cli.epoch_batches(cfg, splits["test"], phase="eval")[0]
        logits = {}
        for dev in (CARD, "cpu"):
            model = cli._model(cfg)
            model.load_state_dict(state)
            model = model.to(dev).eval()
            with torch.inference_mode():
                logits[dev] = model(batch.to(dev)).cpu()
        mask = torch.as_tensor(np.asarray(batch.node_mask))
        got, want_l = logits[CARD][mask], logits["cpu"][mask]
        logit_err = float((got - want_l).abs().max())
        if got.shape[1] != BITS_MAX_DEFS or not torch.isfinite(got).all() or \
                not torch.allclose(got, want_l, rtol=BITS_TOL, atol=BITS_TOL):
            fail(f"dataflow_bits: card vs CPU node logits differ by up to {logit_err}")

        # one training step's gradients, twice from the same weights
        trainer = GraphTrainer(cli._model(cfg), cfg, total_steps=1, device=CARD)
        tstate = trainer.init_state(params=state)
        tb = cli.epoch_batches(cfg, splits["train"], shuffle_epoch=0)[0].to(CARD)
        grads = []
        for _ in range(2):
            trainer.forward_loss(tstate, tb).backward()
            grads.append({k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()})
        if not all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0]):
            fail("dataflow_bits: two backward passes on one batch gave other gradients")
        report.update(card_vs_cpu_logit_max_abs_err=logit_err, grads_bit_equal=True)

    # the segment-sum kernel on a flagship training batch (its cfg edges)
    n, bw = tb.node_budget, BITS_MAX_DEFS
    e_live = int(tb.edge_mask.sum())
    gen = torch.Generator().manual_seed(29)
    y = torch.rand(n, bw, generator=gen).to(CARD)
    idx, ptr, t_idx, t_ptr = setops.edge_runs(tb.edge_src, tb.edge_dst, tb.edge_mask, n)
    live_e = tb.edge_mask.bool()
    src_l, dst_l = tb.edge_src[live_e].long(), tb.edge_dst[live_e].long()
    with torch.inference_mode():
        errs = []
        for a, p in ((idx, ptr), (t_idx, t_ptr)):
            k_out, p_out = setops.gather_sum(y, a, p), setops.gather_sum_plain(y, a, p)
            torch.cuda.synchronize()
            errs.append(float((k_out - p_out).abs().max()))
        lib = torch.zeros(n, bw, device=CARD).index_add_(0, dst_l, y[src_l])
        errs.append(float((setops.gather_sum(y, idx, ptr) - lib).abs().max()))
        if max(errs[:2]) > 0.0 or errs[2] > BITS_TOL:
            fail(f"dataflow_bits: the segment-sum kernel differs from its plain version "
                 f"({errs[:2]}) or from index_add_ ({errs[2]})")
        row = {"ms": median_ms(torch, lambda: setops.gather_sum(y, idx, ptr)),
               "plain_ms": median_ms(torch, lambda: setops.gather_sum_plain(y, idx, ptr)),
               "library_ms": median_ms(torch, lambda: torch.zeros(n, bw, device=CARD)
                                       .index_add_(0, dst_l, y[src_l])),
               "transposed_ms": median_ms(torch, lambda: setops.gather_sum(y, t_idx, t_ptr)),
               **dict(zip(("bound_ms", "bound_by"), gather_sum_bound(n, e_live, bw))),
               "max_abs_err": max(errs[:2]), "vs_index_add_max_abs_err": errs[2],
               "n": n, "e_live": e_live, "b": bw}
    report.update(kernel=row, phase_seconds=time.perf_counter() - t_phase)
    paths = {"bits_train": {"ggnn_step": train_counts["LAUNCHES"],
                            "ggnn_gru_bwd": train_counts["GRU_BWD_LAUNCHES"],
                            "ggnn_dmsg": train_counts["DMSG_LAUNCHES"],
                            "setops_gather_sum": train_counts["SETOPS"]},
             "bits_test": {"ggnn_step": test_counts["LAUNCHES"],
                           "setops_gather_sum": test_counts["SETOPS"]}}
    report["launches"] = paths
    emit(report)
    return paths, row


def bf16_params_phase(torch, tmp: Path, smi: str) -> dict:
    """`model.param_dtype=bfloat16` on the pipeline's flagship store (no
    new extraction): `cli train` of one epoch on the card (kernel 1, B3
    and B4 counted, finite losses), every floating leaf of its checkpoint
    bf16, `cli score` of the test split's functions on the card and on
    the CPU plain path (within BITS_TOL), the same weights upcast into an
    fp32 model on a test batch (within BF16_VS_FP32_TOL), and one
    saliency localization batch on the card. Returns the paths'
    launches."""
    import io

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.data import load_examples
    from deepdfa_tpu_torch.eval import localize
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import CheckpointManager

    t_phase = time.perf_counter()
    pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    cfg = config_mod.apply_overrides(pcfg, [f'run_name="{BF16_RUN}"', "model.param_dtype=bfloat16",
                                            "train.max_epochs=1"])
    n_steps = cfg.model.n_steps
    report: dict = {"phase": "bf16_params", "nvidia_smi": smi,
                    "param_dtype": cfg.model.param_dtype}
    with storage_root(tmp):
        cfg_path = tmp / "bf16.json"
        config_mod.to_json(cfg, cfg_path)
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["train", "--config", str(cfg_path), "--device", CARD])
        train_s = time.perf_counter() - t0
        train_counts = gk.launch_counts()
        run = tmp / "runs" / BF16_RUN
        log = run_log(run)
        losses = [r["loss"] for r in log if "step" in r]
        steps = len(losses)
        splits = cli.load_graph_splits(cfg)
        val_batches = len(cli.epoch_batches(cfg, splits["val"], phase="eval"))
        want = {"LAUNCHES": n_steps * (steps + val_batches), "GRU_BWD_LAUNCHES": n_steps * steps,
                "DMSG_LAUNCHES": n_steps * steps}
        if steps < 2 or not all(math.isfinite(x) for x in losses) or \
                {k: train_counts[k] for k in want} != want:
            fail(f"bf16_params: train ran {steps} steps, losses {losses}, launched "
                 f"{train_counts}, expected {want}")
        state = CheckpointManager(run / cli.CHECKPOINTS_DIR).restore("best")["model"]
        dtypes = sorted({str(v.dtype) for v in state.values() if v.is_floating_point()})
        if dtypes != ["torch.bfloat16"]:
            fail(f"bf16_params: the checkpoint holds {dtypes}")
        report.update(train_seconds=train_s, train_steps=steps, train_losses=losses,
                      epoch_seconds=[r["epoch_seconds"] for r in log if "epoch" in r],
                      train_launches={k: train_counts[k] for k in want},
                      checkpoint_dtypes=dtypes, checkpoint_leaves=len(state))

        # cli score of the test split's functions, on the card, then on the CPU
        by_id = {e.id: e for e in load_examples(
            tmp / "processed" / cfg.data.dataset / "examples.pkl")}
        test_ids = sorted(g.graph_id for g in splits["test"])
        fns = tmp / "bf16_src"
        names = write_sources(fns, [by_id[i] for i in test_ids])
        serve_args = ["--override", f'run_name="{BF16_RUN}"',
                      *(a for o in STRUCT_SERVE for a in ("--override", o))]
        gk.reset_launch_counts()
        card = cli_summary(cli, ["score", str(fns), "--out", str(tmp / "bf16_card.jsonl"),
                                 "--device", CARD, *serve_args])
        score_counts = gk.launch_counts()
        cli_summary(cli, ["score", str(fns), "--out", str(tmp / "bf16_cpu.jsonl"),
                          "--device", "cpu", *serve_args])
        card_rows = score_rows(tmp / "bf16_card.jsonl")
        cpu_rows = score_rows(tmp / "bf16_cpu.jsonl")
        if not all(card_rows[n]["ok"] and cpu_rows[n]["ok"] for n in names):
            fail("bf16_params: a test function failed to score")
        card_p = np.array([card_rows[n]["prob"] for n in names])
        cpu_p = np.array([cpu_rows[n]["prob"] for n in names])
        score_err = float(np.abs(card_p - cpu_p).max())
        if not np.all(np.isfinite(card_p)) or not np.allclose(card_p, cpu_p, rtol=BITS_TOL,
                                                               atol=BITS_TOL):
            fail(f"bf16_params: card vs CPU probabilities differ by up to {score_err}")
        if score_counts["LAUNCHES"] <= 0 or score_counts["LAUNCHES"] % n_steps:
            fail(f"bf16_params: cli score launched {score_counts}")

        # the bf16 model against its weights upcast into an fp32 model
        batch = cli.epoch_batches(cfg, splits["test"], phase="eval")[0].to(CARD)
        half = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim)
        half.load_state_dict(state)
        full = DeepDFA.from_config(dataclasses.replace(cfg.model, param_dtype="float32"),
                                   cfg.data.feat.input_dim)
        full.load_state_dict({k: v.float() for k, v in state.items()})
        half, full = half.to(CARD).eval(), full.to(CARD).eval()
        with torch.inference_mode():
            p_half, p_full = torch.sigmoid(half(batch)), torch.sigmoid(full(batch))
        valid = batch.graph_mask
        upcast_err = float((p_half - p_full)[valid].abs().max())
        if upcast_err > BF16_VS_FP32_TOL or not torch.isfinite(p_half).all():
            fail(f"bf16_params: the bf16 model is {upcast_err} from its fp32 upcast")

        # one saliency localization batch through the bf16 model
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        probs, scores = localize.ggnn_score_fn("saliency", half)(batch)
        torch.cuda.synchronize()
        loc_s = time.perf_counter() - t0
        loc_counts = gk.launch_counts()
        loc_err = float((probs - p_half)[valid].abs().max())
        if not torch.isfinite(scores).all() or loc_err > BITS_TOL or \
                min(loc_counts[k] for k in ("LAUNCHES", "GRU_BWD_LAUNCHES", "DMSG_LAUNCHES")) <= 0:
            fail(f"bf16_params: saliency gave non-finite scores, probabilities {loc_err} from "
                 f"the model's, or launched {loc_counts}")
    report.update(score={"functions": len(names), "card_vs_cpu_max_abs_err": score_err,
                         **{f"card_{k}": card[k] for k in ("serve_seconds",
                                                           "serve_requests_per_sec",
                                                           "serve_batches")}},
                  bf16_vs_fp32_upcast_max_abs_err=upcast_err,
                  saliency={"seconds": loc_s, "prob_vs_model_max_abs_err": loc_err,
                            "graphs": int(valid.sum())},
                  phase_seconds=time.perf_counter() - t_phase)
    paths = {"bf16_train": {"ggnn_step": train_counts["LAUNCHES"],
                            "ggnn_gru_bwd": train_counts["GRU_BWD_LAUNCHES"],
                            "ggnn_dmsg": train_counts["DMSG_LAUNCHES"]},
             "bf16_score": {"ggnn_step": score_counts["LAUNCHES"]},
             "bf16_localize": {"ggnn_step": loc_counts["LAUNCHES"],
                               "ggnn_gru_bwd": loc_counts["GRU_BWD_LAUNCHES"],
                               "ggnn_dmsg": loc_counts["DMSG_LAUNCHES"]}}
    report["launches"] = paths
    emit(report)
    return paths


def moe_combined_phase(torch, smi: str) -> dict:
    """The combined training path with the MoE adapter (MOE_EXPERTS
    experts, top MOE_TOP_K) at codebert-base width, bf16 activations,
    dropout 0.1: MOE_STEPS `CombinedTrainer` steps on the 16-row T 512
    batches of the training corpus, then one serving forward of those
    rows through `score_combined`, with kernels 5-7 and the GGNN kernels
    counted. Checks: finite losses and aux; the MoE block on the last
    step's [CLS] rows in fp32 on the card and on the CPU (the same
    dispatch, outputs and aux within MOE_TOL); the block and a training
    step's gradients the same bits on a repeat. Then one step under
    torch.profiler (device time by group, idle share). Returns the
    paths' launches."""
    import numpy as np

    from deepdfa_tpu_torch.data import collate_plan, lengths_for, plan_bucketed_batches
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.parallel import moe
    from deepdfa_tpu_torch.serve import score_combined
    from deepdfa_tpu_torch.train import CombinedTrainer

    t_phase = time.perf_counter()
    cfg, mcfg = combined_train_setup(torch)
    mcfg = dataclasses.replace(mcfg, moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K)
    tok = tokenizer("roberta")
    token_ids, labels, graphs = training_corpus(np.random.default_rng(21),
                                                cfg.data.feat.input_dim, tok)
    bcfg = cfg.data.batch
    order = sorted(token_ids)
    plans = [p for p in plan_bucketed_batches(
        lengths_for(token_ids, order, tok.pad_id), order, COMBINED_BUCKETS,
        cfg.data.token_budget, 1, bcfg.node_budget, bcfg.edge_budget) if p.seq_len == 512]
    batches = [collate_plan(p, token_ids, labels, graphs, pad_id=tok.pad_id) for p in plans]
    shapes = [list(b.input_ids.shape) for b in batches]
    if not batches or any(s != [16, 512] for s in shapes):
        fail(f"moe_combined: planned T 512 batches {shapes}, want 16 x 512")
    trainer = CombinedTrainer(cfg, mcfg, total_steps=MOE_STEPS, device=CARD)
    t0 = time.perf_counter()
    state = trainer.init_state(seed=0)
    init_s = time.perf_counter() - t0
    seen = []
    hook = state.model.moe.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].detach(), out[1].detach())))

    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = fa.DBIAS_LAUNCHES = 0
    gk.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(MOE_STEPS):
        b = batches[i % len(batches)].to(trainer.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(state, b, fold_seed(0, i))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    train = {"flash_fwd": fa.LAUNCHES, "flash_dq": fa.DQ_LAUNCHES, "flash_dkv": fa.DKV_LAUNCHES,
             "ggnn_step": gk.LAUNCHES, "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES,
             "ggnn_dmsg": gk.DMSG_LAUNCHES}
    L, S = mcfg.encoder.num_layers, mcfg.graph_n_steps
    want = {"flash_fwd": 2 * L * MOE_STEPS, "flash_dq": L * MOE_STEPS, "flash_dkv": L * MOE_STEPS,
            "ggnn_step": S * MOE_STEPS, "ggnn_gru_bwd": S * MOE_STEPS,
            "ggnn_dmsg": S * MOE_STEPS}
    auxes = [float(a) for _, a in seen]
    if train != want or not all(math.isfinite(x) for x in losses + auxes) or \
            len(auxes) != MOE_STEPS:
        fail(f"moe_combined: launched {train} (expected {want}), losses {losses}, aux {auxes}")
    cls_rows = seen[-1][0]
    hook.remove()

    # one serving forward of the last batch's rows (ties: its padded rows)
    ids = [i for i in plans[(MOE_STEPS - 1) % len(plans)].example_ids]
    payloads = [(token_ids[i], graphs[i]) for i in ids]
    state.model.eval()
    fa.LAUNCHES = 0
    gk.reset_launch_counts()
    summary = score_combined(state.model, payloads, cfg, tok, device=CARD)
    serve = {"flash_fwd": fa.LAUNCHES, "ggnn_step": gk.LAUNCHES}
    probs = np.asarray(summary.pop("probs"), dtype=np.float64)
    if summary["serve_scored"] != len(payloads) or not np.all(np.isfinite(probs)) or \
            min(serve.values()) <= 0:
        fail(f"moe_combined: serving scored {summary['serve_scored']}/{len(payloads)}, "
             f"launched {serve}")

    # the MoE block on the last step's [CLS] rows, fp32, card and CPU
    block = state.model.moe
    x32 = cls_rows.float()
    with torch.inference_mode():
        cap = moe.capacity(block.cfg, x32.shape[0])
        d_card, c_card, a_card = moe._route(block.cfg, block.router, x32, cap)
        out_card, aux_card = block(x32)
        out_again, aux_again = block(x32)
        cpu_params = {k: v.detach().cpu() for k, v in block.params().items()}
        d_cpu, _, _ = moe._route(block.cfg, cpu_params["router"], x32.cpu(), cap)
        out_cpu, aux_cpu = moe.moe_ffn(block.cfg, cpu_params, x32.cpu())
    out_err = float((out_card.cpu() - out_cpu).abs().max())
    aux_err = abs(float(aux_card) - float(aux_cpu))
    if not torch.equal(d_card.cpu(), d_cpu) or not torch.allclose(
            out_card.cpu(), out_cpu, rtol=MOE_TOL, atol=MOE_TOL) or aux_err > MOE_TOL:
        fail(f"moe_combined: the MoE block on the card vs the CPU: dispatch equal "
             f"{torch.equal(d_card.cpu(), d_cpu)}, outputs {out_err}, aux {aux_err}")
    if not (torch.equal(out_card, out_again) and torch.equal(aux_card, aux_again)):
        fail("moe_combined: the MoE block gave other bits on a repeat")
    kept = int(d_card.sum())

    # a training step's gradients, twice with one seed
    b0 = batches[0].to(trainer.device)
    grads = []
    state.model.train()
    for _ in range(2):
        trainer.forward_loss(state, b0, fold_seed(0, 999)).backward()
        grads.append(grads_of(state))
    if not all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0]):
        fail("moe_combined: two backward passes on one batch gave other gradients")
    del grads
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        trainer.train_step(state, b0, fold_seed(3, 0))
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        trainer.train_step(state, b0, fold_seed(3, 1))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    profiled = {**device_profile(prof, profiled_ms), "device_ms_by_group": device_groups(prof)}
    n_params = sum(p.numel() for p in state.model.parameters())
    n_moe = sum(p.numel() for p in block.parameters())
    del state, trainer
    paths = {"moe_train": train, "moe_serve": serve}
    emit({"phase": "moe_combined", "nvidia_smi": smi, "experts": MOE_EXPERTS,
          "top_k": MOE_TOP_K, "params": n_params, "moe_params": n_moe, "init_seconds": init_s,
          "batch_shapes": shapes, "dropout": DROPOUT_RATE, "losses": losses, "aux": auxes,
          "step_ms": step_ms, "median_step_ms_after_first": statistics.median(step_ms[1:]),
          "cls_rows": int(x32.shape[0]), "capacity": cap, "slots_kept": kept,
          "card_vs_cpu_out_max_abs_err": out_err, "card_vs_cpu_aux_abs_err": aux_err,
          "dispatch_equal": True, "bits_equal_on_repeat": True, "grads_bit_equal": True,
          "serve": {k: summary[k] for k in ("serve_seconds", "serve_batches")},
          "profiled_step": profiled, "launches": paths,
          "phase_seconds": time.perf_counter() - t_phase})
    return paths


def cli_ladder(cfg) -> tuple[int, ...]:
    """The serve ladder `cli score` warms for `cfg` (no tuned rungs)."""
    from deepdfa_tpu_torch.serve.batcher import _ladder_sizes

    return _ladder_sizes(None, cfg.serve.max_batch_graphs)



def flash_bound(B: int, H: int, Tq: int, Tk_live: list, D: int, itemsize: int,
                extra_bytes: int = 0, pairs: int | None = None):
    """(bound_ms, bound_by) of one flash_fwd call
    (`nn/flash_attention.py:flash_work`) at the bf16 tensor-core peak
    (fp32 at the fp32 peak)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    return roofline(*fa.flash_work(B, H, Tq, Tk_live, D, itemsize, extra_bytes, pairs),
                    PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)


def flash_kernel_phase(torch):
    """Kernel 5 against attention_plain at the serving bucket shapes;
    times at the flagship bucket (B 16, T 512, every key live)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    H, D = 12, 64
    cases = {  # name: (B, T, dtype, real key counts per row)
        "flagship_t512": (16, 512, "bfloat16", [512] * 16),
        "t256": (32, 256, "bfloat16", [256 - 7 * i for i in range(32)]),
        "t128": (64, 128, "bfloat16", [128 - 2 * i for i in range(64)]),
        "fp32_t512": (16, 512, "float32", [512 - 31 * i for i in range(16)]),
        "ragged_all_padding": (16, 512, "bfloat16", [512, 300, 65, 1, 0] + [257] * 11),
    }
    gen = torch.Generator().manual_seed(3)
    report, worst, timing = {}, 0.0, None
    for name, (B, T, dtype, lens) in cases.items():
        td = getattr(torch, dtype)
        q, k, v = (torch.randn(B, H, T, D, generator=gen).to(td).cuda() for _ in range(3))
        mask = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).cuda()
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, mask)
            po, plse = fa.attention_plain(q, k, v, mask)
            o2, lse2 = fa.flash_fwd(q, k, v, mask)
        torch.cuda.synchronize()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            fail(f"flash_fwd {name}: non-finite o or lse")
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        tol = FLASH_TOL[dtype]
        if err_o > tol or err_lse > 1e-5:
            fail(f"flash_fwd {name}: o err {err_o} (tol {tol}), lse err {err_lse} (tol 1e-5)")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"flash_fwd {name}: other bits on a rerun")
        for b, n in enumerate(lens):
            if n == 0 and not bool((o[b] == 0).all()):
                fail(f"flash_fwd {name}: row {b} has no key but o != 0")
        worst = max(worst, err_o, err_lse)
        report[f"{name}_o_max_abs_err"] = err_o
        report[f"{name}_lse_max_abs_err"] = err_lse
        if name == "flagship_t512":
            bias_mask = mask[:, None, None, :]
            with torch.inference_mode():
                ms = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask))
                plain_ms = median_ms(torch, lambda: fa.attention_plain(q, k, v, mask))
                library_ms = median_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias_mask))
            bound_ms, bound_by = flash_bound(B, H, T, lens, D, 2)
            timing = {"shape": [B, H, T, T, D], "dtype": dtype, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            timing["dropout"] = {**flash_fwd_dropout_case(torch, fa, q, k, v, mask),
                                 "bound_ms": bound_ms, "bound_by": bound_by}
            worst = max(worst, timing["dropout"]["o_max_abs_err"])
    emit({"phase": "kernel flash_fwd", "ok": True, "tolerance": FLASH_TOL, "lse_tolerance": 1e-5,
          "max_abs_err": worst, **report, **timing})
    return worst, timing


def flash_fwd_dropout_case(torch, fa, q, k, v, mask) -> dict:
    """Kernel 5 at dropout rate 0.1 on the flagship call against the plain
    version with the seed's Philox bits: o within the bf16 tolerance, lse
    within 1e-5; the keep fraction of the call's 50 M bits within 0.9 +-
    0.002; the kernel's and the plain version's times at that rate, and one scaled_dot_product_attention call's at
    that rate with the backend that ran it."""
    B, H, T, _ = q.shape
    seed = DROPOUT_SEED
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, mask, dropout_rate=DROPOUT_RATE, seed=seed)
        bits = fa.dropout_bits(seed, B, H, T, T, q.device)
        po, plse = fa.attention_plain(q, k, v, mask, dropout_rate=DROPOUT_RATE, bits=bits)
        keep = (bits < fa.keep_threshold(DROPOUT_RATE)).double().mean().item()
        del bits
        undropped, _ = fa.flash_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    if err_o > FLASH_TOL["bfloat16"] or err_lse > 1e-5:
        fail(f"flash_fwd dropout: o err {err_o}, lse err {err_lse}")
    if abs(keep - (1.0 - DROPOUT_RATE)) > 0.002:
        fail(f"flash_fwd dropout: keep fraction {keep} outside 0.9 +- 0.002")
    if torch.equal(o, undropped):
        fail("flash_fwd dropout: o is the undropped o")
    with torch.inference_mode():
        ms = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, dropout_rate=DROPOUT_RATE,
                                                   seed=seed))
        plain_ms = median_ms(torch, lambda: fa.attention_plain(
            q, k, v, mask, dropout_rate=DROPOUT_RATE,
            bits=fa.dropout_bits(seed, B, H, T, T, q.device)))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None, :], dropout_p=DROPOUT_RATE)

        library_ms = median_ms(torch, library)
        backend, top = sdpa_backend(torch, library)
    return {"rate": DROPOUT_RATE, "seed": seed, "bits": B * H * T * T, "keep_fraction": keep,
            "o_max_abs_err": err_o, "lse_max_abs_err": err_lse, "ms": ms,
            "plain_ms_with_bits": plain_ms, "library_ms": library_ms,
            "library_call": "sdpa(bool attn_mask, dropout_p)", "library_backend": backend,
            "library_device_ms_by_kernel": top}


def flash_bwd_bound(B: int, H: int, Tq: int, Tk_live: list, D: int, itemsize: int,
                    products: int, out_tokens: int, extra_bytes: int = 0,
                    pairs: int | None = None):
    """(bound_ms, bound_by) of one backward kernel
    (`nn/flash_attention.py:flash_bwd_work`: dq 3 products, Tq output
    rows; dk/dv 4, 2 Tk; dbias 2, 0)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    return roofline(*fa.flash_bwd_work(B, H, Tq, Tk_live, D, itemsize, products, out_tokens,
                                       extra_bytes, pairs),
                    PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)


def flash_bwd_kernel_phase(torch):
    """Kernels 6 (dq) and 7 (dk/dv) against attention_bwd_plain on the
    card, each case at dropout 0 and 0.1 with a fixed seed (the same
    Philox mask in both versions), from the forward kernel's o and lse:
    the flagship training call (B 16, H 12, T 512, D 64, bf16, every key
    live), the T = 256 and T = 128 buckets, fp32, a bf16 batch with
    ragged masks and an all-padding row (whose gradients must be exactly
    0), and a ragged flagship-shape batch with the training path's
    strided q, k, v and do. Each gradient within 2e-2 of its largest magnitude in bf16, 1e-4
    in fp32; the same bits on a repeat. Times at the flagship call: both
    kernels at rate 0 and 0.1, the plain backward, and the backward of
    one scaled_dot_product_attention call (boolean mask) as the library
    yardstick, never called by the port, at rate 0 and at rate 0.1
    (`sdpa_dropout_yardstick`, with the backend that ran)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    H, D = 12, 64
    cases = {  # name: (B, T, dtype, real key counts per row)
        "flagship_t512": (16, 512, "bfloat16", [512] * 16),
        "t256": (32, 256, "bfloat16", [256 - 7 * i for i in range(32)]),
        "t128": (64, 128, "bfloat16", [128 - 2 * i for i in range(64)]),
        "fp32_t512": (16, 512, "float32", [512 - 31 * i for i in range(16)]),
        "ragged_all_padding": (16, 512, "bfloat16", [512, 300, 65, 1, 0] + [257] * 11),
        # the training path's operands: q, k, v strided views of the fused
        # [B, T, 3, H, D] product, do a [B, H, T, D] view of [B, T, H, D]
        "strided_t512": (16, 512, "bfloat16", [512, 480, 300, 257, 129, 64, 33, 1] + [512] * 8),
    }
    gen = torch.Generator().manual_seed(4)
    report, worst, timing = {}, 0.0, {}
    for name, (B, T, dtype, lens) in cases.items():
        td = getattr(torch, dtype)
        if name.startswith("strided"):
            qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(td).cuda().view(B, T, 3, H, D)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = torch.randn(B, T, H, D, generator=gen).to(td).cuda().transpose(1, 2)
        else:
            q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(td).cuda()
                           for _ in range(4))
        mask = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).cuda()
        for rate in (0.0, DROPOUT_RATE):
            kw = {"dropout_rate": rate, "seed": DROPOUT_SEED}
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, mask, **kw)
                delta = (do.float() * o.float()).sum(-1, keepdim=True)
                dq = fa.flash_dq(q, k, v, mask, lse, delta, do, **kw)
                dk, dv = fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw)
                again = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                         *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
                bits = fa.dropout_bits(DROPOUT_SEED, B, H, T, T, q.device) if rate else None
                want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, dropout_rate=rate,
                                              bits=bits)
                del bits
            torch.cuda.synchronize()
            tag = f"{name}_rate{rate}"
            for what, got, ref, rerun in zip(("dq", "dk", "dv"), (dq, dk, dv), want, again):
                if not torch.isfinite(got.float()).all():
                    fail(f"flash_bwd {tag}: {what} has non-finite values")
                err = (got.float() - ref.float()).abs().max().item()
                scale = max(ref.float().abs().max().item(), 1e-6)
                tol = (FLASH_TOL["bfloat16"] if dtype == "bfloat16" else 1e-4) * scale
                if err > tol:
                    fail(f"flash_bwd {tag}: {what} err {err} > {tol}")
                if not torch.equal(got, rerun):
                    fail(f"flash_bwd {tag}: {what} other bits on a rerun")
                for b, n in enumerate(lens):
                    if n == 0 and not bool((got[b] == 0).all()):
                        fail(f"flash_bwd {tag}: row {b} has no key but d{what} != 0")
                worst = max(worst, err)
                report[f"{tag}_{what}_max_abs_err"] = err
                report[f"{tag}_{what}_scale"] = scale
            if name != "flagship_t512":
                continue
            with torch.inference_mode():
                timing[f"dq_ms_rate{rate}"] = median_ms(
                    torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw))
                timing[f"dkv_ms_rate{rate}"] = median_ms(
                    torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
            if rate:
                timing["dropout_library"] = sdpa_dropout_yardstick(
                    torch, q, k, v, do, mask[:, None, None, :], rate)
                continue
            with torch.inference_mode():
                timing["plain_ms"] = median_ms(
                    torch, lambda: fa.attention_bwd_plain(q, k, v, mask, o, lse, do))
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask[:, None, None, :])
            timing["library_ms"] = median_ms(
                torch, lambda: out.backward(do, retain_graph=True))
            del out, leaves
            for kernel, products, out_tokens in (("dq", 3, T), ("dkv", 4, 2 * T)):
                bound_ms, bound_by = flash_bwd_bound(B, H, T, lens, D, 2, products, out_tokens)
                timing[f"{kernel}_bound_ms"], timing[f"{kernel}_bound_by"] = bound_ms, bound_by
    emit({"phase": "kernel flash_bwd", "ok": True, "rates": [0.0, DROPOUT_RATE],
          "seed": DROPOUT_SEED, "tolerance": {"bfloat16": "2e-2 of scale", "float32": "1e-4 of scale"},
          "max_abs_err": worst, "shape": [16, H, 512, 512, D], **timing, **report})
    return worst, timing


def sdpa_backend(torch, fn) -> tuple[str, dict]:
    """(backend, top kernels): the SDPA backend whose card kernels one run
    of `fn` launched, from their names, and its 4 largest kernels by
    device ms."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and us > 0:
            kernels[e.key[:90]] = us / 1e3
    names = " ".join(kernels).lower()
    # cuDNN's kernel names hold "flash" too, so it is asked for first
    backend = next((b for b, frags in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                                       ("efficient", ("fmha", "efficient", "mem_eff")))
                    if any(f in names for f in frags)), "math")
    return backend, dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:4])


def sdpa_dropout_yardstick(torch, q, k, v, do, attn_mask, rate: float,
                           scale: float | None = None) -> dict:
    """The library yardstick of the backward kernels at dropout `rate`,
    never called by the port: one scaled_dot_product_attention call with
    `attn_mask` (a boolean key mask, or a float mask holding a bias,
    which then gets its gradient too) and dropout_p=rate; its backward
    (the mask replayed from the RNG state the call saved) timed as the
    kernels are, and the backend that ran one forward and backward."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    mask = attn_mask.detach().clone().requires_grad_(attn_mask.is_floating_point())

    def forward():
        return torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask, dropout_p=rate, scale=scale)

    out = forward()
    ms = median_ms(torch, lambda: out.backward(do, retain_graph=True))
    del out
    backend, top = sdpa_backend(torch, lambda: forward().backward(do))
    kind = "float attn_mask with the bias" if attn_mask.is_floating_point() else "bool attn_mask"
    return {"ms": ms, "rate": rate, "call": f"sdpa({kind}, dropout_p) backward",
            "backend": backend, "device_ms_by_kernel": top}


def flash_bias_kernel_phase(torch):
    """Kernels 5-7 with T5's additive [H, T, T] bias and kernel 8 (dbias)
    against the plain versions on the card at the T5 flagship call (B 16,
    H 12, T 512, D 64, bf16, scale 1.0), at dropout 0 and 0.1 (one seed,
    the same Philox mask in every version): every key live, ragged keys
    with an all-padding row (its o and gradients exactly 0), and ragged
    keys with the training path's operands (q, k, v views of the fused
    [B, T, 3, H, D] product, do a view of [B, T, H, D], the bias the
    contiguous [H, T, T] bf16 tensor the encoder builds). o within 2e-2
    (bf16), lse within 1e-5 + 1e-5 |lse|, dq, dk, dv and dbias within
    2e-2 of each one's largest magnitude; all four the same bits on a
    repeat. Times at the every-key-live call: the four kernels with the
    bias (dbias at 0.1 too), the plain forward and backward with the bias,
    one scaled_dot_product_attention call with bias and mask as a float
    attn_mask and its backward with that mask requiring grad (the
    library yardstick, never called by the port), and the bounds; the
    tensor-core dbias beside its first design's (BF16_DBIAS_BASELINE_MS)
    and at the T5 training path's three buckets (`dbias_buckets`: token
    budget 8192, so B 64 at T 128, 32 at 256 and 16 at 512, every key
    live), each bucket's batch cut, time and bound, held to the plain
    dbias as above and to its bits on a repeat."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    B, H, T, D = 16, 12, 512, 64
    tol = FLASH_TOL["bfloat16"]
    cases = {  # name: (real key counts per row, the training path's strides)
        "t5_flagship": ([512] * 16, False),
        "ragged_all_padding": ([512, 300, 65, 1, 0] + [257] * 11, False),
        "training_strides": ([512, 480, 300, 257, 129, 64, 33, 1] + [512] * 8, True),
    }
    gen = torch.Generator().manual_seed(7)
    report, worst, timing = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}, {}
    for name, (lens, strided) in cases.items():
        bf = torch.bfloat16
        if strided:
            qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(bf).cuda().view(B, T, 3, H, D)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = torch.randn(B, T, H, D, generator=gen).to(bf).cuda().transpose(1, 2)
        else:
            q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(bf).cuda() for _ in range(4))
        bias = (torch.randn(H, T, T, generator=gen) * 2.0).to(bf).cuda()
        mask = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).cuda()
        for rate in (0.0, DROPOUT_RATE):
            kw = {"scale": 1.0, "dropout_rate": rate, "seed": DROPOUT_SEED, "bias": bias}
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, mask, **kw)
                delta = (do.float() * o.float()).sum(-1, keepdim=True)
                got = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                       *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw),
                       fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0,
                                      dropout_rate=rate, seed=DROPOUT_SEED))
                o2, lse2 = fa.flash_fwd(q, k, v, mask, **kw)
                again = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                         *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw),
                         fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0,
                                        dropout_rate=rate, seed=DROPOUT_SEED))
                bits = fa.dropout_bits(DROPOUT_SEED, B, H, T, T, q.device) if rate else None
                po, plse = fa.attention_plain(q, k, v, mask, 1.0, rate, bits, bias)
                want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, rate, bits, bias)
                del bits
            torch.cuda.synchronize()
            tag = f"{name}_rate{rate}"
            if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
                fail(f"flash_bias {tag}: non-finite o or lse")
            err_o = (o.float() - po.float()).abs().max().item()
            err_lse = ((lse - plse).abs() - 1e-5 * plse.abs()).max().item()
            if err_o > tol or err_lse > 1e-5:
                fail(f"flash_bias {tag}: o err {err_o} (tol {tol}), lse err {err_lse} beyond "
                     "1e-5 |lse| (tol 1e-5)")
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"flash_bias {tag}: forward gave other bits on a rerun")
            worst["fwd"] = max(worst["fwd"], err_o)
            report[f"{tag}_o_max_abs_err"] = err_o
            for what, g, ref, rerun in zip(("dq", "dk", "dv", "dbias"), got, want, again):
                if not torch.isfinite(g.float()).all():
                    fail(f"flash_bias {tag}: {what} has non-finite values")
                err = (g.float() - ref.float()).abs().max().item()
                scale = max(ref.float().abs().max().item(), 1e-6)
                if err > tol * scale:
                    fail(f"flash_bias {tag}: {what} err {err} > {tol * scale}")
                if not torch.equal(g, rerun):
                    fail(f"flash_bias {tag}: {what} other bits on a rerun")
                key = {"dk": "dkv", "dv": "dkv"}.get(what, what)
                worst[key] = max(worst[key], err)
                report[f"{tag}_{what}_max_abs_err"] = err
                report[f"{tag}_{what}_scale"] = scale
            for b, n in enumerate(lens):
                if n == 0 and not (bool((o[b] == 0).all())
                                   and all(bool((g[b] == 0).all()) for g in got[:3])):
                    fail(f"flash_bias {tag}: row {b} has no key but o or a gradient != 0")
            if name != "t5_flagship":
                continue
            with torch.inference_mode():
                if rate:
                    timing["dbias_dropout_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                        q, k, v, mask, lse, delta, do, bias, scale=1.0, dropout_rate=rate,
                        seed=DROPOUT_SEED))
            if rate:
                float_mask = bias[None] + torch.where(mask, 0.0, -1e9).to(bf)[:, None, None, :]
                timing["dbias_dropout_library"] = sdpa_dropout_yardstick(
                    torch, q, k, v, do, float_mask, rate, scale=1.0)
                del float_mask
                continue
            with torch.inference_mode():
                timing["fwd_ms"] = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, **kw))
                timing["dq_ms"] = median_ms(
                    torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw))
                timing["dkv_ms"] = median_ms(
                    torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
                timing["dbias_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                    q, k, v, mask, lse, delta, do, bias, scale=1.0))
                timing["fwd_plain_ms"] = median_ms(
                    torch, lambda: fa.attention_plain(q, k, v, mask, 1.0, bias=bias))
                timing["bwd_plain_ms"] = median_ms(torch, lambda: fa.attention_bwd_plain(
                    q, k, v, mask, o, lse, do, 1.0, bias=bias))
                float_mask = bias[None] + torch.where(mask, 0.0, -1e9).to(bf)[:, None, None, :]
                timing["fwd_library_ms"] = median_ms(
                    torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=float_mask, scale=1.0))
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, float_mask)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves[:3], attn_mask=leaves[3], scale=1.0)
            timing["bwd_library_ms"] = median_ms(torch, lambda: out.backward(do, retain_graph=True))
            del out, leaves, float_mask
            bias_bytes = 2 * H * T * T
            timing["fwd_bound"] = flash_bound(B, H, T, lens, D, 2, bias_bytes)
            for kernel, products, out_tokens, extra in (
                    ("dq", 3, T, bias_bytes), ("dkv", 4, 2 * T, bias_bytes),
                    ("dbias", 2, 0, bias_bytes + 4 * H * T * T)):
                timing[f"{kernel}_bound"] = flash_bwd_bound(B, H, T, lens, D, 2, products,
                                                            out_tokens, extra)
    del q, k, v, do, bias, mask
    now = {"t5_flagship": timing["dbias_ms"], "dropout": timing["dbias_dropout_ms"]}
    timing["bf16_dbias_vs_baseline"] = {
        call: {"ms": now[call], "baseline_ms": base, "baseline_over_ms": base / now[call]}
        for call, base in BF16_DBIAS_BASELINE_MS.items() if call in now}
    buckets = {}
    for Bb, Tb in ((64, 128), (32, 256), (16, 512)):
        q, k, v, do = (torch.randn(Bb, H, Tb, D, generator=gen).to(torch.bfloat16).cuda()
                       for _ in range(4))
        bias = (torch.randn(H, Tb, Tb, generator=gen) * 2.0).to(torch.bfloat16).cuda()
        mask = torch.ones(Bb, Tb, dtype=torch.bool, device="cuda")
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, mask, scale=1.0, bias=bias)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            got, again = (fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0)
                          for _ in range(2))
            want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, bias=bias)[3]
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 1e-6)
        if not torch.isfinite(got).all() or err > tol * scale:
            fail(f"flash_bias bucket T {Tb}: dbias err {err} > {tol * scale} (or non-finite)")
        if not torch.equal(got, again):
            fail(f"flash_bias bucket T {Tb}: dbias other bits on a rerun")
        with torch.inference_mode():
            ms = median_ms(torch, lambda: fa.flash_dbias(q, k, v, mask, lse, delta, do, bias,
                                                         scale=1.0))
        bound = flash_bwd_bound(Bb, H, Tb, [Tb] * Bb, D, 2, 2, 0,
                                2 * H * Tb * Tb + 4 * H * Tb * Tb)
        buckets[f"t{Tb}"] = {"B": Bb, "ms": ms, "bound_ms": bound[0], "bound_by": bound[1],
                             "cut": dbias_cut(fa, Bb, H, Tb, Tb, False, D, mma=True),
                             "max_abs_err": err, "scale": scale}
        worst["dbias"] = max(worst["dbias"], err)
        del q, k, v, do, bias, mask, o, lse, delta, got, again, want
    timing["dbias_buckets"] = buckets
    emit({"phase": "kernel flash_bias", "ok": True, "shape": [B, H, T, T, D], "scale": 1.0,
          "rates": [0.0, DROPOUT_RATE], "seed": DROPOUT_SEED,
          "tolerance": {"o": tol, "lse": "1e-5 + 1e-5 |lse|", "grads": "2e-2 of scale"},
          "max_abs_err": worst, **timing, **report})
    return worst, timing


def c_like_text(rng, n_tokens: int) -> str:
    """n_tokens C-like tokens (each one hash-tokenizer token), broken
    into lines after ; { and }."""
    lines, line = [], []
    for w in rng.choice(C_WORDS, n_tokens):
        line.append(str(w))
        if w in (";", "{", "}"):
            lines.append(" ".join(line))
            line = []
    lines.append(" ".join(line))
    return "\n".join(lines) + "\n"


def model_config(arch: str, layers: int | None = None, dropout: float | None = None):
    """The combined family's model config at full width (bf16
    activations) with the flagship graph encoder: DeepDFA+LineVul at
    codebert-base width ("roberta") or CodeT5+DeepDFA at codet5-base
    width ("t5"); `layers` cuts the depth, `dropout` sets every rate."""
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import CombinedConfig, DefectConfig, T5Config, TransformerConfig

    cfg = load(COMBINED_CONFIG)
    kw = {"dtype": "bfloat16", **({"num_layers": layers} if layers else {}),
          **({"dropout_rate": dropout} if dropout is not None else {})}
    graph = dict(graph_hidden_dim=cfg.model.hidden_dim, graph_n_steps=cfg.model.n_steps,
                 graph_input_dim=cfg.data.feat.input_dim)
    if arch == "t5":
        return DefectConfig(encoder=T5Config(**kw), **graph)
    head = {} if dropout is None else {"head_dropout": dropout}
    return CombinedConfig(encoder=TransformerConfig(**kw), **graph, **head)


def combined_model(torch, layers: int | None = None, arch: str = "roberta"):
    """The `arch` family's model (`model_config`), random weights from
    seed 0 on the CPU, in eval mode."""
    from deepdfa_tpu_torch.models import CombinedModel, DefectModel

    family = DefectModel if arch == "t5" else CombinedModel
    return family(model_config(arch, layers), generator=torch.Generator().manual_seed(0)).eval()


def tokenizer(arch: str):
    """The hash tokenizer (vocab 4096) in the family's frame: RoBERTa's
    (pad 1) or T5's (pad 0, eos 2)."""
    from deepdfa_tpu_torch.data import HashTokenizer

    return HashTokenizer(vocab_size=4096, t5_frame=arch == "t5")


def serve_combined_phase(torch, rng, arch: str = "roberta"):
    """The combined serving main path of the `arch` family through
    score_combined on the card, its launch counts, batched-vs-alone and
    card-vs-CPU checks."""
    import numpy as np

    from deepdfa_tpu_torch.core import apply_overrides, load
    from deepdfa_tpu_torch.core.config import serve_budgets
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import CombinedExecutor, DynamicBatcher, score_combined

    phase = "serve_t5" if arch == "t5" else "serve_combined"
    override = f"data.seq_buckets={json.dumps(COMBINED_BUCKETS)}"
    cfg = apply_overrides(load(COMBINED_CONFIG), [override])
    tok = tokenizer(arch)
    t0 = time.perf_counter()
    model = combined_model(torch, arch=arch)
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    spans = [(20, 126), (127, 254), (255, 510)]  # real tokens + <s> </s> per bucket
    payloads = []
    for i in range(COMBINED_REQUESTS):
        lo, hi = spans[i % 3]
        text = c_like_text(rng, int(rng.integers(lo, hi + 1)))
        payloads.append((text, synthetic_graph(rng, i, int(rng.integers(10, 151)),
                                               cfg.data.feat.input_dim)))
    n_layers, n_steps = model.cfg.encoder.num_layers, model.cfg.graph_n_steps

    gk.LAUNCHES = fa.LAUNCHES = 0
    summary = score_combined(model, payloads, cfg, tok, device="cuda")
    launches = {"flash_fwd": fa.LAUNCHES, "ggnn_step": gk.LAUNCHES}
    probs = np.asarray(summary.pop("probs"), dtype=np.float64)
    if summary["serve_scored"] != len(payloads) or not np.all(np.isfinite(probs)):
        fail(f"{phase}: {summary['serve_failed_requests']} failed or non-finite")
    if not np.all((probs > 0.0) & (probs < 1.0)):
        fail(f"{phase}: a probability outside (0, 1)")
    batches = summary["serve_batches"]
    warm = len(COMBINED_BUCKETS)
    want = {"flash_fwd": (batches + warm) * n_layers, "ggnn_step": (batches + warm) * n_steps}
    if (summary["flash_fwd_launches"], summary["ggnn_step_launches"]) != (
            batches * n_layers, batches * n_steps) or launches != want:
        fail(f"{phase}: launches {launches} (scoring {summary['flash_fwd_launches']}, "
             f"{summary['ggnn_step_launches']}), expected {want} for {batches} batches + "
             f"{warm} warmup batches")

    # three requests of one bucket re-scored alone on the same padded shape
    node_budget, edge_budget = serve_budgets(cfg)
    ex = CombinedExecutor(model, tok, cfg.data.seq_buckets, cfg.data.token_budget,
                          node_budget, edge_budget, device="cuda")
    enc = [(tok.encode(t, COMBINED_BUCKETS[-1]), g) for t, g in payloads]
    pick = [i for i in range(len(enc)) if ex.bucket_key(enc[i]) == 256][:3]
    alone = [DynamicBatcher(ex).score_all([enc[i]])[0].wait(600) for i in pick]
    graph_gap = float(max(abs(a - probs[i]) for a, i in zip(alone, pick)))
    if graph_gap > 1e-5:
        fail(f"{phase}: alone vs batched with graphs differ by {graph_gap}")
    text_only = [(enc[i][0], None) for i in pick]
    together = [r.wait(600) for r in DynamicBatcher(ex).score_all(text_only)]
    text_alone = [DynamicBatcher(ex).score_all([p])[0].wait(600) for p in text_only]
    if together != text_alone:
        fail(f"{phase}: text-only alone {text_alone} != batched {together}")

    # a 2-layer model of the same width and seed: card vs the CPU plain
    # path, compared on the logits (the probabilities squash their spread)
    small = [enc[i] for i in range(0, 12, 3)]  # 4 requests, T = 128 bucket
    two = {}
    for dev in ("cuda", "cpu"):
        small_ex = CombinedExecutor(combined_model(torch, 2, arch), tok, [128], 4 * 128,
                                    node_budget, edge_budget, device=dev)
        _, (_, batch) = small_ex.pack_chunk(128, small)
        b = batch.to(dev)
        with torch.inference_mode():
            logits = small_ex.model(b.input_ids, b.graphs, b.has_graph)
        two[dev] = logits[: len(small)].float().cpu().numpy().astype(np.float64)
    cpu_err = float(np.abs(two["cuda"] - two["cpu"]).max())
    margin = two["cpu"][:, 1] - two["cpu"][:, 0]
    if not cpu_err <= COMBINED_LOGIT_TOL:
        fail(f"{phase}: 2-layer card vs CPU logits differ by {cpu_err} "
             f"(tol {COMBINED_LOGIT_TOL})")

    # a load window: every bucket runs several full batches, so requests/s
    # and p99 rest on more than the handful of batches above
    load = []
    for i in range(COMBINED_LOAD_REQUESTS):
        lo, hi = spans[i % 3]
        load.append((c_like_text(rng, int(rng.integers(lo, hi + 1))),
                     synthetic_graph(rng, i, int(rng.integers(10, 151)), cfg.data.feat.input_dim)))
    load_summary = score_combined(model, load, cfg, tok, device="cuda")
    load_probs = np.asarray(load_summary.pop("probs"), dtype=np.float64)
    load_batches = load_summary["serve_batches"]
    if load_summary["serve_scored"] != len(load) or not np.all(
            (load_probs > 0.0) & (load_probs < 1.0)):
        fail(f"{phase} load: a failed request or a probability outside (0, 1)")
    load_launches = (load_summary["flash_fwd_launches"], load_summary["ggnn_step_launches"])
    if load_launches != (load_batches * n_layers, load_batches * n_steps):
        fail(f"{phase} load: launches {load_launches} for {load_batches} batches")
    load_summary.pop("buckets")
    emit({"phase": phase, "ok": True, "override": override,
          "seq_buckets": list(cfg.data.seq_buckets), "token_budget": cfg.data.token_budget,
          "node_budget": node_budget, "edge_budget": edge_budget, "params": n_params,
          "init_seconds": init_s, "requests": len(payloads), "kernel_launches": launches,
          "alone_vs_batched_with_graphs_max_abs": graph_gap,
          "alone_vs_batched_with_graphs_bit_equal": graph_gap == 0.0,
          "alone_vs_batched_text_only_bit_equal": True,
          "two_layer_cpu_logits_max_abs_err": cpu_err,
          "two_layer_logit_tolerance": COMBINED_LOGIT_TOL,
          "two_layer_cpu_logits": two["cpu"].tolist(),
          "two_layer_logit_margin_min": float(margin.min()),
          "two_layer_logit_margin_max": float(margin.max()),
          "probs_min": float(probs.min()), "probs_max": float(probs.max()), **summary,
          "load": {"requests": len(load), "probs_min": float(load_probs.min()),
                   "probs_max": float(load_probs.max()), **load_summary}})
    return launches, model, tok, cfg, enc


def profile_combined_phase(torch, model, tok, cfg, enc, phase: str = "profile_combined") -> None:
    """One full 512-token batch (16 rows): host collate, copies, forward
    to sync and fetch (median of 5, each stage synchronized), then one
    batch under torch.profiler (after a dropped warm-up batch) for device
    time by kernel group, the idle share, and whether the trace holds
    every flash and GGNN launch of the batch."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from deepdfa_tpu_torch.core.config import serve_budgets
    from deepdfa_tpu_torch.serve import CombinedExecutor
    from deepdfa_tpu_torch.serve.batcher import DeviceResult

    ex = CombinedExecutor(model, tok, [512], cfg.data.token_budget, *serve_budgets(cfg),
                          device="cuda")
    rows = ex.capacity(512)
    chunk = [p for p in enc if ex.bucket_key(p) == 512][:rows]
    chunk += chunk[: rows - len(chunk)]
    ex.warmup()
    stages = {"collate_ms": [], "to_device_ms": [], "forward_ms": [], "fetch_ms": [], "batch_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        _, (_, batch) = ex.pack_chunk(512, chunk)
        t1 = time.perf_counter()
        b = batch.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            probs = torch.softmax(ex.model(b.input_ids, b.graphs, b.has_graph), dim=-1)[:, 1]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ex.fetch(DeviceResult((probs,)), rows)
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
            stages[k].append(1e3 * v)
    _, packed = ex.pack_chunk(512, chunk)
    # the first batch warms the tracer up and is dropped: a trace that
    # starts cold can miss the window's first kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        ex.fetch(ex.dispatch(512, packed), rows)
        prof.step()  # the traced step ends where the context does
        t0 = time.perf_counter()
        ex.fetch(ex.dispatch(512, packed), rows)
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    dev = device_profile(prof, profiled_ms)
    groups = device_groups(prof)
    mcfg = model.cfg
    emit({"phase": phase, "rows": rows, "tokens": rows * 512,
          **{k: statistics.median(v) for k, v in stages.items()},
          "device_ms_by_group": groups,
          "trace_complete": (groups["flash_fwd"]["calls"], groups["ggnn_step"]["calls"]) == (
              mcfg.encoder.num_layers, mcfg.graph_n_steps), **dev})


def training_corpus(rng, input_dim: int, tok):
    """Seeded labelled texts with graphs, tokenized: 32 rows a bucket at
    T 512, 32 at 256 and 64 at 128, so the bucket planner emits 4 full
    batches (2 of them at 512). A label-1 text uses the second half of
    C_WORDS' one-token words, a label-0 text the first; a label-1 graph
    carries token 7 on one node (the GGNN smoke's signal). `tok` is the
    family's tokenizer."""
    vocab = [w for w in C_WORDS if w not in ("->", "++")]  # those two are 2 tokens each
    half = len(vocab) // 2
    spans = {512: (255, 510), 256: (127, 254), 128: (20, 126)}
    rows = [512] * 32 + [256] * 32 + [128] * 64
    token_ids, labels, graphs = {}, {}, {}
    for i, edge in enumerate(rows):
        label = i % 2
        words = vocab[half:] if label else vocab[:half]
        lo, hi = spans[edge]
        text = " ".join(str(w) for w in rng.choice(words, int(rng.integers(lo, hi + 1))))
        token_ids[i] = tok.encode(text, 512)
        labels[i] = label
        g = synthetic_graph(rng, 2 * (i // 2) + (1 - label), int(rng.integers(10, 151)),
                            input_dim, signal=True)
        graphs[i] = dataclasses.replace(g, graph_id=i)
    return token_ids, labels, graphs


def combined_train_setup(torch, layers: int | None = None, dropout: float = DROPOUT_RATE,
                         arch: str = "roberta"):
    """(config, model config) of the `arch` family's training path at full
    width (bf16 activations, remat "full") with the flagship graph
    encoder; AdamW at lr 1e-4, no warmup, clip 1.0."""
    from deepdfa_tpu_torch.core import apply_overrides, load

    cfg = apply_overrides(load(COMBINED_CONFIG), [
        f"data.seq_buckets={json.dumps(COMBINED_BUCKETS)}", "train.optim.learning_rate=1e-4",
        "train.optim.warmup_frac=0.0", "train.optim.grad_clip_norm=1.0"])
    return cfg, model_config(arch, layers, dropout)


def grads_of(state) -> dict:
    return {k: p.grad.detach().clone() for k, p in state.model.named_parameters()
            if p.grad is not None}


def train_combined_phase(torch, rng, arch: str = "roberta"):
    """The `arch` family's training main path through CombinedTrainer.fit
    on the card: launch counts, bit-equal gradients, a 2-layer CPU
    cross-check, and a step split with remat on and off."""
    import numpy as np

    from deepdfa_tpu_torch.data import collate_plan, lengths_for, plan_bucketed_batches
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train import CombinedTrainer

    phase = "train_t5" if arch == "t5" else "train_combined"
    cfg, mcfg = combined_train_setup(torch, arch=arch)
    tok = tokenizer(arch)
    token_ids, labels, graphs = training_corpus(rng, cfg.data.feat.input_dim, tok)
    bcfg = cfg.data.batch
    order = sorted(token_ids)
    lengths = lengths_for(token_ids, order, tok.pad_id)

    plans = list(plan_bucketed_batches(lengths, order, COMBINED_BUCKETS, cfg.data.token_budget,
                                       1, bcfg.node_budget, bcfg.edge_budget))

    def collate(plan):
        return collate_plan(plan, token_ids, labels, graphs, pad_id=tok.pad_id)

    batches = [collate(p) for p in plans]
    shapes = [list(b.input_ids.shape) for b in batches]
    if len(batches) != TRAIN_BATCHES or sorted(s[1] for s in shapes) != [128, 256, 512, 512]:
        fail(f"{phase}: planned batches {shapes}, want 4 full ones over 128/256/512")
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    trainer = CombinedTrainer(cfg, mcfg, total_steps=steps, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state(seed=0)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    records = []

    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = fa.DBIAS_LAUNCHES = 0
    gk.LAUNCHES = gk.GRU_BWD_LAUNCHES = gk.DMSG_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                max_epochs=TRAIN_EPOCHS, log_fn=records.append, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"flash_fwd": fa.LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
                "flash_dkv": fa.DKV_LAUNCHES, "flash_dbias": fa.DBIAS_LAUNCHES,
                "ggnn_step": gk.LAUNCHES, "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES,
                "ggnn_dmsg": gk.DMSG_LAUNCHES}
    L, S = mcfg.encoder.num_layers, mcfg.graph_n_steps
    # per step: each layer's forward, its replay under remat, its two
    # backward kernels (three with T5's bias: dbias); the warm-up runs one
    # step a bucket; eval batches run the forward alone
    trained = steps + len(COMBINED_BUCKETS)
    want = {"flash_fwd": trained * 2 * L + TRAIN_EPOCHS * L, "flash_dq": trained * L,
            "flash_dkv": trained * L, "flash_dbias": trained * L if arch == "t5" else 0,
            "ggnn_step": trained * S + TRAIN_EPOCHS * S,
            "ggnn_gru_bwd": trained * S, "ggnn_dmsg": trained * S}
    if launches != want:
        fail(f"{phase}: kernel launches {launches}, expected {want}")
    epochs = [r for r in records if "epoch" in r]
    losses = [r["train_loss"] for r in epochs]
    if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
        fail(f"{phase}: a non-finite loss in {epochs}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall: epoch means {losses}")

    # two backward passes on one batch with one seed: the same bits
    b0 = batches[0].to(trainer.device)

    def grads():
        trainer.forward_loss(state, b0, fold_seed(0, 999)).backward()
        return grads_of(state)

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail(f"{phase}: two backward passes on one batch gave other gradients")
    del first, second

    if arch == "t5":
        # bf16 rounding flips T5's ReLU gates where a pre-activation is
        # near 0, and eos pooling feeds the last FFN one token a row, so
        # bf16 gradients of the FFN kernels differ by several percent
        # between any two bf16 runs (the card and the CPU here): the
        # gradients are held in fp32 (the fp32 kernel instances on the
        # card), the bf16 run's losses held and its gradients reported
        cpu = {"two_layer_fp32": combined_cpu_check(torch, [batches[2]] * 2, arch, "float32"),
               "two_layer_bf16": combined_cpu_check(torch, [batches[2]] * 2, arch,
                                                    gate_grads=False)}
    else:
        cpu = combined_cpu_check(torch, [batches[2], batches[2]], arch)
    split = combined_step_split(torch, trainer, state,
                                lambda: collate(next(p for p in plans if p.seq_len == 512)), tok)
    last = epochs[-1]
    emit({"phase": phase, "ok": True, "params": n_params, "init_seconds": init_s,
          "steps": steps, "epochs": TRAIN_EPOCHS, "batch_shapes": shapes,
          "seq_buckets": COMBINED_BUCKETS, "token_budget": cfg.data.token_budget,
          "node_budget": bcfg.node_budget, "edge_budget": bcfg.edge_budget,
          "dropout": DROPOUT_RATE, "remat": mcfg.encoder.remat_policy,
          "optim": dataclasses.asdict(cfg.train.optim), "epoch_train_loss": losses,
          "epoch_val_loss": [r["val_loss"] for r in epochs],
          "epoch_seconds": [r["epoch_seconds"] for r in epochs],
          "fit_seconds": fit_s, "warmup": [r for r in records if "warmup_signatures" in r],
          "last_epoch_tokens_per_sec": last["train_tokens_per_sec"],
          "last_epoch_examples_per_sec": last["train_examples_per_sec"],
          "padding_waste": last["padding_waste"], "kernel_launches": launches,
          "grads_bit_equal": True, **cpu, **split})
    return launches


def combined_cpu_check(torch, batches, arch: str = "roberta", dtype: str = "bfloat16",
                       gate_grads: bool = True) -> dict:
    """A 2-layer model of the same width with dropout 0 and `dtype`
    activations, the same weights on the card and on the CPU plain path:
    the first two steps' losses within COMBINED_TRAIN_LOSS_TOL, step-1
    gradients within COMBINED_TRAIN_GRAD_TOL of each leaf's scale (with
    `gate_grads`; else their error is only reported)."""
    from deepdfa_tpu_torch.train import CombinedTrainer

    cfg, mcfg = combined_train_setup(torch, layers=2, dropout=0.0, arch=arch)
    mcfg = dataclasses.replace(mcfg, encoder=dataclasses.replace(mcfg.encoder, dtype=dtype))
    pairs, grad_err = [], None
    runs = {dev: CombinedTrainer(cfg, mcfg, total_steps=2, device=dev) for dev in ("cuda", "cpu")}
    states = {dev: tr.init_state(seed=0) for dev, tr in runs.items()}
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        step = {}
        for dev, tr in runs.items():
            loss = tr.forward_loss(states[dev], batch.to(tr.device), None)
            loss.backward()
            step[dev] = (loss.item(), {k: g.cpu() for k, g in grads_of(states[dev]).items()})
            states[dev].apply_gradients()
        pairs.append((step["cuda"][0], step["cpu"][0]))
        if i == 0:
            errs = leaf_errors(step["cuda"][1], step["cpu"][1])
            grad_err = max(errs.values())
            worst_leaf = max(errs, key=errs.get)
    loss_err = max(abs(a - b) for a, b in pairs)
    if loss_err > COMBINED_TRAIN_LOSS_TOL or (gate_grads and grad_err > COMBINED_TRAIN_GRAD_TOL):
        fail(f"train ({arch}, {dtype}): 2-layer card vs CPU losses {pairs} (abs err {loss_err}, "
             f"tol {COMBINED_TRAIN_LOSS_TOL}), step-1 gradient err {grad_err} at {worst_leaf} "
             f"(tol {COMBINED_TRAIN_GRAD_TOL}{'' if gate_grads else ', reported only'})")
    return {"dtype": dtype, "two_layer_cpu_losses": pairs, "two_layer_cpu_loss_abs_err": loss_err,
            "two_layer_cpu_step1_grad_rel_err": grad_err, "grads_gated": gate_grads,
            "two_layer_worst_leaf": worst_leaf,
            "two_layer_cpu_seconds": time.perf_counter() - t0}


def combined_step_split(torch, trainer, state, collate_512, tok) -> dict:
    """Median of 10 steps on a full 512-token batch, each stage
    synchronized: host collate of its plan, copies, forward, backward,
    optimiser; tokens/s and examples/s; peak memory with remat on, and
    one step with it off; one step under torch.profiler."""
    import dataclasses as dc

    from deepdfa_tpu_torch.data import batch_token_counts
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    split = {k: [] for k in ("host_collate_ms", "to_device_ms", "forward_ms", "backward_ms",
                             "optimizer_ms", "step_ms")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        t_a = time.perf_counter()
        batch = collate_512()
        t_b = time.perf_counter()
        dev = batch.to(trainer.device)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        loss = trainer.forward_loss(state, dev, fold_seed(1, i))
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t_f = time.perf_counter()
        for k, v in zip(split, (t_b - t_a, t_c - t_b, t_d - t_c, t_e - t_d, t_f - t_e,
                                t_f - t_a)):
            split[k].append(1e3 * v)
    peak_remat = torch.cuda.max_memory_allocated()
    med = {k: statistics.median(v) for k, v in split.items()}
    real, padded, rows = batch_token_counts(batch.input_ids, batch.row_mask, tok.pad_id)
    # remat off (the encoder reads its config at each encode): one
    # warm-up step, then the median of 5
    enc = state.model.encoder
    enc.cfg = dc.replace(enc.cfg, remat=False)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        no_remat = []
        for i in range(6):
            t_a = time.perf_counter()
            trainer.train_step(state, dev, fold_seed(2, i))
            torch.cuda.synchronize()
            no_remat.append(1e3 * (time.perf_counter() - t_a))
        no_remat_ms = statistics.median(no_remat[1:])
        peak_no_remat = torch.cuda.max_memory_allocated()
    finally:
        enc.cfg = dc.replace(enc.cfg, remat=True)
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        trainer.train_step(state, dev, fold_seed(3, 0))
        torch.cuda.synchronize()
        prof.step()
        t_a = time.perf_counter()
        trainer.train_step(state, dev, fold_seed(3, 1))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    return {"step_batch": list(batch.input_ids.shape), "step_real_tokens": real,
            "step_padded_tokens": padded, "step_rows": rows, **med,
            "tokens_per_sec": real / (med["step_ms"] / 1e3),
            "padded_tokens_per_sec": padded / (med["step_ms"] / 1e3),
            "examples_per_sec": rows / (med["step_ms"] / 1e3),
            "peak_memory_mb_remat": peak_remat / 2**20, "no_remat_step_ms": no_remat_ms,
            "peak_memory_mb_no_remat": peak_no_remat / 2**20,
            "profiled_step": {**device_profile(prof, profiled_ms),
                              "device_ms_by_group": device_groups(prof)}}


# the causal flash phase and the generation family's phases

#: kernels 5-8 causal against their plain versions; name: (B, Tq, Tk, dtype,
#: biased, causal, real keys per row, padded leading keys of the last row).
#: The timed cases: the flagship training call with and without T5's bias,
#: and the gen path's three fp32 calls (decoder self-attention, causal and
#: biased; cross-attention, rectangular; the encoder, biased), every key live.
#: The clone path's two fp32 biased calls (B 32) are held to the gates only:
#: there the fp32 dbias cuts the batch into runs of several rows (4 x 8 for
#: the encoder, 8 x 4 for the causal decoder), where the gen calls give
#: 4 x 4 and 16 x 1
FLASH_CAUSAL_CASES = {
    "bf16_t200_biased_padded": (8, 200, 200, "bfloat16", True, True,
                                [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "fp32_t200_biased_padded": (8, 200, 200, "float32", True, True,
                                [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "bf16_t200_padded": (8, 200, 200, "bfloat16", False, True,
                         [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "fp32_t200_padded": (8, 200, 200, "float32", False, True,
                         [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "t5_flagship_t512": (16, 512, 512, "bfloat16", True, True, [512] * 16, 0),
    "flagship_t512": (16, 512, 512, "bfloat16", False, True, [512] * 16, 0),
    "gen_decoder_t128": (16, 128, 128, "float32", True, True, [128] * 16, 0),
    "gen_cross_t128x256": (16, 128, 256, "float32", False, False, [256] * 16, 0),
    "gen_encoder_t256": (16, 256, 256, "float32", True, False, [256] * 16, 0),
    "clone_encoder_t256": (32, 256, 256, "float32", True, False,
                           [256, 255, 200, 129, 128, 64, 1, 0] * 4, 0),
    "clone_decoder_t256": (32, 256, 256, "float32", True, True, [256] * 32, 0),
}
FLASH_TIMED = ("t5_flagship_t512", "flagship_t512", "gen_decoder_t128", "gen_cross_t128x256",
               "gen_encoder_t256")
#: the unbiased non-causal times at the flagship call that PERF.md records
#: from before the causal build existed (NVIDIA H100 80GB HBM3, 700 W):
#: forward, dq, dk/dv
NONCAUSAL_BASELINE_MS = {"flash_fwd": 0.1350, "flash_dq": 0.2031, "flash_dkv": 0.3458}
#: the fp32 dq and dk/dv times at the gen path's calls that PERF.md records
#: for the first FMA instances (one key a lane; NVIDIA H100 80GB HBM3,
#: 700 W), before their register-tiled redesign
FP32_BWD_BASELINE_MS = {
    "gen_decoder_t128": {"flash_dq": 0.1313, "flash_dkv": 0.1740},
    "gen_cross_t128x256": {"flash_dq": 0.3138, "flash_dkv": 0.4026},
    "gen_encoder_t256": {"flash_dq": 0.6015, "flash_dkv": 0.8173},
}
#: the tensor-core dq and dk/dv times at the flagship call that PERF.md
#: records from before their redesign (NVIDIA H100 80GB HBM3, 700 W; each
#: tile's loads behind two barriers, p through expf, the bias read from
#: device memory an element at a time)
BF16_BWD_BASELINE_MS = {
    "plain": {"flash_dq": 0.2063, "flash_dkv": 0.3474},
    "dropout": {"flash_dq": 0.2705, "flash_dkv": 0.4562},
    "bias": {"flash_dq": 0.3307, "flash_dkv": 0.5947},
    "causal": {"flash_dq": 0.1511, "flash_dkv": 0.2008},
    "causal_bias": {"flash_dq": 0.2444, "flash_dkv": 0.3732},
}
#: kernel 5's times that PERF.md records from before its redesign (NVIDIA
#: H100 80GB HBM3, 700 W): the FMA instance at the gen path's calls (one
#: key a lane) and the tensor-core instance at the flagship call (B 16,
#: H 12, T 512, D 64, bf16; each tile's loads behind two barriers, the
#: bias read from device memory a pair at a time)
FWD_BASELINE_MS = {
    "gen_decoder_t128": 0.1019, "gen_cross_t128x256": 0.2465, "gen_encoder_t256": 0.4708,
    "flagship": 0.1360, "flagship_bias": 0.2334, "flagship_causal": 0.1118,
    "flagship_causal_bias": 0.1813, "flagship_dropout": 0.2133,
}


#: B3's time at the flagship batch (N 16384, d 128) that PERF.md records
#: for its first design (six launches: the gate pass reading its weights
#: a column a lane from device memory, the input pass, the split-K weight
#: pass, the reduce and two weight transposes; NVIDIA H100 80GB HBM3,
#: 700 W), before its register-tiled redesign
GRU_BWD_BASELINE_MS = {"ggnn_gru_bwd": 0.6196}
#: the fp32 dbias times at the gen path's biased calls that PERF.md records
#: for its first FMA instance (a lane one key of a 32-key tile for 4 rows;
#: NVIDIA H100 80GB HBM3, 700 W), before its register-tiled redesign
FP32_DBIAS_BASELINE_MS = {"gen_decoder_t128": 0.1674, "gen_encoder_t256": 0.4932}
#: the tensor-core dbias times at the T5 call (B 16, H 12, T 512, D 64,
#: a bf16 bias, scale 1) that PERF.md records from before its redesign
#: (NVIDIA H100 80GB HBM3, 700 W; 64 x 64 blocks over the whole batch,
#: each batch row's k and v tiles behind two barriers, q and do fragments
#: read a lane at a time from device memory): every key live, at dropout
#: 0.1, and causal with the bias
BF16_DBIAS_BASELINE_MS = {"t5_flagship": 0.1910, "dropout": 0.2498, "causal_bias": 0.1774}
#: B4's time at the flagship batch (N 16384, E 65536, d 128, T 1) that
#: PERF.md records for its first design (two launches: q_t = da @ Wm_t^T
#: a column a lane into a [T, N, d] buffer, then a warp per node over its
#: src run; the wrapper's Wm transpose; NVIDIA H100 80GB HBM3, 700 W),
#: before its one-launch redesign; step_bwd added its result into dh in a
#: pass of its own
DMSG_BASELINE_MS = {"ggnn_dmsg": 0.0508}


#: the widths the GGNN kernels take (csrc/ggnn_step.cu: GGNN_WIDTHS; the
#: backward's GRU_CASE and DMSG_CASE lists), 288 the structural-feature
#: model's
GGNN_WIDTHS = range(32, 289, 32)


def no_spill_report(ptxas: dict) -> dict:
    """{kernel: ptxas's registers and spills} of the instances that must
    not spill, in both flash libraries: every tensor-core forward, dq and
    dk/dv instance at D 64 (three of each: without a bias and with a bf16
    or fp32 bias), both tensor-core dbias instances at D 64 (a bf16 or
    fp32 bias), the fp32 and bf16 FMA forwards, the register-tiled fp32
    dq, dk/dv and dbias that the gen path launches and the bf16 FMA dbias;
    every width's instance of B3's three passes and of B4 (`ggnn_bwd`); and
    in `ggnn_step`, every instance of kernel 1 (fp32, bf16, int8 x fold,
    mxu) at every width with the `step_tile` body it runs and the int8
    pre-pass (kernel and warp body); None for one the build did not
    report. The GGNN entries are returned at d 128 and wherever one spills
    or is missing; every width is checked. Kernel 2's are in
    `fused_spill_report`."""
    out = {}
    for lib, c in (("flash_attention", ""), ("flash_attention_causal", ", causal")):
        for kernel, count in (("flash_fwd_bf16_mma", 3), ("flash_dq_bf16_mma", 3),
                              ("flash_dkv_bf16_mma", 3), ("flash_dbias_bf16_mma", 2)):
            mma = sorted(k for k in ptxas[lib] if k.startswith(f"{kernel}<64, "))
            out.update({k: ptxas[lib][k] for k in mma})
            if len(mma) != count:
                out[f"{kernel}<64, ...{c}> x {count}"] = None
        for k in (f"flash_fwd_scalar<float, 64{c}>", f"flash_fwd_scalar<bf16, 64{c}>",
                  f"flash_dq_scalar<float, 64{c}>", f"flash_dkv_scalar<float, 64{c}>",
                  f"flash_dbias_scalar<float, 64{c}>", f"flash_dbias_scalar<bf16, 64{c}>"):
            out[k] = ptxas[lib].get(k)
    for kernel in ("gru_bwd_gates_kernel", "gru_bwd_inputs_kernel", "gru_bwd_weights_kernel",
                   "dmsg_kernel"):
        for d in GGNN_WIDTHS:
            out[f"{kernel}<{d}>"] = ptxas["ggnn_bwd"].get(f"{kernel}<{d}>")
    for d in GGNN_WIDTHS:
        names = [f"mxu_colmax_kernel<{d}>", f"mxu_colmax_warp<{d}>"]
        for p in (0, 1, 2):
            for mxu in ("", ", mxu"):
                names += [f"ggnn_step_kernel<{d}, {p}{mxu}>", f"step_tile<{d}, {p}{mxu}>"]
        for k in names:
            r = ptxas["ggnn_step"].get(k)
            if d == 128 or r is None or r["spill_bytes"]:
                out[k] = r
    return out


def fused_spill_report(ptxas: dict) -> dict:
    """{kernel: ptxas's registers and spills} of every instance of GGNN
    kernel 2 (`ggnn_fused_kernel`) at every width, with the coherent
    `step_tile` and pre-pass bodies it calls. At d <= 128 (two blocks an
    SM, 128 registers) kernel 2 holds its step and tile loops' state
    across the `__noinline__` call of a body that wants every register,
    so the call saves and restores it (PERF.md, kernel 2): reported, not
    gated."""
    out = {}
    for d in GGNN_WIDTHS:
        names = [f"mxu_colmax_warp<{d}, coherent>"]
        for p in (0, 1, 2):
            for mxu in ("", ", mxu"):
                names += [f"ggnn_fused_kernel<{d}, {p}{mxu}>", f"step_tile<{d}, {p}{mxu}, coherent>"]
        out.update({k: ptxas["ggnn_step"].get(k) for k in names})
    return out


def dbias_cut(fa, B: int, H: int, Tq: int, Tk: int, causal: bool, D: int = 64,
              mma: bool = False) -> dict:
    """The batch cut of kernel 8 (the fp32 FMA instance, or with `mma`
    the tensor-core one at head width D) at a call, from the workspace its
    library asks for: `slices` runs of `per` rows (per = ceil(B /
    slices) for the library's power-of-two cuts)."""
    floats = fa._library(causal).flash_dbias_workspace_floats(B, H, Tq, Tk, D, int(mma))
    slices = max(1, floats // (H * Tq * Tk))
    return {"slices": slices, "per": -(-B // slices)}


def live_pairs(torch, mask, Tq: int, causal: bool) -> int:
    """(query, key) pairs that a call computes, over the batch
    (`nn/flash_attention.py:live_pairs`)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    return fa.live_pairs(mask, Tq, causal)


def flash_causal_kernel_phase(torch, noncausal: dict, fwd_flagship: dict, bwd_flagship: dict,
                              ptxas: dict):
    """Kernels 5-8 with the causal mask (the causal build of the flash
    source) against the plain versions on the card, and the fp32 (FMA)
    instances at the generation path's shapes: o within 2e-2 (bf16) or
    1e-5 (fp32), lse within 1e-5 + 1e-5 |lse|, dq, dk, dv and dbias
    within 2e-2 (bf16) or 1e-4 (fp32) of their largest magnitude; queries
    without a live key get o = 0 and zero dq; causal dbias exactly 0
    above the diagonal; the same bits on a repeat. Times of the timed
    cases: each kernel, the plain forward and backward, one
    scaled_dot_product_attention call (is_causal, or a float attn_mask
    holding the bias and -inf; the yardstick, never called by the port)
    and its backward, and the bounds over the live pairs. `noncausal`
    holds this run's unbiased non-causal flagship times, set beside
    NONCAUSAL_BASELINE_MS; the gen calls' dq and dk/dv times are set
    beside FP32_BWD_BASELINE_MS, and the forward's times there and at the
    flagship call (`fwd_flagship`: this run's plain, bias and dropout
    times; the causal ones are this phase's) beside FWD_BASELINE_MS, and
    the tensor-core dq and dk/dv at the flagship call (`bwd_flagship`:
    this run's plain, dropout and bias times, {call: {kernel: ms}}; the
    causal ones are this phase's) beside BF16_BWD_BASELINE_MS.
    `ptxas` is the build's report by library: the instances of
    no_spill_report must not spill."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    rows = fa._library(False).flash_fwd_tile_rows(1)
    no_spill = no_spill_report(ptxas)
    if any(r is None or r["spill_bytes"] for r in no_spill.values()):
        fail(f"flash_causal: an instance that must not spill (a D 64 tensor-core instance, a "
             f"register-tiled FMA instance, a B3 pass or a GGNN forward instance) is missing "
             f"or spills: {no_spill}")
    H, D = 12, 64
    gen = torch.Generator().manual_seed(11)
    report, worst, timing = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}, {}
    cuts = {}
    for name, (B, Tq, Tk, dtype, biased, causal, lens, lead) in FLASH_CAUSAL_CASES.items():
        td = getattr(torch, dtype)
        q, do = (torch.randn(B, H, Tq, D, generator=gen).to(td).to(CARD) for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, generator=gen).to(td).to(CARD) for _ in range(2))
        bias = (torch.randn(H, Tq, Tk, generator=gen) * 2.0).to(td).to(CARD) if biased else None
        mask = torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]
        mask[-1, :lead] = False
        mask = mask.to(CARD)
        kw = {"scale": 1.0, "bias": bias, "causal": causal}
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, mask, **kw)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)

            def backward():
                return (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                        *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw),
                        *((fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0,
                                          causal=causal),) if biased else ()))

            got, again = backward(), backward()
            o2, lse2 = fa.flash_fwd(q, k, v, mask, **kw)
            po, plse = fa.attention_plain(q, k, v, mask, 1.0, bias=bias, causal=causal)
            want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, bias=bias,
                                          causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        gtol = FLASH_TOL["bfloat16"] if dtype == "bfloat16" else 1e-4
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = ((lse - plse).abs() - 1e-5 * plse.abs()).max().item()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            fail(f"flash_causal {name}: non-finite o or lse")
        if err_o > tol or err_lse > 1e-5:
            fail(f"flash_causal {name}: o err {err_o} (tol {tol}), lse err {err_lse}")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"flash_causal {name}: the forward gave other bits on a rerun")
        worst["fwd"] = max(worst["fwd"], err_o)
        report[f"{name}_o_max_abs_err"] = err_o
        for what, g, ref, rerun in zip(("dq", "dk", "dv", "dbias"), got, want, again):
            err = (g.float() - ref.float()).abs().max().item()
            scale = max(ref.float().abs().max().item(), 1e-6)
            if not torch.isfinite(g.float()).all() or err > gtol * scale:
                fail(f"flash_causal {name}: {what} err {err} > {gtol * scale} (or non-finite)")
            if not torch.equal(g, rerun):
                fail(f"flash_causal {name}: {what} other bits on a rerun")
            key = {"dk": "dkv", "dv": "dkv"}.get(what, what)
            worst[key] = max(worst[key], err)
            report[f"{name}_{what}_max_abs_err"] = err
        if lead and not (bool((o[-1, :, :lead] == 0).all())
                         and bool((got[0][-1, :, :lead] == 0).all())):
            fail(f"flash_causal {name}: queries without a live key got o or dq != 0")
        if biased and dtype == "float32":
            cuts[name] = dbias_cut(fa, B, H, Tq, Tk, causal)
        if biased and causal:
            upper = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(1)
            if not bool((got[3][:, upper] == 0).all()):
                fail(f"flash_causal {name}: dbias is not 0 above the diagonal")
        if name not in FLASH_TIMED:
            continue
        t = {"shape": [B, H, Tq, Tk, D], "dtype": dtype, "biased": biased, "causal": causal}
        with torch.inference_mode():
            t["fwd_ms"] = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, **kw))
            t["dq_ms"] = median_ms(torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw))
            t["dkv_ms"] = median_ms(
                torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
            if biased:
                t["dbias_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                    q, k, v, mask, lse, delta, do, bias, scale=1.0, causal=causal))
            t["fwd_plain_ms"] = median_ms(torch, lambda: fa.attention_plain(
                q, k, v, mask, 1.0, bias=bias, causal=causal))
            t["bwd_plain_ms"] = median_ms(torch, lambda: fa.attention_bwd_plain(
                q, k, v, mask, o, lse, do, 1.0, bias=bias, causal=causal))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if biased or not causal:
            live = mask[:, None, None, :]
            if causal:
                live = live & torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
            float_mask = torch.where(live, 0.0, float("-inf")).to(td)
            if biased:
                float_mask = float_mask + bias[None]
            lib = {"attn_mask": float_mask}
        else:
            lib = {"is_causal": True}
        with torch.inference_mode():
            t["fwd_library_ms"] = median_ms(torch, lambda: sdpa(q, k, v, scale=1.0, **lib))
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        if "attn_mask" in lib:
            lib = {"attn_mask": lib["attn_mask"].detach().clone().requires_grad_(biased)}
        out = sdpa(*leaves, scale=1.0, **lib)
        t["bwd_library_ms"] = median_ms(torch, lambda: out.backward(do, retain_graph=True))
        t["library_call"] = ("sdpa(is_causal=True)" if "is_causal" in lib else
                             "sdpa(float attn_mask" + (" with the bias" if biased else "") + ")")
        del out, leaves, lib
        pairs = live_pairs(torch, mask, Tq, causal)
        itemsize = 2 if dtype == "bfloat16" else 4
        bias_bytes = itemsize * H * Tq * Tk if biased else 0
        t["live_pairs"] = pairs
        t["fwd_bound"] = flash_bound(B, H, Tq, lens, D, itemsize, bias_bytes, pairs)
        t["dq_bound"] = flash_bwd_bound(B, H, Tq, lens, D, itemsize, 3, Tq, bias_bytes, pairs)
        t["dkv_bound"] = flash_bwd_bound(B, H, Tq, lens, D, itemsize, 4, 2 * Tk, bias_bytes,
                                         pairs)
        if biased:
            t["dbias_bound"] = flash_bwd_bound(B, H, Tq, lens, D, itemsize, 2, 0,
                                               bias_bytes + 4 * H * Tq * Tk, pairs)
        timing[name] = t
    ratio = {k: noncausal[k] / v for k, v in NONCAUSAL_BASELINE_MS.items()}
    fp32_bwd = {case: {kernel: {"ms": timing[case][f"{kernel[len('flash_'):]}_ms"],
                                "baseline_ms": base,
                                "baseline_over_ms": base / timing[case][
                                    f"{kernel[len('flash_'):]}_ms"]}
                       for kernel, base in by_kernel.items()}
                for case, by_kernel in FP32_BWD_BASELINE_MS.items()}
    fwd_now = {**fwd_flagship, "flagship_causal": timing["flagship_t512"]["fwd_ms"],
               "flagship_causal_bias": timing["t5_flagship_t512"]["fwd_ms"],
               **{case: timing[case]["fwd_ms"] for case in FP32_BWD_BASELINE_MS}}
    fwd = {case: {"ms": fwd_now[case], "baseline_ms": base,
                  "baseline_over_ms": base / fwd_now[case]}
           for case, base in FWD_BASELINE_MS.items()}
    bwd_now = {**bwd_flagship,
               **{call: {f"flash_{k}": timing[case][f"{k}_ms"] for k in ("dq", "dkv")}
                  for call, case in (("causal", "flagship_t512"),
                                     ("causal_bias", "t5_flagship_t512"))}}
    bf16_bwd = {call: {kernel: {"ms": bwd_now[call][kernel], "baseline_ms": base,
                                "baseline_over_ms": base / bwd_now[call][kernel]}
                       for kernel, base in by_kernel.items()}
                for call, by_kernel in BF16_BWD_BASELINE_MS.items()}
    fp32_dbias = {case: {"ms": timing[case]["dbias_ms"], "baseline_ms": base,
                         "baseline_over_ms": base / timing[case]["dbias_ms"],
                         "cut": cuts[case]}
                  for case, base in FP32_DBIAS_BASELINE_MS.items()}
    causal_bias = timing["t5_flagship_t512"]["dbias_ms"]
    bf16_dbias = {"causal_bias": {"ms": causal_bias,
                                  "baseline_ms": BF16_DBIAS_BASELINE_MS["causal_bias"],
                                  "baseline_over_ms": BF16_DBIAS_BASELINE_MS["causal_bias"]
                                  / causal_bias}}
    emit({"phase": "kernel flash_causal", "ok": True,
          "tolerance": {"o": FLASH_TOL, "lse": "1e-5 + 1e-5 |lse|",
                        "grads": {"bfloat16": "2e-2 of scale", "float32": "1e-4 of scale"}},
          "max_abs_err": worst, "timed": timing,
          "noncausal_flagship_ms": noncausal, "noncausal_over_baseline": ratio,
          "fp32_bwd_vs_baseline": fp32_bwd, "fwd_vs_baseline": fwd,
          "bf16_bwd_vs_baseline": bf16_bwd, "fp32_dbias_vs_baseline": fp32_dbias,
          "bf16_dbias_vs_baseline": bf16_dbias,
          "fp32_dbias_cut": cuts,
          "fwd_mma_rows": rows,
          "no_spill_ptxas": no_spill, "fused_spill_ptxas": fused_spill_report(ptxas), **report})
    return worst, timing


#: the device of the causal and generation phases
CARD = "cuda"
GEN_VOCAB = 32100  # codet5-base's vocabulary, through --vocab-size
GEN_SRC, GEN_TGT, GEN_ROWS = 256, 128, 16  # the reference CLI's defaults
GEN_BATCHES, GEN_EPOCHS = 4, 5
GEN_DECODE_BATCHES = 2
#: 2+2-layer card vs CPU (fp32): the gates of the defect model's check
GEN_TRAIN_LOSS_TOL, GEN_TRAIN_GRAD_TOL = COMBINED_TRAIN_LOSS_TOL, COMBINED_TRAIN_GRAD_TOL
GEN_STEP_LOGIT_TOL = 1e-3


def gen_args(cmd: str = "train-gen"):
    """The command line a user gives the generation commands at
    codet5-base width (hash tokenizer at vocab 32100, the reference's
    lengths, batch and beam)."""
    from deepdfa_tpu_torch import cli

    task = ["--task", "summarize"] if cmd == "train-gen" else []
    return cli.build_parser().parse_args([cmd, *task, "--vocab-size", str(GEN_VOCAB)])


def gen_config(overrides=()):
    from deepdfa_tpu_torch.core import Config, apply_overrides

    return apply_overrides(Config(), ["train.optim.learning_rate=1e-4",
                                      "train.optim.warmup_frac=0.0",
                                      "train.optim.grad_clip_norm=1.0", *overrides])


#: the summarize corpus's docstring words
GEN_DOC_WORDS = ("returns", "the", "buffer", "length", "of", "a", "list", "node", "frees",
                 "copies", "into", "checks", "if", "pointer", "is", "null", "size", "array",
                 "index", "value")


def summarize_corpus(rng, n: int, name: str = "summarize.jsonl") -> Path:
    """A summarize-task jsonl of n seeded rows (code of 300-500 C-like
    words, truncated to 256 tokens; docstrings of 20-160 words, to 128)
    in the reference's format, under build/ (gitignored)."""
    vocab = [w for w in C_WORDS if w not in ("->", "++")]
    doc = GEN_DOC_WORDS
    out = ROOT / "build" / "smoke_gen" / name
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = [{"code_tokens": [str(w) for w in rng.choice(vocab, int(rng.integers(300, 501)))],
             "docstring_tokens": [str(w) for w in rng.choice(doc, int(rng.integers(20, 161)))],
             "idx": i} for i in range(n)]
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return out


def flash_counts(fa) -> dict:
    return {"flash_fwd": fa.LAUNCHES, "flash_dq": fa.DQ_LAUNCHES, "flash_dkv": fa.DKV_LAUNCHES,
            "flash_dbias": fa.DBIAS_LAUNCHES}


def reset_flash(fa) -> None:
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = fa.DBIAS_LAUNCHES = 0


def train_gen_phase(torch, rng):
    """`train-gen`'s main path on the card: the CLI's tokenizer, reader
    and model (codet5-base width, fp32), GenTrainer.fit over 4 batches of
    16 summarize rows (256 -> 128 tokens) for 5 epochs with a dev batch,
    AdamW lr 1e-4, hidden dropout 0.1. Every loss finite and the last
    epoch's mean below the first's; launches per step: 6 forward per
    layer (encoder, decoder self-attention and cross-attention, each
    replayed under remat), 3 dq and 3 dk/dv, 2 dbias (encoder and decoder
    biases); two backward passes with one seed give the same bits; a
    2+2-layer model of the same width (dropout 0) gives the same first
    two losses and step-1 gradients on the card and on the CPU plain
    path; a step split, tokens/s and peak memory; bf16 steps beside the
    fp32 ones."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    args = gen_args()
    cfg = gen_config()
    path = summarize_corpus(rng, GEN_ROWS * (GEN_BATCHES + 1))
    steps = GEN_BATCHES * GEN_EPOCHS
    t0 = time.perf_counter()
    tok, gcfg, trainer, state, rows = cli._gen_setup(args, cfg, total_steps=steps)
    init_s = time.perf_counter() - t0
    _, src, tgt = cli._gen_encode_file(args, tok, "summarize", str(path))
    train_src, train_tgt = src[:GEN_ROWS * GEN_BATCHES], tgt[:GEN_ROWS * GEN_BATCHES]
    dev = gen_data.batches_of(src[-GEN_ROWS:], tgt[-GEN_ROWS:], 1, rows, pad_id=tok.pad_id)
    enc = gcfg.encoder
    if (enc.hidden_size, enc.num_layers, gcfg.n_dec_layers, enc.vocab_size, enc.dtype,
            src.shape[1], tgt.shape[1], rows) != (768, 12, 12, GEN_VOCAB, "float32", GEN_SRC,
                                                   GEN_TGT, GEN_ROWS):
        fail(f"train_gen: the CLI built {gcfg}, {src.shape}/{tgt.shape}, rows {rows}")

    def epoch_batches(epoch):
        return gen_data.batches_of(train_src, train_tgt, 1, rows, pad_id=tok.pad_id,
                                   shuffle_seed=cfg.train.seed + epoch)

    records = []
    reset_flash(fa)
    t0 = time.perf_counter()
    trainer.fit(state, epoch_batches, val_batches=lambda: dev, max_epochs=GEN_EPOCHS,
                log_fn=records.append, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = flash_counts(fa)
    L = enc.num_layers
    want = {"flash_fwd": steps * 6 * L + GEN_EPOCHS * 3 * L, "flash_dq": steps * 3 * L,
            "flash_dkv": steps * 3 * L, "flash_dbias": steps * 2 * L}
    if launches != want:
        fail(f"train_gen: kernel launches {launches}, expected {want}")
    losses = [r["train_loss"] for r in records]
    if not all(math.isfinite(x) for x in losses + [r["val_ppl"] for r in records]):
        fail(f"train_gen: a non-finite loss or perplexity in {records}")
    if not losses[-1] < losses[0]:
        fail(f"train_gen: the loss did not fall: epoch means {losses}")

    b0 = epoch_batches(0)[0].to(trainer.device)

    def grads():
        trainer.forward_loss(state, b0, fold_seed(0, 999)).backward()
        return grads_of(state)

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail("train_gen: two backward passes on one batch gave other gradients")
    del first, second
    cpu = gen_cpu_check(torch, args, cfg, epoch_batches(0)[1])
    split = gen_step_split(torch, trainer, state, train_src, train_tgt, tok)
    bf16 = gen_bf16_steps(torch, args, cfg, epoch_batches(0)[:2])
    emit({"phase": "train_gen", "ok": True, "params": sum(p.numel() for p in
                                                          state.model.parameters()),
          "init_seconds": init_s, "steps": steps, "epochs": GEN_EPOCHS,
          "batch": [rows, GEN_SRC, GEN_TGT], "vocab": GEN_VOCAB, "dtype": enc.dtype,
          "dropout": enc.dropout_rate, "remat": enc.remat_policy,
          "optim": dataclasses.asdict(cfg.train.optim), "epoch_train_loss": losses,
          "epoch_val_ppl": [r["val_ppl"] for r in records],
          "epoch_seconds": [r["epoch_seconds"] for r in records], "fit_seconds": fit_s,
          "last_epoch_target_tokens_per_sec": records[-1]["train_target_tokens_per_sec"],
          "kernel_launches": launches,
          "launches_per_step": {"flash_fwd": 6 * L, "flash_dq": 3 * L, "flash_dkv": 3 * L,
                                "flash_dbias": 2 * L},
          "eval_launches_per_dev_batch": {"flash_fwd": 3 * L},
          "grads_bit_equal": True, **cpu, **split, "bf16": bf16})
    return launches, trainer, state, tok, src, tgt


def gen_cpu_check(torch, args, cfg, batch) -> dict:
    """A 2+2-layer GenTrainer of the same width (fp32, dropout 0), the
    same weights on the card and on the CPU plain path: two steps on one
    batch, losses within GEN_TRAIN_LOSS_TOL, step-1 gradients within
    GEN_TRAIN_GRAD_TOL of each leaf's scale."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.models import GenConfig
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    _, enc = cli._gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=dataclasses.replace(enc, num_layers=2, dropout_rate=0.0),
                     max_target_length=args.max_target_length, beam_size=args.beam_size)
    runs = {name: GenTrainer(cfg, gcfg, total_steps=2, device=dev)
            for name, dev in (("card", CARD), ("cpu", "cpu"))}
    states = {name: tr.init_state(seed=0) for name, tr in runs.items()}
    pairs, t0 = [], time.perf_counter()
    for i in range(2):
        step = {}
        for name, tr in runs.items():
            loss = tr.forward_loss(states[name], batch.to(tr.device), None)
            loss.backward()
            step[name] = (loss.item(), {k: g.cpu() for k, g in grads_of(states[name]).items()})
            states[name].apply_gradients()
        pairs.append((step["card"][0], step["cpu"][0]))
        if i == 0:
            errs = leaf_errors(step["card"][1], step["cpu"][1])
            grad_err = max(errs.values())
            worst_leaf = max(errs, key=errs.get)
    loss_err = max(abs(a - b) for a, b in pairs)
    if loss_err > GEN_TRAIN_LOSS_TOL or grad_err > GEN_TRAIN_GRAD_TOL:
        fail(f"train_gen: 2+2-layer card vs CPU losses {pairs} (abs err {loss_err}), step-1 "
             f"gradient err {grad_err} at {worst_leaf}")
    return {"two_layer_cpu_losses": pairs, "two_layer_cpu_loss_abs_err": loss_err,
            "two_layer_cpu_step1_grad_rel_err": grad_err, "two_layer_worst_leaf": worst_leaf,
            "two_layer_cpu_seconds": time.perf_counter() - t0}


def gen_step_split(torch, trainer, state, src, tgt, tok) -> dict:
    """Median of 8 steps on one full batch, each stage synchronized: host
    collate, copies, forward, backward, optimiser; source and target
    tokens/s (real tokens) and peak memory; one step under
    torch.profiler (device time by kernel group, idle share)."""
    from deepdfa_tpu_torch.data.gen_data import collate_gen
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    split = {k: [] for k in ("host_collate_ms", "to_device_ms", "forward_ms", "backward_ms",
                             "optimizer_ms", "step_ms")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(8):
        t_a = time.perf_counter()
        batch = collate_gen(src[:GEN_ROWS], tgt[:GEN_ROWS], GEN_ROWS, tok.pad_id)
        t_b = time.perf_counter()
        dev = batch.to(trainer.device)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        loss = trainer.forward_loss(state, dev, fold_seed(1, i))
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t_f = time.perf_counter()
        for k, v in zip(split, (t_b - t_a, t_c - t_b, t_d - t_c, t_e - t_d, t_f - t_e,
                                t_f - t_a)):
            split[k].append(1e3 * v)
    med = {k: statistics.median(v) for k, v in split.items()}
    src_tok = int((batch.source_ids != tok.pad_id).sum())
    tgt_tok = int((batch.target_ids != tok.pad_id).sum())
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        trainer.train_step(state, dev, fold_seed(3, 0))
        torch.cuda.synchronize()
        prof.step()
        t_a = time.perf_counter()
        trainer.train_step(state, dev, fold_seed(3, 1))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    return {"step_source_tokens": src_tok, "step_target_tokens": tgt_tok, **med,
            "source_tokens_per_sec": src_tok / (med["step_ms"] / 1e3),
            "target_tokens_per_sec": tgt_tok / (med["step_ms"] / 1e3),
            "sequences_per_sec": GEN_ROWS / (med["step_ms"] / 1e3),
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
            "profiled_step": {**device_profile(prof, profiled_ms),
                              "device_ms_by_group": device_groups(prof)}}


def gen_bf16_steps(torch, args, cfg, batches) -> dict:
    """A few steps of the same model with bf16 activations (a field of
    the reference's T5Config): the mma instances of the causal kernels
    on a path; launches per step as in fp32, losses finite, median step
    ms."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.models import GenConfig
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    _, enc = cli._gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=dataclasses.replace(enc, dtype="bfloat16"))
    trainer = GenTrainer(cfg, gcfg, total_steps=6, device=CARD)
    state = trainer.init_state(seed=0)
    dev = [b.to(trainer.device) for b in batches]
    times, losses = [], []
    reset_flash(fa)
    for i in range(6):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        losses.append(trainer.train_step(state, dev[i % len(dev)], fold_seed(4, i)).item())
        times.append(1e3 * (time.perf_counter() - t_a))
    launches = flash_counts(fa)
    L = enc.num_layers
    if launches != {"flash_fwd": 6 * 6 * L, "flash_dq": 6 * 3 * L, "flash_dkv": 6 * 3 * L,
                    "flash_dbias": 6 * 2 * L}:
        fail(f"train_gen bf16: kernel launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_gen bf16: a non-finite loss in {losses}")
    del state, trainer
    return {"steps": 6, "losses": losses, "step_ms_median": statistics.median(times[1:]),
            "kernel_launches": launches}


def decode_gen_phase(torch, trainer, state, src, args):
    """Beam-search decoding (beam 5, max length 128) of the trained
    codet5-base-width model through GenTrainer.decode, 2 batches of 16
    sources: sequences/s; the encoder's flash forward 12 times a batch;
    then a 2+2-layer fp32 model on the card and on the CPU plain path:
    each _decode_step's logits within GEN_STEP_LOGIT_TOL of their scale,
    and the beam ids equal where every step's K-th and (K+1)-th
    candidates are more than 1e-4 apart."""
    from deepdfa_tpu_torch import cli
    import numpy as np

    from deepdfa_tpu_torch.models import GenConfig, T5Seq2Seq
    from deepdfa_tpu_torch.models import t5_gen as genm
    from deepdfa_tpu_torch.nn import flash_attention as fa

    n = GEN_ROWS * GEN_DECODE_BATCHES
    reset_flash(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = trainer.decode(state, src[:n])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in flash_counts(fa).items() if v}
    if launches != {"flash_fwd": GEN_DECODE_BATCHES * trainer.gen_cfg.encoder.num_layers}:
        fail(f"decode_gen: kernel launches {launches}")
    lengths = [len(p) for p in preds]

    _, enc = cli._gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=dataclasses.replace(enc, num_layers=2, dropout_rate=0.0))
    models = {name: T5Seq2Seq(gcfg, generator=torch.Generator().manual_seed(5)).to(dev).eval()
              for name, dev in (("card", CARD), ("cpu", "cpu"))}
    small = torch.from_numpy(src[:4].astype(np.int64))
    Tmax, K = args.max_target_length, args.beam_size
    worst = 0.0
    with torch.no_grad():
        caches = {}
        for name, m in models.items():
            s = small.to(m.encoder.word.device)
            eh = m.encoder.encode(s)
            ck, cv = genm._precompute_cross_kv(m, eh)
            z = torch.zeros(2, 4, enc.num_heads, Tmax, enc.head_dim, device=s.device)
            caches[name] = [ck, cv, z, z.clone(), s != enc.pad_token_id]
        tokens = torch.zeros(4, dtype=torch.int64)
        for t in range(Tmax):
            out = {}
            for name, m in models.items():
                ck, cv, kc, vc, em = caches[name]
                out[name], _, _ = genm._decode_step(m, tokens.to(em.device), t, kc, vc, ck, cv,
                                                    em)
            scale = out["cpu"].abs().max().item()
            worst = max(worst, (out["card"].cpu() - out["cpu"]).abs().max().item() / scale)
            tokens = out["cpu"].argmax(-1)
    if worst > GEN_STEP_LOGIT_TOL:
        fail(f"decode_gen: 2+2-layer decode-step logits card vs CPU rel err {worst}")
    gaps, real = [], genm.top_k_stable

    def spy(x, k):
        vals = torch.sort(x, dim=-1, descending=True, stable=True)[0]
        gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return real(x, k)

    genm.top_k_stable = spy
    try:
        ids_card = genm.beam_search(models["card"], small.to(CARD), K, Tmax).cpu()
    finally:
        genm.top_k_stable = real
    ids_cpu = genm.beam_search(models["cpu"], small, K, Tmax)
    margin = min(gaps)
    compared = margin > 1e-4
    if compared and not torch.equal(ids_card, ids_cpu):
        fail(f"decode_gen: 2+2-layer beam ids differ card vs CPU at margin {margin}")
    emit({"phase": "decode_gen", "ok": True, "sources": n, "beam": K, "max_length": Tmax,
          "seconds": seconds, "sequences_per_sec": n / seconds,
          "mean_output_tokens": statistics.mean(lengths), "kernel_launches": launches,
          "two_layer_step_logit_rel_err": worst, "two_layer_steps": Tmax,
          "two_layer_min_topk_margin": margin, "two_layer_ids_compared": compared,
          "two_layer_ids_equal": bool(torch.equal(ids_card, ids_cpu))})
    return launches, preds


def train_clone_phase(torch, rng):
    """`train-clone`'s path on the card at codet5-base width (fp32): the
    reference's clone files (pairs + data.jsonl, written under build/),
    read and tokenized as the CLI does at 256 tokens, CloneTrainer steps
    on 2 batches of 16 pairs (8 steps); every loss finite; per step the
    launches of the gen step (each code is a row of the seq2seq stack)."""
    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.models import CloneConfig
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train.clone_loop import CloneTrainer, clone_batches_of

    args = gen_args("train-clone")
    cfg = gen_config()
    vocab = [w for w in C_WORDS if w not in ("->", "++")]
    d = ROOT / "build" / "smoke_gen" / "clone"
    d.mkdir(parents=True, exist_ok=True)
    (d / "data.jsonl").write_text("\n".join(json.dumps(
        {"idx": str(i), "func": " ".join(str(w) for w in rng.choice(vocab, int(
            rng.integers(150, 400))))}) for i in range(40)) + "\n")
    (d / "train.txt").write_text("\n".join(f"{i % 40}\t{(7 * i + 3) % 40}\t{i % 2}"
                                          for i in range(32)) + "\n")
    tok, enc = cli._gen_tokenizer_and_encoder(args)
    ex = gen_data.read_clone_examples(str(d / "train.txt"))
    a = tok.batch_encode([f"clone: {e.source}" for e in ex], max_length=args.max_source_length)
    b = tok.batch_encode([f"clone: {e.target}" for e in ex], max_length=args.max_source_length)
    pairs = np.stack([a, b], axis=1).astype(np.int32)
    batches = clone_batches_of(pairs, [e.label for e in ex], 1, args.batch_size,
                               pad_id=tok.pad_id, shuffle_seed=cfg.train.seed)
    trainer = CloneTrainer(cfg, CloneConfig(encoder=enc), total_steps=8, device=CARD)
    state = trainer.init_state()
    losses, times = [], []
    reset_flash(fa)
    for i in range(8):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        losses.append(trainer.train_step(state, batches[i % len(batches)].to(trainer.device),
                                         fold_seed(0, i)).item())
        times.append(1e3 * (time.perf_counter() - t_a))
    launches = flash_counts(fa)
    L = enc.num_layers
    if launches != {"flash_fwd": 8 * 6 * L, "flash_dq": 8 * 3 * L, "flash_dkv": 8 * 3 * L,
                    "flash_dbias": 8 * 2 * L}:
        fail(f"train_clone: kernel launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_clone: a non-finite loss in {losses}")
    from torch.profiler import ProfilerActivity, profile

    batch = batches[0].to(trainer.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        trainer.train_step(state, batch, fold_seed(0, 8))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    metrics, _ = trainer.evaluate(state, batches[:1])
    emit({"phase": "train_clone", "ok": True, "pairs": len(ex), "batch": list(pairs.shape[1:]),
          "rows": args.batch_size, "steps": 8, "losses": losses,
          "step_ms_median": statistics.median(times[1:]), "eval": metrics,
          "kernel_launches": launches,
          "profiled_step": {**device_profile(prof, profiled_ms),
                            "device_ms_by_group": device_groups(prof)}})
    del state, trainer
    return launches


def device_groups(prof) -> dict:
    """Device ms of one profiled window by kernel group: the four flash
    kernels, the GGNN step kernel (with its bf16/int8 table launch), the
    whole-unroll kernel and the two backward kernels (the step group
    holds the bf16/int8 table launch and the int8 mxu pre-pass), matmuls
    (cuBLAS's gemm and Hopper `nvjet` kernels, CUTLASS) and everything
    else; with launch counts."""
    # kernel-name fragments of each group: the flash kernels, the GGNN
    # whole unroll and step, B3 (gru_bwd_*, reduce_splits) and B4
    # (dmsg_kernel); kernel 8 (flash_dbias_bf16_mma, flash_dbias_scalar)
    # with the sum of its cut batch's partials (dbias_reduce)
    names = {"flash_fwd": ("flash_fwd",), "flash_dq": ("flash_dq",),
             "flash_dkv": ("flash_dkv",), "flash_dbias": ("flash_dbias", "dbias_reduce"),
             "ggnn_fused": ("ggnn_fused",),
             "ggnn_step": ("ggnn_step", "msg_table", "mxu_colmax"),
             "ggnn_gru_bwd": ("gru_bwd", "reduce_splits"), "ggnn_dmsg": ("dmsg_",)}
    groups = {name: [0.0, 0] for name in (*names, "matmul", "other")}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if not str(e.device_type).endswith("CUDA") or us <= 0 or getattr(e, "is_user_annotation", False):
            continue
        name = e.key.lower()
        key = next((k for k, frags in names.items() if any(f in name for f in frags)), None) or (
            "matmul" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))
            else "other")
        groups[key][0] += us / 1e3
        groups[key][1] += e.count
    return {k: {"ms": v[0], "calls": v[1]} for k, v in groups.items()}


def kernel_name(mangled: str) -> str:
    """`flash_dq_bf16_mma<64, bias, causal>` from the mangled name of a
    kernel in an anonymous namespace of a csrc file: the width or element
    type, any further int template arguments (the GGNN kernels' message
    policy: `ggnn_fused_kernel<128, 2>` is int8), then the bool template
    flags that are on (the flash kernels' kBias and kCausal; the dbias
    and FMA instances have kCausal only); the mangled name where the
    pattern does not hold."""
    m = None
    for m in re.finditer(r"_cu_[0-9a-f]{8}(\d+)", mangled):
        pass  # the innermost: a device function's name nests its namespace's
    if not m:
        return mangled
    start = m.end()
    base, rest = mangled[start:start + int(m.group(1))], mangled[start + int(m.group(1)):]
    arg = re.match(r"I(?:Li(\d+)E|(f)|(13__nv_bfloat16))((?:Li\d+E)*)((?:Lb[01]E)*)"
                   r"(?:a|f|13__nv_bfloat16)?E", rest)
    if not arg:
        return base
    first = arg.group(1) or ("float" if arg.group(2) else "bf16")
    ints = re.findall(r"Li(\d+)E", arg.group(4))
    flags = re.findall(r"Lb([01])E", arg.group(5))
    names = (("mxu",) if base.startswith("ggnn") else ("mxu", "coherent") if base == "step_tile"
             else ("coherent",) if base == "mxu_colmax_warp" else
             ("bias", "causal") if len(flags) == 2 else ("causal",))
    return f"{base}<{', '.join([first, *ints, *(n for n, f in zip(names, flags) if f == '1')])}>"


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers", "spill_bytes"}} from nvcc's -Xptxas -v log;
    a device function that is not inlined (the GGNN `step_tile`) has its
    own spills, under its name with registers None (it runs within its
    kernel's)."""
    out, name, spill, fn = {}, None, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill, fn = kernel_name(m.group(1)), None, None
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            fn = None if fn == name else fn
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            if fn is not None:
                out[fn] = {"registers": None, "spill_bytes": int(m.group(1)) + int(m.group(2))}
                fn = None
            else:
                spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = {"registers": int(m.group(1)), "spill_bytes": spill}
            name = None
    return out


#: runtime_hooks_train and efficiency (the runtime hooks, queue A item 10):
#: the pipeline's store at the flagship recipe, one epoch, inline input,
#: a step checkpoint every HOOKS_STEP_EVERY steps; the guard's faults, the
#: preemption's step and the watchdog's timeout; HOOKS_SYNC_STEPS guarded
#: and unguarded steps a sync count (and a timed window of each, A B B A);
#: the combined run's steps and poisoned step; the health probe's bound
HOOKS_STEP_EVERY = 2
HOOKS_NAN = "nan@3,nan@4"
HOOKS_SIGTERM_AT = 6
HOOKS_STALL_AT, HOOKS_WATCHDOG_S = 6, 5.0
HOOKS_SYNC_STEPS = 8
HOOKS_COMBINED_TRAIN, HOOKS_COMBINED_NAN = 64, 2
HEALTH_TIMEOUT_S = 120.0
#: ledger MFU must lie in (0, LEDGER_MFU_MAX]: a probe is a point sample
LEDGER_MFU_MAX = 1.05


@contextlib.contextmanager
def faults_env(spec: str):
    """DEEPDFA_FAULTS set to `spec` inside the block."""
    import os

    os.environ["DEEPDFA_FAULTS"] = spec
    try:
        yield
    finally:
        os.environ.pop("DEEPDFA_FAULTS", None)


def cli_rc(cli, args: list[str]) -> int:
    """`cli.main(args)` in this process, its stdout swallowed; the exit
    code (0, or a SystemExit's)."""
    import io

    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(args)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def count_syncs(torch, fn, steps: int) -> int:
    """Synchronizing CUDA calls made by `steps` calls of fn(k), counted
    under torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(steps):
                fn(k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def runtime_hooks_train_phase(torch, tmp: Path, smi: str) -> dict:
    """The resilient runtime on the card (`cli train` in-process on the
    pipeline's store at the flagship recipe, one epoch, inline input,
    train.resilience.enabled, a step checkpoint every HOOKS_STEP_EVERY
    steps): (a) DEEPDFA_FAULTS=HOOKS_NAN; (b) the same plan plus
    sigterm@HOOKS_SIGTERM_AT exits 143 and a second `cli train` resumes
    it; (b)'s final weights, moments and counters equal (a)'s to the bit,
    and both skip steps 3 and 4 without a rollback; (c) three bad steps
    in a row at max_consecutive_bad=3 roll back once with the LR cooled
    to lr_cooldown; (d) a stalled source under a short watchdog exits 113
    (a subprocess, run beside (a)-(c): the watchdog ends its process) with
    a postmortem that `validate_postmortem` accepts. Then, in-process at
    the flagship
    batch, the synchronizing calls of HOOKS_SYNC_STEPS guarded steps
    (the runner reading each ok flag a step late) against as many
    unguarded ones, a step of each timed, and a step checkpoint's
    seconds. Returns the launches of (a) and of (b)'s resumed run."""
    import os

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.obs.flight import validate_postmortem_file
    from deepdfa_tpu_torch.train import GraphTrainer
    from deepdfa_tpu_torch.train.resilience import ResilientRunner, ResumeCursor, StepCheckpointer

    t_phase = time.perf_counter()
    base = ["train", "--config", str(tmp / "pipeline.json"), "--device", CARD,
            "train.max_epochs=1", "train.prefetch_batches=0", "train.resilience.enabled=true",
            f"train.resilience.step_checkpoint_every={HOOKS_STEP_EVERY}"]
    report: dict = {"phase": "runtime_hooks_train", "nvidia_smi": smi, "faults": HOOKS_NAN,
                    "sigterm_at": HOOKS_SIGTERM_AT, "step_checkpoint_every": HOOKS_STEP_EVERY}
    paths: dict = {}

    def final_state(run: str) -> dict:
        ckpt = StepCheckpointer(tmp / "runs" / run / cli.STEP_CHECKPOINTS_DIR)
        return ckpt.restore(ckpt.latest())

    def epochs(run: str) -> list:
        return [r for r in run_log(tmp / "runs" / run) if "epoch" in r]

    with storage_root(tmp):
        runs = {}
        # (d) runs in a process of its own (the watchdog ends it) beside
        # (a)-(c), which it shares nothing with but the read-only store
        env = {**os.environ, "DEEPDFA_FAULTS": f"stall@{HOOKS_STALL_AT}"}
        t_d = time.perf_counter()
        err_path = tmp / "hooks-d.stderr"
        with err_path.open("w") as err_file:
            stalled = subprocess.Popen(
                [sys.executable, "-m", "deepdfa_tpu_torch.cli", *base, 'run_name="hooks-d"',
                 f"train.resilience.watchdog_timeout_s={HOOKS_WATCHDOG_S}", "obs.flight=true"],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err_file)
        gk.reset_launch_counts()
        with faults_env(HOOKS_NAN):
            rc_a = cli_rc(cli, [*base, 'run_name="hooks-a"'])
        counts = gk.launch_counts()
        paths["hooks_train"] = {"ggnn_step": counts["LAUNCHES"],
                                "ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"],
                                "ggnn_dmsg": counts["DMSG_LAUNCHES"]}
        with faults_env(f"{HOOKS_NAN},sigterm@{HOOKS_SIGTERM_AT}"):
            rc_b1 = cli_rc(cli, [*base, 'run_name="hooks-b"'])
        manifest_b1 = json.loads((tmp / "runs" / "hooks-b" / cli.STEP_CHECKPOINTS_DIR
                                  / "resume.json").read_text())
        gk.reset_launch_counts()
        with faults_env(HOOKS_NAN):
            rc_b2 = cli_rc(cli, [*base, 'run_name="hooks-b"'])
        counts = gk.launch_counts()
        paths["hooks_resume"] = {"ggnn_step": counts["LAUNCHES"],
                                 "ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"],
                                 "ggnn_dmsg": counts["DMSG_LAUNCHES"]}
        if (rc_a, rc_b1, rc_b2) != (0, 143, 0):
            fail(f"runtime_hooks_train: exit codes (a, b preempted, b resumed) "
                 f"{(rc_a, rc_b1, rc_b2)}, expected (0, 143, 0)")
        if manifest_b1["reason"] != "preempt" or manifest_b1["step"] != HOOKS_SIGTERM_AT:
            fail(f"runtime_hooks_train: the preemption's manifest {manifest_b1}")
        a, b = final_state("hooks-a"), final_state("hooks-b")
        same = (a["step"] == b["step"] and a["schedule_count"] == b["schedule_count"]
                and a["model"].keys() == b["model"].keys()
                and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]))
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        same = same and sa.keys() == sb.keys() and all(
            sa[i].keys() == sb[i].keys() and all(torch.equal(sa[i][k], sb[i][k]) for k in sa[i])
            for i in sa)
        if not same:
            fail("runtime_hooks_train: the resumed run's final weights, moments or counters "
                 "differ from the uninterrupted run's")
        for run in ("hooks-a", "hooks-b"):
            rec = epochs(run)[-1]
            bad = [r["step"] for r in run_log(tmp / "runs" / run)
                   if "loss" in r and "epoch" not in r and not math.isfinite(r["loss"])]
            if rec["skipped_steps"] != 2 or rec["rollbacks"] != 0 or bad != [3, 4]:
                fail(f"runtime_hooks_train: {run} skipped {rec['skipped_steps']} steps "
                     f"(non-finite at {bad}) with {rec['rollbacks']} rollbacks (steps 3 and 4, "
                     f"no rollback expected)")
        steps_a = a["step"]
        if a["schedule_count"] != steps_a - 2:
            fail(f"runtime_hooks_train: {a['schedule_count']} updates applied over "
                 f"{steps_a} steps with 2 skipped")
        runs["a"] = {"steps": steps_a, "updates": a["schedule_count"],
                     "skipped_steps": 2, "rollbacks": 0, "train_loss": epochs("hooks-a")[-1][
                         "train_loss"]}
        runs["b"] = {"preempted_at": manifest_b1["step"], "resumed_from_step":
                     epochs("hooks-b")[-1]["resumed_from_step"], "equal_to_a_bits": True}

        with faults_env("nan@3,nan@4,nan@5"):
            rc_c = cli_rc(cli, [*base, 'run_name="hooks-c"',
                                "train.resilience.max_consecutive_bad=3"])
        rec_c = epochs("hooks-c")[-1]
        guard_c = json.loads((tmp / "runs" / "hooks-c" / cli.STEP_CHECKPOINTS_DIR
                              / "resume.json").read_text())["guard"]
        if rc_c != 0 or rec_c["rollbacks"] != 1 or guard_c["lr_scale"] != 0.5:
            fail(f"runtime_hooks_train: three bad steps gave rc {rc_c}, {rec_c['rollbacks']} "
                 f"rollbacks, lr_scale {guard_c['lr_scale']} (1 rollback at 0.5 expected)")
        runs["c"] = {"rollbacks": rec_c["rollbacks"], "skipped_steps": rec_c["skipped_steps"],
                     "lr_scale": guard_c["lr_scale"]}

        try:
            stalled.wait(timeout=600)
        finally:
            if stalled.poll() is None:
                stalled.kill()
                stalled.wait()
        pm = validate_postmortem_file(tmp / "runs" / "hooks-d" / "postmortem.json")
        if stalled.returncode != 113 or not pm["ok"] or pm["trigger"] != "watchdog_abort":
            fail(f"runtime_hooks_train: the stalled run exited {stalled.returncode} (113 "
                 f"expected), postmortem {pm}: {err_path.read_text()[-2000:]}")
        runs["d"] = {"exit": stalled.returncode, "seconds": time.perf_counter() - t_d,
                     "postmortem": {k: pm[k] for k in ("trigger", "steps", "events")}}
        report["runs"] = runs

        # the guard's syncs and cost at the flagship batch
        pcfg = config_mod.load(tmp / "pipeline.json")
        cfg = config_mod.apply_overrides(pcfg, ["train.resilience.enabled=true"])
        splits = cli.load_graph_splits(cfg)
        batches = [b.to(CARD) for b in cli.epoch_batches(cfg, splits["train"], 0)[:HOOKS_SYNC_STEPS]]
        # two states: the guarded update keeps the optimiser's counts on
        # the card, torch.optim's own step keeps them on the host
        trainer_g = GraphTrainer(cli._model(cfg), cfg, total_steps=100, device=CARD)
        state_g = trainer_g.init_state()
        trainer_u = GraphTrainer(cli._model(cfg), cfg, total_steps=100, device=CARD)
        state_u = trainer_u.init_state()
        runner = ResilientRunner(cfg.train.resilience, None, seed=cfg.train.seed)

        def guarded(k):
            _, ok = trainer_g.train_step_guarded(state_g, batches[k % len(batches)],
                                                 runner.lr_scale())
            runner.after_step(state_g, ok, ResumeCursor(0, k + 1, state_g.step))

        def plain(k):
            trainer_u.train_step(state_u, batches[k % len(batches)])

        guarded(0)
        plain(0)
        syncs = {"guarded": count_syncs(torch, guarded, HOOKS_SYNC_STEPS),
                 "unguarded": count_syncs(torch, plain, HOOKS_SYNC_STEPS),
                 "control_item": count_syncs(torch, lambda k: float(
                     trainer_u.train_step(state_u, batches[0])), 1)}
        if syncs["guarded"] != syncs["unguarded"] or syncs["control_item"] < 1:
            fail(f"runtime_hooks_train: synchronizing calls {syncs} (the guard must add none; "
                 f"the .item() control must count)")
        if runner.skipped_steps:
            fail(f"runtime_hooks_train: the guard skipped {runner.skipped_steps} clean steps")
        ms = {}
        for name in ("unguarded", "guarded", "guarded_2", "unguarded_2"):
            fn = guarded if name.startswith("guarded") else plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(HOOKS_SYNC_STEPS):
                fn(k)
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0) / HOOKS_SYNC_STEPS
        ckpt = StepCheckpointer(tmp / "hooks-ckpt-timing")
        t0 = time.perf_counter()
        ckpt.save(state_g.state_dict(), ResumeCursor(0, 1, state_g.step), seed=cfg.train.seed)
        save_s = time.perf_counter() - t0
        report.update(
            sync_calls=syncs, step_ms=ms,
            guard_cost_ms_a_step=(ms["guarded"] + ms["guarded_2"] - ms["unguarded"]
                                  - ms["unguarded_2"]) / 2,
            step_checkpoint_seconds=save_s,
            step_checkpoint_bytes=sum(p.stat().st_size for p in ckpt.directory.rglob("*.pt")),
            launches=paths, seconds=time.perf_counter() - t_phase)
    emit(report)
    return paths


def efficiency_phase(torch, tmp: Path, smi: str) -> dict:
    """The efficiency hooks on the card: (1) `cli test --profile
    --xprof-dir` on runtime_hooks_train's run (a) prints Table 5's record
    (GFLOPs and ms a call and an example, p95); the counted FLOPs of its
    batch equal the CPU count of the same batch exactly, and the trace
    names the port's CUDA kernels; (2) `cli score` of serve_source's
    sources with obs.ledger and obs.ledger_ceilings prints a ledger with
    one site a warmed rung and every ledger_mfu in (0, LEDGER_MFU_MAX];
    (3) `cli train-combined` at codebert-base width, HOOKS_COMBINED_TRAIN
    rows (4 steps of 16) under the resilient runtime and the ledger with
    DEEPDFA_FAULTS=nan@HOOKS_COMBINED_NAN: that step is skipped, the
    flash kernels launch, the ledger holds the step's site; (4) the
    bounded health probe (a subprocess, run beside 1-3) answers ok inside
    HEALTH_TIMEOUT_S. Returns the launches of (1)-(3)."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.eval import profiling
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.obs.health import BackendHealth
    from deepdfa_tpu_torch.train import CheckpointManager

    import threading

    t_phase = time.perf_counter()
    report: dict = {"phase": "efficiency", "nvidia_smi": smi}
    paths: dict = {}
    # 4. the bounded health probe, a subprocess of its own, beside 1-3
    probe: dict = {}
    prober = threading.Thread(
        target=lambda: probe.update(BackendHealth().probe(timeout_s=HEALTH_TIMEOUT_S)))
    prober.start()
    with storage_root(tmp):
        # 1. Table 5's record and the count's equality, card and CPU
        run = tmp / "runs" / "hooks-a"
        xprof_dir = tmp / "hooks-xprof"
        (run / "profiledata.jsonl").unlink(missing_ok=True)
        gk.reset_launch_counts()
        rc = cli_rc(cli, ["test", "--device", CARD, "--profile", "--xprof-dir", str(xprof_dir),
                          'run_name="hooks-a"'])
        paths["hooks_test_profile"] = {"ggnn_step": gk.LAUNCHES}
        rec = json.loads((run / "profiledata.jsonl").read_text().splitlines()[-1])
        keys = ("gflops_per_call", "gflops_per_example", "ms_per_call", "ms_per_example",
                "p95_ms_per_call")
        if rc != 0 or not all(math.isfinite(rec[k]) and rec[k] > 0 for k in keys):
            fail(f"efficiency: test --profile exited {rc} with the record {rec}")
        cfg = config_mod.load(run / "config.json")
        model = cli._model(cfg)
        model.load_state_dict(CheckpointManager(run / cli.CHECKPOINTS_DIR).restore("best")[
            "model"])
        model.eval()
        batch = cli.epoch_batches(cfg, cli.load_graph_splits(cfg)["test"], phase="eval")[0]

        def fwd(b):
            with torch.inference_mode():
                return model(b)

        model.to(CARD)
        card = profiling.compiled_cost(fwd, batch.to(CARD))
        model.to("cpu")
        cpu = profiling.compiled_cost(fwd, batch.to("cpu"))
        if card["flops"] != cpu["flops"] or abs(card["flops"] / 1e9 - rec["gflops_per_call"]) \
                > 1e-9 * card["flops"]:
            fail(f"efficiency: counted FLOPs card {card['flops']}, CPU {cpu['flops']}, "
                 f"the record's {rec['gflops_per_call']} GFLOP")
        trace = json.loads((xprof_dir / "trace.json").read_text())
        names = {e.get("name", "") for e in trace.get("traceEvents", [])
                 if e.get("cat") == "kernel"}
        ours = sorted(n for n in names if "ggnn_step_kernel" in n)
        if not ours:
            fail(f"efficiency: the xprof trace names no ggnn_step_kernel among "
                 f"{sorted(names)[:20]}")
        report["table5"] = {**{k: rec[k] for k in (*keys, "examples_per_call",
                                                   "bytes_accessed")},
                            "flops_card": card["flops"], "flops_cpu": cpu["flops"],
                            "trace_kernels": ours[:4]}

        # 2. cli score with the ledger and measured ceilings
        pcfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
        gk.reset_launch_counts()
        summary = cli_summary(cli, [
            "score", str(tmp / "serve_src"), "--out", str(tmp / "hooks_scores.jsonl"),
            "--device", CARD, "--override", 'run_name="pipeline"',
            "--override", "obs.ledger=true", "--override", "obs.ledger_ceilings=true"])
        paths["hooks_score"] = {"ggnn_step": gk.LAUNCHES}
        ledger = summary["ledger"]
        want = {f"serve_score/G{s}" for s in cli_ladder(pcfg)}
        mfu = summary.get("ledger_mfu", {})
        if set(ledger["sites"]) != want or not mfu or not all(
                0.0 < v <= LEDGER_MFU_MAX for v in mfu.values()):
            fail(f"efficiency: the score ledger's sites {sorted(ledger['sites'])} (one a rung "
                 f"of {sorted(want)} expected), ledger_mfu {mfu}")
        report["score_ledger"] = {"sites": ledger["sites"], "ceilings": ledger.get("ceilings"),
                                  "ledger_mfu": mfu,
                                  "requests_per_sec": summary["serve_requests_per_sec"]}

        # 3. train-combined at codebert-base width with a poisoned step
        out = tmp / "processed" / pcfg.data.dataset
        splits = json.loads((out / "splits.json").read_text())
        graphs = set(GraphStore(out / cli.graphs_dirname(pcfg)).load_all())
        ids = {s: sorted(int(k) for k, v in splits.items() if v == s and int(k) in graphs)
               for s in ("train", "val")}
        ds = tmp / "processed" / "pipeline-hooks"
        ds.mkdir()
        for name in ("examples.pkl", f"vocab{pcfg.data.feat.name}.json",
                     cli.graphs_dirname(pcfg)):
            (ds / name).symlink_to(out / name)
        (ds / "splits.json").write_text(json.dumps(
            {**{str(i): "train" for i in ids["train"][:HOOKS_COMBINED_TRAIN]},
             **{str(i): "val" for i in ids["val"][:SERVE_COMBINED_VAL]}}))
        ccfg = config_mod.apply_overrides(load(COMBINED_CONFIG), [
            'run_name="hooks-combined"', 'data.dataset="pipeline-hooks"',
            "train.max_epochs=1", "train.log_every_steps=1", "train.prefetch_batches=0",
            "train.resilience.enabled=true", "train.resilience.step_checkpoint_every=2",
            "obs.ledger=true"])
        ccfg_path = tmp / "hooks_combined.json"
        config_mod.to_json(ccfg, ccfg_path)
        gk.reset_launch_counts()
        reset_flash(fa)
        t0 = time.perf_counter()
        with faults_env(f"nan@{HOOKS_COMBINED_NAN}"):
            rc = cli_rc(cli, ["train-combined", "--config", str(ccfg_path), "--encoder",
                              SERVE_COMBINED_ENCODER, "--max-length", "512", "--device", CARD])
        comb_s = time.perf_counter() - t0
        paths["hooks_train_combined"] = {**{k: v for k, v in flash_counts(fa).items()
                                            if k != "flash_dbias"},
                                         "ggnn_step": gk.LAUNCHES,
                                         "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES,
                                         "ggnn_dmsg": gk.DMSG_LAUNCHES}
        log = run_log(tmp / "runs" / "hooks-combined")
        steps = [r for r in log if "step" in r and "loss" in r]
        rec = [r for r in log if "epoch" in r][-1]
        sites = sorted(rec.get("ledger", {}).get("sites", {}))
        bad = [r["step"] for r in steps if not math.isfinite(r["loss"])]
        if rc != 0 or len(steps) != 4 or bad != [HOOKS_COMBINED_NAN] or \
                rec["skipped_steps"] != 1 or not any(s.startswith("train_step/") for s in sites):
            fail(f"efficiency: train-combined exited {rc} after {len(steps)} steps (4 "
                 f"expected), non-finite at {bad}, skipped {rec.get('skipped_steps')}, "
                 f"ledger sites {sites}")
        report["train_combined"] = {
            "encoder": SERVE_COMBINED_ENCODER, "steps": len(steps),
            "losses": [r["loss"] for r in steps], "skipped_steps": rec["skipped_steps"],
            "ledger_sites": {s: rec["ledger"]["sites"][s] for s in sites},
            "seconds": comb_s, "launches": paths["hooks_train_combined"]}

    prober.join(timeout=2 * HEALTH_TIMEOUT_S)
    if not probe.get("ok") or probe["latency_s"] >= HEALTH_TIMEOUT_S:
        fail(f"efficiency: the health probe answered {probe}")
    report.update(health_probe=probe, launches=paths, seconds=time.perf_counter() - t_phase)
    emit(report)
    return paths


#: joern_and_tools: the Joern route's pool, its per-command bound in the
#: restart check, the card-vs-CPU gate on its probabilities (fp32)
JOERN_POOL_SIZE, JOERN_WEDGE_TIMEOUT_S, JOERN_PROB_TOL = 2, 2.0, 1e-5
#: a source the stub REPL has no export for: a counted failure
JOERN_UNKNOWN = "int other(int a) {\n  int b = a * 2;\n  return b;\n}\n"
#: the search: trials, their train and validation batches, the space
TUNER_TRIALS, TUNER_TRAIN_BATCHES, TUNER_VAL_BATCHES = 2, 4, 2
TUNER_LR_RANGE = (1e-4, 3e-3, True)
#: run-exp's seeds; ivdetect's sources
RUN_EXP_SEEDS = (0, 1)
IVDETECT_FUNCTIONS = 16

#: a sitecustomize for the run-exp subprocesses: it chains to the one it
#: shadows, if any, and at exit writes the process's GGNN kernel launch
#: counts to $CHIP_SMOKE_COUNTS_DIR/<pid>.json (the subprocesses count from
#: 0 as any process does; the parent cannot read their counters)
_COUNTS_HOOK = '''
import atexit, importlib.machinery, importlib.util, json, os, sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None and _spec.loader is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))


def _dump():
    gk = sys.modules.get("deepdfa_tpu_torch.nn.ggnn_kernel")
    if gk is not None:
        path = os.path.join(os.environ["CHIP_SMOKE_COUNTS_DIR"], f"{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(gk.launch_counts(), f)


atexit.register(_dump)
'''


@contextlib.contextmanager
def env_vars(**values):
    """os.environ[k] = v inside the block, restored after."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def recorded_joern(joern_session, serve_frontend):
    """JoernSession and SessionPool replaced by subclasses that record
    every instance and each session's round trips (label, ms); yields
    (sessions, pools)."""
    sessions, pools = [], []

    class Session(joern_session.JoernSession):
        def __init__(self, *a, **k):
            self.round_trips = []
            sessions.append(self)
            super().__init__(*a, **k)

        def _exchange(self, cmd, timeout=None):
            t0 = time.perf_counter()
            try:
                return super()._exchange(cmd, timeout)
            finally:
                what = ("export" if "PrintWriter" in cmd else
                        "import" if cmd.startswith("importCode(") else "handshake")
                self.round_trips.append((what, 1e3 * (time.perf_counter() - t0)))

    class Pool(serve_frontend.SessionPool):
        def __init__(self, *a, **k):
            pools.append(self)
            super().__init__(*a, **k)

    saved = joern_session.JoernSession, serve_frontend.SessionPool
    joern_session.JoernSession, serve_frontend.SessionPool = Session, Pool
    try:
        yield sessions, pools
    finally:
        joern_session.JoernSession, serve_frontend.SessionPool = saved


def joern_and_tools_phase(torch, tmp: Path, test_probs: dict, smi: str) -> dict:
    """The Joern route and the evaluation and experiment tools on the
    pipeline's storage root, run and checkpoint (flagship width, d 128):

    (a) `cli score` in-process with serve.use_joern=true and a pool of
    JOERN_POOL_SIZE over a stub `joern` REPL on PATH
    (deepdfa_tpu_torch/testing/joern_stub.py: neither machine has Joern)
    that exports the five hand-built Joern fixtures: the five fixture
    sources, a repeat of each (cache hits) and JOERN_UNKNOWN (a counted
    failure), on the card, counted from 0, then the same on the CPU plain
    path (every probability within JOERN_PROB_TOL); every fixture went
    through an import and an export round trip. Then, as in a fresh
    process (the shared feature cache dropped), a stub that wedges after
    its handshake under serve.joern_timeout_s=JOERN_WEDGE_TIMEOUT_S: one
    JoernTimeout, one restart, and the five scored with (a)'s
    probabilities. (b) `Tuner` over `random_search` of
    train.optim.learning_rate, TUNER_TRIALS trials of GraphTrainer on the
    card (TUNER_TRAIN_BATCHES steps, TUNER_VAL_BATCHES validation
    batches), each logging through RunLogger: 2 ledger rows, every value
    finite. (c) `cli run-exp --tasks deepdfa --seeds 0 1` (1 epoch): its
    `cli train` subprocesses inherit the storage root and the card; 2
    summary rows with rc 0 and a parsed result, each run's train_log.jsonl.
    (d) `cli coverage`, `logistic_control` on the store's splits beside the
    GGNN's test metrics from the card's pipeline probabilities, and `cli
    ivdetect` over IVDETECT_FUNCTIONS of serve_source's C files. Returns
    the launches of the paths jo, jo_restart, tn and rx."""
    import io
    import os

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.eval import trivial_baseline
    from deepdfa_tpu_torch.frontend import joern_session
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import frontend as serve_frontend
    from deepdfa_tpu_torch.testing import joern_stub
    from deepdfa_tpu_torch.train import GraphTrainer, positive_weight, tuning
    from deepdfa_tpu_torch.train.logging import RunLogger

    t_phase = time.perf_counter()
    report: dict = {"phase": "joern_and_tools", "nvidia_smi": smi}
    paths: dict = {}
    cfg = config_mod.load(tmp / "runs" / "pipeline" / "config.json")
    n_steps = cfg.model.n_steps
    bwd = ("ggnn_gru_bwd", "GRU_BWD_LAUNCHES"), ("ggnn_dmsg", "DMSG_LAUNCHES")
    with storage_root(tmp):
        # (a) the Joern route
        src = tmp / "joern_src"
        src.mkdir()
        for name, code in joern_stub.SOURCES.items():
            (src / f"{name}.c").write_text(code)
            (src / f"{name}_repeat.c").write_text(code)
        (src / "unknown.c").write_text(JOERN_UNKNOWN)
        stub_dir = tmp / "joern_bin"
        joern_stub.write_stub(stub_dir)
        score = ["score", str(src), "--override", 'run_name="pipeline"', "--override",
                 "serve.use_joern=true", "--override", f"serve.joern_pool_size={JOERN_POOL_SIZE}"]
        cache = serve_frontend.shared_cache()
        hits0, misses0 = cache.hits, cache.misses
        with env_vars(PATH=f"{stub_dir}{os.pathsep}{os.environ.get('PATH', '')}"), \
                recorded_joern(joern_session, serve_frontend) as (sessions, pools):
            gk.reset_launch_counts()
            card = cli_summary(cli, [*score, "--out", str(tmp / "joern_card.jsonl"),
                                     "--device", CARD])
            paths["jo"] = {"ggnn_step": gk.LAUNCHES}
            card_counts = gk.launch_counts()
            hits = cache.hits - hits0
            gk.reset_launch_counts()
            cpu = cli_summary(cli, [*score, "--out", str(tmp / "joern_cpu.jsonl"),
                                    "--device", "cpu"])
            cpu_launches = sum(gk.launch_counts().values())
        card_rows, cpu_rows = (score_rows(tmp / "joern_card.jsonl"),
                               score_rows(tmp / "joern_cpu.jsonl"))
        ok = sorted(n for n, r in card_rows.items() if r["ok"])
        trips = [t for s in sessions for t in s.round_trips]
        exports = sum(w == "export" for w, _ in trips)
        want_ok = sorted(str(src / f"{n}{s}.c") for n in joern_stub.SOURCES
                         for s in ("", "_repeat"))
        err = max((abs(card_rows[n]["prob"] - cpu_rows[n]["prob"]) for n in ok),
                  default=math.inf)
        # the card and CPU runs each made a pool; only the card's made a
        # session: the CPU's found every source in the shared cache
        if (ok != want_ok or [n for n, r in cpu_rows.items() if r["ok"]] != ok
                or card["serve_failed_requests"] != 1 or cpu["serve_failed_requests"] != 1
                or not err <= JOERN_PROB_TOL or hits != len(joern_stub.SOURCES)
                or exports != len(joern_stub.SOURCES) + 1
                or [p.size for p in pools] != [JOERN_POOL_SIZE] * 2 or cpu_launches):
            fail(f"joern_and_tools: the Joern route scored {ok} (the fixtures and their "
                 f"repeats expected), failed {card['serve_failed_requests']} on the card and "
                 f"{cpu['serve_failed_requests']} on the CPU (1 expected), card vs CPU "
                 f"{err} (gate {JOERN_PROB_TOL}), {hits} cache hits, {exports} export round "
                 f"trips, pools {[p.size for p in pools]}, {cpu_launches} CPU launches")
        if card_counts["LAUNCHES"] < n_steps * card["serve_batches"] or \
                card["ggnn_step_launches"] != n_steps * card["serve_batches"] or \
                any(v for k, v in card_counts.items() if k != "LAUNCHES"):
            fail(f"joern_and_tools: the Joern route's score launched {card_counts} over "
                 f"{card['serve_batches']} batches")
        probs = {Path(n).stem: card_rows[n]["prob"] for n in ok if "_repeat" not in n}
        report["joern"] = {
            "probs_card": probs,
            "probs_cpu": {Path(n).stem: cpu_rows[n]["prob"] for n in ok if "_repeat" not in n},
            "max_abs_err": err, "cache_hits": hits, "cache_misses": cache.misses - misses0,
            "failed": {Path(n).name: r["error"] for n, r in card_rows.items() if not r["ok"]},
            "round_trip_ms": {w: [ms for x, ms in trips if x == w]
                              for w in ("handshake", "import", "export")},
            "pool_size": pools[0].size, "sessions": len(sessions),
            "replaced": pools[0].replaced, "launches": card_counts["LAUNCHES"],
            "batches": card["serve_batches"], "seconds": card["serve_seconds"]}

        # the wedged stub, as in a fresh process: the shared cache dropped
        serve_frontend._SHARED_CACHE = None
        wedge_dir = tmp / "joern_wedge_bin"
        joern_stub.write_stub(wedge_dir, wedge_flag=tmp / "joern_wedged")
        fresh = tmp / "joern_src_restart"
        fresh.mkdir()
        for name, code in joern_stub.SOURCES.items():
            (fresh / f"{name}.c").write_text(code)
        with env_vars(PATH=f"{wedge_dir}{os.pathsep}{os.environ.get('PATH', '')}"), \
                recorded_joern(joern_session, serve_frontend) as (sessions, pools):
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            wedged = cli_summary(cli, [
                "score", str(fresh), "--out", str(tmp / "joern_restart.jsonl"), "--device",
                CARD, "--override", 'run_name="pipeline"', "--override", "serve.use_joern=true",
                "--override", "serve.joern_pool_size=1", "--override",
                f"serve.joern_timeout_s={JOERN_WEDGE_TIMEOUT_S}"])
            restart_s = time.perf_counter() - t0
            paths["jo_restart"] = {"ggnn_step": gk.LAUNCHES}
        rows = score_rows(tmp / "joern_restart.jsonl")
        restart_err = max(abs(r["prob"] - probs[Path(n).stem]) for n, r in rows.items()
                          if r["ok"])
        restarts = [s.restarts for s in sessions]
        if wedged["serve_scored"] != len(joern_stub.SOURCES) or sum(restarts) != 1 or \
                restart_err > JOERN_PROB_TOL:
            fail(f"joern_and_tools: the wedged stub's score scored {wedged['serve_scored']} "
                 f"with restarts {restarts} (one expected), {restart_err} from (a)'s scores")
        report["joern_restart"] = {"restarts": sum(restarts), "sessions": len(sessions),
                                   "replaced": pools[0].replaced, "seconds": restart_s,
                                   "max_abs_err_vs_first": restart_err,
                                   "timeout_s": JOERN_WEDGE_TIMEOUT_S}

        # (b) hyperparameter search, each trial a few steps on the card
        splits = cli.load_graph_splits(cfg)
        train_b = cli.epoch_batches(cfg, splits["train"], shuffle_epoch=0)[:TUNER_TRAIN_BATCHES]
        val_b = cli.epoch_batches(cfg, splits["val"], phase="eval")[:TUNER_VAL_BATCHES]
        pw = positive_weight(np.array([s.label for s in splits["train"]]))
        tensorboard = []

        def train_fn(overrides, report_fn):
            tcfg = config_mod.apply_overrides(cfg, [*overrides, "train.max_epochs=1"])
            run_dir = tmp / "runs" / f"tune-trial{len(tensorboard)}"
            trainer = GraphTrainer(cli._model(tcfg), tcfg, pos_weight=pw,
                                   total_steps=len(train_b), device=CARD)
            with RunLogger(run_dir) as run_log:
                records = []

                def log(r):
                    records.append(r)
                    run_log.log(r)
                    report_fn(r)

                trainer.fit(trainer.init_state(), lambda epoch: train_b,
                            val_batches=lambda: val_b, log_fn=log)
                tensorboard.append(run_log.has_tensorboard
                                   and any((run_dir / "tb").glob("events*")))
            if not (run_dir / "train_log.jsonl").exists():
                fail(f"joern_and_tools: trial {run_dir.name} wrote no train_log.jsonl")
            return {k: v for k, v in records[-1].items() if isinstance(v, (int, float))}

        tuner = tuning.Tuner(tmp / "tune" / "trials.jsonl", monitor="val_loss", mode="min")
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        space = tuning.SearchSpace(ranges={"train.optim.learning_rate": TUNER_LR_RANGE})
        best = tuner.run(tuning.random_search(space, TUNER_TRIALS, seed=0), train_fn)
        tune_s = time.perf_counter() - t0
        paths["tn"] = {"ggnn_step": gk.LAUNCHES,
                       **{name: getattr(gk, counter) for name, counter in bwd}}
        ledger = [json.loads(x) for x in (tmp / "tune" / "trials.jsonl").read_text().splitlines()]
        values = [v for r in ledger for v in (
            *[x for x in r["final"].values()],
            *[x for i in r["intermediate"] for x in i.values() if isinstance(x, (int, float))])]
        if len(ledger) != TUNER_TRIALS or best is None or not all(math.isfinite(v)
                                                                  for v in values):
            fail(f"joern_and_tools: the search's ledger {ledger}, best {best}")
        steps = TUNER_TRIALS * len(train_b)
        want = {"ggnn_step": n_steps * (steps + TUNER_TRIALS * len(val_b)),
                "ggnn_gru_bwd": n_steps * steps, "ggnn_dmsg": n_steps * steps}
        if paths["tn"] != want:
            fail(f"joern_and_tools: the search launched {paths['tn']}, expected {want}")
        report["search"] = {
            "trials": [{"overrides": r["overrides"], "val_loss": r["final"].get("val_loss"),
                        "seconds": r["seconds"]} for r in ledger],
            "best": best, "has_tensorboard": tensorboard, "seconds": tune_s}

        # (c) cli run-exp: cli train subprocesses on the card
        hook_dir, counts_dir = tmp / "runexp_hook", tmp / "runexp_counts"
        hook_dir.mkdir()
        counts_dir.mkdir()
        (hook_dir / "sitecustomize.py").write_text(_COUNTS_HOOK)
        pythonpath = os.pathsep.join(
            [str(hook_dir), str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])
        t0 = time.perf_counter()
        with env_vars(PYTHONPATH=pythonpath, CHIP_SMOKE_COUNTS_DIR=str(counts_dir)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["run-exp", "--tasks", "deepdfa", "--seeds",
                          *map(str, RUN_EXP_SEEDS), "--tag", "chip",
                          f"--extra-arg=--config={tmp / 'pipeline.json'}",
                          f"--extra-arg=--device={CARD}", "--override", "train.max_epochs=1"])
        run_exp_s = time.perf_counter() - t0
        exp_dir = tmp / "runs" / "experiments" / "chip"
        summary = [json.loads(x) for x in (exp_dir / "summary.jsonl").read_text().splitlines()]
        child = [json.loads(p.read_text()) for p in sorted(counts_dir.glob("*.json"))]
        paths["rx"] = {"ggnn_step": sum(c["LAUNCHES"] for c in child),
                       **{name: sum(c[counter] for c in child) for name, counter in bwd}}
        logs = {r["name"]: tmp / "runs" / r["name"] / "train_log.jsonl" for r in summary}
        if len(summary) != len(RUN_EXP_SEEDS) or any(
                r["rc"] != 0 or not r["result"] for r in summary) or not all(
                p.exists() for p in logs.values()) or len(child) != len(RUN_EXP_SEEDS):
            tails = {r["name"]: (exp_dir / f"{r['name']}.log").read_text()[-1500:]
                     for r in summary}
            fail(f"joern_and_tools: run-exp summary {summary}, {len(child)} counted "
                 f"subprocesses, logs {tails}")
        epochs = {n: [r for r in run_log(p.parent) if "epoch" in r] for n, p in logs.items()}
        report["run_exp"] = {
            "rows": [{k: r[k] for k in ("name", "rc", "seconds", "result")} for r in summary],
            "epoch_losses": {n: [(r["train_loss"], r["val_loss"]) for r in e]
                             for n, e in epochs.items()},
            "launches": paths["rx"], "seconds": run_exp_s}

        # (d) the host tools on the same root
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["coverage", "--config", str(tmp / "pipeline.json")])
        cov = json.loads(out.getvalue())
        coverage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        control = trivial_baseline.logistic_control(
            splits["train"], {"val": splits["val"], "test": splits["test"]},
            cfg.data.feat.input_dim)
        control_s = time.perf_counter() - t0
        test_ids = sorted(test_probs)
        labels = {s.graph_id: s.label for s in splits["test"]}
        ggnn = trivial_baseline.binary_metrics(np.array([test_probs[i] for i in test_ids]),
                                               np.array([labels[i] for i in test_ids]))
        files = [tmp / "serve_src" / f"fn_{i:06d}.c" for i in test_ids[:IVDETECT_FUNCTIONS]]
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["ivdetect", *map(str, files), "--out-dir", str(tmp / "ivdetect")])
        ivdetect_s = time.perf_counter() - t0
        dumped = [json.loads(Path(p).read_text()) for p in out.getvalue().split()]
        if set(cov) != {"train", "val", "test"} or not all(
                0.0 <= c["known_coverage"] <= 1.0 and c["n_graphs"] for c in cov.values()) or \
                not all(0.0 <= v <= 1.0 for m in control.values() for v in m.values()) or \
                len(dumped) != len(files) or not all(d["lines"] for d in dumped):
            fail(f"joern_and_tools: coverage {cov}, control {control}, "
                 f"{len(dumped)} ivdetect dumps of {len(files)}")
        report["host_tools"] = {
            "coverage": cov, "coverage_seconds": coverage_s,
            "logistic_control": control, "logistic_control_seconds": control_s,
            "ggnn_test": ggnn, "ivdetect_functions": len(files),
            "ivdetect_lines": sum(len(d["lines"]) for d in dumped),
            "ivdetect_seconds": ivdetect_s}
    report.update(launches=paths, phase_seconds=time.perf_counter() - t_phase)
    emit(report)
    return paths


#: CodeBLEU of fixed pairs: the reference package's tests' java, c# and
#: python snippets (tests/test_codebleu.py), scored by the reference's
#: get_codebleu on the CPU (the same values under every PYTHONHASHSEED
#: tried); the port must give them exactly
CODEBLEU_JAVA = ("public int sumPositive(int[] xs) {\n  int total = 0;\n"
                 "  for (int i = 0; i < xs.length; i++) {\n    if (xs[i] > 0) {\n"
                 "      total += xs[i];\n    }\n  }\n  return total;\n}",
                 "public int sumPositive(int[] xs) {\n  int total = 0;\n  int i = 0;\n"
                 "  while (i < xs.length) {\n    total += Math.max(xs[i], 0);\n    i++;\n"
                 "  }\n  return total;\n}")
CODEBLEU_CSHARP = ("public virtual int SumPositive(int[] xs) {\n  int total = 0;\n"
                   "  foreach (int x in xs) {\n    if (x > 0) {\n      total += x;\n    }\n"
                   "  }\n  return total;\n}",
                   "public virtual int SumPositive(int[] xs) {\n  int total = 0;\n"
                   "  for (int i = 0; i < xs.Length; i++) {\n"
                   "    total += Math.Max(xs[i], 0);\n  }\n  return total;\n}")
CODEBLEU_PY = ("def add(a, b):\n    total = a + b\n    return total\n",
               "def add(x, y):\n    result = x + y\n    return result\n",
               "def mul(a, b):\n    if a > b:\n        return a * b\n    return 0\n")
#: lang: (references, hypotheses, the reference's get_codebleu)
CODEBLEU_PINNED = {
    "java": ([CODEBLEU_JAVA[0]] * 2, [CODEBLEU_JAVA[1], CODEBLEU_JAVA[0]],
             {"ngram_match": 0.7117310445980464, "weighted_ngram_match": 0.6550978106135386,
              "syntax_match": 0.9090909090909091, "dataflow_match": 0.9,
              "codebleu": 0.7939799410756235}),
    "c_sharp": ([CODEBLEU_CSHARP[0]] * 2, [CODEBLEU_CSHARP[1], CODEBLEU_CSHARP[0]],
                {"ngram_match": 0.727800444251498, "weighted_ngram_match": 0.7147946741053282,
                 "syntax_match": 0.9166666666666666, "dataflow_match": 0.8888888888888888,
                 "codebleu": 0.8120376684780954}),
    "python": ([CODEBLEU_PY[0]] * 2, [CODEBLEU_PY[1], CODEBLEU_PY[2]],
               {"ngram_match": 0.027559619301326558, "weighted_ngram_match": 0.03622673932874929,
                "syntax_match": 0.7, "dataflow_match": 0.75, "codebleu": 0.378446589657519}),
}


def cli_json(cli, args: list[str]) -> dict:
    """`cli.main(args)` in this process; its stdout as one JSON object."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    return json.loads(buf.getvalue())


def codebleu_phase(tok, preds, tgt, smi: str) -> None:
    """`cli codebleu` on the host: decode_gen's beam-search outputs (ids
    mapped back to the corpus's words through the hash tokenizer) against
    their targets, every component finite and in [0, 1]; the decoded
    examples' source code against itself, 1.0 in every component; and
    CODEBLEU_PINNED's pairs equal the reference's values exactly. The
    docstring targets have no def-use triple, and the code's random C
    words seldom a parseable definition (a run's 32 rows can hold none),
    so the dataflow match of either against itself could degenerate to 0
    by the evaluator's rule: the identity check frames each example's
    code in a function that defines and returns a variable
    (`int f<i>(char *src, int n) { int len = n + <i>; <code> ; return
    len; }`), and the targets against themselves are reported, not
    gated."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.eval.codebleu import get_codebleu
    from deepdfa_tpu_torch.models import t5_gen as genm

    t0 = time.perf_counter()
    # the corpus's words (summarize_corpus leaves out "->" and "++", which
    # the hash tokenizer splits into "-" ">" and "+" "+")
    words = sorted(set(GEN_DOC_WORDS) | set(C_WORDS) - {"->", "++"})
    inverse = {int(tok.encode(w, max_length=8)[1]): w for w in words}
    if len(inverse) != len(words):
        fail(f"codebleu: the hash tokenizer maps two corpus words to one id ({len(inverse)} "
             f"ids for {len(words)} words)")

    specials = {tok.cls_id, tok.pad_id, tok.sep_id}

    def text(ids) -> str:
        return " ".join(inverse.get(int(i), f"tok{int(i)}") for i in ids
                        if int(i) not in specials)

    n = len(preds)
    refs = genm.trim_at_eos(tgt[:n], tok.sep_id, tok.pad_id)
    rows = [json.loads(x) for x in (ROOT / "build" / "smoke_gen" / "summarize.jsonl")
            .read_text().splitlines()[:n]]
    report: dict = {"phase": "codebleu", "nvidia_smi": smi, "examples": n}
    with tempfile.TemporaryDirectory() as d:
        files = {"targets": [text(r) for r in refs], "decoded": [text(p) for p in preds],
                 "code": [f"int f{i}(char *src, int n) {{ int len = n + {i}; "
                          f"{' '.join(r['code_tokens'])} ; return len; }}"
                          for i, r in enumerate(rows)]}
        for name, lines in files.items():
            (Path(d) / f"{name}.txt").write_text("\n".join(lines) + "\n")

        def score(refs_name: str, hyp_name: str) -> dict:
            return cli_json(cli, ["codebleu", "--refs", f"{d}/{refs_name}.txt", "--hyp",
                                  f"{d}/{hyp_name}.txt", "--lang", "c"])

        decoded = score("targets", "decoded")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in decoded.values()):
            fail(f"codebleu: decode_gen's outputs against their targets scored {decoded}")
        same = score("code", "code")
        if set(same.values()) != {1.0}:
            fail(f"codebleu: the decoded examples' code against itself scored {same}")
        report.update(decoded_vs_targets=decoded, code_vs_itself=same,
                      targets_vs_themselves=score("targets", "targets"),
                      mean_decoded_words=statistics.mean(len(p) for p in preds))
    pinned = {}
    for lang, (r, h, want) in CODEBLEU_PINNED.items():
        got = get_codebleu(r, h, lang)
        if got != want:
            fail(f"codebleu: {lang} pair scored {got}, the reference's {want}")
        pinned[lang] = got
    report.update(pinned=pinned, seconds=time.perf_counter() - t0)
    emit(report)


#: the generation runtime's fault runs: one epoch of GEN_RT_BATCHES
#: batches of the summarize corpus at GEN_RT_LAYERS + GEN_RT_LAYERS
#: layers (codet5-base width), a step checkpoint every GEN_RT_STEP_EVERY
GEN_RT_LAYERS = 2
GEN_RT_BATCHES = 8
GEN_RT_STEP_EVERY = 3
GEN_RT_NAN = "nan@3,nan@4"
GEN_RT_SIGTERM_AT = 6
GEN_RT_SYNC_STEPS = 8
GEN_RT_TIMED_STEPS = 4
GEN_RT_LEDGER_STEPS = 4


@contextlib.contextmanager
def gen_layers(cli, layers: int):
    """The generation commands build `layers` + `layers` layers inside the
    block (the depth cut of a smoke; widths as the command line says)."""
    real = cli._gen_tokenizer_and_encoder

    def cut(args):
        tok, enc = real(args)
        return tok, dataclasses.replace(enc, num_layers=layers)

    cli._gen_tokenizer_and_encoder = cut
    try:
        yield
    finally:
        cli._gen_tokenizer_and_encoder = real


def gen_runtime_phase(torch, trainer, state, tok, src, tgt, smi: str) -> dict:
    """`train-gen` under the resilient runtime (phase 19b): at full depth
    in-process on phase 18's trainer (its state takes the unguarded
    torch.optim steps, a second state the guarded ones), then the 2 + 2
    layer fault runs through `cli train-gen`. Returns the launches of the
    full-depth guarded steps, of run (a) and of (b)'s resumed run."""
    import numpy as np

    from deepdfa_tpu_torch import cli, obs
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core.config import ResilienceConfig
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train.resilience import ResilientRunner, ResumeCursor, StepCheckpointer

    t_phase = time.perf_counter()
    report: dict = {"phase": "gen_runtime", "nvidia_smi": smi}
    paths: dict = {}
    host = gen_data.batches_of(src[:GEN_ROWS * GEN_BATCHES], tgt[:GEN_ROWS * GEN_BATCHES], 1,
                               GEN_ROWS, pad_id=tok.pad_id)
    batches = [b.to(trainer.device) for b in host]
    state_g = trainer.init_state(seed=1)
    runner = ResilientRunner(ResilienceConfig(enabled=True), None)

    def guarded(k):
        _, ok = trainer.train_step_guarded(state_g, batches[k % len(batches)],
                                           fold_seed(0, state_g.step), runner.lr_scale())
        runner.after_step(state_g, ok, ResumeCursor(0, k + 1, state_g.step))

    def plain(k):
        trainer.train_step(state, batches[k % len(batches)], fold_seed(0, state.step))

    guarded(0)
    plain(0)
    reset_flash(fa)
    syncs = {"guarded": count_syncs(torch, guarded, GEN_RT_SYNC_STEPS)}
    paths["gen_runtime_full"] = flash_counts(fa)
    syncs["unguarded"] = count_syncs(torch, plain, GEN_RT_SYNC_STEPS)
    syncs["control_item"] = count_syncs(torch, lambda k: float(trainer.train_step(
        state, batches[0], fold_seed(0, state.step))), 1)
    if syncs["guarded"] != syncs["unguarded"] or syncs["control_item"] < 1:
        fail(f"gen_runtime: synchronizing calls {syncs} (the guard must add none; the "
             f".item() control must count)")
    if runner.skipped_steps:
        fail(f"gen_runtime: the guard skipped {runner.skipped_steps} clean steps")
    # each step timed alone (synchronized), in rounds A B B A
    times: dict = {"unguarded": [], "guarded": []}
    for name in ("unguarded", "guarded", "guarded", "unguarded"):
        fn = guarded if name == "guarded" else plain
        for k in range(GEN_RT_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(k)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    ms = {k: statistics.median(v) for k, v in times.items()}
    with tempfile.TemporaryDirectory() as d:
        ckpt = StepCheckpointer(Path(d) / "gen-ckpt-timing")
        t0 = time.perf_counter()
        ckpt.save(state_g.state_dict(), ResumeCursor(0, 1, state_g.step), seed=0)
        save_s = time.perf_counter() - t0
        save_bytes = sum(p.stat().st_size for p in ckpt.directory.rglob("*.pt"))
    # the ledger's site of a generation step (measured ceilings)
    lcfg = config_mod.apply_overrides(gen_config(), ["obs.ledger=true",
                                                     "obs.ledger_ceilings=true"])
    records: list = []
    t0 = time.perf_counter()
    with obs.session(lcfg, None):
        trainer.fit(state_g, lambda e: host[:GEN_RT_LEDGER_STEPS], max_epochs=1,
                    log_fn=records.append,
                    resilience=ResilientRunner(ResilienceConfig(enabled=True), None))
    ledger_s = time.perf_counter() - t0
    site = f"train_step/{trainer.signature(batches[0])}"
    view = records[-1].get("ledger", {}).get("sites", {}).get(site, {})
    mfu = view.get("mfu_vs_measured_ceiling")
    if mfu is None or not 0.0 < mfu <= LEDGER_MFU_MAX or not view.get("flops"):
        fail(f"gen_runtime: the ledger's {site} is {view} (an MFU in (0, {LEDGER_MFU_MAX}] "
             f"expected)")
    report["full_depth"] = {
        "layers": [trainer.gen_cfg.encoder.num_layers, trainer.gen_cfg.n_dec_layers],
        "batch": [GEN_ROWS, GEN_SRC, GEN_TGT], "sync_calls": syncs, "step_ms_median": ms,
        "step_ms": times, "guard_cost_ms_a_step": ms["guarded"] - ms["unguarded"],
        "step_checkpoint_seconds": save_s, "step_checkpoint_bytes": save_bytes,
        "ledger": {"site": site, f"ledger_mfu/{site}": mfu, "counted_tflop": view["flops"] / 1e12,
                   "flops_by_precision": view.get("flops_by_precision"),
                   "executions": view.get("executions"), "compile_seconds":
                   view.get("compile_seconds"), "ceilings": records[-1]["ledger"].get("ceilings"),
                   "fit_seconds": ledger_s}}
    del state_g, runner

    # the 2 + 2 layer fault runs through the command line
    path = summarize_corpus(np.random.default_rng(23), GEN_ROWS * (GEN_RT_BATCHES + 1),
                            "summarize_runtime.jsonl")
    lines = path.read_text().splitlines()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        (tmp / "train.jsonl").write_text("\n".join(lines[:GEN_ROWS * GEN_RT_BATCHES]) + "\n")
        (tmp / "dev.jsonl").write_text("\n".join(lines[GEN_ROWS * GEN_RT_BATCHES:]) + "\n")
        cfg = config_mod.apply_overrides(gen_config(), [
            "train.max_epochs=1", "train.resilience.enabled=true",
            f"train.resilience.step_checkpoint_every={GEN_RT_STEP_EVERY}"])
        config_mod.to_json(cfg, tmp / "gen_runtime.json")
        base = ["train-gen", "--task", "summarize", "--vocab-size", str(GEN_VOCAB),
                "--config", str(tmp / "gen_runtime.json"), "--train-file",
                str(tmp / "train.jsonl"), "--dev-file", str(tmp / "dev.jsonl"),
                "--device", CARD]

        def final_state(run: str) -> dict:
            ckpt = StepCheckpointer(tmp / "runs" / run / cli.GEN_STEP_CHECKPOINTS_DIR)
            return ckpt.restore(ckpt.latest())

        def record(run: str) -> dict:
            return [r for r in run_log(tmp / "runs" / run) if "epoch" in r][-1]

        runs: dict = {}
        t0 = time.perf_counter()
        with storage_root(tmp), gen_layers(cli, GEN_RT_LAYERS):
            reset_flash(fa)
            with faults_env(GEN_RT_NAN):
                rc_a = cli_rc(cli, [*base, 'run_name="gen-a"'])
            paths["gen_runtime_faults"] = flash_counts(fa)
            with faults_env(f"{GEN_RT_NAN},sigterm@{GEN_RT_SIGTERM_AT}"):
                rc_b1 = cli_rc(cli, [*base, 'run_name="gen-b"'])
            manifest_b1 = json.loads((tmp / "runs" / "gen-b" / cli.GEN_STEP_CHECKPOINTS_DIR
                                      / "resume.json").read_text())
            reset_flash(fa)
            with faults_env(GEN_RT_NAN):
                rc_b2 = cli_rc(cli, [*base, 'run_name="gen-b"'])
            paths["gen_runtime_resume"] = flash_counts(fa)
            with faults_env("nan@3,nan@4,nan@5"):
                rc_c = cli_rc(cli, [*base, 'run_name="gen-c"',
                                    "train.resilience.max_consecutive_bad=3"])
        runs_s = time.perf_counter() - t0
        if (rc_a, rc_b1, rc_b2, rc_c) != (0, 143, 0, 0):
            fail(f"gen_runtime: exit codes (a, b preempted, b resumed, c) "
                 f"{(rc_a, rc_b1, rc_b2, rc_c)}, expected (0, 143, 0, 0)")
        if manifest_b1["reason"] != "preempt" or manifest_b1["step"] != GEN_RT_SIGTERM_AT:
            fail(f"gen_runtime: the preemption's manifest {manifest_b1}")
        a, b = final_state("gen-a"), final_state("gen-b")
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        same = (a["step"] == b["step"] == GEN_RT_BATCHES
                and a["schedule_count"] == b["schedule_count"] == GEN_RT_BATCHES - 2
                and a["model"].keys() == b["model"].keys()
                and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
                and sa.keys() == sb.keys()
                and all(sa[i].keys() == sb[i].keys()
                        and all(torch.equal(sa[i][k], sb[i][k]) for k in sa[i]) for i in sa))
        if not same:
            fail(f"gen_runtime: the resumed run's final weights, moments or counts differ from "
                 f"the uninterrupted run's (steps {a['step']}/{b['step']}, updates "
                 f"{a['schedule_count']}/{b['schedule_count']})")
        for run in ("gen-a", "gen-b"):
            rec = record(run)
            if rec["skipped_steps"] != 2 or rec["rollbacks"] != 0 or not math.isfinite(
                    rec["train_loss"]):
                fail(f"gen_runtime: {run}'s record {rec} (steps 3 and 4 skipped, no rollback "
                     f"expected)")
            runs[run] = {k: rec[k] for k in ("train_loss", "val_ppl", "skipped_steps",
                                             "rollbacks", "resumed_from_step")}
        rec_c = record("gen-c")
        guard_c = json.loads((tmp / "runs" / "gen-c" / cli.GEN_STEP_CHECKPOINTS_DIR
                              / "resume.json").read_text())["guard"]
        if rec_c["rollbacks"] != 1 or guard_c["lr_scale"] != 0.5:
            fail(f"gen_runtime: three bad steps gave {rec_c['rollbacks']} rollbacks, lr_scale "
                 f"{guard_c['lr_scale']} (1 rollback at 0.5 expected)")
        runs["gen-c"] = {"rollbacks": rec_c["rollbacks"], "skipped_steps":
                         rec_c["skipped_steps"], "lr_scale": guard_c["lr_scale"]}
        ckpt_bytes = sum(p.stat().st_size for p in (tmp / "runs" / "gen-a"
                                                     / cli.GEN_STEP_CHECKPOINTS_DIR).rglob("*.pt"))
    report["two_layer"] = {"layers": [GEN_RT_LAYERS, GEN_RT_LAYERS], "steps": GEN_RT_BATCHES,
                           "faults": GEN_RT_NAN, "sigterm_at": GEN_RT_SIGTERM_AT,
                           "step_checkpoint_every": GEN_RT_STEP_EVERY, "runs": runs,
                           "b_equal_to_a_bits": True, "a_checkpoint_bytes_kept": ckpt_bytes,
                           "seconds": runs_s}
    report.update(launches=paths, seconds=time.perf_counter() - t_phase)
    emit(report)
    return paths


#: the phases --phase can run alone
LONE_PHASES = ("train", "train_gen", "train_clone")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="append", choices=LONE_PHASES, default=[],
                    help="run only this training phase (repeatable)")
    only = ap.parse_args().phase
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs on a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import deepdfa_tpu_torch
    except ImportError as e:
        fail(f"the deepdfa_tpu_torch package is not beside this script ({e})")
    if Path(deepdfa_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"imported deepdfa_tpu_torch from {deepdfa_tpu_torch.__file__}, not {ROOT}")
    for config in (FLAGSHIP_CONFIG, COMBINED_CONFIG):
        if not config.exists():
            fail(f"{config} is missing")
    import numpy as np

    from deepdfa_tpu_torch.nn import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi could not read the card's name and power limit: {e!r}")
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = cuda_build.build()
    ptxas = {name: ptxas_summary(r["log"]) for name, r in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": {
        name: {"cached": r["cached"], "seconds": r["seconds"], "ptxas": ptxas[name]}
        for name, r in built.items()}})

    rng = np.random.default_rng(0)
    if only:
        for name in only:
            globals()[f"{name}_phase"](torch, rng)
        return
    kernel_err, timing = kernel_phase(torch, rng)
    bwd_err, bwd_timing = bwd_kernel_phase(torch, rng)
    launches, model, serve_specs, serve_probs, budgets, max_graphs = serve_phase(torch, rng)
    profile_phase(torch, model, serve_specs[:max_graphs], budgets)
    train_launches = train_phase(torch, rng)
    # kernel 1's bf16/int8 instances, kernel 2 and their paths, on their
    # own seed so the phases after them see the data they always saw
    vrng = np.random.default_rng(7)
    policy_err, policy_timing = policy_kernel_phase(torch, vrng)
    fused_err, fused_timing = fused_kernel_phase(torch, vrng)
    serve_variants, variant_probs = serve_variants_phase(torch, model, serve_specs, serve_probs)
    train_variants = train_variants_phase(torch, vrng)
    # the mxu scatter's instances, their paths and the tune entry point, on
    # their own seed so the phases after them see the data they always saw
    mrng = np.random.default_rng(8)
    mxu_err, mxu_timing = mxu_kernel_phase(torch, mrng)
    fused_mxu_err, fused_mxu_timing = mxu_fused_kernel_phase(torch, mrng)
    serve_mxu = serve_mxu_phase(torch, model, serve_specs, serve_probs,
                                variant_probs["int8", "per_step"])
    train_mxu = train_mxu_phase(torch, mrng)
    tune_paths = tune_phase(torch, mrng)
    with tempfile.TemporaryDirectory() as pipeline_root:
        pipeline_launches, test_probs, extract_s = pipeline_phase(torch, Path(pipeline_root))
        native_phase(torch, Path(pipeline_root), extract_s, smi)
        serve_source_launches = serve_source_phase(torch, Path(pipeline_root), test_probs, smi)
        bpe_phase(Path(pipeline_root))
        attn_saved_launches = train_attn_saved_phase(torch, Path(pipeline_root))
        cascade_paths, casc_args = cascade_phase(torch, Path(pipeline_root), smi)
        localize_paths = localize_ggnn_phase(torch, model, serve_specs[:max_graphs], budgets,
                                             smi)
        localize_paths |= serve_lines_phase(torch, Path(pipeline_root), smi)
        localize_paths |= localize_combined_phase(torch, Path(pipeline_root), smi)
        host_paths = serve_pipelined_phase(torch, model, serve_specs, budgets, max_graphs, smi)
        host_paths |= serve_int8_entry_phase(torch, Path(pipeline_root), casc_args, smi)
        host_paths |= train_prefetch_phase(torch, Path(pipeline_root), smi)
        struct_paths, d288 = struct_feats_phase(torch, Path(pipeline_root), smi)
        struct_paths |= scan_phase(torch, Path(pipeline_root), smi)
        model_paths, gather_row = dataflow_bits_phase(torch, Path(pipeline_root), smi)
        model_paths |= bf16_params_phase(torch, Path(pipeline_root), smi)
        hooks_paths = runtime_hooks_train_phase(torch, Path(pipeline_root), smi)
        hooks_paths |= efficiency_phase(torch, Path(pipeline_root), smi)
        tools_paths = joern_and_tools_phase(torch, Path(pipeline_root), test_probs, smi)
    # on a seed of its own, so the phases after it see the data they always saw
    localize_paths |= localize_t5_phase(torch, np.random.default_rng(19), smi)
    flash_err, flash_timing = flash_kernel_phase(torch)
    combined_launches, cmodel, tok, ccfg, cenc = serve_combined_phase(torch, rng)
    profile_combined_phase(torch, cmodel, tok, ccfg, cenc)
    del cmodel
    bwd_flash_err, bwd_flash = flash_bwd_kernel_phase(torch)
    tc_launches = train_combined_phase(torch, rng)
    fb_err, fb = flash_bias_kernel_phase(torch)
    t5_serve, t5_model, t5_tok, t5_cfg, t5_enc = serve_combined_phase(torch, rng, "t5")
    profile_combined_phase(torch, t5_model, t5_tok, t5_cfg, t5_enc, "profile_t5")
    del t5_model
    t5_train = train_combined_phase(torch, rng, "t5")
    causal_err, causal_timing = flash_causal_kernel_phase(torch, {
        "flash_fwd": flash_timing["ms"], "flash_dq": bwd_flash["dq_ms_rate0.0"],
        "flash_dkv": bwd_flash["dkv_ms_rate0.0"]}, {
        "flagship": flash_timing["ms"], "flagship_dropout": flash_timing["dropout"]["ms"],
        "flagship_bias": fb["fwd_ms"]}, {
        "plain": {"flash_dq": bwd_flash["dq_ms_rate0.0"], "flash_dkv": bwd_flash["dkv_ms_rate0.0"]},
        "dropout": {"flash_dq": bwd_flash[f"dq_ms_rate{DROPOUT_RATE}"],
                    "flash_dkv": bwd_flash[f"dkv_ms_rate{DROPOUT_RATE}"]},
        "bias": {"flash_dq": fb["dq_ms"], "flash_dkv": fb["dkv_ms"]}}, ptxas)
    gen_train, gen_trainer, gen_state, gen_tok, gen_src, gen_tgt = train_gen_phase(torch, rng)
    gen_decode, gen_preds = decode_gen_phase(torch, gen_trainer, gen_state, gen_src, gen_args())
    codebleu_phase(gen_tok, gen_preds, gen_tgt, smi)
    gen_runtime = gen_runtime_phase(torch, gen_trainer, gen_state, gen_tok, gen_src, gen_tgt,
                                    smi)
    del gen_trainer, gen_state
    gen_clone = train_clone_phase(torch, rng)
    model_paths |= moe_combined_phase(torch, smi)
    # each main path's launches, counted from 0 just before it ran
    paths = {"serve": {"ggnn_step": launches}, "train": train_launches,
             "serve_combined": combined_launches, "train_combined": tc_launches,
             "serve_t5": t5_serve, "train_t5": t5_train, "train_gen": gen_train,
             "decode_gen": gen_decode, **gen_runtime, "train_clone": gen_clone,
             **serve_variants,
             **train_variants, **serve_mxu, "train_mxu": train_mxu, **tune_paths,
             "pipeline": pipeline_launches, "serve_source": serve_source_launches,
             "train_attn_saved": attn_saved_launches, **cascade_paths, **localize_paths,
             **host_paths, **struct_paths, **model_paths, **hooks_paths, **tools_paths}
    for path, counts in paths.items():
        idle = [k for k, n in counts.items() if n <= 0 and (k, path) != ("flash_dbias",
                                                                     "train_combined")]
        if idle:
            fail(f"the {path} run launched {idle} no time: {counts}")

    def by_path(kernel: str) -> dict:
        return {path: c[kernel] for path, c in paths.items() if c.get(kernel)}

    def by_call(kernel: str) -> dict:
        """The kernel's times at the causal and the gen path's calls."""
        fwd = kernel == "fwd"
        return {case: {"ms": t[f"{kernel}_ms"],
                       "plain_ms": t["fwd_plain_ms" if fwd else "bwd_plain_ms"],
                       "library_ms": t["fwd_library_ms" if fwd else "bwd_library_ms"],
                       "library_call": t["library_call"], "bound_ms": t[f"{kernel}_bound"][0],
                       "bound_by": t[f"{kernel}_bound"][1], "live_pairs": t["live_pairs"],
                       **{f: t[f] for f in ("shape", "dtype", "causal", "biased")}}
                for case, t in causal_timing.items() if f"{kernel}_ms" in t}

    flash_src = "deepdfa_tpu_torch/csrc/flash_attention.cu"
    # each flash row's ms, plain_ms and library_ms are at dropout 0 without
    # a bias (the library yardstick computes dq, dk and dv in one call);
    # dropout_ms is the kernel at the training path's rate, bias_* the
    # kernel, bound and yardsticks at the T5 call with its [H, T, T] bias
    step_src = "deepdfa_tpu_torch/csrc/ggnn_step.cu"
    fused_row = {k: fused_timing["fp32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    kernels = [
        {"name": "ggnn_step", "source": step_src,
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555", "max_abs_err": kernel_err,
         **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        *({"name": f"ggnn_step_{accum}", "source": step_src,
           "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555", "max_abs_err": policy_err[accum],
           **{k: policy_timing[accum][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
          for accum in ("bf16", "int8")),
        # kernel 2's row: fp32 without the chain; by_policy and chain the rest
        {"name": "ggnn_fused", "source": step_src,
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:717", "max_abs_err": fused_err,
         **fused_row, "by_policy": fused_timing,
         "chain": {a: {"ms": t["chain_ms"], "bound_ms": t["chain_bound_ms"]}
                   for a, t in fused_timing.items()}},
        # kernel 1's mxu instances (int8: with its quantizing and pre-pass
        # launches) and kernel 2's, fp32 without the chain; by_policy the rest
        *({"name": MXU_ROWS[accum][1], "source": step_src,
           "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555", "max_abs_err": mxu_err[accum],
           "library_ms": None, "fold_ms": mxu_timing[accum]["fold_ms"],
           **{k: mxu_timing[accum][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
          for accum in MXU_ROWS),
        {"name": "ggnn_fused_mxu", "source": step_src,
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:717", "max_abs_err": fused_mxu_err,
         **{k: fused_mxu_timing["fp32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "by_policy": fused_mxu_timing,
         "chain": {a: {"ms": t["chain_ms"], "bound_ms": t["chain_bound_ms"]}
                   for a, t in fused_mxu_timing.items()}},
        {"name": "ggnn_gru_bwd", "source": "deepdfa_tpu_torch/csrc/ggnn_bwd.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:852",
         "max_abs_err": bwd_err["ggnn_gru_bwd"], **bwd_timing["ggnn_gru_bwd"]},
        {"name": "ggnn_dmsg", "source": "deepdfa_tpu_torch/csrc/ggnn_bwd.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:907",
         "max_abs_err": bwd_err["ggnn_dmsg"], **bwd_timing["ggnn_dmsg"]},
        {"name": "flash_fwd", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:427",
         "max_abs_err": max(flash_err, fb_err["fwd"], causal_err["fwd"]),
         **{k: flash_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "dropout_ms": flash_timing["dropout"]["ms"],
         "dropout_library_ms": flash_timing["dropout"]["library_ms"],
         "bias": {"ms": fb["fwd_ms"], "plain_ms": fb["fwd_plain_ms"],
                  "library_ms": fb["fwd_library_ms"], "bound_ms": fb["fwd_bound"][0],
                  "bound_by": fb["fwd_bound"][1]}},
        {"name": "flash_dq", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:495",
         "max_abs_err": max(bwd_flash_err, fb_err["dq"], causal_err["dq"]),
         "ms": bwd_flash["dq_ms_rate0.0"], "plain_ms": bwd_flash["plain_ms"],
         "bound_ms": bwd_flash["dq_bound_ms"], "bound_by": bwd_flash["dq_bound_by"],
         "library_ms": bwd_flash["library_ms"],
         "dropout_ms": bwd_flash[f"dq_ms_rate{DROPOUT_RATE}"],
         "dropout_library_ms": bwd_flash["dropout_library"]["ms"],
         "bias": {"ms": fb["dq_ms"], "plain_ms": fb["bwd_plain_ms"],
                  "library_ms": fb["bwd_library_ms"], "bound_ms": fb["dq_bound"][0],
                  "bound_by": fb["dq_bound"][1]}},
        {"name": "flash_dkv", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:516",
         "max_abs_err": max(bwd_flash_err, fb_err["dkv"], causal_err["dkv"]),
         "ms": bwd_flash["dkv_ms_rate0.0"], "plain_ms": bwd_flash["plain_ms"],
         "bound_ms": bwd_flash["dkv_bound_ms"], "bound_by": bwd_flash["dkv_bound_by"],
         "library_ms": bwd_flash["library_ms"],
         "dropout_ms": bwd_flash[f"dkv_ms_rate{DROPOUT_RATE}"],
         "dropout_library_ms": bwd_flash["dropout_library"]["ms"],
         "bias": {"ms": fb["dkv_ms"], "plain_ms": fb["bwd_plain_ms"],
                  "library_ms": fb["bwd_library_ms"], "bound_ms": fb["dkv_bound"][0],
                  "bound_by": fb["dkv_bound"][1]}},
        # kernel 8 exists only with a bias: its row is the T5 call's
        {"name": "flash_dbias", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:559",
         "max_abs_err": max(fb_err["dbias"], causal_err["dbias"]),
         "ms": fb["dbias_ms"], "plain_ms": fb["bwd_plain_ms"], "bound_ms": fb["dbias_bound"][0],
         "bound_by": fb["dbias_bound"][1], "library_ms": fb["bwd_library_ms"],
         "dropout_ms": fb["dbias_dropout_ms"],
         "dropout_library_ms": fb["dbias_dropout_library"]["ms"]},
        # the bit propagation's fixed-order segment sum (no TPU kernel: the
        # reference's jax.ops.segment_sum); library_ms is index_add_
        {"name": "setops_gather_sum", "source": "deepdfa_tpu_torch/csrc/setops.cu",
         "replaces": "deepdfa_tpu/nn/setops.py:56",
         **{k: gather_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}},
    ]
    kernels_by_name = {k["name"]: k for k in kernels}
    for k in kernels:
        k["launches_by_path"] = by_path(k["name"])
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] in d288:
            # the struct_feats and scan paths run only the d 288 model
            at = {p: n for p, n in k["launches_by_path"].items() if p in struct_paths}
            k["d288"] = {**d288[k["name"]], "launches": sum(at.values()),
                         "launches_by_path": at}
        if k["name"].startswith("flash_"):
            k["by_call"] = by_call(k["name"][len("flash_"):])
    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"], "launches": k["launches"],
                       "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                       "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                       "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
                       "launches_by_path": k["launches_by_path"],
                       **({"dropout_ms": k["dropout_ms"], "dropout_rate": DROPOUT_RATE}
                          if "dropout_ms" in k else {}),
                       **({"dropout_library_ms": k["dropout_library_ms"]}
                          if "dropout_library_ms" in k else {}),
                       **({f"bias_{f}": v for f, v in k["bias"].items()} if "bias" in k else {}),
                       **({"by_call": k["by_call"]} if "by_call" in k else {}),
                       **({f: k[f] for f in ("by_policy", "chain", "fold_ms", "d288")
                           if f in k})}
                      for k in kernels]})
    times = [k[f] for k in kernels for f in ("ms", "plain_ms", "bound_ms")]
    times += [k["bias"][f] for k in kernels if "bias" in k for f in ("ms", "plain_ms", "bound_ms")]
    times += [c[f] for k in kernels for c in k.get("by_call", {}).values()
              for f in ("ms", "plain_ms", "library_ms", "bound_ms")]
    times += [c[f] for k in kernels for c in k.get("by_policy", {}).values()
              for f in ("ms", "chain_ms", "step_launches_ms", "plain_ms", "bound_ms")]
    times += [k["d288"][f] for k in kernels if "d288" in k for f in ("ms", "plain_ms", "bound_ms")]
    if not all(kernels_by_name[name]["d288"]["launches"] > 0
               for name in ("ggnn_step", "ggnn_gru_bwd", "ggnn_dmsg")):
        fail(f"a d 288 kernel launched no time on the struct_feats and scan paths: "
             f"{ {k['name']: k['d288']['launches'] for k in kernels if 'd288' in k} }")
    if not all(math.isfinite(t) for t in times):
        fail("a kernel time is not finite")
    if not all(k["launches"] > 0 for k in kernels):
        fail(f"a kernel launched no time on the main paths: "
             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
