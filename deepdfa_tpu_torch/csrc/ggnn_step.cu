// The GGNN forward for NVIDIA Hopper (sm_90a): kernel 1, one message-
// passing step under the fp32, bf16 and int8 message policies, and
// kernel 2, every step of the unroll in one cooperative launch.
//
// Replaces the TPU kernels deepdfa_tpu/nn/ggnn_kernel.py:_fwd_kernel
// (launched by _fwd_call; body in _block_aggregate, _edge_messages,
// _aggregate, _gru) and _fused_kernel (launched by _fused_call), both
// with the "fold" and the "mxu" scatter. Per step it computes, for every node v of
// the padded batch,
//
//   a_v  = sum_t sum_{e: dst_e = v} w_{t,e} * msg_t(h_{src_e})
//   h'_v = GRU(a_v, h_v)            (torch convention, gates r, z, n)
//
// with w_{t,e} = edge_mask_e * [edge_type_e == t] and the policy's
// message (the reference's `accum`):
//   fp32  msg_t(x) = x @ Wm_t + bm_t
//   bf16  msg_t(x) = bf16(x) @ bf16(Wm_t) + bm_t, products summed in fp32
//   int8  msg_t(x) = (q(x) @ Wq_t) * s(x) * ws_t + bm_t, where per row
//         s(x) = max|x| * (1/127) (1 for a zero row) and
//         q(x) = clip(rint(x / s(x)), -127, 127); Wq_t, ws_t the same per
//         output channel (the wrapper quantizes the weights).
// The aggregate and the GRU are fp32 under every policy.
//
// Design. The TPU kernel staged the whole node table in VMEM, walked a
// sequential grid and scattered with a one-hot MXU product; none of
// that carries over. Edges are dst-sorted with the live edges a prefix
// (graphs/batch.py), so each node's in-edges are one contiguous run,
// found through a CSR row pointer built over the live prefix only. One
// block of 8 warps owns a tile of 64 nodes (`step_tile`) and keeps three
// planes in shared memory: hs (h rows), ss (sums; per-warp staging; the
// GRU's weight ring) and as (the aggregate), of [64][d + 4] floats (a row
// is padded so that the 4 rows a warp reads at one k fall in 4 bank
// groups), and cs (sum w). Per tile:
//   1. aggregate, fold: per edge type, each warp sums coef * row over its
//      8 nodes' runs in edge order (one column per lane, no atomics:
//      deterministic) into ss, with row the policy's message-side row
//      (h; bf16(h); q(h)) and coef = w (int8: w * s(h_src)), and sum(w)
//      into cs (`fold_sums`: the warp's runs are one edge range, its src
//      and weights loaded 32 at a time and rows gathered 4 ahead of the
//      FMAs). The block then applies the policy's Wm_t (and ws_t) and
//      c * bm_t once per node: by linearity N*d^2 per type instead of
//      E*d^2, a reassociation of the reference's per-edge sum that keeps
//      the message side's rounding (rows are rounded or quantized before
//      the sum, never the sum itself). That product is register-tiled, a
//      thread 4 nodes x 4 columns of a 64-column panel (2 x 4 of 32 where
//      d is not a multiple of 64), Wm_t's panels (in the policy's own
//      type) coming in halves of k through a two-stage cp.async ring in
//      the hs plane, which holds nothing yet.
//   1'. aggregate, mxu: below.
//   2. the block stages its h rows into hs.
//   3. GRU: gx = a @ Wih + bih and gh = h @ Whh + bhh over the 64 rows of
//      as and hs. Threads 0..127 form gx, threads 128..255 gh, each 8
//      nodes x 2 columns of a 32-column panel and its 3 gates (48
//      accumulators); Wih and Whh come in k-panels of [KP][3 gates][32
//      columns] through a cp.async ring in the ss plane, which this phase
//      leaves dead, each staged weight serving the block's 64 nodes. A
//      thread loads about one float per shared-memory wavefront, so the
//      tile is sized by FMAs per float loaded: 8 x 2 x 3 does 192 FMAs on
//      56 floats per 4 k (all six gates of 2 x 4 did 192 on 112, 4 x 2 on
//      80). At a panel's end the halves trade the gates of half their
//      nodes through ss and each applies the gates of 4 nodes x 2 columns.
//      The first design streamed both matrices from L2 through every
//      warp, each load feeding 8 nodes, ~805 MB of L2 reads a flagship
//      step.
// Every product sum is one IEEE fp32 fmaf chain over k ascending from 0,
// the biases added after (no tensor cores for fp32 or bf16, no TF32), and
// every other rounding step an explicit _rn intrinsic, so the outputs are
// the bits of the first design, whose warps owned 8 nodes and a column a
// lane, and the two kernels that run this body cannot be contracted
// differently.
//
// Kernel 1 (`ggnn_step_kernel`) runs step_tile once per 64-node tile.
// Under bf16 and int8 a first launch (`msg_table_kernel`) writes the
// message-side table: bf16(h), or q(h) and s(h). The gather then reads
// 2 (bf16) or 1 (int8) bytes per element instead of 4.
//
// Kernel 2 (`ggnn_fused_kernel`) runs every step in one launch: a
// persistent grid (as many 256-thread blocks as the card holds at once,
// each looping over its tiles) with a grid-wide barrier between steps
// (cooperative_groups, launched by cudaLaunchCooperativeKernel). The
// state ping-pongs between two f32 planes in global memory, h_out and a
// scratch plane, which the 50 MB L2 holds at the flagship (2 x 8 MB);
// with a chain it also writes each step's input plane. bf16 rounds the
// f32 rows as it gathers them (the reference's fused kernel casts the
// state plane the same way). int8 quantizes each row once per step after
// the GRU of the step that writes it, from the rows the block has just
// written, into one of two shadow tables (one read, one written), and
// the initial state before step 0: one barrier per step. The state
// planes and shadow tables are written inside the launch, so the body
// reads them with L2-only loads (__ldcg) and never through the
// non-coherent read-only path that kernel 1 uses (__ldg). It is
// bit-equal to n_steps launches of kernel 1 because both run the same
// step_tile and the same quant_row.
//
// The mxu scatter (template argument kMxu; the reference's `_aggregate`
// with scatter="mxu", deepdfa_tpu/nn/ggnn_kernel.py:396-433). The TPU
// multiplied a [block_e, block_n] one-hot block by the block's messages
// on the MXU; a dense one-hot product would do block_n times the needed
// work here. Edges are dst-sorted, so the product over an edge block is
// a segmented sum over each node's run, cut at the block_e boundaries:
// the same function. Each warp walks the edges of its 8 nodes' runs
// (one contiguous range) in chunks of 8 edges and computes the chunk's
// messages msg = (row @ Wm_t + bm_t) * w (int8: ((q @ Wq_t) * s * ws_t +
// bm_t) * w, the reference's operation order, every rounding an
// explicit _rn), one column per lane. fp32 and bf16 stage the chunk's
// message-side rows in the warp's rows of ss and run FMA chains, one Wm_t
// load feeding 8 edges. int8 multiplies on the integer tensor cores: one
// mma.sync m16n8k32 s8.s8.s32 per 8 columns and 32 k, the chunk's 8 edges
// its rows 0-7 (rows 8-15 zero), A read from the quantized table 8 bytes
// a lane and B from Wq_t, which the wrapper passes transposed ([out, in])
// and the block stages once in the hs plane with its 8-byte words XOR-
// swizzled by row, so the 16 lanes of a half warp read 16 bank pairs.
// A lane's 8 consecutive k of A pair with the same 8 k of B, a permuted
// k order inside each product, which integers do not see. The products
// are integers, at most 127^2 d < 2^24 for d <= 288, so each int32 sum
// converts to float exactly: the value the first design's fp32 FMA chain
// gave. The fragments' layout (rows of edges, 2 columns a lane) is re-laid
// through the warp's rows of ss into the lane-per-column layout the sums
// walk. Then, in edge order, each node adds its messages into the open
// block's partial P, and on a block change acc_t += P; at the end of a
// node's run a += acc_t (types in ascending order), the reference's
// association. fp32 and bf16 sum the f32 messages; int8 requantizes each
// message against its block's column scale, ms = max|msg| * (1/127) (1
// for a zero column), sums the quanta clip(rint(msg / ms), -127, 127)
// exactly in int32 and adds float(sum) * ms. The column max runs over
// every edge of the block, across node tiles, so a pre-pass
// (`mxu_colmax_warp`) computes every live edge's message and folds |msg|
// into colmax[t][block][column] with an integer atomicMax on the float's
// bits: order-free, so deterministic. The aggregate recomputes the
// messages (the same instructions, hence the same bits) rather than
// storing them: the pre-pass keeps only the [T, E / block_e, D] maxima
// (64 KB at the flagship). Kernel 1 under int8 is three launches (the
// quantized table, the pre-pass, the step); kernel 2 runs the pre-pass
// over the persistent grid before each step, with a grid barrier after
// it: two barriers a step, and one colmax slice per step, zeroed before
// the launch (kernel 2's extra residency, `fused_residency_bytes`).
//
// Widths. d is a multiple of 32 up to 288 (GGNN_WIDTHS): 288 is the
// structural-feature model's embedding, (4 + 5) x 32. Past d 128 a block
// has its SM to itself (the planes take 195 KB of shared memory at d 256,
// 219 KB at d 288, of the 227 KB a block may have); at d 288 int8 mxu's
// Wq_t^T (81 KB) no longer fits the hs plane and the products read it in
// place.
//
// Bound on this card. One flagship fold step (N 16384, d 128, T 1) does
// 2*N*d^2*T + 12*N*d^2 ~ 3.8 GFLOP against ~16 MB of node state moved,
// so it is bound by fp32 operations (67 TFLOP/s at the H100 SXM's
// published peak; PERF.md has the measured times beside it): the GRU
// products are 6/7 of them. The mxu messages add 2*E_live*d^2*T (at the
// flagship 40,884 live edges, 1.3 GFLOP a pass), fp32 FMA under fp32 and
// bf16 (the fp32 contract allows no TF32; a bf16 mma's fp32 accumulation
// would not give the FMA chain's bits), int8 IMMA twice (pre-pass and
// aggregate) at the card's 1,979 int8 TOP/s. Kernel 2 saves the launches
// and the host round trips between steps, not operations.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cuda_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNodesPerWarp = 8;
constexpr int kTileNodes = kWarps * kNodesPerWarp;  // nodes per tile (block)

// The GRU's register-tiled products compute kPanel columns of the tile at
// a time: threads 0..127 the three gates of a @ Wih and threads 128..255
// those of h @ Whh, a thread kGruCols columns for 16 / kGruCols nodes.
constexpr int kPanel = 32;
constexpr int kGruCols = 2;
// k a thread loads of a row of a or h at once: 2 (LDS.64) keeps 16
// registers that 4 (LDS.128) would hold; a wavefront serves the same
// floats either way
constexpr int kGruK = 2;
// stages of the GRU's weight ring
constexpr int kRing = 2;
// int8 mxu messages on the integer tensor cores (else fp32 FMA chains)
constexpr bool kImmaMessages = true;

// floats of a staged row: d and 4 of padding
__host__ __device__ constexpr int row_stride(int d) { return d + 4; }
// floats of the GRU's trade between its two halves: 3 gates of the tile's
// 64 nodes x 32 columns
constexpr int kTrade = 3 * kTileNodes * kPanel;
// floats of the ss plane: 64 rows, and at least the trade
__host__ __device__ constexpr int ss_floats(int d) {
  return kTileNodes * row_stride(d) > kTrade ? kTileNodes * row_stride(d) : kTrade;
}

// k rows of a GRU ring stage ([2 weights][KP][3 gates][kPanel] floats):
// the largest of 16, 8 and 4 that divides d and lets kRing stages fit in
// the ss plane
__host__ __device__ constexpr int gru_kp(int d) {
  return d % 16 == 0 && kRing * 16 * 6 * kPanel <= ss_floats(d)  ? 16
         : d % 8 == 0 && kRing * 8 * 6 * kPanel <= ss_floats(d) ? 8
                                                                 : 4;
}
static_assert(kRing * 4 * 6 * kPanel <= ss_floats(32), "the GRU ring fits at d 32");

// the planes hs, ss, as and cs
constexpr int smem_bytes(int d) {
  return (2 * kTileNodes * row_stride(d) + ss_floats(d) + kTileNodes) * (int)sizeof(float);
}
// blocks an SM holds by shared memory, at most 2: the register cap
constexpr int min_blocks(int d) { return 2 * (smem_bytes(d) + 1024) <= 228 * 1024 ? 2 : 1; }

// message policies; the numbers are the wrapper's (nn/ggnn_kernel.py:POLICIES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

// element type of the policy's message-side table and transform weights
template <int P> struct Msg;
template <> struct Msg<kF32> { using T = float; };
template <> struct Msg<kBF16> { using T = __nv_bfloat16; };
template <> struct Msg<kI8> { using T = int8_t; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// N consecutive values from shared memory, as floats (exact); the fold's
// transform reads its bf16 and int8 weights 4 at a time
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&w)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *p;
  }
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    w[i] = v.x, w[i + 1] = v.y;
  }
}
// int8 byte i of v ^ 0x80808080 (b + 128 for a quantum b >= -127) as the
// float 2^23 + b + 128, less 2^23 + 128: b exactly, on the integer and FADD
// pipes rather than I2F's quarter rate
__device__ __forceinline__ float int8_byte(unsigned v, int i) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
}
__device__ __forceinline__ void load_cols(const int8_t* p, float (&w)[4]) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = int8_byte(v, i);
}

// N consecutive floats into device memory
template <int N>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// wait until at most N committed cp.async groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a @ b on the integer tensor cores: one m16n8k32 tile, s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A load of node state or of a message table: through the read-only
// path where nothing writes it during the launch (kernel 1), L2-only and
// coherent where the same launch writes it (kernel 2).
template <bool kCoherent, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The reference's _quant_rows for one row held by a warp, C values per
// lane at columns c * 32 + lane: s = max|x| * (1/127) (XLA turns the
// reference's `/ 127.0` into that product), 1 for an all-zero row;
// q = clip(rint(x / s), -127, 127) with a true division and rounding
// half to even.
template <int C>
__device__ __forceinline__ void quant_row(const float (&x)[C], int lane, int8_t* q_row,
                                          float* s_row) {
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) m = fmaxf(m, fabsf(x[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = __fmul_rn(m, 1.0f / 127.0f);
  s = s > 0.0f ? s : 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(x[c], s)), -127.0f), 127.0f);
    q_row[c * 32 + lane] = static_cast<int8_t>(r);
  }
  if (lane == 0) *s_row = s;
}

// Edges and weights of a step, the same for every step of an unroll.
// wm is the policy's transform (float, bf16 or int8 [n_etypes, D, D],
// [in, out]; under int8 mxu int8 [n_etypes, D, D] transposed, [out, in]);
// ws its per-channel scales [n_etypes, D] (int8 only).
struct StepArgs {
  const int* src;     // [e]
  const float* w2;    // [n_etypes, e]
  const int* rowptr;  // [n + 1] over the live prefix
  const void* wm;
  const float* ws;
  const float* bm;    // [n_etypes, D]
  const float* wih;   // [D, 3D]
  const float* whh;   // [D, 3D]
  const float* bih;   // [3D]
  const float* bhh;   // [3D]
  int n, e, n_etypes;
  int block_e;        // mxu: edges per block (divides e)
};

constexpr int kChunk = kNodesPerWarp;  // mxu: edges a warp computes at once

// int8 mxu: whether Wq_t^T ([D][D] bytes) fits the hs plane. Up to d 256
// it does; past that (d 288: 81 KB against 73 KB) the products read it
// from device memory as the wrapper laid it out, through the read-only
// path (L1 and L2 hold it: a type's rows are what every warp reads).
template <int D>
__host__ __device__ constexpr bool wqt_staged() {
  return D * D <= kTileNodes * row_stride(D) * (int)sizeof(float);
}
static_assert(wqt_staged<256>(), "Wq_t^T is staged at d 256");

// int8 mxu: the XOR on the 8-byte word index of row r of the staged
// Wq_t^T ([D][D] bytes, rows of D bytes), chosen so that the 16 lanes of
// a half warp, reading word 4 ks + (lane & 3) of rows 8 nt + (lane >> 2),
// hit 16 distinct bank pairs at every width; none where it is not staged
template <int D>
__device__ __forceinline__ int wqt_swizzle(int r) {
  if constexpr (!wqt_staged<D>()) {
    return 0;
  } else if constexpr (D % 128 == 0) {
    return 4 * (r & 3);
  } else if constexpr (D % 64 == 0) {
    return 4 * ((r >> 1) & 1);
  } else {
    return 0;
  }
}

// int8 mxu: Wq_t^T of type t (the wrapper's [out, in] bytes) into the hs
// plane, swizzled; the block waits for it. Where it does not fit, the
// device copy itself.
template <int D>
__device__ __forceinline__ const int8_t* stage_wqt(const StepArgs& a, int t, float* smem) {
  int8_t* dst = reinterpret_cast<int8_t*>(smem);
  const int8_t* src = static_cast<const int8_t*>(a.wm) + (size_t)t * D * D;
  if constexpr (!wqt_staged<D>()) return src;
  constexpr int kChunks = D / 16;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < D * kChunks; idx += kThreads) {
    const int r = idx / kChunks, m = idx % kChunks;
    cp_async16(dst + r * D + 16 * (m ^ (wqt_swizzle<D>(r) >> 1)), src + (size_t)r * D + 16 * m,
               16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  return dst;
}

// int8 mxu on the integer tensor cores: the integer products q(h_src) @
// Wq_t of edges u_0 .. u_{cnt-1} (u_i held by lane i) into stage[i][col]
// (rows of row_stride(D) floats) as floats, exact. Lane (g, q) holds the
// A words of edge g at bytes 32 ks + 8 q .. +7 and the B words of column
// 8 nt + g at the same k; rows 8-15 of A are zero.
template <int D, bool kCoherent>
__device__ __forceinline__ void imma_products(const int8_t* table, int u_l, int cnt,
                                              const int8_t* wqt, float* stage) {
  constexpr int KS = D / 32;
  constexpr int RS = row_stride(D);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int u = __shfl_sync(0xffffffffu, u_l, g);
  unsigned lo[KS], hi[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    int2 v = make_int2(0, 0);
    if (g < cnt)
      v = load<kCoherent>(reinterpret_cast<const int2*>(table + (size_t)u * D + 32 * ks + 8 * q));
    lo[ks] = static_cast<unsigned>(v.x);
    hi[ks] = static_cast<unsigned>(v.y);
  }
#pragma unroll 4
  for (int nt = 0; nt < D / 8; ++nt) {
    const int r = 8 * nt + g;  // the column whose B words this lane holds
    const int8_t* row = wqt + r * D;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int2* bp = reinterpret_cast<const int2*>(row + 8 * ((4 * ks + q) ^ wqt_swizzle<D>(r)));
      const int2 b = wqt_staged<D>() ? *bp : __ldg(bp);
      mma_s8(acc, lo[ks], 0u, hi[ks], 0u, static_cast<unsigned>(b.x), static_cast<unsigned>(b.y));
    }
    *reinterpret_cast<float2*>(stage + g * RS + 8 * nt + 2 * q) =
        make_float2(__int2float_rn(acc[0]), __int2float_rn(acc[1]));
  }
}

// mxu: the messages of edges [base, base + cnt), cnt <= kChunk, of type t
// into m[i][c] (column c * 32 + lane of edge base + i; rows i >= cnt are
// zero) through `stage`, this warp's kChunk rows of the ss plane. fp32 and
// bf16: the edges' message-side rows are staged, then every lane runs the
// FMA chains of its columns over k in ascending order, one Wm_t load
// feeding kChunk edges. int8: the integer products on the tensor cores
// (`imma_products`, Wq_t^T staged at `wqt`), re-laid through the stage.
// Then msg = (mm + bm_t) * w, int8 ((mm * s_src) * ws_t + bm_t) * w.
template <int D, int P, bool kCoherent, class TableT>
__device__ __forceinline__ void chunk_messages(const StepArgs& a, int t, int base, int cnt,
                                               const TableT* table, const float* tscale,
                                               const int8_t* wqt, float* stage,
                                               float (&m)[kChunk][D / 32]) {
  using W = typename Msg<P>::T;
  constexpr int C = D / 32;
  constexpr int RS = row_stride(D);
  const int lane = threadIdx.x & 31;
  int u_l = 0;
  float w_l = 0.0f, s_l = 1.0f;
  if (lane < cnt) {
    u_l = __ldg(a.src + base + lane);
    w_l = __ldg(a.w2 + (size_t)t * a.e + base + lane);
    if constexpr (P == kI8) s_l = load<kCoherent>(tscale + u_l);
  }
  if constexpr (P == kI8 && kImmaMessages) {
    imma_products<D, kCoherent>(reinterpret_cast<const int8_t*>(table), u_l, cnt, wqt, stage);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) m[i][c] = stage[i * RS + c * 32 + lane];
  } else {
    for (int i = 0; i < kChunk; ++i) {
      const int u = __shfl_sync(0xffffffffu, u_l, i);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float x = 0.0f;
        if (i < cnt) {
          x = to_float(load<kCoherent>(table + (size_t)u * D + c * 32 + lane));
          if constexpr (P == kBF16 && sizeof(TableT) == 4) x = round_bf16(x);
        }
        stage[i * RS + c * 32 + lane] = x;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) m[i][c] = 0.0f;
    const W* wmt = static_cast<const W*>(a.wm) + (size_t)t * D * D;
    for (int k = 0; k < D; k += 4) {
      float wq[4][C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr (P == kI8) {  // Wq_t^T, [out, in]: 4 k in a word
          const char4 v = __ldg(reinterpret_cast<const char4*>(wmt + (c * 32 + lane) * D + k));
          wq[0][c] = v.x, wq[1][c] = v.y, wq[2][c] = v.z, wq[3][c] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) wq[q][c] = to_float(__ldg(wmt + (k + q) * D + c * 32 + lane));
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4 s4 = *reinterpret_cast<const float4*>(stage + i * RS + k);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < C; ++c) m[i][c] = fmaf(sv[q], wq[q][c], m[i][c]);
      }
    }
  }
  __syncwarp();  // the next chunk restages
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float w = __shfl_sync(0xffffffffu, w_l, i);
    const float sr = __shfl_sync(0xffffffffu, s_l, i);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      float x = m[i][c];
      if constexpr (P == kI8) x = __fmul_rn(__fmul_rn(x, sr), __ldg(a.ws + (size_t)t * D + j));
      m[i][c] = __fmul_rn(__fadd_rn(x, __ldg(a.bm + (size_t)t * D + j)), w);
    }
  }
}

// mxu, int8: the column scale of block `blk` of type t from the
// pre-pass's max|msg| bits: max * (1/127), 1 for a zero column.
template <int D, bool kCoherent>
__device__ __forceinline__ float block_scale(const unsigned* colmax, int t, int n_eb, int blk,
                                             int j) {
  const float mx = __uint_as_float(load<kCoherent>(colmax + ((size_t)t * n_eb + blk) * D + j));
  const float ms = __fmul_rn(mx, 1.0f / 127.0f);
  return ms > 0.0f ? ms : 1.0f;
}

// mxu, int8: the pre-pass of one warp over type t (Wq_t^T staged at
// `wqt`). Warp `gw` of `nw` takes spans of kSpan live edges (span gw,
// gw + nw, ...), computes their messages and folds max |msg| per column
// into colmax[t][block][column] (zeroed beforehand) with atomicMax on the
// bits, once per block a span touches. Non-negative floats order as
// their bit patterns, so the result does not depend on the order of the
// atomics.
constexpr int kSpan = 4 * kChunk;
template <int D, bool kCoherent>
__device__ __noinline__ void mxu_colmax_warp(const StepArgs a, int t, float* stage,
                                             const int8_t* wqt, const int8_t* table,
                                             const float* tscale, unsigned* colmax, int gw,
                                             int nw) {
  constexpr int C = D / 32;
  const int lane = threadIdx.x & 31;
  const int e_live = __ldg(a.rowptr + a.n);
  const int n_eb = a.e / a.block_e;
  for (int s0 = gw * kSpan; s0 < e_live; s0 += nw * kSpan) {
    const int s1 = min(s0 + kSpan, e_live);
    int blk = s0 / a.block_e;
    float mx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) mx[c] = 0.0f;
    for (int base = s0; base < s1; base += kChunk) {
      const int cnt = min(kChunk, s1 - base);
      float m[kChunk][C];
      chunk_messages<D, kI8, kCoherent>(a, t, base, cnt, table, tscale, wqt, stage, m);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i >= cnt) break;
        const int b = (base + i) / a.block_e;
        if (b != blk) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            atomicMax(colmax + ((size_t)t * n_eb + blk) * D + c * 32 + lane,
                      __float_as_uint(mx[c]));
            mx[c] = 0.0f;
          }
          blk = b;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) mx[c] = fmaxf(mx[c], fabsf(m[i][c]));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      atomicMax(colmax + ((size_t)t * n_eb + blk) * D + c * 32 + lane, __float_as_uint(mx[c]));
  }
}

// mxu: the aggregate of type t for this warp's nodes v0 .. v0 + 7 into
// its rows of `as` (a = acc_t at t == 0, a + acc_t after), walking their
// edges in order (see the note at the top); `stage` is the warp's rows of
// ss, `wqt` Wq_t^T (int8).
template <int D, int P, bool kCoherent, class TableT>
__device__ __forceinline__ void mxu_aggregate(const StepArgs& a, int t, int v0,
                                              const TableT* table, const float* tscale,
                                              const unsigned* colmax, const int8_t* wqt,
                                              float* stage, float* as) {
  constexpr int C = D / 32;
  constexpr int RS = row_stride(D);
  const int lane = threadIdx.x & 31;
  const int n_eb = a.e / a.block_e;
  const int vend = min(v0 + kNodesPerWarp, a.n);
  float part[C], acc_t[C], ms[C];
  int isum[C];
  int r = 0, blk = -1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    part[c] = acc_t[c] = 0.0f;
    ms[c] = 1.0f;
    isum[c] = 0;
  }
  // close the open block partial into acc_t
  auto flush = [&]() {
    if (blk < 0) return;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (P == kI8) {
        acc_t[c] = __fadd_rn(acc_t[c], __fmul_rn(static_cast<float>(isum[c]), ms[c]));
        isum[c] = 0;
      } else {
        acc_t[c] = __fadd_rn(acc_t[c], part[c]);
        part[c] = 0.0f;
      }
    }
    blk = -1;
  };
  // node r's run is over: a (+)= acc_t
  auto finish = [&]() {
    flush();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      as[r * RS + j] = t == 0 ? acc_t[c] : __fadd_rn(as[r * RS + j], acc_t[c]);
      acc_t[c] = 0.0f;
    }
    ++r;
  };
  if (v0 < vend) {
    const int e_end = __ldg(a.rowptr + vend);
    int run_end = __ldg(a.rowptr + v0 + 1);
    for (int base = __ldg(a.rowptr + v0); base < e_end; base += kChunk) {
      const int cnt = min(kChunk, e_end - base);
      float m[kChunk][C];
      chunk_messages<D, P, kCoherent>(a, t, base, cnt, table, tscale, wqt, stage, m);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i >= cnt) break;
        const int e = base + i;
        while (e >= run_end) {
          finish();
          run_end = __ldg(a.rowptr + v0 + r + 1);
        }
        const int b = e / a.block_e;
        if (b != blk) {
          flush();
          blk = b;
          if constexpr (P == kI8) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              ms[c] = block_scale<D, kCoherent>(colmax, t, n_eb, b, c * 32 + lane);
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (P == kI8) {
            const float q = fminf(fmaxf(rintf(__fdiv_rn(m[i][c], ms[c])), -127.0f), 127.0f);
            isum[c] += static_cast<int>(q);
          } else {
            part[c] = __fadd_rn(part[c], m[i][c]);
          }
        }
      }
    }
  }
  while (r < kNodesPerWarp) finish();  // the rest (rows past n get 0)
}

// fold: this warp's sums of type t over its nodes v0 .. v0 + 7, in edge
// order: ss[r] = sum coef * row, cs[r] = sum w (rows past n get 0). The
// warp's runs are one range of edges; it loads their src and weights 32
// at a time and gathers 4 rows ahead of the FMAs, each node's chain in
// the order of its run.
template <int D, int P, bool kCoherent, class TableT>
__device__ __forceinline__ void fold_sums(const StepArgs& a, int t, int v0, const TableT* table,
                                          const float* tscale, float* ss, float* cs) {
  constexpr int C = D / 32;
  constexpr int RS = row_stride(D);
  const int lane = threadIdx.x & 31;
  const int vend = min(v0 + kNodesPerWarp, a.n);
  const float* wt = a.w2 + (size_t)t * a.e;
  float acc[C];
  float cw = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int r = 0;
  // node r's run is over
  auto finish = [&]() {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ss[r * RS + c * 32 + lane] = acc[c];
      acc[c] = 0.0f;
    }
    if (lane == 0) cs[r] = cw;
    cw = 0.0f;
    ++r;
  };
  if (v0 < vend) {
    // rowptr[v0 .. vend] in lanes 0 .. vend - v0
    const int rp_l = lane <= vend - v0 ? __ldg(a.rowptr + v0 + lane) : 0;
    const int e_end = __shfl_sync(0xffffffffu, rp_l, vend - v0);
    int run_end = __shfl_sync(0xffffffffu, rp_l, 1);
    for (int base = __shfl_sync(0xffffffffu, rp_l, 0); base < e_end; base += 32) {
      const int cnt = min(32, e_end - base);
      int u_l = 0;
      float w_l = 0.0f, cf_l = 0.0f;
      if (lane < cnt) {
        w_l = __ldg(wt + base + lane);
        u_l = __ldg(a.src + base + lane);
        cf_l = w_l;
        if constexpr (P == kI8) cf_l = __fmul_rn(w_l, load<kCoherent>(tscale + u_l));
      }
      for (int j0 = 0; j0 < cnt; j0 += 4) {
        float x[4][C];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int u = __shfl_sync(0xffffffffu, u_l, j0 + q);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            x[q][c] = 0.0f;
            if (j0 + q < cnt) {
              x[q][c] = to_float(load<kCoherent>(table + (size_t)u * D + c * 32 + lane));
              if constexpr (P == kBF16 && sizeof(TableT) == 4) x[q][c] = round_bf16(x[q][c]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w = __shfl_sync(0xffffffffu, w_l, j0 + q);
          const float cf = __shfl_sync(0xffffffffu, cf_l, j0 + q);
          if (j0 + q < cnt) {
            while (base + j0 + q >= run_end) {
              finish();
              run_end = __shfl_sync(0xffffffffu, rp_l, r + 1);
            }
            if (w != 0.0f) {
#pragma unroll
              for (int c = 0; c < C; ++c) acc[c] = fmaf(cf, x[q][c], acc[c]);
              cw = __fadd_rn(cw, w);
            }
          }
        }
      }
    }
  }
  while (r < kNodesPerWarp) finish();
}

// fold: ring unit u of Wm_t, the k rows (u % (D / KU)) * KU .. + KU of
// the PW columns from (u / (D / KU)) * PW, in W's type, into a ring stage
// of the hs plane
template <int D, int PW, int KU, class W>
__device__ __forceinline__ void stage_wm_unit(const W* wmt, int u, W* dst) {
  constexpr int kRowChunks = PW * (int)sizeof(W) / 16;
  const int k0 = u % (D / KU) * KU, j0 = u / (D / KU) * PW;
  for (int idx = threadIdx.x; idx < KU * kRowChunks; idx += kThreads) {
    const int k = idx / kRowChunks, m = idx % kRowChunks;
    cp_async16(reinterpret_cast<char*>(dst + k * PW) + 16 * m,
               reinterpret_cast<const char*>(wmt + (size_t)(k0 + k) * D + j0) + 16 * m, 16);
  }
  cp_async_commit();
}

// GRU: ring unit u (column panel u / (D / KP), k panel u % (D / KP)) of
// Wih and Whh, [2][KP][3 gates][kPanel] floats, into `dst`
template <int D>
__device__ __forceinline__ void stage_gru_unit(const StepArgs& a, int u, float* dst) {
  constexpr int KP = gru_kp(D);
  constexpr int kChunks = 2 * KP * 3 * (kPanel / 4);
  const int cp = u / (D / KP), k0 = (u % (D / KP)) * KP;
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int m = idx % (kPanel / 4), g = (idx / (kPanel / 4)) % 3;
    const int k = (idx / (3 * (kPanel / 4))) % KP, mat = idx / (KP * 3 * (kPanel / 4));
    const float* src = (mat ? a.whh : a.wih) + (size_t)(k0 + k) * 3 * D + g * D + cp * kPanel;
    cp_async16(dst + ((mat * KP + k) * 3 + g) * kPanel + 4 * m, src + 4 * m, 16);
  }
  cp_async_commit();
}

// One step for the 64 nodes of tile `tile`; every thread of the block
// calls it.
//   h_in    [n, D] f32 state (the GRU's h);
//   table   [n, D] message-side rows: TableT float (fp32; bf16 rounds
//           them here) or the policy's own type; tscale [n] row scales
//           (int8);
//   colmax  (int8 mxu) the pre-pass's max|msg| bits of this step;
//   h_out, a_out (nullable), chain (nullable: this step's input rows),
//   q_next/s_next (nullable, int8: quantize h' into the next table).
// Not inlined: compiled as a function of its own, the body keeps kernel
// 1's schedule inside kernel 2's step and tile loops. Inlined there, the
// body spills 588-688 bytes at d 128 and kernel 2 runs slower still; as
// a function it costs kernel 2 the saving of its loop state around the
// call (PERF.md, findings on kernel 2).
template <int D, int P, bool kMxu, bool kCoherent, class TableT>
__device__ __noinline__ void step_tile(const StepArgs a, float* smem, int tile,
                                       const float* h_in, const TableT* table,
                                       const float* tscale, const unsigned* colmax,
                                       float* h_out, float* a_out, float* chain,
                                       int8_t* q_next, float* s_next) {
  using W = typename Msg<P>::T;
  constexpr int C = D / 32;  // columns per lane
  constexpr int RS = row_stride(D);
  const int n = a.n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kNodesPerWarp;  // this warp's first tile row
  const int vb = tile * kTileNodes;       // the tile's first node
  const int v0 = vb + row0;               // this warp's first node
  float* hs = smem;
  float* ss = smem + kTileNodes * RS;
  float* as = ss + ss_floats(D);
  float* cs = as + kTileNodes * RS;

  __syncthreads();  // the block's previous tile is done with shared memory

  // 1. the aggregate into as
  if constexpr (kMxu) {
    // 1'. per-edge messages, summed per node within each edge block
    for (int t = 0; t < a.n_etypes; ++t) {
      const int8_t* wqt = nullptr;
      if constexpr (P == kI8) wqt = stage_wqt<D>(a, t, hs);
      mxu_aggregate<D, P, kCoherent>(a, t, v0, table, tscale, colmax, wqt, ss + row0 * RS,
                                     as + row0 * RS);
      __syncthreads();  // Wq_t and the stages are free again
    }
  } else {
    // the transform's column panels: 64 wide where d allows (a thread 4
    // nodes x 4 columns, a panel's k in two ring units), else 32 (2 x 4)
    constexpr int XPW = D % 64 == 0 ? 64 : 32;
    constexpr int XKU = XPW == 64 ? D / 2 : D;  // k rows a ring unit
    constexpr int NXK = D / XKU;                // ring units a panel
    constexpr int XU = D / XPW * NXK;           // ring units a type
    constexpr int XTX = XPW / 4, XTY = kThreads / XTX, XN = kTileNodes / XTY;
    constexpr int kStage = XKU * XPW;           // W elements of a ring stage
    const int xtx = threadIdx.x % XTX, xty = threadIdx.x / XTX;
    W* ring = reinterpret_cast<W*>(hs);
    for (int t = 0; t < a.n_etypes; ++t) {
      const W* wmt = static_cast<const W*>(a.wm) + (size_t)t * D * D;
      stage_wm_unit<D, XPW, XKU>(wmt, 0, ring);
      // sum each node's run in edge order, a warp its 8 nodes
      fold_sums<D, P, kCoherent>(a, t, v0, table, tscale, ss + row0 * RS, cs + row0);
      // ... then apply the policy's Wm_t (and ws_t) and c * bm_t once per
      // node, a panel of columns at a time; a accumulates over types
      const float* bmt = a.bm + (size_t)t * D;
      float acc[XN][4];
#pragma unroll 1
      for (int u = 0; u < XU; ++u) {
        cp_async_wait<0>();
        __syncthreads();  // unit u is in, the sums too; unit u - 1 is done with
        if (u + 1 < XU) stage_wm_unit<D, XPW, XKU>(wmt, u + 1, ring + ((u + 1) & 1) * kStage);
        if (u % NXK == 0) {
#pragma unroll
          for (int m = 0; m < XN; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
        }
        const int k0 = (u % NXK) * XKU;
        const W* wp = ring + (u & 1) * kStage + xtx * 4;
#pragma unroll 2
        for (int k = 0; k < XKU; k += 4) {
          float4 x[XN];
#pragma unroll
          for (int m = 0; m < XN; ++m)
            x[m] = *reinterpret_cast<const float4*>(ss + (xty + m * XTY) * RS + k0 + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float w[4];
            load_cols(wp + (k + kk) * XPW, w);
#pragma unroll
            for (int m = 0; m < XN; ++m) {
              const float xv = lane_of(x[m], kk);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
            }
          }
        }
        if (u % NXK != NXK - 1) continue;
        const int j0 = u / NXK * XPW + xtx * 4;
        float b[4], wsj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b[c] = __ldg(bmt + j0 + c);
          wsj[c] = P == kI8 ? __ldg(a.ws + (size_t)t * D + j0 + c) : 1.0f;
        }
#pragma unroll
        for (int m = 0; m < XN; ++m) {
          const int r = xty + m * XTY;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float mv = P == kI8 ? __fmul_rn(acc[m][c], wsj[c]) : acc[m][c];
            const float val = __fmaf_rn(cs[r], b[c], mv);
            float* dst = as + r * RS + j0 + c;
            *dst = t == 0 ? val : __fadd_rn(*dst, val);
          }
        }
      }
      __syncthreads();  // every unit is done with ss, cs and the ring
    }
  }

  // 2. the tile's h rows into hs, while the GRU's first weights load
  constexpr int KP = gru_kp(D);
  constexpr int NKP = D / KP;                 // k panels (ring units) a column panel
  constexpr int kUnit = 2 * KP * 3 * kPanel;  // floats of a ring stage
  float* ring = ss;
#pragma unroll
  for (int u = 0; u < kRing - 1; ++u) stage_gru_unit<D>(a, u, ring + u * kUnit);
  for (int r = 0; r < kNodesPerWarp; ++r) {
    const int v = v0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      const float x = v < n ? load<kCoherent>(h_in + (size_t)v * D + j) : 0.0f;
      hs[(row0 + r) * RS + j] = x;
      if (chain != nullptr && v < n) chain[(size_t)v * D + j] = x;
    }
  }

  // 3. GRU: threads 0..127 form gx = a @ Wih, threads 128..255 gh = h @ Whh,
  // each TN nodes x TC columns of a 32-column panel and its 3 gates; at the
  // panel's end the two halves trade half their nodes' gates through the
  // ring and each applies the gates of TN / 2 nodes
  constexpr int TC = kGruCols, GTX = kPanel / TC;
  constexpr int GTY = kThreads / 2 / GTX, TN = kTileNodes / GTY;
  const int mat = threadIdx.x / (kThreads / 2);  // 0: a @ Wih, 1: h @ Whh
  const int gt = threadIdx.x % (kThreads / 2);
  const int gcol = gt % GTX, grow = gt / GTX;     // columns gcol * TC.., nodes grow + GTY m
  const float* xs = mat ? hs : as;
  float acc[TN][3][TC];
#pragma unroll 1
  for (int cp = 0; cp < D / kPanel; ++cp) {
#pragma unroll
    for (int m = 0; m < TN; ++m)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[m][g][c] = 0.0f;
#pragma unroll 1
    for (int kp = 0; kp < NKP; ++kp) {
      cp_async_wait<kRing - 2>();
      __syncthreads();  // k panel kp is in (and h); kp - 1 is done with
      if (kp + kRing - 1 < NKP) {
        stage_gru_unit<D>(a, cp * NKP + kp + kRing - 1,
                          ring + ((kp + kRing - 1) % kRing) * kUnit);
      } else {
        cp_async_commit();  // an empty group keeps the count
      }
      const int k0 = kp * KP;
      const float* st = ring + (kp % kRing) * kUnit + mat * KP * 3 * kPanel + gcol * TC;
#pragma unroll
      for (int k = 0; k < KP; k += kGruK) {
        float x[TN][kGruK];
#pragma unroll
        for (int m = 0; m < TN; ++m) load_cols<kGruK>(xs + (grow + GTY * m) * RS + k0 + k, x[m]);
#pragma unroll
        for (int kk = 0; kk < kGruK; ++kk) {
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float w[TC];
            load_cols<TC>(st + ((k + kk) * 3 + g) * kPanel, w);
#pragma unroll
            for (int m = 0; m < TN; ++m) {
#pragma unroll
              for (int c = 0; c < TC; ++c) acc[m][g][c] = fmaf(x[m][kk], w[c], acc[m][g][c]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
    // the trade, [half][m'][gate][thread][TC] floats (kTrade): half 0 hands
    // over gx of its nodes m >= TN / 2, half 1 gh of m < TN / 2. A
    // half's accumulators are indexed by constants only (`kMat`), so they
    // stay in registers.
    float* xb = ss;
    auto trade = [&](auto kMat) {
      constexpr int M = decltype(kMat)::value;
#pragma unroll
      for (int m2 = 0; m2 < TN / 2; ++m2)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          store_cols<TC>(xb + (((M * (TN / 2) + m2) * 3 + g) * (kThreads / 2) + gt) * TC,
                         acc[M ? m2 : m2 + TN / 2][g]);
    };
    if (mat) {
      trade(std::integral_constant<int, 1>{});
    } else {
      trade(std::integral_constant<int, 0>{});
    }
    __syncthreads();
    float other[TN / 2][3][TC];
#pragma unroll
    for (int m2 = 0; m2 < TN / 2; ++m2)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        load_cols<TC>(xb + ((((1 - mat) * (TN / 2) + m2) * 3 + g) * (kThreads / 2) + gt) * TC,
                      other[m2][g]);
    __syncthreads();  // the trade is read: the next panel's weights may load
    if (cp + 1 < D / kPanel) {
#pragma unroll
      for (int u = 0; u < kRing - 1; ++u)
        stage_gru_unit<D>(a, (cp + 1) * NKP + u, ring + u * kUnit);
    }
    // the gates of nodes grow + GTY m, m in [M * TN / 2, (M + 1) * TN / 2)
    const int j0 = cp * kPanel + gcol * TC;
    auto gates = [&](auto kMat) {
      constexpr int M = decltype(kMat)::value;
      float bi[3][TC], bh[3][TC];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          bi[g][c] = __ldg(a.bih + g * D + j0 + c);
          bh[g][c] = __ldg(a.bhh + g * D + j0 + c);
        }
#pragma unroll
      for (int m2 = 0; m2 < TN / 2; ++m2) {
        constexpr int kOwn = M * (TN / 2);
        const int r = grow + GTY * (kOwn + m2);
        const int v = vb + r;
        if (v >= n) continue;
        float hv[TC], av[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          float gxv[3], ghv[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            gxv[g] = M ? other[m2][g][c] : acc[kOwn + m2][g][c];
            ghv[g] = M ? acc[kOwn + m2][g][c] : other[m2][g][c];
          }
          const float rg = sigmoid_f32(
              __fadd_rn(__fadd_rn(gxv[0], bi[0][c]), __fadd_rn(ghv[0], bh[0][c])));
          const float zg = sigmoid_f32(
              __fadd_rn(__fadd_rn(gxv[1], bi[1][c]), __fadd_rn(ghv[1], bh[1][c])));
          const float ng = tanhf(__fadd_rn(__fadd_rn(gxv[2], bi[2][c]),
                                           __fmul_rn(rg, __fadd_rn(ghv[2], bh[2][c]))));
          hv[c] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zg), ng),
                            __fmul_rn(zg, hs[r * RS + j0 + c]));
          av[c] = as[r * RS + j0 + c];
        }
        store_cols<TC>(h_out + (size_t)v * D + j0, hv);
        if (a_out != nullptr) store_cols<TC>(a_out + (size_t)v * D + j0, av);
      }
    };
    if (mat) {
      gates(std::integral_constant<int, 1>{});
    } else {
      gates(std::integral_constant<int, 0>{});
    }
  }
  cp_async_wait<0>();

  // int8 under kernel 2: quantize the rows just written for the next step
  if (q_next != nullptr) {
    __syncthreads();  // the block's h' rows are out
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      if (v >= n) break;
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = __ldcg(h_out + (size_t)v * D + c * 32 + lane);
      quant_row<C>(x, lane, q_next + (size_t)v * D, s_next + v);
    }
  }
}

// Kernel 1: one step, one tile per block.
template <int D, int P, bool kMxu>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
ggnn_step_kernel(StepArgs a, const float* __restrict__ h,
                 const typename Msg<P>::T* __restrict__ table, const float* __restrict__ tscale,
                 const unsigned* __restrict__ colmax, float* __restrict__ h_out,
                 float* __restrict__ a_out) {
  extern __shared__ float4 smem4[];
  step_tile<D, P, kMxu, false>(a, reinterpret_cast<float*>(smem4), blockIdx.x, h, table, tscale,
                               colmax, h_out, a_out, nullptr, nullptr, nullptr);
}

// The warp's staging rows inside a block's shared memory (its rows of ss).
__device__ __forceinline__ float* warp_stage(float* smem, int d) {
  return smem + (kTileNodes + (threadIdx.x >> 5) * kNodesPerWarp) * row_stride(d);
}

// Kernel 1's int8 mxu pre-pass: colmax from the quantized table; a block
// whose spans hold no live edge returns before staging Wq_t.
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
mxu_colmax_kernel(StepArgs a, const int8_t* __restrict__ table, const float* __restrict__ tscale,
                  unsigned* __restrict__ colmax) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if ((int)blockIdx.x * kWarps * kSpan >= __ldg(a.rowptr + a.n)) return;
  for (int t = 0; t < a.n_etypes; ++t) {
    const int8_t* wqt = stage_wqt<D>(a, t, smem);
    mxu_colmax_warp<D, false>(a, t, warp_stage(smem, D), wqt, table, tscale, colmax,
                              blockIdx.x * kWarps + (threadIdx.x >> 5), gridDim.x * kWarps);
    __syncthreads();
  }
}

// Kernel 1's message-side table under bf16 (bf16(h)) or int8 (q(h), s(h)):
// one warp per row.
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
msg_table_kernel(const float* __restrict__ h, typename Msg<P>::T* __restrict__ table,
                 float* __restrict__ tscale, int n) {
  constexpr int C = D / 32;
  const int lane = threadIdx.x & 31;
  const int v = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (v >= n) return;
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = __ldg(h + (size_t)v * D + c * 32 + lane);
  if constexpr (P == kBF16) {
#pragma unroll
    for (int c = 0; c < C; ++c) table[(size_t)v * D + c * 32 + lane] = __float2bfloat16_rn(x[c]);
  } else {
    quant_row<C>(x, lane, table + (size_t)v * D, tscale + v);
  }
}

struct FusedArgs {
  StepArgs step;
  unsigned* colmax;   // int8 mxu: [n_steps, n_etypes, e / block_e, D], zeroed
  const float* feat;  // [n, D] the initial state
  float* plane0;      // [n, D] h_out, written by the last step
  float* plane1;      // [n, D] scratch (n_steps > 1)
  float* chain;       // [n_steps, n, D] or null
  int8_t* q0;         // int8: [n, D] shadow tables and [n] scales,
  int8_t* q1;         //   step s reads q_{s % 2} and writes q_{(s+1) % 2}
  float* s0;
  float* s1;
  int n_steps;
};

// Kernel 2: every step; step s reads feat (s = 0) or the plane step s-1
// wrote and writes plane (n_steps - 1 - s) % 2, so the last step lands
// in plane0 = h_out.
template <int D, int P, bool kMxu>
__global__ void __launch_bounds__(kThreads, min_blocks(D)) ggnn_fused_kernel(FusedArgs f) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  constexpr int C = D / 32;
  const int n = f.step.n;
  const int n_tiles = (n + kTileNodes - 1) / kTileNodes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if constexpr (P == kI8) {  // q(feat) into table 0
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const int v = tile * kTileNodes + warp * kNodesPerWarp + r;
        if (v >= n) break;
        float x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] = __ldg(f.feat + (size_t)v * D + c * 32 + lane);
        quant_row<C>(x, lane, f.q0 + (size_t)v * D, f.s0 + v);
      }
    }
    grid.sync();
  }

  for (int s = 0; s < f.n_steps; ++s) {
    const float* h_in = s == 0 ? f.feat : (((f.n_steps - s) & 1) ? f.plane1 : f.plane0);
    float* h_out = ((f.n_steps - 1 - s) & 1) ? f.plane1 : f.plane0;
    float* chain = f.chain != nullptr ? f.chain + (size_t)s * n * D : nullptr;
    const bool last = s + 1 == f.n_steps;
    const bool odd = s & 1;
    unsigned* colmax = nullptr;
    if constexpr (kMxu && P == kI8) {
      // the step's pre-pass over every live edge, then a barrier
      colmax = f.colmax + (size_t)s * f.step.n_etypes * (f.step.e / f.step.block_e) * D;
      for (int t = 0; t < f.step.n_etypes; ++t) {
        const int8_t* wqt = stage_wqt<D>(f.step, t, smem);
        mxu_colmax_warp<D, true>(f.step, t, warp_stage(smem, D), wqt, odd ? f.q1 : f.q0,
                                 odd ? f.s1 : f.s0, colmax, blockIdx.x * kWarps + warp,
                                 gridDim.x * kWarps);
        __syncthreads();
      }
      grid.sync();
    }
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      if constexpr (P == kI8) {
        step_tile<D, P, kMxu, true>(f.step, smem, tile, h_in,
                                    static_cast<const int8_t*>(odd ? f.q1 : f.q0),
                                    odd ? f.s1 : f.s0, colmax, h_out, nullptr, chain,
                                    last ? nullptr : (odd ? f.q0 : f.q1),
                                    last ? nullptr : (odd ? f.s0 : f.s1));
      } else {
        step_tile<D, P, kMxu, true>(f.step, smem, tile, h_in, h_in, nullptr, nullptr, h_out,
                                    nullptr, chain, nullptr, nullptr);
      }
    }
    if (!last) grid.sync();
  }
}

template <int D, int P, bool kMxu>
cudaError_t launch_step(const StepArgs& a, const float* h, void* table, float* tscale,
                        unsigned* colmax, float* h_out, float* a_out, cudaStream_t stream) {
  using T = typename Msg<P>::T;
  const int grid = (a.n + kTileNodes - 1) / kTileNodes;
  if (grid == 0) return cudaSuccess;
  cudaError_t err;
  const int smem = smem_bytes(D);
  if constexpr (P != kF32) {
    // the message-side table from h (one warp a row)
    const int rows_per_block = kThreads / 32;
    msg_table_kernel<D, P><<<(a.n + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
        h, static_cast<T*>(table), tscale, a.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (kMxu && P == kI8) {
    // the pre-pass: one warp a span of live edges (at most e of them)
    const size_t bytes = (size_t)a.n_etypes * (a.e / a.block_e) * D * sizeof(unsigned);
    if ((err = cudaMemsetAsync(colmax, 0, bytes, stream)) != cudaSuccess) return err;
    if ((err = allow_smem(mxu_colmax_kernel<D>, smem)) != cudaSuccess) return err;
    const int spans = (a.e + kSpan - 1) / kSpan;
    if (spans > 0) {
      mxu_colmax_kernel<D><<<(spans + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
          a, static_cast<const int8_t*>(table), tscale, colmax);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if ((err = allow_smem(ggnn_step_kernel<D, P, kMxu>, smem)) != cudaSuccess) return err;
  ggnn_step_kernel<D, P, kMxu><<<grid, kThreads, smem, stream>>>(
      a, h, P == kF32 ? reinterpret_cast<const T*>(h) : static_cast<const T*>(table), tscale,
      colmax, h_out, a_out);
  return cudaGetLastError();
}

// blocks of kernel 2 an SM holds at once (its cooperative grid's share)
template <int D, int P, bool kMxu>
cudaError_t fused_blocks_per_sm(int* per_sm) {
  auto kernel = ggnn_fused_kernel<D, P, kMxu>;
  const cudaError_t err = allow_smem(kernel, smem_bytes(D));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem_bytes(D));
}

template <int D, int P, bool kMxu>
cudaError_t launch_fused(const FusedArgs& f, int grid_request, int* grid_used,
                         cudaStream_t stream) {
  *grid_used = 0;
  const int n_tiles = (f.step.n + kTileNodes - 1) / kTileNodes;
  if (n_tiles == 0 || f.n_steps == 0) return cudaSuccess;
  const int smem = smem_bytes(D);
  auto kernel = ggnn_fused_kernel<D, P, kMxu>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = fused_blocks_per_sm<D, P, kMxu>(&per_sm)) != cudaSuccess) return err;
  if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
  if constexpr (kMxu && P == kI8) {
    const size_t bytes =
        (size_t)f.n_steps * f.step.n_etypes * (f.step.e / f.step.block_e) * D * sizeof(unsigned);
    if ((err = cudaMemsetAsync(f.colmax, 0, bytes, stream)) != cudaSuccess) return err;
  }
  // a grid the card cannot hold at once is the card's to refuse
  const int grid = grid_request > 0 ? grid_request
                                    : (n_tiles < per_sm * sms ? n_tiles : per_sm * sms);
  FusedArgs args = f;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  *grid_used = grid;
  return cudaGetLastError();
}

// One instance per (policy, scatter); policy 0 fp32, 1 bf16, 2 int8,
// scatter 0 fold, 1 mxu.
template <int D, template <int, int, bool> class Launch, class... Args>
cudaError_t dispatch(int policy, int scatter, Args... args) {
  if (scatter != 0 && scatter != 1) return cudaErrorInvalidValue;
  const bool mxu = scatter == 1;
  switch (policy) {
    case kF32:
      return mxu ? Launch<D, kF32, true>::run(args...) : Launch<D, kF32, false>::run(args...);
    case kBF16:
      return mxu ? Launch<D, kBF16, true>::run(args...) : Launch<D, kBF16, false>::run(args...);
    case kI8:
      return mxu ? Launch<D, kI8, true>::run(args...) : Launch<D, kI8, false>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D, int P, bool kMxu>
struct StepLaunch {
  template <class... Args>
  static cudaError_t run(Args... args) { return launch_step<D, P, kMxu>(args...); }
};

template <int D, int P, bool kMxu>
struct FusedLaunch {
  template <class... Args>
  static cudaError_t run(Args... args) { return launch_fused<D, P, kMxu>(args...); }
};

template <int D, int P, bool kMxu>
struct FusedBlocks {
  template <class... Args>
  static cudaError_t run(Args... args) { return fused_blocks_per_sm<D, P, kMxu>(args...); }
};

}  // namespace

#define GGNN_WIDTHS(X) X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256) X(288)

extern "C" {

// Nodes per tile (per block of kernel 1); the wrapper reads it.
int ggnn_step_tile_nodes() { return kTileNodes; }

// Dynamic shared memory of one block of either kernel at width d, in bytes.
int ggnn_step_smem_bytes(int d) { return smem_bytes(d); }

// Kernel 1: one step under `policy` (0 fp32, 1 bf16, 2 int8) and
// `scatter` (0 fold, 1 mxu). Device pointers; shapes: h, h_out, a_out
// [n, d] f32 (a_out may be null); src [e] int32; w2 [n_etypes, e] f32;
// rowptr [n + 1] int32 over the live prefix (rowptr[n] = live edge
// count); wm [n_etypes, d, d] f32 (fp32), bf16 (bf16) or int8 (int8), [in,
// out], except under int8 mxu: int8 [n_etypes, d (out), d (in)]; ws
// [n_etypes, d] f32 (int8, else null); bm [n_etypes, d]; wih, whh [d,
// 3d]; bih, bhh [3d]. wm, wih and whh start 16-byte aligned. bf16 and
// int8 also take table, [n, d] of the policy's type, and int8 tscale [n]
// f32, which the launch fills from h before the step reads them. mxu
// takes block_e (dividing e); int8 mxu also colmax, [n_etypes, e /
// block_e, d] uint32, which the launch zeroes and fills. Returns a
// cudaError_t as int.
int ggnn_step(int policy, int scatter, const float* h, void* table, float* tscale,
              const int* src, const float* w2, const int* rowptr, const void* wm,
              const float* ws, const float* bm, const float* wih, const float* whh,
              const float* bih, const float* bhh, float* h_out, float* a_out,
              unsigned* colmax, int n, int e, int d, int n_etypes, int block_e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scatter == 1 && (block_e <= 0 || e % block_e != 0)) return (int)cudaErrorInvalidValue;
  const StepArgs a{src, w2, rowptr, wm, ws, bm, wih, whh, bih, bhh, n, e, n_etypes,
                   block_e > 0 ? block_e : 1};
#define GGNN_CASE(DD)                                                                    \
  case DD:                                                                               \
    return (int)dispatch<DD, StepLaunch>(policy, scatter, a, h, table, tscale, colmax,   \
                                         h_out, a_out, s);
  switch (d) {
    GGNN_WIDTHS(GGNN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GGNN_CASE
}

// Kernel 2: n_steps >= 1 steps under `policy` and `scatter` in one
// cooperative launch. Operands as ggnn_step, plus feat [n, d] f32 (the
// initial state, read only), h_out [n, d], scratch [n, d] (null when
// n_steps == 1), chain [n_steps, n, d] or null, for int8 the shadow
// tables q0, q1 [n, d] int8 and their scales s0, s1 [n] (q1, s1 null
// when n_steps == 1), and for int8 mxu colmax [n_steps, n_etypes, e /
// block_e, d] uint32, which the launch zeroes. grid_request 0 launches as
// many blocks as the card holds at once (at most one per tile); a larger
// request is refused by the card. *grid_used receives the grid launched.
// Returns a cudaError_t as int.
int ggnn_fused(int policy, int scatter, const float* feat, const int* src, const float* w2,
               const int* rowptr, const void* wm, const float* ws, const float* bm,
               const float* wih, const float* whh, const float* bih, const float* bhh,
               float* h_out, float* scratch, float* chain, int8_t* q0, int8_t* q1, float* s0,
               float* s1, unsigned* colmax, int n, int e, int d, int n_etypes, int block_e,
               int n_steps, int grid_request, int* grid_used, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scatter == 1 && (block_e <= 0 || e % block_e != 0)) return (int)cudaErrorInvalidValue;
  const FusedArgs f{{src, w2, rowptr, wm, ws, bm, wih, whh, bih, bhh, n, e, n_etypes,
                     block_e > 0 ? block_e : 1},
                    colmax, feat, h_out, scratch, chain, q0, q1, s0, s1, n_steps};
#define GGNN_CASE(DD)                                                                       \
  case DD:                                                                                  \
    return (int)dispatch<DD, FusedLaunch>(policy, scatter, f, grid_request, grid_used, s);
  switch (d) {
    GGNN_WIDTHS(GGNN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GGNN_CASE
}

// Blocks of kernel 2 under `policy` and `scatter` at width d that one SM
// holds at once (its cooperative grid is that times the SM count, at
// most one block a tile) into *per_sm. Returns a cudaError_t as int.
int ggnn_fused_blocks_per_sm(int policy, int scatter, int d, int* per_sm) {
#define GGNN_CASE(DD) \
  case DD:            \
    return (int)dispatch<DD, FusedBlocks>(policy, scatter, per_sm);
  switch (d) {
    GGNN_WIDTHS(GGNN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GGNN_CASE
}

const char* ggnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
