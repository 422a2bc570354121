// Flash attention for NVIDIA Hopper (sm_90a): the forward with in-kernel
// dropout and an additive score bias, and the three backward kernels dq,
// dk/dv and dbias. bf16 on tensor cores (mma.sync), fp32 in IEEE FMA
// loops.
//
// Replaces the TPU kernels of deepdfa_tpu/nn/flash_attention.py:
//   flash_fwd   -> _fwd_kernel   (launched by _fwd_call)
//   flash_dq    -> _dq_kernel    (the first pallas_call of _bwd_call)
//   flash_dkv   -> _dkv_kernel   (the second pallas_call of _bwd_call)
//   flash_dbias -> _dbias_kernel (the third pallas_call of _bwd_call)
// with their causal option (_block_ok, _block_dead). For q [B, H, Tq, D],
// k, v [B, H, Tk, D], a kv mask [B, Tk] and an optional bias [H, Tq, Tk]
// (T5's relative-position bias, broadcast over the batch) the forward
// computes, per (b, h, query row i),
//
//   s_j = q_i . k_j * scale + bias[h, i, j]   where live(i, j), else -1e30
//
// where live(i, j) = mask[b, j], and with causal also j <= i (Tq == Tk,
// global positions: T5's decoder self-attention),
//   m   = max_j s_j,   p_j = exp(s_j - m) where live(i, j), else 0
//   l   = sum_j p_j                                     (fp32, undropped)
//   o_i = (sum_j round(d_j p_j) * v_j) / max(l, FLT_MIN)    (fp32 sums)
//   lse_i = m + log(max(l, FLT_MIN))                    (fp32)
//
// where round() casts to the input dtype before the product, as the
// reference does (`pv.astype(v_blk.dtype)`), and d_j is the dropout
// factor: keep_j / keep_prob, or 1 without dropout. The bias (bf16 or
// fp32) is added unscaled in fp32 (the reference's `_scores`). Dropout
// scales the numerator only; the softmax denominator stays undropped
// (`_fwd_kernel` :199-208). An all-padding row has l = 0 and gets o = 0
// and a finite lse (-1e30), never NaN.
//
// The backward (`_dq_kernel`, `_dkv_kernel`, `_dbias_kernel`), from the
// forward's lse and delta_i = rowsum(do_i * o_i) (fp32, computed by the
// wrapper as the reference computes it outside any kernel):
//
//   p_ij  = exp(s_ij - lse_i) where live(i, j), else 0   (masked FIRST:
//           an all-padding row has lse = -1e30, and exp(s - lse) would
//           be exp(0) = 1 at a masked score of -1e30)
//   dp_ij = d_ij * (do_i . v_j)
//   ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j
//   dk_j  = scale * sum_i round(ds_ij) q_i
//   dv_j  =         sum_i round(d_ij p_ij) do_i
//   dbias[h, i, j] = sum_b ds_bhij                      (fp32, unscaled)
//
// Dropout bits. Each element's bits are a pure function of (seed, b, h,
// row, col): Philox4x32-10 keyed by the 64-bit seed (lo, hi) with the
// counter (col / 4, row, b*H + h, 0), whose four output words are the
// columns 4c .. 4c+3. keep = bits < threshold, threshold = min(round(
// keep_prob * 2^32), 2^32 - 1) (the reference's _Params.keep_threshold).
// So the forward, the three backward kernels and the plain version
// (nn/flash_attention.py:dropout_bits) draw the same mask, whatever each
// one's tiling, without storing it. The reference seeds the TPU PRNG per
// 512 x 512 block instead; its bits cannot be reproduced here, and the
// tests hold the math through explicit bits (debug_bits) instead.
//
// Design. The TPU kernels held a (b, h)'s whole k/v (or q/do) strip in
// VMEM and looped inside one program. Here blocks run in parallel with
// 227 KB of shared memory each:
//  - forward: one block per (b*h, q-tile) streams k/v through shared
//    memory in 64-key tiles with the FlashAttention-2 online softmax
//    (running max and sum in fp32 registers, the accumulator rescaled by
//    exp(m_old - m_new) when the max grows). Both instances stage key
//    tile k+1 (k, v, the kv mask and the bias tile) through cp.async into
//    a two-stage ring while tile k computes;
//  - dq: one block per (b*h, 64-row q-tile) loops over the k/v tiles,
//    recomputing s and p from lse; dq stays in registers. On tensor
//    cores the k/v tile k+1 (with the kv mask and the bias tile) comes in
//    through a two-stage cp.async ring while tile k computes;
//  - dk/dv: one block per (b*h, 64-key k-tile) loops over the q tiles
//    (q, do, lse and delta, on tensor cores also the bias tile, staged in
//    shared memory, the next tile's in flight while this one computes);
//    each warp owns 16 keys (tensor cores) or each thread 4 (FMA), so dk
//    and dv stay in registers;
//  - dbias: one block per (h, q tile, key tile, slice of the batch) loops
//    over its batch rows IN ORDER, recomputing s, p and dp for each b and
//    summing ds in the S-shaped fp32 accumulator, then writes its tile
//    once. The reference zeroes its output at b == 0 and accumulates
//    across grid steps, which is right only because the TPU grid runs in
//    order; GPU blocks run concurrently, so the batch loop lives inside
//    the block. Where a head has few tiles the batch is cut into slices
//    whose partials a second launch sums in slice order, to fill the
//    card.
// No float atomics anywhere (the usual FA2 backward sums dq with atomics):
// the same inputs on the same card give the same bits.
//
// Causal. kCausal is a template argument of every kernel, as kBias is, so
// the non-causal instances carry none of its code. The source builds twice
// (nn/cuda_build.py): FLASH_CAUSAL=0 gives the non-causal instances,
// FLASH_CAUSAL=1 the causal ones, in two libraries that nvcc compiles in
// parallel. Tiles wholly above the diagonal are skipped by loop bound, not
// by predicate: the k loop of a forward or dq block whose q tile starts at
// row r ends at min(Tk, r + rows); the q loop of a dk/dv block whose k tile
// starts at key c starts at the q tile holding row c. Only a tile that
// crosses the diagonal applies the per-element j <= i mask: the
// tensor-core forward runs that tile through its own instance of the tile
// body (a generic lambda on kMasked), so every other tile runs the
// non-causal code; the FMA forward, dq, dk/dv and dbias test a per-tile
// flag instead (the split instance took dq from 166 to 184 registers, 3
// blocks an SM to 2, and was slower). Both forwards hand out their q tiles
// from the last one down, so that the blocks with the most key tiles
// start first and the short ones fill the tail. A dbias block whose tile
// lies wholly above the diagonal writes zeros and returns, so every
// element of dbias is written once. The reference's blocks are min(512,
// T), so at T <= 512 it skips nothing; 64 x 64 tiles here skip (n - 1) n
// / 2 of n^2 tile pairs, n = T / 64.
//
// The bias. The tensor-core forward and dq stage each [rows, 64] bias
// tile through their cp.async ring with k and v, dk/dv each [64 queries,
// keys] tile with q and do (read transposed from shared memory), and all
// three read its fragments there; the FMA forward stages it the same way.
// The FMA dq and dk/dv read their elements from device memory four at a
// time (bias4); both dbias instances stage their tile once, before their
// batch loop: the [H, Tq, Tk] bias is shared by the B blocks of a head and
// stays in the 50 MB L2 across them (6.3 MB in bf16 at H 12, T 512).
//
//  - bf16, D a multiple of 16 (<= 128): warps of 16 rows (the
//    non-causal forward at D <= 64: 32, two m16 tiles sharing each k/v
//    fragment load, 128 rows a block). mma.sync m16n8k16 bf16 products
//    with fp32 accumulators. The S, dP accumulators
//    are reused as A fragments of the next product after their bf16
//    rounding (the reference's rounding points); the operand whose
//    k-dimension runs along the rows of a row-major tile (V in P.V, K in
//    dS.K, dO in P^T.dO, Q in dS^T.Q) comes through ldmatrix.trans. Shared
//    rows are padded by 8 elements so fragment loads hit 32 distinct banks.
//    Bound of the forward at the flagship call (B 16, H 12, T 512, D 64,
//    every key live): 12.9 GFLOP, 0.013 ms at 989 TFLOP/s, on ~50 MB,
//    0.015 ms at 3.35 TB/s (56.6 MB and 0.017 ms with a bf16 bias): bytes
//    bind, and the tensor cores idle while a tile's loads wait. So the
//    forward keeps the next tile's copies in flight (two stages in
//    dynamic shared memory), feeds the products through ldmatrix.x4 (two
//    n8 tiles a load), reads the bias from the staged tile, and makes one
//    Philox call a lane per n8 tile: the quad's four calls cover its two
//    rows x two 4-column groups, and each lane hands its 4 keep bits to
//    the quad by shuffle. Its exponentials are ex2.approx.ftz of a
//    log2(e)-scaled score (expf was ~8 instructions an element and held
//    the plain call): relative error ~2^-22, and a p below 2^-126 is
//    flushed to 0. The tensor-core dq, dk/dv and dbias recompute p with
//    the same instruction from lse log2(e) (bwd_p, one expression, so the
//    three sum the same p); the FMA kernels keep expf.
//  - fp32 (and bf16 at other widths), forward, dq and dk/dv:
//    register-tiled FMA kernels. 256 threads over a 64 x 64 score tile
//    each own a 4 x 4 micro-tile of S (and dP), so per 4 columns of a
//    product 8 LDS.128 feed 64 FMAs. (The first versions scored one key a
//    lane, and about one shared load fed each FMA: shared memory, not the
//    FMA units, set the pace, at 8-12% of the fp32 peak.) The k/v
//    (forward, dq) or q/do (dk/dv) tiles come in through 16-byte cp.async
//    into a two-stage ring while the tile before computes (4-byte copies
//    where a row is not 16-byte aligned; bf16 through registers). At D <=
//    64, ~113 KB of shared memory and 128 registers a thread give two
//    blocks an SM (the forward's p tile is written over the bias tile it
//    came from to fit); at D <= 128 one. Bound at the generation path's
//    calls (B 16, H 12, D 64, fp32, every key live): the encoder's T 256
//    forward 3.2 GFLOP (0.048 ms at 67 TFLOP/s), dq 4.8 GFLOP (0.072 ms),
//    dk/dv 6.4 GFLOP (0.096 ms); cross-attention 128 x 256 0.024, 0.036
//    and 0.048 ms; the causal decoder's T 128 is bound by bytes (forward
//    0.0078, dq 0.0097 and dk/dv 0.0121 ms). Plain fp32 FMA, no TF32 (the
//    generation path's fp32 contract), d and k ascending in every sum.
//  - fp32 (and bf16 at other widths), dbias: the same 4 x 4 score
//    micro-tile a thread over 64 keys x 64 rows, q, do, k and v through
//    a two-stage cp.async ring in 64-column chunks of D (S's, then dP's),
//    the batch cut into slices (its note, at flash_dbias_scalar, has the
//    rest). Bound: 3.2 GFLOP (0.048 ms) at the encoder call; 0.008 ms of
//    bytes at the decoder's.
//
// Bound of the backward at the flagship training call: dq does 3
// products (19.3 GFLOP, 0.0195 ms) on ~64 MB (0.019 ms); dk/dv 4 (25.8
// GFLOP, 0.026 ms) on ~76 MB (0.023 ms); dbias 2 (12.9 GFLOP) on ~70 MB
// with its fp32 output (0.021 ms: bytes bind). The operations bind, and
// on tensor cores the products are the smaller part: each score also
// costs an exponential, the masks, ds and, under dropout, a quarter of a
// Philox4x32-10 call (12.6 M calls a launch). So the tensor-core dq and
// dk/dv keep the next tile's copies in flight, feed every product through
// ldmatrix.x4, score a tile in 32-column parts (half the S and dP
// accumulators live, for more warps an SM), issue a part's Philox calls
// before its elementwise work, so that their chains overlap, and use
// every word of each call (lanes trade them by shuffle). The tensor-core
// dbias does the same with its batch loop: batch row b+1's tiles in
// flight while row b computes. Its blocks re-read every q/do tile once a
// key tile and every k/v tile once a q tile (at the T5 call ~403 MB of
// L2 reads a launch with 64 x 64 tiles against 50 MB of operands), yet
// 128-row or 128-key blocks, a third fewer reads, ran slower than 64 x 64
// ones with twice the warps: latency, not L2 bandwidth, binds it
// (DbiasMmaLayout).
//
// The wrappers (nn/flash_attention.py) pass each operand's (batch, head,
// token) strides and the bias's (head, row) strides; the innermost
// dimension is contiguous. o, dq, dk and dv are written through their
// strides (the wrapper makes them [B, T, H, D] buffers); lse and delta
// are contiguous [B, H, Tq] fp32, dbias contiguous [H, Tq, Tk] fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cuda_common.cuh"

namespace {

constexpr float kNegBig = -1e30f;              // the reference's _NEG_BIG
constexpr float kTiny = 1.17549435082228751e-38f;  // jnp.finfo(float32).tiny
constexpr int kMaxD = 128;

constexpr int kMmaKeys = 64;  // keys (fwd, dq) or queries (dk/dv) per tile


struct Strides {
  long long b, h, t;
};

// Dropout: on/off, the keep threshold on uint32 bits, 1/keep_prob and the
// Philox key (the 64-bit seed).
struct Drop {
  int on;
  uint32_t threshold;
  float inv_keep;
  uint32_t key0, key1;
};

// The additive score bias [H, Tq, Tk] (p == nullptr: none), bf16 or
// fp32, with its head and row strides; the last dimension is contiguous.
struct Bias {
  const void* p;
  int bf16;
  int vec;    // every row start is 16-byte (fp32) or 8-byte (bf16) aligned
  int vec16;  // every row start is 16-byte aligned
  long long sh, st;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // [B, Tk], nonzero = a real key
  void* o;
  float* lse;  // [B, H, Tq] contiguous
  int B, H, Tq, Tk, D;
  int vec;  // the FMA forward: fp32 q, k and v rows all start 16-byte aligned
  int n16;  // the FMA forward: D rounded up to 16, in 16-column groups
  float scale;
  Drop drop;
  Bias bias;
  Strides sq, sk, sv, so;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;     // [B, Tk]
  const float* lse;    // [B, H, Tq] contiguous
  const float* delta;  // [B, H, Tq] contiguous
  const void* dout;    // do
  void* dq;
  void* dk;
  void* dv;
  float* dbias;  // [H, Tq, Tk] contiguous
  int B, H, Tq, Tk, D;
  int vec;  // fp32 q, k, v and do rows all start 16-byte aligned
  int n16;  // the FMA dq and dk/dv: D rounded up to 16, in 16-column groups
  float scale;
  Drop drop;
  Bias bias;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype()
}

// x rounded to T and back: the reference's astype() before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// bias[h, row, col] in fp32; the caller reads only live (row, col)
__device__ __forceinline__ float bias_at(const Bias& bi, int h, int row, int col) {
  const long long off = (long long)h * bi.sh + (long long)row * bi.st + col;
  return bi.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bi.p)[off])
                 : static_cast<const float*>(bi.p)[off];
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al., Random123), one call per 4 columns

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// the four words of columns 4*(col/4) .. +3 of row `row` of head bh
__device__ __forceinline__ uint4 bits4(const Drop& d, int bh, int row, int col) {
  return philox4x32_10(make_uint4((uint32_t)col >> 2, (uint32_t)row, (uint32_t)bh, 0u), d.key0,
                       d.key1);
}

// the bits of one element (bh, row, col)
__device__ __forceinline__ uint32_t bits1(const Drop& d, int bh, int row, int col) {
  return word(bits4(d, bh, row, col), col & 3);
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: shared helpers

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows r0, r1 (= r0 + 8) of the [16, D] accumulators acc times `mul`,
// as bf16 through the strided pointer
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&acc)[NO][4],
                                           int r0, int r1, int rows, long long stride, float mul,
                                           int t) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(base + r0 * stride + c) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (r1 < rows)
      *reinterpret_cast<__nv_bfloat162*>(base + r1 * stride + c) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward, bf16 on tensor cores: one block per (b*h, ROWS-row q tile),
// a warp per 16 (or 32) rows; the q tile is staged once, and k, v, the kv
// mask and the bias tile of key tile k+1 come in through cp.async into a
// two-stage ring while tile k's products run

// The tile layout of the tensor-core forward: query rows a block (64 or
// 128) and a warp (16 or 32: one or two m16 tiles, which share each k/v
// fragment load). 128 x 32 for the non-causal build at D <= 64, else
// 64 x 16: the faster at the flagship calls, weighted by the main paths'
// launches (PERF.md, PR 10).
template <int D, bool kCausal>
struct FwdMmaLayout {
  static constexpr bool kWide = D <= 64 && !kCausal;
  static constexpr int kRows = kWide ? 128 : 64;
  static constexpr int kWarpRows = kWide ? 32 : 16;
};

// a staged bias row: the tile's 64 keys and 8 elements of padding, so the
// fragment reads of a warp's 8 rows hit distinct banks
constexpr int kBiasRow = kMmaKeys + 8;

// [stage][k, v][64][D + 8] bf16
template <int D>
__host__ __device__ constexpr int fwd_kv_bytes() {
  return 2 * 2 * kMmaKeys * (D + 8) * 2;
}

// one stage of a staged bias tile: [rows][cols + 8] in the bias's dtype
// (stage_bias_raw), by default [rows][kBiasRow]
__host__ __device__ constexpr int bias_stage_bytes(int rows, int bf16, int cols = kMmaKeys) {
  return rows * (cols + 8) * (bf16 ? 2 : 4);
}

// S += Q K^T for the 64 keys of a [64][KS] shared k tile and the warp's MT
// m16 tiles, whose q rows start at `q_rows` of a [.][KS] shared tile: per
// k-step, ldmatrix.x4 hands each lane the A fragment of an m16 tile, or
// the B fragments of two n8 tiles, used by every m16 tile
template <int MT, int NJ, int NK, int KS>
__device__ __forceinline__ void mma_qk(float (&acc)[MT][NJ][4], const __nv_bfloat16* q_rows,
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const __nv_bfloat16* p = q_rows + (16 * m + (lane & 15)) * KS + kk * 16 + (lane >> 4) * 8;
      const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[m][0]), "=r"(a[m][1]), "=r"(a[m][2]), "=r"(a[m][3])
                   : "r"(addr)
                   : "memory");
    }
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      const __nv_bfloat16* p =
          tile + ((2 * jj + (lane >> 4)) * 8 + (lane & 7)) * KS + kk * 16 + ((lane >> 3) & 1) * 8;
      const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
      uint32_t b0, b1, b2, b3;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                   : "r"(addr)
                   : "memory");
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * jj], a[m], b0, b1);
        mma_bf16(acc[m][2 * jj + 1], a[m], b2, b3);
      }
    }
  }
}

// O += round(P) V for the warp's MT m16 tiles: the S accumulators of
// n-tiles 2kk, 2kk+1, rounded to bf16, are the A fragment of k-step kk;
// ldmatrix.x4.trans hands each lane the B fragments of two n8 column
// tiles of the [64][KS] v tile at once
template <int MT, int NJ, int NO, int KS>
__device__ __forceinline__ void mma_pv(float (&acc)[MT][NO][4], const float (&x)[MT][NJ][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t xa[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xa[m][0] = pack_bf16(x[m][2 * kk][0], x[m][2 * kk][1]);
      xa[m][1] = pack_bf16(x[m][2 * kk][2], x[m][2 * kk][3]);
      xa[m][2] = pack_bf16(x[m][2 * kk + 1][0], x[m][2 * kk + 1][1]);
      xa[m][3] = pack_bf16(x[m][2 * kk + 1][2], x[m][2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      const __nv_bfloat16* p = tile + (kk * 16 + (lane & 15)) * KS + (n + (lane >> 4)) * 8;
      const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
      uint32_t b0, b1, b2, b3;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                   : "r"(addr)
                   : "memory");
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][n], xa[m], b0, b1);
        mma_bf16(acc[m][n + 1], xa[m], b2, b3);
      }
    }
  }
}

// rows [row0, row0 + R) of a strided [rows, D] bf16 operand (16-byte
// aligned rows) into a shared tile of row stride KS through 16-byte
// cp.async; zeros past `rows`. The caller commits.
template <int R, int D, int KS, int NT>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                        int rows, long long stride, int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < R * CH; idx += NT) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * KS + c, in ? static_cast<const void*>(src + (row0 + r) * stride + c) : src,
               in ? 16 : 0);
  }
}

// bias[h, r0 .. r0+ROWS-1, k0 .. k0+COLS-1] into a [ROWS][COLS + 8]
// shared tile in the bias's own dtype (ES bytes an element: 2 bf16, 4
// fp32), zeros past Tq and Tk: 16-byte cp.async where every bias row
// starts 16-byte aligned (the caller commits), else element by element
// through registers
template <int ROWS, int NT, int ES, int COLS = kMmaKeys>
__device__ __forceinline__ void stage_bias_raw(unsigned char* dst, const Bias& bi, int h, int r0,
                                               int k0, int Tq, int Tk, int tid) {
  constexpr int RS = COLS + 8;  // a staged row, in elements
  const unsigned char* src =
      static_cast<const unsigned char*>(bi.p) + ((long long)h * bi.sh + k0) * ES;
  if (bi.vec16) {
    constexpr int per = 16 / ES;    // elements a chunk
    constexpr int ch = COLS / per;  // chunks a row
    for (int idx = tid; idx < ROWS * ch; idx += NT) {
      const int r = idx / ch, c = idx - r * ch;
      const int n = r0 + r < Tq ? min(per, max(0, Tk - k0 - c * per)) : 0;
      cp_async16(dst + (r * RS + c * per) * ES,
                 n ? static_cast<const void*>(src + ((long long)(r0 + r) * bi.st + c * per) * ES)
                   : src,
                 n * ES);
    }
    return;
  }
  for (int idx = tid; idx < ROWS * COLS; idx += NT) {
    const int r = idx / COLS, c = idx - r * COLS;
    const bool in = r0 + r < Tq && k0 + c < Tk;
    const long long off = (long long)(r0 + r) * bi.st + c;
    if (ES == 2)
      reinterpret_cast<uint16_t*>(dst)[r * RS + c] =
          in ? reinterpret_cast<const uint16_t*>(src)[off] : (uint16_t)0;
    else
      reinterpret_cast<float*>(dst)[r * RS + c] =
          in ? reinterpret_cast<const float*>(src)[off] : 0.0f;
  }
}

// the staged bias of (tile row r, columns col, col + 1), ES bytes an element
template <int ES, int COLS = kMmaKeys>
__device__ __forceinline__ float2 bias_pair(const unsigned char* tile, int r, int col) {
  constexpr int RS = COLS + 8;
  if (ES == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(tile + (r * RS + col) * 2);
    return make_float2(__low2float(v), __high2float(v));
  }
  return *reinterpret_cast<const float2*>(tile + (r * RS + col) * 4);
}

// the staged bias of (tile row r, column c)
template <int ES, int COLS>
__device__ __forceinline__ float bias_one(const unsigned char* tile, int r, int c) {
  constexpr int RS = COLS + 8;
  if (ES == 2) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(tile)[r * RS + c]);
  return reinterpret_cast<const float*>(tile)[r * RS + c];
}

// 2^x on the special-function unit (one instruction; tiny results flush
// to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The backward's p = exp(s scale + bias - lse) (masking is the caller's)
// as 2^((s scale + bias) log2 e - lse log2 e), nl = -lse log2 e. With
// kBias, sc is the scale: dq, dk/dv and dbias evaluate this one
// expression, so they sum the same p. Without, sc is scale log2 e and
// the bias is not read: one FMA and ex2.
template <bool kBias>
__device__ __forceinline__ float bwd_p(float s, float sc, float bias, float nl) {
  if (kBias) return ex2(fmaf(fmaf(s, sc, bias), kLog2e, nl));
  return ex2(fmaf(s, sc, nl));
}

// [rows][D + 8] bf16: the q tile of the tensor-core forward
template <int D>
__host__ __device__ constexpr int fwd_q_bytes(int rows) {
  return rows * (D + 8) * 2;
}

// dynamic shared memory of the tensor-core forward: the k/v ring, the q
// tile, the mask ring, and with a bias its two stages
template <int D>
int fwd_mma_smem_bytes(int rows, const Bias& bi) {
  return fwd_kv_bytes<D>() + fwd_q_bytes<D>(rows) + 2 * kMmaKeys * 4 +
         (bi.p ? 2 * bias_stage_bytes(rows, bi.bf16) : 0);
}

// BIAS: the bytes of a bias element, 2 (bf16) or 4 (fp32), or 0 for the
// unbiased instance, which carries none of its code, so the bias costs the
// RoBERTa path no registers or instructions (kBias in dq and dk/dv). At D
// <= 64 and 16 rows a warp the unbiased instance is held to 128 registers,
// for 16 warps an SM; the biased ones are held to three blocks by shared
// memory.
template <int D, int ROWS, int WR, int BIAS, bool kCausal>
__global__ void __launch_bounds__(ROWS / WR * 32,
                                  (D <= 64 && WR == 16 && !BIAS) ? 512 / (ROWS / WR * 32) : 1)
    flash_fwd_bf16_mma(Args a) {
  constexpr bool kBias = BIAS != 0;
  constexpr int NT = ROWS / WR * 32;  // a warp per WR rows
  constexpr int MT = WR / 16;  // m16 tiles a warp
  constexpr int KS = D + 8;     // padded shared row, in elements
  constexpr int NJ = kMmaKeys / 8;  // n8 tiles of S
  constexpr int NK = D / 16;  // k16 steps of Q K^T
  constexpr int NO = D / 8;  // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][k, v][64][KS]
  __nv_bfloat16* q_s = kv_s + 4 * kMmaKeys * KS;                  // [ROWS][KS]
  int* ok_s = reinterpret_cast<int*>(q_s + ROWS * KS);            // [stage][64]
  // [stage][ROWS][kBiasRow] in the bias's dtype
  unsigned char* bias_s = reinterpret_cast<unsigned char*>(ok_s + 2 * kMmaKeys);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  // causal: the q tiles from the last one down, so that the longest
  // blocks of every head start first
  const int q_start = (kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * ROWS;
  const int w0 = q_start + warp * WR;  // this warp's first row
  // this lane's rows: r0 + 16m and r0 + 16m + 8 of m16 tile m
  const int r0 = w0 + g;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h;
  constexpr int bias_stage = kBias ? bias_stage_bytes(ROWS, BIAS == 2) : 0;
  // causal: the keys past this q tile's last row are dead for all its rows
  const int k_end = kCausal ? min(a.Tk, q_start + ROWS) : a.Tk;

  // key tile k0 sits in stage (k0 / 64) & 1
  auto stage = [&](int k0) {
    const int st = (k0 / kMmaKeys) & 1;
    __nv_bfloat16* ks = kv_s + st * 2 * kMmaKeys * KS;
    cp_tile<kMmaKeys, D, KS, NT>(ks, kp, k0, a.Tk, a.sk.t, tid);
    cp_tile<kMmaKeys, D, KS, NT>(ks + kMmaKeys * KS, vp, k0, a.Tk, a.sv.t, tid);
    if (tid < kMmaKeys) {
      const int* maskp = a.mask + (long long)b * a.Tk;
      const bool in = k0 + tid < a.Tk;
      cp_async4(ok_s + st * kMmaKeys + tid, in ? maskp + k0 + tid : maskp, in ? 4 : 0);
    }
    if constexpr (kBias)
      stage_bias_raw<ROWS, NT, BIAS>(bias_s + st * bias_stage, a.bias, h, q_start, k0, a.Tq, a.Tk,
                                     tid);
    cp_async_commit();
  };
  cp_tile<ROWS, D, KS, NT>(q_s, static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b + h * a.sq.h,
                           q_start, a.Tq, a.sq.t, tid);
  stage(0);  // one group: q and the first k/v tile

  float o[MT][NO][4];
  float m0[MT], m1[MT];  // running max of rows r0 + 16m, r0 + 16m + 8 (quad-uniform)
  float l0[MT], l1[MT];  // this lane's share of the running sums
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.0f;
    m0[m] = m1[m] = kNegBig;
    l0[m] = l1[m] = 0.0f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kMmaKeys) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last one
    if (k0 + kMmaKeys < k_end) stage(k0 + kMmaKeys);
    const int st = (k0 / kMmaKeys) & 1;
    const __nv_bfloat16* ks = kv_s + st * 2 * kMmaKeys * KS;
    const unsigned char* bt = bias_s + st * bias_stage;
    if (kCausal && w0 + WR - 1 < k0) continue;  // every key of the tile is past this warp's rows
    // the tile's real keys as bits, bit c <-> column 2t + c of this lane
    const int* okp = ok_s + st * kMmaKeys;
    const uint64_t real =
        ((uint64_t)__ballot_sync(0xffffffffu, okp[32 + lane] != 0) << 32 |
         __ballot_sync(0xffffffffu, okp[lane] != 0)) >> (2 * t);

    // one k tile; kMasked (a tile that crosses this warp's diagonal)
    // applies the col <= row mask, every other tile runs the non-causal
    // code
    auto tile = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      // the live columns of a row: real keys, with kMasked on or below
      // the diagonal (bit c <-> column 2t + c)
      auto live = [&](int row) -> uint64_t {
        if (!kMasked) return real;
        const int n = row - k0 - 2 * t + 1;  // columns 2t .. 2t + n - 1
        return n >= 64 ? real : n <= 0 ? 0 : real & (((uint64_t)1 << n) - 1);
      };

      // S = Q K^T: rows (r0, r0 + 8) + 16m, columns j*8 + 2t + {0, 1}
      float s[MT][NJ][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.0f;
      }
      mma_qk<MT, NJ, NK, KS>(s, q_s + (w0 - q_start) * KS, ks, lane);

#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int ra = r0 + 16 * m, rb = ra + 8;
        const uint64_t la = live(ra), lb = live(rb);
        // scale, bias and mask (kNegBig where dead), the tile's row max
        // over the quad
        float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = j * 8 + 2 * t;
          float2 b0 = make_float2(0.0f, 0.0f), b1 = b0;
          if constexpr (kBias) {
            b0 = bias_pair<BIAS>(bt, ra - q_start, col);
            b1 = bias_pair<BIAS>(bt, rb - q_start, col);
          }
          s[m][j][0] = (la >> (8 * j)) & 1 ? s[m][j][0] * a.scale + b0.x : kNegBig;
          s[m][j][1] = (la >> (8 * j + 1)) & 1 ? s[m][j][1] * a.scale + b0.y : kNegBig;
          s[m][j][2] = (lb >> (8 * j)) & 1 ? s[m][j][2] * a.scale + b1.x : kNegBig;
          s[m][j][3] = (lb >> (8 * j + 1)) & 1 ? s[m][j][3] * a.scale + b1.y : kNegBig;
          mx0 = fmaxf(mx0, fmaxf(s[m][j][0], s[m][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[m][j][2], s[m][j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0[m], mx0), mn1 = fmaxf(m1[m], mx1);
        // p = exp(s - m) = 2^(s log2 e - m log2 e); a dead score (kNegBig)
        // gives 0, also in a row with no live key yet (m = kNegBig)
        const float ml0 = mn0 == kNegBig ? 0.0f : mn0 * kLog2e;
        const float ml1 = mn1 == kNegBig ? 0.0f : mn1 * kLog2e;
        const float al0 = ex2((m0[m] - mn0) * kLog2e), al1 = ex2((m1[m] - mn1) * kLog2e);
        float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[m][j][e] = ex2(fmaf(s[m][j][e], kLog2e, -ml0));
            s[m][j][2 + e] = ex2(fmaf(s[m][j][2 + e], kLog2e, -ml1));
            ls0 += s[m][j][e];
            ls1 += s[m][j][2 + e];
          }
        }
        l0[m] = l0[m] * al0 + ls0;  // the denominator stays undropped
        l1[m] = l1[m] * al1 + ls1;
        m0[m] = mn0;
        m1[m] = mn1;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[m][n][0] *= al0;
          o[m][n][1] *= al0;
          o[m][n][2] *= al1;
          o[m][n][3] *= al1;
        }
        if (a.drop.on) {
          // The quad's n8 tile j needs 4 Philox calls: rows (ra, rb) x
          // the two 4-column groups j*8 + {0, 4}. Lane t makes the call
          // of row ra or rb (t & 2) and group t & 1, and hands its 4 keep
          // bits to the quad; lane t's columns 2t, 2t+1 are words
          // 2(t & 1) + {0, 1} of group t >> 1.
          const uint32_t thr = a.drop.threshold;
          const float inv = a.drop.inv_keep;
          const int quad = lane & ~3, sh = 2 * (t & 1);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const uint4 w = bits4(a.drop, bh, (t & 2) ? rb : ra, k0 + j * 8 + 4 * (t & 1));
            const uint32_t kb = (uint32_t)(w.x < thr) | (uint32_t)(w.y < thr) << 1 |
                                (uint32_t)(w.z < thr) << 2 | (uint32_t)(w.w < thr) << 3;
            const uint32_t k0b = __shfl_sync(0xffffffffu, kb, quad + (t >> 1)) >> sh;
            const uint32_t k1b = __shfl_sync(0xffffffffu, kb, quad + 2 + (t >> 1)) >> sh;
            s[m][j][0] = k0b & 1u ? s[m][j][0] * inv : 0.0f;
            s[m][j][1] = k0b & 2u ? s[m][j][1] * inv : 0.0f;
            s[m][j][2] = k1b & 1u ? s[m][j][2] * inv : 0.0f;
            s[m][j][3] = k1b & 2u ? s[m][j][3] * inv : 0.0f;
          }
        }
      }

      // O += bf16(P) V
      mma_pv<MT, NJ, NO, KS>(o, s, ks + kMmaKeys * KS, lane);
    };
    if constexpr (kCausal) {
      if (k0 + kMmaKeys - 1 > w0)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    } else {
      tile(std::false_type{});
    }
  }

  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int ra = r0 + 16 * m, rb = ra + 8;
    float la = l0[m], lb = l1[m];
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    const float d0 = fmaxf(la, kTiny), d1 = fmaxf(lb, kTiny);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      if (ra < a.Tq)
        *reinterpret_cast<__nv_bfloat162*>(op + ra * a.so.t + c) =
            __floats2bfloat162_rn(o[m][n][0] / d0, o[m][n][1] / d0);
      if (rb < a.Tq)
        *reinterpret_cast<__nv_bfloat162*>(op + rb * a.so.t + c) =
            __floats2bfloat162_rn(o[m][n][2] / d1, o[m][n][3] / d1);
    }
    if (t == 0) {
      float* lp = a.lse + (long long)bh * a.Tq;
      if (ra < a.Tq) lp[ra] = m0[m] + logf(d0);
      if (rb < a.Tq) lp[rb] = m1[m] + logf(d1);
    }
  }
}

// ---------------------------------------------------------------------------
// dq and dk/dv, bf16 on tensor cores.
//  - dq: one block per (b*h, ROWS-row q tile), a warp per 16 rows. The q
//    and do tiles are staged once; k, v, the kv mask and the bias tile of
//    key tile k+1 come in through a two-stage cp.async ring while tile k
//    computes S = Q K^T, dP = dO V^T, ds = p (dp - delta) and
//    dq += bf16(dS) K.
//  - dk/dv: one block per (b*h, KEYS-key tile), a warp per 16 keys. The k
//    and v tiles are staged once; q, do, lse, delta and the bias tile of q
//    tile i+1 come in through the ring while tile i computes S^T = K Q^T,
//    dP^T = V dO^T, p and ds, dV += bf16(P_dropped)^T dO and
//    dK += bf16(dS)^T Q. The bias tile is [64 queries][KEYS keys] and is
//    read transposed from shared memory.
// Both read every fragment through ldmatrix.x4 (mma_qk, mma_pv, the
// forward's helpers), compute p with bwd_p (ex2 of a log2(e)-scaled
// score) and make one Philox call a lane per n8 tile of S: in dq the lane
// quad's four calls cover its two rows x two 4-key groups, in dk/dv the
// four lanes g = 4m .. 4m+3 of one t cover their keys 4m .. 4m+3 and
// 4m+8 .. 4m+11 at the quad's two queries; two xor shuffles hand every
// lane all four calls' keep bits.

// The tile layout of the tensor-core backward: query rows a dq block and
// keys a dk/dv block (a warp per 16 of either); the columns of a 64-wide
// tile that a warp scores at a time (its S and dP accumulators hold 16 x
// that many, so 32 halves what 64 keeps live); and the blocks an SM that
// each kernel's register budget is set for (1: no cap). At D <= 64, dq
// fits 128 registers for four blocks and the non-causal dk/dv 168 for
// three, neither spilling; the causal dk/dv spills at 168 and is not
// capped. The faster at the flagship calls (PERF.md; kernel_trial.py bwd).
template <int D, bool kCausal>
struct BwdMmaLayout {
  static constexpr int kDqRows = 64;
  static constexpr int kDkvKeys = 64;
  static constexpr int kDqSub = 32;
  static constexpr int kDkvSub = 32;
  static constexpr int kDqBlocks = D <= 64 ? 4 : 1;
  static constexpr int kDkvBlocks = D <= 64 && !kCausal ? 3 : 1;
};

// the keep bits of one Philox call's four words, as a nibble
__device__ __forceinline__ uint32_t keep4(const uint4& w, uint32_t thr) {
  return (uint32_t)(w.x < thr) | (uint32_t)(w.y < thr) << 1 | (uint32_t)(w.z < thr) << 2 |
         (uint32_t)(w.w < thr) << 3;
}

// the live columns of a row `n` columns into a causal diagonal (bit c <->
// this lane's column 2t + c): the first n of `real`
__device__ __forceinline__ uint64_t first_cols(uint64_t real, int n) {
  return n >= 64 ? real : n <= 0 ? 0 : real & (((uint64_t)1 << n) - 1);
}

// dynamic shared memory of the tensor-core dq: the k/v ring, the q and do
// tiles, the mask ring, and with a bias its two stages
template <int D>
int dq_mma_smem_bytes(int rows, const Bias& bi) {
  return fwd_kv_bytes<D>() + 2 * fwd_q_bytes<D>(rows) + 2 * kMmaKeys * 4 +
         (bi.p ? 2 * bias_stage_bytes(rows, bi.bf16) : 0);
}

// BIAS: the bytes of a bias element, 2 (bf16) or 4 (fp32), or 0 for the
// unbiased instance, which carries none of its code (as in the forward)
template <int D, int BIAS, bool kCausal>
__global__ void __launch_bounds__(BwdMmaLayout<D, kCausal>::kDqRows * 2,
                                  BwdMmaLayout<D, kCausal>::kDqBlocks)
    flash_dq_bf16_mma(BwdArgs a) {
  constexpr bool kBias = BIAS != 0;
  constexpr int ROWS = BwdMmaLayout<D, kCausal>::kDqRows;
  constexpr int SUB = BwdMmaLayout<D, kCausal>::kDqSub;  // keys scored at a time
  constexpr int NT = ROWS * 2;  // a warp per 16 rows
  constexpr int KS = D + 8;
  constexpr int NJ = SUB / 8;  // n8 tiles of S
  constexpr int NK = D / 16;   // k16 steps of Q K^T
  constexpr int NO = D / 8;    // n8 tiles of dq
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][k, v][64][KS]
  __nv_bfloat16* q_s = kv_s + 4 * kMmaKeys * KS;                  // [ROWS][KS]
  __nv_bfloat16* do_s = q_s + ROWS * KS;                          // [ROWS][KS]
  int* ok_s = reinterpret_cast<int*>(do_s + ROWS * KS);           // [stage][64]
  // [stage][ROWS][kBiasRow] in the bias's dtype
  unsigned char* bias_s = reinterpret_cast<unsigned char*>(ok_s + 2 * kMmaKeys);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  // causal: the q tiles from the last one down, the longest blocks first
  const int q_start = (kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * ROWS;
  const int w0 = q_start + warp * 16;  // this warp's first row
  const int ra = w0 + g, rb = ra + 8;  // this lane's rows
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h;
  constexpr int bias_stage = kBias ? bias_stage_bytes(ROWS, BIAS == 2) : 0;
  // causal: the keys past this q tile's last row are dead for all its rows
  const int k_end = kCausal ? min(a.Tk, q_start + ROWS) : a.Tk;

  // key tile k0 sits in stage (k0 / 64) & 1
  auto stage = [&](int k0) {
    const int st = (k0 / kMmaKeys) & 1;
    __nv_bfloat16* ks = kv_s + st * 2 * kMmaKeys * KS;
    cp_tile<kMmaKeys, D, KS, NT>(ks, kp, k0, a.Tk, a.sk.t, tid);
    cp_tile<kMmaKeys, D, KS, NT>(ks + kMmaKeys * KS, vp, k0, a.Tk, a.sv.t, tid);
    if (tid < kMmaKeys) {
      const int* maskp = a.mask + (long long)b * a.Tk;
      const bool in = k0 + tid < a.Tk;
      cp_async4(ok_s + st * kMmaKeys + tid, in ? maskp + k0 + tid : maskp, in ? 4 : 0);
    }
    if constexpr (kBias)
      stage_bias_raw<ROWS, NT, BIAS>(bias_s + st * bias_stage, a.bias, h, q_start, k0, a.Tq, a.Tk,
                                     tid);
    cp_async_commit();
  };
  cp_tile<ROWS, D, KS, NT>(q_s, static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b + h * a.sq.h,
                           q_start, a.Tq, a.sq.t, tid);
  cp_tile<ROWS, D, KS, NT>(do_s,
                           static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
                           q_start, a.Tq, a.sdo.t, tid);
  stage(0);  // one group: q, do and the first k/v tile

  // this lane's rows' -lse log2 e and delta (a row past Tq is never stored)
  const float* lp = a.lse + (long long)bh * a.Tq;
  const float* dlp = a.delta + (long long)bh * a.Tq;
  const float nla = ra < a.Tq ? -lp[ra] * kLog2e : 0.0f;
  const float nlb = rb < a.Tq ? -lp[rb] * kLog2e : 0.0f;
  const float dela = ra < a.Tq ? dlp[ra] : 0.0f;
  const float delb = rb < a.Tq ? dlp[rb] : 0.0f;
  const float sc = kBias ? a.scale : a.scale * kLog2e;

  float dq[1][NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[0][n][0] = dq[0][n][1] = dq[0][n][2] = dq[0][n][3] = 0.0f;

  for (int k0 = 0; k0 < k_end; k0 += kMmaKeys) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last one
    if (k0 + kMmaKeys < k_end) stage(k0 + kMmaKeys);
    const int st = (k0 / kMmaKeys) & 1;
    const __nv_bfloat16* ks = kv_s + st * 2 * kMmaKeys * KS;
    const unsigned char* bt = bias_s + st * bias_stage;
    if (kCausal && k0 > w0 + 15) continue;  // every key of the tile is past this warp's rows
    // the tile's real keys as bits, bit c <-> column c
    const int* okp = ok_s + st * kMmaKeys;
    const uint64_t real64 = (uint64_t)__ballot_sync(0xffffffffu, okp[32 + lane] != 0) << 32 |
                            __ballot_sync(0xffffffffu, okp[lane] != 0);

    // the tile in SUB-key parts kc .. kc + SUB - 1
#pragma unroll 1
    for (int kc = 0; kc < kMmaKeys; kc += SUB) {
      const int c0 = k0 + kc;  // the part's first key
      if (kCausal && c0 > w0 + 15) break;
      // the part's live keys, bit c <-> column kc + 2t + c of this lane; a
      // part that crosses this warp's diagonal keeps col <= row
      const uint64_t real = real64 >> (kc + 2 * t);
      const bool diag = kCausal && c0 + SUB - 1 > w0;
      const uint64_t la = diag ? first_cols(real, ra - c0 - 2 * t + 1) : real;
      const uint64_t lb = diag ? first_cols(real, rb - c0 - 2 * t + 1) : real;

      // S = Q K^T and dP = dO V^T: rows ra, rb, columns j*8 + 2t + {0, 1}
      float s[1][NJ][4], dp[1][NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.0f;
        dp[0][j][0] = dp[0][j][1] = dp[0][j][2] = dp[0][j][3] = 0.0f;
      }
      mma_qk<1, NJ, NK, KS>(s, q_s + warp * 16 * KS, ks + kc * KS, lane);
      mma_qk<1, NJ, NK, KS>(dp, do_s + warp * 16 * KS, ks + (kMmaKeys + kc) * KS, lane);

      // keep bits of n8 tile j: 0, 1 for row ra, 8, 9 for rb (columns 2t,
      // 2t + 1). Lane t calls row (t & 2 ? rb : ra) and the 4-column group
      // t & 1: nibble t of the quad's 16 bits. The part's calls first, so
      // that their chains overlap.
      uint32_t keep[NJ];
      if (a.drop.on) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          keep[j] = keep4(bits4(a.drop, bh, (t & 2) ? rb : ra, c0 + j * 8 + 4 * (t & 1)),
                          a.drop.threshold)
                    << (4 * t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          keep[j] |= __shfl_xor_sync(0xffffffffu, keep[j], 1);
          keep[j] |= __shfl_xor_sync(0xffffffffu, keep[j], 2);
          keep[j] >>= 2 * t;
        }
      }

      // ds = p (dp - delta) into s
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float2 ba = make_float2(0.0f, 0.0f), bb = ba;
        if constexpr (kBias) {
          ba = bias_pair<BIAS>(bt, ra - q_start, kc + j * 8 + 2 * t);
          bb = bias_pair<BIAS>(bt, rb - q_start, kc + j * 8 + 2 * t);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          const float pa =
              (la >> c) & 1 ? bwd_p<kBias>(s[0][j][e], sc, e ? ba.y : ba.x, nla) : 0.0f;
          const float pb =
              (lb >> c) & 1 ? bwd_p<kBias>(s[0][j][2 + e], sc, e ? bb.y : bb.x, nlb) : 0.0f;
          float da = dp[0][j][e], db = dp[0][j][2 + e];
          if (a.drop.on) {
            da = (keep[j] >> e) & 1u ? da * a.drop.inv_keep : 0.0f;
            db = (keep[j] >> (8 + e)) & 1u ? db * a.drop.inv_keep : 0.0f;
          }
          s[0][j][e] = pa * (da - dela);
          s[0][j][2 + e] = pb * (db - delb);
        }
      }

      // dq += bf16(dS) K
      mma_pv<1, NJ, NO, KS>(dq, s, ks + kc * KS, lane);
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  store_rows<NO>(out, dq[0], ra, rb, a.Tq, a.sdq.t, a.scale, t);
}

// dynamic shared memory of the tensor-core dk/dv: the k and v tiles, the
// q/do ring, the lse/delta ring, and with a bias its two stages
// ([64 queries][keys + 8])
template <int D>
int dkv_mma_smem_bytes(int keys, const Bias& bi) {
  return 2 * keys * (D + 8) * 2 + fwd_kv_bytes<D>() + 2 * 2 * kMmaKeys * 4 +
         (bi.p ? 2 * bias_stage_bytes(kMmaKeys, bi.bf16, keys) : 0);
}

template <int D, int BIAS, bool kCausal>
__global__ void __launch_bounds__(BwdMmaLayout<D, kCausal>::kDkvKeys * 2,
                                  BwdMmaLayout<D, kCausal>::kDkvBlocks)
    flash_dkv_bf16_mma(BwdArgs a) {
  constexpr bool kBias = BIAS != 0;
  constexpr int KEYS = BwdMmaLayout<D, kCausal>::kDkvKeys;
  constexpr int SUB = BwdMmaLayout<D, kCausal>::kDkvSub;  // queries scored at a time
  constexpr int NT = KEYS * 2;  // a warp per 16 keys
  constexpr int KS = D + 8;
  constexpr int NJ = SUB / 8;  // n8 tiles of S^T
  constexpr int NK = D / 16;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [KEYS][KS]
  __nv_bfloat16* v_s = k_s + KEYS * KS;                          // [KEYS][KS]
  __nv_bfloat16* qd_s = v_s + KEYS * KS;                         // [stage][q, do][64][KS]
  float* ld_s = reinterpret_cast<float*>(qd_s + 4 * kMmaKeys * KS);  // [stage][lse, delta][64]
  // [stage][64][KEYS + 8] in the bias's dtype
  unsigned char* bias_s = reinterpret_cast<unsigned char*>(ld_s + 4 * kMmaKeys);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int c0 = blockIdx.y * KEYS;
  const int kw0 = c0 + warp * 16;      // this warp's first key
  const int ka = kw0 + g, kb = ka + 8;  // this lane's keys
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* dop =
      static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const int* maskp = a.mask + (long long)b * a.Tk;
  const bool oka = ka < a.Tk && maskp[ka] != 0;
  const bool okb = kb < a.Tk && maskp[kb] != 0;
  constexpr int bias_stage = kBias ? bias_stage_bytes(kMmaKeys, BIAS == 2, KEYS) : 0;

  // q tile q0 sits in stage (q0 / 64) & 1
  auto stage = [&](int q0) {
    const int st = (q0 / kMmaKeys) & 1;
    __nv_bfloat16* qs = qd_s + st * 2 * kMmaKeys * KS;
    cp_tile<kMmaKeys, D, KS, NT>(qs, qp, q0, a.Tq, a.sq.t, tid);
    cp_tile<kMmaKeys, D, KS, NT>(qs + kMmaKeys * KS, dop, q0, a.Tq, a.sdo.t, tid);
    if (tid < 2 * kMmaKeys) {  // lse by the first 64 threads, delta by the next
      const int i = tid & (kMmaKeys - 1);
      const float* src = (tid < kMmaKeys ? a.lse : a.delta) + (long long)bh * a.Tq;
      const bool in = q0 + i < a.Tq;
      cp_async4(ld_s + st * 2 * kMmaKeys + tid, in ? src + q0 + i : src, in ? 4 : 0);
    }
    if constexpr (kBias)
      stage_bias_raw<kMmaKeys, NT, BIAS, KEYS>(bias_s + st * bias_stage, a.bias, h, q0, c0, a.Tq,
                                               a.Tk, tid);
    cp_async_commit();
  };
  cp_tile<KEYS, D, KS, NT>(k_s, static_cast<const __nv_bfloat16*>(a.k) + b * a.sk.b + h * a.sk.h,
                           c0, a.Tk, a.sk.t, tid);
  cp_tile<KEYS, D, KS, NT>(v_s, static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h,
                           c0, a.Tk, a.sv.t, tid);
  // causal: the q tiles before the one holding this block's first key are
  // dead for all its keys
  const int q_begin = kCausal ? (c0 / kMmaKeys) * kMmaKeys : 0;
  stage(q_begin);  // one group: k, v and the first q tile
  const float sc = kBias ? a.scale : a.scale * kLog2e;

  float dk[1][NO][4], dv[1][NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[0][n][0] = dk[0][n][1] = dk[0][n][2] = dk[0][n][3] = 0.0f;
    dv[0][n][0] = dv[0][n][1] = dv[0][n][2] = dv[0][n][3] = 0.0f;
  }

  for (int q0 = q_begin; q0 < a.Tq; q0 += kMmaKeys) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last one
    if (q0 + kMmaKeys < a.Tq) stage(q0 + kMmaKeys);
    const int st = (q0 / kMmaKeys) & 1;
    const __nv_bfloat16* qs = qd_s + st * 2 * kMmaKeys * KS;
    const __nv_bfloat16* dos = qs + kMmaKeys * KS;
    const float* lsp = ld_s + st * 2 * kMmaKeys;
    const unsigned char* bt = bias_s + st * bias_stage;
    const int qlim = a.Tq - q0;  // the tile's real queries

    // the tile in SUB-query parts qh .. qh + SUB - 1
#pragma unroll 1
    for (int qh = 0; qh < kMmaKeys; qh += SUB) {
      if (kCausal && q0 + qh + SUB - 1 < kw0) continue;  // every query is before this warp's keys
      const bool diag = kCausal && q0 + qh < kw0 + 15;  // some query is before some key
      const __nv_bfloat16* qp_s = qs + qh * KS;
      const __nv_bfloat16* dp_s = dos + qh * KS;

      // S^T = K Q^T and dP^T = V dO^T: rows = keys ka, kb, columns =
      // queries qh + j*8 + 2t + {0, 1} of the tile
      float s[1][NJ][4], dpt[1][NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.0f;
        dpt[0][j][0] = dpt[0][j][1] = dpt[0][j][2] = dpt[0][j][3] = 0.0f;
      }
      mma_qk<1, NJ, NK, KS>(s, k_s + warp * 16 * KS, qp_s, lane);
      mma_qk<1, NJ, NK, KS>(dpt, v_s + warp * 16 * KS, dp_s, lane);

      // keep bits of n8 tile j: 4e for (ka, query qc + e), 8 + 4e for kb.
      // Lane g = 4m + i calls query qc + (i & 1) and keys kw0 + 4m +
      // 8 (i >> 1) .. +3: nibble i of the four lanes' 16 bits, word i of
      // each is its key. The part's calls first, so that their chains
      // overlap.
      uint32_t keep[NJ];
      if (a.drop.on) {
        const int i = g & 3;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          keep[j] = keep4(bits4(a.drop, bh, q0 + qh + j * 8 + 2 * t + (i & 1),
                                kw0 + (g & 4) + 8 * (i >> 1)),
                          a.drop.threshold)
                    << (4 * i);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          keep[j] |= __shfl_xor_sync(0xffffffffu, keep[j], 4);
          keep[j] |= __shfl_xor_sync(0xffffffffu, keep[j], 8);
          keep[j] >>= i;
        }
      }

      // s <- the dropped p (for dV), dpt <- ds (for dK)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = qh + j * 8 + 2 * t;
        const float2 lse = *reinterpret_cast<const float2*>(lsp + qc);
        const float2 del = *reinterpret_cast<const float2*>(lsp + kMmaKeys + qc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool qv = qc + e < qlim;
          const int query = q0 + qc + e;
          const bool la = oka && qv && (!diag || ka <= query);
          const bool lb = okb && qv && (!diag || kb <= query);
          float ba = 0.0f, bb = 0.0f;
          if constexpr (kBias) {
            ba = bias_one<BIAS, KEYS>(bt, qc + e, ka - c0);
            bb = bias_one<BIAS, KEYS>(bt, qc + e, kb - c0);
          }
          const float nl = -(e ? lse.y : lse.x) * kLog2e;
          const float dl = e ? del.y : del.x;
          const float pa = la ? bwd_p<kBias>(s[0][j][e], sc, ba, nl) : 0.0f;
          const float pb = lb ? bwd_p<kBias>(s[0][j][2 + e], sc, bb, nl) : 0.0f;
          float da = dpt[0][j][e], db = dpt[0][j][2 + e];
          float va = pa, vb = pb;
          if (a.drop.on) {
            const bool keep_a = (keep[j] >> (4 * e)) & 1u;
            const bool keep_b = (keep[j] >> (8 + 4 * e)) & 1u;
            const float inv = a.drop.inv_keep;
            va = keep_a ? pa * inv : 0.0f;
            da = keep_a ? da * inv : 0.0f;
            vb = keep_b ? pb * inv : 0.0f;
            db = keep_b ? db * inv : 0.0f;
          }
          s[0][j][e] = va;
          s[0][j][2 + e] = vb;
          dpt[0][j][e] = pa * (da - dl);
          dpt[0][j][2 + e] = pb * (db - dl);
        }
      }

      mma_pv<1, NJ, NO, KS>(dv, s, dp_s, lane);    // dV += bf16(P_dropped)^T dO
      mma_pv<1, NJ, NO, KS>(dk, dpt, qp_s, lane);  // dK += bf16(dS)^T Q
    }
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  store_rows<NO>(dkp, dk[0], ka, kb, a.Tk, a.sdk.t, a.scale, t);
  store_rows<NO>(dvp, dv[0], ka, kb, a.Tk, a.sdv.t, 1.0f, t);
}

// ---------------------------------------------------------------------------
// dq and dk/dv, fp32 (and bf16 at other widths): register-tiled FMA
// kernels. 256 threads form a 16 x 16 grid (ty, tx) over a 64 x 64 score
// tile: a thread owns the 4 consecutive keys 4ty .. 4ty+3 and the 4
// queries tx, tx+16, tx+32, tx+48, so one Philox call gives the bits of
// a query's 4 keys and one 16-byte load its 4 bias elements. Key tiles
// (k, v) are plain row-major [64][KS] fp32; query tiles (q, do) and dq's
// dS tile are swizzled: 16-byte chunk c of row r sits at chunk c ^ (r & 7),
// so the 8 lanes of a quarter warp, reading chunk c of 8 consecutive
// rows, hit 8 distinct bank groups. KS is 64 (D <= 64) or 128, a template
// argument, and the products run over D rounded up to 16, the padding
// zero-filled.

constexpr int kTileThreads = 256;
constexpr int kTileRows = 64;  // queries (dq) or keys (dk/dv) per block
constexpr int kTileKeys = 64;  // keys (dq) or queries (dk/dv) per tile of the loop

__device__ __forceinline__ int swz(int c, int r) { return c ^ (r & 7); }

// Rows r0 .. r0+63 (zero past `rows`) and columns 0 .. 16*n16-1 (zero
// past D) of a strided [rows, D] operand into a [64][KS] fp32 tile,
// swizzled with kSwz. fp32 goes through cp.async (the caller commits):
// 16 bytes a copy where `vec` says every row starts 16-byte aligned, else
// 4. bf16 is converted to fp32 through registers.
template <typename T, int KS, bool kSwz>
__device__ __forceinline__ void stage_tile(float* tile, const T* src, int r0, int rows,
                                           long long st, int D, int n16, bool vec, int tid) {
  constexpr int kLanes = KS / 4;  // threads of a row, one 16-byte chunk each
  const int n4 = 4 * n16;
  if constexpr (std::is_same<T, float>::value) {
    if (!vec) {
      const int e = tid % KS;
      if (e >= 4 * n4) return;
      const int c = e >> 2;
      for (int r = tid / KS; r < kTileRows; r += kTileThreads / KS) {
        const int row = r0 + r;
        const bool in = row < rows && e < D;
        cp_async4(tile + r * KS + 4 * (kSwz ? swz(c, r) : c) + (e & 3),
                  in ? static_cast<const void*>(src + row * st + e) : src, in ? 4 : 0);
      }
      return;
    }
  }
  const int c = tid % kLanes;
  if (c >= n4) return;
  for (int r = tid / kLanes; r < kTileRows; r += kTileThreads / kLanes) {
    const int row = r0 + r;
    const int cols = row < rows ? min(4, max(0, D - 4 * c)) : 0;
    float* dst = tile + r * KS + 4 * (kSwz ? swz(c, r) : c);
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(dst, cols ? static_cast<const void*>(src + row * st + 4 * c) : src, 4 * cols);
    } else {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = e < cols ? to_f(src[row * st + 4 * c + e]) : 0.0f;
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// operand x's [T, D] strip of head (b, h)
template <typename T>
__device__ __forceinline__ const T* strip(const void* x, const Strides& s, int b, int h) {
  return static_cast<const T*>(x) + b * s.b + h * s.h;
}

// acc[i][j] += sum_d a[4ty + i][d] * b[tx + RS j][d] over the n16 16-column
// groups: `a` points at row 4ty of a plain tile (its 4 rows are one
// broadcast per quarter warp), `b` at row tx of a swizzled one (sw = tx &
// 7; RS is a multiple of 8). Per 4 columns, 8 LDS.128 feed 64 FMAs; d
// ascends in every sum, as in the plain dot product.
template <int KS, int RS = 16>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* a, const float* b,
                                          int sw, int n16) {
  for (int g = 0; g < n16; ++g) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * g + cc;
      float4 y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = *reinterpret_cast<const float4*>(b + RS * j * KS + 4 * (c ^ sw));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(a + i * KS + 4 * c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
        }
      }
    }
  }
}

// acc[i][4cc + e] += sum_k x[4ty + i][k] * y[k][4 (tx + 16cc) + e] over
// the 64 keys (dq) or queries (dk/dv) of a tile, k ascending: `x` points
// at row 4ty of a [64][64] tile (dS swizzled, or p / dS^T plain), `y` is a
// [64][KS] tile. Columns at or past D are skipped. kUnroll unrolls the
// loop over k (register pressure against latency hiding).
template <int KS, int NC, bool kXSwz, bool kYSwz, int kUnroll>
__device__ __forceinline__ void tile_xv(float (&acc)[4][4 * NC], const float* x, const float* y,
                                        int ty, int tx, int D) {
  bool on[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) on[cc] = 4 * (tx + 16 * cc) < D;
#pragma unroll (kUnroll)
  for (int kc = 0; kc < kTileKeys / 4; ++kc) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(x + i * kTileKeys +
                                               4 * (kXSwz ? swz(kc, 4 * ty + i) : kc));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * kc + e;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        if (!on[cc]) continue;
        const int c = tx + 16 * cc;
        const float4 yv =
            *reinterpret_cast<const float4*>(y + k * KS + 4 * (kYSwz ? swz(c, k) : c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xe = lane_of(xv[i], e);
          acc[i][4 * cc + 0] = fmaf(xe, yv.x, acc[i][4 * cc + 0]);
          acc[i][4 * cc + 1] = fmaf(xe, yv.y, acc[i][4 * cc + 1]);
          acc[i][4 * cc + 2] = fmaf(xe, yv.z, acc[i][4 * cc + 2]);
          acc[i][4 * cc + 3] = fmaf(xe, yv.w, acc[i][4 * cc + 3]);
        }
      }
    }
  }
}

// bias[h, row, key0 .. key0+3] in fp32, 0 past Tq or Tk and without a
// bias: one 16-byte (fp32) or 8-byte (bf16) load where the bias's
// alignment allows (key0 is a multiple of 4)
__device__ __forceinline__ void bias4(const Bias& bi, int h, int row, int key0, int Tq, int Tk,
                                      float (&bv)[4]) {
  bv[0] = bv[1] = bv[2] = bv[3] = 0.0f;
  if (bi.p == nullptr || row >= Tq) return;
  const long long off = (long long)h * bi.sh + (long long)row * bi.st + key0;
  if (bi.vec && key0 + 3 < Tk) {
    if (bi.bf16) {
      const uint2 u =
          *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(bi.p) + off);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      bv[0] = __low2float(lo);
      bv[1] = __high2float(lo);
      bv[2] = __low2float(hi);
      bv[3] = __high2float(hi);
    } else {
      const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(bi.p) + off);
      bv[0] = f.x;
      bv[1] = f.y;
      bv[2] = f.z;
      bv[3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (key0 + e < Tk) bv[e] = bias_at(bi, h, row, key0 + e);
}

template <int KS>
__host__ __device__ constexpr int dq_tile_smem_bytes() {
  // q_s, do_s [64][KS]; k_s, v_s [2 stages][64][KS]; ds_s [64][64]; ok_s [2][64]
  return (6 * kTileRows * KS + kTileRows * kTileKeys + 2 * kTileKeys) * 4;
}

template <int KS>
__host__ __device__ constexpr int dkv_tile_smem_bytes() {
  // k_s, v_s [64][KS]; q_s, do_s [2 stages][64][KS]; x_s [64][64]; ok_s [64]
  return (6 * kTileRows * KS + kTileRows * kTileKeys + kTileRows) * 4;
}

template <int KS>
__host__ __device__ constexpr int fwd_tile_smem_bytes() {
  // q_s [64][KS]; k_s, v_s [2 stages][64][KS]; x_s [2 stages][64][64]: the
  // bias tile, then p over it; ok_s [2][64]
  return (5 * kTileRows * KS + 2 * kTileRows * kTileKeys + 2 * kTileKeys) * 4;
}

// forward, fp32 (and bf16 at widths the mma path does not take): one block
// per (b*h, 64-row q tile) loops over 64-key tiles; the next tile's k, v,
// mask and bias come in through cp.async while this one computes. Here a
// thread owns the queries 4ty .. 4ty+3 and the keys tx + 16j of the score
// tile (S = Q K^T, the k tile swizzled), so a row's 64 scores lie in the
// 16 lanes of one half warp: its max is 4 shuffles, and each thread keeps
// its own share of the sum until the end. p replaces the bias element it
// came from in x_s (the same thread reads and writes each element), and
// o stays in registers: rows 4ty .. 4ty+3, the 4-column chunks tx (and
// tx + 16 at KS 128). fp32 at KS 64 runs two blocks an SM (~113 KB, 128
// registers); the bf16 instances (no main path) have no register cap: at
// 128 registers the KS 64 one spilled 40 bytes.
template <typename T, int KS, bool kCausal>
__global__ void __launch_bounds__(kTileThreads, KS == 64 && sizeof(T) == 4 ? 2 : 1)
    flash_fwd_scalar(Args a) {
  constexpr int NC = KS / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [64][KS]
  float* kv_s = q_s + kTileRows * KS;           // [stage][k (swizzled), v][64][KS]
  float* x_s = kv_s + 4 * kTileKeys * KS;       // [stage][64 rows][64 keys], swizzled
  int* ok_s = reinterpret_cast<int*>(x_s + 2 * kTileRows * kTileKeys);  // [stage][64]

  // Pointers and widths are read from the arguments where they are used
  // (register pressure: two blocks an SM leave 128 registers a thread).
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * a.H + h;
  // causal: the q tiles from the last one down, so that the longest
  // blocks start first
  const int q0 = (kCausal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * kTileRows;

  const int k_end = kCausal ? min(a.Tk, q0 + kTileRows) : a.Tk;
  // tile k0 sits in stage (k0 / 64) & 1
  auto stage_kv = [&](int k0) {
    const int st = (k0 / kTileKeys) & 1;
    float* ks = kv_s + st * 2 * kTileKeys * KS;
    stage_tile<T, KS, true>(ks, strip<T>(a.k, a.sk, b, h), k0, a.Tk, a.sk.t, a.D, a.n16, a.vec,
                            tid);
    stage_tile<T, KS, false>(ks + kTileKeys * KS, strip<T>(a.v, a.sv, b, h), k0, a.Tk, a.sv.t,
                             a.D, a.n16, a.vec, tid);
    if (a.bias.p) {
      // bias[h, q0.., k0..] as a [64][64] tile swizzled like p: 4 of its
      // 16 columns' chunks a thread, zeros past Tq and Tk
      const long long off = (long long)h * a.bias.sh + k0;
      float* xs = x_s + st * kTileRows * kTileKeys;
      if (a.bias.bf16)
        stage_tile<__nv_bfloat16, kTileKeys, true>(
            xs, static_cast<const __nv_bfloat16*>(a.bias.p) + off, q0, a.Tq, a.bias.st,
            a.Tk - k0, kTileKeys / 16, false, tid);
      else
        stage_tile<float, kTileKeys, true>(xs, static_cast<const float*>(a.bias.p) + off, q0,
                                           a.Tq, a.bias.st, a.Tk - k0, kTileKeys / 16,
                                           a.bias.vec != 0, tid);
    }
    if (tid < kTileKeys) {
      const int* maskp = a.mask + (long long)b * a.Tk;
      const bool in = k0 + tid < a.Tk;
      cp_async4(ok_s + st * kTileKeys + tid, in ? maskp + k0 + tid : maskp, in ? 4 : 0);
    }
    cp_async_commit();
  };
  stage_tile<T, KS, false>(q_s, strip<T>(a.q, a.sq, b, h), q0, a.Tq, a.sq.t, a.D, a.n16, a.vec,
                           tid);
  stage_kv(0);  // one group: q and the first k/v tile

  float o[4][4 * NC], m[4], l[4];  // l: this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTileKeys) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every thread is done with the last one
    if (k0 + kTileKeys < k_end) stage_kv(k0 + kTileKeys);
    const int stage = (k0 / kTileKeys) & 1;
    const float* ks = kv_s + stage * 2 * kTileKeys * KS;
    float* xs = x_s + stage * kTileRows * kTileKeys;  // the bias tile, then p over it

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
    tile_dots<KS>(s, q_s + 4 * ty * KS, ks + tx * KS, tx & 7, a.n16);  // S = Q K^T

    // scale, bias and mask; live bit 4i + j: (row 4ty + i, key tx + 16j)
    const bool diag = kCausal && k0 + kTileKeys > q0;  // crosses the diagonal
    const int* okp = ok_s + stage * kTileKeys;
    uint32_t live = 0;
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      mx[i] = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = okp[c] != 0 && (!diag || k0 + c <= q0 + r);
        const float bv = a.bias.p ? xs[r * kTileKeys + 4 * swz(c >> 2, r) + (c & 3)] : 0.0f;
        s[i][j] = ok ? s[i][j] * a.scale + bv : kNegBig;
        live |= (uint32_t)ok << (4 * i + j);
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }

    // dropout: lane e = tx & 3 of a quad (its keys are the 4 columns of one
    // Philox group) makes the call of row 4ty + e, and the quad trades
    // words so that each lane holds its own column's word of every row
    uint32_t keep = 0xffffu;
    if (a.drop.on) {
      const int e = tx & 3, quad = (tid & 31) & ~3;
      keep = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 w = bits4(a.drop, bh, q0 + 4 * ty + e, k0 + 16 * j + (tx & ~3));
#pragma unroll
        for (int sft = 0; sft < 4; ++sft) {
          // lane e sends word e + sft of its row and takes word e of row e - sft
          uint32_t x = word(w, (e + sft) & 3);
          if (sft) x = __shfl_sync(0xffffffffu, x, quad | ((e - sft) & 3));
          keep |= (uint32_t)(x < a.drop.threshold) << (4 * ((e - sft) & 3) + j);
        }
      }
    }

    // p = exp(s - m), the rescale, and round(d p) into x_s over the bias
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float mn = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - mn);
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (live >> (4 * i + j)) & 1u ? expf(s[i][j] - mn) : 0.0f;
        ls += p;
        const float pv = (keep >> (4 * i + j)) & 1u ? (a.drop.on ? p * a.drop.inv_keep : p) : 0.0f;
        xs[r * kTileKeys + 4 * swz(c >> 2, r) + (c & 3)] = round_to<T>(pv);  // v's dtype
      }
      l[i] = l[i] * alpha + ls;  // the denominator stays undropped
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();
    // O += P V, keys ascending
    tile_xv<KS, NC, true, false, 2>(o, xs + 4 * ty * kTileKeys, ks + kTileKeys * KS, ty, tx,
                                    a.D);
  }

  T* out = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + 4 * ty + i;
    if (row >= a.Tq) continue;
    const float den = fmaxf(l[i], kTiny);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * cc) + e;
        if (d < a.D) out[row * a.so.t + d] = from_f<T>(o[i][4 * cc + e] / den);
      }
    }
    if (tx == 0) a.lse[(long long)bh * a.Tq + row] = m[i] + logf(den);
  }
}

// dq: one block per (b*h, 64-row q tile) loops over 64-key k/v tiles; the
// next tile's k, v and mask come in through cp.async while this one
// computes. dq stays in registers: a thread owns rows 4ty .. 4ty+3 and
// the 4-column chunks tx (and tx + 16 at KS 128).
template <typename T, int KS, bool kCausal>
__global__ void __launch_bounds__(kTileThreads, KS == 64 ? 2 : 1) flash_dq_scalar(BwdArgs a) {
  constexpr int NC = KS / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [64][KS], swizzled
  float* do_s = q_s + kTileRows * KS;            // [64][KS], swizzled
  float* kv_s = do_s + kTileRows * KS;           // [stage][k, v][64][KS]
  float* ds_s = kv_s + 4 * kTileKeys * KS;       // [64 rows][64 keys], swizzled
  int* ok_s = reinterpret_cast<int*>(ds_s + kTileRows * kTileKeys);  // [stage][64]

  // Pointers and widths are read from the arguments where they are used
  // (register pressure: two blocks an SM leave 128 registers a thread).
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  const int q0 = blockIdx.x * kTileRows;

  const int k_end = kCausal ? min(a.Tk, q0 + kTileRows) : a.Tk;
  // tile k0 sits in stage (k0 / 64) & 1
  auto stage_kv = [&](int k0) {
    float* ks = kv_s + ((k0 / kTileKeys) & 1) * 2 * kTileKeys * KS;
    stage_tile<T, KS, false>(ks, strip<T>(a.k, a.sk, b, h), k0, a.Tk, a.sk.t, a.D, a.n16, a.vec,
                             tid);
    stage_tile<T, KS, false>(ks + kTileKeys * KS, strip<T>(a.v, a.sv, b, h), k0, a.Tk, a.sv.t,
                             a.D, a.n16, a.vec, tid);
    if (tid < kTileKeys) {
      const int* maskp = a.mask + (long long)b * a.Tk;
      const bool in = k0 + tid < a.Tk;
      cp_async4(ok_s + ((k0 / kTileKeys) & 1) * kTileKeys + tid, in ? maskp + k0 + tid : maskp,
                in ? 4 : 0);
    }
    cp_async_commit();
  };
  stage_tile<T, KS, true>(q_s, strip<T>(a.q, a.sq, b, h), q0, a.Tq, a.sq.t, a.D, a.n16, a.vec,
                          tid);
  stage_tile<T, KS, true>(do_s, strip<T>(a.dout, a.sdo, b, h), q0, a.Tq, a.sdo.t, a.D, a.n16,
                          a.vec, tid);
  stage_kv(0);  // one group: q, do and the first k/v tile

  float dq[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dq[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTileKeys) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every thread is done with the last one
    if (k0 + kTileKeys < k_end) stage_kv(k0 + kTileKeys);
    const int stage = (k0 / kTileKeys) & 1;
    const float* ks = kv_s + stage * 2 * kTileKeys * KS;
    const float* vs = ks + kTileKeys * KS;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
    tile_dots<KS>(s, ks + 4 * ty * KS, q_s + tx * KS, tx & 7, a.n16);    // S^T = K Q^T
    tile_dots<KS>(dp, vs + 4 * ty * KS, do_s + tx * KS, tx & 7, a.n16);  // dP^T = V dO^T

    // ds = round(p (dp - delta)) in registers, then once into ds_s
    const bool diag = kCausal && k0 + kTileKeys > q0;  // crosses the diagonal
    const int key0 = k0 + 4 * ty;
    const int4 okq = *reinterpret_cast<const int4*>(ok_s + stage * kTileKeys + 4 * ty);
    const int ok[4] = {okq.x, okq.y, okq.z, okq.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      const bool rin = row < a.Tq;
      const long long lrow = (long long)bh * a.Tq + row;
      const float lse = rin ? a.lse[lrow] : 0.0f, del = rin ? a.delta[lrow] : 0.0f;
      float bv[4];
      bias4(a.bias, h, row, key0, a.Tq, a.Tk, bv);
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (a.drop.on && rin) w = bits4(a.drop, bh, row, key0);
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = ok[i] != 0 && rin && (!diag || key0 + i <= row);
        const float p = live ? expf(s[i][j] * a.scale + bv[i] - lse) : 0.0f;
        float d = dp[i][j];
        if (a.drop.on) d = word(w, i) < a.drop.threshold ? d * a.drop.inv_keep : 0.0f;
        ds[i] = round_to<T>(p * (d - del));  // in k's dtype
      }
      *reinterpret_cast<float4*>(ds_s + (tx + 16 * j) * kTileKeys + 4 * (ty ^ (tx & 7))) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    // dq += dS K; the causal instance keeps its k loop rolled, which its
    // diagonal flag's registers need to stay within 128 without spilling
    tile_xv<KS, NC, true, false, kCausal ? 1 : 2>(dq, ds_s + 4 * ty * kTileKeys, ks, ty, tx,
                                                  a.D);
  }

  T* out = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * cc) + e;
        if (d < a.D) out[row * a.sdq.t + d] = from_f<T>(dq[i][4 * cc + e] * a.scale);
      }
    }
  }
}

// dk/dv: one block per (b*h, 64-key tile) loops over 64-row q/do tiles
// (the causal build from the tile holding its first key); the next tile
// comes in through cp.async while this one computes. round(d p)^T and
// then dS^T pass through one [64][64] shared tile; dk and dv stay in
// registers: a thread owns keys 4ty .. 4ty+3 and the 4-column chunks tx
// (and tx + 16 at KS 128).
template <typename T, int KS, bool kCausal>
__global__ void __launch_bounds__(kTileThreads, KS == 64 ? 2 : 1) flash_dkv_scalar(BwdArgs a) {
  constexpr int NC = KS / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [64][KS]: this block's keys
  float* v_s = k_s + kTileRows * KS;             // [64][KS]
  float* qd_s = v_s + kTileRows * KS;            // [stage][q, do][64][KS], swizzled
  float* x_s = qd_s + 4 * kTileKeys * KS;        // [64 keys][64 queries]: p, then ds
  int* ok_s = reinterpret_cast<int*>(x_s + kTileRows * kTileKeys);  // [64]: the keys' mask

  // Pointers and widths are read from the arguments where they are used
  // (register pressure: two blocks an SM leave 128 registers a thread).
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  const int c0 = blockIdx.x * kTileRows;

  // the causal build starts at the q tile holding key c0 (64-aligned);
  // tile q0 sits in stage ((q0 - q_begin) / 64) & 1
  const int q_begin = kCausal ? c0 : 0;
  auto stage_qd = [&](int q0) {
    float* qs = qd_s + (((q0 - q_begin) / kTileKeys) & 1) * 2 * kTileKeys * KS;
    stage_tile<T, KS, true>(qs, strip<T>(a.q, a.sq, b, h), q0, a.Tq, a.sq.t, a.D, a.n16, a.vec,
                            tid);
    stage_tile<T, KS, true>(qs + kTileKeys * KS, strip<T>(a.dout, a.sdo, b, h), q0, a.Tq,
                            a.sdo.t, a.D, a.n16, a.vec, tid);
    cp_async_commit();
  };
  stage_tile<T, KS, false>(k_s, strip<T>(a.k, a.sk, b, h), c0, a.Tk, a.sk.t, a.D, a.n16, a.vec,
                           tid);
  stage_tile<T, KS, false>(v_s, strip<T>(a.v, a.sv, b, h), c0, a.Tk, a.sv.t, a.D, a.n16, a.vec,
                           tid);
  if (tid < kTileRows) {
    const int* maskp = a.mask + (long long)b * a.Tk;
    const bool in = c0 + tid < a.Tk;
    cp_async4(ok_s + tid, in ? maskp + c0 + tid : maskp, in ? 4 : 0);
  }
  stage_qd(q_begin);  // one group: k, v, the mask and the first q/do tile

  const int key0 = c0 + 4 * ty;
  float dk[4][4 * NC], dv[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }

  for (int q0 = q_begin; q0 < a.Tq; q0 += kTileKeys) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every thread is done with the last one
    if (q0 + kTileKeys < a.Tq) stage_qd(q0 + kTileKeys);
    const float* qs = qd_s + (((q0 - q_begin) / kTileKeys) & 1) * 2 * kTileKeys * KS;
    const float* dos = qs + kTileKeys * KS;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
    tile_dots<KS>(s, k_s + 4 * ty * KS, qs + tx * KS, tx & 7, a.n16);    // S^T = K Q^T
    tile_dots<KS>(dp, v_s + 4 * ty * KS, dos + tx * KS, tx & 7, a.n16);  // dP^T = V dO^T

    // round(d p) goes to x_s as it is formed, round(ds) waits in dp
    const bool diag = kCausal && q0 < c0 + kTileRows;  // crosses the diagonal
    const int4 okq = *reinterpret_cast<const int4*>(ok_s + 4 * ty);
    const int kok[4] = {okq.x, okq.y, okq.z, okq.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      const bool rin = row < a.Tq;
      const long long lrow = (long long)bh * a.Tq + row;
      const float lse = rin ? a.lse[lrow] : 0.0f, del = rin ? a.delta[lrow] : 0.0f;
      float bv[4];
      bias4(a.bias, h, row, key0, a.Tq, a.Tk, bv);
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (a.drop.on && rin) w = bits4(a.drop, bh, row, key0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = kok[i] != 0 && rin && (!diag || key0 + i <= row);
        const float p = live ? expf(s[i][j] * a.scale + bv[i] - lse) : 0.0f;
        float pv = p, d = dp[i][j];
        if (a.drop.on) {
          const bool keep = word(w, i) < a.drop.threshold;
          pv = keep ? p * a.drop.inv_keep : 0.0f;
          d = keep ? d * a.drop.inv_keep : 0.0f;
        }
        x_s[(4 * ty + i) * kTileKeys + tx + 16 * j] = round_to<T>(pv);  // do's dtype
        dp[i][j] = round_to<T>(p * (d - del));                          // q's dtype
      }
    }
    __syncthreads();
    tile_xv<KS, NC, false, true, 2>(dv, x_s + 4 * ty * kTileKeys, dos, ty, tx, a.D);  // P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x_s[(4 * ty + i) * kTileKeys + tx + 16 * j] = dp[i][j];
    }
    __syncthreads();
    tile_xv<KS, NC, false, true, 2>(dk, x_s + 4 * ty * kTileKeys, qs, ty, tx, a.D);  // dS^T Q
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvp = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + i;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * cc) + e;
        if (d < a.D) {
          dkp[key * a.sdk.t + d] = from_f<T>(dk[i][4 * cc + e] * a.scale);
          dvp[key * a.sdv.t + d] = from_f<T>(dv[i][4 * cc + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dbias, bf16 on tensor cores. A block owns ROWS query rows x KEYS keys of
// one head and a slice of the batch, whose rows it visits in order; a warp
// owns 16 rows x WK keys and sums ds over the batch in an S-shaped fp32
// accumulator (WK / 2 registers). Each batch row's q and do tiles, k and v
// tiles, key mask, lse and delta come in through a two-stage cp.async
// ring while the row before computes; the bias tile is staged once, before
// the batch loop. Per row and 32-key part, S = Q K^T and dP = dO V^T
// through ldmatrix.x4 (mma_qk), p from bwd_p, one Philox call a lane per
// n8 tile with the words traded by xor shuffles (as in dq), and acc += p
// (dp - delta). Where the grid is small (the short buckets), the batch is
// cut into slices whose [slices, H, Tq, Tk] partials dbias_reduce sums in
// slice order (dbias_mma_cut); a causal tile wholly above the diagonal
// writes zeros.

// The tile layout of the tensor-core dbias: query rows and keys a block,
// keys a warp (a warp per 16 rows x kWarpKeys) and the keys a warp scores
// at a time. 64 x 64 blocks of 8 warps of 32 keys: with a bf16 bias at D
// 64 a block takes ~85 KB of shared memory and ~122 registers a thread,
// two blocks (16 warps) an SM; 128-row or 128-key blocks take one an SM,
// and warps of 64 keys give 8 warps an SM, all slower at the T5 training
// path's calls, weighted by its launches (PERF.md; kernel_trial.py
// dbias_mma). The cut aims at 528 live blocks, two waves of two an SM.
template <int D, bool kCausal>
struct DbiasMmaLayout {
  static constexpr int kRows = 64;
  static constexpr int kKeys = 64;
  static constexpr int kWarpKeys = 32;
  static constexpr int kSub = 32;
};
constexpr int kDbMmaSplitBlocks = 528;  // live blocks the tensor-core batch cut aims for

// one ring stage of the tensor-core dbias: q, do [rows][D + 8], k, v
// [keys][D + 8] (bf16), the key mask [keys] and lse, delta [rows]
template <int D>
__host__ __device__ constexpr int dbias_mma_stage_bytes(int rows, int keys) {
  return 2 * (rows + keys) * (D + 8) * 2 + keys * 4 + 2 * rows * 4;
}

// dynamic shared memory of the tensor-core dbias: two ring stages and the
// bias tile [rows][keys + 8] in the bias's dtype
template <int D>
int dbias_mma_smem_bytes(int rows, int keys, const Bias& bi) {
  return 2 * dbias_mma_stage_bytes<D>(rows, keys) + bias_stage_bytes(rows, bi.bf16, keys);
}

template <int D, bool kCausal>
__host__ __device__ constexpr int dbias_mma_threads() {
  using L = DbiasMmaLayout<D, kCausal>;
  return L::kRows / 16 * (L::kKeys / L::kWarpKeys) * 32;
}

// BIAS: the bytes of a bias element, 2 (bf16) or 4 (fp32). One block:
// keys k0 .. k0+KEYS-1 and rows q0 .. q0+ROWS-1 of head h over the batch
// rows slice * per .. of its slice, into slice's [H, Tq, Tk] of `out`
// (dbias itself when the batch is not cut).
template <int D, int BIAS, bool kCausal>
__global__ void __launch_bounds__(DbiasMmaLayout<D, kCausal>::kRows / 16 *
                                  (DbiasMmaLayout<D, kCausal>::kKeys /
                                   DbiasMmaLayout<D, kCausal>::kWarpKeys) * 32)
    flash_dbias_bf16_mma(BwdArgs a, float* out, int per) {
  using L = DbiasMmaLayout<D, kCausal>;
  constexpr int ROWS = L::kRows, KEYS = L::kKeys, WK = L::kWarpKeys, SUB = L::kSub;
  static_assert(WK == 32 || WK == 64, "a warp scores 32 or 64 keys");
  static_assert(SUB <= WK && KEYS % WK == 0, "a warp's keys hold whole parts");
  constexpr int RW = ROWS / 16;  // warps along the rows
  constexpr int NT = dbias_mma_threads<D, kCausal>();
  constexpr int KS = D + 8;
  constexpr int NJ = SUB / 8;  // n8 tiles of a part
  constexpr int NA = WK / 8;   // n8 tiles of a warp's keys
  constexpr int NK = D / 16;
  constexpr int SB = dbias_mma_stage_bytes<D>(ROWS, KEYS);
  extern __shared__ __align__(16) unsigned char smem[];
  // [stage][q, do [ROWS][KS]; k, v [KEYS][KS]; mask [KEYS]; lse, delta [ROWS]]
  unsigned char* bias_s = smem + 2 * SB;  // [ROWS][KEYS + 8] in the bias's dtype

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.z % a.H, slice = blockIdx.z / a.H;
  const int k0 = blockIdx.x * KEYS, q0 = blockIdx.y * ROWS;
  const int wr = warp % RW, kw = warp / RW * WK;  // the warp's rows / 16 and first key
  const int w0 = q0 + wr * 16;                    // this warp's first row
  const int ra = w0 + g, rb = ra + 8;             // this lane's rows

  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const int b0 = slice * per;
  const int nb = min(per, a.B - b0);
  // else wholly above the diagonal: ds is 0 and the tile is written as zeros
  if ((!kCausal || k0 < q0 + ROWS) && nb > 0) {
    // batch row b0 + i into stage i & 1
    auto stage = [&](int i) {
      const int b = b0 + i;
      __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + (i & 1) * SB);
      cp_tile<ROWS, D, KS, NT>(qs, static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b +
                                       h * a.sq.h, q0, a.Tq, a.sq.t, tid);
      cp_tile<ROWS, D, KS, NT>(qs + ROWS * KS, static_cast<const __nv_bfloat16*>(a.dout) +
                                                   b * a.sdo.b + h * a.sdo.h, q0, a.Tq,
                               a.sdo.t, tid);
      cp_tile<KEYS, D, KS, NT>(qs + 2 * ROWS * KS, static_cast<const __nv_bfloat16*>(a.k) +
                                                       b * a.sk.b + h * a.sk.h, k0, a.Tk,
                               a.sk.t, tid);
      cp_tile<KEYS, D, KS, NT>(qs + (2 * ROWS + KEYS) * KS,
                               static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h,
                               k0, a.Tk, a.sv.t, tid);
      int* ok_s = reinterpret_cast<int*>(qs + 2 * (ROWS + KEYS) * KS);
      float* ld_s = reinterpret_cast<float*>(ok_s + KEYS);
      const int* maskp = a.mask + (long long)b * a.Tk;
      for (int c = tid; c < KEYS; c += NT) {
        const bool in = k0 + c < a.Tk;
        cp_async4(ok_s + c, in ? maskp + k0 + c : maskp, in ? 4 : 0);
      }
      const long long lrow = ((long long)b * a.H + h) * a.Tq + q0;
      for (int c = tid; c < 2 * ROWS; c += NT) {
        const int r = c % ROWS;
        const float* src = c < ROWS ? a.lse : a.delta;
        const bool in = q0 + r < a.Tq;
        cp_async4(ld_s + c, in ? src + lrow + r : src, in ? 4 : 0);
      }
      cp_async_commit();
    };
    stage_bias_raw<ROWS, NT, BIAS, KEYS>(bias_s, a.bias, h, q0, k0, a.Tq, a.Tk, tid);
    stage(0);  // one group: the bias tile and batch row b0

    for (int i = 0; i < nb; ++i) {
      cp_async_wait_all();
      __syncthreads();  // row i is in; every warp is done with row i - 1
      if (i + 1 < nb) stage(i + 1);
      const int bh = (b0 + i) * a.H + h;
      const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem + (i & 1) * SB);
      const __nv_bfloat16* ks = qs + 2 * ROWS * KS + kw * KS;
      const int* ok_s = reinterpret_cast<const int*>(qs + 2 * (ROWS + KEYS) * KS);
      const float* ld_s = reinterpret_cast<const float*>(ok_s + KEYS);
      // this lane's rows' -lse log2 e and delta (zeros past Tq: never stored)
      const float nla = -ld_s[ra - q0] * kLog2e, nlb = -ld_s[rb - q0] * kLog2e;
      const float dela = ld_s[ROWS + ra - q0], delb = ld_s[ROWS + rb - q0];
      // the warp's real keys as bits, bit c <-> key kw + c of the tile
      uint64_t real64 = __ballot_sync(0xffffffffu, ok_s[kw + lane] != 0);
      if (WK > 32)
        real64 |= (uint64_t)__ballot_sync(0xffffffffu, ok_s[kw + 32 + lane] != 0) << 32;

      // the warp's WK keys in SUB-key parts kc .. kc + SUB - 1
#pragma unroll
      for (int kc = 0; kc < WK; kc += SUB) {
        const int c0 = k0 + kw + kc;  // the part's first key
        if (kCausal && c0 > w0 + 15) continue;  // every key is past this warp's rows
        // the part's live keys, bit c <-> column kc + 2t + c of this lane;
        // a part that crosses this warp's diagonal keeps col <= row
        const uint64_t real = real64 >> (kc + 2 * t);
        const bool diag = kCausal && c0 + SUB - 1 > w0;
        const uint64_t la = diag ? first_cols(real, ra - c0 - 2 * t + 1) : real;
        const uint64_t lb = diag ? first_cols(real, rb - c0 - 2 * t + 1) : real;

        // S = Q K^T and dP = dO V^T: rows ra, rb, columns j*8 + 2t + {0, 1}
        float s[1][NJ][4], dp[1][NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.0f;
          dp[0][j][0] = dp[0][j][1] = dp[0][j][2] = dp[0][j][3] = 0.0f;
        }
        mma_qk<1, NJ, NK, KS>(s, qs + wr * 16 * KS, ks + kc * KS, lane);
        mma_qk<1, NJ, NK, KS>(dp, qs + (ROWS + wr * 16) * KS, ks + (KEYS + kc) * KS, lane);

        // keep bits of n8 tile j as in dq: 0, 1 for row ra, 8, 9 for rb
        uint32_t keep[NJ];
        if (a.drop.on) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            keep[j] = keep4(bits4(a.drop, bh, (t & 2) ? rb : ra, c0 + j * 8 + 4 * (t & 1)),
                            a.drop.threshold)
                      << (4 * t);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            keep[j] |= __shfl_xor_sync(0xffffffffu, keep[j], 1);
            keep[j] |= __shfl_xor_sync(0xffffffffu, keep[j], 2);
            keep[j] >>= 2 * t;
          }
        }

        // acc += p (dp - delta), in batch order
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = kw + kc + j * 8 + 2 * t;  // the lane's first column in the tile
          const float2 ba = bias_pair<BIAS, KEYS>(bias_s, ra - q0, col);
          const float2 bb = bias_pair<BIAS, KEYS>(bias_s, rb - q0, col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + e;
            const float pa =
                (la >> c) & 1 ? bwd_p<true>(s[0][j][e], a.scale, e ? ba.y : ba.x, nla) : 0.0f;
            const float pb =
                (lb >> c) & 1 ? bwd_p<true>(s[0][j][2 + e], a.scale, e ? bb.y : bb.x, nlb) : 0.0f;
            float da = dp[0][j][e], db = dp[0][j][2 + e];
            if (a.drop.on) {
              da = (keep[j] >> e) & 1u ? da * a.drop.inv_keep : 0.0f;
              db = (keep[j] >> (8 + e)) & 1u ? db * a.drop.inv_keep : 0.0f;
            }
            acc[kc / 8 + j][e] += pa * (da - dela);
            acc[kc / 8 + j][2 + e] += pb * (db - delb);
          }
        }
      }
    }
  }

  float* o = out + ((long long)slice * a.H + h) * a.Tq * a.Tk;
  const bool pairs = (a.Tk & 1) == 0;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int key = k0 + kw + j * 8 + 2 * t;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = m ? rb : ra;
      if (row >= a.Tq) continue;
      float* p = o + (long long)row * a.Tk + key;
      if (pairs) {  // Tk even: key + 1 < Tk, and the pair is 8-byte aligned
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][2 * m], acc[j][2 * m + 1]);
      } else {
        p[0] = acc[j][2 * m];
        if (key + 1 < a.Tk) p[1] = acc[j][2 * m + 1];
      }
    }
  }
}

// dbias, fp32 (and bf16 at widths the mma path does not take): a
// register-tiled FMA kernel. (The first version gave a lane one key of a
// 32-key tile for 4 rows: two shared loads fed each FMA, each b's tiles
// waited on a barrier, and the generation path's decoder call filled 36
// blocks of 132 SMs; PERF.md has its times.)
//
// A block owns kDbRows query rows x 64 keys of one head and a contiguous
// slice of the batch, whose b it visits in order. Its 4 kDbRows threads
// form a grid (ty 0..15, tx < R4 = kDbRows / 4): a thread owns the keys
// 4ty .. 4ty+3 and the rows tx + R4 j (j < 4) of S^T = K Q^T and dP^T =
// V dO^T (tile_dots: per 4 columns 8 LDS.128 feed 64 FMAs) and sums ds =
// p (dp - delta) over b in 16 fp32 registers. Each b is 2 C units of a
// two-stage cp.async ring, C = ceil(D / 64): first the C 64-column chunks
// of q and k (S, then p = exp(s scale + bias - lse), which waits in
// shared memory), then those of do and v (dP, then ds), all into one
// 16-register accumulator. With the product and copy loops rolled and
// the dropout keep bits drawn into a 16-bit mask before the sum, the
// kernel fits 128 registers (two blocks an SM) without spilling; lse,
// delta and the key mask of each b ride with its first unit, and the next
// unit is in flight while one computes. The block's bias tile is read
// once into shared memory. (S, dP, the bias and the sum in registers
// together spilled 84 to 236 bytes; with one accumulator, 8.) A head has
// few tiles (the decoder call, T 128 causal: 3 live 64 x 64 tiles, 36
// blocks for 132 SMs), so the batch is cut into `slices` of `per` rows: each block
// writes its slice's [H, Tq, Tk] partial and dbias_reduce sums the
// partials in slice order. dbias_fma_cut picks the cut so that the grid holds
// about kDbSplitBlocks live blocks. Every sum
// keeps one order: the same bits on every run, no atomics. p uses expf,
// as in the FMA dq and dk/dv. Bound at the generation path's calls (B
// 16, H 12, D 64, fp32): the encoder's T 256 does 2 products, 3.2 GFLOP
// (0.048 ms at 67 TFLOP/s); the causal decoder's T 128 is bound by its
// bytes (0.008 ms).

constexpr int kDbKeys = 64;          // keys a block
constexpr int kDbRows = 64;          // query rows a block
constexpr int kDbChunk = 64;         // columns of D a ring unit holds
constexpr int kDbBiasRow = kDbKeys + 4;  // a staged bias row: 8 rows hit 8 bank groups
constexpr int kDbSplitBlocks = 528;  // live blocks the batch split aims for

template <int R>
__host__ __device__ constexpr int dbias_tile_smem_bytes() {
  // [2 stages][q or do [R][64]; k or v [64][64]]; the bias [R][68]; p
  // [16][4R]; [2][lse, delta [R]]; [2][mask [64]]
  return (2 * (R + kDbKeys) * kDbChunk + R * kDbBiasRow + 64 * R + 4 * R + 2 * kDbKeys) * 4;
}

// Rows r0 .. r0+NR-1 (zero past `rows`) and columns col0 .. col0+63 (zero
// past D) of a strided [rows, D] operand into a [NR][64] fp32 tile,
// swizzled with kSwz, by NT threads. As stage_tile: fp32 through cp.async
// (16 bytes a copy where `vec`, else 4; the caller commits), bf16 through
// registers.
template <typename T, int NR, int NT, bool kSwz>
__device__ __forceinline__ void stage_chunk(float* tile, const T* src, int r0, int rows,
                                            long long st, int col0, int D, bool vec, int tid) {
  constexpr int C4 = kDbChunk / 4;  // 16-byte chunks a row
  if constexpr (std::is_same<T, float>::value) {
    if (!vec) {
#pragma unroll 1
      for (int idx = tid; idx < NR * kDbChunk; idx += NT) {
        const int r = idx / kDbChunk, e = idx % kDbChunk, c = e >> 2;
        const int row = r0 + r, col = col0 + e;
        const bool in = row < rows && col < D;
        cp_async4(tile + r * kDbChunk + 4 * (kSwz ? swz(c, r) : c) + (e & 3),
                  in ? static_cast<const void*>(src + row * st + col) : src, in ? 4 : 0);
      }
      return;
    }
  }
#pragma unroll 1
  for (int idx = tid; idx < NR * C4; idx += NT) {
    const int r = idx / C4, c = idx % C4;
    const int row = r0 + r, col = col0 + 4 * c;
    const int cols = row < rows ? min(4, max(0, D - col)) : 0;
    float* dst = tile + r * kDbChunk + 4 * (kSwz ? swz(c, r) : c);
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(dst, cols ? static_cast<const void*>(src + row * st + col) : src, 4 * cols);
    } else {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = e < cols ? to_f(src[row * st + col + e]) : 0.0f;
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// One block: keys k0 .. k0+63 and rows q0 .. q0+R-1 of head h over the
// batch rows slice * per .. of its slice, into slice's [H, Tq, Tk] of
// `out` (dbias itself when the batch is not cut). In the causal build a
// tile wholly above the diagonal writes zeros, so every element is
// written once. The bf16 instances (no main path) have no register cap.
template <typename T, int R, bool kCausal>
__global__ void __launch_bounds__(4 * R, sizeof(T) == 4 ? (R == 64 ? 2 : 4) : 1)
    flash_dbias_scalar(BwdArgs a, float* out, int per) {
  constexpr int R4 = R / 4;
  constexpr int NT = 4 * R;
  constexpr int SF = (R + kDbKeys) * kDbChunk;  // floats of a ring stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [2][q or do [R][64], k or v [64][64]]
  float* bias_s = ring + 2 * SF;                  // [R][kDbBiasRow]
  float* p_s = bias_s + R * kDbBiasRow;           // [16][NT]: each thread's p, i-major
  float* ld_s = p_s + 16 * NT;                    // [2][lse [R], delta [R]]
  int* ok_s = reinterpret_cast<int*>(ld_s + 4 * R);  // [2][64]: the keys' mask

  const int tid = threadIdx.x;
  const int tx = tid % R4, ty = tid / R4;
  const int h = blockIdx.z % a.H, slice = blockIdx.z / a.H;
  const int k0 = blockIdx.x * kDbKeys, q0 = blockIdx.y * R;
  const int key0 = k0 + 4 * ty;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  if (!kCausal || k0 < q0 + R) {  // else wholly above the diagonal: ds is 0
    const bool diag = kCausal && k0 + kDbKeys > q0;  // crosses the diagonal
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // this thread's bias elements, the same for every b
      float bv[4];
      bias4(a.bias, h, q0 + tx + R4 * j, key0, a.Tq, a.Tk, bv);
      *reinterpret_cast<float4*>(bias_s + (tx + R4 * j) * kDbBiasRow + 4 * ty) =
          make_float4(bv[0], bv[1], bv[2], bv[3]);
    }
    const int b0 = slice * per;
    const int chunks = (a.D + kDbChunk - 1) / kDbChunk;
    const int units = min(per, a.B - b0) * 2 * chunks;
    // unit u of batch row b0 + u / (2 chunks), in stage u & 1: the q and k
    // chunk c, or (c >= chunks) the do and v chunk c - chunks
    auto issue = [&](int u) {
      const int b = b0 + u / (2 * chunks), c = u % (2 * chunks);
      const bool dp_part = c >= chunks;
      const int col0 = (dp_part ? c - chunks : c) * kDbChunk;
      float* st = ring + (u & 1) * SF;
      if (dp_part) {
        stage_chunk<T, R, NT, true>(st, strip<T>(a.dout, a.sdo, b, h), q0, a.Tq, a.sdo.t, col0,
                                    a.D, a.vec, tid);
        stage_chunk<T, kDbKeys, NT, false>(st + R * kDbChunk, strip<T>(a.v, a.sv, b, h), k0,
                                           a.Tk, a.sv.t, col0, a.D, a.vec, tid);
      } else {
        stage_chunk<T, R, NT, true>(st, strip<T>(a.q, a.sq, b, h), q0, a.Tq, a.sq.t, col0, a.D,
                                    a.vec, tid);
        stage_chunk<T, kDbKeys, NT, false>(st + R * kDbChunk, strip<T>(a.k, a.sk, b, h), k0,
                                           a.Tk, a.sk.t, col0, a.D, a.vec, tid);
      }
      if (c == 0) {  // NT >= 2R + 64 threads: lse, delta, the mask
        const int m = b & 1;
        const long long lrow = ((long long)b * a.H + h) * a.Tq + q0;
        if (tid < 2 * R) {
          const int r = tid % R;
          const float* src = tid < R ? a.lse : a.delta;
          const bool in = q0 + r < a.Tq;
          cp_async4(ld_s + m * 2 * R + tid, in ? src + lrow + r : src, in ? 4 : 0);
        } else if (tid < 2 * R + kDbKeys) {
          const int kc = tid - 2 * R;
          const int* maskp = a.mask + (long long)b * a.Tk;
          const bool in = k0 + kc < a.Tk;
          cp_async4(ok_s + m * kDbKeys + kc, in ? maskp + k0 + kc : maskp, in ? 4 : 0);
        }
      }
      cp_async_commit();
    };

    // one accumulator serves both products: S, then (p gone to p_s) dP
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.0f;
    }
    if (units > 0) issue(0);
    for (int u = 0; u < units; ++u) {
      cp_async_wait_all();
      __syncthreads();  // unit u is in; every thread is done with unit u - 1
      if (u + 1 < units) issue(u + 1);
      const float* st = ring + (u & 1) * SF;
      const int c = u % (2 * chunks);
      // the chunk's 16-column groups that hold columns of D, a count known
      // only at run time: the product loop stays rolled
      const int n16 = min(kDbChunk / 16, (a.D - (c % chunks) * kDbChunk + 15) / 16);
      // S^T = K Q^T (c < chunks), then dP^T = V dO^T
      tile_dots<kDbChunk, R4>(x, st + (R + 4 * ty) * kDbChunk, st + tx * kDbChunk, tx & 7, n16);
      if (c % chunks != chunks - 1) continue;
      const int b = b0 + u / (2 * chunks), m = b & 1;
      if (c < chunks) {
        // S is complete: p into p_s, x back to 0
        const int4 okq = *reinterpret_cast<const int4*>(ok_s + m * kDbKeys + 4 * ty);
        const int ok[4] = {okq.x, okq.y, okq.z, okq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + R4 * j;
          const bool rin = row < a.Tq;
          const float lse = ld_s[m * 2 * R + tx + R4 * j];
          const float4 bq =
              *reinterpret_cast<const float4*>(bias_s + (tx + R4 * j) * kDbBiasRow + 4 * ty);
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool live = ok[i] != 0 && rin && (!diag || key0 + i <= row);
            p_s[(4 * i + j) * NT + tid] = live ? expf(x[i][j] * a.scale + bv[i] - lse) : 0.0f;
            x[i][j] = 0.0f;
          }
        }
        continue;
      }
      // dP is complete: acc += p (dp - delta), in batch order; the keep
      // bits first (bit 4j + i: element (i, j) is kept)
      unsigned keep = 0xffffu;
      if (a.drop.on) {
        const int bh = b * a.H + h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + R4 * j;
          if (row >= a.Tq) continue;
          const uint4 w = bits4(a.drop, bh, row, key0);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (word(w, i) >= a.drop.threshold) keep &= ~(1u << (4 * j + i));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float del = ld_s[m * 2 * R + R + tx + R4 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float d = x[i][j];
          if (a.drop.on) d = (keep >> (4 * j + i)) & 1u ? d * a.drop.inv_keep : 0.0f;
          acc[i][j] += p_s[(4 * i + j) * NT + tid] * (d - del);
          x[i][j] = 0.0f;
        }
      }
    }
  }

  float* o = out + ((long long)slice * a.H + h) * a.Tq * a.Tk;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = q0 + tx + R4 * j;
    if (row >= a.Tq) continue;
    float* orow = o + (long long)row * a.Tk;
    if ((a.Tk & 3) == 0 && key0 < a.Tk) {
      *reinterpret_cast<float4*>(orow + key0) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (key0 + i < a.Tk) orow[key0 + i] = acc[i][j];
    }
  }
}

// dbias = the sum of the [slices, count] partials (count = H Tq Tk), in
// slice order; a thread sums 4 elements
__global__ void dbias_reduce(const float* __restrict__ part, float* __restrict__ out,
                             long long count, int slices) {
  const long long i0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i0 >= count) return;
  if ((count & 3) == 0) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < slices; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + s * count + i0);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(out + i0) = acc;
    return;
  }
  for (long long i = i0; i < min(count, i0 + 4); ++i) {
    float acc = 0.0f;
    for (int s = 0; s < slices; ++s) acc += part[s * count + i];
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// launches: this build's instances are the causal ones (FLASH_CAUSAL=1) or
// the non-causal ones

#ifndef FLASH_CAUSAL
#define FLASH_CAUSAL 0
#endif
constexpr bool kCausalBuild = FLASH_CAUSAL != 0;



// a kernel with `bytes` of dynamic shared memory (allow_smem)
template <typename K, typename A>
cudaError_t launch_smem(K kernel, dim3 grid, int threads, int bytes, const A& a, cudaStream_t s) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// the tensor-core forward: the grid is (b*h, q tiles), so that with causal
// the q tiles counted from the last one start first for every head
template <int D>
cudaError_t launch_fwd_mma(const Args& a, cudaStream_t s) {
  using L = FwdMmaLayout<D, kCausalBuild>;
  constexpr int R = L::kRows, WR = L::kWarpRows, NT = R / WR * 32;
  const dim3 grid(a.B * a.H, (a.Tq + R - 1) / R);
  const int bytes = fwd_mma_smem_bytes<D>(R, a.bias);
  if (!a.bias.p)
    return launch_smem(flash_fwd_bf16_mma<D, R, WR, 0, kCausalBuild>, grid, NT, bytes, a, s);
  if (a.bias.bf16)
    return launch_smem(flash_fwd_bf16_mma<D, R, WR, 2, kCausalBuild>, grid, NT, bytes, a, s);
  return launch_smem(flash_fwd_bf16_mma<D, R, WR, 4, kCausalBuild>, grid, NT, bytes, a, s);
}

// the tensor-core dq and dk/dv: the grid is (b*h, q or key tiles); the
// causal dq takes its q tiles from the last one down, and dk/dv's first
// key tiles hold the most q tiles
template <int D>
cudaError_t launch_dq_mma(const BwdArgs& a, cudaStream_t s) {
  constexpr int R = BwdMmaLayout<D, kCausalBuild>::kDqRows, NT = R * 2;
  const dim3 grid(a.B * a.H, (a.Tq + R - 1) / R);
  const int bytes = dq_mma_smem_bytes<D>(R, a.bias);
  if (!a.bias.p) return launch_smem(flash_dq_bf16_mma<D, 0, kCausalBuild>, grid, NT, bytes, a, s);
  if (a.bias.bf16)
    return launch_smem(flash_dq_bf16_mma<D, 2, kCausalBuild>, grid, NT, bytes, a, s);
  return launch_smem(flash_dq_bf16_mma<D, 4, kCausalBuild>, grid, NT, bytes, a, s);
}

template <int D>
cudaError_t launch_dkv_mma(const BwdArgs& a, cudaStream_t s) {
  constexpr int K = BwdMmaLayout<D, kCausalBuild>::kDkvKeys, NT = K * 2;
  const dim3 grid(a.B * a.H, (a.Tk + K - 1) / K);
  const int bytes = dkv_mma_smem_bytes<D>(K, a.bias);
  if (!a.bias.p) return launch_smem(flash_dkv_bf16_mma<D, 0, kCausalBuild>, grid, NT, bytes, a, s);
  if (a.bias.bf16)
    return launch_smem(flash_dkv_bf16_mma<D, 2, kCausalBuild>, grid, NT, bytes, a, s);
  return launch_smem(flash_dkv_bf16_mma<D, 4, kCausalBuild>, grid, NT, bytes, a, s);
}

// the FMA kernels: KS 64 for D <= 64 (two blocks an SM), else 128
template <typename K, typename A>
cudaError_t launch_tiled(K kernel, dim3 grid, int bytes, const A& a, cudaStream_t s) {
  return launch_smem(kernel, grid, kTileThreads, bytes, a, s);
}

// the FMA forward: the grid is (h, b, q tiles), the causal build's q
// tiles counted from the last one
template <int KS>
cudaError_t launch_fwd_tiled(const Args& a, int bf16, cudaStream_t s) {
  const dim3 grid(a.H, a.B, (a.Tq + kTileRows - 1) / kTileRows);
  constexpr int bytes = fwd_tile_smem_bytes<KS>();
  if (bf16)
    return launch_tiled(flash_fwd_scalar<__nv_bfloat16, KS, kCausalBuild>, grid, bytes, a, s);
  return launch_tiled(flash_fwd_scalar<float, KS, kCausalBuild>, grid, bytes, a, s);
}

template <int KS>
cudaError_t launch_dq_tiled(const BwdArgs& a, int bf16, cudaStream_t s) {
  const dim3 grid((a.Tq + kTileRows - 1) / kTileRows, a.H, a.B);
  constexpr int bytes = dq_tile_smem_bytes<KS>();
  if (bf16)
    return launch_tiled(flash_dq_scalar<__nv_bfloat16, KS, kCausalBuild>, grid, bytes, a, s);
  return launch_tiled(flash_dq_scalar<float, KS, kCausalBuild>, grid, bytes, a, s);
}

template <int KS>
cudaError_t launch_dkv_tiled(const BwdArgs& a, int bf16, cudaStream_t s) {
  const dim3 grid((a.Tk + kTileRows - 1) / kTileRows, a.H, a.B);
  constexpr int bytes = dkv_tile_smem_bytes<KS>();
  if (bf16)
    return launch_tiled(flash_dkv_scalar<__nv_bfloat16, KS, kCausalBuild>, grid, bytes, a, s);
  return launch_tiled(flash_dkv_scalar<float, KS, kCausalBuild>, grid, bytes, a, s);
}

// A dbias cut of the batch: `slices` contiguous runs of `per` rows (the
// last may be shorter), a block each. The cut is the smallest power of
// two (at most about B) that puts `target` live blocks of rows x keys
// tiles on the card; a causal tile wholly above the diagonal is not live.
// One slice keeps the whole batch in each block.
struct DbiasCut {
  int slices, per;
};

DbiasCut dbias_cut(int B, int H, int Tq, int Tk, int rows, int keys, int target) {
  const int n_q = (Tq + rows - 1) / rows, n_k = (Tk + keys - 1) / keys;
  long long tiles = (long long)n_q * n_k;
  if (kCausalBuild) {  // key tile c is live for the q tile r if keys c < rows (r + 1)
    tiles = 0;
    for (int r = 0; r < n_q; ++r) {
      const int live = (rows * (r + 1) + keys - 1) / keys;
      tiles += live < n_k ? live : n_k;
    }
  }
  int want = 1;
  while (want < B && (long long)want * H * tiles < target) want *= 2;
  const int per = (B + want - 1) / want;
  return {(B + per - 1) / per, per};
}

// the FMA dbias's cut (kDbSplitBlocks live blocks of its 64 x 64 tiles)
DbiasCut dbias_fma_cut(int B, int H, int Tq, int Tk) {
  return dbias_cut(B, H, Tq, Tk, kDbRows, kDbKeys, kDbSplitBlocks);
}

// the tensor-core dbias's cut at head width D
template <int D>
DbiasCut dbias_mma_cut(int B, int H, int Tq, int Tk) {
  using L = DbiasMmaLayout<D, kCausalBuild>;
  return dbias_cut(B, H, Tq, Tk, L::kRows, L::kKeys, kDbMmaSplitBlocks);
}

// with slices > 1, dbias = the slices' partials in `work`, summed in order
cudaError_t reduce_dbias(const BwdArgs& a, const float* work, int slices, cudaStream_t s) {
  const long long count = (long long)a.H * a.Tq * a.Tk;
  dbias_reduce<<<(unsigned)((count + 1023) / 1024), 256, 0, s>>>(work, a.dbias, count, slices);
  return cudaGetLastError();
}

// the FMA dbias: the grid is (key tiles, q tiles, slices x H); with
// slices > 1 the blocks write their partials to `work`, and dbias_reduce
// sums them into dbias
template <typename T>
cudaError_t launch_dbias_tiled(const BwdArgs& a, float* work, cudaStream_t s) {
  constexpr int R = kDbRows;
  const DbiasCut cut = dbias_fma_cut(a.B, a.H, a.Tq, a.Tk);
  const int slices = cut.slices;
  if (slices > 1 && work == nullptr) return cudaErrorInvalidValue;
  auto kernel = flash_dbias_scalar<T, R, kCausalBuild>;
  constexpr int bytes = dbias_tile_smem_bytes<R>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kDbKeys - 1) / kDbKeys, (a.Tq + R - 1) / R, a.H * slices);
  kernel<<<grid, 4 * R, bytes, s>>>(a, slices > 1 ? work : a.dbias, cut.per);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  return reduce_dbias(a, work, slices, s);
}

// the tensor-core dbias: the grid is (key tiles, q tiles, slices x H), as
// the FMA dbias's
template <int D>
cudaError_t launch_dbias_mma(const BwdArgs& a, cudaStream_t s, float* work) {
  using L = DbiasMmaLayout<D, kCausalBuild>;
  const DbiasCut cut = dbias_mma_cut<D>(a.B, a.H, a.Tq, a.Tk);
  if (cut.slices > 1 && work == nullptr) return cudaErrorInvalidValue;
  auto kernel = a.bias.bf16 ? flash_dbias_bf16_mma<D, 2, kCausalBuild>
                            : flash_dbias_bf16_mma<D, 4, kCausalBuild>;
  const int bytes = dbias_mma_smem_bytes<D>(L::kRows, L::kKeys, a.bias);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + L::kKeys - 1) / L::kKeys, (a.Tq + L::kRows - 1) / L::kRows,
                  a.H * cut.slices);
  kernel<<<grid, dbias_mma_threads<D, kCausalBuild>(), bytes, s>>>(
      a, cut.slices > 1 ? work : a.dbias, cut.per);
  err = cudaGetLastError();
  if (err != cudaSuccess || cut.slices == 1) return err;
  return reduce_dbias(a, work, cut.slices, s);
}

// dispatch on the head width of the tensor-core instances
template <template <int> class L, typename A, typename... X>
cudaError_t by_width(int D, const A& a, cudaStream_t s, X... x) {
  switch (D) {
    case 16: return L<16>::run(a, s, x...);
    case 32: return L<32>::run(a, s, x...);
    case 48: return L<48>::run(a, s, x...);
    case 64: return L<64>::run(a, s, x...);
    case 80: return L<80>::run(a, s, x...);
    case 96: return L<96>::run(a, s, x...);
    case 112: return L<112>::run(a, s, x...);
    case 128: return L<128>::run(a, s, x...);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
struct FwdMma {
  static cudaError_t run(const Args& a, cudaStream_t s) { return launch_fwd_mma<D>(a, s); }
};
template <int D>
struct DqMma {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) { return launch_dq_mma<D>(a, s); }
};
template <int D>
struct DkvMma {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) { return launch_dkv_mma<D>(a, s); }
};
template <int D>
struct DbiasMma {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s, float* work) {
    return launch_dbias_mma<D>(a, s, work);
  }
};
// the tensor-core dbias's cut at D (as `run`, for by_width; not a launch)
template <int D>
struct DbiasMmaSlices {
  static cudaError_t run(const BwdArgs& a, cudaStream_t, int* slices) {
    *slices = dbias_mma_cut<D>(a.B, a.H, a.Tq, a.Tk).slices;
    return cudaSuccess;
  }
};

bool bad_problem(int B, int H, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > kMaxD ||
         (long long)B * H > 65535 ||  // gridDim.y
         (kCausalBuild && Tq != Tk);  // causal is the square self-attention
}

Bias make_bias(const void* p, int bf16, long long sh, long long st) {
  Bias b;
  b.p = p;
  b.bf16 = bf16;
  b.vec = reinterpret_cast<uintptr_t>(p) % (bf16 ? 8 : 16) == 0 && sh % 4 == 0 && st % 4 == 0;
  const int per16 = bf16 ? 8 : 4;  // elements in 16 bytes
  b.vec16 = reinterpret_cast<uintptr_t>(p) % 16 == 0 && sh % per16 == 0 && st % per16 == 0;
  b.sh = sh;
  b.st = st;
  return b;
}

// every row of the operand starts 16-byte aligned (fp32: element strides
// that are multiples of 4 from a 16-byte aligned pointer)
bool rows_aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
         s.t % 4 == 0;
}

Drop make_drop(int on, unsigned threshold, float inv_keep, unsigned long long seed) {
  Drop d;
  d.on = on;
  d.threshold = threshold;
  d.inv_keep = inv_keep;
  d.key0 = (uint32_t)(seed & 0xffffffffull);
  d.key1 = (uint32_t)(seed >> 32);
  return d;
}

void fill_bwd(BwdArgs& a, const void* q, const void* k, const void* v, const int* mask,
              const float* lse, const float* delta, const void* dout, int B, int H, int Tq,
              int Tk, int D, float scale, Drop drop) {
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.lse = lse;
  a.delta = delta;
  a.dout = dout;
  a.dq = a.dk = a.dv = nullptr;
  a.dbias = nullptr;
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.D = D;
  a.vec = 0;
  a.n16 = 0;
  a.scale = scale;
  a.drop = drop;
}

// what the FMA dq and dk/dv read besides the problem: the alignment of
// the operands' rows and D's 16-column groups
void set_tile_args(BwdArgs& a) {
  a.vec = rows_aligned16(a.q, a.sq) && rows_aligned16(a.k, a.sk) && rows_aligned16(a.v, a.sv) &&
          rows_aligned16(a.dout, a.sdo);
  a.n16 = (a.D + 15) / 16;
}

}  // namespace

extern "C" {

// Query rows per block of the forward's tensor-core (1, at D 64) and FMA
// (0) instances.
int flash_fwd_tile_rows(int use_mma) {
  return use_mma ? FwdMmaLayout<64, kCausalBuild>::kRows : kTileRows;
}

// Widest head the kernels take.
int flash_fwd_max_head_dim() { return kMaxD; }

// 1 if this library holds the causal instances (FLASH_CAUSAL=1), else 0.
int flash_causal() { return kCausalBuild ? 1 : 0; }

// One forward call. q, k, v, o, mask and lse are device pointers; strides
// is a host array of 14 element strides: (batch, head, token) of q, k, v
// and o, whose innermost dimension is contiguous, then the bias's (head,
// row) strides. bias is a device pointer to the [H, Tq, Tk] score bias
// (bf16 if bias_bf16, else fp32) or null. dtype_bf16 selects bf16 (else
// fp32) for q, k, v and o; lse is fp32 [B, H, Tq]; mask is int32 [B, Tk].
// use_mma takes the tensor-core path (bf16, D % 16 == 0, 16-byte aligned
// pointers, strides multiples of 8). dropout != 0 drops the numerator
// with keep = bits < keep_threshold, scaled by inv_keep, the bits drawn
// from Philox keyed by seed. Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
              const void* bias, int bias_bf16, int B, int H, int Tq, int Tk, int D, float scale,
              int dtype_bf16, int use_mma, int dropout, unsigned keep_threshold, float inv_keep,
              unsigned long long seed, const long long* strides, void* stream) {
  if (bad_problem(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o = o;
  a.lse = lse;
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.D = D;
  a.vec = 0;
  a.n16 = 0;
  a.scale = scale;
  a.drop = make_drop(dropout, keep_threshold, inv_keep, seed);
  a.bias = make_bias(bias, bias_bf16, strides[12], strides[13]);
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.so = Strides{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!dtype_bf16) return (int)cudaErrorInvalidValue;
    return (int)by_width<FwdMma>(D, a, s);
  }
  a.vec = rows_aligned16(q, a.sq) && rows_aligned16(k, a.sk) && rows_aligned16(v, a.sv);
  a.n16 = (D + 15) / 16;
  return (int)(D <= 64 ? launch_fwd_tiled<64>(a, dtype_bf16, s)
                       : launch_fwd_tiled<128>(a, dtype_bf16, s));
}

// dq of one backward call (kernel 6). lse and delta are fp32 [B, H, Tq];
// strides holds 17 element strides: (batch, head, token) of q, k, v, do
// and dq, then the bias's (head, row). The rest as for flash_fwd.
int flash_dq(const void* q, const void* k, const void* v, const int* mask, const float* lse,
             const float* delta, const void* dout, void* dq, const void* bias, int bias_bf16,
             int B, int H, int Tq, int Tk, int D, float scale, int dtype_bf16, int use_mma,
             int dropout, unsigned keep_threshold, float inv_keep, unsigned long long seed,
             const long long* strides, void* stream) {
  if (bad_problem(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  fill_bwd(a, q, k, v, mask, lse, delta, dout, B, H, Tq, Tk, D, scale,
           make_drop(dropout, keep_threshold, inv_keep, seed));
  a.dq = dq;
  a.bias = make_bias(bias, bias_bf16, strides[15], strides[16]);
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.sdo = Strides{strides[9], strides[10], strides[11]};
  a.sdq = Strides{strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!dtype_bf16) return (int)cudaErrorInvalidValue;
    return (int)by_width<DqMma>(D, a, s);
  }
  set_tile_args(a);
  return (int)(D <= 64 ? launch_dq_tiled<64>(a, dtype_bf16, s)
                       : launch_dq_tiled<128>(a, dtype_bf16, s));
}

// dk and dv of one backward call (kernel 7). strides holds 20 element
// strides: (batch, head, token) of q, k, v, do, dk and dv, then the
// bias's (head, row).
int flash_dkv(const void* q, const void* k, const void* v, const int* mask, const float* lse,
              const float* delta, const void* dout, void* dk, void* dv, const void* bias,
              int bias_bf16, int B, int H, int Tq, int Tk, int D, float scale, int dtype_bf16,
              int use_mma, int dropout, unsigned keep_threshold, float inv_keep,
              unsigned long long seed, const long long* strides, void* stream) {
  if (bad_problem(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  fill_bwd(a, q, k, v, mask, lse, delta, dout, B, H, Tq, Tk, D, scale,
           make_drop(dropout, keep_threshold, inv_keep, seed));
  a.dk = dk;
  a.dv = dv;
  a.bias = make_bias(bias, bias_bf16, strides[18], strides[19]);
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.sdo = Strides{strides[9], strides[10], strides[11]};
  a.sdk = Strides{strides[12], strides[13], strides[14]};
  a.sdv = Strides{strides[15], strides[16], strides[17]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!dtype_bf16) return (int)cudaErrorInvalidValue;
    return (int)by_width<DkvMma>(D, a, s);
  }
  set_tile_args(a);
  return (int)(D <= 64 ? launch_dkv_tiled<64>(a, dtype_bf16, s)
                       : launch_dkv_tiled<128>(a, dtype_bf16, s));
}

// Floats of the dbias workspace (kernel 8): the [slices, H, Tq, Tk]
// partials of its cut batch, 0 when it is not cut; use_mma: the
// tensor-core instance at head width D, else the FMA one.
long long flash_dbias_workspace_floats(int B, int H, int Tq, int Tk, int D, int use_mma) {
  int slices = 1;
  if (!use_mma) {
    slices = dbias_fma_cut(B, H, Tq, Tk).slices;
  } else {
    BwdArgs a;
    a.B = B;
    a.H = H;
    a.Tq = Tq;
    a.Tk = Tk;
    if (by_width<DbiasMmaSlices>(D, a, nullptr, &slices) != cudaSuccess) slices = 1;
  }
  return slices > 1 ? (long long)slices * H * Tq * Tk : 0;
}

// dbias of one backward call (kernel 8): dbias [H, Tq, Tk] fp32
// contiguous, the batch sum of ds. bias is required (the scores are
// recomputed with it); strides holds 14 element strides: (batch, head,
// token) of q, k, v and do, then the bias's (head, row). Either instance
// may cut the batch and sum the cut's partials in slice order: work holds
// flash_dbias_workspace_floats(B, H, Tq, Tk, D, use_mma) floats (NULL when
// that is 0). The rest as for flash_dq.
int flash_dbias(const void* q, const void* k, const void* v, const int* mask, const float* lse,
                const float* delta, const void* dout, const void* bias, int bias_bf16,
                float* dbias, float* work, int B, int H, int Tq, int Tk, int D, float scale,
                int dtype_bf16, int use_mma, int dropout, unsigned keep_threshold,
                float inv_keep, unsigned long long seed, const long long* strides,
                void* stream) {
  if (bad_problem(B, H, Tq, Tk, D) || bias == nullptr) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  fill_bwd(a, q, k, v, mask, lse, delta, dout, B, H, Tq, Tk, D, scale,
           make_drop(dropout, keep_threshold, inv_keep, seed));
  a.dbias = dbias;
  a.bias = make_bias(bias, bias_bf16, strides[12], strides[13]);
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.sdo = Strides{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!dtype_bf16) return (int)cudaErrorInvalidValue;
    return (int)by_width<DbiasMma>(D, a, s, work);
  }
  set_tile_args(a);
  return (int)(dtype_bf16 ? launch_dbias_tiled<__nv_bfloat16>(a, work, s)
                          : launch_dbias_tiled<float>(a, work, s));
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
