// The GGNN forward for NVIDIA Hopper (sm_90a): kernel 1, one message-
// passing step under the fp32, bf16 and int8 message policies, and
// kernel 2, every step of the unroll in one cooperative launch.
//
// Replaces the TPU kernels deepdfa_tpu/nn/ggnn_kernel.py:_fwd_kernel
// (launched by _fwd_call; body in _block_aggregate, _edge_messages,
// _aggregate, _gru) and _fused_kernel (launched by _fused_call), both
// with the "fold" scatter. Per step it computes, for every node v of
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
// warp owns kNodesPerWarp nodes (`step_tile`):
//   1. it stages its rows of h in shared memory;
//   2. per edge type, each node sums coef * row over its run in edge
//      order (one column per lane, no atomics: deterministic), with row
//      the policy's message-side row (h; bf16(h); q(h)) and coef = w
//      (int8: w * s(h_src)); then applies the policy's Wm_t (and ws_t)
//      and c * bm_t, c = sum w, once per node. By linearity this costs
//      N*d^2 per type instead of E*d^2: a reassociation of the
//      reference's per-edge sum. It keeps the message side's rounding:
//      the rows are rounded (bf16) or quantized (int8) before the sum,
//      never the sum itself;
//   3. it computes gx = a @ Wih + bih and gh = h @ Whh + bhh column by
//      column and applies the gates.
// Warps share nothing, so there is no block-wide barrier. Every sum is
// an IEEE fp32 FMA loop (no tensor cores, no TF32), and every other
// rounding step is an explicit _rn intrinsic, so the compiler cannot
// contract it differently in the two kernels that run the body.
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
// state plane the same way). int8 quantizes each row once per step in
// the GRU epilogue of the step that writes it, into one of two shadow
// tables (one read, one written), and the initial state before step 0:
// one barrier per step. The state planes and shadow tables are written
// inside the launch, so the body reads them with L2-only loads (__ldcg)
// and never through the non-coherent read-only path that kernel 1 uses
// (__ldg). It is bit-equal to n_steps launches of kernel 1 because both
// run the same step_tile and the same quant_row.
//
// Bound on this card. One flagship step (N 16384, d 128, T 1) does
// 2*N*d^2*T + 12*N*d^2 ~ 3.8 GFLOP against ~16 MB of node state moved,
// so it is bound by fp32 operations (67 TFLOP/s). The GRU products
// dominate. Their weights, [d, 3d] twice, are streamed from L2 by every
// warp; each weight load feeds 8 nodes' FMAs, and the state rows are read
// from shared memory as float4 broadcasts. The bf16/int8 policies cut
// the gather's bytes, not the operations, so they are no faster here;
// tensor-core (wgmma) tiles are the next step for speed. Kernel 2 saves
// the launches and the host round trips between steps, not operations.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNodesPerWarp = 8;
constexpr int kTileNodes = kWarps * kNodesPerWarp;  // nodes per tile (block)

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
// [in, out]); ws its per-channel scales [n_etypes, D] (int8 only).
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
};

// One step for the kNodesPerWarp nodes of this warp in tile `tile`.
//   h_in    [n, D] f32 state (staged rows; the GRU's h);
//   table   [n, D] message-side rows: TableT float (fp32; bf16 rounds
//           them here) or the policy's own type; tscale [n] row scales
//           (int8);
//   h_out, a_out (nullable), chain (nullable: this step's input rows),
//   q_next/s_next (nullable, int8: quantize h' into the next table).
// Not inlined: compiled as a function of its own, the body keeps kernel
// 1's schedule inside kernel 2's step and tile loops. Inlined there, the
// compiler gave it fewer registers and kernel 2's steps ran ~20% slower
// than kernel 1's at the flagship (PERF.md, findings on kernel 2).
template <int D, int P, bool kCoherent, class TableT>
__device__ __noinline__ void step_tile(const StepArgs a, float* smem, int tile,
                                          const float* h_in, const TableT* table,
                                          const float* tscale, float* h_out, float* a_out,
                                          float* chain, int8_t* q_next, float* s_next) {
  using W = typename Msg<P>::T;
  constexpr int C = D / 32;  // columns per lane
  const int n = a.n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kNodesPerWarp;  // this warp's first tile row
  const int v0 = tile * kTileNodes + row0;
  // this warp's slices: h rows, sum(coef * row) rows (later h' rows),
  // aggregate rows, sum(w)
  float* hs = smem + row0 * D;
  float* ss = smem + kTileNodes * D + row0 * D;
  float* as = smem + 2 * kTileNodes * D + row0 * D;
  float* cs = smem + 3 * kTileNodes * D + row0;

  for (int r = 0; r < kNodesPerWarp; ++r) {
    const int v = v0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      const float x = v < n ? load<kCoherent>(h_in + (size_t)v * D + j) : 0.0f;
      hs[r * D + j] = x;
      if (chain != nullptr && v < n) chain[(size_t)v * D + j] = x;
    }
  }

  for (int t = 0; t < a.n_etypes; ++t) {
    const float* wt = a.w2 + (size_t)t * a.e;
    // 2. sum each node's run in edge order
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
      float cw = 0.0f;
      if (v < n) {
        const int e1 = __ldg(a.rowptr + v + 1);
        for (int k = __ldg(a.rowptr + v); k < e1; ++k) {
          const float w = __ldg(wt + k);
          if (w != 0.0f) {
            const int u = __ldg(a.src + k);
            float coef = w;
            if constexpr (P == kI8) coef = __fmul_rn(w, load<kCoherent>(tscale + u));
            const TableT* row = table + (size_t)u * D + lane;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float x = to_float(load<kCoherent>(row + c * 32));
              if constexpr (P == kBF16 && sizeof(TableT) == 4) x = round_bf16(x);
              acc[c] = fmaf(coef, x, acc[c]);
            }
            cw = __fadd_rn(cw, w);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) ss[r * D + c * 32 + lane] = acc[c];
      if (lane == 0) cs[r] = cw;
    }
    __syncwarp();
    // ... then apply the policy's Wm_t (and ws_t) and c * bm_t once per
    // node; a accumulates over types
    const W* wmt = static_cast<const W*>(a.wm) + (size_t)t * D * D;
    const float* bmt = a.bm + (size_t)t * D;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      float acc[kNodesPerWarp];
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) acc[r] = 0.0f;
      for (int k = 0; k < D; k += 4) {
        float wq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wq[q] = to_float(__ldg(wmt + (k + q) * D + j));
#pragma unroll
        for (int r = 0; r < kNodesPerWarp; ++r) {
          const float4 s = *reinterpret_cast<const float4*>(ss + r * D + k);
          acc[r] = fmaf(s.x, wq[0], acc[r]);
          acc[r] = fmaf(s.y, wq[1], acc[r]);
          acc[r] = fmaf(s.z, wq[2], acc[r]);
          acc[r] = fmaf(s.w, wq[3], acc[r]);
        }
      }
      const float b = __ldg(bmt + j);
      float wsj = 1.0f;
      if constexpr (P == kI8) wsj = __ldg(a.ws + (size_t)t * D + j);
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const float m = P == kI8 ? __fmul_rn(acc[r], wsj) : acc[r];
        const float val = __fmaf_rn(cs[r], b, m);
        as[r * D + j] = t == 0 ? val : __fadd_rn(as[r * D + j], val);
      }
    }
    __syncwarp();
  }

  // 3. GRU: gx = a @ Wih + bih, gh = h @ Whh + bhh, gates r, z, n
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    float xr[kNodesPerWarp], xz[kNodesPerWarp], xn[kNodesPerWarp];
    float hr[kNodesPerWarp], hz[kNodesPerWarp], hn[kNodesPerWarp];
#pragma unroll
    for (int r = 0; r < kNodesPerWarp; ++r) {
      xr[r] = xz[r] = xn[r] = 0.0f;
      hr[r] = hz[r] = hn[r] = 0.0f;
    }
    for (int k = 0; k < D; k += 4) {
      float ir[4], iz[4], in_[4], gr[4], gz[4], gn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t row = (size_t)(k + q) * 3 * D;
        ir[q] = __ldg(a.wih + row + j);
        iz[q] = __ldg(a.wih + row + D + j);
        in_[q] = __ldg(a.wih + row + 2 * D + j);
        gr[q] = __ldg(a.whh + row + j);
        gz[q] = __ldg(a.whh + row + D + j);
        gn[q] = __ldg(a.whh + row + 2 * D + j);
      }
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + r * D + k);
        const float4 h4 = *reinterpret_cast<const float4*>(hs + r * D + k);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xr[r] = fmaf(av[q], ir[q], xr[r]);
          xz[r] = fmaf(av[q], iz[q], xz[r]);
          xn[r] = fmaf(av[q], in_[q], xn[r]);
          hr[r] = fmaf(hv[q], gr[q], hr[r]);
          hz[r] = fmaf(hv[q], gz[q], hz[r]);
          hn[r] = fmaf(hv[q], gn[q], hn[r]);
        }
      }
    }
    const float b_ir = __ldg(a.bih + j), b_iz = __ldg(a.bih + D + j), b_in = __ldg(a.bih + 2 * D + j);
    const float b_hr = __ldg(a.bhh + j), b_hz = __ldg(a.bhh + D + j), b_hn = __ldg(a.bhh + 2 * D + j);
#pragma unroll
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      if (v >= n) continue;
      const float rg = sigmoid_f32(__fadd_rn(__fadd_rn(xr[r], b_ir), __fadd_rn(hr[r], b_hr)));
      const float zg = sigmoid_f32(__fadd_rn(__fadd_rn(xz[r], b_iz), __fadd_rn(hz[r], b_hz)));
      const float ng = tanhf(__fadd_rn(__fadd_rn(xn[r], b_in),
                                       __fmul_rn(rg, __fadd_rn(hn[r], b_hn))));
      const float hv = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zg), ng), __fmul_rn(zg, hs[r * D + j]));
      h_out[(size_t)v * D + j] = hv;
      if (a_out != nullptr) a_out[(size_t)v * D + j] = as[r * D + j];
      if (q_next != nullptr) ss[r * D + j] = hv;
    }
  }

  // int8 under kernel 2: quantize the rows just written for the next step
  if (q_next != nullptr) {
    __syncwarp();
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      if (v >= n) break;
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = ss[r * D + c * 32 + lane];
      quant_row<C>(x, lane, q_next + (size_t)v * D, s_next + v);
    }
  }
  __syncwarp();
}

constexpr int smem_bytes(int d) { return (3 * kTileNodes * d + kTileNodes) * (int)sizeof(float); }

// Kernel 1: one step, one tile per block.
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
ggnn_step_kernel(StepArgs a, const float* __restrict__ h,
                 const typename Msg<P>::T* __restrict__ table, const float* __restrict__ tscale,
                 float* __restrict__ h_out, float* __restrict__ a_out) {
  extern __shared__ float4 smem4[];
  step_tile<D, P, false>(a, reinterpret_cast<float*>(smem4), blockIdx.x, h, table, tscale,
                         h_out, a_out, nullptr, nullptr, nullptr);
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
template <int D, int P>
__global__ void __launch_bounds__(kThreads) ggnn_fused_kernel(FusedArgs f) {
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
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      if constexpr (P == kI8) {
        const bool odd = s & 1;
        step_tile<D, P, true>(f.step, smem, tile, h_in,
                              static_cast<const int8_t*>(odd ? f.q1 : f.q0), odd ? f.s1 : f.s0,
                              h_out, nullptr, chain, last ? nullptr : (odd ? f.q0 : f.q1),
                              last ? nullptr : (odd ? f.s0 : f.s1));
      } else {
        step_tile<D, P, true>(f.step, smem, tile, h_in, h_in, nullptr, h_out, nullptr, chain,
                              nullptr, nullptr);
      }
    }
    if (!last) grid.sync();
  }
}

template <int D, int P>
cudaError_t launch_step(const StepArgs& a, const float* h, void* table, float* tscale,
                        float* h_out, float* a_out, cudaStream_t stream) {
  using T = typename Msg<P>::T;
  const int grid = (a.n + kTileNodes - 1) / kTileNodes;
  if (grid == 0) return cudaSuccess;
  cudaError_t err;
  if constexpr (P != kF32) {
    // the message-side table from h (one warp a row)
    const int rows_per_block = kThreads / 32;
    msg_table_kernel<D, P><<<(a.n + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
        h, static_cast<T*>(table), tscale, a.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int smem = smem_bytes(D);
  err = cudaFuncSetAttribute(ggnn_step_kernel<D, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ggnn_step_kernel<D, P><<<grid, kThreads, smem, stream>>>(
      a, h, P == kF32 ? reinterpret_cast<const T*>(h) : static_cast<const T*>(table), tscale,
      h_out, a_out);
  return cudaGetLastError();
}

template <int D, int P>
cudaError_t launch_fused(const FusedArgs& f, int grid_request, int* grid_used,
                         cudaStream_t stream) {
  *grid_used = 0;
  const int n_tiles = (f.step.n + kTileNodes - 1) / kTileNodes;
  if (n_tiles == 0 || f.n_steps == 0) return cudaSuccess;
  const int smem = smem_bytes(D);
  auto kernel = ggnn_fused_kernel<D, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
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

}  // namespace

#define GGNN_WIDTHS(X) X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)

extern "C" {

// Nodes per tile (per block of kernel 1); the wrapper reads it.
int ggnn_step_tile_nodes() { return kTileNodes; }

// Dynamic shared memory of one block of either kernel at width d, in bytes.
int ggnn_step_smem_bytes(int d) { return smem_bytes(d); }

// Kernel 1: one step under `policy` (0 fp32, 1 bf16, 2 int8). Device
// pointers; shapes: h, h_out, a_out [n, d] f32 (a_out may be null);
// src [e] int32; w2 [n_etypes, e] f32; rowptr [n + 1] int32 over the live
// prefix (rowptr[n] = live edge count); wm [n_etypes, d, d] f32 (fp32),
// bf16 (bf16) or int8 (int8), ws [n_etypes, d] f32 (int8, else null);
// bm [n_etypes, d]; wih, whh [d, 3d]; bih, bhh [3d]. bf16 and int8 also
// take table, [n, d] of the policy's type, and int8 tscale [n] f32, which
// the launch fills from h before the step reads them. Returns a
// cudaError_t as int.
int ggnn_step(int policy, const float* h, void* table, float* tscale, const int* src,
              const float* w2, const int* rowptr, const void* wm, const float* ws,
              const float* bm, const float* wih, const float* whh, const float* bih,
              const float* bhh, float* h_out, float* a_out, int n, int e, int d,
              int n_etypes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StepArgs a{src, w2, rowptr, wm, ws, bm, wih, whh, bih, bhh, n, e, n_etypes};
#define GGNN_CASE(DD)                                                               \
  case DD:                                                                          \
    switch (policy) {                                                               \
      case kF32:                                                                    \
        return (int)launch_step<DD, kF32>(a, h, table, tscale, h_out, a_out, s);    \
      case kBF16:                                                                   \
        return (int)launch_step<DD, kBF16>(a, h, table, tscale, h_out, a_out, s);   \
      case kI8:                                                                     \
        return (int)launch_step<DD, kI8>(a, h, table, tscale, h_out, a_out, s);     \
      default:                                                                      \
        return (int)cudaErrorInvalidValue;                                          \
    }
  switch (d) {
    GGNN_WIDTHS(GGNN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GGNN_CASE
}

// Kernel 2: n_steps >= 1 steps under `policy` in one cooperative launch.
// Operands as ggnn_step, plus feat [n, d] f32 (the initial state, read
// only), h_out [n, d], scratch [n, d] (null when n_steps == 1), chain
// [n_steps, n, d] or null, and for int8 the shadow tables q0, q1 [n, d]
// int8 and their scales s0, s1 [n] (q1, s1 null when n_steps == 1).
// grid_request 0 launches as many blocks as the card holds at once (at
// most one per tile); a larger request is refused by the card.
// *grid_used receives the grid launched. Returns a cudaError_t as int.
int ggnn_fused(int policy, const float* feat, const int* src, const float* w2,
               const int* rowptr, const void* wm, const float* ws, const float* bm,
               const float* wih, const float* whh, const float* bih, const float* bhh,
               float* h_out, float* scratch, float* chain, int8_t* q0, int8_t* q1, float* s0,
               float* s1, int n, int e, int d, int n_etypes, int n_steps, int grid_request,
               int* grid_used, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FusedArgs f{{src, w2, rowptr, wm, ws, bm, wih, whh, bih, bhh, n, e, n_etypes},
                    feat, h_out, scratch, chain, q0, q1, s0, s1, n_steps};
#define GGNN_CASE(DD)                                                            \
  case DD:                                                                       \
    switch (policy) {                                                            \
      case kF32:                                                                 \
        return (int)launch_fused<DD, kF32>(f, grid_request, grid_used, s);       \
      case kBF16:                                                                \
        return (int)launch_fused<DD, kBF16>(f, grid_request, grid_used, s);      \
      case kI8:                                                                  \
        return (int)launch_fused<DD, kI8>(f, grid_request, grid_used, s);        \
      default:                                                                   \
        return (int)cudaErrorInvalidValue;                                       \
    }
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
