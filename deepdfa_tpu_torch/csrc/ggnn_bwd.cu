// The backward of one GGNN step, fp32, for NVIDIA Hopper (sm_90a).
//
// Two entry points, one per TPU kernel they replace:
//
// B3 ggnn_gru_bwd_f32 — deepdfa_tpu/nn/ggnn_kernel.py:_gru_bwd_kernel
//   (launched by _gru_bwd_call). The GRU's backward from the saved
//   (h, a): gates recomputed, then
//     da = dgx @ Wih^T,  dh_gru = dgh @ Whh^T + g * z,
//     dWih = a^T @ dgx,  dWhh = h^T @ dgh,  dbih = sum dgx,  dbhh = sum dgh
//   with dgx = [dsr, dsz, dt] and dgh = [dsr, dsz, dhn].
//
// B4 ggnn_dmsg_f32 — deepdfa_tpu/nn/ggnn_kernel.py:_dmsg_kernel
//   (launched by _dmsg_call) together with the sorted segment_sum by
//   src that _step_bwd applies to its rows. It computes
//     dh_msg_u = sum_{e: src_e = u} sum_t w_{t,e} * (da_{dst_e} @ Wm_t^T).
//
// Design.
//
// B3. Three products of 12 N d^2 operations each (the two recomputed
// gate products; da with dh_gru; the two weight products): at the
// flagship (N 16384, d 128) 9.7 GFLOP, 0.144 ms at the fp32 peak of 67
// TFLOP/s, against 42 MB of h, a, g, da and dh (0.013 ms at 3.35 TB/s):
// the operations bind. The TPU kernel walked node blocks on a sequential
// grid and summed the four parameter cotangents across grid steps inside
// its output refs. The card's blocks run in no order, and float atomics
// would make the sums differ run to run, so B3 is four launches. The
// first design (PERF.md: 0.62 ms, 23% of the bound) read its weights a
// column a lane from device memory (the gate pass streamed all of Wih and
// Whh through L1 for every 8 nodes, ~805 MB a launch), and its input and
// weight passes fed 8 to 12 FMAs from each 4 loads. Each pass is now a
// register-tiled FMA product whose operand panels come in through a
// two-stage cp.async ring while the panel before computes:
//   1a. gates: a block of 64 nodes x 32 columns of all six gates, over
//      32-wide k panels of a, h and the [32][3 x 32] column panels of Wih
//      and Whh, so each staged weight serves 64 nodes. Threads 0..127
//      form a @ Wih, 128..255 h @ Whh, each 4 nodes (16 apart) x 4
//      columns x 3 gates: per 4 k, 16 LDS.128 feed 192 FMAs. The six
//      pre-activations of a (node, column) then meet in shared memory
//      (written over the ring), and the elementwise chain of
//      _gru_bwd_kernel writes the four deltas (dsr, dsz, dt, dhn) of each
//      node to a [n, 4d] workspace and g * z to dh.
//   1b. inputs: da = dgx @ Wih^T and dh += dgh @ Whh^T, a block of 64
//      nodes x 64 columns, a thread 4 x 4 of each (tile_dots' layout:
//      per 4 i, 12 LDS.128 feed 128 FMAs), over 32-wide panels of the
//      deltas and of Wih and Whh in their stored [d, 3d] layout (their
//      transposes are no longer made). Keeping the deltas out of the gate
//      block lets more blocks share an SM than one fused node pass would.
//   2. weights: a split-K product over the nodes. A block owns a TK x 96
//      tile of dWih or dWhh (TK 64 where d % 64 == 0, else 32) and one
//      node chunk; a thread TK/8 rows x 6 columns, per node 2 (or 1)
//      LDS.128 and 3 LDS.64 for 48 (or 24) FMAs, summed in node order
//      into one partial (the bias sums ride along in the blocks of the
//      first row tile). The chunks fill the card: at the flagship 16
//      tiles x 32 chunks of 512 nodes, 512 blocks and 12.7 MB of
//      partials.
//   3. reduce: a thread sums 4 outputs over the partials in chunk order.
// Every sum has one fixed order, so the gradients are the same bits on
// every run. Where no parameter takes a cotangent (an attribution, which
// wants the input's alone), the call runs passes 1a and 1b only: da and
// dh keep their bits, and the workspace holds the deltas alone.
//
// B4. The transposed message, summed first: by linearity
//   dh_msg_u = sum_t (sum_{e: src_e = u} w_{t,e} da_{dst_e}) @ Wm_t^T,
// the fold of the forward (ggnn_step.cu, point 1) run over the src CSR.
// Bound at the flagship (N 16384, d 128, T 1): 2 N d^2 T = 0.54 GFLOP
// (0.008 ms at 67 TFLOP/s) against ~17 MB (0.005 ms): the operations
// bind. The first design (PERF.md: 0.0508 ms, 16% of the bound) was two
// launches bound by load latency: q_t = da @ Wm_t^T a column a lane with
// Wm_t^T read from device memory (4 loads per 32 FMAs) into a [T, N, d]
// buffer, then a warp per node walking its run through a chain of
// dependent loads; the wrapper transposed Wm every call and step_bwd added
// the result into dh in a pass of its own. Now one launch, a block of 64
// nodes:
//   1. the sums: the block's src-sorted live edges (one range, through
//      the src CSR row pointer over the live prefix, built by
//      prepare_edges) are cut into 8 equal pieces, a warp each, so a hub
//      node's long run is summed by every warp of its block rather than
//      by one. A warp loads its dst and weights 32 at a time and gathers
//      the da rows 4 ahead of the FMAs (one column a lane); each node's
//      chain runs in edge order into a [64][d + 4] shared plane. A node
//      cut by a piece boundary leaves one partial a piece, which the
//      warp of its first piece adds in piece order.
//   2. the product with Wm_t^T, read in its stored [in, out] layout (no
//      transposed copy): a thread owns kMsgTN nodes x 4 columns (the
//      columns NX apart), per 4 k 4 + kMsgTN LDS.128 feeding 16 kMsgTN
//      FMAs, over [panel][kMsgK] k panels of Wm_t staged swizzled through
//      a two-stage cp.async ring (panels of 128 columns at kMsgTN 8);
//      types ascend, each type's product added to the output (with
//      `accumulate`, to the dh that B3 wrote, so step_bwd needs no add of
//      its own).
// The sums and the products have one fixed order: the same bits on
// every run, no atomics.
//
// All sums are IEEE fp32 FMA: no tensor cores, no TF32.

#include <cuda_runtime.h>

#include <type_traits>

#include "cuda_common.cuh"

namespace {

// B3 gate pass: 64 nodes x 32 columns a block, 32-wide k panels
constexpr int kGateNodes = 64;
constexpr int kGateCols = 32;
constexpr int kGateK = 32;
constexpr int kGateXS = kGateK + 4;  // a staged a / h row, padded: 4 rows hit 4 bank groups
constexpr int kGateThreads = 256;
// floats of a ring stage: a and h [64][kGateXS], Wih and Whh [kGateK][3 x 32]
constexpr int kGateStage = 2 * kGateNodes * kGateXS + 2 * kGateK * 3 * kGateCols;
constexpr int kPreRow = kGateCols + 4;  // a row of the staged pre-activations
// B3 input pass: 64 nodes x 64 columns a block, 32-wide panels over 3d
constexpr int kInNodes = 64;
constexpr int kInCols = 64;
constexpr int kInK = 32;
constexpr int kInThreads = 256;
constexpr int kInStage = 4 * kInNodes * kInK;  // dgx, dgh's n gate, Wih, Whh [64][32]
// B3 weight pass: TK x 96 output tiles, 32 nodes staged at a time
constexpr int kWJ = 96;
constexpr int kWNodes = 32;
constexpr int kWThreads = 128;
constexpr int kWTargetBlocks = 512;  // blocks the node chunks aim for
constexpr int kMaxSplits = 64;
// B4: a block of 64 nodes and 8 warps; a thread's product micro-tile is
// kMsgTN nodes x 4 columns (8 x 4: 12 LDS.128 per 128 FMAs; 4 x 4 ran
// 11% slower at the flagship, PERF.md), and a ring unit holds kMsgK k of
// Wm_t
constexpr int kMsgNodes = 64;
constexpr int kMsgWarps = 8;
constexpr int kMsgThreads = kMsgWarps * 32;
constexpr int kMsgTN = 8;
constexpr int kMsgK = 32;
// the columns of a product panel: 4 a thread, across the threads that
// share a node group
constexpr int kMsgPanel = 4 * kMsgThreads / (kMsgNodes / kMsgTN);

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// rows of a weight-pass tile: 64 where d allows, else 32
__host__ __device__ constexpr int gru_tile_rows(int d) { return d % 64 == 0 ? 64 : 32; }

// weight-pass output tiles of width d: (3d / 96) x (d / TK) for each weight
__host__ __device__ inline int gru_tiles(int d) {
  return (3 * d / kWJ) * (d / gru_tile_rows(d)) * 2;
}

// nodes a chunk of the weight pass for n nodes: enough chunks to put about
// kWTargetBlocks blocks on the card, at most kMaxSplits, a multiple of 32
__host__ __device__ inline int gru_chunk(int n, int d) {
  const int panels = (n + kWNodes - 1) / kWNodes;
  int splits = (kWTargetBlocks + gru_tiles(d) - 1) / gru_tiles(d);
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  splits = splits < panels ? splits : (panels > 0 ? panels : 1);
  const int per = (panels + splits - 1) / splits;
  return (per > 0 ? per : 1) * kWNodes;
}

__host__ __device__ inline int gru_splits(int n, int d) {
  const int chunk = gru_chunk(n, d);
  return (n + chunk - 1) / chunk;
}

// floats of one partial: dWih, dWhh, dbih, dbhh back to back
__host__ __device__ inline long long gru_partial_floats(int d) {
  return 2LL * d * 3 * d + 2LL * 3 * d;
}

// 1a. the six gate pre-activations of 64 nodes x 32 columns from (h, a),
// then the elementwise chain: the deltas [n, 4d] and dh = g * z
template <int D>
__global__ void __launch_bounds__(kGateThreads, 2)
gru_bwd_gates_kernel(const float* __restrict__ h, const float* __restrict__ a,
                     const float* __restrict__ g, const float* __restrict__ wih,
                     const float* __restrict__ whh, const float* __restrict__ bih,
                     const float* __restrict__ bhh, float* __restrict__ delta,
                     float* __restrict__ dh, int n) {
  constexpr int KP = D / kGateK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kGateNodes;
  const int j0 = blockIdx.y * kGateCols;

  // k panel kp into stage kp & 1: rows v0.. of a and h, and of Wih and Whh
  // the rows k0.. at the columns g d + j0 .. +31 of each gate g
  auto stage = [&](int kp) {
    float* st = smem + (kp & 1) * kGateStage;
    const int k0 = kp * kGateK;
    for (int idx = tid; idx < 2 * kGateNodes * (kGateK / 4); idx += kGateThreads) {
      const int which = idx / (kGateNodes * (kGateK / 4));  // 0: a, 1: h
      const int r = (idx / (kGateK / 4)) % kGateNodes, c = idx % (kGateK / 4);
      const int v = v0 + r;
      const float* src = which ? h : a;
      cp_async16(st + (which * kGateNodes + r) * kGateXS + 4 * c,
                 v < n ? src + (size_t)v * D + k0 + 4 * c : src, v < n ? 16 : 0);
    }
    float* ws = st + 2 * kGateNodes * kGateXS;
    for (int idx = tid; idx < 2 * kGateK * 3 * (kGateCols / 4); idx += kGateThreads) {
      const int which = idx / (kGateK * 3 * (kGateCols / 4));  // 0: Wih, 1: Whh
      const int k = (idx / (3 * (kGateCols / 4))) % kGateK;
      const int gc = idx % (3 * (kGateCols / 4));  // gate gc / 8, 16-byte chunk gc % 8
      const float* src = (which ? whh : wih) + (size_t)(k0 + k) * 3 * D + (gc / 8) * D + j0 +
                         4 * (gc % 8);
      cp_async16(ws + (which * kGateK + k) * 3 * kGateCols + 4 * gc, src, 16);
    }
    cp_async_commit();
  };

  // this thread's product, nodes ng + 16m and columns 4cg .. 4cg+3
  const int half = tid >> 7;  // 0: a @ Wih (xr, xz, xn), 1: h @ Whh (hr, hz, hn)
  const int t = tid & 127;
  const int cg = t & 7, ng = t >> 3;
  float acc[4][3][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.0f;
    }
  }
  stage(0);
  for (int kp = 0; kp < KP; ++kp) {
    cp_async_wait_all();
    __syncthreads();  // panel kp is in; every thread is done with kp - 1
    if (kp + 1 < KP) stage(kp + 1);
    const float* st = smem + (kp & 1) * kGateStage;
    const float* xs = st + (half * kGateNodes + ng) * kGateXS;
    const float* ws = st + 2 * kGateNodes * kGateXS + half * kGateK * 3 * kGateCols + 4 * cg;
#pragma unroll 2
    for (int k = 0; k < kGateK; k += 4) {
      float4 x[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        x[m] = *reinterpret_cast<const float4*>(xs + 16 * m * kGateXS + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 w[3];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          w[q] = *reinterpret_cast<const float4*>(ws + (k + kk) * 3 * kGateCols + q * kGateCols);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float xv = lane_of(x[m], kk);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            acc[m][q][0] = fmaf(xv, w[q].x, acc[m][q][0]);
            acc[m][q][1] = fmaf(xv, w[q].y, acc[m][q][1]);
            acc[m][q][2] = fmaf(xv, w[q].z, acc[m][q][2]);
            acc[m][q][3] = fmaf(xv, w[q].w, acc[m][q][3]);
          }
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the ring
  // pre-activations [half][gate][64 nodes][kPreRow] over the ring
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<float4*>(smem + ((half * 3 + q) * kGateNodes + ng + 16 * m) * kPreRow +
                                 4 * cg) =
          make_float4(acc[m][q][0], acc[m][q][1], acc[m][q][2], acc[m][q][3]);
  }
  __syncthreads();

  // the elementwise chain, a (node, column) pair a thread at a time
  for (int idx = tid; idx < kGateNodes * kGateCols; idx += kGateThreads) {
    const int r = idx / kGateCols, c = idx % kGateCols;
    const int v = v0 + r;
    if (v >= n) continue;
    const int j = j0 + c;
    const float* pre = smem + r * kPreRow + c;
    const float xr = pre[0], xz = pre[kGateNodes * kPreRow], xn = pre[2 * kGateNodes * kPreRow];
    const float hr = pre[3 * kGateNodes * kPreRow], hz = pre[4 * kGateNodes * kPreRow];
    const float hn = pre[5 * kGateNodes * kPreRow];
    const float rg = sigmoid_f32((xr + __ldg(bih + j)) + (hr + __ldg(bhh + j)));
    const float zg = sigmoid_f32((xz + __ldg(bih + D + j)) + (hz + __ldg(bhh + D + j)));
    const float hnb = hn + __ldg(bhh + 2 * D + j);
    const float ng_ = tanhf((xn + __ldg(bih + 2 * D + j)) + rg * hnb);
    const float gv = g[(size_t)v * D + j];
    const float dz = gv * (h[(size_t)v * D + j] - ng_);
    const float dn = gv * (1.0f - zg);
    const float dt = dn * (1.0f - ng_ * ng_);
    const float dr = dt * hnb;
    float* drow = delta + (size_t)v * 4 * D;
    drow[j] = dr * rg * (1.0f - rg);     // dsr
    drow[D + j] = dz * zg * (1.0f - zg);  // dsz
    drow[2 * D + j] = dt;
    drow[3 * D + j] = dt * rg;            // dhn
    dh[(size_t)v * D + j] = gv * zg;
  }
}

// 1b. da = dgx @ Wih^T, dh = dgh @ Whh^T + g * z (dh holds g * z) for 64
// nodes x 64 columns: a thread owns nodes 4ty .. 4ty+3 and columns tx +
// 16j. The [64][32] weight panels are swizzled (16-byte chunk c of row r
// at c ^ (r & 7)), so the 8 lanes of a quarter warp reading 8 rows hit 8
// bank groups; the delta panels are plain (a quarter warp reads one row).
template <int D>
__global__ void __launch_bounds__(kInThreads, 2)
gru_bwd_inputs_kernel(const float* __restrict__ delta, const float* __restrict__ wih,
                      const float* __restrict__ whh, float* __restrict__ da,
                      float* __restrict__ dh, int n) {
  constexpr int P = 3 * D / kInK;   // panels over dgx's 3d columns
  constexpr int PN = 2 * D / kInK;  // the first panel of the n gate
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int v0 = blockIdx.x * kInNodes, c0 = blockIdx.y * kInCols;

  // panel p into stage p & 1: dgx's columns i0 .. i0+31 (the workspace's
  // dsr | dsz | dt), in the n gate also dgh's (dhn, d further), and the
  // same columns of Wih and Whh at the rows c0 .. c0+63 (zero past d)
  auto stage = [&](int p) {
    float* st = smem + (p & 1) * kInStage;
    const int i0 = p * kInK;
    const int parts = p >= PN ? 2 : 1;
    for (int idx = tid; idx < parts * kInNodes * (kInK / 4); idx += kInThreads) {
      const int which = idx / (kInNodes * (kInK / 4));
      const int r = (idx / (kInK / 4)) % kInNodes, c = idx % (kInK / 4);
      const int v = v0 + r;
      cp_async16(st + (which * kInNodes + r) * kInK + 4 * c,
                 v < n ? delta + (size_t)v * 4 * D + i0 + which * D + 4 * c : delta,
                 v < n ? 16 : 0);
    }
    for (int idx = tid; idx < 2 * kInCols * (kInK / 4); idx += kInThreads) {
      const int which = idx / (kInCols * (kInK / 4));  // 0: Wih, 1: Whh
      const int r = (idx / (kInK / 4)) % kInCols, c = idx % (kInK / 4);
      const int row = c0 + r;
      const float* src = which ? whh : wih;
      cp_async16(st + ((2 + which) * kInCols + r) * kInK + 4 * (c ^ (r & 7)),
                 row < D ? src + (size_t)row * 3 * D + i0 + 4 * c : src, row < D ? 16 : 0);
    }
    cp_async_commit();
  };

  float ax[4][4], ah[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) ax[i][j] = ah[i][j] = 0.0f;
  }
  const int sw = tx & 7;
  // acc += the panel's products: dgx against Wih, and dgx (r, z gates) or
  // dgh (n gate: kN) against Whh; i ascends in every sum
  auto panel = [&](const float* st, auto kN) {
    const float* xs = st + 4 * ty * kInK;
    const float* hs = decltype(kN)::value ? st + (kInNodes + 4 * ty) * kInK : xs;
    const float* wi = st + (2 * kInCols + tx) * kInK;
    const float* wh = st + (3 * kInCols + tx) * kInK;
#pragma unroll 2
    for (int c = 0; c < kInK / 4; ++c) {
      float4 yi[4], yh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yi[j] = *reinterpret_cast<const float4*>(wi + 16 * j * kInK + 4 * (c ^ sw));
        yh[j] = *reinterpret_cast<const float4*>(wh + 16 * j * kInK + 4 * (c ^ sw));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xs + i * kInK + 4 * c);
        const float4 xh =
            decltype(kN)::value ? *reinterpret_cast<const float4*>(hs + i * kInK + 4 * c) : x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ax[i][j] = fmaf(x.x, yi[j].x, ax[i][j]);
          ax[i][j] = fmaf(x.y, yi[j].y, ax[i][j]);
          ax[i][j] = fmaf(x.z, yi[j].z, ax[i][j]);
          ax[i][j] = fmaf(x.w, yi[j].w, ax[i][j]);
          ah[i][j] = fmaf(xh.x, yh[j].x, ah[i][j]);
          ah[i][j] = fmaf(xh.y, yh[j].y, ah[i][j]);
          ah[i][j] = fmaf(xh.z, yh[j].z, ah[i][j]);
          ah[i][j] = fmaf(xh.w, yh[j].w, ah[i][j]);
        }
      }
    }
  };
  stage(0);
  for (int p = 0; p < P; ++p) {
    cp_async_wait_all();
    __syncthreads();  // panel p is in; every thread is done with p - 1
    if (p + 1 < P) stage(p + 1);
    const float* st = smem + (p & 1) * kInStage;
    if (p < PN)
      panel(st, std::false_type{});
    else
      panel(st, std::true_type{});
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + 4 * ty + i;
    if (v >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= D) continue;
      da[(size_t)v * D + col] = ax[i][j];
      dh[(size_t)v * D + col] = ah[i][j] + dh[(size_t)v * D + col];
    }
  }
}

// 2. one partial of dWih (z < splits) or dWhh (z >= splits): the rows k0
// .. k0+TK-1 and columns i0 .. i0+95 over one node chunk. A thread owns
// the rows k0 + MK kg .. +MK-1 and the columns i0 + 2ig + 32m + {0, 1};
// blocks of the first row tile also sum the bias columns.
template <int D>
__global__ void __launch_bounds__(kWThreads)
gru_bwd_weights_kernel(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ delta, float* __restrict__ part,
                       int n, int chunk, int splits) {
  constexpr int TK = gru_tile_rows(D);
  constexpr int MK = TK / 8;
  constexpr int SF = kWNodes * (TK + kWJ);  // floats of a stage: x [32][TK], g [32][96]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int which = blockIdx.z / splits;  // 0: (a, dgx) -> dWih; 1: (h, dgh) -> dWhh
  const int s = blockIdx.z % splits;
  const int i0 = blockIdx.x * kWJ;
  const int k0 = blockIdx.y * TK;
  const float* x = which == 0 ? a : h;
  const int tid = threadIdx.x;
  const int ig = tid & 15, kg = tid >> 4;
  const bool bias = blockIdx.y == 0;
  const int v_begin = s * chunk;
  const int v_end = min(n, v_begin + chunk);
  const int panels = (v_end - v_begin + kWNodes - 1) / kWNodes;

  // node panel p into stage p & 1: x's columns k0 .. k0+TK-1 and the 96
  // delta columns of the tile (dgh's n gate is dhn, d further on)
  auto stage = [&](int p) {
    float* st = smem + (p & 1) * SF;
    const int vb = v_begin + p * kWNodes;
    for (int idx = tid; idx < kWNodes * (TK / 4); idx += kWThreads) {
      const int r = idx / (TK / 4), c = idx % (TK / 4);
      const int v = vb + r;
      cp_async16(st + r * TK + 4 * c, v < v_end ? x + (size_t)v * D + k0 + 4 * c : x,
                 v < v_end ? 16 : 0);
    }
    for (int idx = tid; idx < kWNodes * (kWJ / 4); idx += kWThreads) {
      const int r = idx / (kWJ / 4), c = idx % (kWJ / 4);
      const int v = vb + r;
      const int i = i0 + 4 * c;
      const int col = (which == 1 && i >= 2 * D) ? i + D : i;
      cp_async16(st + kWNodes * TK + r * kWJ + 4 * c,
                 v < v_end ? delta + (size_t)v * 4 * D + col : delta, v < v_end ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[MK][6], bacc[6];
#pragma unroll
  for (int p = 0; p < MK; ++p) {
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[p][q] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) bacc[q] = 0.0f;
  if (panels > 0) stage(0);
  for (int p = 0; p < panels; ++p) {
    cp_async_wait_all();
    __syncthreads();  // panel p is in; every thread is done with p - 1
    if (p + 1 < panels) stage(p + 1);
    const float* xs = smem + (p & 1) * SF + MK * kg;
    const float* gs = smem + (p & 1) * SF + kWNodes * TK + 2 * ig;
#pragma unroll 4
    for (int vv = 0; vv < kWNodes; ++vv) {
      float xv[MK];
#pragma unroll
      for (int c = 0; c < MK / 4; ++c) {
        const float4 x4 = *reinterpret_cast<const float4*>(xs + vv * TK + 4 * c);
        xv[4 * c] = x4.x;
        xv[4 * c + 1] = x4.y;
        xv[4 * c + 2] = x4.z;
        xv[4 * c + 3] = x4.w;
      }
      float gq[6];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float2 g2 = *reinterpret_cast<const float2*>(gs + vv * kWJ + 32 * m);
        gq[2 * m] = g2.x;
        gq[2 * m + 1] = g2.y;
      }
#pragma unroll
      for (int r = 0; r < MK; ++r) {
#pragma unroll
        for (int q = 0; q < 6; ++q) acc[r][q] = fmaf(xv[r], gq[q], acc[r][q]);
      }
      if (bias) {
#pragma unroll
        for (int q = 0; q < 6; ++q) bacc[q] += gq[q];
      }
    }
  }
  float* out = part + (size_t)s * gru_partial_floats(D);
  float* w = out + (size_t)which * D * 3 * D;
#pragma unroll
  for (int r = 0; r < MK; ++r) {
#pragma unroll
    for (int m = 0; m < 3; ++m)
      *reinterpret_cast<float2*>(w + (size_t)(k0 + MK * kg + r) * 3 * D + i0 + 32 * m + 2 * ig) =
          make_float2(acc[r][2 * m], acc[r][2 * m + 1]);
  }
  if (bias && kg == 0) {
    float* b = out + 2 * D * 3 * D + which * 3 * D;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      *reinterpret_cast<float2*>(b + i0 + 32 * m + 2 * ig) = make_float2(bacc[2 * m], bacc[2 * m + 1]);
  }
}

// 3. out[i] = sum over s of part[s][i], in chunk order; a thread sums 4
// outputs (count, a partial's floats, is a multiple of 4)
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     long long count, int splits) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= count) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + (size_t)s * count + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<float4*>(out + i) = acc;
}

// B4: a row of the sums plane, padded so the rows a warp reads at one k
// fall in distinct bank groups
__host__ __device__ constexpr int msg_row(int d) { return d + 4; }

// B4's k rows a ring unit: kMsgK, or all of d where d is smaller
__host__ __device__ constexpr int msg_k(int d) { return kMsgK < d ? kMsgK : d; }

// B4's shared memory, in floats: the sums [64][d + 4], the ring [2][panel
// columns][k], the cut nodes' pieces [head, tail][8 warps][d], and ints:
// the block's row pointer [65] and the pieces' nodes [head, tail][8]
__host__ __device__ constexpr int dmsg_smem_floats(int d) {
  return kMsgNodes * msg_row(d) + 2 * kMsgPanel * msg_k(d) + 2 * kMsgWarps * d + kMsgNodes +
         1 + 2 * kMsgWarps;
}

// B4: ring unit u of Wm_t, as stored ([in][out]): the in rows p PW .. +
// PW - 1 (zeros past D) of column panel p = u / (D / KU) and the out
// columns (u % (D / KU)) KU .. + KU - 1; 16-byte chunk c of row r sits at
// c ^ (r & 7), so the rows that a quarter warp reads hit 8 bank groups
template <int D, int PW, int KU>
__device__ __forceinline__ void stage_msg_unit(const float* __restrict__ wmt, int u, float* dst) {
  constexpr int CH = KU / 4;
  const int i0 = u / (D / KU) * PW, k0 = u % (D / KU) * KU;
  for (int idx = threadIdx.x; idx < PW * CH; idx += kMsgThreads) {
    const int r = idx / CH, c = idx % CH;
    const int row = i0 + r;
    cp_async16(dst + r * KU + 4 * (c ^ (r & 7)),
               row < D ? wmt + (size_t)row * D + k0 + 4 * c : wmt, row < D ? 16 : 0);
  }
  cp_async_commit();
}

// B4's sums of one type over this warp's piece [a0, a1) of the block's
// src-sorted edges (sp: the block's row pointer). Each node's chain runs
// in edge order; a node whose run the piece holds whole goes to its row
// of ss, one the piece cuts to a piece slot: the head slot for a run that
// began before a0, the tail slot for one that goes on past a1, with its
// node in pnode[head or tail][warp]. Warp 0 starts at node 0 and every
// warp closes the runs that end by a1, so empty runs get their zero rows.
template <int D>
__device__ __forceinline__ void dmsg_sums(const float* __restrict__ da,
                                          const int* __restrict__ dstp,
                                          const float* __restrict__ wt, const int* sp, int a0,
                                          int a1, float* ss, float* piece, int* pnode) {
  constexpr int C = D / 32;
  constexpr int RS = msg_row(D);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the first node: the one whose run holds edge a0 (sp[r] <= a0 < sp[r + 1])
  int r = 0;
  if (warp > 0)
    r = __popc(__ballot_sync(0xffffffffu, sp[lane] <= a0)) +
        __popc(__ballot_sync(0xffffffffu, sp[32 + lane] <= a0)) - 1;
  const int r_head = warp > 0 && sp[r] < a0 ? r : -1;  // its run began before a0
  int run_end = sp[r + 1];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  auto put = [&](float* dst) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dst[c * 32 + lane] = acc[c];
      acc[c] = 0.0f;
    }
  };
  // node r's run is over
  auto close = [&]() {
    if (r == r_head) {
      put(piece + warp * D);
      if (lane == 0) pnode[warp] = r;
    } else {
      put(ss + r * RS);
    }
    if (++r < kMsgNodes) run_end = sp[r + 1];
  };
  for (int base = a0; base < a1; base += 32) {
    const int cnt = min(32, a1 - base);
    int u_l = 0;
    float w_l = 0.0f;
    if (lane < cnt) {
      w_l = __ldg(wt + base + lane);
      u_l = __ldg(dstp + base + lane);
    }
    for (int j0 = 0; j0 < cnt; j0 += 4) {
      float x[4][C];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = __shfl_sync(0xffffffffu, u_l, j0 + q);
#pragma unroll
        for (int c = 0; c < C; ++c)
          x[q][c] = j0 + q < cnt ? __ldg(da + (size_t)u * D + c * 32 + lane) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = __shfl_sync(0xffffffffu, w_l, j0 + q);
        if (j0 + q < cnt) {
          while (base + j0 + q >= run_end) close();
          if (w != 0.0f) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = fmaf(w, x[q][c], acc[c]);
          }
        }
      }
    }
  }
  while (r < kMsgNodes && run_end <= a1) close();
  // node r goes on past a1; its piece here, if its run began before a1
  if (r < kMsgNodes && sp[r] < a1) {
    const int slot = r == r_head ? warp : kMsgWarps + warp;
    put(piece + slot * D);
    if (lane == 0) pnode[slot] = r;
  }
}

// B4: dh_msg for 64 nodes (out: dh_msg, or with `accumulate` the dh it is
// added to), per type the sums (dmsg_sums, then the cut nodes' pieces in
// order) and their product with Wm_t^T
template <int D>
__global__ void __launch_bounds__(kMsgThreads, 2)
dmsg_kernel(const float* __restrict__ da, const float* __restrict__ wm,
            const int* __restrict__ dstp, const float* __restrict__ wp,
            const int* __restrict__ srcptr, float* __restrict__ out, int n, int e,
            int n_etypes, int accumulate) {
  constexpr int C = D / 32;
  constexpr int RS = msg_row(D);
  constexpr int TN = kMsgTN;
  constexpr int NY = kMsgNodes / TN;   // threads along the nodes
  constexpr int NX = kMsgThreads / NY;  // threads along the columns
  constexpr int PW = kMsgPanel;        // 4 NX columns a panel
  constexpr int KU = msg_k(D);
  constexpr int NKU = D / KU;           // ring units a panel
  constexpr int U = (D + PW - 1) / PW * NKU;  // ring units a type
  extern __shared__ float4 smem4[];
  float* ss = reinterpret_cast<float*>(smem4);
  float* ring = ss + kMsgNodes * RS;
  float* piece = ring + 2 * PW * KU;
  int* sp = reinterpret_cast<int*>(piece + 2 * kMsgWarps * D);
  int* pnode = sp + kMsgNodes + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int vb = blockIdx.x * kMsgNodes;
  const int tx = tid % NX, ty = tid / NX;
  const int sw = tx & 7;

  if (tid <= kMsgNodes) sp[tid] = __ldg(srcptr + min(vb + tid, n));
  __syncthreads();
  const int e0 = sp[0], len = sp[kMsgNodes] - e0;
  const int a0 = e0 + (int)((long long)len * warp / kMsgWarps);
  const int a1 = e0 + (int)((long long)len * (warp + 1) / kMsgWarps);
  for (int t = 0; t < n_etypes; ++t) {
    const float* wmt = wm + (size_t)t * D * D;
    stage_msg_unit<D, PW, KU>(wmt, 0, ring);
    if (lane == 0) pnode[warp] = pnode[kMsgWarps + warp] = -1;
    if (warp == 0 || a0 < a1)
      dmsg_sums<D>(da, dstp, wp + (size_t)t * e, sp, a0, a1, ss, piece, pnode);
    __syncthreads();  // every piece is in
    const int rt = pnode[kMsgWarps + warp];  // the node this warp's tail piece began
    if (rt >= 0) {
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = piece[(kMsgWarps + warp) * D + c * 32 + lane];
      for (int w = warp + 1; w < kMsgWarps; ++w) {
        if (pnode[w] != rt) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] += piece[w * D + c * 32 + lane];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) ss[rt * RS + c * 32 + lane] = x[c];
    }

    // the product, nodes TN ty .. + TN - 1 x columns p PW + tx + NX j
    float acc[TN][4];
#pragma unroll 1
    for (int u = 0; u < U; ++u) {
      cp_async_wait_all();
      __syncthreads();  // unit u is in, the sums too; unit u - 1 is done with
      if (u + 1 < U) stage_msg_unit<D, PW, KU>(wmt, u + 1, ring + ((u + 1) & 1) * PW * KU);
      const int kp = u % NKU;
      if (kp == 0) {
#pragma unroll
        for (int i = 0; i < TN; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      const float* xs = ss + TN * ty * RS + kp * KU;
      const float* ws = ring + (u & 1) * PW * KU + tx * KU;
#pragma unroll 2
      for (int c = 0; c < KU / 4; ++c) {
        float4 y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          y[j] = *reinterpret_cast<const float4*>(ws + NX * j * KU + 4 * (c ^ sw));
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(xs + i * RS + 4 * c);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
            acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
            acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
            acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
          }
        }
      }
      if (kp != NKU - 1) continue;
      const int col0 = u / NKU * PW + tx;
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const int v = vb + TN * ty + i;
        if (v >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col0 + NX * j;
          if (col >= D) continue;
          float* dst = out + (size_t)v * D + col;
          *dst = t == 0 && !accumulate ? acc[i][j] : *dst + acc[i][j];
        }
      }
    }
    __syncthreads();  // every unit is done with ss, the pieces and the ring
  }
}

template <int D>
cudaError_t launch_gru_bwd(const float* h, const float* a, const float* g, const float* wih,
                           const float* whh, const float* bih, const float* bhh, float* da,
                           float* dh, float* grads, float* workspace, int n,
                           bool weights, cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  constexpr int gate_smem = 2 * kGateStage * (int)sizeof(float);
  constexpr int in_smem = 2 * kInStage * (int)sizeof(float);
  constexpr int w_smem = 2 * kWNodes * (gru_tile_rows(D) + kWJ) * (int)sizeof(float);
  static_assert(6 * kGateNodes * kPreRow <= 2 * kGateStage, "pre-activations fit the ring");
  cudaError_t err = allow_smem(gru_bwd_gates_kernel<D>, gate_smem);
  if (err == cudaSuccess) err = allow_smem(gru_bwd_inputs_kernel<D>, in_smem);
  if (err == cudaSuccess) err = allow_smem(gru_bwd_weights_kernel<D>, w_smem);
  if (err != cudaSuccess) return err;
  float* delta = workspace;
  float* part = workspace + (size_t)n * 4 * D;
  const int node_tiles = (n + kGateNodes - 1) / kGateNodes;
  gru_bwd_gates_kernel<D><<<dim3(node_tiles, D / kGateCols), kGateThreads, gate_smem, stream>>>(
      h, a, g, wih, whh, bih, bhh, delta, dh, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gru_bwd_inputs_kernel<D><<<dim3((n + kInNodes - 1) / kInNodes, (D + kInCols - 1) / kInCols),
                             kInThreads, in_smem, stream>>>(delta, wih, whh, da, dh, n);
  err = cudaGetLastError();
  if (err != cudaSuccess || !weights) return err;
  const int chunk = gru_chunk(n, D);
  const int splits = gru_splits(n, D);
  const dim3 grid(3 * D / kWJ, D / gru_tile_rows(D), 2 * splits);
  gru_bwd_weights_kernel<D><<<grid, kWThreads, w_smem, stream>>>(a, h, delta, part, n, chunk,
                                                                  splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = gru_partial_floats(D);
  reduce_splits_kernel<<<(int)((count / 4 + 255) / 256), 256, 0, stream>>>(part, grads, count,
                                                                           splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dmsg(const float* da, const float* wm, const int* dstp, const float* wp,
                        const int* srcptr, float* out, int accumulate, int n, int e,
                        int n_etypes, cudaStream_t stream) {
  if (n <= 0 || e <= 0 || n_etypes <= 0) return cudaErrorInvalidValue;
  constexpr int smem = dmsg_smem_floats(D) * (int)sizeof(float);
  const cudaError_t err = allow_smem(dmsg_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dmsg_kernel<D><<<(n + kMsgNodes - 1) / kMsgNodes, kMsgThreads, smem, stream>>>(
      da, wm, dstp, wp, srcptr, out, n, e, n_etypes, accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of B3's workspace: the [n, 4d] deltas and, with weights != 0,
// the weight partials.
long long ggnn_gru_bwd_workspace_floats(int n, int d, int weights) {
  return (long long)n * 4 * d +
         (weights ? (long long)gru_splits(n, d) * gru_partial_floats(d) : 0LL);
}

// Node chunks of B3's weight pass for n nodes at width d (PERF.md
// reports it).
int ggnn_gru_bwd_splits(int n, int d) { return gru_splits(n, d); }

// B3. Device pointers, every one 16-byte aligned; shapes: h, a, g, da, dh
// [n, d]; wih, whh [d, 3d]; bih, bhh [3d]; with weights != 0, grads
// [2*d*3d + 2*3d] receives dWih | dWhh | dbih | dbhh (with weights == 0
// the weight pass and its reduce do not run and grads is not touched);
// workspace holds ggnn_gru_bwd_workspace_floats(n, d, weights) floats.
// Returns a cudaError_t.
int ggnn_gru_bwd_f32(const float* h, const float* a, const float* g, const float* wih,
                     const float* whh, const float* bih, const float* bhh, float* da, float* dh,
                     float* grads, float* workspace, int n, int d, int weights, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRU_CASE(DD)                                                                       \
  case DD:                                                                                 \
    return (int)launch_gru_bwd<DD>(h, a, g, wih, whh, bih, bhh, da, dh, grads, workspace, n, \
                                   weights != 0, s);
  switch (d) {
    GRU_CASE(32)
    GRU_CASE(64)
    GRU_CASE(96)
    GRU_CASE(128)
    GRU_CASE(160)
    GRU_CASE(192)
    GRU_CASE(224)
    GRU_CASE(256)
    GRU_CASE(288)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GRU_CASE
}

// B4. Device pointers; shapes: da, out [n, d]; wm [n_etypes, d, d] as
// stored ([in, out], 16-byte aligned); dstp [e] and wp [n_etypes, e] in
// src-sorted edge order; srcptr [n + 1] over the live prefix of that
// order. out receives dh_msg, or with accumulate != 0 out + dh_msg (in
// place). Returns a cudaError_t.
int ggnn_dmsg_f32(const float* da, const float* wm, const int* dstp, const float* wp,
                  const int* srcptr, float* out, int accumulate, int n, int e, int d,
                  int n_etypes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DMSG_CASE(DD) \
  case DD:            \
    return (int)launch_dmsg<DD>(da, wm, dstp, wp, srcptr, out, accumulate, n, e, n_etypes, s);
  switch (d) {
    DMSG_CASE(32)
    DMSG_CASE(64)
    DMSG_CASE(96)
    DMSG_CASE(128)
    DMSG_CASE(160)
    DMSG_CASE(192)
    DMSG_CASE(224)
    DMSG_CASE(256)
    DMSG_CASE(288)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DMSG_CASE
}

const char* ggnn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
