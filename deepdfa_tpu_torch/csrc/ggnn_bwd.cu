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
// B3. The TPU kernel walked node blocks on a sequential grid and summed
// the four parameter cotangents across grid steps inside its output
// refs. The card's blocks run in no order, and float atomics would make
// the sums differ run to run. So B3 is four launches:
//   1a. gates: one warp owns kNodesPerWarp nodes (as ggnn_step.cu does).
//      It stages its rows of h and a in shared memory, recomputes the
//      six gate pre-activations column by column (one column per lane),
//      applies the elementwise chain of _gru_bwd_kernel and writes the
//      four deltas (dsr, dsz, dt, dhn) of its nodes to a [n, 4d]
//      workspace and g * z to dh.
//   1b. inputs: da and dh_gru from the deltas and the transposed weights
//      (read coalesced from Wih^T, Whh^T, which the wrapper passes), one
//      warp per kNodesPerWarp nodes reading their delta rows through the
//      read-only cache. Keeping the deltas out of shared memory lets
//      three times as many warps share an SM as one fused node pass
//      would (PERF.md has both times).
//   2. weights: a split-K product. The grid tiles [d, 3d] into 32 x 96
//      output tiles for each of the two weights, and splits the nodes
//      into at most kMaxSplits contiguous chunks of a multiple of 32
//      nodes. A block sums its chunk in node order into one partial
//      (the bias sums ride along in the blocks of the first row tile).
//      At the flagship (N 16384, d 128) that is 16 chunks of 1024 nodes
//      and 16 partials of 2 * 128 * 384 + 768 floats (6.3 MB), against
//      50 MB for one partial per 64-node tile.
//   3. reduce: one thread per output sums the partials in chunk order.
// Every sum has one fixed order, so the gradients are the same bits on
// every run.
//
// B4. The port's forward sums w * h_src per node before applying Wm_t
// (ggnn_step.cu, point 2); the backward mirrors it. A first launch
// forms q_t = da @ Wm_t^T once per node (N*d^2 per type instead of the
// reference's E*d^2); a second gives each node one warp that walks its
// run of the src-sorted live edges (a CSR row pointer over the live
// prefix, built by prepare_edges) and sums w_{t,e} * q_t[dst_e] in
// edge order, one column per lane, with no atomics.
//
// All sums are IEEE fp32 FMA: no tensor cores, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kNodesPerWarp = 8;
// B3 node passes: 8 warps, 64 nodes per block
constexpr int kGruWarps = 8;
constexpr int kGruThreads = kGruWarps * 32;
constexpr int kGruTileNodes = kGruWarps * kNodesPerWarp;
// B3 weight pass: 32 x 96 output tiles, 32 nodes staged at a time
constexpr int kWK = 32;
constexpr int kWJ = 96;
constexpr int kWNodes = 32;
constexpr int kWThreads = 256;
constexpr int kMaxSplits = 16;
// B4: 8 warps per block
constexpr int kMsgWarps = 8;
constexpr int kMsgThreads = kMsgWarps * 32;
constexpr int kMsgTileNodes = kMsgWarps * kNodesPerWarp;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// nodes chunk of the weight pass and the number of chunks for n nodes
__host__ __device__ inline int gru_chunk(int n) {
  const int tiles = (n + kWNodes - 1) / kWNodes;
  const int splits = tiles < kMaxSplits ? (tiles > 0 ? tiles : 1) : kMaxSplits;
  return ((tiles + splits - 1) / splits) * kWNodes;
}

__host__ __device__ inline int gru_splits(int n) {
  const int chunk = gru_chunk(n);
  return (n + chunk - 1) / chunk;
}

// floats of one partial: dWih, dWhh, dbih, dbhh back to back
__host__ __device__ inline long long gru_partial_floats(int d) {
  return 2LL * d * 3 * d + 2LL * 3 * d;
}

template <int D>
__global__ void __launch_bounds__(kGruThreads)
gru_bwd_gates_kernel(const float* __restrict__ h, const float* __restrict__ a,
                     const float* __restrict__ g, const float* __restrict__ wih,
                     const float* __restrict__ whh, const float* __restrict__ bih,
                     const float* __restrict__ bhh, float* __restrict__ delta,
                     float* __restrict__ dh, int n) {
  constexpr int C = D / 32;  // columns per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kNodesPerWarp;
  const int v0 = blockIdx.x * kGruTileNodes + row0;
  // this warp's slices: h rows, a rows
  float* hs = smem + row0 * D;
  float* as = smem + kGruTileNodes * D + row0 * D;

  for (int r = 0; r < kNodesPerWarp; ++r) {
    const int v = v0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      hs[r * D + j] = v < n ? h[(size_t)v * D + j] : 0.0f;
      as[r * D + j] = v < n ? a[(size_t)v * D + j] : 0.0f;
    }
  }
  __syncwarp();

  // gates from (h, a), then the elementwise chain, one column a lane
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
        ir[q] = __ldg(wih + row + j);
        iz[q] = __ldg(wih + row + D + j);
        in_[q] = __ldg(wih + row + 2 * D + j);
        gr[q] = __ldg(whh + row + j);
        gz[q] = __ldg(whh + row + D + j);
        gn[q] = __ldg(whh + row + 2 * D + j);
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
    const float b_ir = __ldg(bih + j), b_iz = __ldg(bih + D + j), b_in = __ldg(bih + 2 * D + j);
    const float b_hr = __ldg(bhh + j), b_hz = __ldg(bhh + D + j), b_hn = __ldg(bhh + 2 * D + j);
#pragma unroll
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      if (v >= n) continue;
      const float rg = sigmoid_f32((xr[r] + b_ir) + (hr[r] + b_hr));
      const float zg = sigmoid_f32((xz[r] + b_iz) + (hz[r] + b_hz));
      const float hnb = hn[r] + b_hn;
      const float ng = tanhf((xn[r] + b_in) + rg * hnb);
      const float gv = g[(size_t)v * D + j];
      const float dz = gv * (hs[r * D + j] - ng);
      const float dn = gv * (1.0f - zg);
      const float dt = dn * (1.0f - ng * ng);
      const float dr = dt * hnb;
      float* drow = delta + (size_t)v * 4 * D;
      drow[j] = dr * rg * (1.0f - rg);     // dsr
      drow[D + j] = dz * zg * (1.0f - zg);  // dsz
      drow[2 * D + j] = dt;
      drow[3 * D + j] = dt * rg;            // dhn
      dh[(size_t)v * D + j] = gv * zg;
    }
  }
}

// 1b. da = dgx @ Wih^T, dh = dgh @ Whh^T + g * z (dh holds g * z). The
// deltas were written by the previous launch: each warp reads its nodes'
// rows as warp-uniform float4 loads through the read-only cache, so the
// kernel needs no shared memory and many warps fit on an SM.
template <int D>
__global__ void __launch_bounds__(kGruThreads)
gru_bwd_inputs_kernel(const float* __restrict__ delta, const float* __restrict__ wih_t,
                      const float* __restrict__ whh_t, float* __restrict__ da,
                      float* __restrict__ dh, int n) {
  constexpr int C = D / 32;
  const int lane = threadIdx.x & 31;
  const int v0 = blockIdx.x * kGruTileNodes + (threadIdx.x >> 5) * kNodesPerWarp;
  const float* rows[kNodesPerWarp];
#pragma unroll
  for (int r = 0; r < kNodesPerWarp; ++r)  // rows past n read node 0's, never stored
    rows[r] = delta + (size_t)(v0 + r < n ? v0 + r : 0) * 4 * D;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    float ax[kNodesPerWarp], ah[kNodesPerWarp];
#pragma unroll
    for (int r = 0; r < kNodesPerWarp; ++r) ax[r] = ah[r] = 0.0f;
    // r and z gates: dgx and dgh share dsr, dsz
    for (int i = 0; i < 2 * D; i += 4) {
      float wx[4], wh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wx[q] = __ldg(wih_t + (size_t)(i + q) * D + j);
        wh[q] = __ldg(whh_t + (size_t)(i + q) * D + j);
      }
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(rows[r] + i));
        ax[r] = fmaf(d4.x, wx[0], ax[r]);
        ax[r] = fmaf(d4.y, wx[1], ax[r]);
        ax[r] = fmaf(d4.z, wx[2], ax[r]);
        ax[r] = fmaf(d4.w, wx[3], ax[r]);
        ah[r] = fmaf(d4.x, wh[0], ah[r]);
        ah[r] = fmaf(d4.y, wh[1], ah[r]);
        ah[r] = fmaf(d4.z, wh[2], ah[r]);
        ah[r] = fmaf(d4.w, wh[3], ah[r]);
      }
    }
    // n gate: dgx takes dt, dgh takes dhn
    for (int i = 2 * D; i < 3 * D; i += 4) {
      float wx[4], wh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wx[q] = __ldg(wih_t + (size_t)(i + q) * D + j);
        wh[q] = __ldg(whh_t + (size_t)(i + q) * D + j);
      }
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const float4 x4 = __ldg(reinterpret_cast<const float4*>(rows[r] + i));
        const float4 h4 = __ldg(reinterpret_cast<const float4*>(rows[r] + i + D));
        ax[r] = fmaf(x4.x, wx[0], ax[r]);
        ax[r] = fmaf(x4.y, wx[1], ax[r]);
        ax[r] = fmaf(x4.z, wx[2], ax[r]);
        ax[r] = fmaf(x4.w, wx[3], ax[r]);
        ah[r] = fmaf(h4.x, wh[0], ah[r]);
        ah[r] = fmaf(h4.y, wh[1], ah[r]);
        ah[r] = fmaf(h4.z, wh[2], ah[r]);
        ah[r] = fmaf(h4.w, wh[3], ah[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      if (v >= n) continue;
      da[(size_t)v * D + j] = ax[r];
      dh[(size_t)v * D + j] = ah[r] + dh[(size_t)v * D + j];
    }
  }
}

// 2. one partial of dWih (z < splits) or dWhh (z >= splits) over one
// node chunk; blocks of the first row tile also sum the bias columns
template <int D>
__global__ void __launch_bounds__(kWThreads)
gru_bwd_weights_kernel(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ delta, float* __restrict__ part,
                       int n, int chunk, int splits) {
  __shared__ float4 xs4[kWNodes * kWK / 4];
  __shared__ float gs[kWNodes][kWJ];
  float* xs = reinterpret_cast<float*>(xs4);
  const int which = blockIdx.z / splits;  // 0: (a, dgx) -> dWih; 1: (h, dgh) -> dWhh
  const int s = blockIdx.z % splits;
  const int j0 = blockIdx.x * kWJ;
  const int k0 = blockIdx.y * kWK;
  const float* x = which == 0 ? a : h;
  const int t = threadIdx.x;
  const int tk = t >> 5;  // rows k0 + 4*tk .. +3
  const int tj = t & 31;  // columns j0 + tj + 32*q
  float acc[4][3], bacc[3];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[p][q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 3; ++q) bacc[q] = 0.0f;

  const int v_begin = s * chunk;
  const int v_end = min(n, v_begin + chunk);
  for (int vb = v_begin; vb < v_end; vb += kWNodes) {
    for (int idx = t; idx < kWNodes * kWK; idx += kWThreads) {
      const int v = vb + idx / kWK;
      xs[idx] = v < v_end ? x[(size_t)v * D + k0 + idx % kWK] : 0.0f;
    }
    for (int idx = t; idx < kWNodes * kWJ; idx += kWThreads) {
      const int v = vb + idx / kWJ;
      const int j = j0 + idx % kWJ;
      const int col = (which == 1 && j >= 2 * D) ? j + D : j;  // dgh's n gate is dhn
      gs[idx / kWJ][idx % kWJ] = v < v_end ? delta[(size_t)v * 4 * D + col] : 0.0f;
    }
    __syncthreads();
    for (int vv = 0; vv < kWNodes; ++vv) {
      const float4 x4 = xs4[(vv * kWK) / 4 + tk];
      const float gq[3] = {gs[vv][tj], gs[vv][tj + 32], gs[vv][tj + 64]};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        acc[0][q] = fmaf(x4.x, gq[q], acc[0][q]);
        acc[1][q] = fmaf(x4.y, gq[q], acc[1][q]);
        acc[2][q] = fmaf(x4.z, gq[q], acc[2][q]);
        acc[3][q] = fmaf(x4.w, gq[q], acc[3][q]);
        bacc[q] += gq[q];
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)s * gru_partial_floats(D);
  float* w = out + (size_t)which * D * 3 * D;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      w[(size_t)(k0 + 4 * tk + p) * 3 * D + j0 + tj + 32 * q] = acc[p][q];
  if (blockIdx.y == 0 && tk == 0) {
    float* b = out + 2 * D * 3 * D + which * 3 * D;
#pragma unroll
    for (int q = 0; q < 3; ++q) b[j0 + tj + 32 * q] = bacc[q];
  }
}

// 3. out[i] = sum over s of part[s][i], in chunk order
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     long long count, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * count + i];
  out[i] = acc;
}

// B4 part 1: q_t = da @ Wm_t^T for every node and type
template <int D>
__global__ void __launch_bounds__(kMsgThreads)
dmsg_transform_kernel(const float* __restrict__ da, const float* __restrict__ wm_t,
                      float* __restrict__ q, int n, int n_etypes) {
  constexpr int C = D / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kNodesPerWarp;
  const int v0 = blockIdx.x * kMsgTileNodes + row0;
  float* das = smem + row0 * D;
  for (int r = 0; r < kNodesPerWarp; ++r) {
    const int v = v0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      das[r * D + j] = v < n ? da[(size_t)v * D + j] : 0.0f;
    }
  }
  __syncwarp();
  for (int t = 0; t < n_etypes; ++t) {
    const float* wt = wm_t + (size_t)t * D * D;  // wt[k][j] = Wm_t[j][k]
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      float acc[kNodesPerWarp];
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) acc[r] = 0.0f;
      for (int k = 0; k < D; k += 4) {
        float wq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) wq[u] = __ldg(wt + (size_t)(k + u) * D + j);
#pragma unroll
        for (int r = 0; r < kNodesPerWarp; ++r) {
          const float4 s = *reinterpret_cast<const float4*>(das + r * D + k);
          acc[r] = fmaf(s.x, wq[0], acc[r]);
          acc[r] = fmaf(s.y, wq[1], acc[r]);
          acc[r] = fmaf(s.z, wq[2], acc[r]);
          acc[r] = fmaf(s.w, wq[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const int v = v0 + r;
        if (v < n) q[((size_t)t * n + v) * D + j] = acc[r];
      }
    }
  }
}

// B4 part 2: each node sums w * q_t[dst] over its src-sorted live run
template <int D>
__global__ void __launch_bounds__(kMsgThreads)
dmsg_gather_kernel(const float* __restrict__ q, const int* __restrict__ dstp,
                   const float* __restrict__ wp, const int* __restrict__ srcptr,
                   float* __restrict__ dh_msg, int n, int e, int n_etypes) {
  constexpr int C = D / 32;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kMsgWarps + (threadIdx.x >> 5);
  if (u >= n) return;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  const int k1 = srcptr[u + 1];
  for (int k = srcptr[u]; k < k1; ++k) {
    const int v = dstp[k];
    for (int t = 0; t < n_etypes; ++t) {
      const float w = wp[(size_t)t * e + k];
      if (w != 0.0f) {
        const float* row = q + ((size_t)t * n + v) * D + lane;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(w, __ldg(row + c * 32), acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dh_msg[(size_t)u * D + c * 32 + lane] = acc[c];
}

template <int D>
cudaError_t launch_gru_bwd(const float* h, const float* a, const float* g, const float* wih,
                           const float* whh, const float* bih, const float* bhh,
                           const float* wih_t, const float* whh_t, float* da, float* dh,
                           float* grads, float* workspace, int n, cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int smem = 2 * kGruTileNodes * D * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_gates_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* delta = workspace;
  float* part = workspace + (size_t)n * 4 * D;
  const int blocks = (n + kGruTileNodes - 1) / kGruTileNodes;
  gru_bwd_gates_kernel<D><<<blocks, kGruThreads, smem, stream>>>(
      h, a, g, wih, whh, bih, bhh, delta, dh, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gru_bwd_inputs_kernel<D><<<blocks, kGruThreads, 0, stream>>>(delta, wih_t, whh_t, da, dh, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunk = gru_chunk(n);
  const int splits = gru_splits(n);
  const dim3 grid(3 * D / kWJ, D / kWK, 2 * splits);
  gru_bwd_weights_kernel<D><<<grid, kWThreads, 0, stream>>>(a, h, delta, part, n, chunk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = gru_partial_floats(D);
  reduce_splits_kernel<<<(int)((count + 255) / 256), 256, 0, stream>>>(part, grads, count, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dmsg(const float* da, const float* wm_t, const int* dstp, const float* wp,
                        const int* srcptr, float* dh_msg, float* q, int n, int e, int n_etypes,
                        cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int smem = kMsgTileNodes * D * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dmsg_transform_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dmsg_transform_kernel<D><<<(n + kMsgTileNodes - 1) / kMsgTileNodes, kMsgThreads, smem, stream>>>(
      da, wm_t, q, n, n_etypes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dmsg_gather_kernel<D><<<(n + kMsgWarps - 1) / kMsgWarps, kMsgThreads, 0, stream>>>(
      q, dstp, wp, srcptr, dh_msg, n, e, n_etypes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of B3's workspace: the [n, 4d] deltas and the weight partials.
long long ggnn_gru_bwd_workspace_floats(int n, int d) {
  return (long long)n * 4 * d + (long long)gru_splits(n) * gru_partial_floats(d);
}

// Node chunks of B3's weight pass for n nodes (PERF.md reports it).
int ggnn_gru_bwd_splits(int n) { return gru_splits(n); }

// B3. Device pointers; shapes: h, a, g, da, dh [n, d]; wih, whh [d, 3d];
// wih_t, whh_t [3d, d] (their transposes); bih, bhh [3d]; grads
// [2*d*3d + 2*3d] receives dWih | dWhh | dbih | dbhh; workspace holds
// ggnn_gru_bwd_workspace_floats(n, d) floats. Returns a cudaError_t.
int ggnn_gru_bwd_f32(const float* h, const float* a, const float* g, const float* wih,
                     const float* whh, const float* bih, const float* bhh,
                     const float* wih_t, const float* whh_t, float* da, float* dh,
                     float* grads, float* workspace, int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRU_CASE(DD) \
  case DD:           \
    return (int)launch_gru_bwd<DD>(h, a, g, wih, whh, bih, bhh, wih_t, whh_t, da, dh, grads, workspace, n, s);
  switch (d) {
    GRU_CASE(32)
    GRU_CASE(64)
    GRU_CASE(96)
    GRU_CASE(128)
    GRU_CASE(160)
    GRU_CASE(192)
    GRU_CASE(224)
    GRU_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GRU_CASE
}

// B4. Device pointers; shapes: da, dh_msg [n, d]; wm_t [n_etypes, d, d]
// with wm_t[t][k][j] = Wm_t[j][k]; dstp [e] and wp [n_etypes, e] in
// src-sorted edge order; srcptr [n + 1] over the live prefix of that
// order; q holds n_etypes * n * d floats. Returns a cudaError_t.
int ggnn_dmsg_f32(const float* da, const float* wm_t, const int* dstp, const float* wp,
                  const int* srcptr, float* dh_msg, float* q, int n, int e, int d,
                  int n_etypes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DMSG_CASE(DD) \
  case DD:            \
    return (int)launch_dmsg<DD>(da, wm_t, dstp, wp, srcptr, dh_msg, q, n, e, n_etypes, s);
  switch (d) {
    DMSG_CASE(32)
    DMSG_CASE(64)
    DMSG_CASE(96)
    DMSG_CASE(128)
    DMSG_CASE(160)
    DMSG_CASE(192)
    DMSG_CASE(224)
    DMSG_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DMSG_CASE
}

const char* ggnn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
