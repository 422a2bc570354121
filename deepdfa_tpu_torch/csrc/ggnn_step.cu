// One GGNN message-passing step, fp32, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deepdfa_tpu/nn/ggnn_kernel.py:_fwd_kernel
// (launched by _fwd_call; body in _block_aggregate, _edge_messages,
// _aggregate, _gru), in its fp32 per-step form. Per step it computes
//
//   a_v = sum_t sum_{e: dst_e = v} w_{t,e} * (h_{src_e} @ Wm_t + bm_t)
//   h'_v = GRU(a_v, h_v)            (torch convention, gates r, z, n)
//
// with w_{t,e} = edge_mask_e * [edge_type_e == t], and writes h' and,
// when a_out is not null, the aggregate a (the backward's residual).
//
// Design. The TPU kernel staged the whole node table in VMEM, walked a
// sequential grid and scattered with a one-hot MXU product; none of
// that carries over. Here edges are dst-sorted with the live edges a
// prefix (graphs/batch.py), so each node's in-edges are one contiguous
// run, found through a CSR row pointer built once per batch over the
// live prefix only (padded edges, all pointed at node N-1, never enter a
// row). One warp owns kNodesPerWarp nodes:
//   1. it stages its rows of h in shared memory;
//   2. per edge type, each node sums w * h_src and w over its run in edge
//      order (one column per lane, no atomics: deterministic), then
//      applies Wm_t and bm_t once per node. By linearity this costs
//      N*d^2 per type instead of E*d^2; it is a reassociation of the
//      reference's sum and nothing else;
//   3. it computes gx = a @ Wih + bih and gh = h @ Whh + bhh column by
//      column and applies the gates.
// Warps share nothing, so there is no block-wide barrier. All sums are
// IEEE fp32 FMA: no tensor cores, no TF32.
//
// Bound on this card. One flagship step (N 16384, d 128, T 1) does
// 2*N*d^2*T + 12*N*d^2 ~ 3.8 GFLOP against ~16 MB of node state moved
// (h in, h' out), so it is bound by fp32 operations (67 TFLOP/s) and not
// by HBM (3.35 TB/s). The GRU products dominate. Their weights, [d, 3d]
// twice, do not fit beside the shared tiles in L1 and are streamed from
// L2 by every warp; each weight load feeds 8 nodes' FMAs, and the state
// rows are read from shared memory as float4 broadcasts. Tensor-core
// (wgmma) tiles and TMA-staged weights are the next step for speed.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNodesPerWarp = 8;
constexpr int kTileNodes = kWarps * kNodesPerWarp;  // nodes per block

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ggnn_step_kernel(const float* __restrict__ h, const int* __restrict__ src,
                 const float* __restrict__ w2, const int* __restrict__ rowptr,
                 const float* __restrict__ wm, const float* __restrict__ bm,
                 const float* __restrict__ wih, const float* __restrict__ whh,
                 const float* __restrict__ bih, const float* __restrict__ bhh,
                 float* __restrict__ h_out, float* __restrict__ a_out,
                 int n, int e, int n_etypes) {
  constexpr int C = D / 32;  // columns per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kNodesPerWarp;  // this warp's first tile row
  const int v0 = blockIdx.x * kTileNodes + row0;
  // this warp's slices: h rows, sum(w*h_src) rows, aggregate rows, sum(w)
  float* hs = smem + row0 * D;
  float* ss = smem + kTileNodes * D + row0 * D;
  float* as = smem + 2 * kTileNodes * D + row0 * D;
  float* cs = smem + 3 * kTileNodes * D + row0;

  for (int r = 0; r < kNodesPerWarp; ++r) {
    const int v = v0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      hs[r * D + j] = v < n ? h[(size_t)v * D + j] : 0.0f;
    }
  }

  for (int t = 0; t < n_etypes; ++t) {
    const float* wt = w2 + (size_t)t * e;
    // 2. sum each node's run in edge order
    for (int r = 0; r < kNodesPerWarp; ++r) {
      const int v = v0 + r;
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
      float cw = 0.0f;
      if (v < n) {
        const int e1 = rowptr[v + 1];
        for (int k = rowptr[v]; k < e1; ++k) {
          const float w = wt[k];
          if (w != 0.0f) {
            const float* hrow = h + (size_t)src[k] * D + lane;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = fmaf(w, __ldg(hrow + c * 32), acc[c]);
            cw += w;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) ss[r * D + c * 32 + lane] = acc[c];
      if (lane == 0) cs[r] = cw;
    }
    __syncwarp();
    // ... then apply Wm_t, bm_t once per node; a accumulates over types
    const float* wmt = wm + (size_t)t * D * D;
    const float* bmt = bm + (size_t)t * D;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      float acc[kNodesPerWarp];
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) acc[r] = 0.0f;
      for (int k = 0; k < D; k += 4) {
        float wq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wq[q] = __ldg(wmt + (k + q) * D + j);
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
#pragma unroll
      for (int r = 0; r < kNodesPerWarp; ++r) {
        const float val = fmaf(cs[r], b, acc[r]);
        as[r * D + j] = t == 0 ? val : as[r * D + j] + val;
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
      const float ng = tanhf((xn[r] + b_in) + rg * (hn[r] + b_hn));
      h_out[(size_t)v * D + j] = (1.0f - zg) * ng + zg * hs[r * D + j];
      if (a_out != nullptr) a_out[(size_t)v * D + j] = as[r * D + j];
    }
  }
}

template <int D>
cudaError_t launch(const float* h, const int* src, const float* w2, const int* rowptr,
                   const float* wm, const float* bm, const float* wih, const float* whh,
                   const float* bih, const float* bhh, float* h_out, float* a_out,
                   int n, int e, int n_etypes, cudaStream_t stream) {
  const int smem = (3 * kTileNodes * D + kTileNodes) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ggnn_step_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + kTileNodes - 1) / kTileNodes;
  if (grid == 0) return cudaSuccess;
  ggnn_step_kernel<D><<<grid, kThreads, smem, stream>>>(
      h, src, w2, rowptr, wm, bm, wih, whh, bih, bhh, h_out, a_out, n, e, n_etypes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Nodes per thread block; the wrapper reads it for its shape checks.
int ggnn_step_tile_nodes() { return kTileNodes; }

// Dynamic shared memory of one block at width d, in bytes.
int ggnn_step_smem_bytes(int d) { return (3 * kTileNodes * d + kTileNodes) * (int)sizeof(float); }

// One step. Pointers are device pointers; a_out may be null. Shapes:
// h, h_out, a_out [n, d]; src [e]; w2 [n_etypes, e]; rowptr [n + 1]
// (rowptr[n] = live edge count); wm [n_etypes, d, d]; bm [n_etypes, d];
// wih, whh [d, 3d]; bih, bhh [3d]. Returns a cudaError_t as int.
int ggnn_step_f32(const float* h, const int* src, const float* w2, const int* rowptr,
                  const float* wm, const float* bm, const float* wih, const float* whh,
                  const float* bih, const float* bhh, float* h_out, float* a_out,
                  int n, int e, int d, int n_etypes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_CASE(DD) \
  case DD:            \
    return (int)launch<DD>(h, src, w2, rowptr, wm, bm, wih, whh, bih, bhh, h_out, a_out, n, e, n_etypes, s);
  switch (d) {
    GGNN_CASE(32)
    GGNN_CASE(64)
    GGNN_CASE(96)
    GGNN_CASE(128)
    GGNN_CASE(160)
    GGNN_CASE(192)
    GGNN_CASE(224)
    GGNN_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GGNN_CASE
}

const char* ggnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
