// Flash-attention forward for NVIDIA Hopper (sm_90a): bf16 on tensor
// cores (mma.sync), fp32 in IEEE FMA loops.
//
// Replaces the TPU kernel deepdfa_tpu/nn/flash_attention.py:_fwd_kernel
// (launched by _fwd_call), without its dropout, bias and causal options.
// For q [B, H, Tq, D], k, v [B, H, Tk, D] and a kv mask [B, Tk] it computes,
// per (b, h, query row i),
//
//   s_j = q_i . k_j * scale        where mask[b, j], else -1e30
//   m   = max_j s_j,   p_j = exp(s_j - m) where mask[b, j], else 0
//   l   = sum_j p_j                                     (fp32)
//   o_i = (sum_j round(p_j) * v_j) / max(l, FLT_MIN)    (fp32 sums)
//   lse_i = m + log(max(l, FLT_MIN))                    (fp32)
//
// where round() casts p to the input dtype before the p.v product, as
// the reference does (`pv.astype(v_blk.dtype)`). An all-padding row has
// l = 0 and gets o = 0 and a finite lse (-1e30), never NaN.
//
// Design. The TPU kernel held the whole k/v strip of one (b, h) in VMEM
// (block_k = min(512, Tk)) and ran its k loop inside one program. A
// Hopper block has 227 KB of shared memory and blocks run in parallel,
// so here each block owns one (b*h, q-tile) and streams k/v through
// shared memory in 64-key tiles with the FlashAttention-2 online softmax:
// the running max and sum live in fp32 registers and the accumulator is
// rescaled by exp(m_old - m_new) whenever the max grows. Keys past Tk
// are loaded as zeros and masked, so any Tq and Tk are taken.
//
//  - bf16, D a multiple of 16 (<= 128): 4 warps, 16 query rows each
//    (64 per block). Q stays in registers as mma A fragments; S = Q K^T
//    and O += P V are mma.sync m16n8k16 bf16 products with fp32
//    accumulators; P is reused from the S accumulators as the next A
//    fragment (converted to bf16, which is the reference's rounding of
//    p); V's B fragments come from row-major shared memory through
//    ldmatrix.trans. Shared rows are padded by 8 elements so the
//    fragment loads hit 32 distinct banks.
//  - fp32 (and bf16 at other widths): 4 warps, 4 query rows each;
//    each lane scores one key of a 32-key tile and owns D/32 output
//    columns. Plain fp32 FMA, no TF32.
//
// Bound on this card. One flagship call (B 16, H 12, T 512, D 64, bf16)
// does 4*B*H*T^2*D = 12.9 GFLOP (0.013 ms at 989 TFLOP/s) and must move
// q, k, v and o once, ~50 MB (0.015 ms at 3.35 TB/s): it is bound by
// bytes, barely. This first version has no TMA, no wgmma and no
// double buffering: each tile's loads wait on a barrier, and the k/v
// tiles are re-read from L2 by each of the Tq/64 q-tile blocks of a
// (b, h); the 8 q tiles of a (b, h) are neighbouring blocks, so those
// re-reads hit L2 rather than HBM.
//
// The wrapper (nn/flash_attention.py:flash_fwd) passes each operand's
// (batch, head, token) strides; the innermost dimension is contiguous.
// It writes o into a [B, Tq, H, D] buffer (its strides say so), which
// the encoder's output projection reads without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;              // the reference's _NEG_BIG
constexpr float kTiny = 1.17549435082228751e-38f;  // jnp.finfo(float32).tiny
constexpr int kMaxD = 128;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = kMmaWarps * 16;  // query rows per block
constexpr int kMmaKeys = 64;               // keys per k/v tile

constexpr int kScalarWarps = 4;
constexpr int kScalarThreads = kScalarWarps * 32;
constexpr int kScalarRowsPerWarp = 4;
constexpr int kScalarRows = kScalarWarps * kScalarRowsPerWarp;
constexpr int kScalarKeys = 32;  // one key per lane

struct Strides {
  long long b, h, t;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // [B, Tk], nonzero = a real key
  void* o;
  float* lse;  // [B, H, Tq] contiguous
  int B, H, Tq, Tk, D;
  float scale;
  Strides sq, sk, sv, so;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a k16 x n8 tile stored row-major (rows = k) at `row0`:
// lanes 0-15 address rows 0-15; .trans hands each lane B[2t, 2t+1][g].
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* row0) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col,
                                              int rows, long long stride) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * stride + col);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_mma(Args a) {
  constexpr int KS = D + 8;  // padded shared row, in elements
  constexpr int NJ = kMmaKeys / 8;  // n8 tiles of S
  constexpr int NK = D / 16;  // k16 steps of Q K^T
  constexpr int NO = D / 8;  // n8 tiles of O
  __shared__ __align__(16) __nv_bfloat16 k_s[kMmaKeys * KS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kMmaKeys * KS];
  __shared__ float ok_s[kMmaKeys];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int r0 = blockIdx.x * kMmaRows + warp * 16 + g;  // this lane's rows
  const int r1 = r0 + 8;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* maskp = a.mask + (long long)b * a.Tk;

  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qp, r0, c, a.Tq, a.sq.t);
    qf[kk][1] = load_pair(qp, r1, c, a.Tq, a.sq.t);
    qf[kk][2] = load_pair(qp, r0, c + 8, a.Tq, a.sq.t);
    qf[kk][3] = load_pair(qp, r1, c + 8, a.Tq, a.sq.t);
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNegBig, m1 = kNegBig;  // running max of rows r0, r1 (quad-uniform)
  float l0 = 0.0f, l1 = 0.0f;  // this lane's share of the running sums

  for (int k0 = 0; k0 < a.Tk; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int idx = tid; idx < kMmaKeys * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < a.Tk) {
        kv = *reinterpret_cast<const uint4*>(kp + key * a.sk.t + c);
        vv = *reinterpret_cast<const uint4*>(vp + key * a.sv.t + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * KS + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * KS + c) = vv;
    }
    if (tid < kMmaKeys) {
      const int key = k0 + tid;
      ok_s[tid] = (key < a.Tk && maskp[key] != 0) ? 1.0f : 0.0f;
    }
    __syncthreads();

    // S = Q K^T: rows (r0, r1), columns j*8 + 2t + {0, 1}
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* kr = k_s + (j * 8 + g) * KS + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // scale and mask, the tile's row max over the quad
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = ok_s[j * 8 + 2 * t + e] != 0.0f;
        s[j][e] = ok ? s[j][e] * a.scale : kNegBig;
        s[j][2 + e] = ok ? s[j][2 + e] * a.scale : kNegBig;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = ok_s[j * 8 + 2 * t + e] != 0.0f;
        s[j][e] = ok ? expf(s[j][e] - mn0) : 0.0f;
        s[j][2 + e] = ok ? expf(s[j][2 + e] - mn1) : 0.0f;
        ls0 += s[j][e];
        ls1 += s[j][2 + e];
      }
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += bf16(P) V: the S accumulators of n-tiles 2kk, 2kk+1 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, v_s + (kk * 16 + (lane & 15)) * KS + n * 8);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, kTiny), d1 = fmaxf(l1, kTiny);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < a.Tq)
      *reinterpret_cast<__nv_bfloat162*>(op + r0 * a.so.t + c) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (r1 < a.Tq)
      *reinterpret_cast<__nv_bfloat162*>(op + r1 * a.so.t + c) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
  if (t == 0) {
    float* lp = a.lse + (long long)bh * a.Tq;
    if (r0 < a.Tq) lp[r0] = m0 + logf(d0);
    if (r1 < a.Tq) lp[r1] = m1 + logf(d1);
  }
}

// ---------------------------------------------------------------------------
// fp32 (and bf16 at widths the mma path does not take): FMA loops

template <typename T>
__global__ void __launch_bounds__(kScalarThreads) flash_fwd_scalar(Args a) {
  constexpr int C = kMaxD / 32;  // output columns per lane, at most
  __shared__ float q_s[kScalarRows][kMaxD];
  __shared__ float k_s[kScalarKeys][kMaxD + 1];  // +1: lanes read distinct banks
  __shared__ float v_s[kScalarKeys][kMaxD];
  __shared__ float p_s[kScalarWarps][kScalarKeys];
  __shared__ float ok_s[kScalarKeys];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * kScalarRows;
  const int D = a.D;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* maskp = a.mask + (long long)b * a.Tk;

  for (int idx = tid; idx < kScalarRows * D; idx += kScalarThreads) {
    const int r = idx / D, c = idx - r * D;
    q_s[r][c] = q0 + r < a.Tq ? to_f(qp[(q0 + r) * a.sq.t + c]) : 0.0f;
  }
  float m[kScalarRowsPerWarp], l[kScalarRowsPerWarp], acc[kScalarRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kScalarRowsPerWarp; ++i) {
    m[i] = kNegBig;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < a.Tk; k0 += kScalarKeys) {
    __syncthreads();
    for (int idx = tid; idx < kScalarKeys * D; idx += kScalarThreads) {
      const int r = idx / D, c = idx - r * D;
      const int key = k0 + r;
      k_s[r][c] = key < a.Tk ? to_f(kp[key * a.sk.t + c]) : 0.0f;
      v_s[r][c] = key < a.Tk ? to_f(vp[key * a.sv.t + c]) : 0.0f;
    }
    if (tid < kScalarKeys) {
      const int key = k0 + tid;
      ok_s[tid] = (key < a.Tk && maskp[key] != 0) ? 1.0f : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScalarRowsPerWarp; ++i) {
      const int row = warp * kScalarRowsPerWarp + i;
      if (q0 + row >= a.Tq) continue;  // warp-uniform
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(q_s[row][d], k_s[lane][d], s);
      const bool ok = ok_s[lane] != 0.0f;
      const float x = ok ? s * a.scale : kNegBig;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.0f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      p_s[warp][lane] = to_f(from_f<T>(p));  // p in v's dtype for p.v
      __syncwarp();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = c * 32 + lane;
        if (d < D) {
          float x_acc = acc[i][c] * alpha;
          for (int j = 0; j < kScalarKeys; ++j) x_acc = fmaf(p_s[warp][j], v_s[j][d], x_acc);
          acc[i][c] = x_acc;
        }
      }
      __syncwarp();
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < kScalarRowsPerWarp; ++i) {
    const int row = q0 + warp * kScalarRowsPerWarp + i;
    if (row >= a.Tq) continue;
    const float den = fmaxf(l[i], kTiny);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) op[row * a.so.t + d] = from_f<T>(acc[i][c] / den);
    }
    if (lane == 0) a.lse[(long long)bh * a.Tq + row] = m[i] + logf(den);
  }
}

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kMmaRows - 1) / kMmaRows, a.B * a.H);
  flash_fwd_bf16_mma<D><<<grid, kMmaThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Query rows per thread block of the mma (1) and FMA (0) paths.
int flash_fwd_tile_rows(int use_mma) { return use_mma ? kMmaRows : kScalarRows; }

// Widest head the kernel takes.
int flash_fwd_max_head_dim() { return kMaxD; }

// One forward call. q, k, v, o, mask and lse are device pointers; strides
// is a host array of 12 element strides: (batch, head, token) of q, k, v
// and o, whose innermost dimension is contiguous. dtype_bf16 selects
// bf16 (else fp32) for q, k, v and o; lse is fp32 [B, H, Tq]; mask is
// int32 [B, Tk]. use_mma takes the tensor-core path (bf16, D % 16 == 0,
// 16-byte aligned pointers, strides multiples of 8). Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
              int B, int H, int Tq, int Tk, int D, float scale, int dtype_bf16, int use_mma,
              const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
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
  a.scale = scale;
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.so = Strides{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!dtype_bf16) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 16: return (int)launch_mma<16>(a, s);
      case 32: return (int)launch_mma<32>(a, s);
      case 48: return (int)launch_mma<48>(a, s);
      case 64: return (int)launch_mma<64>(a, s);
      case 80: return (int)launch_mma<80>(a, s);
      case 96: return (int)launch_mma<96>(a, s);
      case 112: return (int)launch_mma<112>(a, s);
      case 128: return (int)launch_mma<128>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid((Tq + kScalarRows - 1) / kScalarRows, B * H);
  if (dtype_bf16)
    flash_fwd_scalar<__nv_bfloat16><<<grid, kScalarThreads, 0, s>>>(a);
  else
    flash_fwd_scalar<float><<<grid, kScalarThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
