// The fixed-order segment sum of the bit propagation, fp32, for NVIDIA
// Hopper (sm_90a).
//
// One entry point, setops_gather_sum_f32, the card's form of the
// segment_sum inside deepdfa_tpu/nn/setops.py:segment_union (there
// jax.ops.segment_sum, which the reference computes outside any Pallas
// kernel). With rows grouped by a CSR row pointer it computes
//
//     out[v, c] = sum_{j = ptr[v]}^{ptr[v + 1] - 1} y[idx[j], c]
//
// summed one term after another in j order, from 0. The propagation
// (nn/bitprop.py) calls it twice a step: forward with the in-edges of
// each node in edge order (idx = src of the dst-sorted edges), and in its
// backward with the out-edges of each node (idx = dst of the src-sorted
// edges), which is the transposed sum that an atomic scatter would
// otherwise do. Every output has one fixed order of additions, so the
// results are the same bits on every run, and the same as the plain
// version's (the loop over a node's run, in the same order, on the CPU).
//
// Design. The work is a gather: N * B outputs, each a few loads (a CFG
// node has one to a few in-edges; the padding edges are no node's, since
// ptr covers the live edges only). A thread owns one (node, column) and
// consecutive threads own consecutive columns, so a warp's loads of one
// source row are one coalesced 128-byte read at B = 64 (the bit width
// max_defs of the flagship extraction). No shared memory: each row is
// read by the few nodes its edges reach, and L2 serves the repeats.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gather_sum_kernel(const float* __restrict__ y, const int* __restrict__ idx,
                      const int* __restrict__ ptr, float* __restrict__ out, int n, int b) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * b) return;
  const int v = (int)(t / b);
  const int c = (int)(t - (long long)v * b);
  const int lo = ptr[v];
  const int hi = ptr[v + 1];
  float s = 0.0f;
  for (int j = lo; j < hi; ++j) s += y[(long long)idx[j] * b + c];
  out[t] = s;
}

}  // namespace

extern "C" {

// Device pointers; shapes: y [m, b] (any m above every idx entry), idx
// [ptr[n]] int32, ptr [n + 1] int32 non-decreasing from 0, out [n, b].
// Returns a cudaError_t.
int setops_gather_sum_f32(const float* y, const int* idx, const int* ptr, float* out, int n,
                          int b, void* stream) {
  if (n < 0 || b <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long total = (long long)n * b;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_sum_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, idx, ptr, out, n, b);
  return (int)cudaGetLastError();
}

const char* setops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
