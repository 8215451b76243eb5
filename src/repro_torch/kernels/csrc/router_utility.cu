// Fused routing decision for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/router_utility.py ::
// router_utility_pallas (_kernel). For each row of trunk features h (n, dh):
//   A = sigmoid(h . Wa + ba), C = h . Wc + bc, U = A - lam * C   (M models)
// and returns argmax_m U (first index on ties) and max_m U, all in f32.
//
// Bound on this card: at the serving shapes (n a pow2 bucket of a few to a
// few thousand rows, dh = 512, M = 2) the work is ~4*n*dh*M flops over
// n*dh*4 bytes of h — far below the H100's operations-per-byte line, so the
// kernel is bound by reading h (and, at small n, by launch latency). The
// design reads each h row once with one warp: the lanes split dh, both head
// dot products for every model column are accumulated in f32 registers and
// reduced with warp shuffles, and the sigmoid / lambda-combine / running
// argmax epilogue runs in registers, so A, C and U never reach memory.
// There are no padded model columns: the loop runs to M exactly.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void router_utility_kernel(const float* __restrict__ h,
                                      const float* __restrict__ aw,
                                      const float* __restrict__ ab,
                                      const float* __restrict__ cw,
                                      const float* __restrict__ cb, float lam,
                                      int n, int dh, int M,
                                      int* __restrict__ choice,
                                      float* __restrict__ best) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* hr = h + (size_t)row * dh;
  float best_u = -INFINITY;
  int best_m = 0;
  for (int m = 0; m < M; ++m) {
    float a = 0.f, c = 0.f;
    for (int k = lane; k < dh; k += 32) {
      const float x = hr[k];
      a = fmaf(x, aw[(size_t)k * M + m], a);
      c = fmaf(x, cw[(size_t)k * M + m], c);
    }
    a = warp_sum(a) + ab[m];
    c = warp_sum(c) + cb[m];
    const float A = 1.f / (1.f + expf(-a));
    const float U = A - lam * c;
    if (U > best_u || m == 0) {  // strict '>' keeps the first index
      best_u = U;
      best_m = m;
    }
  }
  if (lane == 0) {
    choice[row] = best_m;
    best[row] = best_u;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers to contiguous f32 (choice: int32).
// Returns cudaGetLastError() after the launch.
int router_utility_f32(const void* h, const void* aw, const void* ab,
                       const void* cw, const void* cb, float lam, int n, int dh,
                       int M, void* choice, void* best, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  router_utility_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(aw),
      static_cast<const float*>(ab), static_cast<const float*>(cw),
      static_cast<const float*>(cb), lam, n, dh, M, static_cast<int*>(choice),
      static_cast<float*>(best));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
