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
// kernel is bound by reading h and, at the served buckets of 1-16 rows, by
// the latency of one launch and of the loads and shuffles a row waits for.
//
// Design: one warp takes one row and reads it once for all models (up to
// 16 at a time; more are taken in groups of 16, the running argmax carried
// from group to group). At n = 16 the time is a chain of round trips to
// memory, so a block of 8 rows first copies the group's head weights into
// shared memory (a chunk of up to 512 features at a time: every load of
// the chunk in flight at once, the rows' h loads beside them), then the
// lanes own features: float4 loads of h when dh % 4 == 0 and h is 16-byte
// aligned, one feature at a time otherwise. For each of its features a
// lane reads the 2 x MG weights of the group, contiguous in shared memory
// (a feature's row holds the accuracy and cost weights of each model side
// by side, an odd number of 16-byte units wide, and with float4 h the rows
// are ordered so that the 32 lanes read 32 consecutive rows: no bank
// conflicts), and keeps 2 x MG f32 partials in registers. One butterfly
// then adds them across the warp while halving the values each lane holds
// (a transpose-reduce: 2(MG - 1) + 2(5 - log2 MG) shuffles in place of
// 10 MG), so that lane m holds model m's two sums (so does every lane with
// the same low log2 MG bits). The sigmoid, the lambda combine and U run
// on MG lanes at once, and an argmax across those lanes (the lower index
// wins a tie) finds the best; A, C and U never reach memory. There are no
// padded model columns: a group past M leaves its lanes out of the argmax.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kGroup = 16;   // models a pass at most
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory chunk of one group of MG models: kFC features, each a
// row of kStride floats (a_0, c_0, a_1, c_1, ..., padding); kStride / 4
// is odd, so 8 lanes reading 16 bytes from 8 consecutive rows hit
// distinct banks.
template <int MG>
struct Chunk {
  static constexpr int kFC = MG == kGroup ? 256 : 512;
  static constexpr int kW = (2 * MG + 3) / 4 * 4;
  static constexpr int kStride = (kW / 4) % 2 ? kW : kW + 4;
  // the row of chunk feature f: with float4 h, lane L's e-th feature of
  // its i-th load (f = 128 i + 4 L + e) sits in row e * kFC / 4 + 32 i + L
  template <bool VEC>
  __device__ static int row(int f) {
    return VEC ? (f & 3) * (kFC / 4) + (f >> 2) : f;
  }
};

// the halving steps of the transpose-reduce, offsets HALF, HALF / 2, .. 1:
// at offset HALF a lane keeps the upper half of its models if its bit HALF
// is set, the lower half if not, and adds its partner's copy of that half
template <int HALF>
__device__ __forceinline__ void halve(float* v, int lane) {
  if constexpr (HALF >= 1) {
    const bool up = lane & HALF;
#pragma unroll
    for (int i = 0; i < 2 * HALF; ++i) {
      const float send = up ? v[i] : v[i + 2 * HALF];
      const float keep = up ? v[i + 2 * HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, HALF);
    }
    halve<HALF / 2>(v, lane);
  }
}

// v[2m], v[2m + 1] += x times model m's accuracy and cost weights
template <int MG>
__device__ __forceinline__ void accumulate(float x, const float* w,
                                           float* v) {
#pragma unroll
  for (int q = 0; q < Chunk<MG>::kW / 4; ++q) {
    const float4 wq = *reinterpret_cast<const float4*>(w + 4 * q);
    const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < 2 * MG) v[4 * q + e] = fmaf(x, wv[e], v[4 * q + e]);
  }
}

template <int MG, bool VEC>
__global__ void __launch_bounds__(kThreads)
    router_utility_kernel(const float* __restrict__ h,
                          const float* __restrict__ aw,
                          const float* __restrict__ ab,
                          const float* __restrict__ cw,
                          const float* __restrict__ cb, float lam, int n,
                          int dh, int M, int* __restrict__ choice,
                          float* __restrict__ best) {
  using C = Chunk<MG>;
  constexpr int kLoads = VEC ? C::kFC / 128 : C::kFC / 32;   // h a lane
  __shared__ __align__(16) float sw[C::kFC * C::kStride];
  const int t = threadIdx.x, lane = t & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (t >> 5);
  const bool live = row < n;   // every warp helps to stage the weights
  const float* hr = h + (size_t)(live ? row : 0) * dh;
  const int m = lane & (MG - 1);   // this lane's model after the butterfly
  float best_u = -INFINITY;
  int best_m = 0;
  for (int m0 = 0; m0 < M; m0 += MG) {
    const int mg = min(MG, M - m0);
    float v[2 * MG];
#pragma unroll
    for (int i = 0; i < 2 * MG; ++i) v[i] = 0.f;
    for (int f0 = 0; f0 < dh; f0 += C::kFC) {
      // this lane's h of the chunk, in flight beside the weights' loads
      float4 xr[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int f = f0 + (VEC ? 128 * i + 4 * lane : 32 * i + lane);
        if (!live || f >= dh) {
          xr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if constexpr (VEC) {
          xr[i] = *reinterpret_cast<const float4*>(hr + f);
        } else {
          xr[i] = make_float4(hr[f], 0.f, 0.f, 0.f);
        }
      }
      __syncthreads();   // the previous chunk is consumed
#pragma unroll
      for (int i = 0; i < C::kFC * MG / kThreads; ++i) {
        const int e = t + i * kThreads, f = e / MG, mm = e % MG;
        const bool ok = f0 + f < dh && mm < mg;
        const size_t o = (size_t)(f0 + f) * M + m0 + mm;
        float* dst = sw + C::template row<VEC>(f) * C::kStride + 2 * mm;
        dst[0] = ok ? aw[o] : 0.f;
        dst[1] = ok ? cw[o] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        if constexpr (VEC) {
          const float xe[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            accumulate<MG>(
                xe[e],
                sw + C::template row<VEC>(128 * i + 4 * lane + e) * C::kStride,
                v);
        } else {
          accumulate<MG>(xr[i].x,
                         sw + C::template row<VEC>(32 * i + lane) * C::kStride,
                         v);
        }
      }
    }
    halve<MG / 2>(v, lane);
#pragma unroll
    for (int off = MG; off < 32; off <<= 1) {
      v[0] += __shfl_xor_sync(kFull, v[0], off);
      v[1] += __shfl_xor_sync(kFull, v[1], off);
    }
    float u = -INFINITY;
    int um = INT_MAX;
    if (m < mg) {
      const float A = 1.f / (1.f + expf(-(v[0] + ab[m0 + m])));
      u = A - lam * (v[1] + cb[m0 + m]);
      um = m0 + m;
    }
#pragma unroll
    for (int off = 1; off < MG; off <<= 1) {
      const float ou = __shfl_xor_sync(kFull, u, off);
      const int om = __shfl_xor_sync(kFull, um, off);
      if (ou > u || (ou == u && om < um)) {
        u = ou;
        um = om;
      }
    }
    if (m0 == 0 || u > best_u) {   // strict '>' keeps the earlier group
      best_u = u;
      best_m = um;
    }
  }
  if (live && lane == 0) {
    choice[row] = best_m;
    best[row] = best_u;
  }
}

template <int MG>
int launch(const float* h, const float* aw, const float* ab, const float* cw,
           const float* cb, float lam, int n, int dh, int M, int* choice,
           float* best, cudaStream_t s) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = dh % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  if (vec)
    router_utility_kernel<MG, true><<<blocks, kThreads, 0, s>>>(
        h, aw, ab, cw, cb, lam, n, dh, M, choice, best);
  else
    router_utility_kernel<MG, false><<<blocks, kThreads, 0, s>>>(
        h, aw, ab, cw, cb, lam, n, dh, M, choice, best);
  return static_cast<int>(cudaGetLastError());
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
  const auto* hf = static_cast<const float*>(h);
  const auto* awf = static_cast<const float*>(aw);
  const auto* abf = static_cast<const float*>(ab);
  const auto* cwf = static_cast<const float*>(cw);
  const auto* cbf = static_cast<const float*>(cb);
  auto* ci = static_cast<int*>(choice);
  auto* bf = static_cast<float*>(best);
  auto* s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch<1>(hf, awf, abf, cwf, cbf, lam, n, dh, M, ci, bf, s);
  if (M <= 2) return launch<2>(hf, awf, abf, cwf, cbf, lam, n, dh, M, ci, bf, s);
  if (M <= 4) return launch<4>(hf, awf, abf, cwf, cbf, lam, n, dh, M, ci, bf, s);
  if (M <= 8) return launch<8>(hf, awf, abf, cwf, cbf, lam, n, dh, M, ci, bf, s);
  return launch<kGroup>(hf, awf, abf, cwf, cbf, lam, n, dh, M, ci, bf, s);
}

}  // extern "C"
