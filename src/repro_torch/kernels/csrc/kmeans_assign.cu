// K-means nearest-centroid assignment and the Lloyd-step reduction for
// Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/kmeans_assign.py ::
// kmeans_assign_pallas (_assign_kernel, _assign_kernel_dtiled) and
// kmeans_assign_reduce_pallas (_assign_reduce_kernel, _reduce_tiled_kernel,
// _reduce_tiled_kernel_d).
//
// Functions. For each problem p of a batch, with x the (n, d) slab of
// problem p and mu the (K, d) centroids of problem p:
//   assign[i]  = argmin_k ||mu_k||^2 - 2 x_i . mu_k    (||x_i||^2 dropped;
//                the lowest index wins a tie)
//   sums[k]    = sum_{i: assign[i]=k} w_i x_i,   counts[k] = sum_{...} w_i
// x and mu are f32 or bf16 and are upcast as they are loaded; every sum is
// f32. Problems p = g*R .. g*R+R-1 share the data slab g (x is (G, n, d),
// w is (G, n), the centroids (G*R, K, d)): the R restarts of one client's
// Lloyd run read one copy of its data.
//
// Bound on this card. A data row of 4*d bytes meets R*K centroids at 2*d
// f32 operations each: R*K/2 operations a byte, against the H100's f32
// line of 20 (67 TFLOP/s over 3.35 TB/s). Predict and route (R = 1, K = 20:
// 10 a byte) are bound by reading x; a local Lloyd step (R = 3 restarts,
// K = 15: 22.5 a byte) by the operations. This first version stays far
// from both: a block walks d serially, one dependent tile load and two
// barriers per chunk, so at small n it is bound by latency.
//
// Design. One kernel covers every K and d: a block of 256 threads owns 128
// rows of one problem, walks the centroids in tiles of 16 and the features
// in chunks of 32, both staged in shared memory, each thread accumulating
// a 2-row x 4-centroid block of dot products in registers. No input is
// padded: the loops run to K and d exactly and the ragged edges load 0. A
// thread visits its centroids in increasing order with a strict '<', and
// the four threads that share a row merge (distance, index) pairs with
// the lower index winning equal distances, so the first minimum wins as in
// torch.argmin. ||mu_k||^2 comes from a small kernel, one warp per
// centroid, into scratch the caller allocates.
//
// The reduction is deterministic: one block per (problem, cluster,
// 128-feature chunk) scans the assignments in row order, compacts the rows
// of its cluster (in order) into shared memory, and adds w_i * x_i for
// them one row after another, each thread owning one feature. The order of
// every sum is fixed by the row order alone, so a Lloyd run gives the same
// centroids bit for bit from run to run (no atomics). Rows with w = 0 add
// nothing. It is a second launch after the assignment; fusing the two is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;      // rows per assign block
constexpr int kCents = 16;      // centroids per shared-memory tile
constexpr int kChunk = 32;      // features per shared-memory chunk
constexpr int kThreads = 256;   // assign block: 64 row pairs x 4 groups
constexpr int kRedThreads = 128;  // reduce block: features per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void cent_norms_kernel(const T* __restrict__ cents, int rows,
                                  int d, float* __restrict__ c2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* c = cents + (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(c[j]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) c2[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    assign_kernel(const T* __restrict__ x, const T* __restrict__ cents,
                  const float* __restrict__ c2, int n, int K, int d, int R,
                  int* __restrict__ assign) {
  __shared__ float xs[kRows][kChunk + 1];
  __shared__ float cs[kCents][kChunk + 1];
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const T* xp = x + (size_t)(p / R) * n * d;
  const T* cp = cents + (size_t)p * K * d;
  const float* c2p = c2 + (size_t)p * K;
  const int t = threadIdx.x;
  const int rl = t >> 2;   // rows rl and rl + 64 of the block
  const int g = t & 3;     // centroids g, g + 4, g + 8, g + 12 of a tile

  float best[2] = {INFINITY, INFINITY};
  int arg[2] = {0, 0};
  for (int k0 = 0; k0 < K; k0 += kCents) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int d0 = 0; d0 < d; d0 += kChunk) {
      for (int i = t; i < kRows * kChunk; i += kThreads) {
        const int r = i / kChunk, c = i % kChunk;
        const int gr = row0 + r, gc = d0 + c;
        xs[r][c] = (gr < n && gc < d) ? to_f32(xp[(size_t)gr * d + gc]) : 0.f;
      }
      for (int i = t; i < kCents * kChunk; i += kThreads) {
        const int k = i / kChunk, c = i % kChunk;
        const int gk = k0 + k, gc = d0 + c;
        cs[k][c] = (gk < K && gc < d) ? to_f32(cp[(size_t)gk * d + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        const float x0 = xs[rl][c], x1 = xs[rl + 64][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float cv = cs[g + 4 * j][c];
          acc[0][j] = fmaf(x0, cv, acc[0][j]);
          acc[1][j] = fmaf(x1, cv, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + g + 4 * j;
      if (k >= K) break;
      const float ck = c2p[k];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float dist = ck - 2.f * acc[i][j];
        if (dist < best[i]) {   // strict '<': this thread's first minimum
          best[i] = dist;
          arg[i] = k;
        }
      }
    }
  }
  // merge the four threads of each row: the smaller distance, and on equal
  // distances the lower index
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (ob < best[i] || (ob == best[i] && oa < arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
  }
  if (g == 0) {
    const int r0 = row0 + rl, r1 = row0 + rl + 64;
    if (r0 < n) assign[(size_t)p * n + r0] = arg[0];
    if (r1 < n) assign[(size_t)p * n + r1] = arg[1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    reduce_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ assign, int n, int K, int d, int R,
                  float* __restrict__ sums, float* __restrict__ counts) {
  __shared__ int rows[kRedThreads];
  __shared__ int warp_hits[kRedThreads / 32];
  const int k = blockIdx.x;
  const int col = blockIdx.y * kRedThreads + threadIdx.x;
  const int p = blockIdx.z;
  const T* xp = x + (size_t)(p / R) * n * d;
  const float* wp = w + (size_t)(p / R) * n;
  const int* ap = assign + (size_t)p * n;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  float acc = 0.f, cnt = 0.f;
  for (int base = 0; base < n; base += kRedThreads) {
    const int i = base + t;
    const bool hit = i < n && ap[i] == k && wp[i] != 0.f;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[wid] = __popc(mask);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kRedThreads / 32; ++q) {
      off += q < wid ? warp_hits[q] : 0;
      total += warp_hits[q];
    }
    if (hit) rows[off + __popc(mask & ((1u << lane) - 1u))] = i;
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < total; ++j) {   // the cluster's rows, in row order
      const int r = rows[j];
      const float wr = wp[r];
      if (col < d) acc = fmaf(wr, to_f32(xp[(size_t)r * d + col]), acc);
      cnt += wr;
    }
    __syncthreads();
  }
  if (col < d) sums[((size_t)p * K + k) * d + col] = acc;
  if (blockIdx.y == 0 && t == 0) counts[(size_t)p * K + k] = cnt;
}

template <typename T>
void launch_norms(const void* cents, int rows, int d, void* c2,
                  cudaStream_t s) {
  const int per_block = 8;  // warps of a 256-thread block
  cent_norms_kernel<T><<<(rows + per_block - 1) / per_block, 32 * per_block,
                         0, s>>>(static_cast<const T*>(cents), rows, d,
                                 static_cast<float*>(c2));
}

template <typename T>
void launch_assign(const void* x, const void* cents, void* c2, int P, int R,
                   int n, int K, int d, void* assign, cudaStream_t s) {
  launch_norms<T>(cents, P * K, d, c2, s);
  const dim3 grid((n + kRows - 1) / kRows, P);
  assign_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(cents),
      static_cast<const float*>(c2), n, K, d, R, static_cast<int*>(assign));
}

template <typename T>
void launch_reduce(const void* x, const void* w, const void* assign, int P,
                   int R, int n, int K, int d, void* sums, void* counts,
                   cudaStream_t s) {
  const dim3 grid(K, (d + kRedThreads - 1) / kRedThreads, P);
  reduce_kernel<T><<<grid, kRedThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int*>(assign), n, K, d, R, static_cast<float*>(sums),
      static_cast<float*>(counts));
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16 (x and cents alike). All pointers are device
// pointers to contiguous tensors: x (P/R, n, d), cents (P, K, d), scratch
// c2 (P, K) f32, assign (P, n) int32. Returns cudaGetLastError().
int kmeans_assign(int dtype, const void* x, const void* cents, void* c2,
                  int P, int R, int n, int K, int d, void* assign,
                  void* stream) {
  if (P <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_assign<__nv_bfloat16>(x, cents, c2, P, R, n, K, d, assign, s);
  else
    launch_assign<float>(x, cents, c2, P, R, n, K, d, assign, s);
  return static_cast<int>(cudaGetLastError());
}

// As kmeans_assign, plus w (P/R, n) f32 and the outputs sums (P, K, d) and
// counts (P, K), both f32 and written in full (n = 0 writes zeros).
int kmeans_assign_reduce(int dtype, const void* x, const void* cents,
                         const void* w, void* c2, int P, int R, int n, int K,
                         int d, void* assign, void* sums, void* counts,
                         void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (n > 0)
      launch_assign<__nv_bfloat16>(x, cents, c2, P, R, n, K, d, assign, s);
    launch_reduce<__nv_bfloat16>(x, w, assign, P, R, n, K, d, sums, counts,
                                 s);
  } else {
    if (n > 0) launch_assign<float>(x, cents, c2, P, R, n, K, d, assign, s);
    launch_reduce<float>(x, w, assign, P, R, n, K, d, sums, counts, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
