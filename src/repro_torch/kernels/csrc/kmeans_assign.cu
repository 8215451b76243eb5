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
// f32 on the CUDA cores (TF32 tensor cores would keep ~3 digits and move
// the argmin off near-ties). Problems p = g*R .. g*R+R-1 share the data
// slab g (x is (G, n, d), w is (G, n), the centroids (G*R, K, d)): the R
// restarts of one client's Lloyd run read one copy of its data.
//
// Bound on this card. A data row of 4*d bytes meets R*K centroids at 2*d
// f32 operations each: R*K/2 operations a byte, against the H100's f32
// line of 20 (67 TFLOP/s over 3.35 TB/s). Predict and route (R = 1, K = 20:
// 10 a byte) are bound by reading x once; a local Lloyd step (R = 3
// restarts, K = 15: 22.5 a byte) sits on the line.
//
// Assignment design: x is read from device memory once per call. One block
// of 256 threads owns 32 rows of one data slab g and every centroid of the
// slab's R problems (R*K of them: 20 at predict, 45 at the Lloyd shape), so
// the grid is (row tiles, G) and a slab's restarts share its rows; 32-row
// tiles give 282 blocks at predict (9,005 rows) on the 132 SMs. The
// features are walked in chunks of 64: the chunk of x (32 x 64) and the
// chunk of every centroid are staged in shared memory as f32 in a ring of
// three buffers, the next two chunks' copies in flight (cp.async, 16
// bytes, zero-filled past the edges) while this one is multiplied, one
// barrier a chunk; 2-3 blocks share an SM. Within
// a chunk the 8 warps split the features (8 each) and a lane owns one row,
// so a row tile is not a serial walk over d even at routing's 12 rows:
// each thread keeps the row's partial dot with every centroid in
// registers, reading its x values once and the centroids as broadcasts.
// ||mu_k||^2 is summed in the block from the same staged chunks (no
// separate launch). At the end the 8 warps' partial dots are added in a
// fixed tree through shared memory and warp 0 scans the centroids in
// increasing order with a strict '<', so the first minimum wins as in
// torch.argmin. Centroid groups: up to 64 centroids are held at once; a
// slab with more (R*K > 64, e.g. K 1,000) loops over groups of 64, each
// pass streaming x again, with the running minimum carried from group to
// group in order. bf16 inputs, and f32 rows that are not 16-byte aligned
// (d not a multiple of 4), are staged through registers instead of
// cp.async: the next chunk is loaded into registers before this chunk's
// products and stored after them. No input is padded and every K >= 1,
// d >= 1, G and R is taken.
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
#include <stdint.h>

namespace {

constexpr int kRows = 32;         // rows per assign block: one per lane
constexpr int kChunk = 64;        // features per staged chunk
constexpr int kWarps = 8;         // assign block: warps split each chunk
constexpr int kThreads = 32 * kWarps;
constexpr int kFeat = kChunk / kWarps;   // features of a chunk per warp
constexpr int kStride = kChunk + 4;      // smem row stride, float4 aligned
constexpr int kBufs = 3;          // chunk buffers: two chunks in flight
constexpr int kRedThreads = 128;  // reduce block: features per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared memory of an assign block with CG centroids a group, in floats:
// x chunks [kBufs][kRows][kStride], centroid chunks [kBufs][CG][kStride], each
// warp's partial ||mu||^2 [kWarps][CG] and their sums [CG]. After the
// chunk loop the chunk buffers hold the cross-warp reduction, [4][CG][32].
template <int CG>
struct Smem {
  static constexpr int xs = 0;
  static constexpr int cs = xs + kBufs * kRows * kStride;
  static constexpr int c2w = cs + kBufs * CG * kStride;
  static constexpr int c2 = c2w + kWarps * CG;
  static constexpr size_t bytes = (size_t)(c2 + CG) * sizeof(float);
  static_assert(4 * CG * 32 <= c2w, "reduction fits the chunk buffers");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Staging of one chunk (features f0 .. f0 + 63) of the block's rows and of
// centroids c0 .. c0 + nc - 1; everything past n or d reads 0 (the
// asynchronous copies leave the rows of absent centroids as they were:
// nothing reads them).
template <typename T, int CG>
struct Stage {
  const T* xg;   // the slab's rows row0 ..
  const T* cg;   // the group's first centroid
  int rows, nc, d;

  // 16-byte asynchronous copies (f32, d % 4 == 0, 16-byte aligned)
  __device__ __forceinline__ void async(float* xs, float* cs, int f0) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kRows * kChunk / 4 / kThreads; ++i) {
      const int seg = t + i * kThreads, r = seg / (kChunk / 4),
                f = f0 + 4 * (seg % (kChunk / 4));
      const bool ok = r < rows && f < d;
      cp_async16(xs + r * kStride + f - f0,
                 ok ? reinterpret_cast<const float*>(xg) + (size_t)r * d + f
                    : reinterpret_cast<const float*>(xg),
                 ok);
    }
#pragma unroll
    for (int i = 0; i < CG * kChunk / 4 / kThreads; ++i) {
      const int seg = t + i * kThreads, c = seg / (kChunk / 4),
                f = f0 + 4 * (seg % (kChunk / 4));
      if (c < nc)
        cp_async16(cs + c * kStride + f - f0,
                   f < d ? reinterpret_cast<const float*>(cg) + (size_t)c * d + f
                         : reinterpret_cast<const float*>(cg),
                   f < d);
    }
  }

  // element loads into registers, upcast, then stores (any dtype and d)
  static constexpr int kXRegs = kRows * kChunk / kThreads;
  static constexpr int kCRegs = CG * kChunk / kThreads;
  __device__ __forceinline__ void load(float* xr, float* cr, int f0) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      const int e = t + i * kThreads, r = e / kChunk, f = f0 + e % kChunk;
      xr[i] = r < rows && f < d ? to_f32(xg[(size_t)r * d + f]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kCRegs; ++i) {
      const int e = t + i * kThreads, c = e / kChunk, f = f0 + e % kChunk;
      cr[i] = c < nc && f < d ? to_f32(cg[(size_t)c * d + f]) : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* xs, float* cs, const float* xr,
                                        const float* cr) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      const int e = t + i * kThreads;
      xs[(e / kChunk) * kStride + e % kChunk] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kCRegs; ++i) {
      const int e = t + i * kThreads;
      cs[(e / kChunk) * kStride + e % kChunk] = cr[i];
    }
  }
};

// this warp's features of one staged chunk: the row's dots with the
// group's centroids, and this lane's centroids' partial ||mu||^2
template <int CG>
__device__ __forceinline__ void chunk_products(const float* xs,
                                               const float* cs, int nc,
                                               float* acc, float* nrm) {
  const int lane = threadIdx.x & 31, f = (threadIdx.x >> 5) * kFeat;
  const float4 xa = *reinterpret_cast<const float4*>(xs + lane * kStride + f);
  const float4 xb =
      *reinterpret_cast<const float4*>(xs + lane * kStride + f + 4);
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    if (c < nc) {   // uniform: the group's last centroids may be absent
      const float4 ca = *reinterpret_cast<const float4*>(cs + c * kStride + f);
      const float4 cb =
          *reinterpret_cast<const float4*>(cs + c * kStride + f + 4);
      float a = acc[c];
      a = fmaf(xa.x, ca.x, a);
      a = fmaf(xa.y, ca.y, a);
      a = fmaf(xa.z, ca.z, a);
      a = fmaf(xa.w, ca.w, a);
      a = fmaf(xb.x, cb.x, a);
      a = fmaf(xb.y, cb.y, a);
      a = fmaf(xb.z, cb.z, a);
      a = fmaf(xb.w, cb.w, a);
      acc[c] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < (CG + 31) / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < CG) {
      const float* cr = cs + c * kStride + f;
      float s = nrm[j];
#pragma unroll
      for (int e = 0; e < kFeat; ++e) s = fmaf(cr[e], cr[e], s);
      nrm[j] = s;
    }
  }
}

// the asynchronous variants keep few registers so that 2-3 blocks share an
// SM and their copies overlap
template <typename T, int CG, bool ASYNC>
__global__ void __launch_bounds__(kThreads, ASYNC ? (CG <= 32 ? 3 : 2) : 1)
    assign_kernel(const T* __restrict__ x, const T* __restrict__ cents, int n,
                  int K, int d, int R, int* __restrict__ assign) {
  using L = Smem<CG>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.y, row0 = blockIdx.x * kRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int RK = R * K, n_chunks = (d + kChunk - 1) / kChunk;
  const int row = row0 + lane;
  // warp 0's running minimum over the centroids scanned so far: problem pc
  // of the slab, its centroid kc
  float best = INFINITY;
  int arg = 0, pc = 0, kc = 0;

  for (int c0 = 0; c0 < RK; c0 += CG) {
    const int nc = min(CG, RK - c0);
    Stage<T, CG> st{x + ((size_t)g * n + row0) * d,
                    cents + ((size_t)g * RK + c0) * d, n - row0, nc, d};
    float acc[CG], nrm[(CG + 31) / 32];
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < (CG + 31) / 32; ++j) nrm[j] = 0.f;

    if constexpr (ASYNC) {
      // a ring of kBufs chunks: chunk ch + 2 is copied while ch is used;
      // every iteration commits one group (empty past the last chunk), so
      // "one group in flight" always means chunk ch has landed
      auto issue = [&](int ch) {
        if (ch < n_chunks)
          st.async(smem + L::xs + (ch % kBufs) * kRows * kStride,
                   smem + L::cs + (ch % kBufs) * CG * kStride, ch * kChunk);
        cp_async_commit();
      };
      issue(0);
      issue(1);
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int b = ch % kBufs;
        cp_async_wait<1>();   // chunk ch has landed (this thread's part)
        __syncthreads();      // ... everyone's; chunk ch - 1 is consumed
        issue(ch + 2);        // into the buffer chunk ch - 1 used
        chunk_products<CG>(smem + L::xs + b * kRows * kStride,
                           smem + L::cs + b * CG * kStride, nc, acc, nrm);
      }
      cp_async_wait<0>();
    } else {
      float xr[Stage<T, CG>::kXRegs], cr[Stage<T, CG>::kCRegs];
      st.load(xr, cr, 0);
      st.store(smem + L::xs, smem + L::cs, xr, cr);
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int b = ch & 1;
        __syncthreads();
        const bool next = ch + 1 < n_chunks;
        if (next) st.load(xr, cr, (ch + 1) * kChunk);
        chunk_products<CG>(smem + L::xs + b * kRows * kStride,
                           smem + L::cs + b * CG * kStride, nc, acc, nrm);
        if (next)
          st.store(smem + L::xs + (b ^ 1) * kRows * kStride,
                   smem + L::cs + (b ^ 1) * CG * kStride, xr, cr);
      }
    }

    // add the warps' partial dots in a fixed tree (4 + 4, 2 + 2, 1 + 1)
    // and their partial norms in warp order
    float* red = smem;                     // [4][CG][32]
    float* c2w = smem + L::c2w;
    float* c2 = smem + L::c2;
#pragma unroll
    for (int j = 0; j < (CG + 31) / 32; ++j)
      if (lane + 32 * j < CG) c2w[warp * CG + lane + 32 * j] = nrm[j];
    __syncthreads();                       // the chunk buffers are free
    for (int half = kWarps / 2; half >= 1; half >>= 1) {
      if (warp >= half && warp < 2 * half) {
#pragma unroll
        for (int c = 0; c < CG; ++c)
          red[((warp - half) * CG + c) * 32 + lane] = acc[c];
      }
      if (half == kWarps / 2 && t < CG) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += c2w[w * CG + t];
        c2[t] = s;
      }
      __syncthreads();
      if (warp < half) {
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[c] += red[(warp * CG + c) * 32 + lane];
      }
      __syncthreads();
    }

    // warp 0: scan the group's centroids in order, problem by problem
    if (warp == 0) {
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        if (c < nc) {
          const float dist = c2[c] - 2.f * acc[c];
          if (dist < best) {   // strict '<': the first minimum wins
            best = dist;
            arg = kc;
          }
          if (++kc == K) {     // the end of problem g * R + pc
            if (row < n) assign[((size_t)g * R + pc) * n + row] = arg;
            best = INFINITY;
            arg = 0;
            kc = 0;
            ++pc;
          }
        }
      }
    }
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

template <typename T, int CG, bool ASYNC>
int launch_assign_cg(const void* x, const void* cents, int G, int R, int n,
                     int K, int d, void* assign, cudaStream_t s) {
  auto kernel = assign_kernel<T, CG, ASYNC>;
  const size_t bytes = Smem<CG>::bytes;
  // above 48 KB a block's dynamic shared memory must be allowed explicitly,
  // once per kernel and device
  static unsigned long long allowed = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(allowed >> dev & 1ull)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed |= 1ull << dev;
  }
  const dim3 grid((n + kRows - 1) / kRows, G);
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const T*>(x),
                                       static_cast<const T*>(cents), n, K, d,
                                       R, static_cast<int*>(assign));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ASYNC>
int launch_assign_async(const void* x, const void* cents, int G, int R, int n,
                        int K, int d, void* assign, cudaStream_t s) {
  const int rk = R * K;
  if (rk <= 16)
    return launch_assign_cg<T, 16, ASYNC>(x, cents, G, R, n, K, d, assign, s);
  if (rk <= 32)
    return launch_assign_cg<T, 32, ASYNC>(x, cents, G, R, n, K, d, assign, s);
  return launch_assign_cg<T, 64, ASYNC>(x, cents, G, R, n, K, d, assign, s);
}

template <typename T>
int launch_assign(const void* x, const void* cents, int P, int R, int n,
                  int K, int d, void* assign, cudaStream_t s) {
  const int G = P / R;
  const bool aligned = d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cents) % 16 == 0;
  if constexpr (sizeof(T) == 4) {
    if (aligned)
      return launch_assign_async<T, true>(x, cents, G, R, n, K, d, assign, s);
  }
  return launch_assign_async<T, false>(x, cents, G, R, n, K, d, assign, s);
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
// pointers to contiguous tensors: x (P/R, n, d), cents (P, K, d), assign
// (P, n) int32. Returns cudaGetLastError() after the launch, or the error
// of the step before it that failed.
int kmeans_assign(int dtype, const void* x, const void* cents, int P, int R,
                  int n, int K, int d, void* assign, void* stream) {
  if (P <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_assign<__nv_bfloat16>(x, cents, P, R, n, K, d, assign, s);
  return launch_assign<float>(x, cents, P, R, n, K, d, assign, s);
}

// As kmeans_assign, plus w (P/R, n) f32 and the outputs sums (P, K, d) and
// counts (P, K), both f32 and written in full (n = 0 writes zeros).
int kmeans_assign_reduce(int dtype, const void* x, const void* cents,
                         const void* w, int P, int R, int n, int K, int d,
                         void* assign, void* sums, void* counts,
                         void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (n > 0)
    err = dtype == 1
              ? launch_assign<__nv_bfloat16>(x, cents, P, R, n, K, d, assign, s)
              : launch_assign<float>(x, cents, P, R, n, K, d, assign, s);
  if (err != 0) return err;
  if (dtype == 1)
    launch_reduce<__nv_bfloat16>(x, w, assign, P, R, n, K, d, sums, counts,
                                 s);
  else
    launch_reduce<float>(x, w, assign, P, R, n, K, d, sums, counts, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
