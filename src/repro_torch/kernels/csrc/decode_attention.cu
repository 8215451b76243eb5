// Flash-decoding attention for one query token, contiguous and paged caches,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/decode_attention.py ::
// decode_attention_pallas (_kernel) and paged_decode_attention_pallas
// (_paged_kernel). Both variants run ONE device routine, `decode_one`; they
// differ only in how a logical position s of (batch row b, kv head h) is
// addressed:
//   contiguous  cache (B, Hkv, S, hd):  ((b * Hkv + h) * S + s) * hd
//   paged       pool  (P, Hkv, ps, hd): page = page_table[b, s / ps],
//               ((page * Hkv + h) * ps + s % ps) * hd
// The block reads its own page-table row, so the gathered (B, npg*ps) view
// never exists in memory.
//
// Math (the reference's dtype discipline, decode_attention.py:1-25): the g
// query rows of a GQA group are rounded to the cache dtype; scores q.k are
// f32 sums of the cache-dtype products, scaled by hd^-0.5; an online softmax
// keeps (m, l, acc) in f32 over tiles of 32 positions; each probability is
// rounded to the V dtype before p.v; the output is acc / max(l, 1e-30) in
// q's dtype. Positions at or past n_valid are masked (they are never read),
// so trash-page entries past the bound cost nothing, and a row with
// n_valid == 0 writes exact zeros. The loop runs only to n_valid, and the
// tile order and per-tile arithmetic do not depend on S or on the
// addressing, so the paged and contiguous kernels give bit-identical
// results for the same logical cache contents.
//
// Bound on this card: each step reads the valid part of K and V once and
// does 4*g*hd flops per position — with g <= 8 that is <= 16 flops per
// cache byte, far below the H100's operations-per-byte line, so the kernel
// is bound by memory bandwidth. This first version is simple, not fast: one
// 128-thread block per (b, kv head) — at the slice's B = 8 and Hkv = 2
// that is 16 blocks on 132 SMs, so most of the card idles. Splitting the
// sequence across blocks (split-K with a combine pass) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // positions per tile: one per lane in the softmax
constexpr int kMaxG = 8;   // query rows per kv head
constexpr int kRowsPerWarp = kMaxG / kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to T (round to nearest even) and back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct ContigAddr {
  size_t base;  // element offset of (b, h, 0, 0)
  int hd;
  __device__ __forceinline__ size_t operator()(int s) const {
    return base + (size_t)s * hd;
  }
};

struct PagedAddr {
  const int* pt_row;  // page_table[b, :]
  int Hkv, h, ps, hd;
  __device__ __forceinline__ size_t operator()(int s) const {
    const size_t page = (size_t)pt_row[s / ps];
    return ((page * Hkv + h) * ps + (s % ps)) * (size_t)hd;
  }
};

// One (batch row, kv head): q and out point at its (g, HD) rows.
template <typename TQ, typename TC, int HD, typename Addr>
__device__ __forceinline__ void decode_one(const TQ* __restrict__ q,
                                           const TC* __restrict__ kc,
                                           const TC* __restrict__ vc,
                                           const Addr addr, int g, int nv,
                                           float scale, TQ* __restrict__ out) {
  constexpr int kPerLane = HD / 32;          // q / k elements per lane
  constexpr int kRowStride = kThreads / HD;  // acc rows interleave
  constexpr int kAccRows = kMaxG / kRowStride;
  __shared__ float s_sc[kMaxG][kTile];  // scores, then probabilities
  __shared__ float s_corr[kMaxG];
  __shared__ float s_l[kMaxG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float qr[kMaxG][kPerLane];
#pragma unroll
  for (int qi = 0; qi < kMaxG; ++qi)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      qr[qi][j] = qi < g ? round_to<TC>(to_f(q[qi * HD + lane + 32 * j])) : 0.f;

  // softmax state of the rows this warp owns: warp + kWarps * rr
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
  }
  // accumulator ownership: dim d, rows r0 + kRowStride * r
  const int d = tid % HD, r0 = tid / HD;
  float acc[kAccRows];
#pragma unroll
  for (int r = 0; r < kAccRows; ++r) acc[r] = 0.f;

  for (int t0 = 0; t0 < nv; t0 += kTile) {
    // 1. scores: warp w scores positions t0 + w, t0 + w + kWarps, ...
#pragma unroll
    for (int i = 0; i < kTile / kWarps; ++i) {
      const int sl = warp + kWarps * i;
      if (t0 + sl < nv) {
        const TC* kr = kc + addr(t0 + sl);
        float kv[kPerLane];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) kv[j] = to_f(kr[lane + 32 * j]);
#pragma unroll
        for (int qi = 0; qi < kMaxG; ++qi) {
          if (qi < g) {
            float p = 0.f;
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) p = fmaf(qr[qi][j], kv[j], p);
            p = warp_sum(p);
            if (lane == 0) s_sc[qi][sl] = p * scale;
          }
        }
      }
    }
    __syncthreads();
    // 2. online softmax over the tile, one row per warp at a time
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int qi = warp + kWarps * rr;
      if (qi < g) {
        const bool valid = t0 + lane < nv;
        const float sc = valid ? s_sc[qi][lane] : -INFINITY;
        const float m_new = fmaxf(m_run[rr], warp_max(sc));
        const float p = valid ? expf(sc - m_new) : 0.f;
        const float corr = expf(m_run[rr] - m_new);
        l_run[rr] = l_run[rr] * corr + warp_sum(p);
        m_run[rr] = m_new;
        s_sc[qi][lane] = p;
        if (lane == 0) s_corr[qi] = corr;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + sum_s round_V(p_s) * v_s over the valid positions
    const int n_here = min(kTile, nv - t0);
    float part[kAccRows];
#pragma unroll
    for (int r = 0; r < kAccRows; ++r) part[r] = 0.f;
    for (int sl = 0; sl < n_here; ++sl) {
      const float vv = to_f(vc[addr(t0 + sl) + d]);
#pragma unroll
      for (int r = 0; r < kAccRows; ++r) {
        const int qi = r0 + kRowStride * r;
        if (qi < g) part[r] = fmaf(round_to<TC>(s_sc[qi][sl]), vv, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kAccRows; ++r) {
      const int qi = r0 + kRowStride * r;
      if (qi < g) acc[r] = acc[r] * s_corr[qi] + part[r];
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int qi = warp + kWarps * rr;
      if (qi < g) s_l[qi] = l_run[rr];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kAccRows; ++r) {
    const int qi = r0 + kRowStride * r;
    if (qi < g) out[qi * HD + d] = from_f<TQ>(acc[r] / fmaxf(s_l[qi], 1e-30f));
  }
}

template <typename TQ, typename TC, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_contig_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                         const TC* __restrict__ vc,
                         const int* __restrict__ n_valid, int Hkv, int g, int S,
                         float scale, TQ* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t qoff = ((size_t)b * Hkv + h) * g * HD;
  const int nv = min(n_valid[b], S);
  const ContigAddr addr{((size_t)b * Hkv + h) * S * HD, HD};
  decode_one<TQ, TC, HD>(q + qoff, kc, vc, addr, g, nv, scale, out + qoff);
}

template <typename TQ, typename TC, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_paged_kernel(const TQ* __restrict__ q, const TC* __restrict__ kp,
                        const TC* __restrict__ vp,
                        const int* __restrict__ page_table,
                        const int* __restrict__ n_valid, int Hkv, int g, int ps,
                        int npg, float scale, TQ* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t qoff = ((size_t)b * Hkv + h) * g * HD;
  const int nv = min(n_valid[b], npg * ps);
  const PagedAddr addr{page_table + (size_t)b * npg, Hkv, h, ps, HD};
  decode_one<TQ, TC, HD>(q + qoff, kp, vp, addr, g, nv, scale, out + qoff);
}

// dtype codes shared with kernels/decode_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename TQ, typename TC, int HD>
int launch(bool paged, const void* q, const void* k, const void* v,
           const void* page_table, const void* n_valid, int B, int Hkv, int g,
           int S_or_ps, int npg, float scale, void* out, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  if (paged) {
    decode_paged_kernel<TQ, TC, HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TC*>(k),
        static_cast<const TC*>(v), static_cast<const int*>(page_table),
        static_cast<const int*>(n_valid), Hkv, g, S_or_ps, npg, scale,
        static_cast<TQ*>(out));
  } else {
    decode_contig_kernel<TQ, TC, HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TC*>(k),
        static_cast<const TC*>(v), static_cast<const int*>(n_valid), Hkv, g,
        S_or_ps, scale, static_cast<TQ*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch_hd(int hd, bool paged, const void* q, const void* k, const void* v,
              const void* pt, const void* nv, int B, int Hkv, int g, int S_or_ps,
              int npg, float scale, void* out, cudaStream_t st) {
  if (hd == 64)
    return launch<TQ, TC, 64>(paged, q, k, v, pt, nv, B, Hkv, g, S_or_ps, npg,
                              scale, out, st);
  if (hd == 128)
    return launch<TQ, TC, 128>(paged, q, k, v, pt, nv, B, Hkv, g, S_or_ps, npg,
                               scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int q_dtype, int c_dtype, int hd, bool paged, const void* q,
             const void* k, const void* v, const void* pt, const void* nv,
             int B, int Hkv, int g, int S_or_ps, int npg, float scale,
             void* out, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && c_dtype == kF32)
    return launch_hd<float, float>(hd, paged, q, k, v, pt, nv, B, Hkv, g,
                                   S_or_ps, npg, scale, out, st);
  if (q_dtype == kBF16 && c_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, paged, q, k, v, pt, nv, B, Hkv, g, S_or_ps, npg, scale, out, st);
  if (q_dtype == kF32 && c_dtype == kBF16)
    return launch_hd<float, __nv_bfloat16>(hd, paged, q, k, v, pt, nv, B, Hkv,
                                           g, S_or_ps, npg, scale, out, st);
  if (q_dtype == kBF16 && c_dtype == kF32)
    return launch_hd<__nv_bfloat16, float>(hd, paged, q, k, v, pt, nv, B, Hkv,
                                           g, S_or_ps, npg, scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Hkv, g, hd); k, v (B, Hkv, S, hd); n_valid (B,) int32; out like q.
// Returns cudaGetLastError() after the launch.
int decode_attention(int q_dtype, int c_dtype, int hd, const void* q,
                     const void* k, const void* v, const void* n_valid, int B,
                     int Hkv, int g, int S, float scale, void* out,
                     void* stream) {
  return dispatch(q_dtype, c_dtype, hd, false, q, k, v, nullptr, n_valid, B,
                  Hkv, g, S, 0, scale, out, stream);
}

// q (B, Hkv, g, hd); k, v pools (P, Hkv, ps, hd); page_table (B, npg) int32;
// n_valid (B,) int32; out like q. Returns cudaGetLastError().
int paged_decode_attention(int q_dtype, int c_dtype, int hd, const void* q,
                           const void* k_pool, const void* v_pool,
                           const void* page_table, const void* n_valid, int B,
                           int Hkv, int g, int ps, int npg, float scale,
                           void* out, void* stream) {
  return dispatch(q_dtype, c_dtype, hd, true, q, k_pool, v_pool, page_table,
                  n_valid, B, Hkv, g, ps, npg, scale, out, stream);
}

}  // extern "C"
