// Prefill (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_pallas (_kernel). q, k, v are (B, S, H, hd) with equal
// head counts (the caller repeats GQA heads); the output is (B, S, H, hd) in
// q's dtype. The kernel reads that layout in place: position s of head h
// sits at ((b * S + s) * H + h) * hd, so no (B, H, S, hd) copy is made.
//
// Math (the reference's, flash_attention.py:26-63): q and k are upcast to
// f32 before the dot, s = (q . k) * hd^-0.5; the causal form sets s = -1e30
// where the key lies after the query (not -inf, as the reference); an online
// softmax over 64-key tiles keeps the running max m, the normalizer l and the
// accumulator acc in f32; p . v takes v upcast to f32 and p in f32 (p is
// never rounded to bf16, unlike the decode kernels); the output is
// acc / max(l, 1e-30) rounded once to q's dtype. Key tiles wholly above the
// diagonal are skipped. Keys past S in the ragged last tile get s = -inf, so
// they add exactly nothing; query rows past S are computed and not written.
//
// Bound on this card: the work is 4 * B * H * hd * S(S+1)/2 flops (causal)
// over reading q, k, v and writing the output once. At S = 4096, hd = 128
// that is ~1,000 flops per byte, far above the H100's operations-per-byte
// line, so attention is bound by arithmetic — by the tensor cores' bf16 rate
// for a kernel that uses them. This first version is simple, not fast: it
// runs both products on the CUDA cores in f32 (what the reference computes),
// one 128-thread block per (64-row query tile, head, batch row), staging the
// query tile and each key/value tile in shared memory as f32 and keeping the
// softmax state in registers. Keeping p in f32 rules out feeding p . v to the
// bf16 tensor cores directly; q . k could take them exactly for bf16 inputs
// (bf16 products are exact in f32). Both, with wgmma and TMA, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBq = 64;             // query rows per block
constexpr int kBk = 64;             // keys per tile
constexpr int kSStride = kBk + 4;   // score row stride: float4-aligned
constexpr float kMasked = -1e30f;   // the reference's causal mask value

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

// Shared memory of one block, in floats: the query tile (kBq, HD); the key
// tile (kBk, HD + 1), padded so that the 32 lanes reading one key row each
// hit 32 banks; the value tile (kBk, HD); the scores, then probabilities
// (kBq, kSStride); each row's rescale factor and final normalizer.
template <int HD>
struct Smem {
  static constexpr int kKStride = HD + 1;
  static constexpr int q = 0;
  static constexpr int k = q + kBq * HD;
  static constexpr int v = k + kBk * kKStride;
  static constexpr int s = v + kBk * HD;
  static constexpr int corr = s + kBq * kSStride;
  static constexpr int l = corr + kBq;
  static constexpr size_t bytes = (size_t)(l + kBq) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int S, int H, int causal,
                 float scale, T* __restrict__ out) {
  using L = Smem<HD>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::q;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* Ss = smem + L::s;
  float* corr_s = smem + L::corr;
  float* l_s = smem + L::l;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBq;
  const size_t pos_stride = (size_t)H * HD;  // between positions s
  const size_t base = (size_t)blockIdx.z * S * pos_stride + (size_t)blockIdx.y * HD;

  for (int i = tid; i < kBq * HD; i += kThreads) {
    const int r = i / HD, s = q0 + r;
    Qs[i] = s < S ? to_f(q[base + (size_t)s * pos_stride + i % HD]) : 0.f;
  }

  // scores: this thread's key column sj of rows srg + 2 i
  const int sj = tid & (kBk - 1), srg = tid >> 6;
  constexpr int kSRows = kBq / 2;
  // softmax: two threads per row, 32 columns each; both hold the row's state
  const int sr = tid >> 1, half = tid & 1;
  float m_run = kMasked, l_run = 0.f;
  // p . v: output column od of rows org + kTPD i
  constexpr int kTPD = kThreads / HD;  // threads per output column
  constexpr int kORows = kBq / kTPD;
  const int od = tid % HD, org = tid / HD;
  float acc[kORows];
#pragma unroll
  for (int i = 0; i < kORows; ++i) acc[i] = 0.f;

  const int q_last = min(q0 + kBq, S) - 1;
  const int n_tiles = causal ? q_last / kBk + 1 : (S + kBk - 1) / kBk;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ss are done
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool ok = s < S;
      const size_t off = base + (size_t)s * pos_stride + d;
      Ks[r * L::kKStride + d] = ok ? to_f(k[off]) : 0.f;
      Vs[i] = ok ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[kSRows];
#pragma unroll
    for (int i = 0; i < kSRows; ++i) sc[i] = 0.f;
    const float* krow = Ks + sj * L::kKStride;
    for (int d = 0; d < HD; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2],
                  k3v = krow[d + 3];
#pragma unroll
      for (int i = 0; i < kSRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + (srg + 2 * i) * HD + d);
        sc[i] = fmaf(qv.x, k0v, sc[i]);
        sc[i] = fmaf(qv.y, k1v, sc[i]);
        sc[i] = fmaf(qv.z, k2v, sc[i]);
        sc[i] = fmaf(qv.w, k3v, sc[i]);
      }
    }
    const int kpos = k0 + sj;
#pragma unroll
    for (int i = 0; i < kSRows; ++i) {
      const int r = srg + 2 * i;
      float s = sc[i] * scale;
      if (causal && kpos > q0 + r) s = kMasked;
      if (kpos >= S) s = -INFINITY;
      Ss[r * kSStride + sj] = s;
    }
    __syncthreads();

    float* srow = Ss + sr * kSStride + half * (kBk / 2);
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < kBk / 2; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float ps = 0.f;
#pragma unroll 8
    for (int c = 0; c < kBk / 2; ++c) {
      const float p = expf(srow[c] - m_new);
      srow[c] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + ps;
    m_run = m_new;
    if (half == 0) corr_s[sr] = corr;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kORows; ++i) acc[i] *= corr_s[org + kTPD * i];
    for (int j = 0; j < kBk; j += 4) {
      const float v0 = Vs[j * HD + od], v1 = Vs[(j + 1) * HD + od],
                  v2 = Vs[(j + 2) * HD + od], v3 = Vs[(j + 3) * HD + od];
#pragma unroll
      for (int i = 0; i < kORows; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(
            Ss + (org + kTPD * i) * kSStride + j);
        acc[i] = fmaf(p.x, v0, acc[i]);
        acc[i] = fmaf(p.y, v1, acc[i]);
        acc[i] = fmaf(p.z, v2, acc[i]);
        acc[i] = fmaf(p.w, v3, acc[i]);
      }
    }
  }
  if (half == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kORows; ++i) {
    const int r = org + kTPD * i, s = q0 + r;
    if (s < S)
      out[base + (size_t)s * pos_stride + od] =
          from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// dtype codes shared with kernels/flash_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, int B, int S, int H,
           int causal, float scale, void* out, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed explicitly;
  // a launch asking for more than allowed is refused and never runs
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<HD>::bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kBq - 1) / kBq, H, B);
  flash_kernel<T, HD><<<grid, kThreads, Smem<HD>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), S, H, causal, scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, int B,
              int S, int H, int causal, float scale, void* out,
              cudaStream_t st) {
  if (hd == 64) return launch<T, 64>(q, k, v, B, S, H, causal, scale, out, st);
  if (hd == 128)
    return launch<T, 128>(q, k, v, B, S, H, causal, scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out: contiguous (B, S, H, hd) of one dtype (0 f32, 1 bf16).
// Returns cudaGetLastError() after the launch (or the attribute call's error).
int flash_attention(int dtype, int hd, const void* q, const void* k,
                    const void* v, int B, int S, int H, int causal, float scale,
                    void* out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_hd<float>(hd, q, k, v, B, S, H, causal, scale, out, st);
  if (dtype == kBF16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, B, S, H, causal, scale, out,
                                    st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
