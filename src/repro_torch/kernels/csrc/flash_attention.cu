// Prefill (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_pallas (_kernel). q, k, v are (B, S, H, hd) with equal
// head counts (the caller repeats GQA heads); the output is (B, S, H, hd) in
// q's dtype. Both kernels below read that layout in place: position s of
// head h sits at ((b * S + s) * H + h) * hd, so no (B, H, S, hd) copy is made.
//
// Math (the reference's, flash_attention.py:26-63): q and k are upcast to
// f32 before the dot, s = (q . k) * hd^-0.5; the causal form sets s = -1e30
// where the key lies after the query (not -inf, as the reference); an online
// softmax keeps the running max m, the normalizer l and the accumulator acc
// in f32; p . v takes v upcast to f32 and p in f32 (p is never rounded to
// bf16 as a whole, unlike the decode kernels); the output is
// acc / max(l, 1e-30) rounded once to q's dtype. Key tiles wholly above the
// diagonal are skipped. Keys past S in the ragged last tile get s = -inf, so
// they add exactly nothing; query rows past S are computed and not written.
//
// Bound on this card: the work is 4 * B * H * hd * S(S+1)/2 flops (causal)
// over reading q, k, v and writing the output once. At S = 4096, hd = 128
// that is ~1,000 flops per byte, far above the H100's operations-per-byte
// line, so attention is bound by arithmetic: by the tensor cores' bf16 rate
// where they can carry it, else by the CUDA cores' f32 rate (67 TFLOP/s
// on the H100 SXM data sheet).
//
// Which dtype takes which design, and why.
//
// bf16 (the served dtype) runs on the tensor cores. One block of three
// warpgroups owns a 128-row query tile of one (head, batch row): warpgroups
// 0 and 1 consume 64 rows each, warpgroup 2 loads. The loader's one thread
// brings the Q tile in once and the K and V tiles of 128 keys through a
// three-stage ring in shared memory with TMA, completing on mbarriers; the
// tensor maps are 4-D over (hd, H, S, B), so rows past S read as zeros and
// never from the next batch row, and the 128-byte swizzle they write is the
// one wgmma reads. S = Q K^T is one wgmma m64n128k16 per 16 features, exact
// in f32 for bf16 inputs (products of two bf16 values are exact), so only
// the order of the sums differs from the plain version. Scale, masks and
// the online softmax run on the accumulator registers; only the tiles that
// cross the diagonal or the end of S are masked, and no score tile goes to
// shared memory. p . v runs on the tensor cores without rounding p: p is
// split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), both register A
// operands of a wgmma against the same V tile (the B operand, read from
// shared memory in the transposed layout 16-bit types allow); p_hi + p_lo
// carries 16 of p's 24 bits, and the residual (< 2^-17 p) is far inside the
// 2e-5 tolerance, where rounding p once to bf16 (2^-9 p) is not. The
// accumulator layout of S is the A-register layout of p . v, so the split
// needs no shuffles. The loader gives up registers (setmaxnreg 24) so the
// consumers can hold S (64), the output (hd / 2) and p_hi / p_lo (64) at
// 240. The two consumer warpgroups take turns at the tensor cores (two
// named barriers): each issues S_t and P_{t-1} V_{t-1} together, then runs
// the softmax of S_t (exp2, the scale folded in) while the other
// warpgroup's products run. Causal query tiles launch longest first (the
// tile index is the slowest grid axis, reversed), so the short tiles fill
// the tail.
//
// f32 keeps the CUDA-core kernel: no tensor-core path computes the
// reference's f32 products within the f32 tolerance, 2e-5 (|want| + A),
// since TF32 keeps 10 bits. One 128-thread block per (64-row query tile,
// head, batch row) stages the query tile and each 64-key tile in shared
// memory as f32, runs both products as f32 FMAs and keeps the softmax state
// in registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>


namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBq = 64;             // query rows per block
constexpr int kBk = 64;             // keys per tile
constexpr int kSStride = kBk + 4;   // score row stride: float4-aligned
constexpr float kMasked = -1e30f;   // the reference's causal mask value

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBq = 128;        // query rows per block: two warpgroups of 64
constexpr int kBk = 128;        // keys per tile
constexpr int kStages = 3;      // depth of the K/V ring
constexpr int kThreads = 384;   // warpgroups 0 and 1 compute, 2 loads
constexpr int kCol = 64;        // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows): the Q tile and each K and V tile
// are HD / 64 column blocks of (rows, 64) bf16, each row 128 bytes; then
// the barriers q_full, k_full[kStages], v_full[kStages], empty[kStages].
template <int HD>
struct Smem {
  static constexpr int kColBlocks = HD / kCol;
  static constexpr int q_bytes = kBq * HD * 2;
  static constexpr int tile_bytes = kBk * HD * 2;
  static constexpr int q = 0;
  static constexpr int k = q + q_bytes;
  static constexpr int v = k + kStages * tile_bytes;
  static constexpr int bars = v + kStages * tile_bytes;
  static constexpr size_t bytes = bars + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of (64 features, 1 head, 128 positions, 1 batch row) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(s), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (between 64-column blocks of an MN-major operand; unused for
// K-major ones) and stride byte offset (between groups of 8 rows)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// named barriers over the two consumer warpgroups (256 threads): a
// warpgroup waits on its own and arrives on the other's
constexpr int kTurn0 = 1, kTurn1 = 2;   // 0 is __syncthreads'
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// keep the compiler from moving register reads and writes across an
// asynchronous wgmma that owns these registers
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 16, shared) * B (16 x 128, shared)
template <int TNSP_B>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TNSP_B));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared)
template <int TNSP_B>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TNSP_B));
}


template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, int S, int H,
                    int causal, float scale, __nv_bfloat16* __restrict__ out) {
  using L = Smem<HD>;
  constexpr int kCB = L::kColBlocks;
  constexpr int kKSteps = HD / 16;       // k16 steps of q . k
  constexpr int kPSteps = kBk / 16;      // k16 steps of p . v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::bars;
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_q = (S + kBq - 1) / kBq;
  const int q0 = (causal ? n_q - 1 - (int)blockIdx.z : (int)blockIdx.z) * kBq;
  const int n_tiles = causal ? (min(q0 + kBq, S) - 1) / kBk + 1
                             : (S + kBk - 1) / kBk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- loader warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < kCB; ++c)
        tma_load(base + L::q + c * kBq * kRowBytes, &tq, q_full, c * kCol, h,
                 q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        mbar_wait(empty + 8 * s, ph ^ 1);   // the first pass finds it free
        const uint32_t kd = base + L::k + s * L::tile_bytes;
        const uint32_t vd = base + L::v + s * L::tile_bytes;
        mbar_expect_tx(k_full + 8 * s, L::tile_bytes);
        for (int c = 0; c < kCB; ++c)
          tma_load(kd + c * kBk * kRowBytes, &tk, k_full + 8 * s, c * kCol, h,
                   t * kBk, b);
        mbar_expect_tx(v_full + 8 * s, L::tile_bytes);
        for (int c = 0; c < kCB; ++c)
          tma_load(vd + c * kBk * kRowBytes, &tv, v_full + 8 * s, c * kCol, h,
                   t * kBk, b);
      }
    }
  } else {
    // ---- consumer warpgroup w: query rows q0 + 64 w .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
    // accumulator layout: register i of a 64 x N tile holds row
    // 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4)
    // + i % 2; this thread's two rows are qrow0 and qrow0 + 8
    const int qrow0 = q0 + 64 * w + 16 * warp + (lane >> 2);
    const int colq = 2 * (lane & 3);
    const uint32_t qa = base + L::q + w * 64 * kRowBytes;
    const float sl2 = scale * kLog2e;   // scores in units of log2(e)

    float o[kCB][32];
#pragma unroll
    for (int c = 0; c < kCB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t phi[kPSteps][4], plo[kPSteps][4];
#pragma unroll
    for (int kc = 0; kc < kPSteps; ++kc)
#pragma unroll
      for (int a = 0; a < 4; ++a) phi[kc][a] = plo[kc][a] = 0u;

    // The two warpgroups take turns at the tensor cores: step t issues
    // S_t = Q K_t^T and O += P_{t-1} V_{t-1} together, hands the turn over,
    // and runs the softmax of S_t while the other warpgroup's products
    // run.
    if (w == 1) named_arrive(kTurn0);   // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    for (int t = 0; t <= n_tiles; ++t) {
      const bool has_s = t < n_tiles, has_pv = t > 0;
      const int s = t % kStages, sp = (t + kStages - 1) % kStages;
      if (has_s) mbar_wait(k_full + 8 * s, (t / kStages) & 1);
      if (has_pv) mbar_wait(v_full + 8 * sp, ((t - 1) / kStages) & 1);
      named_sync(w == 0 ? kTurn0 : kTurn1);
      fence_regs<64>(sc);
#pragma unroll
      for (int c = 0; c < kCB; ++c) fence_regs<32>(o[c]);
#pragma unroll
      for (int kc = 0; kc < kPSteps; ++kc) {
        fence_regs<4>(phi[kc]);
        fence_regs<4>(plo[kc]);
      }
      wg_fence();
      if (has_s) {
        // S = Q K^T: A (Q) and B (K) both K-major, 32 bytes per k16 step
        const uint32_t ka = base + L::k + s * L::tile_bytes;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n128<0>(
              sc, desc(qa + (kk / 4) * kBq * kRowBytes + off, 16, 1024),
              desc(ka + (kk / 4) * kBk * kRowBytes + off, 16, 1024), kk > 0);
        }
      }
      wg_commit();
      if (has_pv) {
        // O += P V: B (V) is MN-major, 16 keys (2048 bytes) per k16 step;
        // p_hi and p_lo against the same V tile
        const uint32_t va = base + L::v + sp * L::tile_bytes;
#pragma unroll
        for (int kc = 0; kc < kPSteps; ++kc)
#pragma unroll
          for (int c = 0; c < kCB; ++c) {
            const uint64_t dv = desc(va + c * kBk * kRowBytes + kc * 2048,
                                     kBk * kRowBytes, 1024);
            wgmma_rs_n64<1>(o[c], phi[kc], dv);
            wgmma_rs_n64<1>(o[c], plo[kc], dv);
          }
      }
      wg_commit();
      // the other warpgroup's turn (warpgroup 0's last step has no taker)
      if (w == 0) named_arrive(kTurn1);
      else if (t < n_tiles) named_arrive(kTurn0);

      // both products done; the softmax below overlaps the other
      // warpgroup's products (ptxas serializes wgmma if an accumulator is
      // written while a group of the same warpgroup is in flight)
      wg_wait_all();
      fence_regs<64>(sc);
#pragma unroll
      for (int c = 0; c < kCB; ++c) fence_regs<32>(o[c]);
#pragma unroll
      for (int kc = 0; kc < kPSteps; ++kc) {
        fence_regs<4>(phi[kc]);
        fence_regs<4>(plo[kc]);
      }
      if (has_pv && lane == 0) mbar_arrive(empty + 8 * sp);  // stage free
      float corr[2] = {1.f, 1.f};
      if (has_s) {
        const int k0 = t * kBk;
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= sl2;
        if ((causal && k0 + kBk - 1 > q0 + 64 * w) || k0 + kBk > S) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int key = k0 + 8 * (i >> 2) + colq + (i & 1);
            const int row = qrow0 + 8 * ((i >> 1) & 1);
            if (causal && key > row) sc[i] = kMasked;
            if (key >= S) sc[i] = -INFINITY;
          }
        }
        // online softmax on the registers; a row's 128 scores sit in the
        // four threads of a quad
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[r], mx);
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float p0 = exp2f(sc[4 * j + 2 * r] - m_new);
            const float p1 = exp2f(sc[4 * j + 2 * r + 1] - m_new);
            sc[4 * j + 2 * r] = p0;
            sc[4 * j + 2 * r + 1] = p1;
            ps += p0 + p1;
          }
          ps += __shfl_xor_sync(0xffffffffu, ps, 1);
          ps += __shfl_xor_sync(0xffffffffu, ps, 2);
          corr[r] = exp2f(m_run[r] - m_new);
          l_run[r] = l_run[r] * corr[r] + ps;
          m_run[r] = m_new;
        }
      }
      if (has_s) {
#pragma unroll
        for (int c = 0; c < kCB; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
        // p = p_hi + p_lo, both bf16, as the A registers of p . v: the
        // registers 8 kc + 2 a, + 1 of S are register a of k16 step kc
#pragma unroll
        for (int kc = 0; kc < kPSteps; ++kc)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float x0 = sc[8 * kc + 2 * a], x1 = sc[8 * kc + 2 * a + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            const __nv_bfloat162 lo =
                __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
            phi[kc][a] = *reinterpret_cast<const uint32_t*>(&hi);
            plo[kc][a] = *reinterpret_cast<const uint32_t*>(&lo);
          }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + 8 * r;
      if (row >= S) continue;
      const float den = fmaxf(l_run[r], 1e-30f);
      __nv_bfloat16* orow = out + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
      for (int c = 0; c < kCB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + c * kCol + 8 * j + colq) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * r] / den,
                                    o[c][4 * j + 2 * r + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// (hd, H, S, B) view of a contiguous (B, S, H, hd) bf16 tensor, boxes of
// (64, 1, 128, 1), 128-byte swizzle; positions past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kCol, 1, (cuuint32_t)kBk, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, int B, int S, int H,
           int causal, float scale, void* out, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, HD) || !make_map(&mk, k, B, S, H, HD) ||
      !make_map(&mv, v, B, S, H, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<HD>::bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (S + kBq - 1) / kBq);
  flash_tc_kernel<HD><<<grid, kThreads, Smem<HD>::bytes, stream>>>(
      mq, mk, mv, S, H, causal, scale, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype codes shared with kernels/flash_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

int launch_f32(int hd, const void* q, const void* k, const void* v, int B,
               int S, int H, int causal, float scale, void* out,
               cudaStream_t st) {
  if (hd == 64)
    return launch<float, 64>(q, k, v, B, S, H, causal, scale, out, st);
  if (hd == 128)
    return launch<float, 128>(q, k, v, B, S, H, causal, scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(int hd, const void* q, const void* k, const void* v, int B,
                int S, int H, int causal, float scale, void* out,
                cudaStream_t st) {
  if (hd == 64) return tc::launch<64>(q, k, v, B, S, H, causal, scale, out, st);
  if (hd == 128)
    return tc::launch<128>(q, k, v, B, S, H, causal, scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out: contiguous (B, S, H, hd) of one dtype (0 f32, 1 bf16); bf16
// pointers 16-byte aligned (TMA). Returns cudaGetLastError() after the
// launch, or the error of the step before it that failed.
int flash_attention(int dtype, int hd, const void* q, const void* k,
                    const void* v, int B, int S, int H, int causal, float scale,
                    void* out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_f32(hd, q, k, v, B, S, H, causal, scale, out, st);
  if (dtype == kBF16)
    return launch_bf16(hd, q, k, v, B, S, H, causal, scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
