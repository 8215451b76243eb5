// Flash-decoding attention for one query token, contiguous and paged caches,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/decode_attention.py ::
// decode_attention_pallas (_kernel) and paged_decode_attention_pallas
// (_paged_kernel). Both variants run ONE device routine, `decode_chunk`;
// they differ only in how a logical position s of (batch row b, kv head h)
// is addressed:
//   contiguous  cache (B, Hkv, S, hd):  ((b * Hkv + h) * S + s) * hd
//   paged       pool  (P, Hkv, ps, hd): page = page_table[b, s / ps],
//               ((page * Hkv + h) * ps + s % ps) * hd
// so the gathered (B, npg*ps) view never exists in memory.
//
// Math (the reference's dtype discipline, decode_attention.py:1-25): the g
// query rows of a GQA group are rounded to the cache dtype; scores q.k are
// f32 sums of the cache-dtype products, scaled by hd^-0.5; each
// probability is rounded to the V dtype before p.v; sums are f32; the
// output is acc / max(l, 1e-30) in q's dtype.
//
// Bound on this card: a call reads the valid part of K and V once and
// does 4*g*hd flops per position, at most 16 flops per cache byte, far
// below the H100's operations-per-byte line, so the work is bound by
// memory bandwidth. At the served and timed shapes (8 rows, <= 200 valid
// positions, 4 kv heads) that bound is under a microsecond, so what a call
// costs is latency: how many dependent round trips to memory and how many
// serial steps stand between the launch and the last store. The design:
//
// 1. Split the sequence (flash-decoding). The grid is (Hkv, B, n_chunks);
//    block (h, b, c) owns the kChunk logical positions [c*kChunk,
//    (c+1)*kChunk) and exits at once if that starts at or past n_valid[b].
//    It writes f32 partials (m, l, acc) of its g query rows to a workspace
//    that the caller allocates; a second launch, `decode_merge_kernel`,
//    merges the partials of each (b, h) in chunk order 0 .. ceil(nv/C)-1,
//    in one pass (the online-softmax rule), so the loads of several chunks
//    are in flight together. It is launched as a programmatic dependent
//    launch: its blocks start while the chunk kernel runs and wait for its
//    completion before they read the partials. No atomics: the result is
//    the same bits run to run.
// 2. No block barrier in the inner loop. Each warp owns a run of kRun = 8
//    consecutive positions and issues ALL its K and V loads at once (16
//    bytes a lane), then scores them in registers. The block meets twice:
//    once to share the warps' maxima (the chunk maximum m_c, against which
//    every probability of the chunk is taken and rounded), once to add the
//    warps' p.v sums in fixed warp order.
// 3. bf16 caches: both products on mma.sync
//    m16n8k16, bf16 in and f32 sums, which is the reference's rule (q and
//    p rounded to bf16, exact products). q.k takes the g <= 8 query rows
//    padded to M = 16 and the warp's 8 positions as N; p.v the same rows
//    as M and the 8 positions as K (padded to 16), p passed from the score
//    accumulator to the A operand without leaving registers. The operands'
//    k and n orders are permuted so that each lane's fragment is what its
//    own 16-byte loads hold (no shared-memory staging, no transposes).
//    wgmma, whose 64-row M would waste 7/8 of the tile at g <= 8, is not
//    used.
// 4. f32 caches, and bf16 q over an f32 cache, stay on the CUDA cores in
//    f32: TF32 would round the inputs. A warp reads 2 positions per
//    16-byte load at padded width 64 (1 at 128); the g row dots of a
//    position are summed over its lanes by one reduce-scatter butterfly
//    (8 shuffles for 8 rows, not 8 x 4).
//
// Choices, each measured on the card against its alternatives when the
// kernel was designed (PERF.md has the numbers): kChunk = 32 positions a
// block (a multiple of 32 and of the engine's page size 16), kRun = 8
// positions a warp, the tensor cores for bf16 caches and the overlapped
// merge launch. What a block does is a few dependent round trips to memory
// and a short chain of arithmetic, so the call is bound by latency: 32 / 8
// gave the least device time at the served shapes (64 / 8 is faster at the
// timed ones by ~9%), 16 or 4 positions a warp were slower, the tensor
// cores save ~1.3 us of chunk kernel and the overlapped merge about 1 us a
// call.
//
// Head dims. The routine is compiled for two padded widths, HDP = 64 and
// 128, and takes the true head dim hd (a multiple of 16, 16 <= hd <= HDP) at
// run time: hd is the row stride of q, of the caches and of the output, and
// every load of a column at or past hd is predicated to zero, so the padded
// q.k terms are exactly 0 and the padded p.v columns are never written. A
// 16-byte load covers 4 f32 or 8 bf16 columns, and hd is a multiple of 16,
// so a load is either wholly inside the row or wholly past it, and every
// row starts on a 16-byte boundary (a bf16 row of 112 is 224 bytes). The
// scale is the caller's hd^-0.5. The workspace keeps the padded stride.
//
// Contracts. The chunking, the order of every sum inside a chunk and the
// merge order depend only on logical positions and n_valid, never on S,
// npg or ps, so the paged and contiguous kernels give bit-identical results
// for the same logical cache contents. Positions at or past n_valid are
// never read (trash-page entries past the bound cost nothing). A row with
// n_valid == 0 writes exact zeros. Against the one-pass plain version, the
// only freedom is that each p is rounded to bf16 against its chunk's
// maximum m_c and then scaled by exp(m_c - m) in f32, instead of being
// rounded against the row's maximum m; two bf16 roundings of the same p
// differ by at most 2^-8 of p.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // positions per block
constexpr int kRun = 8;     // positions per warp
constexpr int kWarps = kChunk / kRun;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;    // query rows per kv head
constexpr int kMergeThreads = 256;
// the f32 softmax step gives each lane one query row and kRun / 4 of its
// warp's positions: 8 rows x 4 lanes = one warp
constexpr int kPerLane = kRun / 4;
static_assert(kMaxG * 4 == 32, "softmax lane mapping");

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

// the 16 bytes of one f32 load
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// The kMaxG row dots v[] of one lane, each summed over the kLanes lanes of
// its position by a reduce-scatter butterfly: the first three steps halve
// the rows a lane holds (8 -> 4 -> 2 -> 1, 7 shuffles), the rest add the
// last row over the remaining lanes. Lane `piece` ends with the sum of row
// held_row<kLanes>(piece); the lanes that share a row hold the same bits.
template <int kLanes>
__device__ __forceinline__ int held_row(int piece) {
  return 4 * ((piece & (kLanes / 2)) != 0) + 2 * ((piece & (kLanes / 4)) != 0) +
         ((piece & (kLanes / 8)) != 0);
}

template <int kLanes>
__device__ __forceinline__ float rows_sum(const float (&v)[kMaxG], int piece) {
  static_assert(kMaxG == 8 && kLanes >= 8, "three halving steps");
  constexpr unsigned kAll = 0xffffffffu;
  float w4[4], w2[2];
  bool hi = piece & (kLanes / 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // keep rows 4*hi .. 4*hi+3
    w4[i] = (hi ? v[i + 4] : v[i]) +
            __shfl_xor_sync(kAll, hi ? v[i] : v[i + 4], kLanes / 2);
  hi = piece & (kLanes / 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (hi ? w4[i + 2] : w4[i]) +
            __shfl_xor_sync(kAll, hi ? w4[i] : w4[i + 2], kLanes / 4);
  hi = piece & (kLanes / 8);
  float w = (hi ? w2[1] : w2[0]) +
            __shfl_xor_sync(kAll, hi ? w2[0] : w2[1], kLanes / 8);
#pragma unroll
  for (int off = kLanes / 16; off > 0; off >>= 1)
    w += __shfl_xor_sync(kAll, w, off);
  return w;
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
    const size_t page = (size_t)__ldg(pt_row + s / ps);
    return ((page * Hkv + h) * ps + (s % ps)) * (size_t)hd;
  }
};

// The partials of one (b, h, chunk) in the workspace: acc (g, HDP), then
// m (g), then l (g), all f32.
template <int HDP>
__device__ __forceinline__ size_t ws_offset(int b, int h, int c, int Hkv,
                                            int nch, int g) {
  return (((size_t)b * Hkv + h) * nch + c) * (size_t)g * (HDP + 2);
}

// The block's partials from its warps' (m, l, acc) in shared memory: the
// warps' sums in warp order.
template <int HDP>
__device__ __forceinline__ void write_partials(
    const float (&s_m)[kWarps][kMaxG], const float (&s_l)[kWarps][kMaxG],
    const float (&s_acc)[kWarps][kMaxG][HDP], int g,
    float* __restrict__ part) {
  __syncthreads();
  const int tid = threadIdx.x;
  for (int i = tid; i < g * HDP; i += kThreads) {
    const int qi = i / HDP, d = i % HDP;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][qi][d];
    part[i] = a;
  }
  if (tid < g) {
    float m = -INFINITY, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m = fmaxf(m, s_m[w][tid]);
      ls += s_l[w][tid];
    }
    part[g * HDP + tid] = m;
    part[g * HDP + g + tid] = ls;
  }
}

// One (batch row, kv head, chunk) block over an f32 cache, on the CUDA
// cores: q points at its (g, hd) rows, nvp at the row's n_valid, part at
// the block's workspace slot; cap is the cache's capacity in positions.
// Returns at once if the chunk starts at or past n_valid.
template <typename TQ, int HDP, typename Addr>
__device__ __forceinline__ void decode_chunk(const TQ* __restrict__ q,
                                             const float* __restrict__ kc,
                                             const float* __restrict__ vc,
                                             const Addr addr,
                                             const int* __restrict__ nvp,
                                             int cap, int g, int hd, int c0,
                                             float scale,
                                             float* __restrict__ part) {
  // a warp covers its run with 16-byte loads of 4 elements
  constexpr int kVec = 4, kLanes = HDP / kVec;    // lanes per position
  constexpr int kPos = 32 / kLanes;               // positions per load
  constexpr int kLoads = kRun / kPos;             // loads per run
  __shared__ float s_p[kWarps][kMaxG][kRun];  // scores, then rounded p
  __shared__ float s_m[kWarps][kMaxG];
  __shared__ float s_l[kWarps][kMaxG];
  __shared__ float s_acc[kWarps][kMaxG][HDP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / kLanes;   // which position of a load
  const int piece = lane % kLanes; // which 16 bytes of the row
  const bool col = piece * kVec < hd;  // inside the true row
  const int run0 = c0 + warp * kRun;

  // 1. the row offsets of the run (the paged kernel's page-table reads)
  // while n_valid is on its way, then every K and V load of the run in
  // flight at once
  const int nv_in = __ldg(nvp);
  size_t off[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int s = run0 + j * kPos + sub;
    off[j] = s < cap ? addr(s) : 0;
  }
  const int nv = min(nv_in, cap);
  if (c0 >= nv) return;  // the same for the whole block
  uint4 kr[kLoads], vr[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (col && run0 + j * kPos + sub < nv) {
      kr[j] = __ldg(reinterpret_cast<const uint4*>(kc + off[j]) + piece);
      vr[j] = __ldg(reinterpret_cast<const uint4*>(vc + off[j]) + piece);
    } else {
      kr[j] = make_uint4(0u, 0u, 0u, 0u);
      vr[j] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // q as f32: this lane's 16 bytes of each row
  float qf[kMaxG][kVec];
#pragma unroll
  for (int qi = 0; qi < kMaxG; ++qi) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qf[qi][e] = (qi < g && col) ? to_f(q[qi * hd + piece * kVec + e]) : 0.f;
  }

  // 2. scores: each row's dot over the lane's elements, summed over the
  // kLanes lanes of the position by rows_sum
  const int row = held_row<kLanes>(piece);
  const bool writer = (piece & (kLanes / 8 - 1)) == 0;  // one lane a row
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    float kf[kVec];
    unpack(kr[j], kf);
    float d[kMaxG];
#pragma unroll
    for (int qi = 0; qi < kMaxG; ++qi) {
      d[qi] = 0.f;
      if (qi < g) {  // g is the same for the whole warp
#pragma unroll
        for (int e = 0; e < kVec; ++e) d[qi] = fmaf(qf[qi][e], kf[e], d[qi]);
      }
    }
    const float sum = rows_sum<kLanes>(d, piece);
    const int slot = j * kPos + sub;
    if (writer && row < g)
      s_p[warp][row][slot] = run0 + slot < nv ? sum * scale : -INFINITY;
  }
  __syncwarp();

  // 3. softmax: lane = (row r, quarter q4) takes kPerLane positions from
  // kPerLane * q4
  const int r = lane >> 2, q4 = lane & 3;
  float sv[kPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    sv[i] = r < g ? s_p[warp][r][kPerLane * q4 + i] : -INFINITY;
    mx = fmaxf(mx, sv[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (q4 == 0 && r < g) s_m[warp][r] = mx;
  __syncthreads();
  float mc = -INFINITY;  // the chunk maximum, finite: position c0 is valid
  if (r < g) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, s_m[w][r]);
  }
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int slot = kPerLane * q4 + i;
    const float p = (r < g && run0 + slot < nv) ? expf(sv[i] - mc) : 0.f;
    l += p;
    if (r < g) s_p[warp][r][slot] = p;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (q4 == 0 && r < g) s_l[warp][r] = l;
  __syncwarp();

  // 4. p.v over the lane's positions in load order, then over the kPos
  // positions of a load by a butterfly
  float acc[kMaxG][kVec];
#pragma unroll
  for (int qi = 0; qi < kMaxG; ++qi)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[qi][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    float vf[kVec];
    unpack(vr[j], vf);
    const int slot = j * kPos + sub;
#pragma unroll
    for (int qi = 0; qi < kMaxG; ++qi) {
      if (qi < g) {
        const float p = s_p[warp][qi][slot];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[qi][e] = fmaf(p, vf[e], acc[qi][e]);
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < kMaxG; ++qi) {
    if (qi < g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1)
          acc[qi][e] += __shfl_xor_sync(0xffffffffu, acc[qi][e], off);
        if (sub == 0) s_acc[warp][qi][piece * kVec + e] = acc[qi][e];
      }
    }
  }
  write_partials<HDP>(s_m, s_l, s_acc, g, part);
}

// a, b rounded to bf16 (round to nearest even), a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A.B on the tensor cores, m16n8k16, bf16 inputs, f32 sums. A is
// (a0, a1, a2, a3): rows r and r + 8 at k 2t, 2t+1, then the same rows at
// k 2t+8, 2t+9; B is (b0, b1): k 2t, 2t+1 and 2t+8, 2t+9 at column r;
// d is rows r, r + 8 at columns 2t, 2t+1 (r = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The same block over a bf16 cache, both products on the tensor cores:
// q.k with the g query rows padded to M = 16 and the warp's 8 positions as
// N; p.v with the same rows as M and the 8 positions as K (padded to 16),
// p never leaving registers. Lane (r, t) = (lane / 4, lane % 4) reads
// 16 bytes of K at position r and, per 64 dims, 16 bytes of V at positions
// 2t and 2t+1; the k (dims) of q.k and the n (dims) of p.v are permuted to
// match those loads, and q and the output follow the same permutations.
template <typename TQ, int HDP, typename Addr>
__device__ __forceinline__ void decode_chunk(
    const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const Addr addr,
    const int* __restrict__ nvp, int cap, int g, int hd, int c0, float scale,
    float* __restrict__ part) {
  static_assert(kRun == 8, "one 8-column tile of positions a warp");
  constexpr int kBlocks = HDP / 32;  // 16-byte K loads a lane
  constexpr int kHalves = HDP / 64;  // 16-byte V loads a lane and position
  __shared__ float s_m[kWarps][kMaxG];
  __shared__ float s_l[kWarps][kMaxG];
  __shared__ float s_acc[kWarps][kMaxG][HDP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, t = lane & 3;
  const int run0 = c0 + warp * kRun;
  const int sk = run0 + r, sv = run0 + 2 * t;  // K row; V rows sv, sv + 1

  // 1. row offsets while n_valid is on its way, then all loads at once
  const int nv_in = __ldg(nvp);
  const size_t ok = sk < cap ? addr(sk) : 0;
  const size_t ov[2] = {sv < cap ? addr(sv) : 0,
                        sv + 1 < cap ? addr(sv + 1) : 0};
  const int nv = min(nv_in, cap);
  if (c0 >= nv) return;  // the same for the whole block
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 kr[kBlocks], vr[2][kHalves];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)  // dims 32b + 8t .. 32b + 8t + 7
    kr[b] = (sk < nv && 32 * b + 8 * t < hd)
                ? __ldg(reinterpret_cast<const uint4*>(kc + ok) + 4 * b + t)
                : zero;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)  // dims 64hh + 8r .. 64hh + 8r + 7
      vr[j][hh] = (sv + j < nv && 64 * hh + 8 * r < hd)
                      ? __ldg(reinterpret_cast<const uint4*>(vc + ov[j]) +
                              8 * hh + r)
                      : zero;
  // q row r at the dims of this lane's K loads, rounded to bf16
  uint32_t qa[kBlocks][4];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const TQ* qp = q + r * hd + 32 * b + 8 * t + 2 * i;
      qa[b][i] = (r < g && 32 * b + 8 * t < hd)
                     ? pack_bf16(to_f(qp[0]), to_f(qp[1]))
                     : 0u;
    }

  // 2. scores: logical k 2t, 2t+1 | 2t+8, 2t+9 of step (b, h) are dims
  // 32b + 8t + 4h + 0, 1 | 2, 3, the words 2h | 2h+1 of both operands
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mma_bf16(sc, qa[b][2 * h], 0u, qa[b][2 * h + 1], 0u,
               word(kr[b], 2 * h), word(kr[b], 2 * h + 1));

  // 3. softmax: sc[j] is row r at position sv + j
  float sj[2];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sj[j] = (r < g && sv + j < nv) ? sc[j] * scale : -INFINITY;
    mx = fmaxf(mx, sj[j]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (t == 0 && r < g) s_m[warp][r] = mx;
  __syncthreads();
  float mc = -INFINITY;  // the chunk maximum, finite: position c0 is valid
  if (r < g) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, s_m[w][r]);
  }
  float p[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    p[j] = (r < g && sv + j < nv) ? expf(sj[j] - mc) : 0.f;
  float l = p[0] + p[1];
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (t == 0 && r < g) s_l[warp][r] = l;

  // 4. p.v: A = p rounded to bf16 (row r, k 2t, 2t+1 = positions sv, sv+1);
  // output column n of tile (hh, e) is dim 64hh + 8n + e, so B's column r
  // is element e of this lane's V loads and d[0], d[1] are dims
  // 64hh + 16t + e and 64hh + 16t + 8 + e
  const uint32_t pa = pack_bf16(p[0], p[1]);
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t b0 = __byte_perm(word(vr[0][hh], e / 2),
                                      word(vr[1][hh], e / 2),
                                      (e & 1) ? 0x7632 : 0x5410);
      mma_bf16(d, pa, 0u, 0u, 0u, b0, 0u);
      if (r < g) {
        s_acc[warp][r][64 * hh + 16 * t + e] = d[0];
        s_acc[warp][r][64 * hh + 16 * t + 8 + e] = d[1];
      }
    }
  write_partials<HDP>(s_m, s_l, s_acc, g, part);
}

// Lets the merge launch start while this grid runs (programmatic dependent
// launch); the merge waits for this grid's completion before it reads the
// partials.
__device__ __forceinline__ void let_merge_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}

template <typename TQ, typename TC, int HDP>
__global__ void __launch_bounds__(kThreads)
    decode_contig_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                         const TC* __restrict__ vc,
                         const int* __restrict__ n_valid, int Hkv, int g,
                         int hd, int S, int nch, float scale,
                         float* __restrict__ ws) {
  let_merge_start();
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const size_t qoff = ((size_t)b * Hkv + h) * g * hd;
  const ContigAddr addr{((size_t)b * Hkv + h) * S * hd, hd};
  decode_chunk<TQ, HDP>(q + qoff, kc, vc, addr, n_valid + b, S, g, hd,
                        c * kChunk, scale,
                        ws + ws_offset<HDP>(b, h, c, Hkv, nch, g));
}

template <typename TQ, typename TC, int HDP>
__global__ void __launch_bounds__(kThreads)
    decode_paged_kernel(const TQ* __restrict__ q, const TC* __restrict__ kp,
                        const TC* __restrict__ vp,
                        const int* __restrict__ page_table,
                        const int* __restrict__ n_valid, int Hkv, int g, int hd,
                        int ps, int npg, int nch, float scale,
                        float* __restrict__ ws) {
  let_merge_start();
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const size_t qoff = ((size_t)b * Hkv + h) * g * hd;
  const PagedAddr addr{page_table + (size_t)b * npg, Hkv, h, ps, hd};
  decode_chunk<TQ, HDP>(q + qoff, kp, vp, addr, n_valid + b, npg * ps, g, hd,
                        c * kChunk, scale,
                        ws + ws_offset<HDP>(b, h, c, Hkv, nch, g));
}

// One (b, h): the chunks' partials merged in chunk order 0 .. n-1 by the
// online rule (m, l, a) <- (m', l e + l_c e_c, a e + acc_c e_c) with
// m' = max(m, m_c), e = exp(m - m'), e_c = exp(m_c - m'), in one pass, so
// that the loads of several chunks are in flight at once; then
// out = a / max(l, 1e-30), the hd true columns of each row. A row with no
// valid position has no chunk and writes 0.
template <typename TQ, int HDP>
__global__ void __launch_bounds__(kMergeThreads)
    decode_merge_kernel(const float* __restrict__ ws,
                        const int* __restrict__ n_valid, int Hkv, int g, int hd,
                        int cap, int nch, TQ* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int nv = max(0, min(n_valid[b], cap));
  const int n = (nv + kChunk - 1) / kChunk;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partials are in
  const size_t stride = (size_t)g * (HDP + 2);
  const float* w0 = ws + ws_offset<HDP>(b, h, 0, Hkv, nch, g);
  TQ* o = out + ((size_t)b * Hkv + h) * g * hd;
  for (int i = threadIdx.x; i < g * hd; i += kMergeThreads) {
    const int qi = i / hd;
    const float* wm = w0 + g * HDP + qi;  // m_c of this row; l_c at +g
    const float* wa = w0 + qi * HDP + (i - qi * hd);
    float m = -INFINITY, l = 0.f, a = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float mc = wm[c * stride], lc = wm[c * stride + g];
      const float ac = wa[c * stride];
      const float mn = fmaxf(m, mc);  // finite: every chunk below n has data
      const float e = expf(m - mn), ec = expf(mc - mn);
      l = l * e + lc * ec;
      a = a * e + ac * ec;
      m = mn;
    }
    o[i] = from_f<TQ>(a / fmaxf(l, 1e-30f));
  }
}

// dtype codes shared with kernels/decode_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename TQ, typename TC, int HDP>
int launch(bool paged, const void* q, const void* k, const void* v,
           const void* page_table, const void* n_valid, int B, int Hkv, int g,
           int hd, int S_or_ps, int npg, float scale, void* ws, void* out,
           cudaStream_t stream) {
  const int cap = paged ? S_or_ps * npg : S_or_ps;
  const int nch = (cap + kChunk - 1) / kChunk;
  float* w = static_cast<float*>(ws);
  if (nch > 0) {
    const dim3 grid(Hkv, B, nch);
    if (paged) {
      decode_paged_kernel<TQ, TC, HDP><<<grid, kThreads, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TC*>(k),
          static_cast<const TC*>(v), static_cast<const int*>(page_table),
          static_cast<const int*>(n_valid), Hkv, g, hd, S_or_ps, npg, nch,
          scale, w);
    } else {
      decode_contig_kernel<TQ, TC, HDP><<<grid, kThreads, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TC*>(k),
          static_cast<const TC*>(v), static_cast<const int*>(n_valid), Hkv, g,
          hd, S_or_ps, nch, scale, w);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_merge_kernel<TQ, HDP>, static_cast<const float*>(w),
      static_cast<const int*>(n_valid), Hkv, g, hd, cap, nch,
      static_cast<TQ*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch_hd(int hd, bool paged, const void* q, const void* k, const void* v,
              const void* pt, const void* nv, int B, int Hkv, int g, int S_or_ps,
              int npg, float scale, void* ws, void* out, cudaStream_t st) {
  // the padded width: the kernel's lane mapping needs 64 or 128
  if (hd < 16 || hd > 128 || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch<TQ, TC, 64>(paged, q, k, v, pt, nv, B, Hkv, g, hd, S_or_ps,
                              npg, scale, ws, out, st);
  return launch<TQ, TC, 128>(paged, q, k, v, pt, nv, B, Hkv, g, hd, S_or_ps,
                             npg, scale, ws, out, st);
}

int dispatch(int q_dtype, int c_dtype, int hd, bool paged, const void* q,
             const void* k, const void* v, const void* pt, const void* nv,
             int B, int Hkv, int g, int S_or_ps, int npg, float scale,
             void* ws, void* out, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && c_dtype == kF32)
    return launch_hd<float, float>(hd, paged, q, k, v, pt, nv, B, Hkv, g,
                                   S_or_ps, npg, scale, ws, out, st);
  if (q_dtype == kBF16 && c_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, paged, q, k, v, pt, nv, B, Hkv, g, S_or_ps, npg, scale, ws, out,
        st);
  if (q_dtype == kF32 && c_dtype == kBF16)
    return launch_hd<float, __nv_bfloat16>(hd, paged, q, k, v, pt, nv, B, Hkv,
                                           g, S_or_ps, npg, scale, ws, out,
                                           st);
  if (q_dtype == kBF16 && c_dtype == kF32)
    return launch_hd<__nv_bfloat16, float>(hd, paged, q, k, v, pt, nv, B, Hkv,
                                           g, S_or_ps, npg, scale, ws, out,
                                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Positions per block: the caller sizes the workspace as
// (B, Hkv, ceil(capacity / chunk), g, hdp + 2) f32, hdp the padded head dim
// (64 for hd <= 64, else 128).
int decode_attention_chunk(void) { return kChunk; }

// q (B, Hkv, g, hd); k, v (B, Hkv, S, hd), 16-byte aligned; n_valid (B,)
// int32; workspace as above with capacity S; out like q. Two launches on
// `stream`. Returns cudaGetLastError() after the launches.
int decode_attention(int q_dtype, int c_dtype, int hd, const void* q,
                     const void* k, const void* v, const void* n_valid, int B,
                     int Hkv, int g, int S, float scale, void* workspace,
                     void* out, void* stream) {
  return dispatch(q_dtype, c_dtype, hd, false, q, k, v, nullptr, n_valid, B,
                  Hkv, g, S, 0, scale, workspace, out, stream);
}

// q (B, Hkv, g, hd); k, v pools (P, Hkv, ps, hd), 16-byte aligned;
// page_table (B, npg) int32; n_valid (B,) int32; workspace as above with
// capacity npg * ps; out like q. Returns cudaGetLastError().
int paged_decode_attention(int q_dtype, int c_dtype, int hd, const void* q,
                           const void* k_pool, const void* v_pool,
                           const void* page_table, const void* n_valid, int B,
                           int Hkv, int g, int ps, int npg, float scale,
                           void* workspace, void* out, void* stream) {
  return dispatch(q_dtype, c_dtype, hd, true, q, k_pool, v_pool, page_table,
                  n_valid, B, Hkv, g, ps, npg, scale, workspace, out, stream);
}

}  // extern "C"
