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
// Reduction design (one Lloyd step's sums and counts, a second launch).
// Each problem's rows are cut into segments of kSeg = 256 rows, a constant
// of this source (never derived from the card), and one block of 256
// threads takes one (segment, problem): the grid is (segments x R, G) with
// the restart r fastest, so the R restarts' blocks of one data segment run
// side by side and read its rows from L2 (10 slabs x 16 segments x 3
// restarts = 480 blocks at a local Lloyd step, 153 at the statistics over
// 38,970 rows). A block reads its segment's assignments and weights once;
// rows with w = 0 are dropped. Each thread owns four features (a float4
// load when d % 4 == 0 and x is 16-byte aligned; bf16 as 8 bytes when
// 8-byte aligned; scalars otherwise) and walks the rows in row order,
// eight row loads in flight, adding w * x with fmaf into its own column of
// per-cluster f32 sums in shared memory. That is the order a stable sort
// of the rows by cluster followed by a walk of each cluster's rows would
// give (each sum takes its cluster's rows in row order, from 0), without
// the sort: an O(kSeg^2) rank per block was measured to cost more than
// the sums. Each cluster's count is its weights added in row order. A
// partial row is written for every cluster (0 if absent) into a workspace
// (level 0: problem, segment, cluster, feature). The partials are combined
// in segment order by a fixed tree: groups of kFanIn = 16 consecutive
// partials are added in order from 0 by the last block of the group to
// finish (__threadfence, then a per-group counter; no atomic sums), which
// writes the next level's partial, until one group is left, whose last
// block writes sums and counts (one stage at a local Lloyd step, two at
// the statistics). A counter is set back to 0 by the block that finds
// itself last, so the counters, zeroed once when first allocated, need no
// clearing per call. The order of every sum depends only on the row
// order, kSeg and kFanIn, so two launches on the same inputs give the
// same bits. The reduction is launched early (programmatic dependent
// launch): its blocks load their weights while the assignment runs, then
// wait for it (griddepcontrol.wait). A tree stage is bound by what one SM
// reads from L2 (about 1 MB at the statistics shape).
//
// Why the reduction is not fused into the assignment, as the TPU kernel
// fuses it: an assignment block owns 32 rows, so a fused kernel would
// write one partial per (row tile, problem, cluster), 168 MB at the Lloyd
// shape, more than the 120 MB of x it saves re-reading; and the R*K x d
// partials do not fit in shared memory beside the assignment's staging
// ring once d or R*K grows.
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
constexpr int kSeg = 256;         // reduce: rows per segment
constexpr int kRedThreads = kSeg; // reduce block: a row each, 4 features
constexpr int kFanIn = 16;        // reduce: partials added per tree group
constexpr int kRun = 8;           // reduce: row loads in flight per thread
constexpr int kAccBytes = 64 << 10;  // reduce: per-cluster sums in smem
constexpr int kMaxLevels = 12;    // reduce: tree levels (kSeg * 16^10 rows)
constexpr int kDrop = 0x7fffffff; // reduce: the cluster of a row w = 0

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
  // lets a dependent launch (the reduction) start; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
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

// The tree of partials of one reduction call, the same for every problem:
// level l holds n[l] partials per problem (n[0] = the segments); stage l
// adds groups of kFanIn consecutive level-l partials into level l + 1, and
// the last stage (level stages has one partial) writes the outputs; with
// one segment there is no stage and its partial is the output (0 + a = a
// bit for bit: no partial is -0). Offsets are in 4-byte words of the
// workspace; ctr[l] is the first counter of stage l's groups. kc
// clusters' sums fit in shared memory at once.
struct Tree {
  int stages, kc;
  int n[kMaxLevels];
  long long sums[kMaxLevels], cnts[kMaxLevels];
  long long ctr[kMaxLevels];
};

// the 4-feature columns a block holds at once, one a thread
__host__ __device__ constexpr int pass_quads(int d) {
  return d < 4 * kRedThreads ? (d + 3) / 4 : kRedThreads;
}

Tree plan_tree(int P, int n, int K, int d, long long* words,
               long long* counters) {
  Tree tr{};
  tr.kc = min(K, max(1, kAccBytes / (16 * pass_quads(d))));
  tr.n[0] = n > kSeg ? (n + kSeg - 1) / kSeg : 1;
  int L = 0;
  for (; tr.n[L] > 1; ++L) tr.n[L + 1] = (tr.n[L] + kFanIn - 1) / kFanIn;
  tr.stages = L;
  long long off = 0, c = 0;
  for (int l = 0; l < L; ++l) {
    tr.sums[l] = off;   // a multiple of 4 words: 16-byte aligned rows
    off += (long long)P * tr.n[l] * K * d;
    tr.cnts[l] = off;
    off = (off + (long long)P * tr.n[l] * K + 3) / 4 * 4;
    tr.ctr[l] = c;
    c += (long long)P * tr.n[l + 1];
  }
  *words = off;
  *counters = c;
  return tr;
}

// Features f .. f + 3 of a row, upcast; past d (left < 4) they read 0.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int left) {
  if constexpr (VEC) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(p[0], left > 1 ? p[1] : 0.f, left > 2 ? p[2] : 0.f,
                       left > 3 ? p[3] : 0.f);
  }
}
template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int left) {
  if constexpr (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return make_float4(to_f32(p[0]), left > 1 ? to_f32(p[1]) : 0.f,
                       left > 2 ? to_f32(p[2]) : 0.f,
                       left > 3 ? to_f32(p[3]) : 0.f);
  }
}
// the same from a partial written by another block (read through L2)
template <bool VEC>
__device__ __forceinline__ float4 load4_cg(const float* p, int left) {
  if constexpr (VEC) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  } else {
    return make_float4(__ldcg(p), left > 1 ? __ldcg(p + 1) : 0.f,
                       left > 2 ? __ldcg(p + 2) : 0.f,
                       left > 3 ? __ldcg(p + 3) : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v, int left) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    if (left > 1) p[1] = v.y;
    if (left > 2) p[2] = v.z;
    if (left > 3) p[3] = v.w;
  }
}
__device__ __forceinline__ float4 fma4(float w, float4 x, float4 a) {
  return make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y), fmaf(w, x.z, a.z),
                     fmaf(w, x.w, a.w));
}

// One tree group: nm consecutive partials (src, srcc: the first one's sums
// and counts) added in order from 0 into dsum (K, d) and dcnt (K,). The
// block's threads take the (cluster, 4-feature column) pairs in turn, each
// with the loads of all kFanIn partials in flight at once (a partial past
// nm re-reads the last and is not added).
template <bool VEC>
__device__ void combine(const float* src, const float* srcc, int nm, int K,
                        int d, float* dsum, float* dcnt) {
  const int nq = (d + 3) / 4;
  const size_t kd = (size_t)K * d;
  for (int e = threadIdx.x; e < K * nq; e += kRedThreads) {
    const int k = e / nq, f = 4 * (e % nq), left = d - f;
    float4 v[kFanIn];
#pragma unroll
    for (int m = 0; m < kFanIn; ++m)
      v[m] = load4_cg<VEC>(src + min(m, nm - 1) * kd + (size_t)k * d + f,
                           left);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kFanIn; ++m) {
      if (m < nm) {
        a.x += v[m].x;
        a.y += v[m].y;
        a.z += v[m].z;
        a.w += v[m].w;
      }
    }
    store4<VEC>(dsum + (size_t)k * d + f, a, left);
  }
  for (int k = threadIdx.x; k < K; k += kRedThreads) {
    float c = 0.f;
    for (int m = 0; m < nm; ++m) c += __ldcg(srcc + (size_t)m * K + k);
    dcnt[k] = c;
  }
}

// One block per (segment s, problem p = g * R + r), blockIdx.x = s * R + r;
// thread t owns features f = 4t .. 4t + 3 (and f + 4 * kRedThreads, ... when
// d > 1024). VEC: d % 4 == 0 and x, the workspace and sums aligned for
// 4-feature loads and stores. Dynamic shared memory: tr.kc x pass_quads(d)
// float4, thread t's running sums of its features for each cluster of the
// chunk (no thread reads another's).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kRedThreads)
    segment_reduce_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const int* __restrict__ assign, int n, int K, int d,
                          int R, Tree tr, float* ws, int* ctr,
                          float* __restrict__ sums,
                          float* __restrict__ counts) {
  extern __shared__ float4 acc[];   // [tr.kc][pass_quads(d)]
  __shared__ int key[kSeg];         // the row's cluster; kDrop: no weight
  __shared__ float sw[kSeg];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int r = blockIdx.x % R, s = blockIdx.x / R, g = blockIdx.y;
  const int p = g * R + r;
  const int row0 = s * kSeg, nr = min(kSeg, n - row0);
  // thread t's row; its weight does not depend on the assignment, so it is
  // loaded before the wait for the assignment grid
  const float wi = t < nr ? w[(size_t)g * n + row0 + t] : 0.f;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  key[t] = t < nr && wi != 0.f ? assign[(size_t)p * n + row0 + t] : kDrop;
  sw[t] = wi;
  __syncthreads();

  // this block's partial: level 0 of the tree, or the outputs
  const size_t pre0 = ((size_t)p * tr.n[0] + s) * K;
  float* part = tr.stages ? ws + tr.sums[0] + pre0 * d : sums + pre0 * d;
  float* pcnt = tr.stages ? ws + tr.cnts[0] + pre0 : counts + pre0;
  // each cluster's count: its weights added in row order (0 if absent)
  for (int k = t; k < K; k += kRedThreads) {
    float c = 0.f;
    for (int j = 0; j < kSeg; ++j)
      if (key[j] == k) c += sw[j];
    pcnt[k] = c;
  }
  // each cluster's sums: the rows walked in row order, each added with
  // fmaf to its cluster's running sum, so that each sum takes its rows in
  // row order from 0; kRun row loads in flight; chunks of tr.kc clusters
  // (every cluster when K * d is small enough), a pass for each 1,024
  // features; every cluster's partial is written (0 if absent)
  const T* xs = x + ((size_t)g * n + row0) * d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nq = pass_quads(d);
  for (int f = 4 * t; f < d; f += 4 * kRedThreads) {
    const int left = d - f;
    for (int k0 = 0; k0 < K; k0 += tr.kc) {
      const int kc = min(tr.kc, K - k0);
      for (int i = 0; i < kc; ++i) acc[i * nq + t] = zero;
      for (int j0 = 0; j0 < kSeg; j0 += kRun) {
        float4 v[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const unsigned i = key[j0 + u] - k0;   // the chunk's cluster
          v[u] = i < (unsigned)kc
                     ? load4<VEC>(xs + (size_t)(j0 + u) * d + f, left)
                     : zero;
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const unsigned i = key[j0 + u] - k0;
          if (i < (unsigned)kc) {
            float4* a = acc + i * nq + t;
            *a = fma4(sw[j0 + u], v[u], *a);
          }
        }
      }
      for (int i = 0; i < kc; ++i)
        store4<VEC>(part + (size_t)(k0 + i) * d + f, acc[i * nq + t], left);
    }
  }

  // the tree: the last block of each group to finish adds the group
  int idx = s;
  for (int l = 0; l < tr.stages; ++l) {
    const int nl = tr.n[l], grp = idx / kFanIn, m0 = grp * kFanIn;
    const int nm = min(kFanIn, nl - m0);
    __threadfence();   // this block's partial is visible to every block
    __syncthreads();
    if (t == 0) {
      int* cp = ctr + tr.ctr[l] + (size_t)p * tr.n[l + 1] + grp;
      const bool last = atomicAdd(cp, 1) == nm - 1;
      if (last) atomicExch(cp, 0);   // ready for the next call
      s_last = last;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();   // the group's partials are visible to this block
    const bool out = l + 1 == tr.stages;
    const size_t dst = (size_t)p * tr.n[l + 1] + grp;   // = p when out
    const size_t src = (size_t)p * nl + m0;
    combine<VEC>(ws + tr.sums[l] + src * K * d, ws + tr.cnts[l] + src * K,
                 nm, K, d,
                 out ? sums + dst * K * d : ws + tr.sums[l + 1] + dst * K * d,
                 out ? counts + dst * K : ws + tr.cnts[l + 1] + dst * K);
    idx = grp;
  }
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

template <typename T, bool VEC>
int launch_reduce_vec(const void* x, const void* w, const void* assign, int P,
                      int R, int n, int K, int d, void* sums, void* counts,
                      void* ws, void* ctr, bool early, cudaStream_t s) {
  long long words = 0, nctr = 0;
  const Tree tr = plan_tree(P, n, K, d, &words, &nctr);
  auto kernel = segment_reduce_kernel<T, VEC>;
  const size_t bytes = (size_t)tr.kc * pass_quads(d) * sizeof(float4);
  // above 48 KB a block's dynamic shared memory must be allowed explicitly,
  // once per kernel and device
  static unsigned long long allowed = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(allowed >> dev & 1ull)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAccBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tr.n[0] * R, P / R);
  cfg.blockDim = dim3(kRedThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int*>(assign), n, K, d, R, tr,
      static_cast<float*>(ws), static_cast<int*>(ctr),
      static_cast<float*>(sums), static_cast<float*>(counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// early: start while the assignment launched just before runs
// (programmatic dependent launch); the kernel waits for it before it reads
// the assignments
template <typename T>
int launch_reduce(const void* x, const void* w, const void* assign, int P,
                  int R, int n, int K, int d, void* sums, void* counts,
                  void* ws, void* ctr, bool early, cudaStream_t s) {
  const uintptr_t al = sizeof(T) == 4 ? 16 : 8;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % al == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sums) % 16 == 0;
  return vec ? launch_reduce_vec<T, true>(x, w, assign, P, R, n, K, d, sums,
                                          counts, ws, ctr, early, s)
             : launch_reduce_vec<T, false>(x, w, assign, P, R, n, K, d, sums,
                                           counts, ws, ctr, early, s);
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

// The reduction's scratch for a call of kmeans_assign_reduce: out[0] 4-byte
// words of workspace (uninitialised; f32 partials and int32 row counts),
// out[1] int32 counters, which must be zero before the first call and
// are left zero by every call, out[2] the segment size kSeg and out[3] the
// tree's fan-in kFanIn.
int kmeans_reduce_plan(int P, int n, int K, int d, long long* out) {
  plan_tree(P, n, K, d, &out[0], &out[1]);
  out[2] = kSeg;
  out[3] = kFanIn;
  return 0;
}

// As kmeans_assign, plus w (P/R, n) f32, the outputs sums (P, K, d) and
// counts (P, K), both f32 and written in full (n = 0 writes zeros), and
// the scratch that kmeans_reduce_plan sizes: ws and ctr.
int kmeans_assign_reduce(int dtype, const void* x, const void* cents,
                         const void* w, int P, int R, int n, int K, int d,
                         void* assign, void* sums, void* counts, void* ws,
                         void* ctr, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (n > 0)
    err = dtype == 1
              ? launch_assign<__nv_bfloat16>(x, cents, P, R, n, K, d, assign, s)
              : launch_assign<float>(x, cents, P, R, n, K, d, assign, s);
  if (err != 0) return err;
  return dtype == 1
             ? launch_reduce<__nv_bfloat16>(x, w, assign, P, R, n, K, d, sums,
                                            counts, ws, ctr, n > 0, s)
             : launch_reduce<float>(x, w, assign, P, R, n, K, d, sums, counts,
                                    ws, ctr, n > 0, s);
}

}  // extern "C"
