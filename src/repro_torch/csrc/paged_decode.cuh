// Split-and-combine paged decode attention for Hopper (sm_90a), shared by
// paged_attention.cu (fp32 / bf16 pools) and paged_attention_quant.cu
// (int8 / fp8-e4m3 code pools with per-page scales).
//
// One query token per request row b against K/V page pools (P, ps, KV, hd)
// gathered through a block table pt (B, nblk1): logical block i of row b
// lives in page pt[b, i]; position kpos = i * ps + r is live iff
// kpos <= pos[b] (and kpos > pos[b] - window for sliding-window layers).
// Only the logical blocks first .. last that hold a live position are read
// (live_blocks); a pos in the trash column is clamped to the table's last
// block.  Masked positions contribute exactly 0, as in the reference.
//
// The sweep over a row's pages is split across blocks (flash-decoding):
//   * split kernel, grid B * KV * splits (flattened): block (b, h, s) serves
//     the G = H / KV query heads of kv head h over the logical blocks
//     [s * bps, (s + 1) * bps).  The host picks (splits, bps) from B, KV,
//     nblk1 and ps alone (kernels/paged_attention.py: split_plan), never
//     from pos or pt.  A split with no live position returns at once; the
//     combine never reads it (its partial would be m = -1e30, l = 0).
//   * Warp w of the block takes the split's blocks w, w + kWarps, ...
//     (ppw = bps / kWarps of them), one "unit" of rows at a time: the whole
//     page, or ps / 2^k rows when kWarps pages do not fit shared memory
//     (fp32 pools at head_dim 256 and ps 32).  Lane k of the warp reads
//     the page id of the warp's k-th block (and, for codes, the page's two
//     scales) once, at the start, in flight together with pos[b]; the warp
//     then issues its units' 16-, 8- or 4-byte cp.async copies, up to
//     `stages` units at once (all of them on the main path, where every
//     warp has one page: the block's whole split is in flight at once).
//   * Per unit, all in the warp, no block-wide barrier: bf16 queries over
//     bf16 pages go through the tensor cores (mma.sync, see split_body);
//     every other instance computes on the CUDA cores, lane (r, part)
//     taking the partial dots of row r with the G query rows (q in shared
//     memory, fp32), the parts reducing by shuffles, and each lane owning 4
//     or 8 output dims with G fp32 accumulators.  Either way the online
//     softmax (m, l per query head) lives in registers.
//   * At the end, one __syncthreads, and the block merges its warps'
//     (m, l, acc) in warp order.  A row whose live blocks all lie in this
//     split writes its output here; otherwise the block writes its partial
//     (m, l, acc[G][hd], fp32) to the scratch the wrapper keeps per stream.
//   * combine kernel, grid B * KV: merges a row's live partials in split
//     order (eight in flight per thread) and writes the output.  It is the
//     split kernel's programmatic dependent launch, scheduled once every
//     split block has reached its merge, so the launch gap between the two
//     is hidden.  No atomics: one input gives bitwise the same output on
//     every call.
// Why: a decode step reads little (about 1 MB of K/V for 16 rows at ~200
// positions), so the time is latency: a chain of dependent loads and
// barriers per page in one block per (row, kv head).  Here the page ids
// and scales come off the critical path, all pages of a split are in
// flight together, and B * KV * splits blocks cover the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kWarps = 4;                 // warps per split block
constexpr int kThreads = 32 * kWarps;
constexpr int kCombineThreads = 256;      // an item (head, 4 dims) each
constexpr int kMaxGroup = 16;             // query heads per kv head
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPage = 32;              // rows per page
constexpr int kMaxPagesPerWarp = 32;      // lane k holds the k-th page id
constexpr int kMaxStages = 4;             // units in flight per warp
constexpr int kStageBudget = 100 * 1024;  // shared bytes for several stages
constexpr int kSmemBudget = 200 * 1024;
constexpr float kNeg = -1e30f;            // the reference's mask value

// Everything both kernels read; passed by value.
struct Args {
  const void* q;          // (B, 1, H, hd) TQ
  const char* kp;         // (P, ps, KV, hd) pool elements or codes
  const char* vp;
  const float* ks;        // (P, KV) scales (code pools only)
  const float* vs;
  const int* pt;          // (B, nblk1)
  const int* pos;         // (B,)
  void* out;              // (B, 1, H, hd) TQ
  float* part;            // partials: acc [B*KV*splits][G][hd], m, l
  int B, H, KV, G, hd, ps, nblk1, window;
  float scale;
  int splits, bps;        // the host's split plan
  int ppw;                // bps / kWarps
  int rows, upp, lg_parts, stages, stride, chunk;  // shared-memory layout
};

// Element loaders: four consecutive elements 4c .. 4c+3 of a stored row,
// widened to fp32 (codes not yet scaled).
struct F32Pool {
  static constexpr int kBytes = 4;
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static float4 load4(const char* row, int c) {
    return *reinterpret_cast<const float4*>(row + 16 * c);
  }
};
struct Bf16Pool {
  static constexpr int kBytes = 2;
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static float4 load4(const char* row, int c) {
    const uint2 r = *reinterpret_cast<const uint2*>(row + 8 * c);
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
};
struct Int8Pool {
  static constexpr int kBytes = 1;
  static constexpr bool kScaled = true;
  __device__ __forceinline__ static float4 load4(const char* row, int c) {
    const uint32_t r = *reinterpret_cast<const uint32_t*>(row + 4 * c);
    return make_float4(static_cast<float>(static_cast<int>(r << 24) >> 24),
                       static_cast<float>(static_cast<int>(r << 16) >> 24),
                       static_cast<float>(static_cast<int>(r << 8) >> 24),
                       static_cast<float>(static_cast<int>(r) >> 24));
  }
};
struct Fp8Pool {
  static constexpr int kBytes = 1;
  static constexpr bool kScaled = true;
  __device__ __forceinline__ static float one(uint32_t b) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b & 0xffu);
    return static_cast<float>(v);
  }
  __device__ __forceinline__ static float4 load4(const char* row, int c) {
    const uint32_t r = *reinterpret_cast<const uint32_t*>(row + 4 * c);
    return make_float4(one(r), one(r >> 8), one(r >> 16), one(r >> 24));
  }
};

// Asynchronous copy of `bytes` (4, 8 or 16; uniform across the warp).
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n (0 .. kMaxStages - 1) of this thread's groups are
// pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// The logical blocks first .. last that hold row b's live positions.
__device__ __forceinline__ void live_blocks(int p, int window, int ps,
                                            int nblk1, int& first,
                                            int& last) {
  last = p / ps;
  if (last > nblk1 - 1) last = nblk1 - 1;      // pos in the trash column
  first = 0;
  if (window > 0 && p - window + 1 > 0) first = (p - window + 1) / ps;
  if (first > last) first = last;
}

// bf16 tensor-core building blocks (mma.sync m16n8k16, fp32 accumulate):
// two floats as a bf16x2 register (lo in the low half), ldmatrix of four
// 8x8 b16 matrices (plain and transposed), and d += a * b.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive query elements 4i .. 4i+3 (8 or 16 bytes) as fp32.
__device__ __forceinline__ float4 load_q4(const float* q, int i) {
  return reinterpret_cast<const float4*>(q)[i];
}
__device__ __forceinline__ float4 load_q4(const __nv_bfloat16* q, int i) {
  return Bf16Pool::load4(reinterpret_cast<const char*>(q), i);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  p[0] = __float2bfloat16(x.x);
  p[1] = __float2bfloat16(x.y);
  p[2] = __float2bfloat16(x.z);
  p[3] = __float2bfloat16(x.w);
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}
__device__ __forceinline__ float4 fma4(float s, float4 x, float4 y) {
  return make_float4(s * x.x + y.x, s * x.y + y.y, s * x.z + y.z,
                     s * x.w + y.w);
}

// Blocks per SM a split kernel's instance asks registers for: four (128
// registers a thread) for the main path's instances, the tensor-core unit
// and the CUDA-core unit of up to 8 query heads and head_dim 128, so that
// the grid's live blocks fit one wave; the wide instances keep up to 255.
__host__ __device__ constexpr int min_blocks(int kG, int kQ, bool kMma) {
  return kMma || (kG <= 8 && kQ == 1) ? 4 : 1;
}

// Shared memory: [units of every warp | merge area, aliased] [q] [p].
__host__ __device__ __forceinline__ int stage_bytes(const Args& a) {
  return kWarps * a.stages * 2 * a.rows * a.stride;
}
template <int kG>
__host__ __device__ __forceinline__ int merge_bytes(const Args& a) {
  return 4 * kWarps * (2 * kG + a.G * a.hd);
}
template <int kG>
__host__ __device__ __forceinline__ int q_offset(const Args& a) {
  const int m = stage_bytes(a) > merge_bytes<kG>(a) ? stage_bytes(a)
                                                     : merge_bytes<kG>(a);
  return (m + 15) / 16 * 16;
}
// the queries: fp32 rows [kG][hd], or bf16 rows [16][hd + 8] for ldmatrix
// on the tensor-core path (16-byte padded rows: no bank conflicts)
template <int kG>
__host__ __device__ __forceinline__ int q_bytes(const Args& a) {
  const int f32 = 4 * kG * a.hd, b16 = 16 * (2 * a.hd + 16);
  return f32 > b16 ? f32 : b16;
}
template <int kG>
__host__ __device__ __forceinline__ int smem_bytes(const Args& a) {
  return q_offset<kG>(a) + q_bytes<kG>(a) + 4 * kWarps * kMaxPage * kG;
}

// The split kernel's body.  TQ: the queries' and output's type; Pool: the
// stored elements; kG >= G query rows (those past G are zeros, computed and
// dropped, so the hot loops carry no branch per head and the compiler
// interleaves the heads' independent chains) and 4 * kQ * 32 >= hd bound
// the registers.
//
// kMma (bf16 queries over bf16 pages, head_dim and page size multiples of
// 16, kG 8 or 16): a warp's unit goes through the tensor cores instead of
// lane-by-lane dot products.  Per 16 keys: S = Q K^T as m16n8k16 products
// (A = the query rows, padded to 16 and staged once as bf16 in shared
// memory, B = the K rows, both by ldmatrix), the online softmax on the
// accumulator fragments (a lane holds 2 query rows x 4 keys; rows reduce
// over a quad by two shuffles), then O += P V with P taken straight from
// those fragments as bf16 (the reference rounds P to the queries' bf16 as
// well) and V by ldmatrix.trans: 32 mma and 24 ldmatrix per 16-row page at
// head_dim 128, where the CUDA-core unit issues some 1,600 instructions a
// lane (counted from the code).
template <typename TQ, typename Pool, int kG, int kQ, bool kMma>
__device__ __forceinline__ void split_body(const Args& a) {
  extern __shared__ __align__(16) char smem[];
  const int bid = blockIdx.x;
  const int s = bid % a.splits;
  const int h = (bid / a.splits) % a.KV;
  const int b = bid / a.splits / a.KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = a.G, hd = a.hd, ps = a.ps, hd4 = hd / 4;

  // pos[b] and the warp's page ids (lane k: the k-th block it serves), in
  // flight together
  const int p = a.pos[b];
  const int j0 = s * a.bps + warp;
  const int jl = j0 + kWarps * lane;
  int page = 0;
  if (lane < a.ppw && jl < a.nblk1) page = a.pt[(long)b * a.nblk1 + jl];

  int first, last;
  live_blocks(p, a.window, ps, a.nblk1, first, last);
  const int lo = s * a.bps;
  const int hi = min(lo + a.bps, a.nblk1) - 1;
  if (hi < first || lo > last) return;   // nothing live: contributes nothing
  const bool alone = first / a.bps == last / a.bps;

  // the warp's live blocks j0 + kWarps * k, k0 <= k <= k1
  const int k0 = j0 >= first ? 0 : (first - j0 + kWarps - 1) / kWarps;
  const int k1 = last < j0 ? -1 : min(a.ppw - 1, (last - j0) / kWarps);
  const int units = k1 >= k0 ? (k1 - k0 + 1) * a.upp : 0;

  float ksc = 1.f, vsc = 1.f;            // this lane's page's scales
  if (Pool::kScaled && lane < a.ppw && jl >= first && jl <= last) {
    ksc = a.ks[(long)page * a.KV + h];
    vsc = a.vs[(long)page * a.KV + h];
  }

  const int unit_bytes = 2 * a.rows * a.stride;
  char* wstage = smem + warp * a.stages * unit_bytes;
  float* q_s = reinterpret_cast<float*>(smem + q_offset<kG>(a));
  float* p_w = q_s + q_bytes<kG>(a) / 4 + warp * kMaxPage * kG;  // [row][kG]
  const long row_elems = (long)a.KV * hd;             // between page rows
  const int per_row = hd * Pool::kBytes / a.chunk;

  auto issue = [&](int t) {
    const int k = k0 + t / a.upp;
    const int r0 = (t % a.upp) * a.rows;
    const int nr = min(a.rows, ps - r0);
    const int pg = __shfl_sync(0xffffffffu, page, k);
    char* kb = wstage + (t % a.stages) * unit_bytes;
    char* vb = kb + a.rows * a.stride;
    const long base =
        (((long)pg * ps + r0) * a.KV + h) * hd * Pool::kBytes;
    for (int c = lane; c < nr * per_row; c += 32) {
      const int r = c / per_row;
      const int off = (c - r * per_row) * a.chunk;
      const long g = base + r * row_elems * Pool::kBytes + off;
      cp_async(kb + r * a.stride + off, a.kp + g, a.chunk);
      cp_async(vb + r * a.stride + off, a.vp + g, a.chunk);
    }
    cp_async_commit();
  };

  const int ahead = min(a.stages, units);
  for (int t = 0; t < ahead; ++t) issue(t);

  // the group's query heads h*G .. h*G+G-1 are contiguous rows of q[b, 0];
  // rows G .. kG-1 are zeros
  const TQ* qg = static_cast<const TQ*>(a.q) + ((long)b * a.H + h * G) * hd;
  float4* q4w = reinterpret_cast<float4*>(q_s);
  char* qb = reinterpret_cast<char*>(q_s);
  const int qstride = 2 * hd + 16;
  if constexpr (kMma) {             // 16 bf16 rows, 16 bytes at a time
    const int hd8 = hd / 8;
    for (int i = threadIdx.x; i < 16 * hd8; i += kThreads) {
      const int row = i / hd8;
      const int c = i - row * hd8;
      *reinterpret_cast<uint4*>(qb + row * qstride + 16 * c) =
          row < G ? reinterpret_cast<const uint4*>(qg)[row * hd8 + c]
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kG * hd4; i += kThreads)
      q4w[i] = i < G * hd4 ? load_q4(qg, i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const float4* q4 = q4w;

  // tensor-core path state: lane (g0 = lane / 4, cq = 2 * (lane % 4)) holds
  // query rows g0 and g0 + 8
  const int g0 = lane >> 2;
  const int cq = 2 * (lane & 3);
  float m2[2] = {kNeg, kNeg}, l2[2] = {0.f, 0.f}, oacc[16 * kQ][4];
  if constexpr (kMma) {
#pragma unroll
    for (int nt = 0; nt < 16 * kQ; ++nt)
      oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  }

  float m[kG], l[kG], acc[kG][4 * kQ];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * kQ; ++i) acc[g][i] = 0.f;
  }

  const int parts = 1 << a.lg_parts;
  const int r = lane >> a.lg_parts;      // this lane's row in a unit
  const int part = lane & (parts - 1);
  for (int t = 0; t < units; ++t) {
    cp_async_wait(min(a.stages - 1, units - 1 - t));
    __syncwarp();
    const int k = k0 + t / a.upp;
    const int j = j0 + kWarps * k;
    const int r0 = (t % a.upp) * a.rows;
    const int nr = min(a.rows, ps - r0);
    const char* kb = wstage + (t % a.stages) * unit_bytes;
    const char* vb = kb + a.rows * a.stride;
    const bool active = r < nr;

    if constexpr (kMma) {
      const int mi = lane >> 3;          // ldmatrix: this lane's matrix
      const int ri = lane & 7;           // and row in it
      for (int kt = 0; kt < nr; kt += 16) {
        // S = Q K^T over keys kt .. kt+15: s[nt] holds rows g0, g0 + 8 at
        // keys kt + 8 nt + cq, +1
        float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 8 * kQ; ++kk) {
          if (kk < hd / 16) {
            uint32_t qf[4], kf[4];
            ldsm_x4(qf, qb + (ri + 8 * (mi & 1)) * qstride +
                            (16 * kk + 8 * (mi >> 1)) * 2);
            ldsm_x4(kf, kb + (kt + ri + 8 * (mi >> 1)) * a.stride +
                            (16 * kk + 8 * (mi & 1)) * 2);
            mma_bf16(sc2[0], qf, kf[0], kf[1]);
            mma_bf16(sc2[1], qf, kf[2], kf[3]);
          }
        }
        float tm[2] = {kNeg, kNeg};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = j * ps + r0 + kt + 8 * nt + cq + (e & 1);
            const bool lv =
                kpos <= p && (a.window == 0 || kpos > p - a.window);
            sc2[nt][e] = lv ? sc2[nt][e] * a.scale : kNeg;
            tm[e >> 1] = fmaxf(tm[e >> 1], sc2[nt][e]);
          }
        }
        float al[2], sum[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          tm[hh] = fmaxf(tm[hh], __shfl_xor_sync(0xffffffffu, tm[hh], 1));
          tm[hh] = fmaxf(tm[hh], __shfl_xor_sync(0xffffffffu, tm[hh], 2));
          const float m_new = fmaxf(m2[hh], tm[hh]);
          al[hh] = expf(m2[hh] - m_new);
          m2[hh] = m_new;
          sum[hh] = 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc2[nt][e] = expf(sc2[nt][e] - m2[e >> 1]);
            sum[e >> 1] += sc2[nt][e];
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
          sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
          l2[hh] = l2[hh] * al[hh] + sum[hh];
        }
#pragma unroll
        for (int nt = 0; nt < 16 * kQ; ++nt) {
          oacc[nt][0] *= al[0];
          oacc[nt][1] *= al[0];
          oacc[nt][2] *= al[1];
          oacc[nt][3] *= al[1];
        }
        // O += P V: P's A fragment is the S fragments as bf16
        const uint32_t pf[4] = {pack_bf16x2(sc2[0][0], sc2[0][1]),
                                pack_bf16x2(sc2[0][2], sc2[0][3]),
                                pack_bf16x2(sc2[1][0], sc2[1][1]),
                                pack_bf16x2(sc2[1][2], sc2[1][3])};
#pragma unroll
        for (int dj = 0; dj < 8 * kQ; ++dj) {
          if (dj < hd / 16) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, vb + (kt + ri + 8 * (mi & 1)) * a.stride +
                                  (16 * dj + 8 * (mi >> 1)) * 2);
            mma_bf16(oacc[2 * dj], pf, vf[0], vf[1]);
            mma_bf16(oacc[2 * dj + 1], pf, vf[2], vf[3]);
          }
        }
      }
    } else {
      // scores: lane (r, part) sums the 4-element groups c = part (mod
      // parts) of row r against every query row, then the parts reduce
      float sc[kG];
  #pragma unroll
      for (int g = 0; g < kG; ++g) sc[g] = 0.f;
      if (active) {
        const char* krow = kb + r * a.stride;
  #pragma unroll 4
        for (int c = part; c < hd4; c += parts) {
          const float4 kv = Pool::load4(krow, c);
  #pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float4 qq = q4[g * hd4 + c];
            sc[g] += qq.x * kv.x + qq.y * kv.y + qq.z * kv.z + qq.w * kv.w;
          }
        }
      }
      for (int off = 1; off < parts; off <<= 1) {
  #pragma unroll
        for (int g = 0; g < kG; ++g)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
      }
      const int kpos = j * ps + r0 + r;
      const bool live =
          active && kpos <= p && (a.window == 0 || kpos > p - a.window);
      const float kscale =
          a.scale * (Pool::kScaled ? __shfl_sync(0xffffffffu, ksc, k) : 1.f);
      const float vscale =
          Pool::kScaled ? __shfl_sync(0xffffffffu, vsc, k) : 1.f;

      // online softmax per query head, in registers; lanes of one row hold
      // the same score, so the reductions step over rows only
      float x[kG], mx[kG], e[kG], sum[kG];
  #pragma unroll
      for (int g = 0; g < kG; ++g) {
        x[g] = live ? sc[g] * kscale : kNeg;
        mx[g] = x[g];
      }
      for (int off = parts; off < 32; off <<= 1) {
  #pragma unroll
        for (int g = 0; g < kG; ++g)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      }
  #pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);
        e[g] = active ? expf(x[g] - m_new) : 0.f;
        sum[g] = e[g];
        mx[g] = expf(m[g] - m_new);          // the rescale factor alpha
        m[g] = m_new;
      }
      for (int off = parts; off < 32; off <<= 1) {
  #pragma unroll
        for (int g = 0; g < kG; ++g)
          sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], off);
      }
  #pragma unroll
      for (int g = 0; g < kG; ++g) {
        l[g] = l[g] * mx[g] + sum[g];
  #pragma unroll
        for (int i = 0; i < 4 * kQ; ++i) acc[g][i] *= mx[g];
      }
      if (active && part == 0) {
  #pragma unroll
        for (int g = 0; g < kG; ++g) p_w[r * kG + g] = e[g] * vscale;
      }
      __syncwarp();

      // acc[g][d] += p[g][row] * v[row][d]; lane owns the 4-element groups
      // lane + 32 * iq
      for (int rr = 0; rr < nr; ++rr) {
        float pr[kG];
  #pragma unroll
        for (int g = 0; g < kG; g += 2) {
          const float2 two =
              *reinterpret_cast<const float2*>(p_w + rr * kG + g);
          pr[g] = two.x;
          pr[g + 1] = two.y;
        }
        const char* vrow = vb + rr * a.stride;
  #pragma unroll
        for (int iq = 0; iq < kQ; ++iq) {
          const int c = lane + 32 * iq;
          if (c < hd4) {
            const float4 v = Pool::load4(vrow, c);
  #pragma unroll
            for (int g = 0; g < kG; ++g) {
              acc[g][4 * iq + 0] += pr[g] * v.x;
              acc[g][4 * iq + 1] += pr[g] * v.y;
              acc[g][4 * iq + 2] += pr[g] * v.z;
              acc[g][4 * iq + 3] += pr[g] * v.w;
            }
          }
        }
      }
    }
    __syncwarp();                        // the stage and p_w are free again
    if (t + a.stages < units) issue(t + a.stages);
  }

  // let the combine kernel launch once every block is here (or gone): it
  // waits for this grid's end (griddepcontrol.wait) before it reads a
  // partial, and is scheduled meanwhile
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // merge the warps in warp order (the merge area aliases the stages)
  __syncthreads();
  float* mw = reinterpret_cast<float*>(smem);          // [kWarps][kG]
  float* lw = mw + kWarps * kG;                        // [kWarps][kG]
  float* aw = lw + kWarps * kG;                        // [kWarps][G][hd]
  if constexpr (kMma) {
    if ((lane & 3) == 0) {
      mw[warp * kG + g0] = m2[0];
      lw[warp * kG + g0] = l2[0];
      if (g0 + 8 < kG) {
        mw[warp * kG + g0 + 8] = m2[1];
        lw[warp * kG + g0 + 8] = l2[1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16 * kQ; ++nt) {
      if (nt < hd / 8) {
        if (g0 < G)
          *reinterpret_cast<float2*>(aw + (warp * G + g0) * hd + 8 * nt +
                                     cq) = make_float2(oacc[nt][0],
                                                       oacc[nt][1]);
        if (g0 + 8 < G)
          *reinterpret_cast<float2*>(aw + (warp * G + g0 + 8) * hd + 8 * nt +
                                     cq) = make_float2(oacc[nt][2],
                                                       oacc[nt][3]);
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (lane == g) {
        mw[warp * kG + g] = m[g];
        lw[warp * kG + g] = l[g];
      }
      if (g < G) {
#pragma unroll
        for (int iq = 0; iq < kQ; ++iq) {
          const int c = lane + 32 * iq;
          if (c < hd4)
            *reinterpret_cast<float4*>(aw + (warp * G + g) * hd + 4 * c) =
                make_float4(acc[g][4 * iq], acc[g][4 * iq + 1],
                            acc[g][4 * iq + 2], acc[g][4 * iq + 3]);
        }
      }
    }
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out) + ((long)b * a.H + h * G) * hd;
  const long pidx = bid;                 // (b * KV + h) * splits + s
  float* pa = a.part + pidx * G * hd;
  float* pm = a.part + (long)a.B * a.KV * a.splits * G * hd + pidx * G;
  float* pl = pm + (long)a.B * a.KV * a.splits * G;
  const float4* aw4 = reinterpret_cast<const float4*>(aw);
  for (int i = threadIdx.x; i < G * hd4; i += kThreads) {
    const int g = i / hd4;
    float M = mw[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, mw[w * kG + g]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float al = expf(mw[w * kG + g] - M);
      L += al * lw[w * kG + g];
      A = fma4(al, aw4[w * G * hd4 + i], A);
    }
    if (alone) {
      store4(out + 4 * i, scale4(A, 1.f / fmaxf(L, 1e-30f)));
    } else {
      reinterpret_cast<float4*>(pa)[i] = A;
      if (i - g * hd4 == 0) {
        pm[g] = M;
        pl[g] = L;
      }
    }
  }
}

// The combine kernel's body: block b * KV + h merges row b's live
// partials in split order.  Rows with one live split were written by the
// split kernel.  Launched as the split kernel's programmatic dependent, so
// it waits for that grid's end and its memory before reading a partial.
template <typename TQ>
__device__ __forceinline__ void combine_body(const Args& a) {
  const int bh = blockIdx.x;
  const int b = bh / a.KV;
  const int h = bh - b * a.KV;
  int first, last;
  live_blocks(a.pos[b], a.window, a.ps, a.nblk1, first, last);
  const int s0 = first / a.bps;
  const int s1 = last / a.bps;
  if (s0 == s1) return;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = a.G, hd4 = a.hd / 4;
  const long n = (long)a.B * a.KV * a.splits;
  const float4* pa = reinterpret_cast<const float4*>(a.part) +
                     (long)bh * a.splits * G * hd4;
  const float* pm = a.part + n * G * a.hd + (long)bh * a.splits * G;
  const float* pl = pm + n * G;
  TQ* out = static_cast<TQ*>(a.out) + ((long)b * a.H + h * G) * a.hd;
  for (int i = threadIdx.x; i < G * hd4; i += blockDim.x) {
    const int g = i / hd4;
    // eight splits' partials in flight at a time, merged online in split
    // order
    float M = kNeg, L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = s0; s <= s1; s += 8) {
      float mv[8], lv[8];
      float4 av[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool in = s + u <= s1;
        mv[u] = in ? pm[(s + u) * G + g] : kNeg;
        lv[u] = in ? pl[(s + u) * G + g] : 0.f;
        av[u] = in ? pa[(long)(s + u) * G * hd4 + i]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float Mc = M;
#pragma unroll
      for (int u = 0; u < 8; ++u) Mc = fmaxf(Mc, mv[u]);
      const float r = expf(M - Mc);
      L *= r;
      A = scale4(A, r);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float al = expf(mv[u] - Mc);
        L += al * lv[u];
        A = fma4(al, av[u], A);
      }
      M = Mc;
    }
    store4(out + 4 * i, scale4(A, 1.f / fmaxf(L, 1e-30f)));
  }
}

// Host: fill the shared-memory layout of `a` (rows per unit, stages, row
// stride, copy size) and check the plan.  Returns false on a plan the
// kernels cannot run.
template <typename Pool, int kG>
inline bool layout(Args& a) {
  if (a.splits <= 0 || a.bps <= 0 || a.bps % kWarps != 0) return false;
  a.ppw = a.bps / kWarps;
  if (a.ppw > kMaxPagesPerWarp || (long)(a.splits - 1) * a.bps >= a.nblk1 ||
      (long)a.splits * a.bps < a.nblk1)
    return false;
  const int row = a.hd * Pool::kBytes;
  a.chunk = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : 4;
  a.stride = (row + 15) / 16 * 16 + 16;
  a.rows = a.ps;
  a.upp = 1;
  a.stages = a.ppw < kMaxStages ? a.ppw : kMaxStages;
  const int fixed = q_bytes<kG>(a) + 4 * kWarps * kMaxPage * kG + 16;
  while (a.stages > 1 && stage_bytes(a) + fixed > kStageBudget) --a.stages;
  while (a.rows > 1 && stage_bytes(a) + fixed > kSmemBudget)
    a.rows = (a.rows + 1) / 2;
  a.upp = (a.ps + a.rows - 1) / a.rows;
  a.lg_parts = 0;
  while ((2 << a.lg_parts) * a.rows <= 32) ++a.lg_parts;
  return true;
}

// Host: launch the split kernel and, when the plan has more than one
// split, the combine kernel, on `stream`.
template <typename Pool, int kG>
inline cudaError_t launch(void (*split)(Args), void (*combine)(Args),
                          Args a, cudaStream_t stream) {
  if (!layout<Pool, kG>(a) || (a.splits > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes<kG>(a);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(split),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long blocks = (long)a.B * a.KV * a.splits;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  split<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  // the combine as a programmatic dependent launch: it is scheduled while
  // the split grid runs and waits on griddepcontrol.wait, so the launch
  // gap between the two kernels is hidden
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.KV);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine, a);
}

// Host: the checks and fields both entry points share.
inline bool fill(Args& a, int B, int H, int KV, int hd, int ps, int nblk1,
                 int window, float scale, int splits, int bps) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || hd <= 0 ||
      hd > kMaxHeadDim || hd % 4 != 0 || ps <= 0 || ps > kMaxPage ||
      nblk1 <= 0)
    return false;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hd = hd;
  a.ps = ps;
  a.nblk1 = nblk1;
  a.window = window;
  a.scale = scale;
  a.splits = splits;
  a.bps = bps;
  return true;
}

}  // namespace paged
