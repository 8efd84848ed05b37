// Blockwise causal / sliding-window GQA attention for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, `_kernel`): q (B, Sq, H, hd)
// against k, v (B, Sk, KV, hd), query head h reading kv head h / G
// (G = H / KV).  Key kpos is live for query qpos iff kpos < Sk, and, when
// causal, kpos <= qpos, and, with a window, kpos > qpos - window.
// Positions start at 0 on both sides.  Online softmax in fp32; the output
// has q's dtype.
//
// What bounds it on an H100: the products.  A full-sequence pass does
// 4 * hd flops per live (query head, key) pair, about half of
// 4 * B * H * Sq * Sk * hd when causal, against q, k, v and the output read
// or written once.  At a scoring shape (B = 4, S = 1024, H = 28, KV = 4,
// hd = 128, bf16) that is 30 GFLOP against 67 MB: 0.030 ms at the bf16
// tensor-core rate, 0.020 ms at the HBM rate, so the tensor cores set the
// bound.  In fp32 (the toy models) the CUDA cores' rate does.
//
// What the design does about that:
//   * The TPU grid (B, H, Sq/Qt, Sk/Kt) carries m, l and acc across a
//     sequential k axis.  Here one block per (q tile, kv head, batch row)
//     loops over the k tiles itself, and serves all G query heads of the
//     group: its query rows are (position, head) pairs, qt = 64 / G
//     positions times G heads per 64 rows, so each K/V tile is staged into
//     shared memory once per group, not once per query head.
//   * The loop visits only k tiles that hold a live key for some row of
//     the block: from the first row's window start to the last row's
//     causal end.  A causal pass does about half the products of a full
//     one; the TPU kernel traverses every tile.  Masked entries are -inf
//     before the exponential and so contribute exactly 0, and the running
//     max only moves on live scores: a row whose first visited tile is
//     wholly masked (a window shorter than the tile) keeps m = -1e30,
//     l = 0 and acc = 0 until its first live key, with no garbage to reset.
//   * bf16 at head_dim 64 or 128 (every Qwen2.5-Math layer):
//     flash_hopper_kernel, warp-specialised.  One producer thread loads Q
//     once (a 4-d tensor map over (hd, H, Sq, B) whose box of (64, G, qt,
//     1) lands the rows in (position, head) order) and keeps a ring of 3
//     K/V stages of 128 keys full through TMA, with full and empty
//     mbarriers; out-of-range rows and keys arrive as zeros, so the ragged
//     Sq / Sk edges need no padding in memory.  Two consumer warpgroups
//     own 64 rows each (2 qt positions a block) and compute S = Q K^T with
//     wgmma m64n128k16 from shared memory, the online softmax in registers
//     on the accumulator layout, and O += P V with P as the bf16 register
//     A operand and V as the MN-major shared-memory B operand (no
//     transposed staging).  The warpgroups take turns at the tensor cores
//     (named barriers), so one's softmax runs under the other's products.
//     Only tiles that cross the causal diagonal, the window's lower edge
//     or Sk are masked, by one compact loop over per-row key bounds.  Q
//     tiles are handed out longest first, so the last wave holds short
//     ones.  The output is staged in the warpgroup's Q panels and stored
//     as whole rows.
//   * bf16 at head_dim 256 (gemma3-1b, recurrentgemma-9b):
//     flash_hopper256_kernel.  Its 64 x 256 fp32 O accumulator takes 128
//     registers a thread, more than a 384-thread block leaves a consumer
//     (ptxas allocates every thread of a block by its launch bounds, 168),
//     so the block is the two consumer warpgroups alone and warp 0 also
//     issues the loads: Q once, then K/V tiles of 64 keys through a ring of
//     2 stages (Q 64 KB + 2 x 64 KB of K/V; 128-key tiles in 3 stages would
//     need 448 KB).  Each warpgroup runs its own loop, S = Q K^T with wgmma
//     m64n64k16, the same online softmax and masks, O += P V as two
//     m64n128k16 halves of the 256 dims; no named-barrier pingpong.
//   * Other bf16 head dims (16 and 40 in the toy configs): QK^T and P.V on
//     the tensor cores with mma.sync m16n8k16 (fp32 accumulate); each warp
//     owns 16 query rows, keeps its 16 x 64 score tile and its 16 x hd
//     output in registers, V staged transposed; head_dim zero-padded to a
//     multiple of 16 in shared memory (40 -> 48).  Its register tiles, and
//     the fp32 kernel's, are sized for head_dim 128 or, above it, 256.
//   * fp32: CUDA cores, each thread a 4 x 8 register tile of the scores
//     and a 4 x hd/8 tile of the output.
//   * The ragged Sq / Sk edges of the last two are masked in the kernel:
//     rows past Sq are computed on zeros and never written, keys past Sk
//     are staged as zeros and masked.  Nothing is padded in device memory.
//   * Given a non-null `lse` (flash_attention_hopper_fwd only), the
//     epilogue also writes each row's log-sum-exp, fp32 (B, H, Sq), in
//     base 2: lse2 = m + log2(l) of the scores scaled by scale * log2(e),
//     i.e. the natural log-sum-exp of the scaled scores times log2(e).
//     The backward (flash_attention_bwd_hopper.cu) rebuilds P as
//     exp2(s * scale * log2(e) - lse2) from it.  Serving and scoring pass
//     null: the output's arithmetic is the same either way.
// Not yet: a persistent grid (each block pays its own Q load and output
// store outside the product loop), the softmax of one tile overlapped
// with the next tile's QK^T inside a warpgroup.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;            // (position, head) query rows per block
constexpr int kKeys = 64;            // keys per k tile
constexpr int kMaxHeadDim = 256;
constexpr int kPadBf16 = 8;          // bf16 elements of padding per row
constexpr float kNeg = -1e30f;       // the reference's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, H, KV, hd, G, qt, causal, window;
  float scale;
};

// live range [lo, hi] of keys for query position pos
__device__ __forceinline__ int key_lo(const Args& a, int pos) {
  return a.window > 0 ? max(0, pos - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const Args& a, int pos) {
  return a.causal ? min(pos, a.Sk - 1) : a.Sk - 1;
}
__device__ __forceinline__ bool live(const Args& a, int pos, int key) {
  return key < a.Sk && (!a.causal || key <= pos) &&
         (a.window == 0 || key > pos - a.window);
}

// Offset (elements) of query row r = i * G + g of this block: position
// q0 + i, head h * G + g.  The G heads of one position are contiguous.
__device__ __forceinline__ long q_row(const Args& a, int b, int h, int q0,
                                      int r) {
  const int i = r / a.G, g = r - (r / a.G) * a.G;
  return (((long)b * a.Sq + q0 + i) * a.H + (long)h * a.G + g) * a.hd;
}
__device__ __forceinline__ long kv_row(const Args& a, int b, int h,
                                       int key) {
  return (((long)b * a.Sk + key) * a.KV + h) * a.hd;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int kMaxHd>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int hdp = (a.hd + 15) / 16 * 16;     // head_dim padded for the MMA k
  const int qk_ld = hdp + kPadBf16;          // row stride of q_s and k_s
  const int vt_ld = kKeys + kPadBf16;        // row stride of vt_s
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kRows * qk_ld;  // [key][dim]
  __nv_bfloat16* vt_s = k_s + kKeys * qk_ld; // [dim][key]
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * a.qt;
  const int qlast = min(q0 + a.qt, a.Sq) - 1;
  const int nrows = (qlast - q0 + 1) * a.G;
  const int tid = threadIdx.x;

  // Q rows, zero past nrows and past hd (16-byte chunks: hd % 8 == 0)
  const int cpr = hdp / 8;
  for (int c = tid; c < kRows * cpr; c += kThreads) {
    const int r = c / cpr, j = (c - r * cpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nrows && j < a.hd)
      val = *reinterpret_cast<const uint4*>(q + q_row(a, b, h, q0, r) + j);
    *reinterpret_cast<uint4*>(q_s + r * qk_ld + j) = val;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tg = lane & 3;   // mma group and thread-in-group
  const int r0 = warp * 16 + gq, r1 = r0 + 8;
  const int pos0 = q0 + r0 / a.G, pos1 = q0 + r1 / a.G;
  const int ndt = a.hd / 8;                  // output n-tiles of 8 dims
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[kMaxHd / 8][4];
#pragma unroll
  for (int t = 0; t < kMaxHd / 8; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  const int first = key_lo(a, q0) / kKeys;
  const int last = key_hi(a, qlast) / kKeys;
  for (int tile = first; tile <= last; ++tile) {
    const int kb = tile * kKeys;
    __syncthreads();                         // previous tile fully read
    for (int c = tid; c < kKeys * cpr; c += kThreads) {
      const int n = c / cpr, j = (c - n * cpr) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kb + n < a.Sk && j < a.hd)
        val = *reinterpret_cast<const uint4*>(k + kv_row(a, b, h, kb + n) + j);
      *reinterpret_cast<uint4*>(k_s + n * qk_ld + j) = val;
    }
    // V transposed: neighbouring threads take neighbouring keys, so the
    // 2-byte shared stores of one dim land side by side
    for (int c = tid; c < kKeys * ndt; c += kThreads) {
      const int n = c % kKeys, j = (c / kKeys) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kb + n < a.Sk)
        val = *reinterpret_cast<const uint4*>(v + kv_row(a, b, h, kb + n) + j);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int t = 0; t < 8; ++t) vt_s[(j + t) * vt_ld + n] = e[t];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int ks = 0; ks < hdp; ks += 16) {
      const __nv_bfloat16* qa = q_s + ks + tg * 2;
      const uint32_t a0 = ld32(qa + r0 * qk_ld), a1 = ld32(qa + r1 * qk_ld);
      const uint32_t a2 = ld32(qa + r0 * qk_ld + 8);
      const uint32_t a3 = ld32(qa + r1 * qk_ld + 8);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const __nv_bfloat16* kr = k_s + (nt * 8 + gq) * qk_ld + ks + tg * 2;
        mma_bf16(s[nt], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // mask and scale; online softmax over the quad that shares a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + tg * 2 + (e & 1);
        const bool lv = live(a, e < 2 ? pos0 : pos1, key);
        s[nt][e] = lv ? s[nt][e] * a.scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int t = 0; t < kMaxHd / 8; ++t) {
      o[t][0] *= al0;
      o[t][1] *= al0;
      o[t][2] *= al1;
      o[t][3] *= al1;
    }

    // O += P V: the score accumulators of n-tiles 2c, 2c+1 are the A
    // fragment of key chunk c
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int t = 0; t < kMaxHd / 8; ++t) {
        if (t < ndt) {
          const __nv_bfloat16* vr =
              vt_s + (t * 8 + gq) * vt_ld + kc * 16 + tg * 2;
          mma_bf16(o[t], a0, a1, a2, a3, ld32(vr), ld32(vr + 8));
        }
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int t = 0; t < kMaxHd / 8; ++t) {
    if (t < ndt) {
      const int d = t * 8 + tg * 2;
      if (r0 < nrows)
        *reinterpret_cast<__nv_bfloat162*>(out + q_row(a, b, h, q0, r0) + d) =
            __floats2bfloat162_rn(o[t][0] * inv0, o[t][1] * inv0);
      if (r1 < nrows)
        *reinterpret_cast<__nv_bfloat162*>(out + q_row(a, b, h, q0, r1) + d) =
            __floats2bfloat162_rn(o[t][2] * inv1, o[t][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

template <int kMaxHd>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int ld = a.hd + 1;                   // odd stride: no bank conflicts
  const int sld = kKeys + 1;
  float* q_s = reinterpret_cast<float*>(smem);    // [kRows][ld]
  float* k_s = q_s + kRows * ld;                  // [kKeys][ld]
  float* v_s = k_s + kKeys * ld;                  // [kKeys][hd]
  float* p_s = v_s + kKeys * a.hd;                // [kRows][sld]
  float* al_s = p_s + kRows * sld;                // [kRows] rescale factor
  float* l_s = al_s + kRows;                      // [kRows] denominators
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * a.qt;
  const int qlast = min(q0 + a.qt, a.Sq) - 1;
  const int nrows = (qlast - q0 + 1) * a.G;
  const int tid = threadIdx.x;
  const int c4 = a.hd / 4;                   // float4 chunks per row

  for (int c = tid; c < kRows * c4; c += kThreads) {
    const int r = c / c4, j = (c - r * c4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows)
      val = *reinterpret_cast<const float4*>(q + q_row(a, b, h, q0, r) + j);
    float* dst = q_s + r * ld + j;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }

  // scores: rows tr*4 .. tr*4+3, keys tc + 8j; output: the same rows,
  // dims tc + 8j
  const int tr = tid / 8, tc = tid % 8;
  const int ndim = a.hd / 8;
  // softmax: two threads per row, 32 keys each
  const int srow = tid / 2, shalf = tid & 1;
  float m_run = kNeg, l_run = 0.f;           // kept by the softmax threads
  float o[4][kMaxHd / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHd / 8; ++j) o[i][j] = 0.f;

  const int first = key_lo(a, q0) / kKeys;
  const int last = key_hi(a, qlast) / kKeys;
  for (int tile = first; tile <= last; ++tile) {
    const int kb = tile * kKeys;
    __syncthreads();
    for (int c = tid; c < kKeys * c4; c += kThreads) {
      const int n = c / c4, j = (c - n * c4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kb + n < a.Sk) {
        const long off = kv_row(a, b, h, kb + n) + j;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      float* kd = k_s + n * ld + j;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<float4*>(v_s + n * a.hd + j) = vv;
    }
    __syncthreads();

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < a.hd; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(tr * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = k_s[(tc + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr * 4 + i;
      const int pos = q0 + row / a.G;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kb + tc + 8 * j;
        p_s[row * sld + tc + 8 * j] =
            live(a, pos, key) ? acc[i][j] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one row per pair of threads
    {
      float* prow = p_s + srow * sld + shalf * 32;
      float mx = -INFINITY;
      for (int j = 0; j < 32; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float mn = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int j = 0; j < 32; ++j) {
        const float e = expf(prow[j] - mn);
        prow[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_run - mn);
      l_run = l_run * alpha + sum;
      m_run = mn;
      if (shalf == 0) al_s[srow] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = al_s[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < kMaxHd / 8; ++j) o[i][j] *= al;
    }
    for (int key = 0; key < kKeys; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(tr * 4 + i) * sld + key];
#pragma unroll
      for (int j = 0; j < kMaxHd / 8; ++j) {
        if (j < ndim) {
          const float vv = v_s[key * a.hd + tc + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
        }
      }
    }
  }

  if (shalf == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr * 4 + i;
    if (row < nrows) {
      const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
      float* dst = out + q_row(a, b, h, q0, row);
#pragma unroll
      for (int j = 0; j < kMaxHd / 8; ++j)
        if (j < ndim) dst[tc + 8 * j] = o[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, head_dim 64, 128 and 256: TMA, mbarrier ring, wgmma
// ---------------------------------------------------------------------------

constexpr int kHKeys = 128;          // keys per k tile (head_dim 64, 128)
constexpr int kHStages = 3;          // K/V ring depth (head_dim 64, 128)
constexpr int kTurn = 1;             // named barriers 1, 2: whose turn
constexpr int kStaged = 3;           // named barriers 3, 4: output staged
constexpr int kHThreads = 384;       // 2 consumer warpgroups + 1 producer
constexpr int kHConsumers = 256;
// head_dim 256: a 64 x 256 fp32 O accumulator is 128 registers a thread,
// so the block is the two consumer warpgroups alone (256 threads, up to 255
// registers each; a producer warpgroup would cap every thread at 168) and
// warp 0 also loads.  64-key tiles in a ring of 2 keep Q (64 KB) and the
// ring (2 x 64 KB) within the 227 KB a block may use.
constexpr int kWKeys = 64;
constexpr int kWStages = 2;
constexpr int kWThreads = 256;

struct HArgs {
  void* out;
  float* lse;                        // (B, H, Sq) log2-sum-exp, or null
  int Sq, Sk, H, G, qt, causal, window;
  float scale_log2;                  // softmax scale * log2(e)
};

// Shared-memory plan of one block, all offsets from a 1024-aligned base:
// Q [2 warpgroups][HD/64 panels][64 rows][128 B], then the ring of K and
// V tiles [stage][HD/64 panels][KEYS rows][128 B], then the mbarriers.
template <int HD, int KEYS, int STAGES>
struct HPlan {
  static constexpr int kPanels = HD / 64;
  static constexpr int kQPanel = 64 * 128;
  static constexpr int kKVPanel = KEYS * 128;
  static constexpr int kQBytes = 2 * kPanels * kQPanel;
  static constexpr int kKVStage = kPanels * kKVPanel;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + STAGES * kKVStage;
  static constexpr int kBars = kV + STAGES * kKVStage;
  static constexpr int kSmem = kBars + (1 + 3 * STAGES) * 8 + 1024;
};

// The online softmax of one tile of KEYS keys (first key kb) for a
// consumer thread's rows r0 and r1 of its warpgroup (positions pw0 .. pw1):
// sc holds S = Q K^T on the wgmma accumulator layout.  Scores go to the
// log2 domain, masked only where the tile crosses the causal diagonal,
// the window's lower edge or Sk, by one compact loop over per-row key
// bounds (key live iff lo < key <= hi): a per-element branch around
// per-element bounds made the unmasked path jump over the masked code 64
// times a tile, which cost more in instruction fetch than both products
// together.  Updates m and l, rescales O and leaves P in pa as PV's bf16
// A operand.
template <int KEYS, int HD>
__device__ __forceinline__ void online_softmax(
    const HArgs& a, int kb, int pw0, int pw1, int r0, int r1, int tq,
    float* sc, uint32_t* pa, float* o, float& m0, float& m1, float& l0,
    float& l1) {
  const bool edge = (a.causal && kb + KEYS - 1 > pw0) || kb + KEYS > a.Sk ||
                    (a.window > 0 && kb <= pw1 - a.window);
  if (edge) {
    const int p0 = pw0 + r0 / a.G, p1 = pw0 + r1 / a.G;
    const int hi0 = a.causal ? min(p0, a.Sk - 1) : a.Sk - 1;
    const int hi1 = a.causal ? min(p1, a.Sk - 1) : a.Sk - 1;
    const int lo0 = a.window > 0 ? p0 - a.window : -1;
    const int lo1 = a.window > 0 ? p1 - a.window : -1;
    const int k0 = kb + 2 * tq;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + (e & 1);
        const bool lv = e < 2 ? (key > lo0 && key <= hi0)
                              : (key > lo1 && key <= hi1);
        sc[4 * j + e] = lv ? sc[4 * j + e] * a.scale_log2 : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) sc[i] *= a.scale_log2;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // a row with no live key yet keeps m = -1e30: its scores are -inf, so
  // exp2 gives exactly 0 and alpha is 1
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float al0 = hopper::exp2_approx(m0 - mn0);
  const float al1 = hopper::exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    const float p0 = hopper::exp2_approx(sc[4 * j] - mn0);
    const float p1 = hopper::exp2_approx(sc[4 * j + 1] - mn0);
    const float p2 = hopper::exp2_approx(sc[4 * j + 2] - mn1);
    const float p3 = hopper::exp2_approx(sc[4 * j + 3] - mn1);
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    // n-tile j holds keys 8j..8j+7: a0/a1 of step j/2 if j is even, a2/a3
    // if odd
    pa[4 * (j / 2) + 2 * (j % 2)] = hopper::pack_bf16(p0, p1);
    pa[4 * (j / 2) + 2 * (j % 2) + 1] = hopper::pack_bf16(p2, p3);
  }
  l0 = l0 * al0 + sum0;              // this thread's columns; quad-summed
  l1 = l1 * al1 + sum1;              // at the end
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= al0;
    o[4 * j + 1] *= al0;
    o[4 * j + 2] *= al1;
    o[4 * j + 3] *= al1;
  }
}

// A consumer thread's part of its warpgroup's epilogue, after the
// warpgroup's last product: l summed over the quad, the log-sum-exp if
// asked for, and the normalized bf16 output tile staged in the
// warpgroup's Q panels (qw; 16-byte chunks XOR-swizzled by row so the
// quad's 4-byte writes do not conflict), then stored as whole rows.
template <int HD>
__device__ __forceinline__ void store_output(
    const HArgs& a, const float* o, float m0, float m1, float l0, float l1,
    char* qw, int r0, int r1, int tq, int pw0, int rows, int b, int h,
    int wg, int tid) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (a.lse != nullptr && tq == 0) {
    // m is the row's max in the log2 domain, l its sum of exp2(s - m)
    const int p0 = pw0 + r0 / a.G, p1 = pw0 + r1 / a.G;
    const long hb = (long)b * a.H + (long)h * a.G;
    if (r0 < rows && p0 < a.Sq)
      a.lse[(hb + r0 % a.G) * a.Sq + p0] = m0 + log2f(l0);
    if (r1 < rows && p1 < a.Sq)
      a.lse[(hb + r1 % a.G) * a.Sq + p1] = m1 + log2f(l1);
  }
  constexpr int kRowBytes = HD * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = (j ^ (r0 & 7)) * 16 + 4 * tq;   // r1 & 7 == r0 & 7
    *reinterpret_cast<uint32_t*>(qw + r0 * kRowBytes + c) =
        hopper::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(qw + r1 * kRowBytes + c) =
        hopper::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  hopper::named_sync(kStaged + wg, 128);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  constexpr int kChunks = HD / 8;
  for (int i = tid % 128; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int pos = pw0 + r / a.G, g = r - (r / a.G) * a.G;
    if (r < rows && pos < a.Sq)
      *reinterpret_cast<uint4*>(
          out + (((long)b * a.Sq + pos) * a.H + (long)h * a.G + g) * HD +
          c * 8) = *reinterpret_cast<const uint4*>(
          qw + r * kRowBytes + ((c ^ (r & 7)) * 16));
  }
}

// Rows past G * qt of each Q panel (1 of 64 at G = 7, 4 at G = 6) are
// never written by TMA: zero them so the unused rows compute on zeros.
__device__ __forceinline__ void zero_q_pad(char* q_s, int panels, int rows,
                                           int tid, int nthreads) {
  const int pad = (64 - rows) * 8;   // 16-byte chunks per panel
  for (int i = tid; i < panels * pad; i += nthreads) {
    const int panel = i / pad, c = i - panel * pad;
    *reinterpret_cast<uint4*>(q_s + panel * 64 * 128 + rows * 128 + c * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kHThreads, 1)
flash_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, HArgs a) {
  using P = HPlan<HD, kHKeys, kHStages>;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  char* q_s = base;
  char* k_s = base + P::kK;
  char* v_s = base + P::kV;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + kHStages;
  uint64_t* empty = full_v + kHStages;

  // q tiles longest first: causal rows late in the sequence see the most
  // keys, so they go in the first wave and short tiles fill the last
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qtile * 2 * a.qt;
  const int qlast = min(q0 + 2 * a.qt, a.Sq) - 1;
  const int first =
      (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / kHKeys;
  const int last = (a.causal ? min(qlast, a.Sk - 1) : a.Sk - 1) / kHKeys;
  const int rows = a.G * a.qt;       // rows TMA writes per warpgroup panel
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kHStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], kHConsumers);
    }
  }
  zero_q_pad(q_s, 2 * P::kPanels, rows, tid, kHThreads);
  hopper::fence_proxy_async();
  hopper::fence_barrier_init();
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      hopper::mbar_expect_tx(q_bar, 2 * P::kPanels * rows * 128);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < P::kPanels; ++p)
          hopper::tma_load_4d(q_s + (w * P::kPanels + p) * P::kQPanel, &qmap,
                              q_bar, 64 * p, h * a.G, q0 + w * a.qt, b);
      for (int tile = first, it = 0; tile <= last; ++tile, ++it) {
        const int s = it % kHStages, ph = (it / kHStages) & 1;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&full_k[s], P::kKVStage);
        for (int p = 0; p < P::kPanels; ++p)
          hopper::tma_load_4d(k_s + s * P::kKVStage + p * P::kKVPanel, &kmap,
                              &full_k[s], 64 * p, h, tile * kHKeys, b);
        hopper::mbar_expect_tx(&full_v[s], P::kKVStage);
        for (int p = 0; p < P::kPanels; ++p)
          hopper::tma_load_4d(v_s + s * P::kKVStage + p * P::kKVPanel, &vmap,
                              &full_v[s], 64 * p, h, tile * kHKeys, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows (positions q0 + wg * qt ...) --
    hopper::setmaxnreg_inc<240>();
    const int w = (tid % 128) / 32, lane = tid % 32;
    const int gq = lane >> 2, tq = lane & 3;
    const int r0 = 16 * w + gq, r1 = r0 + 8;     // this thread's two rows
    const int pw0 = q0 + wg * a.qt;              // warpgroup's positions
    const int pw1 = min(pw0 + a.qt, a.Sq) - 1;
    char* qw = q_s + wg * P::kPanels * P::kQPanel;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    float sc[kHKeys / 2];            // S of a tile, then its probabilities
    uint32_t pa[kHKeys / 4];         // P as PV's A operand, 16 keys a step
    hopper::mbar_wait(q_bar, 0);

    // S(it) = Q K^T (64 rows x 128 keys, K-major A and B), issued
    auto issue_s = [&](int it) {
      const int s = it % kHStages;
      char* ks = k_s + s * P::kKVStage;
      hopper::mbar_wait(&full_k[s], (it / kHStages) & 1);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n128<0>(
            sc, hopper::desc_sw128(qw + p * P::kQPanel + off, 16, 1024),
            hopper::desc_sw128(ks + p * P::kKVPanel + off, 16, 1024),
            kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P(it) V(it) (V [key][dim] is the MN-major B operand), run to
    // completion; then the tile's stage goes back to the producer
    auto run_pv = [&](int it) {
      const int s = it % kHStages;
      char* vs = v_s + s * P::kKVStage;
      hopper::mbar_wait(&full_v[s], (it / kHStages) & 1);
#pragma unroll
      for (int kc = 0; kc < kHKeys / 16; ++kc) {
        const uint64_t dv =
            hopper::desc_sw128(vs + kc * 16 * 128, P::kKVPanel, 1024);
        if constexpr (HD == 128)
          hopper::wgmma_rs_n128<1>(o, pa + 4 * kc, dv, 1);
        else
          hopper::wgmma_rs_n64<1>(o, pa + 4 * kc, dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<HD / 2>(o);
      hopper::fence_operands<kHKeys / 4>(pa);
      hopper::mbar_arrive(&empty[s]);
    };
    // the online softmax of tile it: waits for S(it), rescales O (whose
    // last product has completed) and leaves P(it) in pa
    auto softmax = [&](int it) {
      hopper::wgmma_wait<0>();
      hopper::fence_operands<kHKeys / 2>(sc);
      online_softmax<kHKeys, HD>(a, (first + it) * kHKeys, pw0, pw1, r0, r1,
                                 tq, sc, pa, o, m0, m1, l0, l1);
    };

    // Pingpong: the warpgroups take turns at the tensor cores (named
    // barriers kTurn + wg).  In its turn a warpgroup runs O += P V of the
    // previous tile and issues S of the next, then hands the turn over and
    // runs that tile's softmax while the other warpgroup's products run.
    // Warpgroup 1 hands the first turn to warpgroup 0; warpgroup 0 takes
    // the turn warpgroup 1 hands back after its last.  The first and last
    // turns are peeled, so no product is issued under a condition.
    const int nt = last - first + 1;
    if (wg == 1) hopper::named_arrive(kTurn, 256);
    hopper::named_sync(kTurn + wg, 256);
    hopper::wgmma_fence();
    issue_s(0);
    hopper::named_arrive(kTurn + 1 - wg, 256);
    softmax(0);
    for (int it = 1; it < nt; ++it) {
      hopper::named_sync(kTurn + wg, 256);
      hopper::wgmma_fence();
      run_pv(it - 1);
      issue_s(it);
      hopper::named_arrive(kTurn + 1 - wg, 256);
      softmax(it);
    }
    hopper::named_sync(kTurn + wg, 256);
    hopper::wgmma_fence();
    run_pv(nt - 1);
    hopper::named_arrive(kTurn + 1 - wg, 256);
    if (wg == 0) hopper::named_sync(kTurn, 256);

    store_output<HD>(a, o, m0, m1, l0, l1, qw, r0, r1, tq, pw0, rows, b, h,
                     wg, tid);
  }
}

// head_dim 256: two consumer warpgroups and no producer warpgroup (see
// kWThreads).  Warp 0 loads: lane 0 issues every TMA load, and the warp
// waits until both warpgroups have released a stage before it refills it,
// one tile ahead of the products.  Each warpgroup runs its own loop
// (S = Q K^T with wgmma m64n64k16, the online softmax, O += P V as two
// m64n128k16 halves of the 256 dims), so the warp schedulers, not named
// barriers, interleave one warpgroup's softmax with the other's products.
__global__ void __launch_bounds__(kWThreads, 1)
flash_hopper256_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, HArgs a) {
  constexpr int HD = 256;
  using P = HPlan<HD, kWKeys, kWStages>;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  char* q_s = base;
  char* k_s = base + P::kK;
  char* v_s = base + P::kV;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + kWStages;
  uint64_t* empty = full_v + kWStages;

  const int qtile = gridDim.x - 1 - blockIdx.x;    // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qtile * 2 * a.qt;
  const int qlast = min(q0 + 2 * a.qt, a.Sq) - 1;
  const int first =
      (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / kWKeys;
  const int last = (a.causal ? min(qlast, a.Sk - 1) : a.Sk - 1) / kWKeys;
  const int nt = last - first + 1;
  const int rows = a.G * a.qt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], kWThreads);
    }
  }
  zero_q_pad(q_s, 2 * P::kPanels, rows, tid, kWThreads);
  hopper::fence_proxy_async();
  hopper::fence_barrier_init();
  __syncthreads();

  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const bool loader = tid < 32;
  // tile it into stage it % kWStages, once both warpgroups released it
  auto load = [&](int it) {
    const int s = it % kWStages, ph = (it / kWStages) & 1;
    hopper::mbar_wait(&empty[s], ph ^ 1);
    if (lane == 0) {
      const int key0 = (first + it) * kWKeys;
      hopper::mbar_expect_tx(&full_k[s], P::kKVStage);
      for (int p = 0; p < P::kPanels; ++p)
        hopper::tma_load_4d(k_s + s * P::kKVStage + p * P::kKVPanel, &kmap,
                            &full_k[s], 64 * p, h, key0, b);
      hopper::mbar_expect_tx(&full_v[s], P::kKVStage);
      for (int p = 0; p < P::kPanels; ++p)
        hopper::tma_load_4d(v_s + s * P::kKVStage + p * P::kKVPanel, &vmap,
                            &full_v[s], 64 * p, h, key0, b);
    }
  };
  if (loader) {
    if (lane == 0) {
      hopper::mbar_expect_tx(q_bar, 2 * P::kPanels * rows * 128);
      for (int g = 0; g < 2; ++g)
        for (int p = 0; p < P::kPanels; ++p)
          hopper::tma_load_4d(q_s + (g * P::kPanels + p) * P::kQPanel, &qmap,
                              q_bar, 64 * p, h * a.G, q0 + g * a.qt, b);
    }
    for (int it = 0; it < kWStages - 1 && it < nt; ++it) load(it);
  }

  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w + gq, r1 = r0 + 8;       // this thread's two rows
  const int pw0 = q0 + wg * a.qt;                // warpgroup's positions
  const int pw1 = min(pw0 + a.qt, a.Sq) - 1;
  char* qw = q_s + wg * P::kPanels * P::kQPanel;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float sc[kWKeys / 2];
  uint32_t pa[kWKeys / 4];
  hopper::mbar_wait(q_bar, 0);

  for (int it = 0; it < nt; ++it) {
    if (loader && it + kWStages - 1 < nt) load(it + kWStages - 1);
    const int s = it % kWStages, ph = (it / kWStages) & 1;
    char* ks = k_s + s * P::kKVStage;
    char* vs = v_s + s * P::kKVStage;
    hopper::mbar_wait(&full_k[s], ph);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          sc, hopper::desc_sw128(qw + p * P::kQPanel + off, 16, 1024),
          hopper::desc_sw128(ks + p * P::kKVPanel + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands<kWKeys / 2>(sc);
    online_softmax<kWKeys, HD>(a, (first + it) * kWKeys, pw0, pw1, r0, r1,
                               tq, sc, pa, o, m0, m1, l0, l1);
    hopper::mbar_wait(&full_v[s], ph);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kWKeys / 16; ++kc) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        hopper::wgmma_rs_n128<1>(
            o + 64 * half, pa + 4 * kc,
            hopper::desc_sw128(vs + 2 * half * P::kKVPanel + kc * 16 * 128,
                               P::kKVPanel, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands<HD / 2>(o);
    hopper::fence_operands<kWKeys / 4>(pa);
    hopper::mbar_arrive(&empty[s]);
  }

  store_output<HD>(a, o, m0, m1, l0, l1, qw, r0, r1, tq, pw0, rows, b, h,
                   wg, tid);
}

template <int HD>
cudaError_t launch_hopper(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Sk,
                          int H, int KV, int causal, int window, float scale,
                          cudaStream_t stream) {
  constexpr bool kWide = HD == 256;
  constexpr int kKeys_ = kWide ? kWKeys : kHKeys;
  using P = HPlan<HD, kKeys_, kWide ? kWStages : kHStages>;
  HArgs a;
  a.out = out;
  a.lse = lse;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.G = H / KV;
  a.qt = kRows / a.G;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * 1.4426950408889634f;
  // q as (hd, H, Sq, B): a box of (64 dims, G heads, qt positions) lands
  // as 64-element rows in (position, head) order; k, v as (hd, KV, Sk, B)
  const uint64_t e = 2;
  const uint64_t qd[4] = {(uint64_t)HD, (uint64_t)H, (uint64_t)Sq,
                          (uint64_t)B};
  const uint64_t qs[3] = {HD * e, (uint64_t)H * HD * e,
                          (uint64_t)Sq * H * HD * e};
  const uint32_t qb[4] = {64, (uint32_t)a.G, (uint32_t)a.qt, 1};
  const uint64_t kd[4] = {(uint64_t)HD, (uint64_t)KV, (uint64_t)Sk,
                          (uint64_t)B};
  const uint64_t ksd[3] = {HD * e, (uint64_t)KV * HD * e,
                           (uint64_t)Sk * KV * HD * e};
  const uint32_t kbx[4] = {64, 1, kKeys_, 1};
  CUtensorMap qm, km, vm;
  cudaError_t err = hopper::make_tensor_map(&qm, 4, q, qd, qs, qb);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map(&km, 4, k, kd, ksd, kbx);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map(&vm, 4, v, kd, ksd, kbx);
  if (err != cudaSuccess) return err;
  const auto kernel = [] {
    if constexpr (kWide)
      return &flash_hopper256_kernel;
    else
      return &flash_hopper_kernel<HD>;
  }();
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 2 * a.qt - 1) / (2 * a.qt), KV, B);
  kernel<<<grid, kWide ? kWThreads : kHThreads, P::kSmem, stream>>>(qm, km,
                                                                    vm, a);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int B, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + a.qt - 1) / a.qt, a.KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out: (B, Sq, H, hd); k, v:
// (B, Sk, KV, hd); all contiguous and 16-byte aligned; H / KV <= 64;
// head_dim a multiple of 8, at most 256 (the register tiles are sized for
// 128 or 256, the smaller that holds head_dim).  Every query row must hold
// at least one live key (the wrapper checks).  Returns the cudaError_t of
// the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kRows || hd <= 0 || hd > kMaxHeadDim || hd % 8 != 0 ||
      window < 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.G = H / KV;
  a.qt = kRows / a.G;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const size_t hdp = (hd + 15) / 16 * 16;
    const size_t smem = sizeof(__nv_bfloat16) *
        ((size_t)(kRows + kKeys) * (hdp + kPadBf16) +
         (size_t)hd * (kKeys + kPadBf16));
    return (int)(hd <= 128 ? launch(flash_bf16_kernel<128>, a, B, smem, s)
                           : launch(flash_bf16_kernel<256>, a, B, smem, s));
  }
  if (dtype == 0) {
    const size_t smem = sizeof(float) *
        ((size_t)(kRows + kKeys) * (hd + 1) + (size_t)kKeys * hd +
         (size_t)kRows * (kKeys + 1) + 2 * (size_t)kRows);
    return (int)(hd <= 128 ? launch(flash_f32_kernel<128>, a, B, smem, s)
                           : launch(flash_f32_kernel<256>, a, B, smem, s));
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 q, k, v with head_dim 64, 128 or 256 through the TMA/wgmma
// kernels; the rest of the contract as flash_attention_fwd.  `lse`, if not
// null, is a float32 (B, H, Sq) buffer that receives each row's
// log-sum-exp in base 2 (the natural one times log2(e)).  Returns the
// cudaError_t of building the tensor maps and of the launch (0 = success).
extern "C" int flash_attention_hopper_fwd(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B, int Sq, int Sk,
                                          int H, int KV, int hd, int causal,
                                          int window, float scale,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kRows || window < 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 256)
    return (int)launch_hopper<256>(q, k, v, out, l, B, Sq, Sk, H, KV, causal,
                                   window, scale, s);
  if (hd == 128)
    return (int)launch_hopper<128>(q, k, v, out, l, B, Sq, Sk, H, KV, causal,
                                   window, scale, s);
  if (hd == 64)
    return (int)launch_hopper<64>(q, k, v, out, l, B, Sq, Sk, H, KV, causal,
                                  window, scale, s);
  return (int)cudaErrorInvalidValue;
}
