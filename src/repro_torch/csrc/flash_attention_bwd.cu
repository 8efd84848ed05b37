// Backward of blockwise causal / sliding-window GQA attention for Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel: `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) is forward-only, and the reference
// trains through its XLA einsum attention, which XLA differentiates.  The
// port sends every CUDA tensor to a kernel, so a train step on the card
// needs this one.  It computes the gradients of `flash_attention_plain`
// (src/repro_torch/kernels/flash_attention.py) with respect to q
// (B, Sq, H, hd), k and v (B, Sk, KV, hd), given the forward's output and
// its gradient dO: query head h reads kv head h / G (G = H / KV); key kpos
// is live for query qpos iff kpos < Sk and, when causal, kpos <= qpos, and,
// with a window, kpos > qpos - window.
//
// With P = softmax(scale * Q K^T) (masked), O = P V:
//   lse = logsumexp of the masked scaled scores of a row, D = rowsum(dO * O),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the G query heads that read one kv head.
//
// What bounds it on an H100: both the products and the bytes, about
// equally.  Five products of 2 * hd flops per live (query head, key) pair,
// 2.5 times the forward's count, against q, k, v, O and dO read once and
// dq, dk, dv written once: at the target's training shape (B = 4,
// S = 512, H = 28, KV = 4, hd = 128, bf16, causal) 18.8 GFLOP, 0.019 ms at
// the bf16 tensor-core rate, against 67.1 MB, 0.020 ms at the HBM rate.
//
// Design (simple and exact first; no atomics, so two calls are bitwise
// equal).  Three kernels, 128 threads, each warp owning 16 rows:
//   (a) stats: one block per (64 query positions, head, batch row) stages
//       Q once, sweeps the live key tiles for the rows' running max and
//       sum (an online log-sum-exp, fp32), and computes D from dO and O.
//       The forward's three kernels are left as they are: they do not emit
//       the log-sum-exp, so it is recomputed here.
//   (b) dK, dV: one block per (64 keys, kv head, batch row) keeps K and V
//       in shared memory and dK, dV in registers, and loops over the G
//       query heads of the group and the live 32-query tiles of each:
//       S^T = K Q^T, P^T from the log-sum-exp, dV += P^T dO,
//       dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
//   (c) dQ: one block per (64 query positions, head, batch row) keeps Q,
//       dO and dQ, and loops over the live 64-key tiles: S = Q K^T, P,
//       dP = dO V^T, dS, dQ += dS K.
//   The loops visit only tiles that hold a live pair for some row (from
//   the window's lower edge to the causal diagonal); masked pairs get
//   P = 0 exactly, never exp(-1e30 - lse).  Every product is a 16 x 8 x 16
//   tile from shared memory in the mma.sync accumulator layout: bf16 on
//   the tensor cores (mma.sync m16n8k16, fp32 accumulate), fp32 on the
//   CUDA cores with the same fragment layout.  P and dS go through a
//   per-warp shared tile in the input dtype, so in bf16 they are rounded
//   to bf16 before their products (the plain version keeps them fp32).
//   Operands a product reads with the other dimension contiguous (K for
//   dQ, Q and dO for dK and dV) are staged a second time transposed.
//   Rows past Sq or Sk are staged as zeros and never written; head_dim is
//   zero-padded to a multiple of 16 in shared memory.
// bf16 at head_dim 64, 128 and 256 (every Qwen2.5-Math and Gemma layer) no
// longer comes here: flash_attention_bwd_hopper.cu (wgmma and TMA, the
// log-sum-exp the forward saved, a key tile's heads spread over several
// blocks) takes it.  These kernels keep fp32 (head dims up to 256) and the
// toy models' bf16 head dims 16 and 40; the entry point refuses bf16 above
// head_dim 128.
//
// Head dims above 128 (fp32 at 256): dK, dV and dQ are register tiles of
// at most kDimTile = 128 columns (a thread's 16 x 128 slice of dK and dV
// is already 128 fp32 registers), so the output's head dims are split over
// blocks: blocks (b) and (c) run once per 128-wide half of the head dim
// (grid y = kv heads or heads x halves), each recomputing S, P, dP and dS
// over the whole head dim from shared memory and producing its half of
// the output.  Only the transposed operands of the half's products are
// staged for the half.  And the G query heads of a kv head are spread over
// G blocks of (b) (one head each; the Gemma families have one kv head, so
// key tiles alone give too few blocks to fill the card): each writes its
// fp32 dK and dV to `part`, and a fourth kernel (d) sums the G partials in
// head order, scales dK and rounds both to the output dtype.  fp32 at
// head_dim 256 takes smaller tiles to fit shared memory: 16-query tiles in
// (b), 32-key tiles in (c).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // 4 warps of 16 rows
constexpr int kRows = 64;            // rows of a block: queries (a, c), keys (b)
constexpr int kKeys = 64;            // key tile of (a), and of (c) but fp32
                                     // above kDimTile
constexpr int kQueries = 32;         // query tile of (b), but fp32 above
                                     // kDimTile
constexpr int kDimTile = 128;        // output head dims of one block
constexpr int kMaxHeadDim = 256;
constexpr float kNeg = -1e30f;       // the reference's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                        // (B, H, Sq)
  float* delta;                      // (B, H, Sq)
  float* part;                       // (gsplit, 2, B, Sk, KV, hd), or null
  int Sq, Sk, H, KV, hd, hdp, G, causal, window;
  int halves;                        // ceil(hd / kDimTile)
  int gsplit;                        // blocks a kv group's heads spread over
  float scale;
};

// The head dims c0 .. c0 + cn - 1 that block index y's output covers (y's
// last factor is the half of the head dim).
__device__ __forceinline__ void dim_half(const Args& a, int y, int& c0,
                                         int& cn) {
  c0 = (y % a.halves) * kDimTile;
  cn = min(kDimTile, a.hd - c0);
}

__device__ __forceinline__ bool live(const Args& a, int pos, int key) {
  return pos < a.Sq && key < a.Sk && (!a.causal || key <= pos) &&
         (a.window == 0 || key > pos - a.window);
}
__device__ __forceinline__ int key_lo(const Args& a, int pos) {
  return a.window > 0 ? max(0, pos - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const Args& a, int pos) {
  return a.causal ? min(pos, a.Sk - 1) : a.Sk - 1;
}
__device__ __forceinline__ long q_off(const Args& a, int b, int h, int pos) {
  return pos < a.Sq ? (((long)b * a.Sq + pos) * a.H + h) * a.hd : -1;
}
__device__ __forceinline__ long kv_off(const Args& a, int b, int h, int key) {
  return key < a.Sk ? (((long)b * a.Sk + key) * a.KV + h) * a.hd : -1;
}

// shared-memory row padding (elements): row strides of 4 words mod 32 banks
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int n = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two neighbouring elements from fp32 values
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16 x 8, mma.sync accumulator layout: c[0], c[1] at row gq, columns
// 2 tg and 2 tg + 1; c[2], c[3] the same columns at row gq + 8) +=
// A (16 x 16) B (16 x 8), A's rows at `a` (k contiguous, row stride lda),
// B stored as [n][k] at `b` (k contiguous, row stride ldb).
__device__ __forceinline__ void mma_tile(float* c, const __nv_bfloat16* a,
                                         int lda, const __nv_bfloat16* b,
                                         int ldb, int gq, int tg) {
  const __nv_bfloat16* ar = a + gq * lda + tg * 2;
  const __nv_bfloat16* br = b + gq * ldb + tg * 2;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ld32(ar)), "r"(ld32(ar + 8 * lda)), "r"(ld32(ar + 8)),
        "r"(ld32(ar + 8 * lda + 8)), "r"(ld32(br)), "r"(ld32(br + 8)));
}

// the same tile product in fp32 on the CUDA cores
__device__ __forceinline__ void mma_tile(float* c, const float* a, int lda,
                                         const float* b, int ldb, int gq,
                                         int tg) {
  const float* a0 = a + gq * lda;
  const float* a1 = a0 + 8 * lda;
  const float* b0 = b + tg * 2 * ldb;
  const float* b1 = b0 + ldb;
#pragma unroll
  for (int kk = 0; kk < 16; kk += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + kk);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + kk);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + kk);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + kk);
    c[0] = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x0.z, y0.z,
               fmaf(x0.w, y0.w, c[0]))));
    c[1] = fmaf(x0.x, y1.x, fmaf(x0.y, y1.y, fmaf(x0.z, y1.z,
               fmaf(x0.w, y1.w, c[1]))));
    c[2] = fmaf(x1.x, y0.x, fmaf(x1.y, y0.y, fmaf(x1.z, y0.z,
               fmaf(x1.w, y0.w, c[2]))));
    c[3] = fmaf(x1.x, y1.x, fmaf(x1.y, y1.y, fmaf(x1.z, y1.z,
               fmaf(x1.w, y1.w, c[3]))));
  }
}

// `rows` rows of hd elements into dst[row][0:hdp] (row stride ld), zero
// past hd and in rows whose offset is -1; 16-byte chunks.
template <typename T, typename Off>
__device__ __forceinline__ void stage(T* dst, int ld, int rows, int hd,
                                      int hdp, const T* src, Off off) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = hdp / V;
  for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
    const int r = c / cpr, j = (c - r * cpr) * V;
    const long o = off(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (o >= 0 && j < hd)
      val = *reinterpret_cast<const uint4*>(src + o + j);
    *reinterpret_cast<uint4*>(dst + r * ld + j) = val;
  }
}

// the same rows' dims d0 .. d0 + dn - 1 transposed: dst[dim - d0][row]
// (row stride ldt)
template <typename T, typename Off>
__device__ __forceinline__ void stage_t(T* dst, int ldt, int rows, int d0,
                                        int dn, const T* src, Off off) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = dn / V;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c % rows, j = (c / rows) * V;
    const long o = off(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (o >= 0) val = *reinterpret_cast<const uint4*>(src + o + d0 + j);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int t = 0; t < V; ++t) dst[(j + t) * ldt + r] = e[t];
  }
}

// ---------------------------------------------------------------------------
// (a) log-sum-exp and D per query row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_stats_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int ld = a.hdp + Pad<T>::n;
  T* q_s = reinterpret_cast<T*>(smem);            // [kRows][ld]
  T* k_s = q_s + kRows * ld;                      // [kKeys][ld]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const int b = blockIdx.z, h = blockIdx.y, kvh = h / a.G;
  const int q0 = blockIdx.x * kRows;
  const int qlast = min(q0 + kRows, a.Sq) - 1;
  stage(q_s, ld, kRows, a.hd, a.hdp, q,
        [=](int r) { return q_off(a, b, h, q0 + r); });

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tg = lane & 3;
  const int pos0 = q0 + warp * 16 + gq, pos1 = pos0 + 8;
  const T* qw = q_s + warp * 16 * ld;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int first = key_lo(a, q0) / kKeys, last = key_hi(a, qlast) / kKeys;
  for (int tile = first; tile <= last; ++tile) {
    const int kb = tile * kKeys;
    __syncthreads();
    stage(k_s, ld, kKeys, a.hd, a.hdp, k,
          [=](int r) { return kv_off(a, b, kvh, kb + r); });
    __syncthreads();
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int ks = 0; ks < a.hdp; ks += 16) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
        mma_tile(s[nt], qw + ks, ld, k_s + nt * 8 * ld + ks, ld, gq, tg);
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + tg * 2 + (e & 1);
        s[nt][e] = live(a, e < 2 ? pos0 : pos1, key) ? s[nt][e] * a.scale
                                                      : -INFINITY;
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      sum0 += expf(s[nt][0] - mn0) + expf(s[nt][1] - mn0);
      sum1 += expf(s[nt][2] - mn1) + expf(s[nt][3] - mn1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * expf(m0 - mn0) + sum0;
    l1 = l1 * expf(m1 - mn1) + sum1;
    m0 = mn0;
    m1 = mn1;
  }
  const long row = ((long)b * a.H + h) * a.Sq;
  if (tg == 0 && pos0 < a.Sq) a.lse[row + pos0] = m0 + logf(l0);
  if (tg == 0 && pos1 < a.Sq) a.lse[row + pos1] = m1 + logf(l1);

  // D = rowsum(dO * O) in fp32, a warp per row
  const T* o = static_cast<const T*>(a.out);
  const T* dout = static_cast<const T*>(a.dout);
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const long off = q_off(a, b, h, q0 + r);
    if (off < 0) break;
    float acc = 0.f;
    for (int d = lane; d < a.hd; d += 32)
      acc = fmaf(to_f(dout[off + d]), to_f(o[off + d]), acc);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0) a.delta[row + q0 + r] = acc;
  }
}

// ---------------------------------------------------------------------------
// (b) dK and dV for a key tile, summed over the group's heads
// ---------------------------------------------------------------------------

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int ld = a.hdp + Pad<T>::n;
  const int ldq = QT + Pad<T>::n;
  int c0, cn;
  dim_half(a, blockIdx.y, c0, cn);
  T* k_s = reinterpret_cast<T*>(smem);            // [kRows][ld]
  T* v_s = k_s + kRows * ld;                      // [kRows][ld]
  T* q_s = v_s + kRows * ld;                      // [QT][ld]
  T* do_s = q_s + QT * ld;                        // [QT][ld]
  T* qt_s = do_s + QT * ld;                       // [cn][ldq]
  T* dot_s = qt_s + cn * ldq;                     // [cn][ldq]
  T* p_s = dot_s + cn * ldq;                      // [4 warps][16][ldq]
  float* lse_s = reinterpret_cast<float*>(p_s + 4 * 16 * ldq);
  float* d_s = lse_s + QT;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int b = blockIdx.z, kvh = blockIdx.y / a.halves / a.gsplit;
  const int split = blockIdx.y / a.halves % a.gsplit;
  const int k0 = blockIdx.x * kRows;
  const int klast = min(k0 + kRows, a.Sk) - 1;
  auto key_row = [=](int r) { return kv_off(a, b, kvh, k0 + r); };
  stage(k_s, ld, kRows, a.hd, a.hdp, k, key_row);
  stage(v_s, ld, kRows, a.hd, a.hdp, v, key_row);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tg = lane & 3;
  const int key0 = k0 + warp * 16 + gq, key1 = key0 + 8;
  const T* kw = k_s + warp * 16 * ld;
  const T* vw = v_s + warp * 16 * ld;
  T* pw = p_s + warp * 16 * ldq;
  const int ndt = cn / 8;
  float dk[kDimTile / 8][4], dv[kDimTile / 8][4];
#pragma unroll
  for (int t = 0; t < kDimTile / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  // query positions with a live key in [k0, klast]
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.Sq - 1, klast + a.window - 1)
                               : a.Sq - 1;
  const int g1 = (split + 1) * a.G / a.gsplit;
  for (int g = split * a.G / a.gsplit; g < g1 && qlo <= qhi; ++g) {
    const int h = kvh * a.G + g;
    const long stat = ((long)b * a.H + h) * a.Sq;
    for (int qt = qlo / QT; qt <= qhi / QT; ++qt) {
      const int p0 = qt * QT;
      auto q_row = [=](int r) { return q_off(a, b, h, p0 + r); };
      __syncthreads();                           // previous tile fully read
      stage(q_s, ld, QT, a.hd, a.hdp, q, q_row);
      stage(do_s, ld, QT, a.hd, a.hdp, dout, q_row);
      stage_t(qt_s, ldq, QT, c0, cn, q, q_row);
      stage_t(dot_s, ldq, QT, c0, cn, dout, q_row);
      if (threadIdx.x < QT) {
        const int pos = p0 + threadIdx.x;
        lse_s[threadIdx.x] = pos < a.Sq ? a.lse[stat + pos] : 0.f;
        d_s[threadIdx.x] = pos < a.Sq ? a.delta[stat + pos] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T (16 keys x QT queries a warp), then P^T
      float p[QT / 8][4];
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
        p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      for (int ks = 0; ks < a.hdp; ks += 16) {
#pragma unroll
        for (int nt = 0; nt < QT / 8; ++nt)
          mma_tile(p[nt], kw + ks, ld, q_s + nt * 8 * ld + ks, ld, gq, tg);
      }
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tg * 2 + (e & 1);
          p[nt][e] = live(a, p0 + col, e < 2 ? key0 : key1)
                         ? expf(p[nt][e] * a.scale - lse_s[col]) : 0.f;
        }
        store2(pw + gq * ldq + nt * 8 + tg * 2, p[nt][0], p[nt][1]);
        store2(pw + (gq + 8) * ldq + nt * 8 + tg * 2, p[nt][2], p[nt][3]);
      }
      __syncwarp();
      // dV += P^T dO
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) {
#pragma unroll
        for (int t = 0; t < kDimTile / 8; ++t)
          if (t < ndt)
            mma_tile(dv[t], pw + kc * 16, ldq, dot_s + t * 8 * ldq + kc * 16,
                     ldq, gq, tg);
      }
      // dP^T = V dO^T, dS^T = P^T (dP^T - D)
      float dp[QT / 8][4];
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      for (int ks = 0; ks < a.hdp; ks += 16) {
#pragma unroll
        for (int nt = 0; nt < QT / 8; ++nt)
          mma_tile(dp[nt], vw + ks, ld, do_s + nt * 8 * ld + ks, ld, gq, tg);
      }
      __syncwarp();                              // P^T fully read
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt) {
        const int col = nt * 8 + tg * 2;
        store2(pw + gq * ldq + col, p[nt][0] * (dp[nt][0] - d_s[col]),
               p[nt][1] * (dp[nt][1] - d_s[col + 1]));
        store2(pw + (gq + 8) * ldq + col, p[nt][2] * (dp[nt][2] - d_s[col]),
               p[nt][3] * (dp[nt][3] - d_s[col + 1]));
      }
      __syncwarp();
      // dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) {
#pragma unroll
        for (int t = 0; t < kDimTile / 8; ++t)
          if (t < ndt)
            mma_tile(dk[t], pw + kc * 16, ldq, qt_s + t * 8 * ldq + kc * 16,
                     ldq, gq, tg);
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
  const long o0 = kv_off(a, b, kvh, key0), o1 = kv_off(a, b, kvh, key1);
  if (a.gsplit > 1) {                // fp32 partials, summed by (d)
    const long n = (long)gridDim.z * a.Sk * a.KV * a.hd;
    float* pk = a.part + 2 * split * n;
    float* pv = pk + n;
#pragma unroll
    for (int t = 0; t < kDimTile / 8; ++t) {
      if (t < ndt) {
        const int d = c0 + t * 8 + tg * 2;
        if (o0 >= 0) {
          store2(pk + o0 + d, dk[t][0], dk[t][1]);
          store2(pv + o0 + d, dv[t][0], dv[t][1]);
        }
        if (o1 >= 0) {
          store2(pk + o1 + d, dk[t][2], dk[t][3]);
          store2(pv + o1 + d, dv[t][2], dv[t][3]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < kDimTile / 8; ++t) {
    if (t < ndt) {
      const int d = c0 + t * 8 + tg * 2;
      if (o0 >= 0) {
        store2(dkg + o0 + d, dk[t][0] * a.scale, dk[t][1] * a.scale);
        store2(dvg + o0 + d, dv[t][0], dv[t][1]);
      }
      if (o1 >= 0) {
        store2(dkg + o1 + d, dk[t][2] * a.scale, dk[t][3] * a.scale);
        store2(dvg + o1 + d, dv[t][2], dv[t][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dQ for 64 query positions of one head
// ---------------------------------------------------------------------------

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int ld = a.hdp + Pad<T>::n;
  const int ldk = KT + Pad<T>::n;
  int c0, cn;
  dim_half(a, blockIdx.y, c0, cn);
  T* q_s = reinterpret_cast<T*>(smem);            // [kRows][ld]
  T* do_s = q_s + kRows * ld;                     // [kRows][ld]
  T* k_s = do_s + kRows * ld;                     // [KT][ld]
  T* v_s = k_s + KT * ld;                         // [KT][ld]
  T* kt_s = v_s + KT * ld;                        // [cn][ldk]
  T* p_s = kt_s + cn * ldk;                       // [4 warps][16][ldk]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int b = blockIdx.z, h = blockIdx.y / a.halves, kvh = h / a.G;
  const int q0 = blockIdx.x * kRows;
  const int qlast = min(q0 + kRows, a.Sq) - 1;
  auto q_row = [=](int r) { return q_off(a, b, h, q0 + r); };
  stage(q_s, ld, kRows, a.hd, a.hdp, q, q_row);
  stage(do_s, ld, kRows, a.hd, a.hdp, dout, q_row);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tg = lane & 3;
  const int pos0 = q0 + warp * 16 + gq, pos1 = pos0 + 8;
  const long stat = ((long)b * a.H + h) * a.Sq;
  const float lse0 = pos0 < a.Sq ? a.lse[stat + pos0] : 0.f;
  const float lse1 = pos1 < a.Sq ? a.lse[stat + pos1] : 0.f;
  const float d0 = pos0 < a.Sq ? a.delta[stat + pos0] : 0.f;
  const float d1 = pos1 < a.Sq ? a.delta[stat + pos1] : 0.f;
  const T* qw = q_s + warp * 16 * ld;
  const T* dow = do_s + warp * 16 * ld;
  T* pw = p_s + warp * 16 * ldk;
  const int ndt = cn / 8;
  float dq[kDimTile / 8][4];
#pragma unroll
  for (int t = 0; t < kDimTile / 8; ++t)
    dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;

  const int first = key_lo(a, q0) / KT, last = key_hi(a, qlast) / KT;
  for (int tile = first; tile <= last; ++tile) {
    const int kb = tile * KT;
    auto key_row = [=](int r) { return kv_off(a, b, kvh, kb + r); };
    __syncthreads();
    stage(k_s, ld, KT, a.hd, a.hdp, k, key_row);
    stage(v_s, ld, KT, a.hd, a.hdp, v, key_row);
    stage_t(kt_s, ldk, KT, c0, cn, k, key_row);
    __syncthreads();

    // S = Q K^T, P
    float p[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
    for (int ks = 0; ks < a.hdp; ks += 16) {
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
        mma_tile(p[nt], qw + ks, ld, k_s + nt * 8 * ld + ks, ld, gq, tg);
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + tg * 2 + (e & 1);
        const bool row1 = e >= 2;
        p[nt][e] = live(a, row1 ? pos1 : pos0, key)
                       ? expf(p[nt][e] * a.scale - (row1 ? lse1 : lse0))
                       : 0.f;
      }
    }
    // dP = dO V^T, dS = P (dP - D)
    float dp[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    for (int ks = 0; ks < a.hdp; ks += 16) {
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
        mma_tile(dp[nt], dow + ks, ld, v_s + nt * 8 * ld + ks, ld, gq, tg);
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const int col = nt * 8 + tg * 2;
      store2(pw + gq * ldk + col, p[nt][0] * (dp[nt][0] - d0),
             p[nt][1] * (dp[nt][1] - d0));
      store2(pw + (gq + 8) * ldk + col, p[nt][2] * (dp[nt][2] - d1),
             p[nt][3] * (dp[nt][3] - d1));
    }
    __syncwarp();
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
#pragma unroll
      for (int t = 0; t < kDimTile / 8; ++t)
        if (t < ndt)
          mma_tile(dq[t], pw + kc * 16, ldk, kt_s + t * 8 * ldk + kc * 16,
                   ldk, gq, tg);
    }
    __syncwarp();                                // dS fully read
  }

  T* dqg = static_cast<T*>(a.dq);
  const long o0 = q_off(a, b, h, pos0), o1 = q_off(a, b, h, pos1);
#pragma unroll
  for (int t = 0; t < kDimTile / 8; ++t) {
    if (t < ndt) {
      const int d = c0 + t * 8 + tg * 2;
      if (o0 >= 0)
        store2(dqg + o0 + d, dq[t][0] * a.scale, dq[t][1] * a.scale);
      if (o1 >= 0)
        store2(dqg + o1 + d, dq[t][2] * a.scale, dq[t][3] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// (d) dK and dV from the split heads' partials, summed in head order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_sum_kernel(Args a,
                                                                long n) {
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (long i = 2 * ((long)blockIdx.x * kThreads + threadIdx.x); i < n;
       i += 2L * gridDim.x * kThreads) {
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int s = 0; s < a.gsplit; ++s) {
      const float2 pk =
          *reinterpret_cast<const float2*>(a.part + 2 * s * n + i);
      const float2 pv =
          *reinterpret_cast<const float2*>(a.part + (2 * s + 1) * n + i);
      k0 += pk.x;
      k1 += pk.y;
      v0 += pv.x;
      v1 += pv.y;
    }
    store2(dk + i, k0 * a.scale, k1 * a.scale);
    store2(dv + i, v0, v1);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// (b) and (c) with query tiles of QT and key tiles of KT
template <typename T, int QT, int KT>
cudaError_t launch_all(const Args& a, int B, cudaStream_t s) {
  const size_t ld = a.hdp + Pad<T>::n;
  const size_t ldq = QT + Pad<T>::n, ldk = KT + Pad<T>::n;
  const size_t dn = a.hd < kDimTile ? a.hd : kDimTile;
  const dim3 sgrid((a.Sq + kRows - 1) / kRows, a.H, B);
  const dim3 qgrid((a.Sq + kRows - 1) / kRows, a.H * a.halves, B);
  const dim3 kgrid((a.Sk + kRows - 1) / kRows, a.KV * a.halves * a.gsplit,
                   B);
  cudaError_t e = launch(bwd_stats_kernel<T>, a, sgrid,
                         sizeof(T) * (kRows + kKeys) * ld, s);
  if (e != cudaSuccess) return e;
  e = launch(bwd_dkdv_kernel<T, QT>, a, kgrid,
             sizeof(T) * ((2 * kRows + 2 * QT) * ld + 2 * dn * ldq +
                          4 * 16 * ldq) +
                 sizeof(float) * 2 * QT,
             s);
  if (e != cudaSuccess) return e;
  e = launch(bwd_dq_kernel<T, KT>, a, qgrid,
             sizeof(T) * ((2 * kRows + 2 * KT) * ld + dn * ldk +
                          4 * 16 * ldk),
             s);
  if (e != cudaSuccess || a.gsplit == 1) return e;
  const long n = (long)B * a.Sk * a.KV * a.hd;
  const long blocks = (n / 2 + kThreads - 1) / kThreads;
  bwd_dkdv_sum_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           kThreads, 0, s>>>(a, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (head_dim 128 at most), for all of q,
// k, v, out, dout, dq, dk and dv.  q, out, dout, dq: (B, Sq, H, hd);
// k, v, dk, dv: (B, Sk, KV, hd); all contiguous and 16-byte aligned; lse
// and delta: (B, H, Sq) float32 scratch; part: float32 scratch of
// 2 H B Sk hd elements (the split heads' dK and dV) when head_dim > 128,
// else unused (may be null).  H / KV <= 64;
// head_dim a multiple of 8, at most 256.  Every query row must hold at
// least one live key (the wrapper checks).  Launches the three kernels
// (four above head_dim 128) in order on `stream`; returns the first
// cudaError_t (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta,
                                   void* part, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int causal, int window, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > 64 || hd <= 0 || hd > kMaxHeadDim || hd % 8 != 0 ||
      window < 0 || B > 65535 ||
      H * ((hd + kDimTile - 1) / kDimTile) > 65535 ||
      (hd > kDimTile && part == nullptr) || (dtype == 1 && hd > kDimTile))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.part = static_cast<float*>(part);
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  a.G = H / KV;
  a.causal = causal;
  a.window = window;
  a.halves = (hd + kDimTile - 1) / kDimTile;
  a.gsplit = hd > kDimTile ? H / KV : 1;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_all<__nv_bfloat16, kQueries, kKeys>(a, B, s);
  if (dtype == 0 && hd > kDimTile)
    return (int)launch_all<float, kQueries / 2, kKeys / 2>(a, B, s);
  if (dtype == 0) return (int)launch_all<float, kQueries, kKeys>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
