// Fused log-softmax + label gather over the vocabulary for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel `logprob_gather_pallas`
// (src/repro/kernels/logprob_gather.py, `_kernel`): for every token t,
//     out[t] = logits[t, label[t]] - logsumexp(logits[t, :vocab]),
//     logits = h @ W,  h (T, d),  W (d, V),
// with the columns >= vocab masked and the math in fp32.  The (T, V)
// logits are never written to device memory.
//
// What bounds it on an H100: at the scoring shapes (T = 256 tokens,
// d = 3584, V = 152064) the work is a (T x d) by (d x V) product, 2.8e11
// flops against 1.09 GB of W in bf16: about 0.28 ms at the dense bf16
// tensor-core rate and 0.33 ms at the HBM rate, so the W bytes set the
// bound, closely followed by the flops.  With fp32 h the products run as
// three bf16 passes (below): 0.85 ms of tensor-core work against the same
// bytes, so the operations set that bound.
//
// Design, bf16 W (the Qwen2.5-Math and RWKV models):
//   * The TPU kernel runs the vocab axis as a sequential grid dimension with
//     (m, s, picked) in VMEM scratch.  Hopper blocks run in parallel, so the
//     vocabulary is cut into splits: a grid of (token tiles of 128, vocab
//     splits), each block sweeping its split's strips of 256 columns and
//     keeping the online (m, s, picked) of its tokens in registers.  It
//     writes them as partials; a second kernel merges the splits per token
//     into picked - (m + log s).
//   * Warp specialisation: one producer thread keeps a ring of 4 stages
//     (2 with fp32 h) full through TMA, each stage a 64-deep chunk of the
//     block's h rows and of the strip's W, with full/empty mbarriers; two
//     consumer warpgroups each multiply 64 tokens by the 256 columns with
//     wgmma m64n256k16 (bf16 in, fp32 accumulate, 128 accumulators a
//     thread), keeping one product group in flight while the next stage is
//     issued.  Token tiles are the fastest grid axis, so the blocks that
//     read one W strip run side by side and share it through L2: W comes
//     from device memory about once, and h (1.8 MB at T = 256) stays in L2
//     and is read once per 256 columns, not once per 64 as before.
//   * W is read through its two strides by its own tensor map: a row-major
//     (d, V) unembedding is an MN-major B operand (64-column boxes, 64
//     rows deep), the tied embedding's transpose (W[k, n] at n * ld + k) a
//     K-major one; neither is copied.  Out-of-range rows and columns land
//     as zeros, and the columns >= vocab are masked in the epilogue.
//   * Epilogue per strip: each thread folds its 2 rows x 64 columns of
//     logits into its own running (m, s, picked); the quad that shares a
//     row merges them once, after the split's last strip.
//   * fp32 h over bf16 W (shared scoring over quantized pools): the
//     wrapper splits h into three bf16 parts h1 + h2 + h3 (residual below
//     2^-24 |h|), and each stage multiplies all three by the same W chunk
//     into the same fp32 accumulators.  A bf16 x bf16 product is exact in
//     fp32, so this is the reference's fp32 math up to summation order, at
//     three times the tensor-core work and the same W bytes.
// fp32 h over fp32 W (the toy models only) keeps a CUDA-core kernel: 64 x
// 64 logit tiles, h and W chunks double-buffered with cp.async, 4 x 8
// outputs a thread.
// Not yet: thread-block clusters multicasting one W chunk to the blocks of
// a strip (halving the L2 reads of W), or a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;       // the reference's mask value

// ---------------------------------------------------------------------------
// fp32 h over fp32 W: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;        // 4 warps
constexpr int kTT = 64;              // tokens per block
constexpr int kVT = 64;              // vocab columns per tile
constexpr int kKC = 32;              // depth of one pipeline stage
constexpr int kLDL = kVT + 4;        // row stride of the fp32 logit tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory geometry of one pipeline stage (floats and bytes).
template <bool kContig>
struct Geometry {
  static constexpr int LDH = kKC + 4;           // hs[token][k]
  // kContig: ws[n][k] (column-major B); else ws[k][n] (row-major B)
  static constexpr int LDW = kContig ? kKC + 4 : kVT + 4;
  static constexpr int H_BYTES = kTT * LDH * 4;
  static constexpr int W_BYTES = (kContig ? kVT : kKC) * LDW * 4;
  static constexpr int SMEM = 2 * H_BYTES + 2 * W_BYTES
      + kTT * kLDL * 4 + 4 * kTT * 4;           // + logits, m/s/p/labels
  static_assert(H_BYTES % 32 == 0 && W_BYTES % 32 == 0, "alignment");
};

// Issue the cp.async copies of one stage: h[t0:t0+64, k0:k0+32] and
// W[k0:k0+32, c0:c0+64], zero past T, d and V.
template <bool kContig>
__device__ __forceinline__ void load_stage(float* hs, float* ws,
                                           const float* h, const float* w,
                                           int t0, int c0, int k0, int T,
                                           int d, int V, long ldw) {
  using Gm = Geometry<kContig>;
  constexpr int HC = kKC / 4;
  for (int c = threadIdx.x; c < kTT * HC; c += kThreads) {
    const int r = c / HC;
    const int j = (c - r * HC) * 4;
    const bool ok = t0 + r < T && k0 + j < d;
    cp_async16(hs + r * Gm::LDH + j, ok ? h + (long)(t0 + r) * d + k0 + j : h,
               ok);
  }
  if constexpr (kContig) {
    constexpr int WC = kKC / 4;
    for (int c = threadIdx.x; c < kVT * WC; c += kThreads) {
      const int n = c / WC;
      const int j = (c - n * WC) * 4;
      const bool ok = c0 + n < V && k0 + j < d;
      cp_async16(ws + n * Gm::LDW + j,
                 ok ? w + (long)(c0 + n) * ldw + k0 + j : w, ok);
    }
  } else {
    constexpr int WC = kVT / 4;
    for (int c = threadIdx.x; c < kKC * WC; c += kThreads) {
      const int kk = c / WC;
      const int j = (c - kk * WC) * 4;
      const bool ok = c0 + j < V && k0 + kk < d;
      cp_async16(ws + kk * Gm::LDW + j,
                 ok ? w + (long)(k0 + kk) * ldw + c0 + j : w, ok);
    }
  }
  cp_async_commit();
}

// lg[0:64, 0:64] = h[t0:t0+64, :] @ W[:, c0:c0+64] in fp32.
template <bool kContig>
__device__ void tile_logits(const float* h, const float* w, char* smem,
                            float* lg, int t0, int c0, int T, int d, int V,
                            long ldw) {
  using Gm = Geometry<kContig>;
  float* hs[2] = {reinterpret_cast<float*>(smem),
                  reinterpret_cast<float*>(smem + Gm::H_BYTES)};
  float* ws[2] = {reinterpret_cast<float*>(smem + 2 * Gm::H_BYTES),
                  reinterpret_cast<float*>(smem + 2 * Gm::H_BYTES +
                                           Gm::W_BYTES)};
  const int nk = (d + kKC - 1) / kKC;
  load_stage<kContig>(hs[0], ws[0], h, w, t0, c0, 0, T, d, V, ldw);
  // thread owns tokens tr + 16a (a < 4) and columns tc + 8b (b < 8)
  const int tr = threadIdx.x / 8;
  const int tc = threadIdx.x % 8;
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < nk) {
      load_stage<kContig>(hs[cur ^ 1], ws[cur ^ 1], h, w, t0, c0,
                          (kb + 1) * kKC, T, d, V, ldw);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hc = hs[cur];
    const float* wc = ws[cur];
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = hc[(tr + 16 * a) * Gm::LDH + k];
#pragma unroll
      for (int b = 0; b < 8; ++b)
        bv[b] = kContig ? wc[(tc + 8 * b) * Gm::LDW + k]
                        : wc[k * Gm::LDW + tc + 8 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) lg[(tr + 16 * a) * kLDL + tc + 8 * b] = acc[a][b];
}

template <bool kContig>
__global__ void __launch_bounds__(kThreads)
logprob_partial_kernel(const float* __restrict__ h,
                       const float* __restrict__ w,
                       const int* __restrict__ labels,
                       float* __restrict__ part, int T, int d, int V,
                       int vocab, long ldw, int tiles_per_split,
                       int nsplit) {
  using Gm = Geometry<kContig>;
  extern __shared__ __align__(128) char smem[];
  float* lg = reinterpret_cast<float*>(smem + 2 * Gm::H_BYTES
                                       + 2 * Gm::W_BYTES);  // [kTT][kLDL]
  float* m_s = lg + kTT * kLDL;        // running max per token
  float* s_s = m_s + kTT;              // running sum of exp(logit - m)
  float* p_s = s_s + kTT;              // the label's logit (or -1e30)
  int* lab_s = reinterpret_cast<int*>(p_s + kTT);
  const int t0 = blockIdx.x * kTT;
  const int split = blockIdx.y;
  const int ntiles = (vocab + kVT - 1) / kVT;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, ntiles);
  if (threadIdx.x < kTT) {
    m_s[threadIdx.x] = kNeg;
    s_s[threadIdx.x] = 0.f;
    p_s[threadIdx.x] = kNeg;
    const int t = t0 + threadIdx.x;
    lab_s[threadIdx.x] = t < T ? labels[t] : -1;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int c0 = tile * kVT;
    tile_logits<kContig>(h, w, smem, lg, t0, c0, T, d, V, ldw);
    __syncthreads();
    // online logsumexp and label pick: one warp per 16 token rows, each
    // lane two columns of the tile
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float la = c0 + lane < vocab ? lg[r * kLDL + lane] : kNeg;
      const float lb = c0 + lane + 32 < vocab ? lg[r * kLDL + lane + 32]
                                              : kNeg;
      float mt = fmaxf(la, lb);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      float e = expf(la - m_new) + expf(lb - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        e += __shfl_xor_sync(0xffffffffu, e, off);
      if (lane == 0) {
        s_s[r] = s_s[r] * expf(m_old - m_new) + e;
        m_s[r] = m_new;
        const int lab = lab_s[r];
        if (lab >= c0 && lab < c0 + kVT && lab < vocab)
          p_s[r] = fmaxf(p_s[r], lg[r * kLDL + lab - c0]);
      }
    }
    __syncthreads();                   // lg and the stage buffers free
  }
  if (threadIdx.x < kTT && t0 + threadIdx.x < T) {
    const long i = (long)split * T + t0 + threadIdx.x;
    part[i] = m_s[threadIdx.x];
    part[(long)nsplit * T + i] = s_s[threadIdx.x];
    part[2L * nsplit * T + i] = p_s[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// bf16 W, bf16 h or fp32 h as three bf16 parts: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kHThreads = 384;       // 2 consumer warpgroups + 1 producer
constexpr int kHConsumers = 256;
constexpr int kHTokens = 128;        // tokens per block (64 a warpgroup)
constexpr int kHCols = 256;          // vocab columns per strip
constexpr int kHDepth = 64;          // depth of one stage (128 bytes)

// NPART bf16 parts of h (1, or 3 for fp32 h).  Stage: h [part][128 tokens]
// [64] then W, [4 panels of 64 columns][64 rows] (MN-major) or [256
// columns][64] (K-major), all rows 128 bytes, 128-byte swizzled.
template <int NPART>
struct GPlan {
  static constexpr int kStages = NPART == 1 ? 4 : 2;
  static constexpr int kHPart = kHTokens * 128;
  static constexpr int kWBytes = kHCols * 128;
  static constexpr int kStage = NPART * kHPart + kWBytes;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
};

template <int NPART, bool KMAJOR>
__global__ void __launch_bounds__(kHThreads, 1)
logprob_hopper_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const int* __restrict__ labels,
                      float* __restrict__ part, int T, int d, int vocab,
                      int tiles_per_split, int nsplit) {
  using P = GPlan<NPART>;
  constexpr int S = P::kStages;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* empty = full + S;
  const int t0 = blockIdx.x * kHTokens;
  const int split = blockIdx.y;
  const int ntiles = (vocab + kHCols - 1) / kHCols;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, ntiles);
  const int nk = (d + kHDepth - 1) / kHDepth;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kHConsumers);
    }
  }
  hopper::fence_barrier_init();
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      int it = 0;
      for (int tile = tile_lo; tile < tile_hi; ++tile) {
        const int c0 = tile * kHCols;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % S, ph = (it / S) & 1;
          char* hs = base + s * P::kStage;
          char* ws = hs + NPART * P::kHPart;
          hopper::mbar_wait(&empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&full[s], P::kStage);
          if constexpr (NPART == 1)
            hopper::tma_load_2d(hs, &hmap, &full[s], kc * kHDepth, t0);
          else
            hopper::tma_load_3d(hs, &hmap, &full[s], kc * kHDepth, t0, 0);
          if constexpr (KMAJOR) {
            hopper::tma_load_2d(ws, &wmap, &full[s], kc * kHDepth, c0);
          } else {
            for (int i = 0; i < kHCols / 64; ++i)
              hopper::tma_load_2d(ws + i * 64 * 128, &wmap, &full[s],
                                  c0 + 64 * i, kc * kHDepth);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tokens t0 + 64 wg ... + 63 ----
    hopper::setmaxnreg_inc<240>();
    const int w = (tid % 128) / 32, lane = tid % 32;
    const int gq = lane >> 2, tq = lane & 3;
    const int ta = t0 + 64 * wg + 16 * w + gq, tb = ta + 8;  // two rows
    const int lab_a = ta < T ? labels[ta] : -1;
    const int lab_b = tb < T ? labels[tb] : -1;
    float ma = kNeg, sa = 0.f, pa = kNeg, mb = kNeg, sb = 0.f, pb = kNeg;
    float acc[kHCols / 2];
    int it = 0, prev = 0;
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int c0 = tile * kHCols;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % S, ph = (it / S) & 1;
        const char* hs = base + s * P::kStage + wg * 64 * 128;
        const char* ws = base + s * P::kStage + NPART * P::kHPart;
        hopper::mbar_wait(&full[s], ph);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHDepth / 16; ++kk) {
          const uint64_t dw =
              KMAJOR ? hopper::desc_sw128(ws + kk * 32, 16, 1024)
                     : hopper::desc_sw128(ws + kk * 16 * 128, 64 * 128, 1024);
#pragma unroll
          for (int p = 0; p < NPART; ++p)
            hopper::wgmma_ss_n256<KMAJOR ? 0 : 1>(
                acc,
                hopper::desc_sw128(hs + p * P::kHPart + kk * 32, 16, 1024),
                dw, kc > 0 || kk > 0 || p > 0);
        }
        hopper::wgmma_commit();
        // the previous stage's products are done: release it
        hopper::wgmma_wait<1>();
        if (kc > 0) hopper::mbar_arrive(&empty[prev]);
        prev = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands<kHCols / 2>(acc);
      hopper::mbar_arrive(&empty[prev]);

      // fold the strip into this thread's running (m, s, picked): column
      // c0 + 8j + 2tq + (e & 1), row a for e < 2, row b for e >= 2
      float mta = kNeg, mtb = kNeg;
#pragma unroll
      for (int j = 0; j < kHCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          const bool in = col < vocab;
          const float x = in ? acc[4 * j + e] : -INFINITY;
          acc[4 * j + e] = x;
          if (e < 2) {
            mta = fmaxf(mta, x);
            if (in && col == lab_a) pa = x;
          } else {
            mtb = fmaxf(mtb, x);
            if (in && col == lab_b) pb = x;
          }
        }
      }
      const float na = fmaxf(ma, mta), nb = fmaxf(mb, mtb);
      float ea = 0.f, eb = 0.f;
#pragma unroll
      for (int j = 0; j < kHCols / 8; ++j) {
        ea += expf(acc[4 * j] - na) + expf(acc[4 * j + 1] - na);
        eb += expf(acc[4 * j + 2] - nb) + expf(acc[4 * j + 3] - nb);
      }
      sa = sa * expf(ma - na) + ea;
      sb = sb * expf(mb - nb) + eb;
      ma = na;
      mb = nb;
    }
    // merge the quad that shares the rows, then one lane writes
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float oma = __shfl_xor_sync(0xffffffffu, ma, off);
      const float osa = __shfl_xor_sync(0xffffffffu, sa, off);
      const float omb = __shfl_xor_sync(0xffffffffu, mb, off);
      const float osb = __shfl_xor_sync(0xffffffffu, sb, off);
      pa = fmaxf(pa, __shfl_xor_sync(0xffffffffu, pa, off));
      pb = fmaxf(pb, __shfl_xor_sync(0xffffffffu, pb, off));
      const float xa = fmaxf(ma, oma), xb = fmaxf(mb, omb);
      sa = sa * expf(ma - xa) + osa * expf(oma - xa);
      sb = sb * expf(mb - xb) + osb * expf(omb - xb);
      ma = xa;
      mb = xb;
    }
    if (tq == 0) {
      const long n = (long)nsplit * T;
      if (ta < T) {
        const long i = (long)split * T + ta;
        part[i] = ma;
        part[n + i] = sa;
        part[2 * n + i] = pa;
      }
      if (tb < T) {
        const long i = (long)split * T + tb;
        part[i] = mb;
        part[n + i] = sb;
        part[2 * n + i] = pb;
      }
    }
  }
}

// out[t] = max_s picked - (M + log sum_s s_s * exp(m_s - M)), M = max_s m_s
__global__ void logprob_merge_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int T,
                                     int nsplit) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* m = part;
  const float* s = part + (long)nsplit * T;
  const float* p = part + 2L * nsplit * T;
  float M = kNeg, P = kNeg;
  for (int i = 0; i < nsplit; ++i) {
    M = fmaxf(M, m[(long)i * T + t]);
    P = fmaxf(P, p[(long)i * T + t]);
  }
  float S = 0.f;
  for (int i = 0; i < nsplit; ++i)
    S += s[(long)i * T + t] * expf(m[(long)i * T + t] - M);
  out[t] = P - (M + logf(S));
}

cudaError_t merge(const void* part, void* out, int T, int nsplit,
                  cudaStream_t stream) {
  logprob_merge_kernel<<<(T + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), T, nsplit);
  return cudaGetLastError();
}

template <bool kContig>
cudaError_t launch_f32(const void* h, const void* w, const void* labels,
                       void* part, int T, int d, int V, int vocab, long ldw,
                       int tiles_per_split, int nsplit, cudaStream_t stream) {
  using Gm = Geometry<kContig>;
  if (d % 4 != 0 || (!kContig && V % 4 != 0) || ldw % 4 != 0)
    return cudaErrorInvalidValue;
  auto kernel = logprob_partial_kernel<kContig>;
  if (Gm::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + kTT - 1) / kTT, nsplit);
  kernel<<<grid, kThreads, Gm::SMEM, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<float*>(part), T, d, V,
      vocab, ldw, tiles_per_split, nsplit);
  return cudaGetLastError();
}

template <int NPART, bool KMAJOR>
cudaError_t launch_hopper(const void* h, const void* w, const void* labels,
                          void* part, int T, int d, int V, int vocab,
                          long ldw, int tiles_per_split, int nsplit,
                          cudaStream_t stream) {
  using P = GPlan<NPART>;
  if (d % 8 != 0 || ldw % 8 != 0) return cudaErrorInvalidValue;
  // h: (d, T[, 3 parts]) in boxes of (64, 128[, 3]); W: K-major (d, V)
  // with columns ldw apart, boxes (64, 256), or MN-major (V, d) with rows
  // ldw apart, boxes (64, 64)
  const uint64_t hd[3] = {(uint64_t)d, (uint64_t)T, 3};
  const uint64_t hs[2] = {(uint64_t)d * 2, (uint64_t)T * d * 2};
  const uint32_t hb[3] = {kHDepth, kHTokens, 3};
  const uint64_t wdk[2] = {(uint64_t)d, (uint64_t)V};
  const uint64_t wdm[2] = {(uint64_t)V, (uint64_t)d};
  const uint64_t ws[1] = {(uint64_t)ldw * 2};
  const uint32_t wbk[2] = {kHDepth, kHCols};
  const uint32_t wbm[2] = {64, kHDepth};
  CUtensorMap hm, wm;
  cudaError_t err = hopper::make_tensor_map(&hm, NPART == 1 ? 2 : 3, h, hd,
                                            hs, hb);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map(&wm, 2, w, KMAJOR ? wdk : wdm, ws,
                                  KMAJOR ? wbk : wbm);
  if (err != cudaSuccess) return err;
  auto kernel = logprob_hopper_kernel<NPART, KMAJOR>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kHTokens - 1) / kHTokens, nsplit);
  kernel<<<grid, kHThreads, P::kSmem, stream>>>(
      hm, wm, static_cast<const int*>(labels), static_cast<float*>(part), T,
      d, vocab, tiles_per_split, nsplit);
  return cudaGetLastError();
}

template <int NPART>
cudaError_t launch_hopper_layout(int kcontig, const void* h, const void* w,
                                 const void* labels, void* part, int T,
                                 int d, int V, int vocab, long ldw,
                                 int tiles_per_split, int nsplit,
                                 cudaStream_t s) {
  if (kcontig)
    return launch_hopper<NPART, true>(h, w, labels, part, T, d, V, vocab,
                                      ldw, tiles_per_split, nsplit, s);
  return launch_hopper<NPART, false>(h, w, labels, part, T, d, V, vocab, ldw,
                                     tiles_per_split, nsplit, s);
}

}  // namespace

// hdtype: 0 = float32 h (T, d); 1 = bfloat16 h (T, d); 2 = fp32 h split
// into three bfloat16 parts, (3, T, d).  wdtype: 0 = float32 W (only with
// hdtype 0), 1 = bfloat16 W (with hdtype 1 or 2).  W: (d, V); kcontig = 1:
// W[k, n] at n * ldw + k (a transposed row-major (V, d) matrix), kcontig =
// 0: W[k, n] at k * ldw + n.  labels: (T,) int32.  part: (3, nsplit, T)
// float32 scratch; out: (T,) float32.  The vocabulary's strips
// (ceil(vocab / 64) with fp32 W, ceil(vocab / 256) with bf16 W) are cut
// into nsplit splits of tiles_per_split strips, none of them empty.
// Pointers 16-byte aligned; rows of h and W (d, ldw, and V when kcontig =
// 0 and W is fp32) multiples of 16 bytes.  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int logprob_gather_fwd(const void* h, const void* w,
                                  const void* labels, void* part, void* out,
                                  int T, int d, int V, int vocab,
                                  long long ldw, int kcontig,
                                  int tiles_per_split, int nsplit, int hdtype,
                                  int wdtype, void* stream) {
  const int strip = wdtype == 1 ? kHCols : kVT;
  const int ntiles = (vocab + strip - 1) / strip;
  if (T <= 0 || d <= 0 || V <= 0 || vocab <= 0 || vocab > V ||
      tiles_per_split <= 0 || nsplit <= 0 ||
      (long)nsplit * tiles_per_split < ntiles ||
      (long)(nsplit - 1) * tiles_per_split >= ntiles || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long ld = static_cast<long>(ldw);
  cudaError_t err;
  if (hdtype == 0 && wdtype == 0)
    err = kcontig ? launch_f32<true>(h, w, labels, part, T, d, V, vocab, ld,
                                     tiles_per_split, nsplit, s)
                  : launch_f32<false>(h, w, labels, part, T, d, V, vocab, ld,
                                      tiles_per_split, nsplit, s);
  else if (hdtype == 1 && wdtype == 1)
    err = launch_hopper_layout<1>(kcontig, h, w, labels, part, T, d, V,
                                  vocab, ld, tiles_per_split, nsplit, s);
  else if (hdtype == 2 && wdtype == 1)
    err = launch_hopper_layout<3>(kcontig, h, w, labels, part, T, d, V,
                                  vocab, ld, tiles_per_split, nsplit, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)merge(part, out, T, nsplit, s);
}
