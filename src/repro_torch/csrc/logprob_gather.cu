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
// bound, closely followed by the flops.
//
// Design:
//   * The TPU kernel runs the vocab axis as a sequential grid dimension with
//     (m, s, picked) in VMEM scratch.  Hopper blocks run in parallel, so the
//     vocabulary is cut into splits: a grid of (token tiles of 64, vocab
//     splits), each block sweeping its own split's tiles of 64 columns in a
//     loop and keeping the online (m, s, picked) of its 64 tokens in shared
//     memory.  It writes them as partials; a second kernel merges the
//     splits per token into picked - (m + log s).
//   * Each 64 x 64 logit tile is a k-loop over d in chunks of 32, h and W
//     chunks double-buffered in shared memory with 16-byte cp.async copies
//     (zero-filled past the edges).  Token tiles are the fastest grid axis,
//     so the blocks that read one W range run side by side and share it
//     through L2; W comes from device memory about once.
//   * bf16 h and bf16 W multiply on the tensor cores (WMMA 16x16x16, fp32
//     accumulate: a bf16 x bf16 product is exact in fp32, so this is the
//     reference's fp32 math up to summation order).  fp32 h or fp32 W (the
//     scoring pass over dequantized KV promotes h to fp32; the toy models
//     are fp32) multiply in fp32 on the CUDA cores, 4 x 8 outputs a thread.
//   * W is read through its two strides, so the tied embedding's transpose
//     (W[k, n] at n * d + k) goes in without a copy, as does a row-major
//     unembedding (W[k, n] at k * V + n).  Only the columns < vocab are
//     swept: a masked column contributes exp(-1e30 - m) = 0, so skipping
//     them changes nothing.
// Not yet: wgmma, TMA, or a deeper pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;        // 4 warps
constexpr int kTT = 64;              // tokens per block
constexpr int kVT = 64;              // vocab columns per tile
constexpr int kKC = 32;              // depth of one pipeline stage
constexpr int kLDL = kVT + 4;        // row stride of the fp32 logit tile
constexpr float kNeg = -1e30f;       // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Shared-memory geometry of one pipeline stage (elements and bytes).
template <typename TH, typename TW, bool kContig>
struct Geometry {
  static constexpr int EH = 16 / sizeof(TH);    // elements per 16 bytes
  static constexpr int EW = 16 / sizeof(TW);
  static constexpr int LDH = kKC + EH;          // hs[token][k]
  // kContig: ws[n][k] (column-major B); else ws[k][n] (row-major B)
  static constexpr int LDW = kContig ? kKC + EW : kVT + EW;
  static constexpr int H_BYTES = kTT * LDH * sizeof(TH);
  static constexpr int W_BYTES = (kContig ? kVT : kKC) * LDW * sizeof(TW);
  static constexpr int SMEM = 2 * H_BYTES + 2 * W_BYTES
      + kTT * kLDL * 4 + 4 * kTT * 4;           // + logits, m/s/p/labels
  static_assert(H_BYTES % 32 == 0 && W_BYTES % 32 == 0, "alignment");
};

// Issue the cp.async copies of one stage: h[t0:t0+64, k0:k0+32] and
// W[k0:k0+32, c0:c0+64], zero past T, d and V.
template <typename TH, typename TW, bool kContig>
__device__ __forceinline__ void load_stage(TH* hs, TW* ws, const TH* h,
                                           const TW* w, int t0, int c0,
                                           int k0, int T, int d, int V,
                                           long ldw) {
  using Gm = Geometry<TH, TW, kContig>;
  constexpr int HC = kKC / Gm::EH;
  for (int c = threadIdx.x; c < kTT * HC; c += kThreads) {
    const int r = c / HC;
    const int j = (c - r * HC) * Gm::EH;
    const bool ok = t0 + r < T && k0 + j < d;
    cp_async16(hs + r * Gm::LDH + j, ok ? h + (long)(t0 + r) * d + k0 + j : h,
               ok);
  }
  if constexpr (kContig) {
    constexpr int WC = kKC / Gm::EW;
    for (int c = threadIdx.x; c < kVT * WC; c += kThreads) {
      const int n = c / WC;
      const int j = (c - n * WC) * Gm::EW;
      const bool ok = c0 + n < V && k0 + j < d;
      cp_async16(ws + n * Gm::LDW + j,
                 ok ? w + (long)(c0 + n) * ldw + k0 + j : w, ok);
    }
  } else {
    constexpr int WC = kVT / Gm::EW;
    for (int c = threadIdx.x; c < kKC * WC; c += kThreads) {
      const int kk = c / WC;
      const int j = (c - kk * WC) * Gm::EW;
      const bool ok = c0 + j < V && k0 + kk < d;
      cp_async16(ws + kk * Gm::LDW + j,
                 ok ? w + (long)(k0 + kk) * ldw + c0 + j : w, ok);
    }
  }
  cp_async_commit();
}

// lg[0:64, 0:64] = h[t0:t0+64, :] @ W[:, c0:c0+64] in fp32.
template <typename TH, typename TW, bool kContig>
__device__ void tile_logits(const TH* h, const TW* w, char* smem, float* lg,
                            int t0, int c0, int T, int d, int V, long ldw) {
  using Gm = Geometry<TH, TW, kContig>;
  constexpr bool kTensor = std::is_same<TH, __nv_bfloat16>::value &&
                           std::is_same<TW, __nv_bfloat16>::value;
  TH* hs[2] = {reinterpret_cast<TH*>(smem),
               reinterpret_cast<TH*>(smem + Gm::H_BYTES)};
  TW* ws[2] = {reinterpret_cast<TW*>(smem + 2 * Gm::H_BYTES),
               reinterpret_cast<TW*>(smem + 2 * Gm::H_BYTES + Gm::W_BYTES)};
  const int nk = (d + kKC - 1) / kKC;
  const int warp = threadIdx.x / 32;
  load_stage<TH, TW, kContig>(hs[0], ws[0], h, w, t0, c0, 0, T, d, V, ldw);

  if constexpr (kTensor) {
    using BLayout = typename std::conditional<kContig, wmma::col_major,
                                              wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kVT / 16];
#pragma unroll
    for (int j = 0; j < kVT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int kb = 0; kb < nk; ++kb) {
      const int cur = kb & 1;
      if (kb + 1 < nk) {
        load_stage<TH, TW, kContig>(hs[cur ^ 1], ws[cur ^ 1], h, w, t0, c0,
                                    (kb + 1) * kKC, T, d, V, ldw);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        // warp w owns token rows 16w .. 16w+15 of the tile
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, hs[cur] + warp * 16 * Gm::LDH + kk,
                               Gm::LDH);
#pragma unroll
        for (int j = 0; j < kVT / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
              b;
          const TW* bp = kContig ? ws[cur] + j * 16 * Gm::LDW + kk
                                 : ws[cur] + kk * Gm::LDW + j * 16;
          wmma::load_matrix_sync(b, bp, Gm::LDW);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kVT / 16; ++j)
      wmma::store_matrix_sync(lg + warp * 16 * kLDL + j * 16, acc[j], kLDL,
                              wmma::mem_row_major);
  } else {
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
        load_stage<TH, TW, kContig>(hs[cur ^ 1], ws[cur ^ 1], h, w, t0, c0,
                                    (kb + 1) * kKC, T, d, V, ldw);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const TH* hc = hs[cur];
      const TW* wc = ws[cur];
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float av[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          av[a] = to_float(hc[(tr + 16 * a) * Gm::LDH + k]);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          bv[b] = to_float(kContig ? wc[(tc + 8 * b) * Gm::LDW + k]
                                   : wc[k * Gm::LDW + tc + 8 * b]);
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
      for (int b = 0; b < 8; ++b)
        lg[(tr + 16 * a) * kLDL + tc + 8 * b] = acc[a][b];
  }
}

template <typename TH, typename TW, bool kContig>
__global__ void __launch_bounds__(kThreads)
logprob_partial_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                       const int* __restrict__ labels,
                       float* __restrict__ part, int T, int d, int V,
                       int vocab, long ldw, int tiles_per_split,
                       int nsplit) {
  using Gm = Geometry<TH, TW, kContig>;
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
    tile_logits<TH, TW, kContig>(h, w, smem, lg, t0, c0, T, d, V, ldw);
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

template <typename TH, typename TW, bool kContig>
cudaError_t launch(const void* h, const void* w, const void* labels,
                   void* part, void* out, int T, int d, int V, int vocab,
                   long ldw, int tiles_per_split, int nsplit,
                   cudaStream_t stream) {
  using Gm = Geometry<TH, TW, kContig>;
  if (d % Gm::EH != 0 || (kContig ? d % Gm::EW : V % Gm::EW) != 0 ||
      ldw % Gm::EW != 0)
    return cudaErrorInvalidValue;
  auto kernel = logprob_partial_kernel<TH, TW, kContig>;
  if (Gm::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + kTT - 1) / kTT, nsplit);
  kernel<<<grid, kThreads, Gm::SMEM, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w),
      static_cast<const int*>(labels), static_cast<float*>(part), T, d, V,
      vocab, ldw, tiles_per_split, nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  logprob_merge_kernel<<<(T + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), T, nsplit);
  return cudaGetLastError();
}

template <typename TH, typename TW>
cudaError_t launch_layout(int kcontig, const void* h, const void* w,
                          const void* labels, void* part, void* out, int T,
                          int d, int V, int vocab, long ldw,
                          int tiles_per_split, int nsplit, cudaStream_t s) {
  if (kcontig)
    return launch<TH, TW, true>(h, w, labels, part, out, T, d, V, vocab, ldw,
                                tiles_per_split, nsplit, s);
  return launch<TH, TW, false>(h, w, labels, part, out, T, d, V, vocab, ldw,
                               tiles_per_split, nsplit, s);
}

}  // namespace

// h: (T, d) contiguous, hdtype 0 = float32, 1 = bfloat16.  W: (d, V) with
// wdtype 0 = float32, 1 = bfloat16; kcontig = 1: W[k, n] at n * ldw + k
// (a transposed row-major (V, d) matrix), kcontig = 0: W[k, n] at
// k * ldw + n.  labels: (T,) int32.  part: (3, nsplit, T) float32 scratch;
// out: (T,) float32.  The vocabulary's ceil(vocab / 64) tiles are cut into
// nsplit splits of tiles_per_split tiles, none of them empty.  Pointers
// 16-byte aligned, d, ldw (and V when kcontig = 0) multiples of 16 bytes.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int logprob_gather_fwd(const void* h, const void* w,
                                  const void* labels, void* part, void* out,
                                  int T, int d, int V, int vocab,
                                  long long ldw, int kcontig,
                                  int tiles_per_split, int nsplit, int hdtype,
                                  int wdtype, void* stream) {
  const int ntiles = (vocab + kVT - 1) / kVT;
  if (T <= 0 || d <= 0 || V <= 0 || vocab <= 0 || vocab > V ||
      tiles_per_split <= 0 || nsplit <= 0 ||
      (long)nsplit * tiles_per_split < ntiles ||
      (long)(nsplit - 1) * tiles_per_split >= ntiles || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long ld = static_cast<long>(ldw);
  if (hdtype == 1 && wdtype == 1)
    return (int)launch_layout<__nv_bfloat16, __nv_bfloat16>(
        kcontig, h, w, labels, part, out, T, d, V, vocab, ld,
        tiles_per_split, nsplit, s);
  if (hdtype == 0 && wdtype == 1)
    return (int)launch_layout<float, __nv_bfloat16>(
        kcontig, h, w, labels, part, out, T, d, V, vocab, ld,
        tiles_per_split, nsplit, s);
  if (hdtype == 0 && wdtype == 0)
    return (int)launch_layout<float, float>(kcontig, h, w, labels, part, out,
                                            T, d, V, vocab, ld,
                                            tiles_per_split, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
