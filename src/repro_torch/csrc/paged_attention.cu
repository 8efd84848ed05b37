// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py, `_kernel`): one query token per
// request row against K/V page pools shaped (P, ps, KV, hd), gathered
// through a block table pt (B, nblk1).  Logical block i of row b lives in
// page pt[b, i]; position kpos = i * ps + lane is live iff kpos <= pos[b]
// (and kpos > pos[b] - window for sliding-window layers).  Stale rows of
// recycled pages and the trash column are masked, never read into the
// softmax.  Softmax is online, in fp32.
//
// What bounds it on an H100: the bytes of K/V it reads.  A decode step has
// one query per head, so each K/V element feeds G = H / KV query heads and
// two flops each: about 2 * G flops per byte, far below the ~295 flops per
// byte at which an H100 stops being memory bound.  At decode sizes the
// live K/V is small (about 1 MB for 16 rows at ~200 positions), so in
// practice the serial sweep's latency, not bandwidth, sets the time.
//
// What the design does about that:
//   * One block per (request row, kv head) serves all G query heads of the
//     group, so each K/V page is read from device memory once per group, not
//     once per query head as the TPU grid (B, H, nblk) does.
//   * The block walks its row's logical blocks itself, reading the page id
//     from the table.  Pages are double-buffered in shared memory with
//     16-byte cp.async copies (neighbouring threads on neighbouring
//     addresses): the next page is in flight while this one is computed.
//   * The sweep covers only blocks that hold live positions: it stops after
//     block pos // ps and, with a window, starts at the first block holding
//     pos - window + 1.  Masked positions contribute exactly 0 in the
//     reference, so skipping them changes nothing but the bytes read.
//   * Per page, every (query head, row) score is one thread's dot product
//     (shared-memory rows padded by 16 bytes, so the reads do not
//     conflict), the online softmax is one warp per query head with shuffle
//     reductions, and each thread owns output dims with G independent fp32
//     accumulators in registers.
// Not yet: TMA, wgmma, or splitting a long sweep across blocks.  B * KV
// blocks fill only part of the 132 SMs at decode batch sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;        // query heads per kv head
constexpr int kMaxDimPerThread = 2;  // head_dim <= kThreads * 2
constexpr int kMaxPage = 32;         // rows per page (one warp lane each)
constexpr int kPad = 16;             // bytes of padding per shared row
constexpr float kNeg = -1e30f;       // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying one page's K and V rows of kv head h into kbuf / vbuf
// (row r at r * row_bytes), 16 bytes per thread per step.
template <typename T>
__device__ __forceinline__ void issue_page(char* kbuf, char* vbuf,
                                           const T* kp, const T* vp,
                                           long base, long row_stride, int ps,
                                           int hd, int row_bytes) {
  const int per_row = hd * (int)sizeof(T) / 16;
  const int total = ps * per_row;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int r = c / per_row;
    const int j = (c - r * per_row) * 16;
    const long off = base + r * row_stride;
    cp_async16(kbuf + r * row_bytes + j,
               reinterpret_cast<const char*>(kp + off) + j);
    cp_async16(vbuf + r * row_bytes + j,
               reinterpret_cast<const char*>(vp + off) + j);
  }
  cp_async_commit();
}

// dot(q (fp32, shared), k row (T, shared)), 16-byte reads, four partial sums
template <typename T>
__device__ __forceinline__ float dot_row(const float* q, const char* krow,
                                         int hd) {
  constexpr int N = 16 / sizeof(T);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int d = 0; d < hd; d += N) {
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + d * sizeof(T));
    const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(q + d + e);
      s0 += qq.x * to_float(kv[e]);
      s1 += qq.y * to_float(kv[e + 1]);
      s2 += qq.z * to_float(kv[e + 2]);
      s3 += qq.w * to_float(kv[e + 3]);
    }
  }
  return (s0 + s1) + (s2 + s3);
}

// TQ: the queries' and the output's type; T: the pools' (TQ = float over
// T = bf16 widens K and V to fp32 as they are read, as the reference's
// promotion does; the math is fp32 throughout either way).
template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ pt,
                       const int* __restrict__ pos, TQ* __restrict__ out,
                       int H, int KV, int hd, int ps, int nblk1, int window,
                       float scale) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;            // kv head
  const int G = H / KV;
  const int row_bytes = hd * (int)sizeof(T) + kPad;
  const int page_bytes = ps * row_bytes;
  char* kbuf[2] = {smem, smem + 2 * page_bytes};
  char* vbuf[2] = {smem + page_bytes, smem + 3 * page_bytes};
  float* q_s = reinterpret_cast<float*>(smem + 4 * page_bytes);  // [G][hd]
  float* p_s = q_s + G * hd;           // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;           // [G] running max
  float* l_s = m_s + G;                // [G] running denominator
  float* a_s = l_s + G;                // [G] this page's rescale factor

  const int p = pos[b];
  int last = p / ps;
  if (last > nblk1 - 1) last = nblk1 - 1;
  int first = 0;
  if (window > 0 && p - window + 1 > 0) first = (p - window + 1) / ps;
  if (first > last) first = last;
  const int* table = pt + (long)b * nblk1;
  const long row_stride = (long)KV * hd;   // between rows of one page

  issue_page<T>(kbuf[0], vbuf[0], kp, vp,
                ((long)table[first] * ps * KV + h) * hd, row_stride, ps, hd,
                row_bytes);

  // the group's query heads h*G .. h*G+G-1 are contiguous rows of q[b, 0]
  const TQ* qg = q + ((long)b * H + (long)h * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x)
    q_s[i] = to_float(qg[i]);
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNeg;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kMaxGroup][kMaxDimPerThread];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int k = 0; k < kMaxDimPerThread; ++k) acc[g][k] = 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = first; i <= last; ++i) {
    const int cur = (i - first) & 1;
    if (i < last) {
      issue_page<T>(kbuf[cur ^ 1], vbuf[cur ^ 1], kp, vp,
                    ((long)table[i + 1] * ps * KV + h) * hd, row_stride, ps,
                    hd, row_bytes);
      cp_async_wait<1>();                  // page i landed, i+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: one thread per (query head, page row) pair
    for (int pr = threadIdx.x; pr < G * ps; pr += blockDim.x) {
      const int g = pr / ps;
      const int r = pr - g * ps;
      const int kpos = i * ps + r;
      const bool live = kpos <= p && (window == 0 || kpos > p - window);
      p_s[pr] = live ? dot_row<T>(q_s + g * hd, kbuf[cur] + r * row_bytes,
                                  hd) * scale
                     : kNeg;
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per page row
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < ps ? p_s[g * ps + lane] : kNeg;
      float m_blk = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, m_blk);
      const float e = lane < ps ? expf(s - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < ps) p_s[g * ps + lane] = e;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc[g][d] * alpha[g] + sum_r p[g][r] * v[r][d]
#pragma unroll
    for (int k = 0; k < kMaxDimPerThread; ++k) {
      const int d = threadIdx.x + k * kThreads;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g][k] *= a_s[g];
        for (int r = 0; r < ps; ++r) {
          const float v = to_float(
              reinterpret_cast<const T*>(vbuf[cur] + r * row_bytes)[d]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < G) acc[g][k] += p_s[g * ps + r] * v;
        }
      }
    }
    __syncthreads();                       // buffers and p_s free again
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
#pragma unroll
      for (int k = 0; k < kMaxDimPerThread; ++k) {
        const int d = threadIdx.x + k * kThreads;
        if (d < hd) store(out + ((long)b * H + (long)h * G + g) * hd + d,
                          acc[g][k] * inv);
      }
    }
  }
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pt, const void* pos, void* out, int B, int H,
                   int KV, int hd, int ps, int nblk1, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t row_bytes = hd * sizeof(T) + kPad;
  const size_t smem = 4 * ps * row_bytes
      + sizeof(float) * ((size_t)G * hd + (size_t)G * ps + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, KV);
  paged_attention_kernel<TQ, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<TQ*>(out), H, KV, hd, ps,
      nblk1, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 q and pools, 1 = bfloat16 q and pools, 2 = float32 q
// over bfloat16 pools (K and V widened as read; fp32 output).  q, out:
// (B, 1, H, hd); kp, vp: (P, ps, KV, hd); pt: (B, nblk1) int32; pos: (B,)
// int32; all contiguous, 16-byte aligned, head_dim * the pools' element
// size a multiple of 16 bytes.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_fwd(const void* q, const void* kp,
                                   const void* vp, const void* pt,
                                   const void* pos, void* out, int B, int H,
                                   int KV, int hd, int ps, int nblk1,
                                   int window, float scale, int dtype,
                                   void* stream) {
  const int esize = dtype == 0 ? 4 : 2;     // the pools' element size
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || hd <= 0 ||
      hd > kThreads * kMaxDimPerThread || (hd * esize) % 16 != 0 ||
      ps <= 0 || ps > kMaxPage || nblk1 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, float>(q, kp, vp, pt, pos, out, B, H, KV, hd,
                                     ps, nblk1, window, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, pt, pos, out, B, H, KV, hd, ps, nblk1, window, scale, s);
  if (dtype == 2)
    return (int)launch<float, __nv_bfloat16>(q, kp, vp, pt, pos, out, B, H,
                                             KV, hd, ps, nblk1, window,
                                             scale, s);
  return (int)cudaErrorInvalidValue;
}
