// Quantized paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_attention_quant_pallas`
// (src/repro/kernels/paged_attention.py, `_quant_kernel`): one query token
// per request row against K/V page pools of int8 or fp8-e4m3 codes shaped
// (P, ps, KV, hd), with one fp32 scale per (page, kv head) in ks / vs
// (P, KV), gathered through a block table pt (B, nblk1).  Element
// (page, r, h, d) dequantizes to code * ks[page, h] (vs for V).  Logical
// block i of row b lives in page pt[b, i]; position kpos = i * ps + lane is
// live iff kpos <= pos[b] (and kpos > pos[b] - window for sliding-window
// layers).  Stale rows of recycled pages and the trash column are masked,
// never read into the softmax.  Softmax is online, in fp32.
//
// What bounds it on an H100: the bytes of codes it reads, one byte per
// element (half the bf16 kernel's), plus two scales per page.  As in
// csrc/paged_attention.cu, each code feeds G = H / KV query heads and two
// flops each, far below the ~295 flops per byte at which an H100 stops
// being memory bound; at decode sizes the serial sweep's latency sets the
// time in practice.
//
// Design: the structure of csrc/paged_attention.cu, over codes.
//   * One block per (request row, kv head) serves the group's G query
//     heads, so each page of codes is read once per group.
//   * The block walks its row's live logical blocks (up to block pos // ps,
//     from the first block the window reaches), reading the page id from
//     the table.  Pages of codes are double-buffered in shared memory with
//     cp.async copies of 16 bytes (8 or 4 for a head_dim that 16 does not
//     divide); thread 0 loads the page's two scales into shared memory with
//     the same issue, once per (block, page).
//   * Dequantization is fused before each product: every code is widened
//     to fp32 and multiplied by its page scale in registers, and no fp copy
//     of a page is written anywhere.  One thread per (query head, page row)
//     score, one warp per query head for the softmax, G fp32 accumulators
//     per output dim in registers.
// Code types: int8_t, and fp8-e4m3 passed as its storage bytes and widened
// through __nv_fp8_e4m3 (<cuda_fp8.h>).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
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

// Widening of one stored code byte.
struct Int8Code {
  __device__ __forceinline__ static float decode(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(b));
  }
};
struct Fp8Code {
  __device__ __forceinline__ static float decode(uint8_t b) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  }
};

// Asynchronous copy of `bytes` (4, 8 or 16; uniform across the block).
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying one page's K and V code rows of kv head h into kbuf / vbuf
// (row r at r * row_bytes) in chunks of `chunk` bytes, the largest of 16, 8
// and 4 that divides head_dim; thread 0 loads the page's K and V scales
// into sc[0], sc[1].
__device__ __forceinline__ void issue_page(char* kbuf, char* vbuf, float* sc,
                                           const uint8_t* kp,
                                           const uint8_t* vp,
                                           const float* ks, const float* vs,
                                           int page, int h, int KV, int ps,
                                           int hd, int row_bytes, int chunk) {
  const long base = ((long)page * ps * KV + h) * hd;
  const long row_stride = (long)KV * hd;
  const int per_row = hd / chunk;
  const int total = ps * per_row;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int r = c / per_row;
    const int j = (c - r * per_row) * chunk;
    const long off = base + r * row_stride + j;
    cp_async(kbuf + r * row_bytes + j, kp + off, chunk);
    cp_async(vbuf + r * row_bytes + j, vp + off, chunk);
  }
  cp_async_commit();
  if (threadIdx.x == 0) {
    sc[0] = ks[(long)page * KV + h];
    sc[1] = vs[(long)page * KV + h];
  }
}

// dot(q (fp32, shared), code row * ksc): 16 codes per read, four partial
// sums, then the tail of head_dim 4 codes per read (rows 16-byte aligned)
template <typename Code>
__device__ __forceinline__ float dot_row(const float* q, const char* krow,
                                         float ksc, int hd) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = 0;
  for (; d + 16 <= hd; d += 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
    const uint8_t* kv = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(q + d + e);
      s0 += qq.x * (Code::decode(kv[e]) * ksc);
      s1 += qq.y * (Code::decode(kv[e + 1]) * ksc);
      s2 += qq.z * (Code::decode(kv[e + 2]) * ksc);
      s3 += qq.w * (Code::decode(kv[e + 3]) * ksc);
    }
  }
  for (; d < hd; d += 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(krow + d);
    const uint8_t* kv = reinterpret_cast<const uint8_t*>(&raw);
    s0 += q[d] * (Code::decode(kv[0]) * ksc);
    s1 += q[d + 1] * (Code::decode(kv[1]) * ksc);
    s2 += q[d + 2] * (Code::decode(kv[2]) * ksc);
    s3 += q[d + 3] * (Code::decode(kv[3]) * ksc);
  }
  return (s0 + s1) + (s2 + s3);
}

template <typename T, typename Code>
__global__ void __launch_bounds__(kThreads)
paged_attention_quant_kernel(const T* __restrict__ q,
                             const uint8_t* __restrict__ kp,
                             const uint8_t* __restrict__ vp,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs,
                             const int* __restrict__ pt,
                             const int* __restrict__ pos, T* __restrict__ out,
                             int H, int KV, int hd, int ps, int nblk1,
                             int window, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;            // kv head
  const int G = H / KV;
  // one byte per code; rows padded to 16-byte multiples
  const int row_bytes = (hd + 15) / 16 * 16 + kPad;
  const int page_bytes = ps * row_bytes;
  const int chunk = hd % 16 == 0 ? 16 : hd % 8 == 0 ? 8 : 4;
  char* kbuf[2] = {smem, smem + 2 * page_bytes};
  char* vbuf[2] = {smem + page_bytes, smem + 3 * page_bytes};
  float* q_s = reinterpret_cast<float*>(smem + 4 * page_bytes);  // [G][hd]
  float* p_s = q_s + G * hd;           // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;           // [G] running max
  float* l_s = m_s + G;                // [G] running denominator
  float* a_s = l_s + G;                // [G] this page's rescale factor
  float* sc_s = a_s + G;               // [2][2] (k, v) scale per buffer

  const int p = pos[b];
  int last = p / ps;
  if (last > nblk1 - 1) last = nblk1 - 1;
  int first = 0;
  if (window > 0 && p - window + 1 > 0) first = (p - window + 1) / ps;
  if (first > last) first = last;
  const int* table = pt + (long)b * nblk1;

  issue_page(kbuf[0], vbuf[0], sc_s, kp, vp, ks, vs, table[first], h, KV, ps,
             hd, row_bytes, chunk);

  // the group's query heads h*G .. h*G+G-1 are contiguous rows of q[b, 0]
  const T* qg = q + ((long)b * H + (long)h * G) * hd;
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
      issue_page(kbuf[cur ^ 1], vbuf[cur ^ 1], sc_s + 2 * (cur ^ 1), kp, vp,
                 ks, vs, table[i + 1], h, KV, ps, hd, row_bytes, chunk);
      cp_async_wait<1>();                  // page i landed, i+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float ksc = sc_s[2 * cur];
    const float vsc = sc_s[2 * cur + 1];

    // scores: one thread per (query head, page row) pair
    for (int pr = threadIdx.x; pr < G * ps; pr += blockDim.x) {
      const int g = pr / ps;
      const int r = pr - g * ps;
      const int kpos = i * ps + r;
      const bool live = kpos <= p && (window == 0 || kpos > p - window);
      p_s[pr] = live ? dot_row<Code>(q_s + g * hd, kbuf[cur] + r * row_bytes,
                                     ksc, hd) * scale
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

    // acc[g][d] = acc[g][d] * alpha[g] + sum_r p[g][r] * (v[r][d] * vsc)
#pragma unroll
    for (int k = 0; k < kMaxDimPerThread; ++k) {
      const int d = threadIdx.x + k * kThreads;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g][k] *= a_s[g];
        for (int r = 0; r < ps; ++r) {
          const float v = Code::decode(static_cast<uint8_t>(
                              vbuf[cur][r * row_bytes + d])) * vsc;
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < G) acc[g][k] += p_s[g * ps + r] * v;
        }
      }
    }
    __syncthreads();                       // buffers, scales, p_s free again
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

template <typename T, typename Code>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* pt,
                   const void* pos, void* out, int B, int H, int KV, int hd,
                   int ps, int nblk1, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t row_bytes = (hd + 15) / 16 * 16 + kPad;
  const size_t smem = 4 * ps * row_bytes
      + sizeof(float) * ((size_t)G * hd + (size_t)G * ps + 3 * (size_t)G + 4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_quant_kernel<T, Code>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, KV);
  paged_attention_quant_kernel<T, Code><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(kp),
      static_cast<const uint8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<T*>(out), H, KV, hd, ps,
      nblk1, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_codes(int code, const void* q, const void* kp,
                         const void* vp, const void* ks, const void* vs,
                         const void* pt, const void* pos, void* out, int B,
                         int H, int KV, int hd, int ps, int nblk1, int window,
                         float scale, cudaStream_t s) {
  if (code == 0)
    return launch<T, Int8Code>(q, kp, vp, ks, vs, pt, pos, out, B, H, KV, hd,
                               ps, nblk1, window, scale, s);
  if (code == 1)
    return launch<T, Fp8Code>(q, kp, vp, ks, vs, pt, pos, out, B, H, KV, hd,
                              ps, nblk1, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16.  code (kp, vp): 0 = int8,
// 1 = float8_e4m3fn, passed as bytes.  q, out: (B, 1, H, hd); kp, vp:
// (P, ps, KV, hd); ks, vs: (P, KV) float32; pt: (B, nblk1) int32; pos: (B,)
// int32; all contiguous, 16-byte aligned, head_dim a multiple of 4.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_quant_fwd(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* pt,
                                         const void* pos, void* out, int B,
                                         int H, int KV, int hd, int ps,
                                         int nblk1, int window, float scale,
                                         int dtype, int code, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || hd <= 0 ||
      hd > kThreads * kMaxDimPerThread || hd % 4 != 0 || ps <= 0 ||
      ps > kMaxPage || nblk1 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_codes<float>(code, q, kp, vp, ks, vs, pt, pos, out, B,
                                    H, KV, hd, ps, nblk1, window, scale, s);
  if (dtype == 1)
    return (int)launch_codes<__nv_bfloat16>(code, q, kp, vp, ks, vs, pt, pos,
                                            out, B, H, KV, hd, ps, nblk1,
                                            window, scale, s);
  return (int)cudaErrorInvalidValue;
}
