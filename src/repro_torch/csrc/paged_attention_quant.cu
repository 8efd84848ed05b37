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
// What bounds it on an H100: as for csrc/paged_attention.cu, latency, not
// bytes: it reads one byte per code (half the bf16 kernel's) plus two
// scales per page.  The first design had one more round trip per page than
// the bf16 kernel: thread 0 loaded the page's two scales with plain loads
// when it issued the page, so the kernel that reads half the bytes was the
// slower one (0.058 against 0.047 ms at the target's shape, H100 80GB HBM3
// at 700 W, chip_smoke.py phase 3).
//
// What this design does about it: the split-and-combine structure of
// csrc/paged_decode.cuh, shared with the bf16 kernel, over codes, on the
// CUDA cores (P stays fp32, as in the reference): 0.0136 ms at the target's
// shape and 0.0183 ms with positions up to ~500, same machine and script.
//   * Lane k of each warp loads the page id of the warp's k-th block once,
//     at the start, and then that page's K and V scales; the scale loads
//     are in flight beside the warp's cp.async copies of the codes, never a
//     blocking load per page, and reach the other lanes by shuffle.
//   * Dequantization is fused: each code widens to fp32 in registers; the K
//     scale multiplies the score (scale * ks), the V scale the probability
//     that weighs the row, so no fp copy of a page is written anywhere.
//   * Codes come through cp.async in 16-byte copies, or 8 or 4 bytes for a
//     head_dim that 16 does not divide (the toys' 40 and 8): no TMA map
//     covers byte rows of 8 or 40.
// Code types: int8_t, and fp8-e4m3 passed as its storage bytes and widened
// through __nv_fp8_e4m3 (<cuda_fp8.h>).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"

namespace {

template <typename TQ, typename Pool, int kG, int kQ, bool kMma>
__global__ void __launch_bounds__(paged::kThreads,
                                  paged::min_blocks(kG, kQ, kMma))
paged_attention_quant_kernel(const paged::Args a) {
  paged::split_body<TQ, Pool, kG, kQ, kMma>(a);
}

template <typename TQ>
__global__ void __launch_bounds__(paged::kCombineThreads)
paged_attention_quant_combine_kernel(const paged::Args a) {
  paged::combine_body<TQ>(a);
}

template <typename TQ, typename Pool, int kG>
cudaError_t launch_q(const paged::Args& a, cudaStream_t s) {
  if (a.hd <= 128)
    return paged::launch<Pool, kG>(
        paged_attention_quant_kernel<TQ, Pool, kG, 1, false>,
        paged_attention_quant_combine_kernel<TQ>, a, s);
  return paged::launch<Pool, kG>(
      paged_attention_quant_kernel<TQ, Pool, kG, 2, false>,
      paged_attention_quant_combine_kernel<TQ>, a, s);
}

template <typename TQ, typename Pool>
cudaError_t launch_g(const paged::Args& a, cudaStream_t s) {
  if (a.G <= 2) return launch_q<TQ, Pool, 2>(a, s);
  if (a.G <= 8) return launch_q<TQ, Pool, 8>(a, s);
  return launch_q<TQ, Pool, 16>(a, s);
}

template <typename TQ>
cudaError_t launch_codes(int code, const paged::Args& a, cudaStream_t s) {
  if (code == 0) return launch_g<TQ, paged::Int8Pool>(a, s);
  if (code == 1) return launch_g<TQ, paged::Fp8Pool>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16.  code (kp, vp): 0 = int8,
// 1 = float8_e4m3fn, passed as bytes.  q, out: (B, 1, H, hd); kp, vp:
// (P, ps, KV, hd); ks, vs: (P, KV) float32; pt: (B, nblk1) int32; pos: (B,)
// int32; all contiguous, 16-byte aligned, head_dim a multiple of 4.
// splits, bps, part: the split plan and its fp32 scratch, as for
// paged_attention_fwd.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int paged_attention_quant_fwd(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* pt,
                                         const void* pos, void* out,
                                         void* part, int B, int H, int KV,
                                         int hd, int ps, int nblk1,
                                         int window, float scale, int splits,
                                         int bps, int dtype, int code,
                                         void* stream) {
  paged::Args a{};
  if (!paged::fill(a, B, H, KV, hd, ps, nblk1, window, scale, splits, bps))
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.kp = static_cast<const char*>(kp);
  a.vp = static_cast<const char*>(vp);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.pt = static_cast<const int*>(pt);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.part = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_codes<float>(code, a, s);
  if (dtype == 1) return (int)launch_codes<__nv_bfloat16>(code, a, s);
  return (int)cudaErrorInvalidValue;
}
