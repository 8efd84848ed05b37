// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py, `_kernel`): one query token per
// request row against K/V page pools shaped (P, ps, KV, hd) of fp32 or
// bf16, gathered through a block table pt (B, nblk1).  Logical block i of
// row b lives in page pt[b, i]; position kpos = i * ps + lane is live iff
// kpos <= pos[b] (and kpos > pos[b] - window for sliding-window layers).
// Stale rows of recycled pages and the trash column are masked, never read
// into the softmax.  Softmax is online, in fp32.
//
// What bounds it on an H100: not the bytes.  Each K/V element feeds
// G = H / KV query heads, two flops each: about 2 * G flops per byte, far
// below the ~295 at which the card stops being memory bound, and a decode
// step's live K/V is small (about 1 MB for 16 rows at ~200 positions, 0.4
// microseconds at 3.35 TB/s).  What sets the time is latency.  The first
// design gave one block per (row, kv head) the whole sweep, with a
// dependent load of the next page id, one page in flight and four block
// barriers per page: 0.047 ms a call at the target's shape, about 3.6
// microseconds a page (H100 80GB HBM3 at 700 W, chip_smoke.py phase 3),
// behind SDPA over pre-gathered K/V (0.026 ms).
//
// What this design does about it (csrc/paged_decode.cuh, shared with the
// quantized kernel):
//   * The sweep is split across blocks: grid B * KV * splits, each split a
//     fixed range of logical blocks chosen on the host from the shapes
//     alone; a second small kernel, launched as the first one's
//     programmatic dependent, merges the partials in split order
//     (deterministic, no atomics).  A row whose live positions lie in one
//     split is written by the split kernel and skipped by the merge.
//   * Each warp reads its page ids once, in flight with pos, and issues
//     all its pages' cp.async copies at once: on the main path every page
//     of a split is in flight together.
//   * Each warp computes its pages alone, with no block barrier per page:
//     bf16 queries over bf16 pages on the tensor cores (mma.sync m16n8k16
//     for Q K^T and P V, operands by ldmatrix, P kept in registers as the
//     reference's bf16), the other instances on the CUDA cores.
// Same machine and script: 0.0109 ms at the target's shape and 0.0165 ms
// with positions up to ~500.  What is left is two launches, two dependent
// loads (pos and page ids, then pages) and the merge's round trip.  Each
// K/V page is read once per (row, kv head), not once per query head as the
// TPU grid (B, H, nblk) does.  Shared memory holds the pages through
// cp.async, not TMA: the pools are fp32 or bf16 at any head_dim that is a
// multiple of 4 (fp32) or 8 (bf16), including the toy models' 16 and 40,
// which hopper::make_tensor_map's 128-byte-swizzled bf16 maps do not
// cover, and a call made thousands of times per engine step pays no
// tensor-map encoding on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"

namespace {

template <typename TQ, typename Pool, int kG, int kQ, bool kMma>
__global__ void __launch_bounds__(paged::kThreads,
                                  paged::min_blocks(kG, kQ, kMma))
paged_attention_kernel(const paged::Args a) {
  paged::split_body<TQ, Pool, kG, kQ, kMma>(a);
}

template <typename TQ>
__global__ void __launch_bounds__(paged::kCombineThreads)
paged_attention_combine_kernel(const paged::Args a) {
  paged::combine_body<TQ>(a);
}

template <typename TQ, typename Pool, int kG>
cudaError_t launch_q(const paged::Args& a, cudaStream_t s) {
  if (a.hd <= 128)
    return paged::launch<Pool, kG>(
        paged_attention_kernel<TQ, Pool, kG, 1, false>,
        paged_attention_combine_kernel<TQ>, a, s);
  return paged::launch<Pool, kG>(
      paged_attention_kernel<TQ, Pool, kG, 2, false>,
      paged_attention_combine_kernel<TQ>, a, s);
}

template <typename TQ, typename Pool>
cudaError_t launch(const paged::Args& a, cudaStream_t s) {
  if (a.G <= 2) return launch_q<TQ, Pool, 2>(a, s);
  if (a.G <= 8) return launch_q<TQ, Pool, 8>(a, s);
  return launch_q<TQ, Pool, 16>(a, s);
}

// bf16 queries over bf16 pools: the tensor-core unit where head_dim is a
// multiple of 16 up to 128 and pages hold 16 or 32 rows (bf16 pages always
// fit shared memory whole, so a unit is a page); the toys' narrower heads
// and head_dim 256 (whose fragments would not fit the registers) take the
// CUDA-core unit
cudaError_t launch_bf16(const paged::Args& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a.hd % 16 != 0 || a.hd > 128 || a.ps % 16 != 0)
    return launch<bf16, paged::Bf16Pool>(a, s);
  if (a.G <= 8)
    return paged::launch<paged::Bf16Pool, 8>(
        paged_attention_kernel<bf16, paged::Bf16Pool, 8, 1, true>,
        paged_attention_combine_kernel<bf16>, a, s);
  return paged::launch<paged::Bf16Pool, 16>(
      paged_attention_kernel<bf16, paged::Bf16Pool, 16, 1, true>,
      paged_attention_combine_kernel<bf16>, a, s);
}

}  // namespace

// dtype: 0 = float32 q and pools, 1 = bfloat16 q and pools, 2 = float32 q
// over bfloat16 pools (K and V widened as read; fp32 output).  q, out:
// (B, 1, H, hd); kp, vp: (P, ps, KV, hd); pt: (B, nblk1) int32; pos: (B,)
// int32; all contiguous, 16-byte aligned, head_dim * the pools' element
// size a multiple of 16 bytes.  splits, bps: the split plan (splits ranges
// of bps logical blocks, bps a multiple of 4 and at most 128, covering
// nblk1); part: fp32 scratch of B * KV * splits * (H / KV) * (hd + 2)
// elements, unused (may be null) when splits == 1.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int paged_attention_fwd(const void* q, const void* kp,
                                   const void* vp, const void* pt,
                                   const void* pos, void* out, void* part,
                                   int B, int H, int KV, int hd, int ps,
                                   int nblk1, int window, float scale,
                                   int splits, int bps, int dtype,
                                   void* stream) {
  paged::Args a{};
  const int esize = dtype == 0 ? 4 : 2;     // the pools' element size
  if (!paged::fill(a, B, H, KV, hd, ps, nblk1, window, scale, splits, bps) ||
      (hd * esize) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.kp = static_cast<const char*>(kp);
  a.vp = static_cast<const char*>(vp);
  a.pt = static_cast<const int*>(pt);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.part = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, paged::F32Pool>(a, s);
  if (dtype == 1) return (int)launch_bf16(a, s);
  if (dtype == 2) return (int)launch<float, paged::Bf16Pool>(a, s);
  return (int)cudaErrorInvalidValue;
}
