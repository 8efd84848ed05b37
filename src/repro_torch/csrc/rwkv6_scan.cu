// WKV6 recurrence (the RWKV-6 time-mix inner loop) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel `rwkv6_scan_pallas`
// (src/repro/kernels/rwkv6_scan.py, `_kernel`).  For each (batch row b,
// head h), with an fp32 state S of shape hd x hd, at every step t:
//     out_t[n] = sum_k r_t[k] * (S[k, n] + u[k] * k_t[k] * v_t[n])
//     S[k, n] <- w_t[k] * S[k, n] + k_t[k] * v_t[n]
// r, k, v: (B, T, H, hd) in bf16 or fp32; w: (B, T, H, hd) fp32 decays;
// u: (H, hd) fp32; the initial state (B, H, hd, hd) fp32.  Writes every
// out_t (B, T, H, hd) fp32 and the final state to its own buffer.
//
// What bounds it on an H100: the recurrence does four multiply-adds per
// state element per step, 8 * B * T * H * hd^2 flops on the CUDA cores in
// fp32 (67 TFLOP/s), against r, k, v, w and out moved once and the state
// read and written once.  A decode step (T = 1) is bound by the state's
// bytes; a long sequence (B = 4, T = 1024, H = 40, hd = 64) by the flops,
// 5.4 GFLOP or 0.080 ms.  But the steps are serial: a block can only run
// B * H * hd independent columns of the state, 10,240 threads at that
// shape, about two warps per SM, so the kernel is latency-bound far above
// its bound at long T.
//
// Design:
//   * The TPU grid (B * H, T / C) keeps S in VMEM scratch across a
//     sequential chunk axis and pads T to the chunk (w = 1, k = 0).  Here
//     one block per (b, h) loops over T itself with hd threads, and
//     thread n keeps column n of S in hd fp32 registers: the sum over k is
//     serial in one thread and needs no shuffles, and no padding exists.
//   * r, k, w and v of a run of kChunk steps are staged into shared
//     memory (thread n loads element n of each step: coalesced), so the
//     block syncs twice per chunk, not per step.  Every thread reads
//     r, k and w of a step as broadcast float4s; v_t[n] is its own.
//   * u is loaded into registers once.  The output sum runs in four
//     independent accumulators, so its dependent chain is hd / 4 long.
//   * Templated on hd in {32, 64} (the toy models and rwkv6-3b); the
//     wrapper refuses any other.
// Not yet: splitting the k sum over threads for more parallelism than
// B * H * hd, a cp.async / TMA stage that loads the next chunk while the
// current one runs, or a backward pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;           // steps staged per __syncthreads pair

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TIn, int HD>
__global__ void __launch_bounds__(HD)
    rwkv6_scan_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k,
                      const TIn* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ out,
                      float* __restrict__ sT, int T, int H) {
  __shared__ __align__(16) float rs[kChunk][HD];
  __shared__ __align__(16) float ks[kChunk][HD];
  __shared__ __align__(16) float ws[kChunk][HD];
  __shared__ float vs[kChunk][HD];
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int n = threadIdx.x;                 // this thread's state column

  float s[HD];                               // S[:, n]
  float uu[HD];
  const float* s_in = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    s[i] = s_in[i * HD + n];
    uu[i] = u[h * HD + i];
  }

  const size_t step = (size_t)H * HD;        // elements from t to t + 1
  const size_t base = (size_t)b * T * step + (size_t)h * HD + n;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int c = min(kChunk, T - t0);
    __syncthreads();                         // the previous chunk is used up
#pragma unroll 4
    for (int j = 0; j < c; ++j) {
      const size_t off = base + (size_t)(t0 + j) * step;
      rs[j][n] = to_float(r[off]);
      ks[j][n] = to_float(k[off]);
      vs[j][n] = to_float(v[off]);
      ws[j][n] = w[off];
    }
    __syncthreads();
    for (int j = 0; j < c; ++j) {
      const float vt = vs[j][n];
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[j][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[j][i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = kk[q] * vt;
          y[q] = fmaf(rr[q], fmaf(uu[i + q], kv, s[i + q]), y[q]);
          s[i + q] = fmaf(ww[q], s[i + q], kv);
        }
      }
      out[base + (size_t)(t0 + j) * step] = (y[0] + y[1]) + (y[2] + y[3]);
    }
  }
  float* s_out = sT + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[i * HD + n] = s[i];
}

template <typename TIn, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* out,
                   void* sT, int B, int T, int H, cudaStream_t s) {
  rwkv6_scan_kernel<TIn, HD><<<B * H, HD, 0, s>>>(
      static_cast<const TIn*>(r), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), T, H);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_hd(int hd, const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0,
                      void* out, void* sT, int B, int T, int H,
                      cudaStream_t s) {
  if (hd == 32)
    return launch<TIn, 32>(r, k, v, w, u, s0, out, sT, B, T, H, s);
  if (hd == 64)
    return launch<TIn, 64>(r, k, v, w, u, s0, out, sT, B, T, H, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v: (B, T, H, hd) contiguous, dtype 0 = float32, 1 = bfloat16.
// w: (B, T, H, hd), u: (H, hd), s0: (B, H, hd, hd), all float32 and
// contiguous.  out: (B, T, H, hd) float32; sT: (B, H, hd, hd) float32, a
// buffer apart from s0.  hd is 32 or 64; T may be 0 (sT = s0).  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* out, void* sT, int B, int T, int H,
                              int hd, int dtype, void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, r, k, v, w, u, s0, out, sT, B, T, H, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, out, sT, B,
                                         T, H, s);
  return (int)cudaErrorInvalidValue;
}
