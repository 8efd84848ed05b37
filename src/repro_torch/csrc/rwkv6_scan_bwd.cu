// Backward of the WKV6 recurrence (the RWKV-6 time-mix inner loop) for
// Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: `rwkv6_scan_pallas`
// (src/repro/kernels/rwkv6_scan.py) is forward-only, and the reference
// trains through the plain scan of `_wkv_scan` (src/repro/models/rwkv.py),
// which XLA differentiates.  The port sends every CUDA tensor to a kernel,
// so a train step of an RWKV model on the card needs this one.  It computes
// the gradients of `rwkv6_scan_plain` (src/repro_torch/kernels/
// rwkv6_scan.py).  Per (batch row, head), with the fp32 state S (hd x hd),
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
// in reverse over t, carrying dS (the cotangent of S_t), which starts from
// the final state's cotangent (zero without one):
//     dr_t = (S_{t-1} + diag(u) k_t v_t^T) dO_t
//     dk_t = dS_t v_t + u * r_t (v_t . dO_t)
//     dv_t = dS_t^T k_t + (sum_k r_t u k_t) dO_t
//     dw_t = rowsum(dS_t * S_{t-1})
//     du  += r_t * k_t (v_t . dO_t)          (per (row, head) partial)
//     dS_{t-1} = r_t dO_t^T + diag(w_t) dS_t
// and the initial state's gradient is dS_0.
//
// What bounds it on an H100: the fp32 operations on the CUDA cores
// (67 TFLOP/s).  Per (row, step, head) the state recompute and the dS update
// take 3 hd^2 each and dr, dk, dv and dw 2 hd^2 each, 14 hd^2 + 16 hd in
// all: 4.8e9 at rwkv6-3b's training shape (B 4, T 512, H 40, hd 64),
// 0.071 ms, against 126 MB moved, 0.038 ms.  The steps are serial, so
// what limits this first kernel is how few threads a step offers.
//
// Design (simple and exact first; no atomics, so two calls are bitwise
// equal).  One block per (row, head), 2 hd threads:
//   * dw_t needs S_{t-1} in reverse order, and S_{t-1} is never rebuilt by
//     dividing by w_t (the model's clamp lets w reach e^-54.6).  A forward
//     sweep writes fp32 checkpoints of S before every kChunk-th step to the
//     scratch `cp` ((B H) x (chunks - 1) x hd x hd fp32: 333 MB at the
//     training shape; the first chunk starts from the initial state).  The
//     reverse sweep then takes the chunks last to first: each recomputes
//     its kChunk states forward from its checkpoint into shared memory and
//     walks them backwards.
//   * The rows of S and of dS evolve independently (w scales a row, k v^T
//     and r dO^T are outer products), so thread i < hd keeps row i of S
//     and of dS in registers and forms dr, dk, dw and du with no exchange;
//     thread hd + j keeps column j of dS, a bitwise twin of the rows'
//     (the same fma per element), and forms dv_t[j] = sum_k dS[k, j] k[k]
//     the same way.  Per step a thread reads its own row from shared memory
//     (rows padded by 4 floats: no bank conflict for float4 reads) and the
//     step's inputs as broadcasts; no barrier runs between steps.
//   * A chunk's r, k, v, w and dO are staged in fp32 by all threads
//     between two block barriers; bf16 inputs are widened there.
//   * Templated on hd in {32, 64}; the wrapper refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4;       // steps per checkpoint and per staged chunk
constexpr int kArrays = 5;      // r, k, v, w, dO
constexpr int kPad = 4;         // floats of padding per state row

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  const float* dout;
  const float* dsT;     // null: no cotangent on the final state
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du;            // (B, H, hd) partials
  float* ds0;
  float* cp;            // (B H, chunks - 1, hd, hd) checkpoints
  int B, T, H;
};

template <int HD>
struct Shape {
  static constexpr int kThreads = 2 * HD;
  static constexpr int kLd = HD + kPad;
  static constexpr int kStageFloats = kChunk * kArrays * HD;
  static constexpr int kSmem =
      (kStageFloats + kChunk * HD * kLd + HD) * (int)sizeof(float);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Steps t0 .. t0 + len - 1 of the arrays in `mask` (bit a: array a of r, k,
// v, w, dO) into st[s][a][0:HD] in fp32, by every thread of the block.
template <typename TIn, int HD>
__device__ __forceinline__ void stage(const Args& a, float* st, size_t base,
                                      size_t step, int t0, int len,
                                      unsigned mask) {
  for (int idx = threadIdx.x; idx < len * kArrays * HD;
       idx += Shape<HD>::kThreads) {
    const int s = idx / (kArrays * HD);
    const int arr = (idx / HD) % kArrays;
    const int e = idx % HD;
    if (!(mask >> arr & 1)) continue;
    const size_t off = base + (size_t)(t0 + s) * step + e;
    float x;
    if (arr == 0) x = to_float(static_cast<const TIn*>(a.r)[off]);
    else if (arr == 1) x = to_float(static_cast<const TIn*>(a.k)[off]);
    else if (arr == 2) x = to_float(static_cast<const TIn*>(a.v)[off]);
    else if (arr == 3) x = a.w[off];
    else x = a.dout[off];
    st[idx] = x;
  }
}

template <int HD>
__device__ __forceinline__ const float* arr_of(const float* st, int s,
                                               int arr) {
  return st + (s * kArrays + arr) * HD;
}

// A row of HD floats between registers (x, indexed only by constants once
// unrolled) and 16-byte aligned memory, four at a time.
template <int HD>
__device__ __forceinline__ void load_row(float* x, const float* p) {
#pragma unroll
  for (int n = 0; n < HD; n += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + n);
    x[n] = f.x;
    x[n + 1] = f.y;
    x[n + 2] = f.z;
    x[n + 3] = f.w;
  }
}
template <int HD>
__device__ __forceinline__ void store_row(float* p, const float* x) {
#pragma unroll
  for (int n = 0; n < HD; n += 4)
    *reinterpret_cast<float4*>(p + n) =
        make_float4(x[n], x[n + 1], x[n + 2], x[n + 3]);
}

// S[n] <- w S[n] + kk v[n] over a row, v from a staged row (broadcast)
template <int HD>
__device__ __forceinline__ void advance(float* S, float ww, float kk,
                                        const float* v) {
#pragma unroll
  for (int n = 0; n < HD; n += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(v + n);
    S[n] = fmaf(ww, S[n], kk * v4.x);
    S[n + 1] = fmaf(ww, S[n + 1], kk * v4.y);
    S[n + 2] = fmaf(ww, S[n + 2], kk * v4.z);
    S[n + 3] = fmaf(ww, S[n + 3], kk * v4.w);
  }
}

template <typename TIn, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
    rwkv6_scan_bwd_kernel(const Args a) {
  using Sh = Shape<HD>;
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                                // [kChunk][5][HD]
  float* sp = st + Sh::kStageFloats;               // [kChunk][HD][kLd]
  float* u_s = sp + kChunk * HD * Sh::kLd;         // [HD]
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.T * a.H + h) * HD;
  const int chunks = (a.T + kChunk - 1) / kChunk;
  const bool row_thread = threadIdx.x < HD;
  const int i = row_thread ? threadIdx.x : threadIdx.x - HD;
  const float* s0 = a.s0 + (size_t)bh * HD * HD;
  float* cp = a.cp + (size_t)bh * (chunks - 1) * HD * HD;
  if (threadIdx.x < HD) u_s[threadIdx.x] = a.u[h * HD + threadIdx.x];

  // forward sweep: checkpoints of S before chunks 1 .. chunks - 1
  float S[HD];
  if (row_thread) {
    load_row<HD>(S, s0 + i * HD);
  }
  for (int c = 0; c + 1 < chunks; ++c) {
    const int t0 = c * kChunk;
    __syncthreads();
    stage<TIn, HD>(a, st, base, step, t0, kChunk, 0b01110);
    __syncthreads();
    if (row_thread) {
      for (int s = 0; s < kChunk; ++s)
        advance<HD>(S, arr_of<HD>(st, s, 3)[i], arr_of<HD>(st, s, 1)[i],
                    arr_of<HD>(st, s, 2));
      store_row<HD>(cp + ((size_t)c * HD + i) * HD, S);
    }
  }

  // reverse sweep: a row (row threads) or a column (the others) of dS
  float dS[HD];
#pragma unroll
  for (int n = 0; n < HD; ++n) {
    const size_t at = row_thread ? (size_t)i * HD + n : (size_t)n * HD + i;
    dS[n] = a.dsT == nullptr ? 0.f : a.dsT[(size_t)bh * HD * HD + at];
  }
  float du = 0.f;
  TIn* dr = static_cast<TIn*>(a.dr);
  TIn* dk = static_cast<TIn*>(a.dk);
  TIn* dv = static_cast<TIn*>(a.dv);
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int len = min(kChunk, a.T - t0);
    __syncthreads();
    stage<TIn, HD>(a, st, base, step, t0, len, 0b11111);
    __syncthreads();
    if (row_thread) {
      // the chunk's states S_{t-1}, recomputed from its checkpoint
      const float* from = c == 0 ? s0 : cp + (size_t)(c - 1) * HD * HD;
      load_row<HD>(S, from + i * HD);
      for (int s = 0; s < len; ++s) {
        store_row<HD>(sp + (s * HD + i) * Sh::kLd, S);
        if (s + 1 < len)
          advance<HD>(S, arr_of<HD>(st, s, 3)[i], arr_of<HD>(st, s, 1)[i],
                      arr_of<HD>(st, s, 2));
      }
      const float uu = u_s[i];
      for (int s = len - 1; s >= 0; --s) {
        const float* v = arr_of<HD>(st, s, 2);
        const float* dO = arr_of<HD>(st, s, 4);
        const float* row = sp + (s * HD + i) * Sh::kLd;
        const float rr = arr_of<HD>(st, s, 0)[i];
        const float kk = arr_of<HD>(st, s, 1)[i];
        const float ww = arr_of<HD>(st, s, 3)[i];
        float vd = 0.f, drs = 0.f, dks = 0.f, dws = 0.f;
#pragma unroll
        for (int n = 0; n < HD; n += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(v + n);
          const float4 o4 = *reinterpret_cast<const float4*>(dO + n);
          const float4 p4 = *reinterpret_cast<const float4*>(row + n);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float oo[4] = {o4.x, o4.y, o4.z, o4.w};
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            vd = fmaf(vv[e], oo[e], vd);
            drs = fmaf(pp[e], oo[e], drs);
            dks = fmaf(dS[n + e], vv[e], dks);
            dws = fmaf(dS[n + e], pp[e], dws);
            dS[n + e] = fmaf(ww, dS[n + e], rr * oo[e]);
          }
        }
        const size_t at = base + (size_t)(t0 + s) * step + i;
        store(dr + at, fmaf(uu * kk, vd, drs));
        store(dk + at, fmaf(uu * rr, vd, dks));
        a.dw[at] = dws;
        du = fmaf(rr * kk, vd, du);
      }
    } else {
      for (int s = len - 1; s >= 0; --s) {
        const float* r = arr_of<HD>(st, s, 0);
        const float* k = arr_of<HD>(st, s, 1);
        const float* w = arr_of<HD>(st, s, 3);
        const float oj = arr_of<HD>(st, s, 4)[i];
        float ruk = 0.f, dvs = 0.f;
#pragma unroll
        for (int n = 0; n < HD; n += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(r + n);
          const float4 k4 = *reinterpret_cast<const float4*>(k + n);
          const float4 w4 = *reinterpret_cast<const float4*>(w + n);
          const float4 u4 = *reinterpret_cast<const float4*>(u_s + n);
          const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
          const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ruk = fmaf(rv[e] * uv[e], kv[e], ruk);
            dvs = fmaf(dS[n + e], kv[e], dvs);
            dS[n + e] = fmaf(wv[e], dS[n + e], rv[e] * oj);
          }
        }
        store(dv + base + (size_t)(t0 + s) * step + i, fmaf(ruk, oj, dvs));
      }
    }
  }
  if (row_thread) {
    store_row<HD>(a.ds0 + ((size_t)bh * HD + i) * HD, dS);
    a.du[(size_t)bh * HD + i] = du;
  }
}

template <typename TIn, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Sh = Shape<HD>;
  auto kernel = rwkv6_scan_bwd_kernel<TIn, HD>;
  if (Sh::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B * a.H, Sh::kThreads, Sh::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_hd(int hd, const Args& a, cudaStream_t stream) {
  if (hd == 32) return launch<TIn, 32>(a, stream);
  if (hd == 64) return launch<TIn, 64>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for r, k, v and dr, dk, dv.
// r, k, v, w, dout, dr, dk, dv, dw: (B, T, H, hd); u: (H, hd); s0, dsT,
// ds0: (B, H, hd, hd); du: (B, H, hd) partials; cp: (B H, ceil(T / 4) - 1,
// hd, hd) fp32 scratch (null when that is 0).  w, u, s0, dout, dsT, dw, du,
// ds0 are float32; everything contiguous and 16-byte aligned; dsT may be
// null (a zero cotangent).  hd is 32 or 64, T >= 1.  Launches one kernel
// on `stream`; returns its cudaError_t (0 = success).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dout, const void* dsT, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* cp, int B, int T, int H,
                              int hd, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (long long)B * H > 2147483647LL ||
      (T > kChunk && cp == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dout = static_cast<const float*>(dout);
  a.dsT = static_cast<const float*>(dsT);
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dw = static_cast<float*>(dw);
  a.du = static_cast<float*>(du);
  a.ds0 = static_cast<float*>(ds0);
  a.cp = static_cast<float*>(cp);
  a.B = B;
  a.T = T;
  a.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_hd<float>(hd, a, s);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
