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
// out_t (B, T, H, hd) fp32 and the final state, to its own buffer or in
// place over the initial state (then only in rows whose `live` flag is
// set; the others keep their state bit for bit).
//
// What bounds it on an H100: 5 hd^2 + 5 hd flops per (row, step, head) on
// the CUDA cores in fp32 (67 TFLOP/s), against r, k, v, w and out moved
// once and the state read and written once.  A decode step (T = 1) is
// bound by the state's bytes; a long sequence (B = 4, T = 1024, H = 40,
// hd = 64) by the flops, 0.051 ms.  But the steps are serial, so what
// limits the kernel is how many independent threads a step offers and how
// little else each thread issues between its multiply-adds.
//
// Design:
//   * A thread keeps a 16 x 4 tile of S in registers: the rows of row
//     group g (quads g, g + 4, g + 8, g + 12) in the four columns
//     4 m .. 4 m + 3, lane 4 m + g of a warp.  Per state element and step
//     it issues three fp32 instructions (k v, the output's multiply-add,
//     the update's); per step it reads r, k and w of its 16 rows and v of
//     its 4 columns from shared memory, about one shared-memory cycle for
//     three multiply-adds.  (A first version with one column a thread
//     read as many words for a quarter of the work and was bound by the
//     shared-memory pipe: 0.45 ms at T = 1024.)  hd threads per (row,
//     head), 64 at hd 64.  The four groups' partial sums are
//     reduce-scattered by three xor shuffles in a fixed order, so lane
//     4 m + g ends with column 4 m + g and a warp writes 32 neighbouring
//     outputs.  The four groups of a warp read four neighbouring 16-byte
//     words of a staged row (no bank conflict).
//   * The scalar sum_k r[k] u[k] k[k] of a step does not depend on the
//     column: the producer computes it once per step.
//   * Staging is warp-specialised.  One producer warp copies kChunk steps
//     of r, k, v and w with cp.async into a ring of kSlots slots of shared
//     memory, kSlots - 1 chunks in flight, widens bf16 once, and signals
//     each slot on an mbarrier; the consumer warps wait on it and release
//     the slot on another.  No block-wide barrier runs after the start;
//     every mbarrier wait traps after 2^24 tries instead of hanging the
//     card.
//   * A decode step (T = 1) needs no ring: rwkv6_step_kernel loads each
//     thread's r, k, w, u and v beside its state tile, all at once, with
//     no shared memory and no barrier, so a call is one round trip for
//     the state and one write of it.
//   * Long sequences are split across blocks.  The grid is (row x head,
//     segment); the host's plan (kernels/rwkv6_scan.py:scan_plan) picks
//     the segments from B, T, H and hd alone.  Segment 0 starts from the
//     initial state, every other from zero, and the producer keeps the
//     segment's decay product D[k] = prod_t w_t[k].  A second kernel,
//     launched as the first one's programmatic dependent, gives each later
//     segment its true starting state by chaining the boundary states in
//     segment order, S_{j+1} = D_j * S_j + S_local_j, and adds
//     (r_t * P_t) . S_j to each of its outputs, P_t the product of the
//     segment's decays before t: per 32-step tile a (32 x hd) by
//     (hd x hd) product from shared memory, 8 steps by 4 columns a
//     thread, with the next tile's r, w and outputs staged by cp.async.
//     Every factor is a product of decays of at most 1: nothing divides
//     by a decay or takes exp(-L).  The orders are fixed and no float
//     atomic is used, so one input gives bitwise one output.
//   * Templated on hd in {32, 64} (the toy models and rwkv6-3b); the
//     wrapper refuses any other.
// Not yet: a backward pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::fence_barrier_init;
using hopper::mbar_arrive;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kGroups = 4;      // lanes sharing one column quad's k-sum
constexpr int kChunk = 8;       // steps per ring slot
constexpr int kSlots = 3;       // ring depth
constexpr int kFixTile = 32;    // steps per fix-up tile
constexpr int kFixStages = 2;   // fix-up tiles staged, 1 in flight

template <typename TIn, int HD>
struct Shape {
  static constexpr int kRows = HD / kGroups;   // state rows per thread
  static constexpr int kConsumers = HD;        // 4 columns x kRows rows each
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  // a slot: the r, k, w, v rows of kChunk steps in fp32, then their
  // u-dots; bf16 inputs land in a raw area first
  static constexpr int kSlotFloats = kChunk * 4 * HD + kChunk;
  static constexpr int kRawBytes =
      sizeof(TIn) == 4 ? 0 : 3 * kChunk * HD * (int)sizeof(TIn);
  static constexpr int kSmem =
      kSlots * (kSlotFloats * 4 + kRawBytes) + 2 * kSlots * 8;
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* out;
  float* sT;               // may equal s0 (in place)
  const uint8_t* live;     // (B,) or null: every row live
  float* part;             // segments > 1: S_local, then D (see below)
  int B, T, H, segs, seg_len;
};

// Row of the state that row register i of group g holds.
__device__ __forceinline__ int row_of(int g, int i) {
  return 4 * (g + kGroups * (i >> 2)) + (i & 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;        // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The scratch of a call with segments > 1: each (row x head, segment)'s
// local final state S_local (hd x hd), then its decay product D (hd).
template <int HD>
__device__ __forceinline__ float* local_state(const Args& a, int bh, int s) {
  return a.part + ((size_t)bh * a.segs + s) * HD * HD;
}
template <int HD>
__device__ __forceinline__ float* decay_product(const Args& a, int bh,
                                                int s) {
  return a.part + (size_t)a.B * a.H * a.segs * HD * HD +
         ((size_t)bh * a.segs + s) * HD;
}

// The state tile of a consumer thread: rows row_of(g, i), columns
// 4 m .. 4 m + 3, from an (hd x hd) row-major block.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(const float* S, int g, int m,
                                          float4* s) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    s[i] = *reinterpret_cast<const float4*>(S + row_of(g, i) * HD + 4 * m);
}
template <int HD, int ROWS>
__device__ __forceinline__ void store_tile(float* S, int g, int m,
                                           const float4* s) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    *reinterpret_cast<float4*>(S + row_of(g, i) * HD + 4 * m) = s[i];
}

// A consumer thread's column quad m and row group g: lane g of the four
// lanes that share column quad m.
__device__ __forceinline__ void place(int tid, int& m, int& g) {
  const int lane = tid & 31;
  m = (tid >> 5) * (32 / kGroups) + lane / kGroups;
  g = lane % kGroups;
}

// Reduce-scatter of the four groups' partial sums of a column quad (y:
// its four columns), in a fixed order: lane g returns the sum of column g
// of the quad, (y0 + y2) + (y1 + y3) in the groups' terms.  (Eight groups
// of 8 rows, twice the warps per row and head, ran faster at one block
// an SM but slower at decode and at the main shapes.)
__device__ __forceinline__ float reduce_scatter(const float* y, int g) {
  static_assert(kGroups == 4, "two exchanges scatter four columns");
  const bool hi = g & 2, mid = g & 1;
  float k0 = hi ? y[2] : y[0];
  float k1 = hi ? y[3] : y[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? y[0] : y[2], 2);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? y[1] : y[3], 2);
  float keep = mid ? k1 : k0;
  keep += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 1);
  return keep;
}

// One row quad of a thread's state tile at one step: its four rows' r, k
// and w, its four columns' v.  Accumulates sum_k r[k] S[k, n] (the state
// before the update) into ya from the quad's even rows and into yb from its
// odd rows (yb may be ya), and updates S[k, n] <- w[k] S[k, n] + k[k] v[n].
__device__ __forceinline__ void update_quad(const float4 rq, const float4 kq,
                                            const float4 wq, const float* v,
                                            float4* s, float* ya, float* yb) {
  const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
  const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
  const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float* y = e & 1 ? yb : ya;
    float4& st = s[e];
    y[0] = fmaf(rr[e], st.x, y[0]);
    st.x = fmaf(ww[e], st.x, kk[e] * v[0]);
    y[1] = fmaf(rr[e], st.y, y[1]);
    st.y = fmaf(ww[e], st.y, kk[e] * v[1]);
    y[2] = fmaf(rr[e], st.z, y[2]);
    st.z = fmaf(ww[e], st.z, kk[e] * v[2]);
    y[3] = fmaf(rr[e], st.w, y[3]);
    st.w = fmaf(ww[e], st.w, kk[e] * v[3]);
  }
}

// One step of a consumer thread over the step's staged r, k, w, v rows:
// updates its state tile and returns its column's sum_k r[k] S[k, n]
// (the state before the update).
template <int HD, int ROWS>
__device__ __forceinline__ float scan_step(const float* row, float4* s,
                                           int m, int g) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* k4 = r4 + HD / 4;
  const float4* w4 = r4 + HD / 2;
  const float4 vq = r4[3 * HD / 4 + m];
  const float v[4] = {vq.x, vq.y, vq.z, vq.w};
  float ya[4] = {0.f, 0.f, 0.f, 0.f}, yb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q)
    update_quad(r4[g + kGroups * q], k4[g + kGroups * q],
                w4[g + kGroups * q], v, s + 4 * q, ya, yb);
  float y[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) y[x] = ya[x] + yb[x];
  return reduce_scatter(y, g);
}

// The producer warp's two halves of chunk c: issue its copies into slot
// c % kSlots (after the consumers released the slot's previous chunk), and,
// once they landed, widen and finish it.
template <typename TIn, int HD>
struct Producer {
  using S = Shape<TIn, HD>;
  static constexpr int VEC = 16 / sizeof(TIn);      // r, k, v per copy
  static constexpr int LPS = HD / VEC;              // copies per step row
  static constexpr int PIECES = kChunk * LPS / 32;  // per lane and array
  static constexpr int LPSW = HD / 4;               // the same for w
  static constexpr int PIECESW = kChunk * LPSW / 32;

  const Args& a;
  float* ring;            // kSlots slots of kSlotFloats
  char* raw;              // kSlots raw areas of kRawBytes
  uint64_t* empty;
  size_t base, step;
  int len, lane;

  __device__ __forceinline__ float* slot(int c) const {
    return ring + (c % kSlots) * S::kSlotFloats;
  }

  __device__ __forceinline__ void issue(int c) const {
    const int chunks = (len + kChunk - 1) / kChunk;
    if (c < chunks) {
      if (c >= kSlots) mbar_wait(&empty[c % kSlots], ((c / kSlots) & 1) ^ 1);
      float* sl = slot(c);
      const TIn* src[3] = {static_cast<const TIn*>(a.r),
                           static_cast<const TIn*>(a.k),
                           static_cast<const TIn*>(a.v)};
      constexpr int kRow[3] = {0, 1, 3};              // r, k, v rows
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        const int p = lane + 32 * q;
        const int js = p / LPS, e = (p % LPS) * VEC;
        const int j = c * kChunk + js;
        const size_t off = base + (size_t)min(j, len - 1) * step + e;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          void* dst = sizeof(TIn) == 4
                          ? static_cast<void*>(sl + (js * 4 + kRow[x]) * HD +
                                               e)
                          : static_cast<void*>(
                                raw + (c % kSlots) * S::kRawBytes +
                                ((x * kChunk + js) * HD + e) * sizeof(TIn));
          cp_async16(dst, src[x] + off, j < len);
        }
      }
#pragma unroll
      for (int q = 0; q < PIECESW; ++q) {
        const int p = lane + 32 * q;
        const int js = p / LPSW, e = (p % LPSW) * 4;
        const int j = c * kChunk + js;
        cp_async16(sl + (js * 4 + 2) * HD + e,
                   a.w + base + (size_t)min(j, len - 1) * step + e, j < len);
      }
    }
    cp_async_commit();                  // one group per chunk, maybe empty
  }

  // Chunk c has landed (this lane's copies): widen r, k and v, compute the
  // steps' u-dots and fold this lane's w into its share of D.
  __device__ __forceinline__ void finish(int c, const float* uu,
                                         float* dp) const {
    float* sl = slot(c);
#pragma unroll
    for (int q = 0; q < PIECES; ++q) {
      const int p = lane + 32 * q;
      const int js = p / LPS, e = (p % LPS) * VEC;
      float fr[VEC], fk[VEC];
      if constexpr (sizeof(TIn) == 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(sl + js * 4 * HD +
                                                           e);
        const float4 k4 =
            *reinterpret_cast<const float4*>(sl + (js * 4 + 1) * HD + e);
        fr[0] = r4.x, fr[1] = r4.y, fr[2] = r4.z, fr[3] = r4.w;
        fk[0] = k4.x, fk[1] = k4.y, fk[2] = k4.z, fk[3] = k4.w;
      } else {
        const char* rw = raw + (c % kSlots) * S::kRawBytes;
        constexpr int kRow[3] = {0, 1, 3};
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(
              rw + ((x * kChunk + js) * HD + e) * 2);
          const uint32_t h[4] = {w4.x, w4.y, w4.z, w4.w};
          float f[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(h[i] << 16);
            f[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
          }
          float* dst = sl + (js * 4 + kRow[x]) * HD + e;
          *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2],
                                                        f[3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(f[4], f[5], f[6], f[7]);
          if (x == 0)
#pragma unroll
            for (int i = 0; i < 8; ++i) fr[i] = f[i];
          if (x == 1)
#pragma unroll
            for (int i = 0; i < 8; ++i) fk[i] = f[i];
        }
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(fr[i] * uu[i], fk[i], dot);
#pragma unroll
      for (int o = 1; o < LPS; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane % LPS == 0) sl[kChunk * 4 * HD + js] = dot;
    }
#pragma unroll
    for (int q = 0; q < PIECESW; ++q) {
      const int p = lane + 32 * q;
      const int js = p / LPSW, e = (p % LPSW) * 4;
      if (c * kChunk + js < len) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(sl + (js * 4 + 2) * HD + e);
        dp[0] *= w4.x;
        dp[1] *= w4.y;
        dp[2] *= w4.z;
        dp[3] *= w4.w;
      }
    }
  }
};

// Grid (B * H, segments), Shape::kThreads threads: the consumers, then
// the producer warp.  Scans one segment and writes its outputs; with one
// segment also the final state, else the segment's local final state.
// The step loop stays rolled: unrolling a chunk's 8 steps took 146
// registers a thread (bf16, hd 64) and ran a T = 1024 call 3% faster,
// above the 128 that keep five blocks on an SM; capped at 128 it spilled
// and ran slower than rolled (PERF.md, section 6).
template <typename TIn, int HD>
__global__ void __launch_bounds__(Shape<TIn, HD>::kThreads)
    rwkv6_scan_kernel(const Args a) {
  using S = Shape<TIn, HD>;
  extern __shared__ __align__(16) char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  char* raw = smem + kSlots * S::kSlotFloats * 4;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(raw + kSlots * S::kRawBytes);
  uint64_t* empty = full + kSlots;
  const int bh = blockIdx.x;
  const int seg = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int t0 = seg * a.seg_len;
  const int len = min(a.seg_len, a.T - t0);
  const int chunks = (len + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], S::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const size_t step = (size_t)a.H * HD;   // elements from t to t + 1
  const size_t base = ((size_t)b * a.T + t0) * step + (size_t)h * HD;
  const int lane = tid & 31;

  if (tid >= S::kConsumers) {             // the producer warp
    using P = Producer<TIn, HD>;
    const P pr{a, ring, raw, empty, base, step, len, lane};
    float uu[P::VEC];
    const int e0 = (lane % P::LPS) * P::VEC;
#pragma unroll
    for (int i = 0; i < P::VEC; ++i) uu[i] = a.u[h * HD + e0 + i];
    float dp[4] = {1.f, 1.f, 1.f, 1.f};   // this lane's share of D
    for (int c = 0; c < kSlots - 1; ++c) pr.issue(c);
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kSlots - 2>();         // chunk c is here
      pr.finish(c, uu, dp);
      mbar_arrive(&full[c % kSlots]);      // release: the slot's stores
      pr.issue(c + kSlots - 1);
    }
    cp_async_wait<0>();
    if (seg > 0) {
      // lanes holding the same elements of other steps, in a fixed order
#pragma unroll
      for (int o = P::LPSW; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[i] *= __shfl_xor_sync(0xffffffffu, dp[i], o);
      if (lane < P::LPSW)
        *reinterpret_cast<float4*>(decay_product<HD>(a, bh, seg) +
                                   (lane % P::LPSW) * 4) =
            make_float4(dp[0], dp[1], dp[2], dp[3]);
    }
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    return;
  }

  int m, g;                                     // column quad, row group
  place(tid, m, g);
  float4 s[S::kRows];
  if (seg == 0) {
    load_tile<HD, S::kRows>(a.s0 + (size_t)bh * HD * HD, g, m, s);
  } else {
#pragma unroll
    for (int i = 0; i < S::kRows; ++i) s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int col = 4 * m + g;                    // its output column
  float* out = a.out + base + col;
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(&full[c % kSlots], (c / kSlots) & 1);
    const float* sl = ring + (c % kSlots) * S::kSlotFloats;
    const int steps = min(kChunk, len - c * kChunk);
    const float* dots = sl + kChunk * 4 * HD;
    float* o = out + (size_t)c * kChunk * step;
    for (int j = 0; j < steps; ++j) {
      const float* row = sl + j * 4 * HD;
      o[(size_t)j * step] = fmaf(dots[j], row[3 * HD + col],
                                 scan_step<HD, S::kRows>(row, s, m, g));
    }
    mbar_arrive(&empty[c % kSlots]);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (a.segs > 1)
    store_tile<HD, S::kRows>(local_state<HD>(a, bh, seg), g, m, s);
  else if (a.live == nullptr || a.live[b])
    store_tile<HD, S::kRows>(a.sT + (size_t)bh * HD * HD, g, m, s);
  // else a frozen row keeps its state
}

// 4 elements of r, k or v (8 or 16 bytes) widened to fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

// Grid (B * H), hd threads: one step (T = 1, a decode step), with no
// staging and no barrier: each thread loads its rows' r, k, w and u and
// its columns' v itself, beside its state tile, all at once.
template <typename TIn, int HD>
__global__ void __launch_bounds__(HD) rwkv6_step_kernel(const Args a) {
  constexpr int kRows = HD / kGroups;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  int m, g;
  place(threadIdx.x, m, g);
  const size_t x0 = (size_t)bh * HD;        // (b, 0, h, 0) at T = 1
  float4 s[kRows];
  load_tile<HD, kRows>(a.s0 + (size_t)bh * HD * HD, g, m, s);
  float4 rq[kRows / 4], kq[kRows / 4], wq[kRows / 4], uq[kRows / 4];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const int k0 = 4 * (g + kGroups * q);
    rq[q] = load4(static_cast<const TIn*>(a.r) + x0 + k0);
    kq[q] = load4(static_cast<const TIn*>(a.k) + x0 + k0);
    wq[q] = __ldg(reinterpret_cast<const float4*>(a.w + x0 + k0));
    uq[q] = __ldg(reinterpret_cast<const float4*>(a.u + h * HD + k0));
  }
  const float4 vq = load4(static_cast<const TIn*>(a.v) + x0 + 4 * m);
  const float v[4] = {vq.x, vq.y, vq.z, vq.w};
  // this group's share of sum_k r u k, times v, opens the output sums
  float dot = 0.f;
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    dot = fmaf(rq[q].x * uq[q].x, kq[q].x, dot);
    dot = fmaf(rq[q].y * uq[q].y, kq[q].y, dot);
    dot = fmaf(rq[q].z * uq[q].z, kq[q].z, dot);
    dot = fmaf(rq[q].w * uq[q].w, kq[q].w, dot);
  }
  float y[4] = {dot * v[0], dot * v[1], dot * v[2], dot * v[3]};
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
    update_quad(rq[q], kq[q], wq[q], v, s + 4 * q, y, y);
  a.out[x0 + 4 * m + g] = reduce_scatter(y, g);
  if (a.live == nullptr || a.live[b])
    store_tile<HD, kRows>(a.sT + (size_t)bh * HD * HD, g, m, s);
}

// A thread's float4s tid, tid + THREADS, ... of an (hd x hd) state.
template <int HD, int NV, int THREADS>
__device__ __forceinline__ void chain_load(const float* S, int tid,
                                           float4* sv) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    sv[i] = reinterpret_cast<const float4*>(S)[tid + i * THREADS];
}
// One link of the boundary-state chain on those float4s:
// S <- D * S + S_local (D per row).
template <int HD, int NV, int THREADS>
__device__ __forceinline__ void chain_link(const float* local,
                                           const float* d, int tid,
                                           float4* sv) {
  float4 l[NV];
  float dk[NV];
  chain_load<HD, NV, THREADS>(local, tid, l);
#pragma unroll
  for (int i = 0; i < NV; ++i) dk[i] = d[(tid + i * THREADS) * 4 / HD];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    sv[i] = make_float4(fmaf(dk[i], sv[i].x, l[i].x),
                        fmaf(dk[i], sv[i].y, l[i].y),
                        fmaf(dk[i], sv[i].z, l[i].z),
                        fmaf(dk[i], sv[i].w, l[i].w));
}

// The fix-up kernel's shared memory: the segment's starting state S_j,
// kFixStages stages of a tile's r (as stored), w and outputs, and the
// tile's r_t * P_t transposed (row k: the tile's steps).
template <typename TIn, int HD>
struct FixShape {
  // a thread: kTS of a tile's steps by 4 columns
  static constexpr int kTS = 8;
  static constexpr int kThreads = HD / 4 * (kFixTile / kTS);
  static constexpr int kQStride = kFixTile + 4;
  static constexpr int kS = HD * HD * 4;
  static constexpr int kR = kFixTile * HD * (int)sizeof(TIn);
  static constexpr int kW = kFixTile * HD * 4;
  static constexpr int kStage = kR + 2 * kW;         // r, w, outputs
  static constexpr int kSmem = kS + kFixStages * kStage + HD * kQStride * 4;
};

// Grid (B * H, segments - 1), FixShape::kThreads threads, for segments
// 1 .. segs - 1: chains the boundary states up to this segment's start,
// S_j, adds (r_t * P_t) . S_j to the segment's outputs, and the last
// segment writes the final state.  Per tile of kFixTile steps the
// product is a (kFixTile x hd) by (hd x hd) matrix product from shared
// memory, each thread kTS steps by 4 columns of it in registers: three
// 16-byte shared loads per 32 multiply-adds (with 2 or 4 steps a thread
// the shared loads bound it).  The tiles' r, w and outputs are staged
// with cp.async, the next tile in flight.
template <typename TIn, int HD>
__global__ void __launch_bounds__(FixShape<TIn, HD>::kThreads)
    rwkv6_scan_fixup_kernel(const Args a) {
  using F = FixShape<TIn, HD>;
  extern __shared__ __align__(16) char smem[];
  float* sj = reinterpret_cast<float*>(smem);                  // [k][n]
  float* qt = reinterpret_cast<float*>(smem + F::kS +
                                       kFixStages * F::kStage);
  const int bh = blockIdx.x;
  const int seg = blockIdx.y + 1;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int t0 = seg * a.seg_len;
  const int len = min(a.seg_len, a.T - t0);
  const int tiles = (len + kFixTile - 1) / kFixTile;
  const int tid = threadIdx.x;
  const int cq = tid % (HD / 4);              // columns 4 cq .. 4 cq + 3
  const int tq = tid / (HD / 4);              // a tile's steps kTS tq ..
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.T + t0) * step + (size_t)h * HD;
  const TIn* r = static_cast<const TIn*>(a.r);

  auto issue = [&](int i) {          // tile i into stage i % kFixStages
    if (i < tiles) {
      char* st = smem + F::kS + (i % kFixStages) * F::kStage;
      constexpr int RV = 16 / sizeof(TIn), RL = HD / RV;
      for (int p = tid; p < kFixTile * RL; p += F::kThreads) {
        const int j = i * kFixTile + p / RL, e = (p % RL) * RV;
        cp_async16(st + ((p / RL) * HD + e) * sizeof(TIn),
                   r + base + (size_t)min(j, len - 1) * step + e, j < len);
      }
      for (int p = tid; p < kFixTile * HD / 4; p += F::kThreads) {
        const int j = i * kFixTile + p / (HD / 4), e = (p % (HD / 4)) * 4;
        const size_t off = base + (size_t)min(j, len - 1) * step + e;
        const int at = ((p / (HD / 4)) * HD + e) * 4;
        cp_async16(st + F::kR + at, a.w + off, j < len);
        cp_async16(st + F::kR + F::kW + at, a.out + off, j < len);
      }
    }
    cp_async_commit();               // one group per tile, maybe empty
  };
  // the scan kernel's outputs, local states and decay products are
  // complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = 0; i < kFixStages - 1; ++i) issue(i);

  // S_seg: segment 0 began from the initial state, so its local final
  // state is S_1; then S_{j+1} = D_j * S_j + S_local_j.  Thread tid
  // keeps the float4s tid, tid + kThreads, ... of the state, every load
  // of a link issued at once
  constexpr int kV = HD * HD / 4 / F::kThreads;  // float4s per thread
  float4 sv[kV];
  chain_load<HD, kV, F::kThreads>(local_state<HD>(a, bh, 0), tid, sv);
  for (int j = 1; j < seg; ++j)
    chain_link<HD, kV, F::kThreads>(local_state<HD>(a, bh, j),
                                    decay_product<HD>(a, bh, j), tid, sv);
#pragma unroll
  for (int i = 0; i < kV; ++i)
    reinterpret_cast<float4*>(sj)[tid + i * F::kThreads] = sv[i];

  float pk = 1.f;                             // thread k < HD: P_t[k]
  for (int i = 0; i < tiles; ++i) {
    issue(i + kFixStages - 1);
    cp_async_wait<kFixStages - 1>();          // tile i is here (this part)
    __syncthreads();                          // ... every part, and S_j
    const char* st = smem + F::kS + (i % kFixStages) * F::kStage;
    const float* ot = reinterpret_cast<const float*>(st + F::kR + F::kW);
    const int n = min(kFixTile, len - i * kFixTile);
    if (tid < HD) {
      const TIn* rt = reinterpret_cast<const TIn*>(st);
      const float* wt = reinterpret_cast<const float*>(st + F::kR);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        qt[tid * F::kQStride + j] = to_float(rt[j * HD + tid]) * pk;
        pk *= wt[j * HD + tid];
      }
#pragma unroll 4
      for (int j = n; j < kFixTile; ++j) qt[tid * F::kQStride + j] = 0.f;
    }
    __syncthreads();
    float acc[F::kTS][4] = {};
#pragma unroll 8
    for (int k = 0; k < HD; ++k) {
      const float* qk = qt + k * F::kQStride + F::kTS * tq;
      float qs[F::kTS];
#pragma unroll
      for (int x = 0; x < F::kTS; x += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qk + x);
        qs[x] = qv.x, qs[x + 1] = qv.y, qs[x + 2] = qv.z, qs[x + 3] = qv.w;
      }
      const float4 sv = *reinterpret_cast<const float4*>(sj + k * HD + 4 * cq);
#pragma unroll
      for (int x = 0; x < F::kTS; ++x) {
        acc[x][0] = fmaf(qs[x], sv.x, acc[x][0]);
        acc[x][1] = fmaf(qs[x], sv.y, acc[x][1]);
        acc[x][2] = fmaf(qs[x], sv.z, acc[x][2]);
        acc[x][3] = fmaf(qs[x], sv.w, acc[x][3]);
      }
    }
#pragma unroll
    for (int x = 0; x < F::kTS; ++x) {
      const int j = F::kTS * tq + x;
      if (j < n) {
        const float4 o =
            *reinterpret_cast<const float4*>(ot + j * HD + 4 * cq);
        *reinterpret_cast<float4*>(a.out + base +
                                   (size_t)(i * kFixTile + j) * step +
                                   4 * cq) =
            make_float4(o.x + acc[x][0], o.y + acc[x][1], o.z + acc[x][2],
                        o.w + acc[x][3]);
      }
    }
    __syncthreads();                          // the stage and qt are free
  }
  if (seg == a.segs - 1 && (a.live == nullptr || a.live[b])) {
    // S_j from shared memory, one more link, out to the final state
    chain_load<HD, kV, F::kThreads>(sj, tid, sv);
    chain_link<HD, kV, F::kThreads>(local_state<HD>(a, bh, seg),
                                    decay_product<HD>(a, bh, seg), tid, sv);
#pragma unroll
    for (int i = 0; i < kV; ++i)
      reinterpret_cast<float4*>(a.sT + (size_t)bh * HD * HD)
          [tid + i * F::kThreads] = sv[i];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename TIn, int HD>
cudaError_t launch_scan(const Args& a, cudaStream_t stream) {
  using S = Shape<TIn, HD>;
  auto kernel = rwkv6_scan_kernel<TIn, HD>;
  const cudaError_t e = allow_smem(kernel, S::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, a.segs), S::kThreads, S::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TIn, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.T == 1) {
    rwkv6_step_kernel<TIn, HD><<<a.B * a.H, HD, 0, stream>>>(a);
    return cudaGetLastError();
  }
  cudaError_t e = launch_scan<TIn, HD>(a, stream);
  if (e != cudaSuccess || a.segs == 1) return e;
  // the fix-up as a programmatic dependent launch: scheduled as the scan
  // grid's last blocks finish, it waits on griddepcontrol.wait before it
  // reads their results
  auto fixup = rwkv6_scan_fixup_kernel<TIn, HD>;
  e = allow_smem(fixup, FixShape<TIn, HD>::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H, a.segs - 1);
  cfg.blockDim = dim3(FixShape<TIn, HD>::kThreads);
  cfg.dynamicSmemBytes = FixShape<TIn, HD>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fixup, a);
}

template <typename TIn>
cudaError_t launch_hd(int hd, const Args& a, cudaStream_t stream) {
  if (hd == 32) return launch<TIn, 32>(a, stream);
  if (hd == 64) return launch<TIn, 64>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v: (B, T, H, hd) contiguous, dtype 0 = float32, 1 = bfloat16.
// w: (B, T, H, hd), u: (H, hd), s0: (B, H, hd, hd), all float32 and
// contiguous; r, k, v, w, s0 and sT 16-byte aligned.  out: (B, T, H, hd)
// float32; sT: (B, H, hd, hd) float32, a buffer apart from s0 or s0
// itself (in place).  live: (B,) bytes, or null; a row whose byte is 0
// keeps its state in sT (with sT = s0, bit for bit).  hd is 32 or 64; T
// may be 0 (sT = s0).  The plan: `segs` segments of `seg_len` steps covering T
// (the last may be shorter, none empty), and with segs > 1 `part`, fp32
// scratch of B * H * segs * (hd * hd + hd) elements.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* out, void* sT, const void* live,
                              void* part, int B, int T, int H, int hd,
                              int dtype, int segs, int seg_len,
                              void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || (long long)B * H > 2147483647LL ||
      segs < 1 || segs > 65535 || seg_len < 0 ||
      (long long)segs * seg_len < T ||
      (T > 0 && (long long)(segs - 1) * seg_len >= T) ||
      (T == 0 && segs != 1) || (segs > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.out = static_cast<float*>(out);
  a.sT = static_cast<float*>(sT);
  a.live = static_cast<const uint8_t*>(live);
  a.part = static_cast<float*>(part);
  a.B = B;
  a.T = T;
  a.H = H;
  a.segs = segs;
  a.seg_len = seg_len;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_hd<float>(hd, a, s);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
