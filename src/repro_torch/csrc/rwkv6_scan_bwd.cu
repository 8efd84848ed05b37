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
// 0.071 ms, against 126 MB moved, 0.038 ms.
//
// Design (no atomics and fixed summation orders, so two calls are bitwise
// equal):
//   * Every element of S and of dS is a chain of its own (w scales a row,
//     k v^T and r dO^T are outer products), so a head spreads over many
//     threads: hd^2 / 16 of them (256 at hd 64), each keeping a 4 x 4 tile
//     of S and of dS, kept once.  A block holds 32 rows of a head (2 hd
//     threads: warp cg has columns 16 cg .. + 15, lane 4 rq + cq the tile
//     at rows 4 rq .., columns 16 cg + 4 cq ..), and the hd / 32 blocks of
//     a head form a cluster: at hd 64, 320 blocks of 128 threads for
//     rwkv6-3b's 160 (row, head) pairs, three a SM, where one block a pair
//     left 28 of the 132 SMs with two heads.
//   * Reductions: a thread sums its tile's 4 columns (dr, dk, dw) and 4
//     rows (dv) in registers; rows are reduce-scattered over the 4 lanes of
//     a row quad and columns over the 8 lanes of a column quad by xor
//     shuffles in a fixed order, so each lane ends with one row's
//     (dk, dw, dr) and every other lane with one column's dv over the
//     block's 32 rows.  Those go to shared memory, and once per sub-chunk
//     of kSub steps, after one cluster barrier, the 4 column groups
//     (rows) are summed, and each block sums its 32 columns' dv over the
//     cluster's blocks, reading the other block's partials through
//     distributed shared memory, in rank order.  The u
//     terms ride on the same sums as per-thread partials: with
//     vd_p = v_t . dO_t over the thread's 4 columns, dk gets u r vd_p, dr
//     gets u k vd_p and du r k vd_p, summed over the column groups with
//     the rest; dv gets (sum over the thread's rows of r u k) dO_t, summed
//     over the rows.
//   * S_{t-1} is needed in reverse order and is never rebuilt by dividing
//     by w (which can reach e^-54.6).  A forward sweep, states only, writes
//     fp32 checkpoints of S before every kSeg-th step to the scratch `cp`
//     ((B H) x (segments - 1) x hd x hd fp32: 81.3 MB at the training
//     shape).  The reverse sweep takes the segments last to first: it
//     recomputes a segment's states from its checkpoint, keeping the start
//     of each kSub-step sub-chunk in shared memory (each thread its own
//     tile, no barrier), then per sub-chunk, last to first, recomputes its
//     kSub states into registers and walks them backwards, every product
//     of the step (dk, dv, dw, dr, the dS update) from the same registers.
//     Full sub-chunks run as straight-line code.
//   * r, k, v, w and dO reach shared memory a segment at a time through
//     cp.async issued by every thread one segment ahead, into a ring of 2
//     slots (bf16 stays bf16 there and is widened on use); the wait rides
//     on the barrier that ends the segment before.
//   * Templated on hd in {32, 64} (one block a head at 32); the wrapper
//     refuses any other.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kSeg = 16;        // steps per checkpoint (segment)
constexpr int kSub = 4;         // steps per sub-chunk, held in registers
constexpr int kRows = 32;       // rows of the state a block holds
constexpr unsigned kFull = 0xffffffffu;

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
  float* cp;            // (B H, segments - 1, hd, hd) checkpoints
  int B, T, H;
};

template <typename TIn, int HD>
struct Shape {
  static constexpr int kCluster = HD / kRows;       // blocks of a head
  static constexpr int kThreads = kRows * HD / 16;  // a 4 x 4 tile a thread
  static constexpr int kCG = HD / 16;               // column groups = warps
  // one staged segment: r, k, v [kSeg][HD] in TIn, then w, dO in fp32
  static constexpr int kIn = kSeg * HD * (int)sizeof(TIn);
  static constexpr int kF = kSeg * HD * 4;
  static constexpr int kSlot = 3 * kIn + 2 * kF;
  // sub-chunk starts [kSeg / kSub - 1][4][threads] float4
  static constexpr int kStarts = 2 * kSlot;
  static constexpr int kRow =                // [2][kSub][CG][kRows] float4
      kStarts + (kSeg / kSub - 1) * 4 * kThreads * 16;
  static constexpr int kCol = kRow + 2 * kSub * kCG * kRows * 16;
  static constexpr int kSmem = kCol + 2 * kSub * HD * 4;  // [2][kSub][HD]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// four neighbouring values, widened to fp32
__device__ __forceinline__ void ld4(float* x, const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void ld4(float* x, const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// One staged segment in shared memory.
template <typename TIn, int HD>
struct Slot {
  const TIn* r;
  const TIn* k;
  const TIn* v;
  const float* w;
  const float* o;
  __device__ __forceinline__ explicit Slot(const char* base)
      : r(reinterpret_cast<const TIn*>(base)),
        k(reinterpret_cast<const TIn*>(base + Shape<TIn, HD>::kIn)),
        v(reinterpret_cast<const TIn*>(base + 2 * Shape<TIn, HD>::kIn)),
        w(reinterpret_cast<const float*>(base + 3 * Shape<TIn, HD>::kIn)),
        o(reinterpret_cast<const float*>(base + 3 * Shape<TIn, HD>::kIn +
                                         Shape<TIn, HD>::kF)) {}
};

// Steps t0 .. t0 + len - 1 of r, k, v, w and dO into a slot, 16 bytes a
// cp.async, by every thread of the block (one commit group a segment).
template <typename TIn, int HD>
__device__ __forceinline__ void stage(const Args& a, char* slot, size_t base,
                                      size_t step, int t0, int len) {
  using Sh = Shape<TIn, HD>;
  constexpr int cIn = HD * (int)sizeof(TIn) / 16, cF = HD * 4 / 16;
  constexpr int per = 3 * cIn + 2 * cF;
  for (int i = threadIdx.x; i < len * per; i += Sh::kThreads) {
    const int s = i / per;
    int c = i - s * per;
    const size_t off = base + (size_t)(t0 + s) * step;
    if (c < 3 * cIn) {
      const int arr = c / cIn;
      c -= arr * cIn;
      const TIn* src = static_cast<const TIn*>(arr == 0 ? a.r
                                               : arr == 1 ? a.k : a.v);
      cp_async16(slot + arr * Sh::kIn + (s * HD) * (int)sizeof(TIn) + c * 16,
                 reinterpret_cast<const char*>(src + off) + c * 16);
    } else {
      c -= 3 * cIn;
      const int arr = c / cF;
      c -= arr * cF;
      const float* src = arr == 0 ? a.w : a.dout;
      cp_async16(slot + 3 * Sh::kIn + arr * Sh::kF + s * HD * 4 + c * 16,
                 reinterpret_cast<const char*>(src + off) + c * 16);
    }
  }
  cp_async_commit();
}

// A thread's 4 x 4 tile (rows row0.., columns col0..) of a row-major
// hd x hd fp32 matrix in global memory, to and from registers x[4 rr + cc].
template <int HD>
__device__ __forceinline__ void load_tile(float* x, const float* m, int row0,
                                          int col0) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) ld4(x + 4 * rr, m + (row0 + rr) * HD + col0);
}
template <int HD>
__device__ __forceinline__ void store_tile(float* m, const float* x, int row0,
                                           int col0) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
    *reinterpret_cast<float4*>(m + (row0 + rr) * HD + col0) =
        make_float4(x[4 * rr], x[4 * rr + 1], x[4 * rr + 2], x[4 * rr + 3]);
}

// A thread's tile to and from its place in shared memory: [4 rows][threads]
// float4, so a warp's 16-byte accesses are contiguous.
template <int NT>
__device__ __forceinline__ void put_tile(float4* at, const float* x) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
    at[rr * NT] =
        make_float4(x[4 * rr], x[4 * rr + 1], x[4 * rr + 2], x[4 * rr + 3]);
}
template <int NT>
__device__ __forceinline__ void get_tile(float* x, const float4* at) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const float4 f = at[rr * NT];
    x[4 * rr] = f.x;
    x[4 * rr + 1] = f.y;
    x[4 * rr + 2] = f.z;
    x[4 * rr + 3] = f.w;
  }
}

// S <- diag(w) S + k v^T on the tile, step ls of the slot
template <typename TIn, int HD>
__device__ __forceinline__ void advance(float* S, const Slot<TIn, HD>& sl,
                                        int ls, int row0, int col0) {
  float k4[4], v4[4], w4[4];
  ld4(k4, sl.k + ls * HD + row0);
  ld4(w4, sl.w + ls * HD + row0);
  ld4(v4, sl.v + ls * HD + col0);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      S[4 * rr + cc] = fmaf(w4[rr], S[4 * rr + cc], k4[rr] * v4[cc]);
}

// x[0..3] (rows 0..3 of the lane's row quad) reduce-scattered over the 4
// lanes of the quad (xor 1, then xor 2): returns the sum for row
// 2 (lane & 1) + ((lane >> 1) & 1) of the quad.
__device__ __forceinline__ float scatter_rows(const float* x, int b0, int b1) {
  float k0 = b0 ? x[2] : x[0], k1 = b0 ? x[3] : x[1];
  const float s0 = b0 ? x[0] : x[2], s1 = b0 ? x[1] : x[3];
  k0 += __shfl_xor_sync(kFull, s0, 1);
  k1 += __shfl_xor_sync(kFull, s1, 1);
  const float keep = b1 ? k1 : k0, send = b1 ? k0 : k1;
  return keep + __shfl_xor_sync(kFull, send, 2);
}

template <typename TIn, int HD>
__global__ void __launch_bounds__(Shape<TIn, HD>::kThreads, 3)
    rwkv6_scan_bwd_kernel(const Args a) {
  using Sh = Shape<TIn, HD>;
  constexpr int NT = Sh::kThreads, CG = Sh::kCG, NC = Sh::kCluster;
  extern __shared__ __align__(16) char smem[];
  float4* starts = reinterpret_cast<float4*>(smem + Sh::kStarts) + threadIdx.x;
  float4* prow = reinterpret_cast<float4*>(smem + Sh::kRow);
  float* pcol = reinterpret_cast<float*>(smem + Sh::kCol);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();     // the block's 32 rows

  const int bh = blockIdx.x / NC;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.T * a.H + h) * HD;
  const int NS = (a.T + kSeg - 1) / kSeg;
  const int tid = threadIdx.x, cgi = tid / 32, lane = tid % 32;
  const int lrow0 = 4 * (lane >> 2);              // within the block
  const int row0 = kRows * rank + lrow0, col0 = 16 * cgi + 4 * (lane & 3);
  const int b0 = lane & 1, b1 = (lane >> 1) & 1;
  const int b3 = (lane >> 3) & 1, b4 = lane >> 4;
  const int my_row = lrow0 + 2 * b0 + b1;         // row of the lane's sums
  const int my_col = col0 + 2 * b4 + b3;          // column of its dv
  const float* s0 = a.s0 + (size_t)bh * HD * HD;
  float* cp = a.cp + (size_t)bh * (NS - 1) * HD * HD;
  auto slot_of = [&](int n) { return smem + (n & 1) * Sh::kSlot; };
  float u4[4];
  ld4(u4, a.u + h * HD + row0);

  // ---- forward sweep: the checkpoints before segments 1 .. NS - 1 ----
  // Items, in order: forward segments 0 .. NS - 2 (n = g), then reverse
  // segments NS - 1 .. 0 (n = NS - 1 + j); item n's inputs sit in slot
  // n & 1, staged while item n - 1 runs.
  stage<TIn, HD>(a, slot_of(0), base, step, 0, min(kSeg, a.T));
  cp_async_wait_all();
  __syncthreads();
  float S[16];
  load_tile<HD>(S, s0, row0, col0);
  for (int g = 0; g + 1 < NS; ++g) {
    const int t1 = (g + 1) * kSeg;
    stage<TIn, HD>(a, slot_of(g + 1), base, step, t1, min(kSeg, a.T - t1));
    const Slot<TIn, HD> sl(slot_of(g));
#pragma unroll
    for (int ls = 0; ls < kSeg; ++ls) advance<TIn, HD>(S, sl, ls, row0, col0);
    store_tile<HD>(cp + (size_t)g * HD * HD, S, row0, col0);
    cp_async_wait_all();
    __syncthreads();
  }

  // ---- reverse sweep: segments last to first, sub-chunks last to first ----
  float dS[16];
  if (a.dsT == nullptr) {
#pragma unroll
    for (int e = 0; e < 16; ++e) dS[e] = 0.f;
  } else {
    load_tile<HD>(dS, a.dsT + (size_t)bh * HD * HD, row0, col0);
  }
  float du[4] = {0.f, 0.f, 0.f, 0.f};
  TIn* dr = static_cast<TIn*>(a.dr);
  TIn* dk = static_cast<TIn*>(a.dk);
  TIn* dv = static_cast<TIn*>(a.dv);
  const float* peer[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) peer[c] = cluster.map_shared_rank(pcol, c);
  int par = 0;                       // partial buffers in use
  for (int j = 0; j < NS; ++j) {
    const int g = NS - 1 - j, n = NS - 1 + j;
    const int t0 = g * kSeg, len = min(kSeg, a.T - t0);
    const int nq = (len + kSub - 1) / kSub;
    if (g > 0) stage<TIn, HD>(a, slot_of(n + 1), base, step, t0 - kSeg, kSeg);
    const Slot<TIn, HD> sl(slot_of(n));
    const float* from = g == 0 ? s0 : cp + (size_t)(g - 1) * HD * HD;
    // the starts of sub-chunks 1 .. nq - 1, each thread its own tile
    load_tile<HD>(S, from, row0, col0);
    if (nq == kSeg / kSub) {
#pragma unroll
      for (int ls = 0; ls < kSeg - kSub; ++ls) {
        advance<TIn, HD>(S, sl, ls, row0, col0);
        if (ls % kSub == kSub - 1)
          put_tile<NT>(starts + (ls / kSub) * 4 * NT, S);
      }
    } else {
      for (int ls = 0; ls < kSub * (nq - 1); ++ls) {
        advance<TIn, HD>(S, sl, ls, row0, col0);
        if (ls % kSub == kSub - 1)
          put_tile<NT>(starts + (ls / kSub) * 4 * NT, S);
      }
    }
    for (int q = nq - 1; q >= 0; --q) {
      const int q0 = q * kSub, qlen = min(kSub, len - q0);
      // sub-chunk of QLEN steps: states S_{t-1}, t = q0 .., then the steps
      // backwards, each leaving its partial sums in buffer `par`
      auto sub = [&](auto qlen_c) {
        constexpr int QLEN = decltype(qlen_c)::value;
        float St[QLEN][16];
        if (q == 0)
          load_tile<HD>(St[0], from, row0, col0);
        else
          get_tile<NT>(St[0], starts + (q - 1) * 4 * NT);
#pragma unroll
        for (int m = 1; m < QLEN; ++m) {
#pragma unroll
          for (int e = 0; e < 16; ++e) St[m][e] = St[m - 1][e];
          advance<TIn, HD>(St[m], sl, q0 + m - 1, row0, col0);
        }
#pragma unroll
        for (int m = QLEN - 1; m >= 0; --m) {
          const int ls = q0 + m;
          float r4[4], k4[4], v4[4], w4[4], o4[4];
          ld4(r4, sl.r + ls * HD + row0);
          ld4(k4, sl.k + ls * HD + row0);
          ld4(w4, sl.w + ls * HD + row0);
          ld4(v4, sl.v + ls * HD + col0);
          ld4(o4, sl.o + ls * HD + col0);
          float vdp = v4[0] * o4[0];
#pragma unroll
          for (int cc = 1; cc < 4; ++cc) vdp = fmaf(v4[cc], o4[cc], vdp);
          float pk[4], pw[4], pd[4], pv[4], ruk = 0.f;
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float ur = u4[rr] * r4[rr];
            pk[rr] = ur * vdp;                           // u r (v . dO)
            pd[rr] = u4[rr] * k4[rr] * vdp;              // u k (v . dO)
            pw[rr] = 0.f;
            du[rr] = fmaf(r4[rr] * k4[rr], vdp, du[rr]);
            ruk = fmaf(ur, k4[rr], ruk);
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) pv[cc] = ruk * o4[cc];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              float& d = dS[4 * rr + cc];
              const float sp = St[m][4 * rr + cc];
              pk[rr] = fmaf(d, v4[cc], pk[rr]);
              pv[cc] = fmaf(d, k4[rr], pv[cc]);
              pw[rr] = fmaf(d, sp, pw[rr]);
              pd[rr] = fmaf(sp, o4[cc], pd[rr]);
              d = fmaf(w4[rr], d, r4[rr] * o4[cc]);
            }
          const float rk = scatter_rows(pk, b0, b1);
          const float rw = scatter_rows(pw, b0, b1);
          const float rd = scatter_rows(pd, b0, b1);
          // dv: the 4 columns reduce-scattered over the 8 row quads
          float c0 = b4 ? pv[2] : pv[0], c1 = b4 ? pv[3] : pv[1];
          const float e0 = b4 ? pv[0] : pv[2], e1 = b4 ? pv[1] : pv[3];
          c0 += __shfl_xor_sync(kFull, e0, 16);
          c1 += __shfl_xor_sync(kFull, e1, 16);
          float col = b3 ? c1 : c0;
          col += __shfl_xor_sync(kFull, b3 ? c0 : c1, 8);
          col += __shfl_xor_sync(kFull, col, 4);
          const int slot = par * kSub + m;
          prow[(slot * CG + cgi) * kRows + my_row] =
              make_float4(rk, rw, rd, 0.f);
          if ((lane & 4) == 0) pcol[slot * HD + my_col] = col;
        }
      };
      switch (qlen) {
        case 4: sub(std::integral_constant<int, 4>{}); break;
        case 3: sub(std::integral_constant<int, 3>{}); break;
        case 2: sub(std::integral_constant<int, 2>{}); break;
        default: sub(std::integral_constant<int, 1>{}); break;
      }
      if (q == 0 && g > 0) cp_async_wait_all();
      cluster.sync();
      // the sub-chunk's outputs, one of each a thread per step: the block's
      // rows (dk, dw, dr summed over the column groups) and its kRows
      // columns of dv (summed over the cluster's blocks)
      for (int it = tid; it < qlen * kRows; it += NT) {
        const int m = it / kRows, x = it - m * kRows;
        const int slot = par * kSub + m;
        const size_t at = base + (size_t)(t0 + q0 + m) * step + kRows * rank;
        float4 acc = prow[(slot * CG) * kRows + x];
#pragma unroll
        for (int c = 1; c < CG; ++c) {
          const float4 p = prow[(slot * CG + c) * kRows + x];
          acc.x += p.x;
          acc.y += p.y;
          acc.z += p.z;
        }
        store(dk + at + x, acc.x);
        a.dw[at + x] = acc.y;
        store(dr + at + x, acc.z);
      }
      for (int it = tid; it < qlen * kRows; it += NT) {
        const int m = it / kRows, x = it - m * kRows;
        const int slot = par * kSub + m, col = kRows * rank + x;
        float sum = peer[0][slot * HD + col];
#pragma unroll
        for (int c = 1; c < NC; ++c) sum += peer[c][slot * HD + col];
        store(dv + base + (size_t)(t0 + q0 + m) * step + col, sum);
      }
      par ^= 1;
    }
  }
  store_tile<HD>(a.ds0 + (size_t)bh * HD * HD, dS, row0, col0);
  // du: each thread's partials (its 4 rows over its 4 columns) summed over
  // the row quad's lanes, then over the column groups in order
  float* dus = reinterpret_cast<float*>(prow);
  const float mine = scatter_rows(du, b0, b1);
  cluster.sync();                    // every peer read of pcol is done
  dus[cgi * kRows + my_row] = mine;
  __syncthreads();
  if (tid < kRows) {
    float acc = dus[tid];
#pragma unroll
    for (int c = 1; c < CG; ++c) acc += dus[c * kRows + tid];
    a.du[(size_t)bh * HD + kRows * rank + tid] = acc;
  }
}

template <typename TIn, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Sh = Shape<TIn, HD>;
  auto kernel = rwkv6_scan_bwd_kernel<TIn, HD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H * Sh::kCluster);
  cfg.blockDim = dim3(Sh::kThreads);
  cfg.dynamicSmemBytes = Sh::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Sh::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, a);
  return l != cudaSuccess ? l : cudaGetLastError();
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
// ds0: (B, H, hd, hd); du: (B, H, hd) partials; cp: (B H, ceil(T / kSeg) -
// 1, hd, hd) fp32 scratch (null when that is 0) of cp_len floats, which
// must be that size exactly.  w, u, s0, dout, dsT, dw, du, ds0 are
// float32; everything contiguous and 16-byte aligned; dsT may be null (a
// zero cotangent).  hd is 32 or 64, T >= 1.  Launches one kernel on
// `stream`; returns its cudaError_t (0 = success).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dout, const void* dsT, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* cp, long long cp_len, int B,
                              int T, int H, int hd, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (long long)B * H * 2 > 2147483647LL ||
      cp_len != (long long)((T + kSeg - 1) / kSeg - 1) * B * H * hd * hd ||
      (cp_len > 0 && cp == nullptr))
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
