// Backward of blockwise causal / sliding-window GQA attention for Hopper
// (sm_90a), bf16 at head_dim 64 or 128 (every Qwen2.5-Math layer) and 256
// (the Gemma families), plain C interface.  Other inputs (fp32; bf16 at
// the toy head dims 16 and 40) go to flash_attention_bwd.cu.
//
// Replaces no TPU kernel: `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) is forward-only, and the reference
// trains through its XLA einsum attention (src/repro/models/attention.py),
// which XLA differentiates.  It computes the gradients of
// `flash_attention_plain` (src/repro_torch/kernels/flash_attention.py) with
// respect to q (B, Sq, H, hd), k and v (B, Sk, KV, hd), given the output O,
// its gradient dO and the log-sum-exp the forward kernel saved
// (flash_attention.cu, flash_hopper_kernel and flash_hopper256_kernel:
// fp32 (B, H, Sq), in base 2, lse2 = lse * log2(e)).  Query head h reads
// kv head h / G (G = H / KV); key kpos is live for query qpos iff kpos < Sk
// and, when causal, kpos <= qpos, and, with a window, kpos > qpos - window.
//
// With s the raw scores Q K^T, P = exp2(s * scale * log2(e) - lse2) on live
// pairs and 0 elsewhere:
//   D = rowsum(dO * O),  dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the G query heads that read one kv head.
//
// What bounds it on an H100: products and bytes about equally.  Five
// products of 2 * hd flops per live (query head, key) pair against q, k,
// v, O and dO read once and dq, dk, dv written once:
//   target's training shape (B 4, S 512, H 28, KV 4, hd 128, causal):
//     18.8 GFLOP, 0.019 ms at the bf16 tensor-core rate, against 67.1 MB,
//     0.020 ms at the HBM rate;
//   draft's (B 4, S 511, H 12, KV 2, hd 128, causal): 8.0 GFLOP,
//     0.0081 ms, against 29.3 MB, 0.0087 ms;
//   gemma3's (B 2, S 1024, H 4, KV 1, hd 256, causal): 10.7 GFLOP,
//     0.0109 ms (operations); recurrentgemma's (H 16) 43.0 GFLOP,
//     0.0435 ms.
// This design runs seven products (dQ recomputes S and dP).
//
// Three kernels, launched in order on one stream, no atomics (two calls
// are bitwise equal).  What each does about the four faults of the first
// design (flash_attention_bwd.cu: eight products, mma.sync from shared
// memory, synchronous scalar staging, too few blocks):
//   (a) dQ, and D = rowsum(dO * O): one block per (2 x 64 / G query
//       positions, kv head, batch row) like the forward's: 384 threads, a
//       producer warpgroup (this kernel needs 144 registers, within 168),
//       rows that are (position, head) pairs of the group, Q and dO loaded
//       once by TMA, a ring of 64-key K and V tiles.  Each row's D comes
//       from its dO already in shared memory and its O, in fp32, and is
//       written out for (b).  Per tile S = Q K^T and dP = dO V^T (wgmma
//       from shared memory), P and dS in registers, and dQ += dS K with K
//       as the MN-major B operand.  The log-sum-exp is not rebuilt: the
//       forward saved it, so no QK^T sweep runs before the gradients
//       (eight products become seven).
//   (b) dK, dV: a block owns 128 keys of one kv head, two warpgroups of
//       64 keys, and a run of (query head, 64-query tile) items of the
//       group.  Warp 0 also loads: its lane 0 TMA-loads the block's K and
//       V tile once and rings each item's Q and dO tiles through 3 stages
//       (full / empty mbarriers) two items ahead, while its lanes copy the
//       item's 64 log-sum-exp and D values beside them.  Each warpgroup
//       computes S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16 from
//       shared memory (both operands K-major), turns S^T into P^T on the
//       accumulator layout straight into the bf16 A operand, forms
//       dS^T = P^T (dP^T - D) from it, and issues dV += P^T dO and
//       dK += dS^T Q with dO and Q as the MN-major B operands of the same
//       swizzled tiles: no transposed staging, and P and dS never reach
//       shared memory.  Registers are the crux: dK and dV take hd / 2
//       fp32 each a thread (128 at hd 128), S^T and dP^T 32 each, the two
//       A operands 16 each.  ptxas allocates every thread of a block by
//       its launch bounds and does not raise that for code after
//       setmaxnreg, so a 384-thread block with a producer warpgroup capped
//       them at 168 and spilled about 350 bytes a thread; 256 threads
//       allow 255 (248 used, no spill), which is why this kernel has no
//       producer warpgroup.
//   More blocks: the host's plan (flash_attention.py: bwd_split_plan)
//       lists each 128-key tile's items in (head, query tile) order and
//       cuts them into near-equal contiguous runs of at most `chunk`
//       items, one block each, `chunk` chosen to fill waves of one block
//       per SM (128 blocks of at most 21 items at the target's training
//       shape, 128 of at most 8 at the draft's, on 132 SMs, where the
//       first design had 128 and 64 blocks walking all G heads).  The
//       plan reaches the kernels as a table, (jlo, n, splits, first
//       block) per key tile; they do not recompute it.  A key tile in one
//       run writes bf16 dK, dV directly; the runs of a split tile write
//       fp32 partials, and (c) sums them in run order.  (A cluster of
//       blocks summing the runs through distributed shared memory was
//       measured too and lost, PERF.md.)
//   (c) reduce: the fp32 partials of each split key tile summed in run
//       order, dK scaled, both written in bf16, one float4 a thread.
// Masks and edges: the loops visit only tiles that hold a live pair; only
// tiles that cross the causal diagonal, the window's lower edge, Sq or Sk
// are masked, by per-row bounds, and masked pairs get P = 0 by a select,
// never exp2(-1e30 - lse).  TMA fills rows past Sq and Sk with zeros, so
// the ragged edges need no padding in memory; a warpgroup whose keys or
// rows see no live pair of a tile skips its products.
// Head_dim 256 (bwd_dq256_kernel, bwd_dkdv256_kernel; the first design,
// flash_attention_bwd.cu's mma.sync kernels with the output's head dims
// split over two blocks, ran about 12 full-width products a live pair,
// rebuilt the log-sum-exp and summed G fp32 partials of every key): a
// 64 x 256 fp32 accumulator is 128 registers a thread, so neither kernel
// has a producer warpgroup (256 threads, warp 0 loads).
//   (a) dQ keeps Q and dO of 2 x 64 rows (128 KB), so its K/V ring holds
//       three 32-key tiles (96 KB); S and dP with wgmma m64n32k16, dQ as
//       two m64n128k16 halves.  At gemma3's G 4 that is 64 blocks for 132
//       SMs, the causal last ones 32 tiles long (0.070 of 0.115 ms there);
//       one row set a block with the key tiles split over the warpgroups
//       (a ring each, two stages) ran slower, its loads exposed (PERF.md).
//   (b) dK/dV: a 64 x 256 fp32 dK plus dV would be 256 registers a thread
//       in one warpgroup, so a block owns 64 keys and its two warpgroups
//       split each item: warpgroup 0 computes S^T = K Q^T, warpgroup 1
//       dP^T = V dO^T (full 256-deep contractions), P^T and dS^T cross
//       between them in bf16 through shared memory in the 128-byte
//       swizzle (the A operand's layout), and each accumulates dV and dK
//       for its own 128-wide half of the dims: four 64 x 64 x 256 products
//       an item, seven in all with (a)'s three.  The plan is the same
//       function at a 64-key tile (32 tiles at gemma3's B 2 x S 1024, one
//       kv head, cut into runs that fill the card), and (c) sums the runs'
//       partials.
// Not yet: dQ accumulated by the dK/dV blocks in a fixed order (five
// products instead of seven); the two warpgroups taking turns at the
// tensor cores as the forward's do; the dQ product left running under the
// next tile's (tried at 64/128: slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBKeys = 128;          // keys per dK/dV block
constexpr int kBQ = 64;              // queries per item of its sweep
constexpr int kBStages = 3;          // Q / dO ring depth
constexpr int kDKeys = 64;           // keys per tile of the dQ sweep
constexpr int kDStages = 3;          // K / V ring depth of the dQ sweep
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr int kMaxGroup = 64;

struct BArgs {
  const float* lse;                  // (B, H, Sq) log2-sum-exp
  const void* out;                   // O, (B, Sq, H, hd) bf16
  float* delta;                      // D, (B, H, Sq): the dQ kernel's
  void* dq;                          // (B, Sq, H, hd) bf16
  void* dk;                          // (B, Sk, KV, hd) bf16
  void* dv;
  float* part;                       // [B][KV][nslots][2][kBKeys][hd] fp32
  const int4* plan;                  // per key tile: jlo, n, splits, slot0
  int Sq, Sk, H, KV, G, qt, causal, window, nslots;
  float scale, scale_log2;
};

__host__ __device__ __forceinline__ int imin(int x, int y) {
  return x < y ? x : y;
}

__host__ __device__ __forceinline__ int key_tiles(const BArgs& a, int keys) {
  return (a.Sk + keys - 1) / keys;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---------------------------------------------------------------------------
// (b) dK, dV
// ---------------------------------------------------------------------------

// Shared-memory plan of a dK/dV block, from a 1024-aligned base: K and V
// [HD/64 panels][kBKeys rows][128 B] each, the ring of Q and dO tiles
// [stage][HD/64 panels][kBQ rows][128 B], the ring's log-sum-exp and D
// [stage][kBQ] fp32, then the mbarriers.
template <int HD>
struct KVPlan {
  static constexpr int kPanels = HD / 64;
  static constexpr int kKPanel = kBKeys * 128;
  static constexpr int kQPanel = kBQ * 128;
  static constexpr int kKBytes = kPanels * kKPanel;
  static constexpr int kQStage = kPanels * kQPanel;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kBStages * kQStage;
  static constexpr int kLse = kDO + kBStages * kQStage;
  static constexpr int kDelta = kLse + kBStages * kBQ * 4;
  static constexpr int kBars = kDelta + kBStages * kBQ * 4;
  static constexpr int kSmem = kBars + (1 + 2 * kBStages) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kConsumers, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, BArgs a) {
  using P = KVPlan<HD>;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  char* k_s = base + P::kK;
  char* v_s = base + P::kV;
  char* q_s = base + P::kQ;
  char* do_s = base + P::kDO;
  float* lse_s = reinterpret_cast<float*>(base + P::kLse);
  float* d_s = reinterpret_cast<float*>(base + P::kDelta);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kBStages;

  const int kvh = blockIdx.y, b = blockIdx.z;
  // this block's key tile t: query tiles jlo .. jlo + n - 1 hold a live
  // pair for one of its keys, G * n items cut into `splits` runs; run s
  // takes items [i0, i1)
  int t = 0;
  int4 tp = a.plan[0];
  while (blockIdx.x >= tp.w + tp.z) tp = a.plan[++t];
  const int jlo = tp.x, tn = tp.y, splits = tp.z;
  const int s = blockIdx.x - tp.w;
  const int items = a.G * tn;
  const int i0 = (int)((long)s * items / splits);
  const int i1 = (int)((long)(s + 1) * items / splits);
  const int k0 = t * kBKeys;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int i = 0; i < kBStages; ++i) {
      hopper::mbar_init(&full[i], 1 + 32);    // TMA bytes + 32 lanes
      hopper::mbar_init(&empty[i], kConsumers);
    }
  }
  hopper::fence_barrier_init();
  __syncthreads();

  // Warp 0 also loads: lane 0 issues every TMA load, every lane copies
  // its share of the item's log-sum-exp and D.  Item it goes into stage
  // it % kBStages once both warpgroups have released that stage.
  const int wg = tid / 128, lane = tid % 32;
  const bool loader = tid < 32;
  const int nitems = i1 - i0;
  auto load_item = [&](int it) {
    const int st = it % kBStages, ph = (it / kBStages) & 1;
    const int i = i0 + it;
    const int h = kvh * a.G + i / tn;
    const int p0 = (jlo + i % tn) * kBQ;
    hopper::mbar_wait(&empty[st], ph ^ 1);
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[st], 2 * P::kQStage);
      for (int p = 0; p < P::kPanels; ++p) {
        hopper::tma_load_4d(q_s + st * P::kQStage + p * P::kQPanel, &qmap,
                            &full[st], 64 * p, h, p0, b);
        hopper::tma_load_4d(do_s + st * P::kQStage + p * P::kQPanel, &domap,
                            &full[st], 64 * p, h, p0, b);
      }
    }
    const long row = ((long)b * a.H + h) * a.Sq;
    for (int c = lane; c < kBQ; c += 32) {
      const int pos = p0 + c;
      lse_s[st * kBQ + c] = pos < a.Sq ? a.lse[row + pos] : 0.f;
      d_s[st * kBQ + c] = pos < a.Sq ? a.delta[row + pos] : 0.f;
    }
    hopper::mbar_arrive(&full[st]);
  };
  if (loader) {
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * P::kKBytes);
      for (int p = 0; p < P::kPanels; ++p) {
        hopper::tma_load_4d(k_s + p * P::kKPanel, &kmap, kv_bar, 64 * p, kvh,
                            k0, b);
        hopper::tma_load_4d(v_s + p * P::kKPanel, &vmap, kv_bar, 64 * p, kvh,
                            k0, b);
      }
    }
    for (int it = 0; it < kBStages - 1 && it < nitems; ++it) load_item(it);
  }

  // ---- warpgroup wg owns keys kw .. kw + 63 ----
  const int w = (tid % 128) / 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w + gq, r1 = r0 + 8;       // this thread's two keys
  const int kw = k0 + 64 * wg;
  const int klast = imin(kw + 63, a.Sk - 1);
  // live query positions of each of the thread's keys: lo .. hi
  auto hi_of = [&](int key) {
    return key >= a.Sk ? -1
                       : (a.window > 0 ? imin(a.Sq - 1, key + a.window - 1)
                                       : a.Sq - 1);
  };
  const int lo0 = a.causal ? kw + r0 : 0, lo1 = a.causal ? kw + r1 : 0;
  const int hi0 = hi_of(kw + r0), hi1 = hi_of(kw + r1);
  char* kwp = k_s + wg * 64 * 128;
  char* vwp = v_s + wg * 64 * 128;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  float sp[kBQ / 2], dp[kBQ / 2];        // S^T, dP^T
  uint32_t pa[kBQ / 4], da[kBQ / 4];     // P^T and dS^T as A operands
  hopper::mbar_wait(kv_bar, 0);

  for (int i = i0, it = 0; i < i1; ++i, ++it) {
    const int st = it % kBStages;
    const int p0 = (jlo + i % tn) * kBQ;
    const int plast = p0 + kBQ - 1;
    if (loader && it + kBStages - 1 < nitems) load_item(it + kBStages - 1);
    hopper::mbar_wait(&full[st], (it / kBStages) & 1);
    // a warpgroup whose keys see no query of this tile adds nothing
    const bool dead = kw >= a.Sk || p0 >= a.Sq ||
                      (a.causal && kw > plast) ||
                      (a.window > 0 && p0 > klast + a.window - 1);
    if (!dead) {
      char* qs = q_s + st * P::kQStage;
      char* ds = do_s + st * P::kQStage;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(
            sp, hopper::desc_sw128(kwp + p * P::kKPanel + off, 16, 1024),
            hopper::desc_sw128(qs + p * P::kQPanel + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(
            dp, hopper::desc_sw128(vwp + p * P::kKPanel + off, 16, 1024),
            hopper::desc_sw128(ds + p * P::kQPanel + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operands<kBQ / 2>(sp);

      // P^T, straight into the bf16 A operand of dV += P^T dO: column c of
      // n-tile j is query p0 + 8 j + 2 tq + (e & 1)
      const float* ls = lse_s + st * kBQ;
      const bool edge = kw + 63 >= a.Sk || plast >= a.Sq ||
                        (a.causal && kw + 63 > p0) ||
                        (a.window > 0 && kw <= plast - a.window);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 l = *reinterpret_cast<const float2*>(ls + c);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = hopper::exp2_approx(
              fmaf(sp[4 * j + e], a.scale_log2, (e & 1) ? -l.y : -l.x));
          if (edge) {
            const int pos = p0 + c + (e & 1);
            const bool lv = e < 2 ? (pos >= lo0 && pos <= hi0)
                                  : (pos >= lo1 && pos <= hi1);
            x[e] = lv ? x[e] : 0.f;
          }
        }
        pa[4 * (j / 2) + 2 * (j % 2)] = hopper::pack_bf16(x[0], x[1]);
        pa[4 * (j / 2) + 2 * (j % 2) + 1] = hopper::pack_bf16(x[2], x[3]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands<kBQ / 2>(dp);
      // dS^T = P^T (dP^T - D), P^T read back from its bf16 operand (so the
      // fp32 S^T is dead before dP^T is read: fewer live registers)
      const float* dd = d_s + st * kBQ;
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * tq);
        const int f = 4 * (j / 2) + 2 * (j % 2);
        const float2 pr0 = unpack_bf16(pa[f]), pr1 = unpack_bf16(pa[f + 1]);
        da[f] = hopper::pack_bf16(pr0.x * (dp[4 * j] - d.x),
                                  pr0.y * (dp[4 * j + 1] - d.y));
        da[f + 1] = hopper::pack_bf16(pr1.x * (dp[4 * j + 2] - d.x),
                                      pr1.y * (dp[4 * j + 3] - d.y));
      }
      // dV += P^T dO and dK += dS^T Q (dO and Q [query][dim] are the
      // MN-major B operands)
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) {
        const uint64_t db =
            hopper::desc_sw128(ds + kc * 16 * 128, P::kQPanel, 1024);
        if constexpr (HD == 128)
          hopper::wgmma_rs_n128<1>(dv, pa + 4 * kc, db, 1);
        else
          hopper::wgmma_rs_n64<1>(dv, pa + 4 * kc, db, 1);
      }
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) {
        const uint64_t db =
            hopper::desc_sw128(qs + kc * 16 * 128, P::kQPanel, 1024);
        if constexpr (HD == 128)
          hopper::wgmma_rs_n128<1>(dk, da + 4 * kc, db, 1);
        else
          hopper::wgmma_rs_n64<1>(dk, da + 4 * kc, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<HD / 2>(dk);
      hopper::fence_operands<HD / 2>(dv);
      hopper::fence_operands<kBQ / 4>(pa);
      hopper::fence_operands<kBQ / 4>(da);
    }
    hopper::mbar_arrive(&empty[st]);
  }

  // accumulator (row r, n-tile j) holds dims 8 j + 2 tq, + 1: dk[4 j],
  // dk[4 j + 1] of row r0, dk[4 j + 2], dk[4 j + 3] of row r1
  if (splits == 1) {
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk);
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv);
    const long o0 = (((long)b * a.Sk + kw + r0) * a.KV + kvh) * HD + 2 * tq;
    const long o1 = o0 + 8L * a.KV * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (kw + r0 < a.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + o0 + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j] * a.scale,
                                  dk[4 * j + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + o0 + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      }
      if (kw + r1 < a.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + o1 + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2] * a.scale,
                                  dk[4 * j + 3] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + o1 + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  } else {
    float* pk = a.part + ((((long)b * a.KV + kvh) * a.nslots + blockIdx.x) *
                          2) * kBKeys * HD;
    float* pv = pk + kBKeys * HD;
    const long o0 = (long)(64 * wg + r0) * HD + 2 * tq, o1 = o0 + 8 * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(pk + o0 + 8 * j) =
          make_float2(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<float2*>(pv + o0 + 8 * j) =
          make_float2(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<float2*>(pk + o1 + 8 * j) =
          make_float2(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<float2*>(pv + o1 + 8 * j) =
          make_float2(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) the split key tiles' partials, summed in run order
// ---------------------------------------------------------------------------

template <int HD, int KEYS>
__global__ void __launch_bounds__(256) bwd_reduce_kernel(BArgs a) {
  // block x: key tile x / kGroups, its rows (x % kGroups) * 1024 / HD
  // onwards, one float4 of dK and of dV a thread
  constexpr int kGroups = KEYS * HD / 1024;
  const int t = blockIdx.x / kGroups, kvh = blockIdx.y, b = blockIdx.z;
  const int slot0 = a.plan[t].w, splits = a.plan[t].z;
  const int e = (blockIdx.x % kGroups) * 1024 + threadIdx.x * 4;
  const int key = t * KEYS + e / HD;
  if (splits == 1 || key >= a.Sk) return;
  const long stride = 2L * KEYS * HD;
  const float* part =
      a.part + (((long)b * a.KV + kvh) * a.nslots + slot0) * stride + e;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * stride);
    const float4 y =
        *reinterpret_cast<const float4*>(part + s * stride + KEYS * HD);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  const long o = (((long)b * a.Sk + key) * a.KV + kvh) * HD + e % HD;
  __nv_bfloat162* dko =
      reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.dk) + o);
  __nv_bfloat162* dvo =
      reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.dv) + o);
  dko[0] = __floats2bfloat162_rn(sk.x * a.scale, sk.y * a.scale);
  dko[1] = __floats2bfloat162_rn(sk.z * a.scale, sk.w * a.scale);
  dvo[0] = __floats2bfloat162_rn(sv.x, sv.y);
  dvo[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// ---------------------------------------------------------------------------
// (a) dQ and D
// ---------------------------------------------------------------------------

// Shared-memory plan of a dQ block: Q and dO [2 warpgroups][HD/64
// panels][64 rows][128 B] each, then the ring of K and V tiles
// [stage][HD/64 panels][kDKeys rows][128 B], then the mbarriers and each
// warpgroup's 64 values of D.
template <int HD>
struct QPlan {
  static constexpr int kPanels = HD / 64;
  static constexpr int kQPanel = 64 * 128;
  static constexpr int kKVPanel = kDKeys * 128;
  static constexpr int kQBytes = 2 * kPanels * kQPanel;
  static constexpr int kKVStage = kPanels * kKVPanel;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kDStages * kKVStage;
  static constexpr int kBars = kV + kDStages * kKVStage;
  static constexpr int kDRows = kBars + 64;      // [2 warpgroups][64] fp32
  static constexpr int kSmem = kDRows + 2 * 64 * 4 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, BArgs a) {
  using P = QPlan<HD>;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  char* q_s = base + P::kQ;
  char* do_s = base + P::kDO;
  char* k_s = base + P::kK;
  char* v_s = base + P::kV;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kDStages;

  // query tiles longest first, as the forward's
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qtile * 2 * a.qt;
  const int qlast = imin(q0 + 2 * a.qt, a.Sq) - 1;
  const int first =
      (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / kDKeys;
  const int last = (a.causal ? imin(qlast, a.Sk - 1) : a.Sk - 1) / kDKeys;
  const int rows = a.G * a.qt;       // rows TMA writes per warpgroup panel
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kDStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
  }
  // rows past G * qt of each Q and dO panel are never written by TMA:
  // zero them so the unused rows compute on zeros
  const int pad = (64 - rows) * 8;   // 16-byte chunks per panel
  for (int i = tid; i < 4 * P::kPanels * pad; i += kThreads) {
    const int panel = i / pad, c = i - panel * pad;
    *reinterpret_cast<uint4*>(q_s + panel * P::kQPanel + rows * 128 + c * 16) =
        make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();
  hopper::fence_barrier_init();
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    hopper::setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      hopper::mbar_expect_tx(q_bar, 2 * 2 * P::kPanels * rows * 128);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < P::kPanels; ++p) {
          const int off = (w * P::kPanels + p) * P::kQPanel;
          hopper::tma_load_4d(q_s + off, &qmap, q_bar, 64 * p, h * a.G,
                              q0 + w * a.qt, b);
          hopper::tma_load_4d(do_s + off, &domap, q_bar, 64 * p, h * a.G,
                              q0 + w * a.qt, b);
        }
      for (int tile = first, it = 0; tile <= last; ++tile, ++it) {
        const int s = it % kDStages, ph = (it / kDStages) & 1;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * P::kKVStage);
        for (int p = 0; p < P::kPanels; ++p) {
          hopper::tma_load_4d(k_s + s * P::kKVStage + p * P::kKVPanel, &kmap,
                              &full[s], 64 * p, h, tile * kDKeys, b);
          hopper::tma_load_4d(v_s + s * P::kKVStage + p * P::kKVPanel, &vmap,
                              &full[s], 64 * p, h, tile * kDKeys, b);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int w = (tid % 128) / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w + gq, r1 = r0 + 8;       // this thread's two rows
  const int pw0 = q0 + wg * a.qt;                // warpgroup's positions
  const int pw1 = imin(pw0 + a.qt, a.Sq) - 1;
  char* qw = q_s + wg * P::kPanels * P::kQPanel;
  char* dow = do_s + wg * P::kPanels * P::kQPanel;
  // per row: its position, live keys (lo, hi], log-sum-exp and D
  const int p0 = pw0 + r0 / a.G, p1 = pw0 + r1 / a.G;
  const bool v0 = r0 < rows && p0 < a.Sq, v1 = r1 < rows && p1 < a.Sq;
  const long hb = (long)b * a.H + (long)h * a.G;
  const long s0 = (hb + r0 % a.G) * a.Sq + p0;
  const long s1 = (hb + r1 % a.G) * a.Sq + p1;
  const float lse0 = v0 ? a.lse[s0] : 0.f, lse1 = v1 ? a.lse[s1] : 0.f;
  const int hi0 = a.causal ? imin(p0, a.Sk - 1) : a.Sk - 1;
  const int hi1 = a.causal ? imin(p1, a.Sk - 1) : a.Sk - 1;
  const int lo0 = a.window > 0 ? p0 - a.window : -1;
  const int lo1 = a.window > 0 ? p1 - a.window : -1;

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float sp[kDKeys / 2], dp[kDKeys / 2];
  uint32_t da[kDKeys / 4];
  hopper::mbar_wait(q_bar, 0);

  // D = rowsum(dO * O) of the warpgroup's rows: dO from its swizzled
  // panels, O from device memory, two threads a row (8 chunks of 8 dims
  // each); written out for the dK/dV kernel, which runs after this one
  float* d_rows = reinterpret_cast<float*>(base + P::kDRows) + 64 * wg;
  {
    const int r = (tid % 128) / 2, half = tid % 2;
    const int pos = pw0 + r / a.G, g = r % a.G;
    float acc = 0.f;
    if (r < rows && pos < a.Sq) {
      const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(a.out) +
          (((long)b * a.Sq + pos) * a.H + (long)h * a.G + g) * HD;
#pragma unroll
      for (int c = half * (HD / 16); c < (half + 1) * (HD / 16); ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(
            dow + (c / 8) * P::kQPanel + r * 128 + (((c % 8) ^ (r & 7)) * 16));
        const uint4 y = *reinterpret_cast<const uint4*>(orow + c * 8);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xf = __bfloat1622float2(xp[i]);
          const float2 yf = __bfloat1622float2(yp[i]);
          acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_rows[r] = acc;
      if (r < rows && pos < a.Sq) a.delta[(hb + g) * a.Sq + pos] = acc;
    }
    hopper::named_sync(1 + wg, 128);
  }
  const float d0 = d_rows[r0], d1 = d_rows[r1];

  for (int tile = first, it = 0; tile <= last; ++tile, ++it) {
    const int s = it % kDStages;
    const int kb = tile * kDKeys;
    hopper::mbar_wait(&full[s], (it / kDStages) & 1);
    // a warpgroup whose rows see no key of this tile adds nothing
    const bool dead = pw0 >= a.Sq || (a.causal && kb > pw1) ||
                      (a.window > 0 && kb + kDKeys - 1 <= pw0 - a.window);
    if (!dead) {
      char* ks = k_s + s * P::kKVStage;
      char* vs = v_s + s * P::kKVStage;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(
            sp, hopper::desc_sw128(qw + p * P::kQPanel + off, 16, 1024),
            hopper::desc_sw128(ks + p * P::kKVPanel + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(
            dp, hopper::desc_sw128(dow + p * P::kQPanel + off, 16, 1024),
            hopper::desc_sw128(vs + p * P::kKVPanel + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operands<kDKeys / 2>(sp);
      // P: column c of n-tile j is key kb + 8 j + 2 tq + (e & 1)
      const bool edge = (a.causal && kb + kDKeys - 1 > pw0) ||
                        kb + kDKeys > a.Sk ||
                        (a.window > 0 && kb <= pw1 - a.window);
#pragma unroll
      for (int j = 0; j < kDKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = hopper::exp2_approx(
              fmaf(sp[4 * j + e], a.scale_log2, e < 2 ? -lse0 : -lse1));
          if (edge) {
            const int key = kb + 8 * j + 2 * tq + (e & 1);
            const bool lv = e < 2 ? (key > lo0 && key <= hi0)
                                  : (key > lo1 && key <= hi1);
            sp[4 * j + e] = lv ? x : 0.f;
          } else {
            sp[4 * j + e] = x;
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands<kDKeys / 2>(dp);
#pragma unroll
      for (int j = 0; j < kDKeys / 8; ++j) {
        const float g0 = sp[4 * j] * (dp[4 * j] - d0);
        const float g1 = sp[4 * j + 1] * (dp[4 * j + 1] - d0);
        const float g2 = sp[4 * j + 2] * (dp[4 * j + 2] - d1);
        const float g3 = sp[4 * j + 3] * (dp[4 * j + 3] - d1);
        da[4 * (j / 2) + 2 * (j % 2)] = hopper::pack_bf16(g0, g1);
        da[4 * (j / 2) + 2 * (j % 2) + 1] = hopper::pack_bf16(g2, g3);
      }
      // dQ += dS K (K [key][dim] is the MN-major B operand)
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kDKeys / 16; ++kc) {
        const uint64_t db =
            hopper::desc_sw128(ks + kc * 16 * 128, P::kKVPanel, 1024);
        if constexpr (HD == 128)
          hopper::wgmma_rs_n128<1>(dq, da + 4 * kc, db, 1);
        else
          hopper::wgmma_rs_n64<1>(dq, da + 4 * kc, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<HD / 2>(dq);
      hopper::fence_operands<kDKeys / 4>(da);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // stage the bf16 tile in this warpgroup's Q panels (its last product
  // has completed), 16-byte chunks XOR-swizzled by row, then store rows
  constexpr int kRowBytes = HD * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = (j ^ (r0 & 7)) * 16 + 4 * tq;   // r1 & 7 == r0 & 7
    *reinterpret_cast<uint32_t*>(qw + r0 * kRowBytes + c) =
        hopper::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(qw + r1 * kRowBytes + c) =
        hopper::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
  hopper::named_sync(1 + wg, 128);
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq);
  constexpr int kChunks = HD / 8;
  for (int i = tid % 128; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int pos = pw0 + r / a.G, g = r - (r / a.G) * a.G;
    if (r < rows && pos < a.Sq)
      *reinterpret_cast<uint4*>(
          dqg + (((long)b * a.Sq + pos) * a.H + (long)h * a.G + g) * HD +
          c * 8) = *reinterpret_cast<const uint4*>(
          qw + r * kRowBytes + ((c ^ (r & 7)) * 16));
  }
}

// ---------------------------------------------------------------------------
// head_dim 256
// ---------------------------------------------------------------------------
//
// A 64 x 256 fp32 accumulator is 128 registers a thread, and ptxas
// allocates every thread of a block by its launch bounds (168 at 384
// threads), so both head_dim-256 kernels are two consumer warpgroups alone
// (256 threads, up to 255 registers) and warp 0 also issues the loads, as
// the head_dim-256 forward (flash_attention.cu, flash_hopper256_kernel).

constexpr int kW = 256;              // threads of a head_dim-256 block
constexpr int kWDKeys = 32;          // keys per tile of the dQ sweep
constexpr int kWDStages = 3;         // its K / V ring depth
constexpr int kWBKeys = 64;          // keys per dK/dV block
constexpr int kWBStages = 2;         // its Q / dO ring depth
constexpr int kMaxSmem = 232448;     // what a block may use (227 KB)

// dQ block: Q and dO [2 warpgroups][4 panels][64 rows][128 B], 64 KB each;
// then the ring of 32-key K and V tiles [stage][4 panels][32 rows][128 B],
// 16 KB a tile, 96 KB for three stages (two 64-key stages would not fit
// beside Q and dO: 128 + 128 KB); then the mbarriers and D.  225.6 KB.
struct QPlan256 {
  static constexpr int kPanels = 4;
  static constexpr int kQPanel = 64 * 128;
  static constexpr int kKVPanel = kWDKeys * 128;
  static constexpr int kQBytes = 2 * kPanels * kQPanel;
  static constexpr int kKVStage = kPanels * kKVPanel;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kWDStages * kKVStage;
  static constexpr int kBars = kV + kWDStages * kKVStage;
  static constexpr int kDRows = kBars + 64;      // [2 warpgroups][64] fp32
  static constexpr int kSmem = kDRows + 2 * 64 * 4 + 1024;
};
static_assert(QPlan256::kSmem <= kMaxSmem, "dQ block over 227 KB");

// dK/dV block: K and V [4 panels][64 keys][128 B], 32 KB each; the ring of
// Q and dO items [stage][4 panels][64 queries][128 B], 64 KB a stage, two
// stages; P^T [2 buffers][64 keys][128 B] and dS^T [64 keys][128 B] in the
// 128-byte swizzle, the K-major A operand of wgmma; the ring's
// log-sum-exp and D; the mbarriers.  218 KB.
struct KVPlan256 {
  static constexpr int kPanels = 4;
  static constexpr int kKPanel = kWBKeys * 128;
  static constexpr int kQPanel = kBQ * 128;
  static constexpr int kKBytes = kPanels * kKPanel;
  static constexpr int kQStage = kPanels * kQPanel;
  static constexpr int kTile = 64 * 128;         // one 64 x 64 bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kWBStages * kQStage;
  static constexpr int kP = kDO + kWBStages * kQStage;
  static constexpr int kDS = kP + 2 * kTile;
  static constexpr int kLse = kDS + kTile;
  static constexpr int kDelta = kLse + kWBStages * kBQ * 4;
  static constexpr int kBars = kDelta + kWBStages * kBQ * 4;
  static constexpr int kSmem = kBars + (1 + 2 * kWBStages) * 8 + 1024;
};
static_assert(KVPlan256::kSmem <= kMaxSmem, "dK/dV block over 227 KB");

// A thread's two bf16 values (columns 2 tq, 2 tq + 1 of n-tile j, row r) in
// a 64-row tile of 128-byte rows, 16-byte chunks XOR-swizzled by row as the
// 128-byte swizzle lays them out
__device__ __forceinline__ uint32_t* tile_pair(char* tile, int r, int j,
                                               int tq) {
  return reinterpret_cast<uint32_t*>(tile + r * 128 + ((j ^ (r & 7)) << 4) +
                                     4 * tq);
}

// (b) at head_dim 256: a block owns 64 keys of one kv head and a run of
// (query head, 64-query tile) items of the plan.  Per item warpgroup 0
// computes S^T = K Q^T and warpgroup 1 dP^T = V dO^T, each a full 256-deep
// contraction (wgmma m64n64k16 from shared memory); warpgroup 0 turns S^T
// into P^T and leaves it in shared memory in bf16, warpgroup 1 reads it
// back at its own accumulator positions and leaves dS^T = P^T (dP^T - D)
// beside it.  Then each warpgroup accumulates, for its own 128-wide half of
// the head dims, dV += P^T dO and dK += dS^T Q (wgmma m64n128k16, A the
// swizzled P^T or dS^T tile, B the MN-major half of the item's dO or Q
// tile): four 64 x 64 x 256 products an item.  Named barriers order the
// exchange (1: P^T written, 2: dS^T written); P^T alternates between two
// buffers, so the next item's P^T never waits for this one's readers.
// Registers: dK and dV halves 64 + 64 fp32, the S^T or dP^T accumulator 32.
__global__ void __launch_bounds__(kW, 1)
bwd_dkdv256_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap domap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, BArgs a) {
  constexpr int HD = 256;
  using P = KVPlan256;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  char* k_s = base + P::kK;
  char* v_s = base + P::kV;
  char* q_s = base + P::kQ;
  char* do_s = base + P::kDO;
  char* p_s = base + P::kP;
  char* x_s = base + P::kDS;
  float* lse_s = reinterpret_cast<float*>(base + P::kLse);
  float* d_s = reinterpret_cast<float*>(base + P::kDelta);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kWBStages;

  const int kvh = blockIdx.y, b = blockIdx.z;
  int t = 0;
  int4 tp = a.plan[0];
  while (blockIdx.x >= tp.w + tp.z) tp = a.plan[++t];
  const int jlo = tp.x, tn = tp.y, splits = tp.z;
  const int s = blockIdx.x - tp.w;
  const int items = a.G * tn;
  const int i0 = (int)((long)s * items / splits);
  const int i1 = (int)((long)(s + 1) * items / splits);
  const int k0 = t * kWBKeys;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int i = 0; i < kWBStages; ++i) {
      hopper::mbar_init(&full[i], 1 + 32);    // TMA bytes + 32 lanes
      hopper::mbar_init(&empty[i], kW);
    }
  }
  hopper::fence_barrier_init();
  __syncthreads();

  const int wg = tid / 128, lane = tid % 32;
  const bool loader = tid < 32;
  const int nitems = i1 - i0;
  auto load_item = [&](int it) {
    const int st = it % kWBStages, ph = (it / kWBStages) & 1;
    const int i = i0 + it;
    const int h = kvh * a.G + i / tn;
    const int p0 = (jlo + i % tn) * kBQ;
    hopper::mbar_wait(&empty[st], ph ^ 1);
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[st], 2 * P::kQStage);
      for (int p = 0; p < P::kPanels; ++p) {
        hopper::tma_load_4d(q_s + st * P::kQStage + p * P::kQPanel, &qmap,
                            &full[st], 64 * p, h, p0, b);
        hopper::tma_load_4d(do_s + st * P::kQStage + p * P::kQPanel, &domap,
                            &full[st], 64 * p, h, p0, b);
      }
    }
    const long row = ((long)b * a.H + h) * a.Sq;
    for (int c = lane; c < kBQ; c += 32) {
      const int pos = p0 + c;
      lse_s[st * kBQ + c] = pos < a.Sq ? a.lse[row + pos] : 0.f;
      d_s[st * kBQ + c] = pos < a.Sq ? a.delta[row + pos] : 0.f;
    }
    hopper::mbar_arrive(&full[st]);
  };
  if (loader) {
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * P::kKBytes);
      for (int p = 0; p < P::kPanels; ++p) {
        hopper::tma_load_4d(k_s + p * P::kKPanel, &kmap, kv_bar, 64 * p, kvh,
                            k0, b);
        hopper::tma_load_4d(v_s + p * P::kKPanel, &vmap, kv_bar, 64 * p, kvh,
                            k0, b);
      }
    }
    for (int it = 0; it < kWBStages - 1 && it < nitems; ++it) load_item(it);
  }

  // both warpgroups hold the same 64 keys: this thread's rows r0, r1
  const int w = (tid % 128) / 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w + gq, r1 = r0 + 8;
  const int klast = imin(k0 + kWBKeys - 1, a.Sk - 1);
  auto hi_of = [&](int key) {
    return key >= a.Sk ? -1
                       : (a.window > 0 ? imin(a.Sq - 1, key + a.window - 1)
                                       : a.Sq - 1);
  };
  const int lo0 = a.causal ? k0 + r0 : 0, lo1 = a.causal ? k0 + r1 : 0;
  const int hi0 = hi_of(k0 + r0), hi1 = hi_of(k0 + r1);
  // warpgroup 0 multiplies K by Q, warpgroup 1 V by dO
  const char* mine = wg == 0 ? k_s : v_s;

  float dk[HD / 4], dv[HD / 4];          // this warpgroup's 128 dims
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) dk[i] = dv[i] = 0.f;
  float acc[kBQ / 2];                    // S^T (warpgroup 0), dP^T (1)
  hopper::mbar_wait(kv_bar, 0);

  for (int i = i0, it = 0; i < i1; ++i, ++it) {
    const int st = it % kWBStages;
    const int p0 = (jlo + i % tn) * kBQ;
    const int plast = p0 + kBQ - 1;
    if (loader && it + kWBStages - 1 < nitems)
      load_item(it + kWBStages - 1);
    hopper::mbar_wait(&full[st], (it / kWBStages) & 1);
    // the same for both warpgroups: the block's keys see no query of it
    const bool dead = k0 >= a.Sk || p0 >= a.Sq ||
                      (a.causal && k0 > plast) ||
                      (a.window > 0 && p0 > klast + a.window - 1);
    if (!dead) {
      char* qs = q_s + st * P::kQStage;
      char* ds = do_s + st * P::kQStage;
      const char* theirs = wg == 0 ? qs : ds;
      char* pb = p_s + (it & 1) * P::kTile;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(
            acc, hopper::desc_sw128(mine + p * P::kKPanel + off, 16, 1024),
            hopper::desc_sw128(theirs + p * P::kQPanel + off, 16, 1024),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<kBQ / 2>(acc);
      if (wg == 0) {
        // P^T in bf16: column c of n-tile j is query p0 + 8 j + 2 tq + (e & 1)
        const float* ls = lse_s + st * kBQ;
        const bool edge = k0 + kWBKeys - 1 >= a.Sk || plast >= a.Sq ||
                          (a.causal && k0 + kWBKeys - 1 > p0) ||
                          (a.window > 0 && k0 <= plast - a.window);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float2 l = *reinterpret_cast<const float2*>(ls + c);
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = hopper::exp2_approx(
                fmaf(acc[4 * j + e], a.scale_log2, (e & 1) ? -l.y : -l.x));
            if (edge) {
              const int pos = p0 + c + (e & 1);
              const bool lv = e < 2 ? (pos >= lo0 && pos <= hi0)
                                    : (pos >= lo1 && pos <= hi1);
              x[e] = lv ? x[e] : 0.f;
            }
          }
          *tile_pair(pb, r0, j, tq) = hopper::pack_bf16(x[0], x[1]);
          *tile_pair(pb, r1, j, tq) = hopper::pack_bf16(x[2], x[3]);
        }
        hopper::fence_proxy_async();
      }
      hopper::named_sync(1, kW);           // P^T in shared memory
      // dV (this warpgroup's half) += P^T dO
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc)
        hopper::wgmma_ss_n128<1>(
            dv, hopper::desc_sw128(pb + kc * 32, 16, 1024),
            hopper::desc_sw128(ds + 2 * wg * P::kQPanel + kc * 16 * 128,
                               P::kQPanel, 1024), 1);
      hopper::wgmma_commit();
      if (wg == 1) {
        // dS^T = P^T (dP^T - D), P^T read back where this thread's
        // accumulator elements sit
        const float* dd = d_s + st * kBQ;
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 d =
              *reinterpret_cast<const float2*>(dd + 8 * j + 2 * tq);
          const float2 pr0 = unpack_bf16(*tile_pair(pb, r0, j, tq));
          const float2 pr1 = unpack_bf16(*tile_pair(pb, r1, j, tq));
          *tile_pair(x_s, r0, j, tq) =
              hopper::pack_bf16(pr0.x * (acc[4 * j] - d.x),
                                pr0.y * (acc[4 * j + 1] - d.y));
          *tile_pair(x_s, r1, j, tq) =
              hopper::pack_bf16(pr1.x * (acc[4 * j + 2] - d.x),
                                pr1.y * (acc[4 * j + 3] - d.y));
        }
        hopper::fence_proxy_async();
      }
      hopper::named_sync(2, kW);           // dS^T in shared memory
      // dK (this warpgroup's half) += dS^T Q
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc)
        hopper::wgmma_ss_n128<1>(
            dk, hopper::desc_sw128(x_s + kc * 32, 16, 1024),
            hopper::desc_sw128(qs + 2 * wg * P::kQPanel + kc * 16 * 128,
                               P::kQPanel, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<HD / 4>(dk);
      hopper::fence_operands<HD / 4>(dv);
    }
    hopper::mbar_arrive(&empty[st]);
  }

  // accumulator (row r, n-tile j) holds dims 128 wg + 8 j + 2 tq, + 1
  const int d0 = 128 * wg + 2 * tq;
  if (splits == 1) {
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk);
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv);
    const long o0 = (((long)b * a.Sk + k0 + r0) * a.KV + kvh) * HD + d0;
    const long o1 = o0 + 8L * a.KV * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      if (k0 + r0 < a.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + o0 + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j] * a.scale,
                                  dk[4 * j + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + o0 + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      }
      if (k0 + r1 < a.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + o1 + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2] * a.scale,
                                  dk[4 * j + 3] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + o1 + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  } else {
    float* pk = a.part + ((((long)b * a.KV + kvh) * a.nslots + blockIdx.x) *
                          2) * kWBKeys * HD;
    float* pv = pk + kWBKeys * HD;
    const long o0 = (long)r0 * HD + d0, o1 = o0 + 8 * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      *reinterpret_cast<float2*>(pk + o0 + 8 * j) =
          make_float2(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<float2*>(pv + o0 + 8 * j) =
          make_float2(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<float2*>(pk + o1 + 8 * j) =
          make_float2(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<float2*>(pv + o1 + 8 * j) =
          make_float2(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// (a) at head_dim 256: as bwd_dq_kernel (rows that are (position, head)
// pairs of a kv group, Q and dO loaded once by TMA, D from dO and O), but
// with 32-key K and V tiles in a ring of three (see QPlan256) loaded by
// warp 0, S and dP with wgmma m64n32k16, and dQ += dS K as two m64n128k16
// halves of the 256 dims.  Registers: dQ 128 fp32, S and dP 16 each, dS 8.
__global__ void __launch_bounds__(kW, 1)
bwd_dq256_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, BArgs a) {
  constexpr int HD = 256;
  using P = QPlan256;
  extern __shared__ char smem_raw[];
  char* base = hopper::align1024(smem_raw);
  char* q_s = base + P::kQ;
  char* do_s = base + P::kDO;
  char* k_s = base + P::kK;
  char* v_s = base + P::kV;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + P::kBars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kWDStages;

  const int qtile = gridDim.x - 1 - blockIdx.x;    // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qtile * 2 * a.qt;
  const int qlast = imin(q0 + 2 * a.qt, a.Sq) - 1;
  const int first =
      (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / kWDKeys;
  const int last = (a.causal ? imin(qlast, a.Sk - 1) : a.Sk - 1) / kWDKeys;
  const int nt = last - first + 1;
  const int rows = a.G * a.qt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kWDStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kW);
    }
  }
  const int pad = (64 - rows) * 8;   // 16-byte chunks per panel
  for (int i = tid; i < 4 * P::kPanels * pad; i += kW) {
    const int panel = i / pad, c = i - panel * pad;
    *reinterpret_cast<uint4*>(q_s + panel * P::kQPanel + rows * 128 + c * 16) =
        make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();
  hopper::fence_barrier_init();
  __syncthreads();

  const int wg = tid / 128, lane = tid % 32;
  const bool loader = tid < 32;
  // tile it into stage it % kWDStages, once both warpgroups released it
  auto load = [&](int it) {
    const int s = it % kWDStages, ph = (it / kWDStages) & 1;
    hopper::mbar_wait(&empty[s], ph ^ 1);
    if (lane == 0) {
      const int key0 = (first + it) * kWDKeys;
      hopper::mbar_expect_tx(&full[s], 2 * P::kKVStage);
      for (int p = 0; p < P::kPanels; ++p) {
        hopper::tma_load_4d(k_s + s * P::kKVStage + p * P::kKVPanel, &kmap,
                            &full[s], 64 * p, h, key0, b);
        hopper::tma_load_4d(v_s + s * P::kKVStage + p * P::kKVPanel, &vmap,
                            &full[s], 64 * p, h, key0, b);
      }
    }
  };
  if (loader) {
    if (lane == 0) {
      hopper::mbar_expect_tx(q_bar, 2 * 2 * P::kPanels * rows * 128);
      for (int g = 0; g < 2; ++g)
        for (int p = 0; p < P::kPanels; ++p) {
          const int off = (g * P::kPanels + p) * P::kQPanel;
          hopper::tma_load_4d(q_s + off, &qmap, q_bar, 64 * p, h * a.G,
                              q0 + g * a.qt, b);
          hopper::tma_load_4d(do_s + off, &domap, q_bar, 64 * p, h * a.G,
                              q0 + g * a.qt, b);
        }
    }
    for (int it = 0; it < kWDStages - 1 && it < nt; ++it) load(it);
  }

  const int w = (tid % 128) / 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w + gq, r1 = r0 + 8;       // this thread's two rows
  const int pw0 = q0 + wg * a.qt;                // warpgroup's positions
  const int pw1 = imin(pw0 + a.qt, a.Sq) - 1;
  char* qw = q_s + wg * P::kPanels * P::kQPanel;
  char* dow = do_s + wg * P::kPanels * P::kQPanel;
  const int p0 = pw0 + r0 / a.G, p1 = pw0 + r1 / a.G;
  const bool v0 = r0 < rows && p0 < a.Sq, v1 = r1 < rows && p1 < a.Sq;
  const long hb = (long)b * a.H + (long)h * a.G;
  const long s0 = (hb + r0 % a.G) * a.Sq + p0;
  const long s1 = (hb + r1 % a.G) * a.Sq + p1;
  const float lse0 = v0 ? a.lse[s0] : 0.f, lse1 = v1 ? a.lse[s1] : 0.f;
  const int hi0 = a.causal ? imin(p0, a.Sk - 1) : a.Sk - 1;
  const int hi1 = a.causal ? imin(p1, a.Sk - 1) : a.Sk - 1;
  const int lo0 = a.window > 0 ? p0 - a.window : -1;
  const int lo1 = a.window > 0 ? p1 - a.window : -1;

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float sp[kWDKeys / 2], dp[kWDKeys / 2];
  uint32_t da[kWDKeys / 4];
  hopper::mbar_wait(q_bar, 0);

  // D = rowsum(dO * O), two threads a row, written out for (b)
  float* d_rows = reinterpret_cast<float*>(base + P::kDRows) + 64 * wg;
  {
    const int r = (tid % 128) / 2, half = tid % 2;
    const int pos = pw0 + r / a.G, g = r % a.G;
    float acc = 0.f;
    if (r < rows && pos < a.Sq) {
      const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(a.out) +
          (((long)b * a.Sq + pos) * a.H + (long)h * a.G + g) * HD;
#pragma unroll 4
      for (int c = half * (HD / 16); c < (half + 1) * (HD / 16); ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(
            dow + (c / 8) * P::kQPanel + r * 128 + (((c % 8) ^ (r & 7)) * 16));
        const uint4 y = *reinterpret_cast<const uint4*>(orow + c * 8);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xf = __bfloat1622float2(xp[i]);
          const float2 yf = __bfloat1622float2(yp[i]);
          acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_rows[r] = acc;
      if (r < rows && pos < a.Sq) a.delta[(hb + g) * a.Sq + pos] = acc;
    }
    hopper::named_sync(1 + wg, 128);
  }
  const float d0 = d_rows[r0], d1 = d_rows[r1];

  for (int it = 0; it < nt; ++it) {
    if (loader && it + kWDStages - 1 < nt) load(it + kWDStages - 1);
    const int s = it % kWDStages;
    const int kb = (first + it) * kWDKeys;
    hopper::mbar_wait(&full[s], (it / kWDStages) & 1);
    const bool dead = pw0 >= a.Sq || (a.causal && kb > pw1) ||
                      (a.window > 0 && kb + kWDKeys - 1 <= pw0 - a.window);
    if (!dead) {
      char* ks = k_s + s * P::kKVStage;
      char* vs = v_s + s * P::kKVStage;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n32<0>(
            sp, hopper::desc_sw128(qw + p * P::kQPanel + off, 16, 1024),
            hopper::desc_sw128(ks + p * P::kKVPanel + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_n32<0>(
            dp, hopper::desc_sw128(dow + p * P::kQPanel + off, 16, 1024),
            hopper::desc_sw128(vs + p * P::kKVPanel + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operands<kWDKeys / 2>(sp);
      const bool edge = (a.causal && kb + kWDKeys - 1 > pw0) ||
                        kb + kWDKeys > a.Sk ||
                        (a.window > 0 && kb <= pw1 - a.window);
#pragma unroll
      for (int j = 0; j < kWDKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = hopper::exp2_approx(
              fmaf(sp[4 * j + e], a.scale_log2, e < 2 ? -lse0 : -lse1));
          if (edge) {
            const int key = kb + 8 * j + 2 * tq + (e & 1);
            const bool lv = e < 2 ? (key > lo0 && key <= hi0)
                                  : (key > lo1 && key <= hi1);
            sp[4 * j + e] = lv ? x : 0.f;
          } else {
            sp[4 * j + e] = x;
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands<kWDKeys / 2>(dp);
#pragma unroll
      for (int j = 0; j < kWDKeys / 8; ++j) {
        const float g0 = sp[4 * j] * (dp[4 * j] - d0);
        const float g1 = sp[4 * j + 1] * (dp[4 * j + 1] - d0);
        const float g2 = sp[4 * j + 2] * (dp[4 * j + 2] - d1);
        const float g3 = sp[4 * j + 3] * (dp[4 * j + 3] - d1);
        da[4 * (j / 2) + 2 * (j % 2)] = hopper::pack_bf16(g0, g1);
        da[4 * (j / 2) + 2 * (j % 2) + 1] = hopper::pack_bf16(g2, g3);
      }
      // dQ += dS K (K [key][dim] the MN-major B operand), two 128-dim halves
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kWDKeys / 16; ++kc) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          hopper::wgmma_rs_n128<1>(
              dq + 64 * hh, da + 4 * kc,
              hopper::desc_sw128(ks + 2 * hh * P::kKVPanel + kc * 16 * 128,
                                 P::kKVPanel, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<HD / 2>(dq);
      hopper::fence_operands<kWDKeys / 4>(da);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // the bf16 tile staged in this warpgroup's Q panels, then stored as rows
  constexpr int kRowBytes = HD * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = (j ^ (r0 & 7)) * 16 + 4 * tq;   // r1 & 7 == r0 & 7
    *reinterpret_cast<uint32_t*>(qw + r0 * kRowBytes + c) =
        hopper::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(qw + r1 * kRowBytes + c) =
        hopper::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
  hopper::named_sync(1 + wg, 128);
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq);
  constexpr int kChunks = HD / 8;
  for (int i = tid % 128; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int pos = pw0 + r / a.G, g = r - (r / a.G) * a.G;
    if (r < rows && pos < a.Sq)
      *reinterpret_cast<uint4*>(
          dqg + (((long)b * a.Sq + pos) * a.H + (long)h * a.G + g) * HD +
          c * 8) = *reinterpret_cast<const uint4*>(
          qw + r * kRowBytes + ((c ^ (r & 7)) * 16));
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch_all(const void* q, const void* k, const void* v,
                       const void* dout, const BArgs& a, int B,
                       cudaStream_t stream) {
  constexpr bool kWide = HD == 256;
  constexpr int kKeys = kWide ? kWBKeys : kBKeys;   // a dK/dV block's keys
  // q, dO as (hd, H, Sq, B); k, v as (hd, KV, Sk, B)
  const uint64_t e = 2;
  const uint64_t qd[4] = {(uint64_t)HD, (uint64_t)a.H, (uint64_t)a.Sq,
                          (uint64_t)B};
  const uint64_t qs[3] = {HD * e, (uint64_t)a.H * HD * e,
                          (uint64_t)a.Sq * a.H * HD * e};
  const uint64_t kd[4] = {(uint64_t)HD, (uint64_t)a.KV, (uint64_t)a.Sk,
                          (uint64_t)B};
  const uint64_t ks[3] = {HD * e, (uint64_t)a.KV * HD * e,
                          (uint64_t)a.Sk * a.KV * HD * e};
  // dK/dV blocks: one head's 64-query tile, kKeys keys; dQ blocks: G heads
  // x qt positions, 64 keys (32 at head_dim 256)
  const uint32_t q_item[4] = {64, 1, kBQ, 1};
  const uint32_t k_item[4] = {64, 1, kKeys, 1};
  const uint32_t q_rows[4] = {64, (uint32_t)a.G, (uint32_t)a.qt, 1};
  const uint32_t k_tile[4] = {64, 1, kWide ? kWDKeys : kDKeys, 1};
  CUtensorMap m[8];
  const void* qsrc[2] = {q, dout};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = hopper::make_tensor_map(&m[i], 4, qsrc[i], qd, qs, q_item);
    if (err == cudaSuccess)
      err = hopper::make_tensor_map(&m[4 + i], 4, qsrc[i], qd, qs, q_rows);
  }
  const void* ksrc[2] = {k, v};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = hopper::make_tensor_map(&m[2 + i], 4, ksrc[i], kd, ks, k_item);
    if (err == cudaSuccess)
      err = hopper::make_tensor_map(&m[6 + i], 4, ksrc[i], kd, ks, k_tile);
  }
  if (err != cudaSuccess) return err;

  const dim3 qgrid((a.Sq + 2 * a.qt - 1) / (2 * a.qt), a.KV, B);
  const dim3 kgrid(a.nslots, a.KV, B);
  if constexpr (kWide) {
    err = allow_smem(bwd_dq256_kernel, QPlan256::kSmem);
    if (err != cudaSuccess) return err;
    bwd_dq256_kernel<<<qgrid, kW, QPlan256::kSmem, stream>>>(m[4], m[5],
                                                             m[6], m[7], a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = allow_smem(bwd_dkdv256_kernel, KVPlan256::kSmem);
    if (err != cudaSuccess) return err;
    bwd_dkdv256_kernel<<<kgrid, kW, KVPlan256::kSmem, stream>>>(
        m[0], m[1], m[2], m[3], a);
  } else {
    err = allow_smem(bwd_dq_kernel<HD>, QPlan<HD>::kSmem);
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<HD><<<qgrid, kThreads, QPlan<HD>::kSmem, stream>>>(
        m[4], m[5], m[6], m[7], a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = allow_smem(bwd_dkdv_kernel<HD>, KVPlan<HD>::kSmem);
    if (err != cudaSuccess) return err;
    bwd_dkdv_kernel<HD><<<kgrid, kConsumers, KVPlan<HD>::kSmem, stream>>>(
        m[0], m[1], m[2], m[3], a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (a.nslots > key_tiles(a, kKeys)) {  // partials to sum
    bwd_reduce_kernel<HD, kKeys><<<
        dim3(key_tiles(a, kKeys) * (kKeys * HD / 1024), a.KV, B), 256, 0,
        stream>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// bf16 q, k, v, out, dout, dq, dk, dv with head_dim 64, 128 or 256.  q,
// out, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd); all
// contiguous and 16-byte aligned.  lse: the forward kernel's log2-sum-exp,
// float32 (B, H, Sq); delta: float32 (B, H, Sq) scratch; plan: the dK/dV
// plan (flash_attention.py: bwd_split_plan) on the device for key tiles of
// `keys` = 128 (64 at head_dim 256), int32 (ceil(Sk / keys), 4), row t =
// (jlo, n, splits, first block) of key tile t; plan_rows: its rows, which
// must be ceil(Sk / keys); nslots: its blocks per (batch row, kv head),
// the sum of its splits; part: float32 scratch of part_len values, which
// must be B * KV * nslots * 2 * keys * hd when nslots exceeds the key
// tiles (the third kernel sums them in run order) and 0 otherwise.
// H / KV <= 64; every query row must hold at least one live key (the
// wrapper checks).  Launches the kernels in order on `stream`; returns the
// first cudaError_t (0 = success).
extern "C" int flash_attention_hopper_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* part, const void* plan, int B, int Sq, int Sk, int H,
    int KV, int hd, int causal, int window, float scale, int nslots,
    int plan_rows, long long part_len, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || window < 0 || B > 65535 || KV > 65535 ||
      (hd != 64 && hd != 128 && hd != 256))
    return (int)cudaErrorInvalidValue;
  BArgs a;
  a.lse = static_cast<const float*>(lse);
  a.out = out;
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.part = static_cast<float*>(part);
  a.plan = static_cast<const int4*>(plan);
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.qt = 64 / a.G;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  const int keys = hd == 256 ? kWBKeys : kBKeys;
  const int tiles = key_tiles(a, keys);
  if (plan_rows != tiles || nslots < tiles ||
      part_len != (nslots > tiles
                       ? (long long)B * KV * nslots * 2 * keys * hd : 0LL))
    return (int)cudaErrorInvalidValue;
  a.nslots = nslots;
  // The tensor maps are encoded by the driver, which refuses them on a
  // thread with no current context; autograd may run this on a thread
  // where no runtime call has made one current yet.  cudaFree(nullptr)
  // frees nothing and makes the primary context current.
  const cudaError_t ctx = cudaFree(nullptr);
  if (ctx != cudaSuccess) return (int)ctx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 256) return (int)launch_all<256>(q, k, v, dout, a, B, s);
  if (hd == 128) return (int)launch_all<128>(q, k, v, dout, a, B, s);
  return (int)launch_all<64>(q, k, v, dout, a, B, s);
}
