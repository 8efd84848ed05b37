#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--layers N]

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions; TF32 switched off for matmuls and cuDNN.
2. build   — compile every CUDA source of ``src/repro_torch/csrc`` with nvcc,
   one process per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes, with the stated tolerances: paged attention
   (bf16, fp32, and fp32 queries over bf16 pools) and quantized paged
   attention (int8 and fp8 codes under bf16 and fp32 queries), each at the
   main path's positions (up to ~200) and at a long-context case (440-509
   in the engine's max_seq = 512 table), and at the split plan's other
   shapes (B = KV = 1, G = 16, a window that leaves splits empty, head_dim
   8, 16, 40 and 256, pages of 4, 8 and 32 rows), both timed at the two
   position ranges with the wrapper's host time per call; the fused
   log-softmax gather (the
   target's row-major unembedding with fp32 and bf16 h, and the draft's
   tied, transposed embedding; timed with bf16 h and with fp32 h), flash
   attention (target and draft heads, bf16 through the TMA/wgmma kernel
   and fp32; bf16 at the toy head dims 40 and 16 through the mma.sync
   kernel, G = 7 and 1; causal with no window and with one shorter than
   every tile, S = 1000) and the WKV6 scan (rwkv6-3b's heads at its decode,
   shared-scoring and full-sequence shapes in bf16, and a toy hd = 32 in
   fp32; spread decays and a non-zero initial state; then decays at the
   model's clamp ends and mixed, B = H = 1 at T = 4096 (32 segments), the
   in-place decode form with half the rows frozen (their state compared
   bitwise), two calls bitwise equal, a capture into a CUDA graph and two
   streams at once; timed with the wrapper's host time per call).  Each
   kernel's time
   beside its bound, the plain version's time and, where one exists, one
   PyTorch library call computing the same function (a yardstick the port
   never calls).  Launches made here are not counted.
4. main paths — the full-width Qwen2.5-Math draft/target/PRM triple with
   seeded random weights in bf16, served by the paged GSI engine through
   the continuous-batching scheduler: (a) 6 requests on 4 slots over bf16
   pages at a threshold among the selected tilted rewards, so that it both
   accepts draft candidates and falls back (both counted and required),
   (d) run (a) again through the pipelined scheduler (``sync=False``, the
   CLI's default), whose tokens, finish reasons, engine steps, accepted
   and decision counts, prefix counters and paged-attention launches must
   equal (a)'s bit for bit, with host work overlapping a step
   (``pipeline_stats``), (b) a short run whose threshold no tilted reward
   can reach, so the target fallback must run, and (c) 5 requests over
   int8 pages with shared scoring and the draft's weights rounded through
   int8.  Then run
   score-prm, at full depth: the sequences (a) finished go through
   target.prefill, target.score, draft.score and PRM.reward_at_end, and
   each result is held against the decode path (teacher-forced paged
   decode_step) on the same tokens.  Every kernel launch counter is zeroed
   just before each run and read just after: in (a), (d) and (b) every paged
   attention call launched the bf16 kernel; in (c) every one launched the
   quantized kernel and the vocab gather ran twice per draft phase; in
   score-prm the flash kernel ran once per layer of every full-sequence
   call and the gather once per score call, with no paged launch.
   Then, once the Qwen weights are freed, the full-width full-depth
   rwkv6-3b triple (bf16, seeded random weights, every decay_base
   overwritten so the WKV state carries): run gsi-rwkv-shared serves 4
   requests through the dense engine with shared scoring, at a threshold
   at which it both accepts draft candidates and falls back to the target
   (both counted and required), and the scan ran
   exactly layers x (decode_step calls + score_candidates calls) times and
   the gather once per score_candidates call; run score-rwkv puts its
   sequences through the four full-sequence calls (the scan once per layer
   of each, the gather twice) and holds them against the decode path
   (printing the counted bf16 run's own gap as a control, then in fp32
   activations over the same weights).
4b. agreement — a toy fp32 triple at temperature 0: paged (kernel) against
   dense (plain attention) serving on the card, bf16 pages under its fp32
   activations (the kernel's fp32-query, bf16-pool instance) on the card
   against the CPU, and int8 / fp8 pages with shared scoring on the card
   against the same engine on the CPU; then the
   toy models' forward, score, prefill and rewards on the card (head_dim 16
   and 40, a full/local stack with a window shorter than S) against the
   CPU; and a toy fp32 RWKV triple served dense and paged on the card
   commits the CPU's tokens, its forward, score, prefill state and rewards
   matching the CPU's.
5. profile — one engine step of (a) (at threshold 0.5, as it was profiled
   before it had its own threshold) and of (c), then two consecutive
   pipelined dispatches of (a)'s configuration (after the first, the
   window pump, dispatch, pump), one score-prm batch and one engine step of
   gsi-rwkv-shared, under ``torch.profiler`` (device activity only; each
   with the device's busy and idle share); a paged kernel's row counts its
   split and combine kernels together.

The line before the last is ``{"kernels": [...]}``: every ported kernel
with its largest error in phase 3, its timings and its launch count from the
phase-4 run(s) of its path (the gather's row also carries its fp32-h
timings under ``fp32_h_*``, the paged rows their long-context timings
under ``long_*`` and the wrapper's host time per call under ``host_ms``).
The last line is ``{"ok": true, "device": {...}}``.  ``--layers`` cuts
the depth of runs (a), (d) and (b) (never a width, never run (c),
score-prm or the RWKV runs) and says so on a ``reduced:`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12                 # HBM3, H100 SXM data sheet
PEAK_OPS = {"torch.bfloat16": 989e12,      # dense tensor-core bf16
            "torch.float32": 67e12}        # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
TOL = {"torch.float32": 2e-5,
       # the plain version casts the probabilities to bf16 before the P.V
       # product (as the reference does); the kernel keeps them in fp32.
       # The quantized pair computes in fp32 on both sides and differs by
       # the output's one bf16 rounding
       "torch.bfloat16": 2e-2}
# log-probs: both sides in fp32 from the same inputs (bf16 x bf16 products
# are exact in fp32); they differ in summation order over d and the vocab,
# an error that grows with the logits: 1e-3 absolute plus 1e-5 of the
# log-prob (the draft's tied std-1 embedding gives log-probs near -300)
LOGPROB_ATOL, LOGPROB_RTOL = 1e-3, 1e-5
# run score-prm against the decode path: two kernels (flash, with bf16
# probabilities, and paged decode, with fp32 ones) and GEMMs of other row
# counts round the bf16 activations of 28 layers at different points, each
# rounding a relative 2^-9, and the decode path's logits are themselves
# bf16 (half an ulp is 0.016 at |logit| 4-8).  The target's logits have a
# std near 1 (post-norm states over a 1/sqrt(d) unembedding).  Held to 0.1
# in log-probs (nats) and in logits, and to 0.01 in rewards (a sigmoid,
# slope at most 1/4, of a logit of the same scale)
LP_TOL, LOGIT_TOL, REWARD_TOL = 0.1, 0.1, 0.01
# run score-rwkv against the decode path: the random-weight RWKV stack
# amplifies the two paths' different roundings from layer to layer, so in
# bf16 activations the 32-layer gap is of the order of a nat (the run
# prints it as a control and requires it above LP_TOL, which shows that
# the fp32 comparison is the one able to see a fault).  Both paths then
# run again with fp32 activations over the same bf16 weights and are held
# to score-prm's tolerances, and the state that prefill leaves in layer 0,
# which no depth amplifies, is held to the state decode carries to the
# same position within TOY_RTOL of its scale
# phase 4b, card against CPU in fp32: summation orders differ (cuBLAS and
# the kernels against the CPU's), 1e-4 of each output's scale
TOY_RTOL = 1e-4
# the toy RWKV triple's draft and target disagree (independent random
# weights), so its tilted rewards are negative: this threshold both accepts
# and rejects
TOY_RWKV_THRESHOLD = -2.0
# run gsi-rwkv-shared: at full width the draft and target (independent
# random weights) disagree too, so tilted rewards r + (log pi_B - log pi_S)
# / beta lie below the PRM's rewards; this threshold lies among the
# selected tilted rewards, so the run both accepts a draft candidate and
# falls back to the target
RWKV_THRESHOLD = -0.29
# run gsi: the full-width Qwen2.5-Math draft (tied std-1 embedding, nearly
# deterministic) and target (independent random weights) disagree by about
# 12 nats a token, so its selected tilted rewards lie near -10 (-10.75 to
# -8.45 in a chip run at threshold 0.5, which nothing reached); this
# threshold lies among them, so the run commits accepted draft candidates
# over paged caches and falls back to the target
QWEN_THRESHOLD = -9.5


T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def elapsed(what):
    print(f"elapsed {time.perf_counter() - T0:.1f} s after {what}",
          flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# Phase 3 helpers: main-path-shaped paged attention inputs
# ----------------------------------------------------------------------

def paged_case(torch, *, H, KV, dtype, seed, hd=128, ps=16, slots=4, n=4,
               nblk=32, span=2, lo=20, hi=190):
    """Inputs shaped like one layer's paged attention call on the main path.

    Pool: ``slots * nblk`` allocatable pages + ``slots * n * span`` scratch
    pages + 1 trash page, filled with random values (stale garbage
    everywhere).  Rows are ``slots * n`` candidate branches: each branch
    aliases its slot's committed pages below its write block (slot 1 shares
    slot 0's first three pages, as a prefix-cache hit does) and writes into
    its own scratch pages from there; unassigned columns and the extra
    table column point at the trash page.  Slot positions are drawn from
    [lo, hi) (the main path's ~200 by default; the long-context case takes
    440-500 in the engine's max_seq = 512 table), branches 3 apart.
    """
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = slots * nblk + slots * n * span + 1
    trash = P - 1
    kp = torch.randn((P, ps, KV, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, KV, hd), generator=gen, device=dev).to(dtype)
    B = slots * n
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dtype)
    cpu = torch.Generator().manual_seed(seed)
    perm = torch.randperm(slots * nblk, generator=cpu)
    committed = perm.reshape(slots, nblk)
    committed[1, :3] = committed[0, :3]            # shared prefix pages
    slot_pos = torch.randint(lo, hi, (slots,), generator=cpu)
    pt = torch.full((B, nblk + 1), trash, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    scratch = slots * nblk
    for s in range(slots):
        base = int(slot_pos[s])
        blk0 = base // ps
        for j in range(n):
            b = s * n + j
            p = base + 3 * j                        # branches at their own
            pos[b] = p                              # progress in the step
            pt[b, :blk0] = committed[s, :blk0]
            for k in range(span):
                col = min(blk0 + k, nblk)
                pt[b, col] = scratch
                scratch += 1
    return q, kp, vp, pt.to(dev), pos.to(dev)


# the split plan's shapes beyond the main path's (B, H, KV, head_dim, page
# size, table columns, largest pos, window): B = KV = 1 (one (row, kv head)
# pair, 9 splits), G = 16, a window that leaves splits empty, the toys'
# head dims 8, 16 and 40, pages of 4, 8 and 32 rows, head_dim 256 (fp32
# pools of 32-row pages are cut into 16-row units); the largest pos of
# each sits in the trash column or near the table's end
SPLIT_SHAPES = {
    "b1kv1": (1, 7, 1, 128, 16, 33, 527, 0),
    "g16": (4, 32, 2, 64, 16, 33, 300, 0),
    "window": (8, 28, 4, 128, 16, 33, 527, 40),
    "hd8": (4, 8, 2, 8, 16, 12, 180, 0),
    "hd16-g1": (4, 4, 4, 16, 16, 12, 180, 8),
    "hd40-ps8": (4, 14, 2, 40, 8, 20, 150, 8),
    "ps4-g1": (3, 4, 4, 16, 4, 40, 150, 0),
    "hd256-ps32": (3, 14, 2, 256, 32, 10, 300, 0),
}


def split_case(torch, shape, qdt, pool, seed):
    """One paged call at ``SPLIT_SHAPES[shape]``: distinct random pages in
    every column but the last (the trash page), stale values everywhere,
    rows 0 and 1 sharing their first page, positions spread from the
    largest down to 0.  ``pool`` is a dtype or "int8" / "fp8" (codes and
    scales as the engine writes them)."""
    from repro_torch.kernels import quant
    B, H, KV, hd, ps, nblk1, top, window = SPLIT_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = B * (nblk1 - 1) + 1
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(qdt)
    kp, vp = (torch.randn((P, ps, KV, hd), generator=gen, device="cuda")
              for _ in range(2))
    cpu = torch.Generator().manual_seed(seed)
    pt = torch.randperm(P - 1, generator=cpu)[:B * (nblk1 - 1)].reshape(
        B, nblk1 - 1)
    pt[min(1, B - 1), 0] = pt[0, 0]
    pt = torch.cat([pt, torch.full((B, 1), P - 1)], dim=1).int().cuda()
    pos = torch.linspace(top, 0, B).int().cuda()
    if not isinstance(pool, str):
        return (q, kp.to(pool), vp.to(pool), pt, pos), window
    codes = []
    for x in (kp, vp):
        sc = x.abs().amax(dim=(1, 3)).clamp(min=quant.EPS) / quant.QMAX[pool]
        codes += [quant.quantize_codes(x / sc[:, None, :, None],
                                       quant.pool_dtype(pool, qdt)), sc]
    return (q, codes[0], codes[2], codes[1], codes[3], pt, pos), window


def check_split_shapes(torch, fn, plain, name, instances):
    """``fn`` against ``plain`` at every :data:`SPLIT_SHAPES` entry for each
    (q dtype, pool) instance; returns the largest error."""
    worst = 0.0
    for qdt, pool in instances:
        errs = []
        for shape in SPLIT_SHAPES:
            args, window = split_case(torch, shape, qdt, pool,
                                      len(shape) + len(str(pool)))
            got = fn(*args, window=window)
            want = plain(*args, window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} {shape}: non-finite kernel output")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[str(qdt)]
            check(err <= tol, f"{name} {shape} q={qdt} pools={pool}: error "
                  f"{err} > {tol}")
            errs.append(err)
        worst = max(worst, *errs)
        print(f"{name} at the split shapes ({', '.join(SPLIT_SHAPES)}), "
              f"q={str(qdt)[6:]} pools={str(pool).replace('torch.', '')}: "
              f"max_abs_err={max(errs):.3e} (tol {TOL[str(qdt)]:.0e})",
              flush=True)
    return worst


def live_rows(pt, pos, ps, window):
    """Unique physical pool rows the live positions of every row read."""
    rows, n_live = set(), 0
    nblk1 = pt.shape[1]
    for b in range(pt.shape[0]):
        p = int(pos[b])
        lo = max(0, p - window + 1) if window else 0
        hi = min(p, nblk1 * ps - 1)
        for kpos in range(lo, hi + 1):
            rows.add(int(pt[b, kpos // ps]) * ps + kpos % ps)
        n_live += hi - lo + 1
    return rows, n_live


def bound(arg_sets, window):
    """Least mean time per call the card could take over ``arg_sets`` (the
    sets :func:`time_ms` cycles through): the larger of the bytes each call
    must move (live K/V rows once, q, out, table, positions) over the HBM
    rate, and its operations over the peak rate for the dtype."""
    nbytes = ops = 0
    for q, kp, _, pt, pos in arg_sets:
        H, hd = q.shape[2:]
        ps, KV = kp.shape[1], kp.shape[2]
        esize = q.element_size()
        rows, n_live = live_rows(pt.cpu(), pos.cpu(), ps, window)
        nbytes += len(rows) * KV * hd * esize * 2 + 2 * q.numel() * esize \
            + pt.numel() * 4 + pos.numel() * 4
        ops += 4 * (H // KV) * KV * hd * n_live     # QK and PV, 2 flops each
    t_bytes = nbytes / len(arg_sets) / H100_BYTES_PER_S
    t_ops = ops / len(arg_sets) / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, arg_sets, iters=40, enqueue=False):
    """Mean ms per call with CUDA events, cycling through ``arg_sets``
    (together larger than the L2 cache, so K/V comes from HBM).

    Returns ``(device_ms, back_to_back_ms)``, and with ``enqueue`` also
    ``host_ms``.  ``device_ms`` enqueues every call behind a ~0.5 s device
    sleep, so the card runs them back to back whatever the host's per-call
    cost: the function's own time on the card (checked: the timed region
    must not have started when the host finished enqueueing).
    ``back_to_back_ms`` is the same loop without the sleep, where a host
    slower than the card shows up as the per-call time.  ``host_ms`` is the
    host clock's time per call of the queued loop: what one call costs the
    host, whatever the card does.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for queued in (True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(1_000_000_000)        # clock cycles
        start.record()
        count = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            for args in arg_sets:
                fn(*args)
                count += 1
        host_ms = (time.perf_counter() - t0) * 1e3 / count
        end.record()
        if queued:
            check(not start.query(), "timing: the host did not finish "
                  "enqueueing before the device sleep ended")
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / count)
        if queued:
            enqueue_ms = host_ms
    return (*out, enqueue_ms) if enqueue else tuple(out)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_device(torch):
    print("== phase 1: device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False "
          "torch.backends.cudnn.allow_tf32=False", flush=True)
    return smi[0]


def phase_build():
    print("== phase 2: build", flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        print(f"built {name}: {build.library_path(name).name}", flush=True)
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the mangled name without its file prefix and arguments
                kernel = re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "",
                                line.split("'")[1]).split("EEv")[0]
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {kernel}: {line.strip()}", flush=True)
    print(f"build seconds: {secs:.2f}", flush=True)


def paged_sets(torch, make, budget):
    """Input sets from ``make(i)`` until their pools pass ``budget`` bytes
    (twice the L2 cache), so K/V comes from HBM when they are cycled."""
    sets = []
    while sum(s[1].numel() * s[1].element_size() * 2 for s in sets) < budget:
        sets.append(make(len(sets)))
    return sets


def gathered_kv(torch, q, k, v, pt, pos):
    """SDPA's inputs for one paged call: q (B, H, 1, hd) and K/V gathered
    through the table into (B, KV, S, hd), with the causal mask (the
    library yardstick's gather is not timed)."""
    B, _, _, hd = q.shape
    P, ps, KV = k.shape[:3]
    S = pt.shape[1] * ps
    rows = (pt.long()[:, :, None] * ps
            + torch.arange(ps, device="cuda")).reshape(B, S)
    kg = k.reshape(P * ps, KV, hd)[rows].transpose(1, 2).contiguous()
    vg = v.reshape(P * ps, KV, hd)[rows].transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None] <= pos[:, None].long())
    return q.transpose(1, 2).contiguous(), kg, vg, mask[:, None, None]


def time_paged(torch, name, fn, plain, sets, plain_sets, lib_sets, bounds,
               what, iters):
    """Time ``fn``, ``plain`` and SDPA over the cycled sets; print the
    device-only and the back-to-back lines; return the numbers."""
    ms, ms_host, enqueue_ms = time_ms(torch, lambda *a: fn(*a), sets,
                                      iters=iters, enqueue=True)
    plain_ms, plain_host = time_ms(torch, lambda *a: plain(*a), plain_sets,
                                   iters=1)
    library_ms, library_host = time_ms(torch, sdpa, lib_sets, iters=5)
    bound_ms, bound_by = bounds
    print(f"{name} timing ({what}; kernel {len(sets)} input sets cycled past"
          f" L2, plain {len(plain_sets)}, library {len(lib_sets)}), "
          f"device-only ms per call: kernel {ms:.4f}, bound {bound_ms:.6f} "
          f"({bound_by}, mean over the sets), plain {plain_ms:.4f}, library "
          f"(scaled_dot_product_attention over pre-gathered K/V) "
          f"{library_ms:.4f}", flush=True)
    print(f"{name} timing ({what}), back-to-back launches from the host "
          f"(host cost included), ms per call: kernel {ms_host:.4f}, plain "
          f"{plain_host:.4f}, library {library_host:.4f}; the wrapper's "
          f"host time per call (enqueue only) {enqueue_ms:.4f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "back_to_back_ms": ms_host, "host_ms": enqueue_ms}


def print_plan(name, B, KV, nblk1, ps):
    from repro_torch.kernels.paged_attention import split_plan
    splits, bps = split_plan(B, KV, nblk1, ps)
    print(f"{name} split plan at B={B} KV={KV} table={nblk1} ps={ps}: "
          f"{splits} splits of {bps} logical blocks, {B * KV * splits} "
          f"blocks", flush=True)


def phase_kernels(torch):
    print("== phase 3: paged_attention vs its plain version", flush=True)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    # (q dtype, pool dtype): fp32 queries over bf16 pools are the
    # kernel's widening instance (kv_dtype="bf16" under fp32 activations)
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.float32, torch.bfloat16))
    # the main path's positions (~200), and the long-context case (440-509
    # in the engine's max_seq = 512 table)
    spans = {"": (20, 190, 0), " long": (440, 500, 1000)}
    for tag, (H, KV) in shapes.items():
        print_plan("paged_attention", 16, KV, 33, 16)
        for span, (lo, hi, off) in spans.items():
            for dtype, pool in pairs:
                for window in (0, 64):
                    q, kp, vp, pt, pos = paged_case(
                        torch, H=H, KV=KV, dtype=dtype,
                        seed=H + window + off, lo=lo, hi=hi)
                    kp, vp = kp.to(pool), vp.to(pool)
                    got = paged_attention_cuda(q, kp, vp, pt, pos,
                                               window=window)
                    want = paged_attention_plain(q, kp, vp, pt, pos,
                                                 window=window)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{tag}: non-finite kernel output")
                    err = (got.float() - want.float()).abs().max().item()
                    tol = TOL[str(dtype)]
                    print(f"paged_attention {tag}{span} H={H} KV={KV} hd=128"
                          f" ps=16 rows={q.shape[0]} table={pt.shape[1]} "
                          f"pos<={int(pos.max())} q={str(dtype)[6:]} pools="
                          f"{str(pool)[6:]} window={window}: max_abs_err="
                          f"{err:.3e} (tol {tol:.0e})", flush=True)
                    check(err <= tol, f"paged_attention {tag}{span} {dtype} "
                          f"over {pool} window {window}: error {err} > {tol}")
                    max_err = max(max_err, err)
    max_err = max(max_err, check_split_shapes(
        torch, paged_attention_cuda, paged_attention_plain,
        "paged_attention", pairs))

    # timing at the target's main-path shape, bf16, full attention; then
    # the long-context case
    H, KV = shapes["target"]
    row = {}
    for span, (lo, hi, off) in spans.items():
        sets = paged_sets(torch, lambda i: paged_case(
            torch, H=H, KV=KV, dtype=torch.bfloat16, seed=100 + i + off,
            lo=lo, hi=hi), 2 * L2_BYTES)
        # few enough calls that the launch queue never fills in the sleep
        got = time_paged(
            torch, f"paged_attention{span}", paged_attention_cuda,
            paged_attention_plain, sets, sets,
            [gathered_kv(torch, *s) for s in sets], bound(sets, 0),
            f"target shape, bf16, pos<={max(int(s[4].max()) for s in sets)}",
            iters=20)
        row.update({("long_" if span else "") + k: v
                    for k, v in got.items()})
    # launches are read from the main path's run (phase 4), not from here
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:172",
            "launches": 0, "max_abs_err": max_err, **row}


def deq(torch, pool, sc, dtype):
    """A code pool dequantized to ``dtype`` (page scale per (page, head))."""
    return (pool.float() * sc[:, None, :, None]).to(dtype)


def quant_case(torch, *, H, KV, dtype, kv, seed, lo=20, hi=190):
    """:func:`paged_case` over code pools, quantized as the engine writes
    them: each (page, kv head) of the N(0, 1) pools, scaled by a random
    factor in [0.25, 2), gets the scale amax / QMAX and codes in range.  The
    same table (stale rows, a shared prefix, scratch pages, the trash
    column)."""
    from repro_torch.kernels import quant
    q, kp, vp, pt, pos = paged_case(torch, H=H, KV=KV, dtype=dtype,
                                    seed=seed, lo=lo, hi=hi)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = []
    for pool in (kp, vp):
        fp = pool.float() * (0.25 + 1.75 * torch.rand(
            (pool.shape[0], 1, KV, 1), generator=gen, device="cuda"))
        sc = fp.abs().amax(dim=(1, 3)).clamp(min=quant.EPS) / quant.QMAX[kv]
        out += [quant.quantize_codes(fp / sc[:, None, :, None],
                                     quant.pool_dtype(kv, dtype)), sc]
    return q, out[0], out[2], out[1], out[3], pt, pos


def bound_quant(arg_sets, window):
    """:func:`bound` for the quantized kernel: one byte per code, plus the
    two fp32 scales of every page a live position reads."""
    nbytes = ops = 0
    for q, kp, _, _, _, pt, pos in arg_sets:
        H, hd = q.shape[2:]
        ps, KV = kp.shape[1], kp.shape[2]
        rows, n_live = live_rows(pt.cpu(), pos.cpu(), ps, window)
        pages = {r // ps for r in rows}
        nbytes += len(rows) * KV * hd * 2 + len(pages) * KV * 4 * 2 \
            + 2 * q.numel() * q.element_size() + pt.numel() * 4 \
            + pos.numel() * 4
        ops += 4 * (H // KV) * KV * hd * n_live
    t_bytes = nbytes / len(arg_sets) / H100_BYTES_PER_S
    t_ops = ops / len(arg_sets) / PEAK_OPS[str(arg_sets[0][0].dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels_quant(torch):
    print("== phase 3: paged_attention_quant vs its plain version",
          flush=True)
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_cuda, paged_attention_quant_plain)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    spans = {"": (20, 190, 0), " long": (440, 500, 1000)}
    for tag, (H, KV) in shapes.items():
        for span, (lo, hi, off) in spans.items():
            for kv in ("int8", "fp8"):
                for dtype in (torch.bfloat16, torch.float32):
                    for window in (0, 64):
                        args = quant_case(torch, H=H, KV=KV, dtype=dtype,
                                          kv=kv, seed=H + window + len(kv)
                                          + off, lo=lo, hi=hi)
                        got = paged_attention_quant_cuda(*args,
                                                         window=window)
                        want = paged_attention_quant_plain(*args,
                                                           window=window)
                        torch.cuda.synchronize()
                        check(bool(torch.isfinite(got).all()),
                              f"{tag} {kv}: non-finite kernel output")
                        err = (got.float() - want.float()).abs().max().item()
                        tol = TOL[str(dtype)]
                        print(f"paged_attention_quant {tag}{span} H={H} "
                              f"KV={KV} hd=128 ps=16 rows={args[0].shape[0]}"
                              f" table={args[5].shape[1]} pos<="
                              f"{int(args[6].max())} {kv} q={str(dtype)[6:]}"
                              f" window={window}: max_abs_err={err:.3e} "
                              f"(tol {tol:.0e})", flush=True)
                        check(err <= tol, f"paged_attention_quant {tag}{span}"
                              f" {kv} {dtype} window {window}: error {err} > "
                              f"{tol}")
                        max_err = max(max_err, err)
    max_err = max(max_err, check_split_shapes(
        torch, paged_attention_quant_cuda, paged_attention_quant_plain,
        "paged_attention_quant",
        ((torch.bfloat16, "int8"), (torch.float32, "int8"),
         (torch.bfloat16, "fp8"), (torch.float32, "fp8"))))

    # timing at the int8 run's target shape: bf16 queries over int8 codes;
    # then the long-context case
    H, KV = shapes["target"]
    row = {}
    for span, (lo, hi, off) in spans.items():
        sets = paged_sets(torch, lambda i: quant_case(
            torch, H=H, KV=KV, dtype=torch.bfloat16, kv="int8",
            seed=200 + i + off, lo=lo, hi=hi), 2 * L2_BYTES)
        # at most a few hundred launches per timed loop, so the launch
        # queue never fills during the device sleep: the kernel cycles all
        # the sets; the plain version (~35 launches a call) a quarter of
        # them; SDPA sets (gathered bf16 K/V, about 17 MB each) six, past
        # L2 on their own
        lib_sets = [gathered_kv(torch, q, deq(torch, kp, ks, q.dtype),
                                deq(torch, vp, vs, q.dtype), pt, pos)
                    for q, kp, vp, ks, vs, pt, pos in sets[:6]]
        got = time_paged(
            torch, f"paged_attention_quant{span}", paged_attention_quant_cuda,
            paged_attention_quant_plain, sets, sets[:len(sets) // 4],
            lib_sets, bound_quant(sets, 0),
            f"target shape, bf16 q over int8 codes, "
            f"pos<={max(int(s[6].max()) for s in sets)}", iters=10)
        row.update({("long_" if span else "") + k: v
                    for k, v in got.items()})
    return {"name": "paged_attention_quant", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention_quant.cu",
            "replaces": "src/repro/kernels/paged_attention.py:121",
            "launches": 0, "max_abs_err": max_err, **row}


def bound_logprob(torch, h, w, vocab):
    """Least time for one call: h, W (once each), labels and the output
    over the HBM rate, against the products' flops over the peak rate they
    run at.  bf16 W: 2 * T * d * vocab flops at the bf16 tensor-core rate
    with bf16 h; with fp32 h, the function the kernel computes, fp32 math
    over bf16 W, is three bf16 products (h split into three bf16 parts, a
    bf16 x bf16 product being exact in fp32): 3 * 2 * T * d * vocab at the
    bf16 rate, which is also below the 2 * T * d * vocab fp32 CUDA-core
    count it replaced (4.165 ms at the target's shape).  fp32 W: the fp32
    rate."""
    T, d = h.shape[0] * h.shape[1], h.shape[2]
    nbytes = h.numel() * h.element_size() + w.numel() * w.element_size() \
        + T * 4 + T * 4
    passes = 3 if (h.dtype, w.dtype) == (torch.float32,
                                         torch.bfloat16) else 1
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = passes * 2 * T * d * vocab / PEAK_OPS[str(w.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa(q, k, v, m):
    """The library yardstick: scaled_dot_product_attention with grouped kv
    heads over pre-gathered K/V."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                          enable_gqa=True)


def logprob_inputs(torch, *, T, d, V, hdtype, tied, seed):
    """Post-norm-like hidden states (N(0,1)), a weight at the model's init
    scale (untied unembedding: std 1/sqrt(d), row-major (d, V); tied: the
    embedding's std 1, passed as the transpose of a row-major (V, d)
    matrix), labels in [0, V) with 0 among them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((4 * 4, T // 16, d), generator=gen,
                    device="cuda").to(hdtype)
    if tied:
        w = torch.randn((V, d), generator=gen, device="cuda").bfloat16().T
    else:
        w = (torch.randn((d, V), generator=gen, device="cuda")
             * d ** -0.5).bfloat16()
    labels = torch.randint(0, V, (4 * 4, T // 16), generator=gen,
                           device="cuda")
    labels[0, 0] = 0
    return h, w, labels


def phase_kernels_logprob(torch):
    print("== phase 3: logprob_gather vs its plain version", flush=True)
    import torch.nn.functional as F
    from repro_torch.configs import qwen25_math
    from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                    logprob_gather_plain)
    from repro_torch.models.common import padded_vocab
    tgt, dft = qwen25_math.TARGET, qwen25_math.DRAFT
    T = 4 * 4 * 16              # slots x n x max_step_tokens
    cases = [("target", tgt, torch.float32, False),
             ("target", tgt, torch.bfloat16, False),
             ("draft", dft, torch.bfloat16, True)]
    max_err = 0.0
    for tag, cfg, hdt, tied in cases:
        V = padded_vocab(cfg)
        h, w, labels = logprob_inputs(torch, T=T, d=cfg.d_model, V=V,
                                      hdtype=hdt, tied=tied, seed=cfg.d_model)
        labels.clamp_(max=cfg.vocab_size - 1)
        got = logprob_gather_cuda(h, w, labels, cfg.vocab_size)
        want = logprob_gather_plain(h, w, labels, cfg.vocab_size)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite log-probs")
        diff = (got - want).abs()
        err = diff.max().item()
        over = (diff - LOGPROB_ATOL - LOGPROB_RTOL * want.abs()).max().item()
        print(f"logprob_gather {tag} T={T} d={cfg.d_model} V={V} vocab="
              f"{cfg.vocab_size} h={str(hdt)[6:]} w=bfloat16 "
              f"{'tied (embedding.T, strided)' if tied else 'row-major'}: "
              f"max_abs_err={err:.3e} (tol {LOGPROB_ATOL:.0e} + "
              f"{LOGPROB_RTOL:.0e} x |log-prob|), log-probs in "
              f"[{want.min().item():.2f}, {want.max().item():.2f}]",
              flush=True)
        check(over <= 0, f"logprob_gather {tag} {hdt}: error {err} over "
              f"the tolerance")
        max_err = max(max_err, err)

    row = {"name": "logprob_gather", "route": "cuda",
           "source": "src/repro_torch/csrc/logprob_gather.cu",
           "replaces": "src/repro/kernels/logprob_gather.py:69",
           "launches": 0, "max_abs_err": max_err}
    # bf16 h (scoring, RWKV shared scoring) fills the row's main fields;
    # fp32 h (shared scoring over quantized pools) its fp32_h_* fields
    for hdt in (torch.bfloat16, torch.float32):
        h, w, labels = logprob_inputs(torch, T=T, d=tgt.d_model,
                                      V=tgt.vocab_size, hdtype=hdt,
                                      tied=False, seed=7)
        vocab = tgt.vocab_size
        ms, ms_host = time_ms(
            torch, lambda a, b, c: logprob_gather_cuda(a, b, c, vocab),
            [(h, w, labels)], iters=5)
        plain_ms, _ = time_ms(
            torch, lambda a, b, c: logprob_gather_plain(a, b, c, vocab),
            [(h, w, labels)], iters=2)
        flat = labels.reshape(-1)
        library_ms, _ = time_ms(
            torch, lambda a, b, c: -F.cross_entropy(
                (a.reshape(-1, a.shape[-1]) @ b.to(a.dtype)).float(), c,
                reduction="none"), [(h, w, flat)], iters=3)
        bound_ms, bound_by = bound_logprob(torch, h, w, vocab)
        print(f"logprob_gather timing (target T={T} d={tgt.d_model} V="
              f"{vocab}, h={str(hdt)[6:]}, w=bfloat16), device-only ms per "
              f"call: kernel {ms:.4f}, bound {bound_ms:.4f} ({bound_by}), "
              f"plain {plain_ms:.4f}, library (h @ W, then -cross_entropy: "
              f"two calls) {library_ms:.4f}; back to back from the host: "
              f"kernel {ms_host:.4f}", flush=True)
        pre = "" if hdt == torch.bfloat16 else "fp32_h_"
        row.update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                    f"{pre}bound_ms": bound_ms, f"{pre}bound_by": bound_by,
                    f"{pre}library_ms": library_ms})
    return row


def flash_case(torch, *, B, S, H, KV, dtype, seed, hd=128):
    """q (B,S,H,hd), k/v (B,S,KV,hd): N(0, 1), as rope'd projections of
    normed hidden states are about."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def bound_flash(q, k, window):
    """Least time for one causal call: 4 * hd flops per live (query head,
    key) pair at the tensor-core (bf16) or CUDA-core (fp32) rate, against
    q, k, v and the output moved once at the HBM rate."""
    B, S, H, hd = q.shape
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    ops = 4 * B * H * hd * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels_flash(torch):
    print("== phase 3: flash_attention vs its plain version", flush=True)
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     uses_hopper_kernel)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    # bf16 at hd 128 runs the TMA/wgmma kernel: 128-key tiles, 2 x (64 // G)
    # = 18 or 20 positions a block.  fp32 runs the CUDA-core kernel and
    # bf16 at hd 40 and 16 (the toy models' head dims) the mma.sync one:
    # 64-key tiles, 64 // G positions.  Window 8 is shorter than every
    # query and key tile, so late rows' first tile is wholly masked.
    # S = 1000 is a multiple of no tile.
    cases = [(tag, H, KV, 128, dtype)
             for tag, (H, KV) in shapes.items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(f"toy G={H // KV}", H, KV, hd, torch.bfloat16)
              for H, KV in ((28, 4), (4, 4)) for hd in (40, 16)]
    for tag, H, KV, hd, dtype in cases:
        check(uses_hopper_kernel(dtype, hd) == (dtype == torch.bfloat16
                                                and hd == 128),
              f"flash {tag} hd={hd} {dtype}: unexpected kernel choice")
        for window in (0, 8):
            q, k, v = flash_case(torch, B=4, S=1000, H=H, KV=KV, hd=hd,
                                 dtype=dtype, seed=H + hd % 128 + window)
            got = flash_attention_cuda(q, k, v, window=window)
            want = flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"flash {tag}: non-finite kernel output")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[str(dtype)]
            print(f"flash_attention {tag} B=4 S=1000 H={H} KV={KV} "
                  f"hd={hd} {str(dtype)[6:]} causal window={window}: "
                  f"max_abs_err={err:.3e} (tol {tol:.0e})", flush=True)
            check(err <= tol, f"flash_attention {tag} hd={hd} {dtype} "
                  f"window {window}: error {err} > {tol}")
            max_err = max(max_err, err)
            del q, k, v, got, want

    # timing at a scoring shape: B = 4, S = 1024, the target's heads, bf16
    H, KV = shapes["target"]
    sets = [flash_case(torch, B=4, S=1024, H=H, KV=KV, dtype=torch.bfloat16,
                       seed=300 + i) for i in range(2)]   # 67 MB each
    ms, ms_host = time_ms(torch, lambda *a: flash_attention_cuda(*a), sets,
                          iters=20)
    plain_ms, plain_host = time_ms(
        torch, lambda *a: flash_attention_plain(*a), sets, iters=1)
    lib_sets = [[t.transpose(1, 2).contiguous() for t in s] for s in sets]
    library_ms, library_host = time_ms(
        torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), lib_sets, iters=20)
    bound_ms, bound_by = bound_flash(sets[0][0], sets[0][1], 0)
    print(f"flash_attention timing (B=4 S=1024 H={H} KV={KV} hd=128 bf16 "
          f"causal), device-only ms per call: kernel {ms:.4f}, bound "
          f"{bound_ms:.4f} ({bound_by}), plain {plain_ms:.4f}, library "
          f"(scaled_dot_product_attention is_causal enable_gqa, (B,H,S,hd)) "
          f"{library_ms:.4f}; back to back from the host: kernel "
          f"{ms_host:.4f}, plain {plain_host:.4f}, library "
          f"{library_host:.4f}", flush=True)
    del sets, lib_sets
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# the decays' ends under models/rwkv.py:_decay's clamp of log(-log w) to
# [-8, 4]: exp(-e^4), about 1.8e-24 a step, and exp(-e^-8), about 0.99966
FAST_DECAY, SLOW_DECAY = math.exp(-math.exp(4.0)), math.exp(-math.exp(-8.0))


def rwkv_case(torch, *, B, T, H, hd, dtype, seed, decays="spread"):
    """r, k, v N(0, 1) in ``dtype`` (as normed projections are about);
    decays spread in (0.45, 0.999), at one clamp end (``fast``, ``slow``)
    or ``mixed`` element by element between the two; u N(0, 0.3^2); a
    non-zero fp32 initial state."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (randn(B, T, H, hd).to(dtype) for _ in range(3))
    shape = (B, T, H, hd)
    uni = torch.rand(shape, generator=gen, device="cuda")
    w = {"spread": lambda: 0.45 + 0.549 * uni,
         "fast": lambda: torch.full(shape, FAST_DECAY, device="cuda"),
         "slow": lambda: torch.full(shape, SLOW_DECAY, device="cuda"),
         "mixed": lambda: torch.where(uni < 0.5, FAST_DECAY, SLOW_DECAY)
         }[decays]()
    return r, k, v, w, 0.3 * randn(H, hd), 0.1 * randn(B, H, hd, hd)


def scan_err(torch, tag, got, want):
    """Largest error of the kernel's (out, state) against the plain
    version's, checked against 1e-4 of each one's scale (both sides compute
    in fp32 from the same inputs, in other summation orders)."""
    errs, worst = [], 0.0
    for name, g, w in zip(("out", "state"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"rwkv6_scan {tag}: non-finite {name}")
        err = (g - w).abs().max().item() if w.numel() else 0.0
        scale = w.abs().max().item() if w.numel() else 0.0
        errs.append(f"{name} max_abs_err={err:.3e} (tol 1e-4 x "
                    f"{scale:.2f})")
        check(err <= 1e-4 * max(scale, 1.0), f"rwkv6_scan {tag}: {name} "
              f"error {err} over 1e-4 x {scale}")
        worst = max(worst, err)
    return worst, ", ".join(errs)


def check_rwkv_forms(torch):
    """The scan beyond phase 3's timed shapes: clamp-end and mixed decays,
    the plan's most segments, the in-place decode form, determinism, a CUDA
    graph and two streams.  Returns the largest error against the plain
    version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                                rwkv6_scan_plain, scan_plan)
    worst = 0.0
    for i, (tag, B, T, H, decays) in enumerate((
            ("decode, mixed decays", 16, 1, 40, "mixed"),
            ("shared scoring, fast decays", 16, 17, 40, "fast"),
            ("full sequence, fast decays", 4, 1024, 40, "fast"),
            ("full sequence, slow decays", 4, 1024, 40, "slow"),
            ("full sequence, mixed decays", 4, 1024, 40, "mixed"),
            ("one head", 1, 4096, 1, "mixed"))):
        args = rwkv_case(torch, B=B, T=T, H=H, hd=64, dtype=torch.bfloat16,
                         seed=600 + i, decays=decays)
        err, text = scan_err(torch, tag, rwkv6_scan_cuda(*args),
                             rwkv6_scan_plain(*args))
        worst = max(worst, err)
        print(f"rwkv6_scan {tag} B={B} T={T} H={H} hd=64 bf16 plan "
              f"{scan_plan(B, T, H, 64)}: {text}", flush=True)
    # the in-place decode form, half the rows frozen
    r, k, v, w, u, s0 = rwkv_case(torch, B=16, T=1, H=40, hd=64,
                                  dtype=torch.bfloat16, seed=610)
    live = torch.arange(16, device="cuda") % 2 == 0
    state = s0.clone()
    out = ops.rwkv6_scan_(r, k, v, w, u, state, live)
    want_out, want_s = rwkv6_scan_cuda(r, k, v, w, u, s0)
    plain_out, plain_s = rwkv6_scan_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    frozen = torch.equal(state[~live], s0[~live])
    same = torch.equal(state[live], want_s[live]) and torch.equal(
        out, want_out)
    err, text = scan_err(torch, "in-place decode", (out, state), (
        plain_out, torch.where(live[:, None, None, None], plain_s, s0)))
    worst = max(worst, err)
    print(f"rwkv6_scan in-place decode B=16 H=40, 8 rows frozen: frozen "
          f"rows bitwise unchanged={frozen}, live rows and out bitwise the "
          f"out-of-place kernel's={same}; {text}", flush=True)
    check(frozen and same, "rwkv6_scan in-place decode: a frozen row moved "
          "or a live row differs from the out-of-place kernel")
    # two calls, a graph replay and two streams, at the split shape
    args = rwkv_case(torch, B=4, T=1024, H=40, hd=64, dtype=torch.bfloat16,
                     seed=620)
    first = rwkv6_scan_cuda(*args)
    again = rwkv6_scan_cuda(*args)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rwkv6_scan_cuda(*args)
    fresh = rwkv_case(torch, B=4, T=1024, H=40, hd=64, dtype=torch.bfloat16,
                      seed=621)
    for dst, src in zip(args, fresh):
        dst.copy_(src)
    graph.replay()
    eager = rwkv6_scan_cuda(*args)
    torch.cuda.synchronize()
    replayed = all(torch.equal(a, b) for a, b in zip(captured, eager))
    del graph, captured
    sets = [fresh, rwkv_case(torch, B=2, T=600, H=40, hd=64,
                             dtype=torch.bfloat16, seed=622)]
    streams = [torch.cuda.Stream() for _ in sets]
    torch.cuda.synchronize()
    outs = []
    for _ in range(2):
        for stream, a in zip(streams, sets):
            with torch.cuda.stream(stream):
                outs.append(rwkv6_scan_cuda(*a))
    torch.cuda.synchronize()
    for j, got in enumerate(outs):
        err, _ = scan_err(torch, "two streams", got,
                          rwkv6_scan_plain(*sets[j % 2]))
        worst = max(worst, err)
    print(f"rwkv6_scan B=4 T=1024 plan {scan_plan(4, 1024, 40, 64)}: two "
          f"calls bitwise equal={bitwise}; a CUDA graph replay over new "
          f"inputs bitwise the eager call={replayed}; two streams at once "
          f"(T 1024 and 600) within 1e-4 of the plain version", flush=True)
    check(bitwise and replayed, "rwkv6_scan: two calls or a graph replay "
          "differ from the eager call")
    return worst


def bound_rwkv(r):
    """Least time for one call: r, k, v, w, u and the output moved once and
    the state read and written once, over the HBM rate, against the flops
    the recurrence needs at the fp32 rate.  Per (row, step, head): the u
    term sum_k r[k] u[k] k[k] is one dot product (3 hd flops), so the output
    sum_k r[k] S[k, n] + (that) v[n] takes 2 hd^2 + 2 hd, and the update
    w[k] S[k, n] + k[k] v[n] takes 3 hd^2: 5 hd^2 + 5 hd in all."""
    B, T, H, hd = r.shape
    nbytes = B * T * H * hd * (3 * r.element_size() + 4 + 4) + H * hd * 4 \
        + 2 * B * H * hd * hd * 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = B * T * H * (5 * hd * hd + 5 * hd) / PEAK_OPS["torch.float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels_rwkv(torch):
    print("== phase 3: rwkv6_scan vs its plain version", flush=True)
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                                rwkv6_scan_plain, scan_plan)
    # rwkv6-3b's heads (H = 40, hd = 64, bf16 r/k/v) at its three call
    # shapes, and a toy model's (hd = 32, fp32)
    cases = [("decode (4 slots x n = 4)", 16, 1, 40, 64, torch.bfloat16),
             ("shared scoring (16 + 1 feeds)", 16, 17, 40, 64,
              torch.bfloat16),
             ("full sequence", 4, 1024, 40, 64, torch.bfloat16),
             ("toy", 4, 300, 4, 32, torch.float32)]
    max_err, row = 0.0, None
    for i, (tag, B, T, H, hd, dtype) in enumerate(cases):
        args = rwkv_case(torch, B=B, T=T, H=H, hd=hd, dtype=dtype,
                         seed=400 + i)
        err, text = scan_err(torch, tag, rwkv6_scan_cuda(*args),
                             rwkv6_scan_plain(*args))
        max_err = max(max_err, err)
        print(f"rwkv6_scan {tag} B={B} T={T} H={H} hd={hd} "
              f"{str(dtype)[6:]} plan {scan_plan(B, T, H, hd)}: {text}",
              flush=True)
        if dtype != torch.bfloat16:
            continue
        # time at the main paths' shapes over input sets cycled past L2
        # (a decode step finds its state in device memory, not in L2)
        sets = [args]
        while len(sets) < 2 or sum(
                a[5].numel() * 4 + a[3].numel() * 4 for a in sets) \
                < 2 * L2_BYTES:
            sets.append(rwkv_case(torch, B=B, T=T, H=H, hd=hd, dtype=dtype,
                                  seed=500 + 10 * i + len(sets)))
        ms, ms_host, host_ms = time_ms(
            torch, lambda *a: rwkv6_scan_cuda(*a), sets, iters=20,
            enqueue=True)
        bound_ms, bound_by = bound_rwkv(args[0])
        plain = "not timed (about 6 launches a step)"
        plain_ms = None
        if T <= 17:
            plain_ms, _ = time_ms(torch, lambda *a: rwkv6_scan_plain(*a),
                                  sets[:2], iters=1)
            plain = f"{plain_ms:.4f}"
        print(f"rwkv6_scan timing, {tag} B={B} T={T} H={H} hd={hd} bf16 "
              f"({len(sets)} input sets cycled past L2), device-only ms per "
              f"call: kernel {ms:.4f}, bound {bound_ms:.6f} ({bound_by}), "
              f"plain {plain}, library: no single PyTorch call computes "
              f"WKV6; back to back from the host: kernel {ms_host:.4f}; "
              f"the wrapper's host time per call {host_ms:.4f}",
              flush=True)
        if row is None:            # the decode shape: most launches
            row = {"name": "rwkv6_scan", "route": "cuda",
                   "source": "src/repro_torch/csrc/rwkv6_scan.cu",
                   "replaces": "src/repro/kernels/rwkv6_scan.py:56",
                   "launches": 0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "host_ms": host_ms}
        del sets
    row["max_abs_err"] = max(max_err, check_rwkv_forms(torch))
    return row


def instrument(torch, model, tag, acc):
    """Count ``model``'s paged decode steps and time each one (host clock
    around the call, and CUDA events on the stream)."""
    orig = model.decode_step
    acc[tag] = {"calls": 0, "paged_calls": 0, "host_s": 0.0, "events": [],
                "layers": len(model.layers)}

    def timed(cache, tokens, positions, **kw):
        rec = acc[tag]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = orig(cache, tokens, positions, **kw)
        b.record()
        rec["host_s"] += time.perf_counter() - t0
        rec["events"].append((a, b))
        rec["calls"] += 1
        rec["paged_calls"] += kw.get("pt") is not None
        return out

    model.decode_step = timed


def counters(torch):
    """The launch-counting wrapper of every kernel, by kernel name."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.logprob_gather import logprob_gather_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    return {"paged_attention": paged_attention_cuda,
            "paged_attention_quant": paged_attention_quant_cuda,
            "logprob_gather": logprob_gather_cuda,
            "flash_attention": flash_attention_cuda,
            "rwkv6_scan": rwkv6_scan_cuda}


def only(launches, **want):
    """True iff the kernels in ``want`` launched exactly as many times as
    it says and every other kernel not at all."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def serve_run(torch, name, cfgs, params, g, count, seed, acc, sync=True,
              **kw):
    """Serve ``count`` requests through a fresh engine (paged unless ``kw``
    says otherwise), lock-step or pipelined (``sync``), with every launch
    counter zeroed just before and read just after; returns the result."""
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine, gsi_engine
    from repro_torch.models import scoring
    engine = GSIServingEngine(*cfgs, *params, g, mode="gsi", max_seq=512,
                              device="cuda",
                              **{"paged": True, "page_size": 16, **kw})
    rec = acc.setdefault(name, {})
    for tag, model in (("draft", engine.draft), ("target", engine.target),
                       ("prm", engine.prm)):
        instrument(torch, model, tag, rec)
    phases = {"draft": 0}
    draft_phase = engine._draft_phase

    def counted(*a, **k):
        phases["draft"] += 1
        return draft_phase(*a, **k)

    engine._draft_phase = counted
    scores = {"calls": 0, "layers": 0}
    score_candidates = gsi_engine.score_candidates

    def scored(model, *a, **k):
        scores["calls"] += 1
        scores["layers"] += len(model.layers)
        return score_candidates(model, *a, **k)

    gsi_engine.score_candidates = scored
    seen = []                       # (h dtype, w dtype, h shape) per call
    gather = scoring.ops.logprob_gather

    def observed(h, w, labels, vocab_size):
        seen.append((str(h.dtype)[6:], str(w.dtype)[6:], tuple(h.shape)))
        return gather(h, w, labels, vocab_size)

    scoring.ops.logprob_gather = observed
    prompts = serve.random_prompts(count, seed=seed,
                                   vocab=cfgs[0].vocab_size, lo=24, hi=72)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    try:
        res = serve.serve(engine, prompts, capacity=4, seed=seed, sync=sync)
    finally:
        scoring.ops.logprob_gather = gather
        gsi_engine.score_candidates = score_candidates
    launches = {k: fn.launches for k, fn in wrappers.items()}
    torch.cuda.synchronize()
    res.update(name=name, launches=launches, draft_phases=phases["draft"],
               score_calls=scores["calls"], score_layers=scores["layers"],
               prompts=prompts,
               gather_inputs=sorted(set(seen)), count=count,
               mem=engine.cache_memory_report(4))
    del engine
    return res


def report_run(name, res, rec, vocab):
    """Print one run's numbers and check its requests and rewards."""
    import numpy as np
    mem = res["mem"]
    print(f"run {name}: requests finished {res['finished']}/{res['count']}, "
          f"engine steps {res['steps']}, draft phases {res['draft_phases']},"
          f" generated tokens {res['tokens']}, wall {res['wall_s']:.2f} s, "
          f"tokens/s {res['tokens_per_s']:.2f}, accept rate "
          f"{res['accept_rate']:.3f}, draft tokens {res['draft_tokens']}, "
          f"target tokens {res['target_tokens']}, prefix {res['prefix']}",
          flush=True)
    total = mem["num_pages"] + mem["scratch_pages"] + 1
    if mem["bytes_per_page"]:          # an engine with paged layers
        print(f"run {name}: page pool [{mem['kv_dtype']}] {total} pages x "
              f"{mem['bytes_per_page'] + mem['scale_bytes_per_page']} B = "
              f"{mem['paged_pool_bytes'] / 2 ** 30:.3f} GiB; capacity "
              f"{mem['capacity_pages']} pages, {mem['capacity_tokens']} "
              f"tokens, {mem['capacity_bytes']} B (payload "
              f"{mem['bytes_per_page']} B + "
              f"scales {mem['scale_bytes_per_page']} B per page; "
              f"{mem['fp_bytes_per_page']} B at the activation dtype)",
              flush=True)
    for tag, r in rec.items():
        stream_s = sum(a.elapsed_time(b) for a, b in r["events"]) / 1e3
        print(f"run {name}: {tag} decode_step calls {r['calls']} (paged "
              f"{r['paged_calls']}), host {r['host_s']:.2f} s, stream "
              f"{stream_s:.2f} s", flush=True)
    print(f"run {name}: kernel launches {res['launches']}", flush=True)
    check(res["finished"] == res["count"],
          f"{name}: {res['finished']} of {res['count']} requests finished")
    for rid in res["ids"]:
        r = res["responses"][rid]
        check(r.finish_reason in ("eos", "low_reward", "max_steps"),
              f"{rid}: no finish reason")
        toks = r.tokens
        check(toks.size > 0 and toks.min() >= 0 and toks.max() < vocab,
              f"{rid}: tokens out of range")
    rw = np.concatenate([np.ravel(a) for a in res["stats"].raw_rewards])
    check(np.isfinite(rw).all() and rw.min() >= 0 and rw.max() <= 1,
          f"{name}: PRM rewards not finite in [0,1]")


def fmt_stats(stats):
    """``pipeline_stats()`` on one line: every key, floats to 4 places."""
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in stats.items())


def check_pipelined(sync, pipe):
    """Run gsi-async against run gsi: the same tokens, finish reasons,
    engine steps, decisions and prefix counters, bit for bit, and the same
    paged-attention launches; the pipeline overlapped host work."""
    def outcome(res):
        st = res["stats"]
        return ({r: (res["responses"][r].tokens.tolist(),
                     res["responses"][r].finish_reason,
                     res["responses"][r].engine_steps) for r in res["ids"]},
                res["steps"], st.accepted, st.decisions, st.draft_tokens,
                st.target_tokens, res["prefix"])

    stats = pipe["pipeline"]
    print(f"run gsi-async against run gsi (one process): tokens/s "
          f"{pipe['tokens_per_s']:.2f} vs {sync['tokens_per_s']:.2f}, wall "
          f"{pipe['wall_s']:.2f} s vs {sync['wall_s']:.2f} s, engine steps "
          f"{pipe['steps']} vs {sync['steps']}; pipeline_stats "
          + fmt_stats(stats), flush=True)
    check(outcome(pipe) == outcome(sync),
          "gsi-async: tokens, finish reasons, engine steps, decisions or "
          "prefix counters differ from run gsi's")
    check(pipe["launches"]["paged_attention"]
          == sync["launches"]["paged_attention"],
          f"gsi-async: {pipe['launches']['paged_attention']} paged launches"
          f", run gsi {sync['launches']['paged_attention']}")
    check(stats["sync"] is False and stats["overlap_host_s"] > 0,
          f"gsi-async: no host work overlapped a step ({stats})")
    print("run gsi-async: tokens, finish reasons, engine steps, accepted "
          "and decision counts, prefix stats and paged launches identical "
          "to run gsi", flush=True)


def phase_main(torch, layers):
    print("== phase 4: main paths at full Qwen2.5-Math width", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params

    full = serve.build_triple("qwen2.5-math")
    cfgs = serve.build_triple("qwen2.5-math", layers=layers)
    if layers and layers < full[0].num_layers:
        print(f"reduced: runs gsi, gsi-async and gsi-forced-fallback cut "
              f"to {layers} "
              f"layers in all three models (published "
              f"{full[0].num_layers}); widths unchanged; run gsi-int8-shared"
              f" at full depth", flush=True)
    for c in full:
        print(f"model {c.name}: layers={c.num_layers} d={c.d_model} "
              f"heads={c.num_heads}/{c.num_kv_heads} hd={c.head_dim} "
              f"ffn={c.d_ff} vocab={c.vocab_size} "
              f"tied={c.tie_embeddings} params~{c.param_count() / 1e9:.2f}B",
              flush=True)
    t0 = time.perf_counter()
    params = [random_params(c, i, "cuda") for i, c in enumerate(full)]
    cut = [{k: p[k] for k in param_specs(c)} for p, c in zip(params, cfgs)]
    torch.cuda.synchronize()
    print(f"random bf16 weights on the card: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    gcfg = GSIConfig(n=4, beta=20.0, threshold_u=0.5, temperature=0.7,
                     max_step_tokens=16, max_steps=4, min_step_reward=0.0)
    # (name, triple, gsi config, requests, seed, options); the bf16-page
    # runs may be cut in depth, the int8 run never is
    runs = [("gsi", cfgs, cut,
             dataclasses.replace(gcfg, threshold_u=QWEN_THRESHOLD), 6, 0,
             {}),
            # run gsi again through the pipelined scheduler
            ("gsi-async", cfgs, cut,
             dataclasses.replace(gcfg, threshold_u=QWEN_THRESHOLD), 6, 0,
             {"sync": False}),
            # no tilted reward reaches 1e9: every row rejects, the
            # target fallback must run
            ("gsi-forced-fallback", cfgs, cut,
             dataclasses.replace(gcfg, threshold_u=1e9, max_steps=2), 2, 1,
             {}),
            ("gsi-int8-shared", full, params, gcfg, 5, 2,
             {"kv_dtype": "int8", "shared_scoring": True,
              "quantize_draft": True})]
    acc, results = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, c3, p3, g, count, seed, kw in runs:
        res = serve_run(torch, name, c3, p3, g, count, seed, acc, **kw)
        results[name] = res
        report_run(name, res, acc[name], full[0].vocab_size)
        elapsed(f"run {name}")

    def paged_layer_calls(name):
        return sum(r["layers"] * r["paged_calls"] for r in acc[name].values())

    for name in ("gsi", "gsi-async", "gsi-forced-fallback"):
        got, want = results[name]["launches"], paged_layer_calls(name)
        check(want > 0 and only(got, paged_attention=want),
              f"{name}: launches {got}; want paged_attention = layers x "
              f"paged decode_step calls = {want} and no other kernel")
    q = results["gsi-int8-shared"]
    got, want = q["launches"], paged_layer_calls("gsi-int8-shared")
    print(f"run gsi-int8-shared: paged_attention_quant launches "
          f"{got['paged_attention_quant']}, layers x paged decode_step calls "
          f"{want}; logprob_gather launches {got['logprob_gather']}, 2 x "
          f"draft phases {2 * q['draft_phases']}; vocab-gather inputs (h, w,"
          f" h shape) {q['gather_inputs']}", flush=True)
    check(want > 0 and q["draft_phases"] > 0
          and only(got, paged_attention_quant=want,
                   logprob_gather=2 * q["draft_phases"]),
          f"gsi-int8-shared: launches {got}; want paged_attention_quant = "
          f"layers x paged decode_step calls = {want}, logprob_gather = 2 x"
          f" draft phases = {2 * q['draft_phases']}, no other kernel")
    stats = results["gsi"]["stats"]
    tilted = torch.cat([torch.as_tensor(t).flatten()
                        for t in stats.tilted_rewards])
    print(f"run gsi: threshold {QWEN_THRESHOLD}; decisions "
          f"{stats.decisions}: accepted {stats.accepted} (a draft candidate "
          f"committed over paged caches), rejected "
          f"{stats.decisions - stats.accepted} (target fallback); selected "
          f"tilted rewards in [{tilted.min().item():.4f}, "
          f"{tilted.max().item():.4f}], median "
          f"{tilted.median().item():.4f}", flush=True)
    check(bool(layers) or 0 < stats.accepted < stats.decisions,
          f"gsi: {stats.accepted} of {stats.decisions} decisions accepted; "
          f"the run must take both the accept and the fallback branch")
    check_pipelined(results["gsi"], results["gsi-async"])
    fallback = results["gsi-forced-fallback"]
    check(fallback["target_tokens"] > 0 and fallback["accept_rate"] == 0.0,
          "forced-fallback run: the target fallback did not run")
    print(f"target fallback ran: {fallback['target_tokens']} target tokens, "
          f"accept rate {fallback['accept_rate']}", flush=True)
    fp, i8 = results["gsi"]["mem"], q["mem"]
    keys = ("capacity_pages", "capacity_tokens", "capacity_bytes",
            "bytes_per_page", "scale_bytes_per_page", "fp_bytes_per_page")
    print("capacity, bf16 pages (run gsi) vs int8 pages (run "
          "gsi-int8-shared): " + ", ".join(
              f"{k} {fp[k]} vs {i8[k]}" for k in keys)
          + f"; bytes per page ratio "
          f"{(fp['bytes_per_page'] + fp['scale_bytes_per_page']) / (i8['bytes_per_page'] + i8['scale_bytes_per_page']):.4f}",
          flush=True)
    scored = phase_score(torch, "score-prm", full, params, results["gsi"],
                         "flash_attention",
                         tols=(LP_TOL, REWARD_TOL, LOGIT_TOL))
    print(f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    launches = {
        "paged_attention": sum(results[n]["launches"]["paged_attention"]
                               for n in ("gsi", "gsi-async",
                                         "gsi-forced-fallback")),
        "paged_attention_quant": got["paged_attention_quant"],
        "logprob_gather": got["logprob_gather"]
        + scored["logprob_gather"],
        "flash_attention": scored["flash_attention"]}
    print(f"logprob_gather launches over its runs: gsi-int8-shared "
          f"{got['logprob_gather']} + score-prm {scored['logprob_gather']}",
          flush=True)
    elapsed("run score-prm")
    phase_profile(torch, [("gsi", cfgs, cut, {}),
                          ("gsi-int8-shared", full, params, runs[3][6])],
                  gcfg)
    phase_profile_pipelined(torch, cfgs, cut, gcfg)
    phase_profile_scoring(torch, full, params, results["gsi"])
    del params, cut
    torch.cuda.empty_cache()
    return launches


def carry_decays(torch, params, seed):
    """Overwrite every RWKV layer's ``decay_base`` in ``params`` (in place)
    with a seeded uniform in [-6, -0.5], so that the base decays
    w = exp(-exp(decay_base)) lie in about (0.54, 0.9975) and the WKV state
    carries from token to token (at the seeded init they lie in about
    [2e-24, 1.2e-4]).  Returns the range of the base decays as stored."""
    gen = torch.Generator().manual_seed(seed)
    ws = []
    for name, t in params.items():
        if name.endswith(".tm.decay_base"):
            t.copy_(torch.empty(t.shape).uniform_(-6.0, -0.5, generator=gen))
            ws.append(torch.exp(-torch.exp(t.float())))
    return min(w.min().item() for w in ws), max(w.max().item() for w in ws)


def toy_rwkv_triple():
    """The reduced ``rwkv6-3b`` (fp32, d 128, 4 heads of 32, vocab 64) as a
    2-layer draft, a 3-layer target and the target's PRM."""
    from repro_torch.config import get_config, reduced_config
    draft = reduced_config(get_config("rwkv6-3b"), vocab=64)
    target = dataclasses.replace(draft, name="rwkv6-3b-smoke-target",
                                 num_layers=3)
    prm = dataclasses.replace(target, name="rwkv6-3b-smoke-prm",
                              reward_head=True)
    return draft, target, prm


def phase_rwkv(torch):
    """Runs gsi-rwkv-shared and score-rwkv at rwkv6-3b's full width and
    depth, then one engine step under the profiler."""
    print("== phase 4: RWKV-6 runs at full rwkv6-3b width and depth",
          flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    cfgs = serve.build_triple("rwkv6-3b")
    for c in cfgs:
        print(f"model {c.name}: layers={c.num_layers} d={c.d_model} "
              f"heads={c.num_heads} hd={c.rwkv_head_dim} ffn={c.d_ff} "
              f"vocab={c.vocab_size} tied={c.tie_embeddings} "
              f"params~{c.param_count() / 1e9:.2f}B", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = [random_params(c, i, "cuda") for i, c in enumerate(cfgs)]
    ranges = [carry_decays(torch, p, 50 + i)
              for i, p in enumerate(params)]
    torch.cuda.synchronize()
    print(f"random bf16 weights on the card: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    print(f"decays: every layer's decay_base overwritten with U[-6, -0.5] "
          f"(seeded); base w = exp(-exp(decay_base)) in "
          f"[{min(r[0] for r in ranges):.4f}, "
          f"{max(r[1] for r in ranges):.4f}] over the three models, before "
          f"the data-dependent LoRA term", flush=True)
    gcfg = GSIConfig(n=4, beta=20.0, threshold_u=RWKV_THRESHOLD,
                     temperature=0.7, max_step_tokens=16, max_steps=4,
                     min_step_reward=0.0)
    kw = {"paged": False, "shared_scoring": True}
    acc = {}
    res = serve_run(torch, "gsi-rwkv-shared", cfgs, params, gcfg, 4, 3, acc,
                    **kw)
    rec = acc["gsi-rwkv-shared"]
    report_run("gsi-rwkv-shared", res, rec, cfgs[0].vocab_size)
    print(f"run gsi-rwkv-shared: cache_memory_report(4) {res['mem']}",
          flush=True)
    stats = res["stats"]
    tilted = torch.cat([torch.as_tensor(t).flatten()
                        for t in stats.tilted_rewards])
    print(f"run gsi-rwkv-shared: threshold {RWKV_THRESHOLD}; decisions "
          f"{stats.decisions}: accepted {stats.accepted} (a draft candidate "
          f"committed over the frozen state), rejected "
          f"{stats.decisions - stats.accepted} (target fallback); tilted "
          f"rewards in [{tilted.min().item():.4f}, "
          f"{tilted.max().item():.4f}]", flush=True)
    check(0 < stats.accepted < stats.decisions,
          f"gsi-rwkv-shared: {stats.accepted} of {stats.decisions} decisions "
          f"accepted; the run must take both the accept and the fallback "
          f"branch")
    steps = sum(r["layers"] * r["calls"] for r in rec.values())
    want = steps + res["score_layers"]
    got = res["launches"]
    print(f"run gsi-rwkv-shared: rwkv6_scan launches {got['rwkv6_scan']}, "
          f"layers x decode_step calls {steps} "
          f"({ {t: r['calls'] for t, r in rec.items()} }) + layers x "
          f"score_candidates calls {res['score_layers']} "
          f"({res['score_calls']} calls) = {want}; logprob_gather launches "
          f"{got['logprob_gather']}, score_candidates calls "
          f"{res['score_calls']}; vocab-gather inputs (h, w, h shape) "
          f"{res['gather_inputs']}", flush=True)
    check(res["score_calls"] == 2 * res["draft_phases"] > 0
          and only(got, rwkv6_scan=want, logprob_gather=res["score_calls"]),
          f"gsi-rwkv-shared: launches {got}; want rwkv6_scan = {want}, "
          f"logprob_gather = {res['score_calls']} score_candidates calls "
          f"(2 x {res['draft_phases']} draft phases), no other kernel")
    elapsed("run gsi-rwkv-shared")
    scored = phase_score(torch, "score-rwkv", cfgs, params, res,
                         "rwkv6_scan", agree_dtype="float32",
                         tols=(LP_TOL, REWARD_TOL, LOGIT_TOL))
    elapsed("run score-rwkv")
    print(f"max_memory_allocated (RWKV phase) "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    phase_profile(torch, [("gsi-rwkv-shared", cfgs, params, kw)], gcfg)
    del params
    torch.cuda.empty_cache()
    return {"rwkv6_scan": got["rwkv6_scan"] + scored["rwkv6_scan"],
            "logprob_gather": got["logprob_gather"]
            + scored["logprob_gather"]}


def finished_sequences(torch, res):
    """Prompt plus committed tokens of every request of a run, PAD-padded
    into one (B, S) batch on the card, with their lengths and the shortest
    prompt's length."""
    import numpy as np
    seqs = [np.concatenate([p, res["responses"][rid].tokens]).astype(
        np.int64) for p, rid in zip(res["prompts"], res["ids"])]
    width = max(s.size for s in seqs)
    toks = np.zeros((len(seqs), width), np.int64)
    for i, s in enumerate(seqs):
        toks[i, :s.size] = s
    lengths = np.array([s.size for s in seqs])
    prompt = min(p.size for p in res["prompts"])
    return (torch.from_numpy(toks).cuda(), torch.from_numpy(lengths).cuda(),
            prompt)


def scoring_models(full, params):
    """The full-width triple over the weights already on the card (no
    copy): draft and target models and the PRM."""
    from repro_torch.models import Model
    from repro_torch.rewards import PRM
    return (Model(full[0], params[0]), Model(full[1], params[1]),
            PRM(full[2], params[2], device="cuda"))


def scoring_batch(draft, target, prm, toks, lengths, prompt):
    """A scoring run's four full-sequence calls."""
    prefill = target.prefill(toks[:, :prompt], max_seq=prompt + 8)
    return (prefill, target.score(toks), draft.score(toks),
            prm.reward_at_end(toks, lengths))


def teacher_forced(torch, model, toks, *, keep=(), hidden_at=None,
                   state_at=None):
    """Feed ``toks`` one position at a time through paged ``decode_step``
    (the decode path: the paged kernel in every attention layer, the scan
    at T = 1 in every RWKV layer, from an empty cache, identity block
    table).  Returns the log-prob of each next token (B, S-1), the logits
    at the positions in ``keep`` (and, under ``"state"``, a copy of every
    layer's cache right after position ``state_at``), and the final hidden
    state of row b at position ``hidden_at[b]``."""
    B, S = toks.shape
    ps = 16
    nblk = -(-S // ps)
    cache = model.init_cache(B, S, pages=B * nblk, page_size=ps)
    pt = torch.arange(B * nblk, dtype=torch.int32,
                      device="cuda").reshape(B, nblk)
    vocab = model.cfg.vocab_size
    lp = torch.zeros((B, S - 1), device="cuda")
    kept, hid = {}, None
    rows = torch.arange(B, device="cuda")
    for t in range(S):
        pos = torch.full((B,), t, device="cuda")
        logits, h = model.decode_step(cache, toks[:, t:t + 1], pos,
                                      return_hidden=True, pt=pt)
        if t in keep:
            kept[t] = logits.float()
        if t == state_at:
            kept["state"] = [{k: v.clone() for k, v in layer.items()}
                             for layer in cache]
        if t + 1 < S:
            lsm = torch.log_softmax(logits[:, :vocab].float(), dim=-1)
            lp[:, t] = lsm[rows, toks[:, t + 1]]
        if hidden_at is not None:
            hid = h if hid is None else hid
            hid = torch.where((hidden_at == t)[:, None], h, hid)
    return lp, kept, hid


def phase_score(torch, run, full, params, served, kernel, *,
                agree_dtype=None, tols=(None, None, None)):
    """Run ``run``: the sequences a serving run finished (``served``),
    through the full-width full-depth target's prefill and score, the
    draft's score and the PRM's reward_at_end, with every launch counter
    zeroed just before and read just after: ``kernel`` (flash attention or
    the WKV6 scan) once per layer of each call, the gather once per score
    and nothing else.  Then each result against the decode path on the
    card, held to ``tols`` (log-probs, rewards, logits); with
    ``agree_dtype`` both sides of that comparison run again with
    activations of that dtype over the same weights."""
    print(f"== phase 4: run {run} (full-sequence passes at full width "
          f"and depth)", flush=True)
    draft, target, prm = scoring_models(full, params)
    toks, lengths, prompt = finished_sequences(torch, served)
    B, S = toks.shape
    print(f"run {run}: {B} sequences of run {served['name']}, lengths "
          f"{lengths.tolist()}, padded to {S}; prefill of the first "
          f"{prompt} tokens (the shortest prompt)", flush=True)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    (pf_logits, pf_cache), lp_t, lp_d, r_end = scoring_batch(
        draft, target, prm, toks, lengths, prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    calls = {"target.prefill": len(target.layers),
             "target.score": len(target.layers),
             "draft.score": len(draft.layers),
             "prm.reward_at_end": len(prm.model.layers)}
    want = sum(calls.values())
    print(f"run {run}: wall {wall:.3f} s for the four calls; kernel "
          f"launches {launches}; {kernel} wanted = layers summed over the "
          f"full-sequence calls {calls} = {want}; logprob_gather wanted = 2"
          f" score calls", flush=True)
    check(only(launches, **{kernel: want, "logprob_gather": 2}),
          f"{run}: launches {launches}; want {kernel} = {want}, "
          f"logprob_gather = 2, no other kernel")
    for name, t in (("target.score", lp_t), ("draft.score", lp_d),
                    ("prm.reward_at_end", r_end),
                    ("target.prefill logits", pf_logits)):
        check(bool(torch.isfinite(t).all()), f"{run}: {name} not finite")
    check(lp_t.shape == (B, S - 1) and lp_d.shape == (B, S - 1)
          and r_end.shape == (B,) and float(r_end.min()) >= 0
          and float(r_end.max()) <= 1, f"{run}: bad output shapes or "
          f"rewards outside [0, 1]")

    live = torch.arange(S - 1, device="cuda")[None] < (lengths - 1)[:, None]
    lp_tol, reward_tol, logit_tol = tols
    if agree_dtype is not None:
        # control: the counted run's own target.score against the decode
        # path at the same activation dtype
        lp_ctrl, _, _ = teacher_forced(torch, target, toks)
        err_ctrl = (lp_t - lp_ctrl)[live].abs().max().item()
        print(f"{run} control ({target.cfg.dtype} activations, the counted "
              f"run): target.score log-probs vs the decode path "
              f"max_abs_err={err_ctrl:.5f} over {int(live.sum())} tokens; "
              f"the agreement below runs in {agree_dtype} activations, "
              f"where the log-prob tol is {lp_tol}", flush=True)
        check(math.isfinite(err_ctrl) and err_ctrl > lp_tol,
              f"{run} control: the {target.cfg.dtype} gap {err_ctrl} is "
              f"within {lp_tol}, so the comparison needs no "
              f"{agree_dtype} activations")
        del pf_cache
        draft, target, prm = scoring_models(
            [dataclasses.replace(c, dtype=agree_dtype) for c in full],
            params)
        (pf_logits, pf_cache), lp_t, lp_d, r_end = scoring_batch(
            draft, target, prm, toks, lengths, prompt)
    # the same functions through the decode path (paged attention or the
    # scan at T = 1, state carried in the cache)
    rwkv = target.kinds[0] == "rwkv"
    lp_dec, kept, _ = teacher_forced(torch, target, toks,
                                     keep=(prompt - 1, prompt),
                                     state_at=prompt - 1 if rwkv else None)
    _, _, h_end = teacher_forced(torch, prm.model, toks,
                                 hidden_at=lengths - 1)
    r_dec = prm.model.reward_from_hidden(h_end)
    # (d) the state prefill leaves (the scan over T = prompt) against the
    # state decode carried to the same position (the scan at T = 1, written
    # into the cache step by step), read before a step moves it on
    state_errs = []
    for i, (got, want) in enumerate(zip(pf_cache, kept.get("state", ()))):
        for key in got:
            err = (got[key].float() - want[key].float()).abs().max().item()
            scale = max(want[key].float().abs().max().item(), 1.0)
            state_errs.append((i, key, err / scale))
    step = target.decode_step(pf_cache, toks[:, prompt:prompt + 1],
                              torch.full((B,), prompt, device="cuda"))
    V = full[1].vocab_size
    err_lp = (lp_t - lp_dec)[live].abs().max().item()
    err_r = (r_end - r_dec).abs().max().item()
    err_pf = (pf_logits[:, :V] - kept[prompt - 1][:, :V]).abs().max().item()
    err_step = (step[:, :V].float() - kept[prompt][:, :V]).abs().max().item()
    print(f"{run} vs the decode path on the same tokens "
          f"({target.cfg.dtype} activations): (a) "
          f"target.score log-probs max_abs_err={err_lp:.5f} (tol "
          f"{lp_tol}) over {int(live.sum())} tokens, log-probs in "
          f"[{lp_t[live].min().item():.2f}, {lp_t[live].max().item():.2f}]; "
          f"(b) prm.reward_at_end max_abs_err={err_r:.5f} (tol {reward_tol})"
          f", rewards {[round(x, 4) for x in r_end.tolist()]}; (c) prefill "
          f"last-token logits max_abs_err={err_pf:.5f}, one decode_step "
          f"from the prefill cache {err_step:.5f} (tol {logit_tol}), logits "
          f"in [{kept[prompt - 1][:, :V].min().item():.2f}, "
          f"{kept[prompt - 1][:, :V].max().item():.2f}]", flush=True)
    check(err_lp <= lp_tol, f"{run} (a): log-prob error {err_lp}")
    check(err_r <= reward_tol, f"{run} (b): reward error {err_r}")
    check(err_pf <= logit_tol and err_step <= logit_tol,
          f"{run} (c): prefill logits error {err_pf}, decode from the "
          f"prefill cache {err_step}")
    if state_errs:
        # layer 0 sees no depth amplification: 1e-4 of its scale
        first = {key: f"{e:.2e}" for i, key, e in state_errs if i == 0}
        worst = max(state_errs, key=lambda x: x[2])
        print(f"{run} (d): prefill state vs decode state after {prompt} "
              f"tokens, error / scale: layer 0 {first} (tol {TOY_RTOL}); "
              f"largest over the {len(pf_cache)} layers {worst[2]:.2e} "
              f"(layer {worst[0]} {worst[1]})", flush=True)
        check(all(e <= TOY_RTOL for i, _, e in state_errs if i == 0),
              f"{run} (d): layer 0 state differs: {first}")
    del pf_cache, draft, target, prm
    torch.cuda.empty_cache()
    return launches


def phase_profile_scoring(torch, full, params, gsi_res):
    """One score-prm batch under torch.profiler: wall and device busy
    time, the top device operations and the flash kernel's and the vocab
    gather's shares."""
    from torch.profiler import ProfilerActivity, profile
    print("== phase 5: where one score-prm batch's time goes", flush=True)
    draft, target, prm = scoring_models(full, params)
    toks, lengths, prompt = finished_sequences(torch, gsi_res)
    scoring_batch(draft, target, prm, toks, lengths, prompt)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scoring_batch(draft, target, prm, toks, lengths, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("score-prm batch: device time not measured (the profiler saw "
              "no device activity)", flush=True)
        return
    busy = sum(r[0] for r in rows) / 1e6
    flash = sum(r[0] for r in rows if "flash_" in r[2]) / 1e6
    gather = sum(r[0] for r in rows if "logprob_" in r[2]) / 1e6
    print(f"score-prm batch: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"device idle share {1 - busy / wall:.3f}, flash kernel "
          f"{flash * 1e3:.2f} ms = {100 * flash / busy:.1f}% of busy, "
          f"vocab gather (partials and merge) {gather * 1e3:.2f} ms = "
          f"{100 * gather / busy:.1f}% of busy", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
              f"{100 * dev_us / 1e6 / busy:5.1f}%  {key[:90]}", flush=True)


def device_rows(torch, prof):
    """(device us, calls, name) of every device-side event of a profile,
    and the device's busy seconds.  Host ops are not recorded: recording
    them slowed the host-bound step under the profiler and their
    processing took minutes per step."""
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return rows, sum(r[0] for r in rows) / 1e6


def phase_profile_pipelined(torch, cfgs, params, gcfg):
    """Two consecutive pipelined dispatches of the gsi configuration (4
    slots, n = 4, the prompts of phase_profile): the first ``step``
    admits and dispatches step 1 (a warm-up, then a synchronize); the
    profiled window is pump (materialize and retire step 1), dispatch
    step 2, and the pump that drains it (``flush``: step 1's harvest
    while step 2 runs, then step 2's materialize and harvest), so it
    holds one step's device work, as the lock-step profile does.  Prints
    the device's busy and idle share under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import GSIScheduler, GSIServingEngine
    print("== phase 5: where a pipelined dispatch's time goes (gsi, "
          "sync=False)", flush=True)
    eng = GSIServingEngine(*cfgs, *params, gcfg, mode="gsi", max_seq=512,
                           device="cuda", paged=True, page_size=16)
    sched = GSIScheduler(eng, capacity=4, sync=False)
    for p in serve.random_prompts(4, seed=5, vocab=cfgs[0].vocab_size,
                                  lo=24, hi=72):
        sched.submit(p)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sched.step(gen)                          # admit and dispatch (warm-up)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step(gen)
        sched.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy = device_rows(torch, prof)
    check(sched.engine_steps == 2 and not sched.has_pending,
          f"pipelined profile: {sched.engine_steps} engine steps")
    print(f"pipelined pump, dispatch, pump (gsi): wall {wall:.3f} s, "
          f"device busy {busy:.3f} s, device "
          f"idle share {1 - busy / wall:.3f}; pipeline_stats "
          + fmt_stats(sched.pipeline_stats())
          if rows else "pipelined dispatches: device time not measured (the "
          "profiler saw no device activity)", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
              f"{100 * dev_us / 1e6 / max(busy, 1e-12):5.1f}%  "
              f"{key[:90]}", flush=True)
    del sched, eng
    elapsed("the pipelined profile of gsi")


def phase_profile(torch, configs, gcfg):
    """One engine step (4 slots, n=4, prompts 24-72 tokens) of each
    configuration under torch.profiler: device time by kernel and the
    device's idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    for name, cfgs, params, kw in configs:
        print(f"== phase 5: where one engine step's time goes ({name})",
              flush=True)
        eng = GSIServingEngine(*cfgs, *params, gcfg, mode="gsi",
                               max_seq=512, device="cuda",
                               **{"paged": True, "page_size": 16, **kw})
        prompts = serve.random_prompts(4, seed=5, vocab=cfgs[0].vocab_size,
                                       lo=24, hi=72)
        width = max(p.size for p in prompts)
        packed = [list(p) + [0] * (width - p.size) for p in prompts]
        state = eng.admit(eng.fresh_state(4), np.ones(4, bool),
                          np.asarray(packed, np.int32))
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, _ = eng.step_decode(state, gen)       # warm-up step
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, res = eng.step_decode(state, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows, busy = device_rows(torch, prof)
        fell_back = not bool(res.accept.all())
        print(f"engine step ({name}): wall {wall:.3f} s, device busy "
              f"{busy:.3f} s, device idle share {1 - busy / wall:.3f} "
              f"(fallback ran: {fell_back})" if rows else
              "engine step: device time not measured (the profiler saw no "
              "device activity)", flush=True)
        for dev_us, count, key in sorted(rows, reverse=True)[:12]:
            print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
                  f"{100 * dev_us / 1e6 / max(busy, 1e-12):5.1f}%  "
                  f"{key[:90]}", flush=True)
        # each kernel row's device kernels: the paged kernels' split and
        # combine kernels count together, and the scan's one-step, ring
        # and fix-up kernels
        for kernel, names in (
                ("paged_attention", ("paged_attention_kernel",
                                     "paged_attention_combine_kernel")),
                ("paged_attention_quant", ("paged_attention_quant_",)),
                ("logprob_gather", ("logprob_",)),
                ("rwkv6_scan", ("rwkv6_step_kernel", "rwkv6_scan_kernel",
                                "rwkv6_scan_fixup_kernel"))):
            mine = [r for r in rows if any(n in r[2] for n in names)]
            if mine:
                us = sum(r[0] for r in mine)
                print(f"  {kernel}: {us / 1e3:.2f} ms over "
                      f"{sum(r[1] for r in mine)} device launches ("
                      + ", ".join(f"{n} {sum(r[1] for r in mine if n in r[2])}"
                                  for n in names)
                      + f") = {100 * us / 1e6 / max(busy, 1e-12):.1f}% of "
                      f"busy", flush=True)
        del eng, state
        elapsed(f"the profile of {name}")


def toy_serve(torch, cfgs, params, g, prompts, device, **kw):
    """Serve ``prompts`` on ``device``; tokens per request, accept rate and
    mean PRM reward."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    eng = GSIServingEngine(*cfgs, *[{k: t.to(device) for k, t in p.items()}
                                    for p in params], g, max_seq=96,
                           page_size=8, device=device, **kw)
    res = serve.serve(eng, prompts, capacity=2, seed=0)
    rw = np.concatenate([np.ravel(a) for a in res["stats"].raw_rewards])
    return ([res["responses"][r].tokens.tolist() for r in res["ids"]],
            res["accept_rate"], float(rw.mean()))


def phase_agreement(torch):
    """Toy fp32 triple at temperature 0: paged serving (the kernel) and
    dense serving (plain attention) commit the same tokens; int8 and fp8
    pages with shared scoring commit on the card what they commit on the
    CPU (or, should an upstream last-ulp difference move one code across a
    rounding boundary, stay within the reference's quantized-drift bounds:
    accept rate within 0.35, mean reward within 5%)."""
    print("== phase 4b: toy fp32 agreement on the card", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    cfgs = serve.toy_triple(vocab=64)
    params = [random_params(c, 10 + i, "cpu") for i, c in enumerate(cfgs)]
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, threshold_u=0.3, min_step_reward=-1.0)
    prompts = serve.random_prompts(5, seed=3, vocab=64, lo=3, hi=20)
    paged = toy_serve(torch, cfgs, params, g, prompts, "cuda", paged=True)
    dense = toy_serve(torch, cfgs, params, g, prompts, "cuda", paged=False)
    same = paged[0] == dense[0]
    print(f"toy paged vs dense: {len(paged[0])} requests, "
          f"{sum(map(len, paged[0]))} tokens, identical={same}", flush=True)
    check(same, "paged and dense serving committed different tokens")
    from repro_torch.kernels.logprob_gather import logprob_gather_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda)
    # kv_dtype="bf16" under fp32 activations: fp32 queries over bf16 pages,
    # K and V widened in the kernel; the CPU promotes the same way
    before = paged_attention_cuda.launches
    card = toy_serve(torch, cfgs, params, g, prompts, "cuda", paged=True,
                     kv_dtype="bf16")
    launched = paged_attention_cuda.launches - before
    cpu = toy_serve(torch, cfgs, params, g, prompts, "cpu", paged=True,
                    kv_dtype="bf16")
    same = card[0] == cpu[0]
    print(f"toy bf16 pages under fp32 activations, card vs CPU: "
          f"{sum(map(len, card[0]))} tokens, identical={same}, accept "
          f"{card[1]:.3f} vs {cpu[1]:.3f}, paged_attention launches "
          f"{launched}", flush=True)
    check(launched > 0, "toy bf16 pages: the card run did not launch the "
          "paged kernel")
    check(same, "toy bf16 pages: card and CPU committed different tokens")
    for kv in ("int8", "fp8"):
        kw = dict(paged=True, kv_dtype=kv, shared_scoring=True)
        before = (paged_attention_quant_cuda.launches,
                  logprob_gather_cuda.launches)
        card = toy_serve(torch, cfgs, params, g, prompts, "cuda", **kw)
        check(paged_attention_quant_cuda.launches > before[0]
              and logprob_gather_cuda.launches > before[1],
              f"toy {kv}: the card run did not launch both kernels")
        cpu = toy_serve(torch, cfgs, params, g, prompts, "cpu", **kw)
        same = card[0] == cpu[0]
        print(f"toy {kv} shared scoring, card vs CPU: "
              f"{sum(map(len, card[0]))} tokens, identical={same}, accept "
              f"{card[1]:.3f} vs {cpu[1]:.3f}, mean reward {card[2]:.6f} vs "
              f"{cpu[2]:.6f}", flush=True)
        if not same:
            check(abs(card[1] - cpu[1]) <= 0.35
                  and abs(card[2] - cpu[2]) <= 0.05 * max(abs(cpu[2]), 1e-3),
                  f"toy {kv}: tokens differ and the drift exceeds the bounds")
            print(f"toy {kv}: tokens differ; accept and reward drift within "
                  f"the bounds", flush=True)


def phase_agreement_full(torch):
    """Toy fp32 models: forward, score, prefill (logits and caches) and the
    PRM's rewards on the card (the flash kernel in every layer, head_dim 16
    and 40, and a full/local stack whose window 8 is shorter than S) match
    the same calls on the CPU (plain versions)."""
    print("== phase 4b: toy full-sequence passes, card vs CPU", flush=True)
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import serve
    from repro_torch.models import Model, random_params
    from repro_torch.rewards import PRM
    draft, target, prm_cfg = serve.toy_triple(vocab=64)
    stack = dataclasses.replace(draft, name="sx-full-local", num_layers=3,
                                layer_pattern=("full", "local"),
                                window_size=8)
    toks = np.random.default_rng(4).integers(3, 64, (3, 77))
    lengths = np.array([77, 40, 9])

    def close(tag, got, want):
        want = want.float()
        err = (got.float().cpu() - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        print(f"toy {tag}: max_abs_err={err:.3e} (tol {TOY_RTOL:.0e} x "
              f"{scale:.2f})", flush=True)
        check(err <= TOY_RTOL * scale, f"toy {tag}: card and CPU differ")

    for i, cfg in enumerate((draft, target, stack, prm_cfg)):
        params = random_params(cfg, 20 + i, "cpu")
        cpu, card = Model(cfg, params), Model(cfg, params, device="cuda")
        tc, tg = torch.from_numpy(toks), torch.from_numpy(toks).cuda()
        before = flash_attention_cuda.launches
        tag = f"{cfg.name} (hd {cfg.head_dim}, {cfg.layer_pattern})"
        V = cfg.vocab_size                # padded columns hold -1e30
        close(f"{tag} forward", card.forward(tg)[0][..., :V],
              cpu.forward(tc)[0][..., :V])
        close(f"{tag} score", card.score(tg), cpu.score(tc))
        lg, cache = card.prefill(tg[:, :50], max_seq=64)
        lc, cache_c = cpu.prefill(tc[:, :50], max_seq=64)
        close(f"{tag} prefill logits", lg[:, :V], lc[:, :V])
        close(f"{tag} prefill caches",
              torch.cat([c[k].flatten() for c in cache for k in "kv"]),
              torch.cat([c[k].flatten() for c in cache_c for k in "kv"]))
        if cfg.reward_head:
            got = PRM(cfg, params, device="cuda").reward_at_end(tg, lengths)
            want = PRM(cfg, params, device="cpu").reward_at_end(tc, lengths)
            close(f"{tag} reward_at_end", got, want)
        torch.cuda.synchronize()
        check(flash_attention_cuda.launches - before
              >= 3 * cfg.num_layers, f"toy {tag}: the flash kernel did not "
              f"run in every layer")


def phase_agreement_rwkv(torch):
    """The toy RWKV triple in fp32 (decays overwritten so the state
    carries): served at temperature 0 on the card, dense and paged (with
    shared scoring), it commits the CPU's tokens; the toy target's and
    PRM's forward, score, prefill (logits and state leaves) and rewards on
    the card match the CPU."""
    print("== phase 4b: toy RWKV triple, card vs CPU", flush=True)
    import numpy as np
    from repro_torch.config import GSIConfig
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.launch import serve
    from repro_torch.models import Model, random_params
    from repro_torch.rewards import PRM
    cfgs = toy_rwkv_triple()
    params = [random_params(c, 30 + i, "cpu") for i, c in enumerate(cfgs)]
    for i, p in enumerate(params):
        carry_decays(torch, p, 60 + i)
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, threshold_u=TOY_RWKV_THRESHOLD,
                  min_step_reward=-1.0)
    prompts = serve.random_prompts(5, seed=3, vocab=64, lo=3, hi=20)
    for kw in ({"paged": False}, {"paged": True, "shared_scoring": True}):
        before = rwkv6_scan_cuda.launches
        card = toy_serve(torch, cfgs, params, g, prompts, "cuda", **kw)
        check(rwkv6_scan_cuda.launches > before,
              f"toy RWKV {kw}: the card run did not launch the scan")
        cpu = toy_serve(torch, cfgs, params, g, prompts, "cpu", **kw)
        same = card[0] == cpu[0]
        print(f"toy RWKV {kw}, card vs CPU: {sum(map(len, card[0]))} "
              f"tokens, identical={same}, accept {card[1]:.3f} vs "
              f"{cpu[1]:.3f}, mean reward {card[2]:.6f} vs {cpu[2]:.6f}",
              flush=True)
        check(same, f"toy RWKV {kw}: card and CPU committed different "
              f"tokens")

    def close(tag, got, want):
        want = want.float()
        err = (got.float().cpu() - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        print(f"toy RWKV {tag}: max_abs_err={err:.3e} (tol {TOY_RTOL:.0e} "
              f"x {scale:.2f})", flush=True)
        check(err <= TOY_RTOL * scale, f"toy RWKV {tag}: card and CPU "
              f"differ")

    toks = np.random.default_rng(4).integers(3, 64, (3, 77))
    lengths = np.array([77, 40, 9])
    tc, tg = torch.from_numpy(toks), torch.from_numpy(toks).cuda()
    for cfg, p in zip(cfgs[1:], params[1:]):
        cpu, card = Model(cfg, p), Model(cfg, p, device="cuda")
        V = cfg.vocab_size
        before = rwkv6_scan_cuda.launches
        close(f"{cfg.name} forward", card.forward(tg)[0][..., :V],
              cpu.forward(tc)[0][..., :V])
        close(f"{cfg.name} score", card.score(tg), cpu.score(tc))
        lg, state = card.prefill(tg[:, :50])
        lc, state_c = cpu.prefill(tc[:, :50])
        close(f"{cfg.name} prefill logits", lg[:, :V], lc[:, :V])
        for key in state[0]:
            close(f"{cfg.name} prefill state {key}",
                  torch.cat([c[key].flatten() for c in state]),
                  torch.cat([c[key].flatten() for c in state_c]))
        if cfg.reward_head:
            close(f"{cfg.name} reward_at_end",
                  PRM(cfg, p, device="cuda").reward_at_end(tg, lengths),
                  PRM(cfg, p, device="cpu").reward_at_end(tc, lengths))
        torch.cuda.synchronize()
        check(rwkv6_scan_cuda.launches - before >= 3 * cfg.num_layers,
              f"toy RWKV {cfg.name}: the scan did not run in every layer")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the bf16-page runs' three models to this "
                         "depth (0 = the published 28)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({src}); run from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    try:
        phase_device(torch)
        phase_build()
        rows = [phase_kernels(torch), phase_kernels_quant(torch),
                phase_kernels_logprob(torch), phase_kernels_flash(torch),
                phase_kernels_rwkv(torch)]
        elapsed("phases 1-3")
        launches = phase_main(torch, args.layers)
        elapsed("the Qwen runs")
        rwkv = phase_rwkv(torch)
        elapsed("the RWKV runs")
        launches["rwkv6_scan"] = rwkv["rwkv6_scan"]
        launches["logprob_gather"] += rwkv["logprob_gather"]
        for row in rows:
            row["launches"] = launches[row["name"]]
        phase_agreement(torch)
        phase_agreement_full(torch)
        phase_agreement_rwkv(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke seconds: {time.perf_counter() - T0:.1f}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
