#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--layers N]

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions; TF32 switched off for matmuls and cuDNN.
2. build   — compile every CUDA source of ``src/repro_torch/csrc`` with nvcc,
   one process per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes, with the stated tolerances: paged attention,
   quantized paged attention (int8 and fp8 codes), the fused log-softmax
   gather (the target's row-major unembedding and the draft's tied,
   transposed embedding) and flash attention (target and draft heads,
   bf16 and fp32, causal with no window and with one shorter than the
   query tile, S = 1000).  Each kernel's time beside its bound, the plain
   version's time and one PyTorch library call computing the same function
   (a yardstick the port never calls).  Launches made here are not counted.
4. main paths — the full-width Qwen2.5-Math draft/target/PRM triple with
   seeded random weights in bf16, served by the paged GSI engine through
   the continuous-batching scheduler: (a) 6 requests on 4 slots over bf16
   pages, (b) a short run whose threshold no tilted reward can reach, so the
   target fallback must run, and (c) 5 requests over int8 pages with shared
   scoring and the draft's weights rounded through int8.  Then run
   score-prm, at full depth: the sequences (a) finished go through
   target.prefill, target.score, draft.score and PRM.reward_at_end, and
   each result is held against the decode path (teacher-forced paged
   decode_step) on the same tokens.  Every kernel launch counter is zeroed
   just before each run and read just after: in (a) and (b) every paged
   attention call launched the bf16 kernel; in (c) every one launched the
   quantized kernel and the vocab gather ran twice per draft phase; in
   score-prm the flash kernel ran once per layer of every full-sequence
   call and the gather once per score call, with no paged launch.
4b. agreement — a toy fp32 triple at temperature 0: paged (kernel) against
   dense (plain attention) serving on the card, and int8 / fp8 pages with
   shared scoring on the card against the same engine on the CPU; then the
   toy models' forward, score, prefill and rewards on the card (head_dim 16
   and 40, a full/local stack with a window shorter than S) against the
   CPU.
5. profile — one engine step of (a) and of (c), and one score-prm batch,
   under ``torch.profiler``.

The line before the last is ``{"kernels": [...]}``: every ported kernel
with its largest error in phase 3, its timings and its launch count from the
phase-4 run(s) of its path.  The last line is
``{"ok": true, "device": {...}}``.  ``--layers`` cuts the depth of runs (a)
and (b) (never a width, never run (c) or score-prm) and says so on a
``reduced:`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
# phase 4b, card against CPU in fp32: summation orders differ (cuBLAS and
# the kernels against the CPU's), 1e-4 of each output's scale
TOY_RTOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# Phase 3 helpers: main-path-shaped paged attention inputs
# ----------------------------------------------------------------------

def paged_case(torch, *, H, KV, dtype, seed, hd=128, ps=16, slots=4, n=4,
               nblk=32, span=2):
    """Inputs shaped like one layer's paged attention call on the main path.

    Pool: ``slots * nblk`` allocatable pages + ``slots * n * span`` scratch
    pages + 1 trash page, filled with random values (stale garbage
    everywhere).  Rows are ``slots * n`` candidate branches: each branch
    aliases its slot's committed pages below its write block (slot 1 shares
    slot 0's first three pages, as a prefix-cache hit does) and writes into
    its own scratch pages from there; unassigned columns and the extra
    table column point at the trash page.  Positions are ragged, up to ~200.
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
    slot_pos = torch.randint(20, 190, (slots,), generator=cpu)
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


def time_ms(torch, fn, arg_sets, iters=40):
    """Mean ms per call with CUDA events, cycling through ``arg_sets``
    (together larger than the L2 cache, so K/V comes from HBM).

    Returns ``(device_ms, back_to_back_ms)``.  ``device_ms`` enqueues every
    call behind a ~0.5 s device sleep, so the card runs them back to back
    whatever the host's per-call cost: the function's own time on the card
    (checked: the timed region must not have started when the host finished
    enqueueing).  ``back_to_back_ms`` is the same loop without the sleep,
    where a host slower than the card shows up as the per-call time.
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
        for _ in range(iters):
            for args in arg_sets:
                fn(*args)
                count += 1
        end.record()
        if queued:
            check(not start.query(), "timing: the host did not finish "
                  "enqueueing before the device sleep ended")
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / count)
    return tuple(out)


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    print(f"build seconds: {secs:.2f}", flush=True)


def phase_kernels(torch):
    print("== phase 3: paged_attention vs its plain version", flush=True)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    for tag, (H, KV) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            for window in (0, 64):
                q, kp, vp, pt, pos = paged_case(torch, H=H, KV=KV,
                                                dtype=dtype, seed=H + window)
                got = paged_attention_cuda(q, kp, vp, pt, pos, window=window)
                want = paged_attention_plain(q, kp, vp, pt, pos,
                                             window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"{tag}: non-finite kernel output")
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[str(dtype)]
                print(f"paged_attention {tag} H={H} KV={KV} hd=128 ps=16 "
                      f"rows={q.shape[0]} table={pt.shape[1]} "
                      f"{str(dtype)[6:]} window={window}: max_abs_err="
                      f"{err:.3e} (tol {tol:.0e})", flush=True)
                check(err <= tol, f"paged_attention {tag} {dtype} window "
                      f"{window}: error {err} > {tol}")
                max_err = max(max_err, err)

    # timing at the target's main-path shape, bf16, full attention
    H, KV = shapes["target"]
    sets = []
    while sum(s[1].numel() * 4 for s in sets) < 2 * L2_BYTES:
        sets.append(paged_case(torch, H=H, KV=KV, dtype=torch.bfloat16,
                               seed=100 + len(sets)))
    # few enough calls that the launch queue never fills during the sleep
    ms, ms_host = time_ms(torch, lambda *a: paged_attention_cuda(*a), sets,
                          iters=20)
    plain_ms, plain_host = time_ms(
        torch, lambda *a: paged_attention_plain(*a), sets, iters=1)

    def gathered(q, kp, vp, pt, pos):
        B, _, _, hd = q.shape
        P, ps = kp.shape[:2]
        S = pt.shape[1] * ps
        rows = (pt.long()[:, :, None] * ps
                + torch.arange(ps, device="cuda")).reshape(B, S)
        k = kp.reshape(P * ps, KV, hd)[rows].transpose(1, 2).contiguous()
        v = vp.reshape(P * ps, KV, hd)[rows].transpose(1, 2).contiguous()
        mask = (torch.arange(S, device="cuda")[None] <= pos[:, None].long())
        return q.transpose(1, 2).contiguous(), k, v, mask[:, None, None]

    lib_sets = [gathered(*s) for s in sets]
    library_ms, library_host = time_ms(torch, sdpa, lib_sets, iters=5)
    bound_ms, bound_by = bound(sets, 0)
    print(f"paged_attention timing (target shape, bf16, {len(sets)} input "
          f"sets cycled past L2), device-only ms per call: kernel {ms:.4f}, "
          f"bound {bound_ms:.6f} ({bound_by}, mean over the sets), plain "
          f"{plain_ms:.4f}, library (scaled_dot_product_attention over "
          f"pre-gathered K/V) {library_ms:.4f}", flush=True)
    print(f"paged_attention timing, back-to-back launches from the host "
          f"(host cost included), ms per call: kernel {ms_host:.4f}, plain "
          f"{plain_host:.4f}, library {library_host:.4f}", flush=True)
    # launches are read from the main path's run (phase 4), not from here
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:172",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def quant_case(torch, *, H, KV, dtype, kv, seed):
    """:func:`paged_case` over code pools, quantized as the engine writes
    them: each (page, kv head) of the N(0, 1) pools, scaled by a random
    factor in [0.25, 2), gets the scale amax / QMAX and codes in range.  The
    same table (stale rows, a shared prefix, scratch pages, the trash
    column)."""
    from repro_torch.kernels import quant
    q, kp, vp, pt, pos = paged_case(torch, H=H, KV=KV, dtype=dtype,
                                    seed=seed)
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
    for tag, (H, KV) in shapes.items():
        for kv in ("int8", "fp8"):
            for dtype in (torch.bfloat16, torch.float32):
                for window in (0, 64):
                    args = quant_case(torch, H=H, KV=KV, dtype=dtype, kv=kv,
                                      seed=H + window + len(kv))
                    got = paged_attention_quant_cuda(*args, window=window)
                    want = paged_attention_quant_plain(*args, window=window)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{tag} {kv}: non-finite kernel output")
                    err = (got.float() - want.float()).abs().max().item()
                    tol = TOL[str(dtype)]
                    print(f"paged_attention_quant {tag} H={H} KV={KV} hd=128"
                          f" ps=16 rows={args[0].shape[0]} table="
                          f"{args[5].shape[1]} {kv} q={str(dtype)[6:]} "
                          f"window={window}: max_abs_err={err:.3e} "
                          f"(tol {tol:.0e})", flush=True)
                    check(err <= tol, f"paged_attention_quant {tag} {kv} "
                          f"{dtype} window {window}: error {err} > {tol}")
                    max_err = max(max_err, err)

    # timing at the int8 run's target shape: bf16 queries over int8 codes
    H, KV = shapes["target"]
    sets = []
    while sum(s[1].numel() * 2 for s in sets) < 2 * L2_BYTES:
        sets.append(quant_case(torch, H=H, KV=KV, dtype=torch.bfloat16,
                               kv="int8", seed=200 + len(sets)))
    # at most a few hundred launches per timed loop, so the launch queue
    # never fills during the device sleep: the kernel cycles all the sets;
    # the plain version (~35 launches a call) a quarter of them; SDPA sets
    # (gathered bf16 K/V, about 17 MB each) six, past L2 on their own
    ms, ms_host = time_ms(torch, lambda *a: paged_attention_quant_cuda(*a),
                          sets, iters=10)
    plain_ms, plain_host = time_ms(
        torch, lambda *a: paged_attention_quant_plain(*a),
        sets[:len(sets) // 4], iters=1)

    def gathered(q, kp, vp, ks, vs, pt, pos):
        B, _, _, hd = q.shape
        P, ps = kp.shape[:2]
        S = pt.shape[1] * ps
        ptl = pt.long()
        rows = (ptl[:, :, None] * ps
                + torch.arange(ps, device="cuda")).reshape(B, S)

        def deq(pool, sc):
            x = pool.reshape(P * ps, KV, hd)[rows].float() \
                * sc[ptl].repeat_interleave(ps, dim=1)[..., None]
            return x.to(q.dtype).transpose(1, 2).contiguous()

        mask = (torch.arange(S, device="cuda")[None] <= pos[:, None].long())
        return q.transpose(1, 2).contiguous(), deq(kp, ks), deq(vp, vs), \
            mask[:, None, None]

    lib_sets = [gathered(*s) for s in sets[:6]]
    library_ms, library_host = time_ms(torch, sdpa, lib_sets, iters=5)
    bound_ms, bound_by = bound_quant(sets, 0)
    print(f"paged_attention_quant timing (target shape, bf16 q over int8 "
          f"codes; kernel {len(sets)} input sets cycled past L2, plain "
          f"{len(sets) // 4}, library 6), device-only ms "
          f"per call: kernel {ms:.4f}, bound {bound_ms:.6f} ({bound_by}, "
          f"mean over the sets), plain {plain_ms:.4f}, library "
          f"(scaled_dot_product_attention over pre-gathered, dequantized "
          f"bf16 K/V) {library_ms:.4f}", flush=True)
    print(f"paged_attention_quant timing, back-to-back launches from the "
          f"host (host cost included), ms per call: kernel {ms_host:.4f}, "
          f"plain {plain_host:.4f}, library {library_host:.4f}", flush=True)
    return {"name": "paged_attention_quant", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention_quant.cu",
            "replaces": "src/repro/kernels/paged_attention.py:121",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def bound_logprob(torch, h, w, vocab):
    """Least time for one call: h, W (once each), labels and the output
    over the HBM rate, against 2 * T * d * vocab flops over the peak rate of
    the type the products run in (fp32 when either input is fp32)."""
    T, d = h.shape[0] * h.shape[1], h.shape[2]
    nbytes = h.numel() * h.element_size() + w.numel() * w.element_size() \
        + T * 4 + T * 4
    kind = str(torch.promote_types(h.dtype, w.dtype))
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * T * d * vocab / PEAK_OPS[kind]
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

    row = None
    for hdt in (torch.float32, torch.bfloat16):     # main path's h is fp32
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
        if row is None:
            row = {"name": "logprob_gather", "route": "cuda",
                   "source": "src/repro_torch/csrc/logprob_gather.cu",
                   "replaces": "src/repro/kernels/logprob_gather.py:69",
                   "launches": 0, "max_abs_err": max_err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
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
                                                     flash_attention_plain)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    # window 8 is shorter than the kernel's query tile (64 // G = 9 or 10
    # positions) and its 64-key tile: late rows' first tile is wholly
    # masked.  S = 1000 is not a multiple of either tile.
    for tag, (H, KV) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            for window in (0, 8):
                q, k, v = flash_case(torch, B=4, S=1000, H=H, KV=KV,
                                     dtype=dtype, seed=H + window)
                got = flash_attention_cuda(q, k, v, window=window)
                want = flash_attention_plain(q, k, v, window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"flash {tag}: non-finite kernel output")
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[str(dtype)]
                print(f"flash_attention {tag} B=4 S=1000 H={H} KV={KV} "
                      f"hd=128 {str(dtype)[6:]} causal window={window}: "
                      f"max_abs_err={err:.3e} (tol {tol:.0e})", flush=True)
                check(err <= tol, f"flash_attention {tag} {dtype} window "
                      f"{window}: error {err} > {tol}")
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
    return {"paged_attention": paged_attention_cuda,
            "paged_attention_quant": paged_attention_quant_cuda,
            "logprob_gather": logprob_gather_cuda,
            "flash_attention": flash_attention_cuda}


def serve_run(torch, name, cfgs, params, g, count, seed, acc, **kw):
    """Serve ``count`` requests through a fresh engine with every launch
    counter zeroed just before and read just after; returns the result."""
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    from repro_torch.models import scoring
    engine = GSIServingEngine(*cfgs, *params, g, mode="gsi", max_seq=512,
                              paged=True, page_size=16, device="cuda", **kw)
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
        res = serve.serve(engine, prompts, capacity=4, seed=seed)
    finally:
        scoring.ops.logprob_gather = gather
    launches = {k: fn.launches for k, fn in wrappers.items()}
    torch.cuda.synchronize()
    res.update(launches=launches, draft_phases=phases["draft"],
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
    print(f"run {name}: page pool [{mem['kv_dtype']}] {total} pages x "
          f"{mem['bytes_per_page'] + mem['scale_bytes_per_page']} B = "
          f"{mem['paged_pool_bytes'] / 2 ** 30:.3f} GiB; capacity "
          f"{mem['capacity_pages']} pages, {mem['capacity_tokens']} tokens, "
          f"{mem['capacity_bytes']} B (payload {mem['bytes_per_page']} B + "
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


def phase_main(torch, layers):
    print("== phase 4: main paths at full Qwen2.5-Math width", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params

    full = serve.build_triple("qwen2.5-math")
    cfgs = serve.build_triple("qwen2.5-math", layers=layers)
    if layers and layers < full[0].num_layers:
        print(f"reduced: runs gsi and gsi-forced-fallback cut to {layers} "
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
    # (name, triple, gsi config, requests, seed, engine options); the
    # bf16-page runs may be cut in depth, the int8 run never is
    runs = [("gsi", cfgs, cut, gcfg, 6, 0, {}),
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

    def paged_layer_calls(name):
        return sum(r["layers"] * r["paged_calls"] for r in acc[name].values())

    for name in ("gsi", "gsi-forced-fallback"):
        got, want = results[name]["launches"], paged_layer_calls(name)
        check(got["paged_attention"] == want > 0
              and got["paged_attention_quant"] == 0
              and got["logprob_gather"] == 0
              and got["flash_attention"] == 0,
              f"{name}: launches {got}; want paged_attention = layers x "
              f"paged decode_step calls = {want} and no other kernel")
    q = results["gsi-int8-shared"]
    got, want = q["launches"], paged_layer_calls("gsi-int8-shared")
    print(f"run gsi-int8-shared: paged_attention_quant launches "
          f"{got['paged_attention_quant']}, layers x paged decode_step calls "
          f"{want}; logprob_gather launches {got['logprob_gather']}, 2 x "
          f"draft phases {2 * q['draft_phases']}; vocab-gather inputs (h, w,"
          f" h shape) {q['gather_inputs']}", flush=True)
    check(got["paged_attention_quant"] == want > 0
          and got["paged_attention"] == 0 and got["flash_attention"] == 0,
          f"gsi-int8-shared: launches {got}; want paged_attention_quant = "
          f"layers x paged decode_step calls = {want}, no bf16 kernel")
    check(got["logprob_gather"] == 2 * q["draft_phases"] > 0,
          f"gsi-int8-shared: logprob_gather launches "
          f"{got['logprob_gather']} != 2 x draft phases {q['draft_phases']}")
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
    scored = phase_score_prm(torch, full, params, results["gsi"])
    print(f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    launches = {
        "paged_attention": sum(results[n]["launches"]["paged_attention"]
                               for n in ("gsi", "gsi-forced-fallback")),
        "paged_attention_quant": got["paged_attention_quant"],
        "logprob_gather": got["logprob_gather"]
        + scored["logprob_gather"],
        "flash_attention": scored["flash_attention"]}
    print(f"logprob_gather launches over its runs: gsi-int8-shared "
          f"{got['logprob_gather']} + score-prm {scored['logprob_gather']}",
          flush=True)
    phase_profile(torch, [("gsi", cfgs, cut, {}),
                          ("gsi-int8-shared", full, params, runs[2][6])],
                  gcfg)
    phase_profile_scoring(torch, full, params, results["gsi"])
    del params, cut
    torch.cuda.empty_cache()
    return launches


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
    """The run score-prm's four full-sequence calls."""
    prefill = target.prefill(toks[:, :prompt], max_seq=prompt + 8)
    return (prefill, target.score(toks), draft.score(toks),
            prm.reward_at_end(toks, lengths))


def teacher_forced(torch, model, toks, *, keep=(), hidden_at=None):
    """Feed ``toks`` one position at a time through paged ``decode_step``
    (the decode path: the paged kernel in every layer, from an empty
    cache, identity block table).  Returns the log-prob of each next token
    (B, S-1), the logits at the positions in ``keep``, and the final hidden
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
        if t + 1 < S:
            lsm = torch.log_softmax(logits[:, :vocab].float(), dim=-1)
            lp[:, t] = lsm[rows, toks[:, t + 1]]
        if hidden_at is not None:
            hid = h if hid is None else hid
            hid = torch.where((hidden_at == t)[:, None], h, hid)
    return lp, kept, hid


def phase_score_prm(torch, full, params, gsi_res):
    """Run score-prm: the sequences run gsi finished, through the full-width
    full-depth target's prefill and score, the draft's score and the PRM's
    reward_at_end, with every launch counter zeroed just before and read
    just after; then each result against the decode path on the card."""
    print("== phase 4: run score-prm (full-sequence passes at full width "
          "and depth)", flush=True)
    draft, target, prm = scoring_models(full, params)
    toks, lengths, prompt = finished_sequences(torch, gsi_res)
    B, S = toks.shape
    print(f"run score-prm: {B} sequences of run gsi, lengths "
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
    want_flash = sum(calls.values())
    print(f"run score-prm: wall {wall:.3f} s for the four calls; kernel "
          f"launches {launches}; flash_attention wanted = layers summed "
          f"over the full-sequence calls {calls} = {want_flash}; "
          f"logprob_gather wanted = 2 score calls", flush=True)
    check(launches["flash_attention"] == want_flash
          and launches["logprob_gather"] == 2
          and launches["paged_attention"] == 0
          and launches["paged_attention_quant"] == 0,
          f"score-prm: launches {launches}; want flash_attention = "
          f"{want_flash}, logprob_gather = 2, no paged kernel")
    for name, t in (("target.score", lp_t), ("draft.score", lp_d),
                    ("prm.reward_at_end", r_end),
                    ("target.prefill logits", pf_logits)):
        check(bool(torch.isfinite(t).all()), f"score-prm: {name} not finite")
    check(lp_t.shape == (B, S - 1) and lp_d.shape == (B, S - 1)
          and r_end.shape == (B,) and float(r_end.min()) >= 0
          and float(r_end.max()) <= 1, "score-prm: bad output shapes or "
          "rewards outside [0, 1]")

    # the same functions through the decode path (the paged kernel)
    live = torch.arange(S - 1, device="cuda")[None] < (lengths - 1)[:, None]
    lp_dec, kept, _ = teacher_forced(torch, target, toks,
                                     keep=(prompt - 1, prompt))
    _, _, h_end = teacher_forced(torch, prm.model, toks,
                                 hidden_at=lengths - 1)
    r_dec = prm.model.reward_from_hidden(h_end)
    step = target.decode_step(pf_cache, toks[:, prompt:prompt + 1],
                              torch.full((B,), prompt, device="cuda"))
    V = full[1].vocab_size
    err_lp = (lp_t - lp_dec)[live].abs().max().item()
    err_r = (r_end - r_dec).abs().max().item()
    err_pf = (pf_logits[:, :V] - kept[prompt - 1][:, :V]).abs().max().item()
    err_step = (step[:, :V].float() - kept[prompt][:, :V]).abs().max().item()
    print(f"score-prm vs the decode path on the same tokens: (a) "
          f"target.score log-probs max_abs_err={err_lp:.4f} (tol "
          f"{LP_TOL}) over {int(live.sum())} tokens, log-probs in "
          f"[{lp_t[live].min().item():.2f}, {lp_t[live].max().item():.2f}]; "
          f"(b) prm.reward_at_end max_abs_err={err_r:.5f} (tol {REWARD_TOL})"
          f", rewards {[round(x, 4) for x in r_end.tolist()]}; (c) prefill "
          f"last-token logits max_abs_err={err_pf:.4f}, one decode_step "
          f"from the prefill cache {err_step:.4f} (tol {LOGIT_TOL}), logits "
          f"in [{kept[prompt - 1][:, :V].min().item():.2f}, "
          f"{kept[prompt - 1][:, :V].max().item():.2f}]", flush=True)
    check(err_lp <= LP_TOL, f"score-prm (a): log-prob error {err_lp}")
    check(err_r <= REWARD_TOL, f"score-prm (b): reward error {err_r}")
    check(err_pf <= LOGIT_TOL and err_step <= LOGIT_TOL,
          f"score-prm (c): prefill logits error {err_pf}, decode from the "
          f"prefill cache {err_step}")
    del pf_cache, draft, target, prm
    torch.cuda.empty_cache()
    return launches


def phase_profile_scoring(torch, full, params, gsi_res):
    """One score-prm batch under torch.profiler: wall and device busy
    time, the top device operations and the flash kernel's share."""
    from torch.profiler import ProfilerActivity, profile
    print("== phase 5: where one score-prm batch's time goes", flush=True)
    draft, target, prm = scoring_models(full, params)
    toks, lengths, prompt = finished_sequences(torch, gsi_res)
    scoring_batch(draft, target, prm, toks, lengths, prompt)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    print(f"score-prm batch: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"device idle share {1 - busy / wall:.3f}, flash kernel "
          f"{flash * 1e3:.2f} ms = {100 * flash / busy:.1f}% of busy",
          flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
              f"{100 * dev_us / 1e6 / busy:5.1f}%  {key[:90]}", flush=True)


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
                               max_seq=512, paged=True, page_size=16,
                               device="cuda", **kw)
        prompts = serve.random_prompts(4, seed=5, vocab=cfgs[0].vocab_size,
                                       lo=24, hi=72)
        width = max(p.size for p in prompts)
        packed = [list(p) + [0] * (width - p.size) for p in prompts]
        state = eng.admit(eng.fresh_state(4), np.ones(4, bool),
                          np.asarray(packed, np.int32))
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, _ = eng.step_decode(state, gen)       # warm-up step
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, res = eng.step_decode(state, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies): a CPU op's self
            # device time repeats its kernels' time
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and e.self_device_time_total > 0:
                rows.append((e.self_device_time_total, e.count, e.key))
        busy = sum(r[0] for r in rows) / 1e6
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
        del eng, state


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
    from repro_torch.kernels.paged_attention import paged_attention_quant_cuda
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
    t0 = time.perf_counter()
    try:
        phase_device(torch)
        phase_build()
        rows = [phase_kernels(torch), phase_kernels_quant(torch),
                phase_kernels_logprob(torch), phase_kernels_flash(torch)]
        launches = phase_main(torch, args.layers)
        for row in rows:
            row["launches"] = launches[row["name"]]
        phase_agreement(torch)
        phase_agreement_full(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke seconds: {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
