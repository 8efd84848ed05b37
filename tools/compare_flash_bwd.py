#!/usr/bin/env python3
"""Time flash attention's backward (and forward) of two checkouts on one
card, in turns.

    python3 tools/compare_flash_bwd.py OTHER_SRC [--rounds N] [--plans]
                                       [--profile]

OTHER_SRC is another checkout's ``src`` directory (say a parent commit
unpacked with ``git archive``).  Both packages are named ``repro_torch``, so
each side runs in its own process, in the order OTHER, this, this, OTHER
(``--rounds`` times).  Each process times, with ``chip_smoke.time_ms``
(calls queued behind a device sleep; two input sets cycled), bf16 causal
attention:

* ``bwd target``: ``flash_attention_bwd_cuda`` at the target's training
  shape (B 4, S 512, H 28, KV 4, hd 128);
* ``bwd draft``: the same at the draft's (S 511, H 12, KV 2), the shape
  that run t1 of ``chip_smoke.py`` trains;
* ``bwd gemma3``, ``bwd gemma3-window``, ``bwd rgemma``,
  ``bwd rgemma-window``: the same at head_dim 256, phase 3's four timed
  Gemma shapes (gemma3's 4 query heads over 1 at B 2, S 1024, causal and
  with window 512; recurrentgemma's 16 over 1 at B 2, S 1024 and at
  B 1, S 4096 with window 2048);
* ``fwd scoring``: ``flash_attention_cuda`` at phase 3's scoring shape
  (S 1024, H 28, KV 4), and on a side that has it, ``fwd scoring lse``,
  the same call asked for its log-sum-exp;
* ``fwd gemma3``, ``fwd rgemma`` and ``fwd gemma3 lse``, ``fwd rgemma
  lse``: the hd-256 forward at the two B 2, S 1024 Gemma shapes, without
  and with its log-sum-exp: what training's forward pays for the
  log-sum-exp that a side's backward takes instead of rebuilding it.

A side whose wrapper takes the forward's log-sum-exp at the shape's
head_dim (``uses_hopper_bwd_kernel``) gets the forward kernel's, as
training passes it; the other side's backward rebuilds it. ``--plans``
also times this checkout's backward at both training shapes under the
dK/dV plans for other SM counts (``_sm_count`` replaced in the child;
the wrapper takes no plan), and
``--profile`` each side's backward kernels one by one under
``torch.profiler`` (device ms per call of each kernel name).  Prints
the device time per call (the median) and the host time per call (the
fastest and the median).  Needs an NVIDIA GPU; builds each side's
kernels.  The driver is ``tools/compare_turns.py``'s.
"""
from __future__ import annotations

import json
import sys

from compare_turns import THIS_SRC, run

# tag, B, S, H, KV, hd, window
BWD_SHAPES = (("target", 4, 512, 28, 4, 128, 0),
              ("draft", 4, 511, 12, 2, 128, 0),
              ("gemma3", 2, 1024, 4, 1, 256, 0),
              ("gemma3-window", 2, 1024, 4, 1, 256, 512),
              ("rgemma", 2, 1024, 16, 1, 256, 0),
              ("rgemma-window", 1, 4096, 16, 1, 256, 2048))
PLAN_SMS = (66, 132, 264)


def bwd_sets(torch, fa, B, S, H, KV, hd, window):
    """Two input sets of (q, k, v, out, dout) and the keyword arguments the
    side's backward takes; out (and the log-sum-exp) from its forward."""
    sets, kws = [], []
    hopper = hasattr(fa, "uses_hopper_bwd_kernel") \
        and fa.uses_hopper_bwd_kernel(torch.bfloat16, hd)
    for i in range(2):
        gen = torch.Generator(device="cuda").manual_seed(800 + i)
        q, k, v, dout = (
            torch.randn(shape, generator=gen, device="cuda")
            .to(torch.bfloat16)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                          (B, S, H, hd)))
        if hopper:
            out, lse = fa.flash_attention_cuda(q, k, v, window=window,
                                               return_lse=True)
            kws.append({"lse": lse, "window": window})
        else:
            out = fa.flash_attention_cuda(q, k, v, window=window)
            kws.append({"window": window})
        sets.append((q, k, v, out, dout, len(kws) - 1))
    return sets, kws


def profile(torch, src, name, fn, sets, calls=20):
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls cycling ``sets``."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    rows = {e.key[:60]: round(e.self_device_time_total / 1e3 / calls, 4)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}
    print(json.dumps({"src": src, "name": f"{name} kernels",
                      "device_ms": [sum(rows.values())], "host_ms": [0.0],
                      "per_kernel_ms": rows}), flush=True)


def child(args) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    src = args.other

    def report(name, fn, sets, **extra):
        runs = [cs.time_ms(torch, fn, sets, iters=10, enqueue=True)
                for _ in range(5)]
        print(json.dumps({"src": src, "name": name,
                          "device_ms": [r[0] for r in runs],
                          "host_ms": [r[2] for r in runs], **extra}),
              flush=True)

    with torch.no_grad():
        for tag, B, S, H, KV, hd, window in BWD_SHAPES:
            sets, kws = bwd_sets(torch, fa, B, S, H, KV, hd, window)

            def bwd(q, k, v, out, dout, i):
                return fa.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                   **kws[i])
            report(f"bwd {tag}", bwd, sets)
            if args.profile:
                profile(torch, src, f"bwd {tag}", bwd, sets)
            if args.plans and src == THIS_SRC:
                sm_count = fa._sm_count
                for sms in PLAN_SMS:
                    fa._sm_count = lambda device, sms=sms: sms
                    chunk, tiles = fa.bwd_split_plan(
                        B, S, S, H, KV, window=window, sms=sms,
                        keys=fa.bwd_keys(hd))
                    report(f"bwd {tag} plan sms={sms}", bwd, sets,
                           chunk=chunk,
                           blocks=B * KV * sum(t[2] for t in tiles))
                fa._sm_count = sm_count
            del sets, kws
        sets = cs.flash_case(torch, B=4, S=1024, H=28, KV=4,
                             dtype=torch.bfloat16, seed=300)
        sets = [sets, cs.flash_case(torch, B=4, S=1024, H=28, KV=4,
                                    dtype=torch.bfloat16, seed=301)]
        report("fwd scoring", fa.flash_attention_cuda, sets)
        if hasattr(fa, "uses_hopper_bwd_kernel"):
            report("fwd scoring lse", lambda *a: fa.flash_attention_cuda(
                *a, return_lse=True), sets)
        for tag, B, S, H, KV, hd, _ in (s for s in BWD_SHAPES
                                        if s[0] in ("gemma3", "rgemma")):
            sets = [cs.flash_case(torch, B=B, S=S, H=H, KV=KV, hd=hd,
                                  dtype=torch.bfloat16, seed=310 + i)
                    for i in range(2)]
            report(f"fwd {tag}", fa.flash_attention_cuda, sets)
            report(f"fwd {tag} lse", lambda *a: fa.flash_attention_cuda(
                *a, return_lse=True), sets)


if __name__ == "__main__":
    sys.exit(run(__file__, child, __doc__, flags=(
        ("--plans", "also time this checkout's backward under other "
                    "dK/dV plans"),
        ("--profile", "profile each side's backward kernels"))))
