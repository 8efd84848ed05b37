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
attention at hd 128 and B 4:

* ``bwd target``: ``flash_attention_bwd_cuda`` at the target's training
  shape (S 512, H 28, KV 4);
* ``bwd draft``: the same at the draft's (S 511, H 12, KV 2), the shape
  that run t1 of ``chip_smoke.py`` trains;
* ``fwd scoring``: ``flash_attention_cuda`` at phase 3's scoring shape
  (S 1024, H 28, KV 4), and on a side that has it, ``fwd scoring lse``,
  the same call asked for its log-sum-exp.

A side whose wrapper takes the forward's log-sum-exp
(``uses_hopper_bwd_kernel``) gets the forward kernel's, as training
passes it; the other side's backward rebuilds it.  ``--plans`` also times
this checkout's backward at both training shapes under the dK/dV plans
for other SM counts (``_sm_count`` replaced in the child; the wrapper
takes no plan), and
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

BWD_SHAPES = (("target", 512, 28, 4), ("draft", 511, 12, 2))
PLAN_SMS = (66, 132, 264)


def bwd_sets(torch, fa, S, H, KV):
    """Two input sets of (q, k, v, out, dout) and the keyword arguments the
    side's backward takes; out (and the log-sum-exp) from its forward."""
    sets, kws = [], []
    for i in range(2):
        gen = torch.Generator(device="cuda").manual_seed(800 + i)
        q, k, v, dout = (
            torch.randn(shape, generator=gen, device="cuda")
            .to(torch.bfloat16)
            for shape in ((4, S, H, 128), (4, S, KV, 128), (4, S, KV, 128),
                          (4, S, H, 128)))
        if hasattr(fa, "uses_hopper_bwd_kernel"):
            out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            kws.append({"lse": lse})
        else:
            out = fa.flash_attention_cuda(q, k, v)
            kws.append({})
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
        for tag, S, H, KV in BWD_SHAPES:
            sets, kws = bwd_sets(torch, fa, S, H, KV)

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
                    chunk, tiles = fa.bwd_split_plan(4, S, S, H, KV, sms=sms)
                    report(f"bwd {tag} plan sms={sms}", bwd, sets,
                           chunk=chunk,
                           blocks=4 * KV * sum(t[2] for t in tiles))
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


if __name__ == "__main__":
    sys.exit(run(__file__, child, __doc__, flags=(
        ("--plans", "also time this checkout's backward under other "
                    "dK/dV plans"),
        ("--profile", "profile each side's backward kernels"))))
