#!/usr/bin/env python3
"""Time the WKV6 scan wrapper, its backward and one RWKV decode layer of
two checkouts on one card, in turns.

    python3 tools/compare_scan.py OTHER_SRC [--rounds N] [--plans]

OTHER_SRC is another checkout's ``src`` directory (say a parent commit
unpacked with ``git archive``).  Both packages are named ``repro_torch``, so
each side runs in its own process, in the order OTHER, this, this, OTHER
(``--rounds`` times).  Each process times, with ``chip_smoke.time_ms``
(calls queued behind a device sleep; input sets cycled past the L2 cache),
``rwkv6_scan_cuda`` at ``chip_smoke.py``'s phase-3 shapes of rwkv6-3b's
heads (H 40, hd 64, bf16 r/k/v): decode (B 16, T 1), shared scoring
(B 16, T 17) and full sequence (B 4, T 1024); ``rwkv6_scan_bwd_cuda`` at
rwkv6-3b's training shape (``bwd training``: B 4, T 512, H 40, hd 64,
bf16 r/k/v, N(0, 1) cotangents on the output and the final state, two
input sets cycled); and one full-width rwkv6-3b
layer's ``block_apply`` in decode mode at B 16 with half the rows live
(the scan, the state write and everything around them: its device time
per call summed from ``torch.profiler``'s kernel and copy rows, its host
time per call as a loop ended by one synchronize, its device operations
per call, and any host sync that torch's sync debug mode reports).  It
prints the device time per call (the median) and the host time per call
(the fastest and the median; for the scan, the host's enqueue time).
``--plans`` also times this checkout's kernel at the full-sequence shape
under other segment plans, forced in place of ``scan_plan``'s.  Needs an
NVIDIA GPU; builds each side's kernels.  The driver is
``tools/compare_turns.py``'s.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

from compare_turns import THIS_SRC, run

SHAPES = (("decode", 16, 1), ("scoring", 16, 17), ("full", 4, 1024))
PLANS = ((1, 1024), (2, 512), (3, 342), (4, 256), (5, 205), (6, 171),
         (8, 128), (16, 64))


def scan_sets(torch, cs, B, T):
    """Input sets at (B, T) whose states and decays together pass twice
    the L2 cache, as chip_smoke's phase 3 cycles them."""
    sets = []
    while len(sets) < 2 or sum(a[5].numel() * 4 + a[3].numel() * 4
                               for a in sets) < 2 * cs.L2_BYTES:
        sets.append(cs.rwkv_case(torch, B=B, T=T, H=40, hd=64,
                                 dtype=torch.bfloat16, seed=700 + len(sets)))
    return sets


def decode_layer(torch):
    """A timed call of one full-width rwkv6-3b layer in decode mode (B 16,
    half the rows live) over its own cache."""
    from repro_torch.config import get_config
    from repro_torch.models import Model, blocks, random_params
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=1,
                              vocab_size=64)
    model = Model(cfg, random_params(cfg, 0, "cuda"))
    layer = model.layers[0]
    cache = model.init_cache(16, 0)[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((16, 1, cfg.d_model), generator=gen, device="cuda") \
        .to(layer["ln1"].dtype)
    positions = torch.zeros(16, dtype=torch.long, device="cuda")
    live = torch.arange(16, device="cuda") % 2 == 0

    def call():
        return blocks.block_apply(cfg, "rwkv", layer, x, mode="decode",
                                  positions=positions,
                                  freqs=model.rope_freqs, cache=cache,
                                  live=live)
    return call


def child(args) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import rwkv6_scan as rs
    torch.backends.cuda.matmul.allow_tf32 = False
    src = args.other
    plans = args.plans and src == THIS_SRC

    def report(name, fn, sets):
        runs = [cs.time_ms(torch, fn, sets, iters=20, enqueue=True)
                for _ in range(5)]
        print(json.dumps({"src": src, "name": name,
                          "device_ms": [r[0] for r in runs],
                          "host_ms": [r[2] for r in runs]}), flush=True)

    with torch.no_grad():
        for name, B, T in SHAPES:
            sets = scan_sets(torch, cs, B, T)
            report(f"scan {name}", rs.rwkv6_scan_cuda, sets)
            if plans and name == "full":
                chosen = rs.scan_plan
                for plan in PLANS:
                    rs.scan_plan = lambda *shape, p=plan: p
                    report(f"scan full plan {plan}", rs.rwkv6_scan_cuda,
                           sets)
                rs.scan_plan = chosen
            del sets
        sets = []
        for i in range(2):
            args = cs.rwkv_case(torch, B=4, T=512, H=40, hd=64,
                                dtype=torch.bfloat16, seed=720 + i)
            gen = torch.Generator(device="cuda").manual_seed(730 + i)
            sets.append((*args,
                         torch.randn((4, 512, 40, 64), generator=gen,
                                     device="cuda"),
                         torch.randn((4, 40, 64, 64), generator=gen,
                                     device="cuda")))
        runs = [cs.time_ms(torch, rs.rwkv6_scan_bwd_cuda, sets, iters=5,
                           enqueue=True) for _ in range(5)]
        print(json.dumps({"src": src, "name": "bwd training",
                          "device_ms": [r[0] for r in runs],
                          "host_ms": [r[2] for r in runs]}), flush=True)
        del sets
        call = decode_layer(torch)
        report_layer(torch, src, call)


def report_layer(torch, src, call, calls=20):
    """The decode layer's device time per call (the kernels' and copies'
    time under torch.profiler) and host time per call (a loop of calls,
    then one synchronize), five times each; and whether a call makes the
    host wait for the device (torch's sync debug mode)."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        call()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dev, host, launches = [], [], 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3 / calls)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev.append(sum(e.self_device_time_total for e in rows) / 1e3
                   / calls)
        launches = sum(e.count for e in rows) // calls
    print(json.dumps({"src": src, "name": "decode layer",
                      "device_ms": dev, "host_ms": host,
                      "device_ops_per_call": launches,
                      "host_syncs": sorted({str(w.message)[:120]
                                            for w in caught})}),
          flush=True)


if __name__ == "__main__":
    sys.exit(run(__file__, child, __doc__, flags=(
        ("--plans", "also time this checkout's kernel under other plans"),)))
