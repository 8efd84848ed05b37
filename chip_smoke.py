#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers N]

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions; TF32 switched off for matmuls and cuDNN.
2. build   — compile every CUDA source of ``src/repro_torch/csrc`` with nvcc.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, with the stated tolerances; the kernel's time
   beside its bound, the plain version's time and one PyTorch library call
   computing the same function (a yardstick the port never calls).
   Launches made here are not counted.
4. main path — the full-width Qwen2.5-Math draft/target/PRM triple with
   seeded random weights in bf16, served by the paged GSI engine through
   the continuous-batching scheduler: 6 requests on 4 slots, then a short
   run whose threshold no tilted reward can reach, so the target fallback
   must run.  Kernel launch counters are zeroed just before and read just
   after; every paged attention call must have launched the kernel.  Then a
   toy fp32 triple checks paged (kernel) against dense (plain attention)
   serving token for token at temperature 0.

The line before the last is ``{"kernels": [...]}``: every ported kernel
with its largest error in phase 3 and its launch count from phase 4's
main-path run.  The last line is
``{"ok": true, "device": {...}}``.  ``--layers`` cuts the depth of all
three models equally (never a width) and says so on a ``reduced:`` line.
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
       # product (as the reference does); the kernel keeps them in fp32
       "torch.bfloat16": 2e-2}


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
    print("== phase 3: kernels vs plain versions", flush=True)
    import torch.nn.functional as F
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
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    if not gqa:     # no enable_gqa before torch 2.5: expand kv heads
        lib_sets = [(q, k.repeat_interleave(H // KV, 1),
                     v.repeat_interleave(H // KV, 1), m)
                    for q, k, v, m in lib_sets]
    kw = {"enable_gqa": True} if gqa else {}
    library_ms, library_host = time_ms(
        torch, lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, **kw), lib_sets, iters=5)
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


def phase_main(torch, layers):
    print("== phase 4: main path at full Qwen2.5-Math width", flush=True)
    import numpy as np
    from repro_torch.config import GSIConfig
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.serving import GSIServingEngine

    cfgs = serve.build_triple("qwen2.5-math", layers=layers)
    full = serve.build_triple("qwen2.5-math")
    if layers and layers < full[0].num_layers:
        print(f"reduced: depth cut to {layers} layers in all three models "
              f"(published {full[0].num_layers}); widths unchanged",
              flush=True)
    for c in cfgs:
        print(f"model {c.name}: layers={c.num_layers} d={c.d_model} "
              f"heads={c.num_heads}/{c.num_kv_heads} hd={c.head_dim} "
              f"ffn={c.d_ff} vocab={c.vocab_size} "
              f"tied={c.tie_embeddings} params~{c.param_count() / 1e9:.2f}B",
              flush=True)
    t0 = time.perf_counter()
    params = [random_params(c, i, "cuda") for i, c in enumerate(cfgs)]
    torch.cuda.synchronize()
    print(f"random bf16 weights on the card: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    gcfg = GSIConfig(n=4, beta=20.0, threshold_u=0.5, temperature=0.7,
                     max_step_tokens=16, max_steps=4, min_step_reward=0.0)
    runs = [("gsi", gcfg, 6, 0),
            # no tilted reward reaches 1e9: every row rejects, the
            # target fallback must run
            ("gsi-forced-fallback",
             dataclasses.replace(gcfg, threshold_u=1e9, max_steps=2), 2, 1)]
    acc = {}
    torch.cuda.reset_peak_memory_stats()
    paged_attention_cuda.launches = 0
    results = []
    for name, g, count, seed in runs:
        engine = GSIServingEngine(*cfgs, *params, g, mode="gsi",
                                  max_seq=512, paged=True, page_size=16,
                                  device="cuda")
        for tag, model in (("draft", engine.draft), ("target", engine.target),
                           ("prm", engine.prm)):
            instrument(torch, model, tag, acc.setdefault(name, {}))
        prompts = serve.random_prompts(count, seed=seed,
                                       vocab=cfgs[0].vocab_size, lo=24, hi=72)
        res = serve.serve(engine, prompts, capacity=4, seed=seed)
        mem = engine.cache_memory_report(4)
        results.append((name, count, res, mem))
        del engine
    launches = paged_attention_cuda.launches
    torch.cuda.synchronize()

    expected = 0
    for (name, count, res, mem) in results:
        stats = res["stats"]
        print(f"run {name}: requests finished {res['finished']}/{count}, "
              f"engine steps {res['steps']}, generated tokens "
              f"{res['tokens']}, wall {res['wall_s']:.2f} s, tokens/s "
              f"{res['tokens_per_s']:.2f}, accept rate "
              f"{res['accept_rate']:.3f}, draft tokens "
              f"{res['draft_tokens']}, target tokens "
              f"{res['target_tokens']}, prefix {res['prefix']}", flush=True)
        print(f"run {name}: page pool {mem['total_pages']} pages x "
              f"{mem['bytes_per_page']} B = "
              f"{mem['paged_pool_bytes'] / 2 ** 30:.3f} GiB", flush=True)
        for tag, rec in acc[name].items():
            stream_s = sum(a.elapsed_time(b) for a, b in rec["events"]) / 1e3
            print(f"run {name}: {tag} decode_step calls {rec['calls']} "
                  f"(paged {rec['paged_calls']}), host {rec['host_s']:.2f} "
                  f"s, stream {stream_s:.2f} s", flush=True)
            expected += rec["layers"] * rec["paged_calls"]
        check(res["finished"] == count,
              f"{name}: {res['finished']} of {count} requests finished")
        for rid in res["ids"]:
            r = res["responses"][rid]
            check(r.finish_reason in ("eos", "low_reward", "max_steps"),
                  f"{rid}: no finish reason")
            toks = r.tokens
            check(toks.size > 0 and toks.min() >= 0
                  and toks.max() < cfgs[0].vocab_size,
                  f"{rid}: tokens out of range")
        rw = np.concatenate([np.ravel(a) for a in stats.raw_rewards])
        check(np.isfinite(rw).all() and rw.min() >= 0 and rw.max() <= 1,
              f"{name}: PRM rewards not finite in [0,1]")
    fallback = results[1][2]
    check(fallback["target_tokens"] > 0 and fallback["accept_rate"] == 0.0,
          "forced-fallback run: the target fallback did not run")
    print(f"target fallback ran: {fallback['target_tokens']} target tokens, "
          f"accept rate {fallback['accept_rate']}", flush=True)
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    print(f"paged_attention launches {launches}, layers x paged decode_step "
          f"calls {expected}", flush=True)
    check(launches == expected and launches > 0,
          f"paged kernel launches {launches} != layers x paged decode_step "
          f"calls {expected}")
    phase_profile(torch, cfgs, params, gcfg)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_profile(torch, cfgs, params, gcfg):
    """One engine step (4 slots, n=4, prompts 24-72 tokens) under
    torch.profiler: device time by kernel and the device's idle share."""
    print("== phase 5: where one engine step's time goes", flush=True)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    eng = GSIServingEngine(*cfgs, *params, gcfg, mode="gsi", max_seq=512,
                           paged=True, page_size=16, device="cuda")
    prompts = serve.random_prompts(4, seed=5, vocab=cfgs[0].vocab_size,
                                   lo=24, hi=72)
    width = max(p.size for p in prompts)
    packed = [list(p) + [0] * (width - p.size) for p in prompts]
    import numpy as np
    state = eng.admit(eng.fresh_state(4), np.ones(4, bool),
                      np.asarray(packed, np.int32))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = eng.step_decode(state, gen)           # warm-up step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, res = eng.step_decode(state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's self device
        # time repeats its kernels' time
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    fell_back = not bool(res.accept.all())
    print(f"engine step: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"device idle share {1 - busy / wall:.3f} (fallback ran: "
          f"{fell_back})" if rows else "engine step: device time not "
          "measured (the profiler saw no device activity)", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
              f"{100 * dev_us / 1e6 / max(busy, 1e-12):5.1f}%  {key[:90]}",
              flush=True)
    del eng, state


def phase_agreement(torch):
    """Toy fp32 triple at temperature 0: paged serving (the kernel) and
    dense serving (plain attention) commit the same tokens."""
    print("== phase 4b: paged (kernel) vs dense (plain) serving, toy fp32",
          flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.serving import GSIServingEngine
    cfgs = serve.toy_triple(vocab=64)
    params = [random_params(c, 10 + i, "cuda") for i, c in enumerate(cfgs)]
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, threshold_u=0.3, min_step_reward=-1.0)
    prompts = serve.random_prompts(5, seed=3, vocab=64, lo=3, hi=20)
    outs = []
    for paged in (True, False):
        eng = GSIServingEngine(*cfgs, *params, g, max_seq=96, paged=paged,
                               page_size=8, device="cuda")
        res = serve.serve(eng, prompts, capacity=2, seed=0)
        outs.append([res["responses"][r].tokens.tolist() for r in res["ids"]])
    same = outs[0] == outs[1]
    print(f"toy paged vs dense: {len(outs[0])} requests, "
          f"{sum(map(len, outs[0]))} tokens, identical={same}", flush=True)
    check(same, "paged and dense serving committed different tokens")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut all three models to this depth (0 = the "
                         "published 28)")
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
        kernel = phase_kernels(torch)
        kernel["launches"] = phase_main(torch, args.layers)
        phase_agreement(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke seconds: {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
