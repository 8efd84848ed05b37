#!/usr/bin/env python3
"""Time the paged decode wrappers of two checkouts on one card, in turns.

    python3 tools/compare_paged.py OTHER_SRC [--rounds N]

OTHER_SRC is another checkout's ``src`` directory (say a parent commit
unpacked with ``git archive``).  Both packages are named ``repro_torch``, so
each side runs in its own process, in the order OTHER, this, this, OTHER
(``--rounds`` times), at ``chip_smoke.py``'s phase-3 target shape (16 rows,
H 28 / KV 4, head_dim 128, 16-row pages, a 33-column table; bf16, and bf16
queries over int8 codes).  For each wrapper it prints the device time per
call (calls queued behind a device sleep) and the host's enqueue time per
call over seven loops (the fastest and the median), both from
``chip_smoke.time_ms``.  Needs an NVIDIA GPU; builds each side's kernels.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(src: str) -> None:
    sys.path[:0] = [src, str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    sets = [cs.paged_case(torch, H=28, KV=4, dtype=torch.bfloat16,
                          seed=100 + i) for i in range(4)]
    qsets = [cs.quant_case(torch, H=28, KV=4, dtype=torch.bfloat16,
                           kv="int8", seed=200 + i) for i in range(4)]
    for name, fn, args in (("paged_attention", pa.paged_attention_cuda,
                            sets),
                           ("paged_attention_quant",
                            pa.paged_attention_quant_cuda, qsets)):
        runs = [cs.time_ms(torch, fn, args, iters=40, enqueue=True)
                for _ in range(7)]
        print(json.dumps({"src": src, "name": name,
                          "device_ms": [r[0] for r in runs],
                          "host_ms": [r[2] for r in runs]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's src directory")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.other)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_paged: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    this = str(ROOT / "src")
    rows = []
    for src in [args.other, this, this, args.other] * args.rounds:
        out = subprocess.run([sys.executable, __file__, src, "--child"],
                             capture_output=True, text=True, check=True)
        rows += [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{")]
    for name in ("paged_attention", "paged_attention_quant"):
        for label, src in (("other", args.other), ("this", this)):
            mine = [r for r in rows if r["name"] == name and r["src"] == src]
            host = [h for r in mine for h in r["host_ms"]]
            dev = [d for r in mine for d in r["device_ms"]]
            print(f"{name} {label} ({src}): device ms per call median "
                  f"{statistics.median(dev):.4f}; host ms per call "
                  f"fastest {min(host):.4f}, median "
                  f"{statistics.median(host):.4f} ({len(host)} loops in "
                  f"{len(mine)} processes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
