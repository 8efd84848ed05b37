"""The driver the compare tools share: two checkouts' timings on one card,
in turns.

``run(script, child, doc, flags)`` parses ``OTHER_SRC [--rounds N]`` and
the script's own boolean ``flags``, which it passes on to every child.  It
runs ``script OTHER_SRC|THIS_SRC --child`` once per side in the order
OTHER, this, this, OTHER (``--rounds`` times), each side in its own
process, because both packages are named ``repro_torch``.  A child puts its
side's ``src`` and the repository root first on ``sys.path``, then calls
``child(args)``, which prints one JSON line per timed function:
``{"src", "name", "device_ms": [...], "host_ms": [...]}`` and any other
keys, shown beside the times.  The driver prints, per name and side, the
median device time per call (with its min and max) and the fastest and
median host time per call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
THIS_SRC = str(ROOT / "src")


def run(script: str, child, doc: str, flags=()) -> int:
    """``flags``: (flag, help) pairs of the script's own switches."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("other", help="the other checkout's src directory")
    ap.add_argument("--rounds", type=int, default=1)
    for flag, text in flags:
        ap.add_argument(flag, action="store_true", help=text)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path[:0] = [args.other, str(ROOT)]
        child(args)
        return 0
    import torch
    if not torch.cuda.is_available():
        print(f"{Path(script).stem}: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    passed = [flag for flag, _ in flags
              if getattr(args, flag.lstrip("-").replace("-", "_"))]
    rows = []
    for src in [args.other, THIS_SRC, THIS_SRC, args.other] * args.rounds:
        out = subprocess.run([sys.executable, script, src, "--child",
                              *passed], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        rows += [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{")]
    for name in dict.fromkeys(r["name"] for r in rows):
        for label, src in (("other", args.other), ("this", THIS_SRC)):
            mine = [r for r in rows if r["name"] == name and r["src"] == src]
            if not mine:
                continue
            host = [h for r in mine for h in r["host_ms"]]
            dev = [d for r in mine for d in r["device_ms"]]
            extra = "".join(f"; {k} {v}" for k, v in mine[0].items()
                            if k not in ("src", "name", "device_ms",
                                         "host_ms"))
            print(f"{name} {label} ({src}): device ms per call median "
                  f"{statistics.median(dev):.4f} (min {min(dev):.4f}, max "
                  f"{max(dev):.4f}); host ms per call fastest "
                  f"{min(host):.4f}, median {statistics.median(host):.4f} "
                  f"({len(host)} loops in {len(mine)} processes){extra}",
                  flush=True)
    return 0
