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
The driver is ``tools/compare_turns.py``'s.
"""
from __future__ import annotations

import json
import sys

from compare_turns import run


def child(args) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    sets = [cs.paged_case(torch, H=28, KV=4, dtype=torch.bfloat16,
                          seed=100 + i) for i in range(4)]
    qsets = [cs.quant_case(torch, H=28, KV=4, dtype=torch.bfloat16,
                           kv="int8", seed=200 + i) for i in range(4)]
    for name, fn, inputs in (("paged_attention", pa.paged_attention_cuda,
                              sets),
                             ("paged_attention_quant",
                              pa.paged_attention_quant_cuda, qsets)):
        runs = [cs.time_ms(torch, fn, inputs, iters=40, enqueue=True)
                for _ in range(7)]
        print(json.dumps({"src": args.other, "name": name,
                          "device_ms": [r[0] for r in runs],
                          "host_ms": [r[2] for r in runs]}), flush=True)


if __name__ == "__main__":
    sys.exit(run(__file__, child, __doc__))
