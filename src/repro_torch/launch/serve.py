"""GSI serving launcher of the port: build a draft/target/PRM triple with
seeded random weights on the card and serve queued requests through the
continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --config qwen2.5-math \
        --requests 6 --capacity 4 --n 4 --paged [--layers 28] [--device cuda] \
        [--kv-dtype {fp,bf16,int8,fp8}] [--quantize-draft] [--sync | --async]
    PYTHONPATH=src python -m repro_torch.launch.serve --config rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --config rwkv6-3b \
        --device cpu --layers 2 --requests 2 --max-steps 1 --max-step-tokens 4

The real checkpoints are not in the repository, so weights are random
(seeded): the run exercises the serving path at the published widths, and
its tokens carry no meaning.  ``--layers`` cuts the depth of all three
models equally; widths are never cut.  Serving is pipelined by default
(``--async``, as in the reference): the scheduler keeps one step ticket in
flight and harvests and admits while it runs, and prints an ``async
pipeline: overlap_fraction=...`` line; ``--sync`` selects the lock-step
loop (identical tokens).  ``--kv-dtype`` (with ``--paged``) picks the page
storage format and ``--quantize-draft`` rounds the draft's weights through
int8, as in the reference's CLI.  ``--replicas > 1`` and ``--tp`` raise.

``--config rwkv6-3b`` serves the RWKV-6 family: draft, target and PRM all
have ``rwkv6-3b``'s shape (the PRM adds the reward head), with seeds 0, 1
and 2.  The repository registers only this one RWKV model, so the triple
covers the RWKV serving path (the WKV6 scan kernel in every layer) and
says nothing about GSI's speed-up: its draft costs what its target does.
``toy`` is a small fp32 triple for a look on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import GSIConfig, ModelConfig, get_config
from repro_torch.configs import qwen25_math
from repro_torch.device import resolve_device
from repro_torch.models import random_params
from repro_torch.serving import GSIScheduler, GSIServingEngine


def toy_triple(vocab: int = 16):
    """Small draft / larger target / PRM configs (the reference's toy)."""
    draft = ModelConfig(
        name="sx-draft", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=vocab, head_dim=16,
        dtype="float32", param_dtype="float32")
    target = dataclasses.replace(draft, name="sx-target", num_layers=4,
                                 d_model=160, head_dim=40, d_ff=448)
    prm = dataclasses.replace(target, name="sx-prm", reward_head=True)
    return draft, target, prm


def rwkv_triple():
    """``rwkv6-3b`` as draft and target, and as the PRM with a reward head
    (``rwkv6-3b-prm``)."""
    cfg = get_config("rwkv6-3b")
    return cfg, cfg, dataclasses.replace(cfg, name="rwkv6-3b-prm",
                                         reward_head=True)


TRIPLES = {"qwen2.5-math": lambda: qwen25_math.TRIPLE, "toy": toy_triple,
           "rwkv6-3b": rwkv_triple}


def build_triple(name: str, *, layers: int = 0):
    """The named config triple; ``layers > 0`` cuts every model's depth to
    ``layers`` (never a width)."""
    cfgs = TRIPLES[name]()
    if layers:
        cfgs = tuple(dataclasses.replace(c, num_layers=layers) for c in cfgs)
    return cfgs


def build_engine(cfgs, gcfg: GSIConfig, *, seed: int = 0, device="cuda",
                 **engine_kw) -> GSIServingEngine:
    """A serving engine over the triple with seeded random weights made
    directly on ``device`` (seeds ``seed``, ``seed+1``, ``seed+2``)."""
    dev = resolve_device(device)
    params = [random_params(cfg, seed + i, dev) for i, cfg in enumerate(cfgs)]
    return GSIServingEngine(*cfgs, *params, gcfg, device=dev, **engine_kw)


def random_prompts(count: int, *, seed: int, vocab: int, lo: int, hi: int,
                   reserved=(0, 1, 2)):
    """``count`` seeded prompts with lengths in [lo, hi] and no token in
    ``reserved`` (PAD, sep, eos)."""
    rng = np.random.default_rng(seed)
    allowed = np.setdiff1d(np.arange(vocab), np.asarray(reserved))
    return [rng.choice(allowed, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(count)]


def make_frontend(engines, *, capacity: int, continuous: bool = True,
                  collect_stats: bool = False, sync: bool = True,
                  **kw) -> GSIScheduler:
    """One serving frontend: a :class:`GSIScheduler` over one engine.
    Several engines (replicas behind a router) are not ported yet."""
    if isinstance(engines, (list, tuple)):
        if len(engines) != 1:
            raise NotImplementedError(
                "replicas behind a router are not ported to repro_torch yet")
        engines = engines[0]
    return GSIScheduler(engines, capacity=capacity, continuous=continuous,
                        collect_stats=collect_stats, sync=sync, **kw)


def serve(engine: GSIServingEngine, prompts, *, capacity: int,
          seed: int = 0, continuous: bool = True, sync: bool = True) -> dict:
    """Submit ``prompts`` up front and drain them through the scheduler,
    lock-step (``sync=True``) or pipelined.

    Returns the responses and the serving counters; ``wall_s`` is the host
    clock around the whole drain, which ends in a device synchronize, so it
    includes the device work.
    """
    sched = make_frontend(engine, capacity=capacity, continuous=continuous,
                          collect_stats=True, sync=sync)
    ids = [sched.submit(p) for p in prompts]
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    out = sched.run(gen)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    tokens = sum(out[r].num_tokens for r in ids if r in out)
    s = sched.stats
    return {"responses": out, "ids": ids, "finished": len(out),
            "steps": sched.engine_steps, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / max(wall, 1e-9),
            "accept_rate": s.accept_rate, "draft_tokens": s.draft_tokens,
            "target_tokens": s.target_tokens, "prefix": sched.prefix_stats(),
            "pipeline": sched.pipeline_stats(), "stats": s}


def main(argv=None) -> None:
    """CLI entry point (see module docstring for usage)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="qwen2.5-math", choices=list(TRIPLES))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut all three models to this depth (0 = full)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--method", default="gsi",
                    choices=["gsi", "gsi_norej", "rsd", "sbon_s", "sbon_b"])
    ap.add_argument("--beta", type=float, default=20.0)
    ap.add_argument("--u", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--max-step-tokens", type=int, default=16)
    ap.add_argument("--max-steps", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--gang", action="store_true")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--kv-dtype", default="fp",
                    choices=["fp", "bf16", "int8", "fp8"],
                    help="paged KV-page storage format (requires --paged): "
                         "fp keeps the activation dtype; int8/fp8 store "
                         "codes with per-page scales, dequantized inside "
                         "the paged-attention kernel")
    ap.add_argument("--quantize-draft", action="store_true",
                    help="round the draft model's matmul weights through "
                         "int8 (per-channel scales) at engine load")
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--async", dest="sync", action="store_false",
                     help="pipelined serving (default): one step ticket "
                          "in flight, harvest and admission overlap the "
                          "device's decode")
    grp.add_argument("--sync", dest="sync", action="store_true",
                     help="lock-step serving loop (identical tokens)")
    ap.set_defaults(sync=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.replicas > 1:
        raise NotImplementedError("--replicas > 1 is not ported yet")
    if args.tp > 1:
        raise NotImplementedError("--tp is not ported yet")

    cfgs = build_triple(args.config, layers=args.layers)
    gcfg = GSIConfig(n=args.n, beta=args.beta, threshold_u=args.u,
                     temperature=args.temperature,
                     max_step_tokens=args.max_step_tokens,
                     max_steps=args.max_steps, min_step_reward=0.0)
    engine = build_engine(cfgs, gcfg, seed=args.seed, device=args.device,
                          mode=args.method, max_seq=args.max_seq,
                          paged=args.paged, page_size=args.page_size,
                          kv_dtype=None if args.kv_dtype == "fp"
                          else args.kv_dtype,
                          quantize_draft=args.quantize_draft)
    prompts = random_prompts(args.requests, seed=args.seed,
                             vocab=cfgs[0].vocab_size, lo=24, hi=72)
    res = serve(engine, prompts, capacity=args.capacity, seed=args.seed,
                continuous=not args.gang, sync=args.sync)
    print(f"{args.config} ({cfgs[1].num_layers} layers) method={args.method}"
          f" n={args.n} capacity={args.capacity} device={engine.device} "
          f"{'paged' if args.paged else 'dense'} kv={args.kv_dtype}"
          f"{' draft=int8' if args.quantize_draft else ''}: "
          f"finished={res['finished']}/{args.requests} steps={res['steps']} "
          f"tokens={res['tokens']} wall={res['wall_s']:.2f}s "
          f"tokens/s={res['tokens_per_s']:.1f} "
          f"accept={res['accept_rate']:.2f} draft_tokens="
          f"{res['draft_tokens']} target_tokens={res['target_tokens']} "
          f"({'sync' if args.sync else 'async'})")
    if not args.sync:
        pipe = res["pipeline"]
        print(f"async pipeline: overlap_fraction="
              f"{pipe['overlap_fraction']:.2f} "
              f"overlap_host={pipe['overlap_host_s'] * 1e3:.0f}ms "
              f"serial_host={pipe['serial_host_s'] * 1e3:.0f}ms "
              f"materialize_wait={pipe['materialize_wait_s'] * 1e3:.0f}ms "
              f"dispatch={pipe['dispatch_s'] * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
