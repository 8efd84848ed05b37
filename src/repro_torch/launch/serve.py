"""GSI serving launcher of the port: build a draft/target/PRM triple with
seeded random weights on the card and serve queued requests through the
continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --config qwen2.5-math \
        --requests 6 --capacity 4 --n 4 --paged [--layers 28] [--device cuda] \
        [--kv-dtype {fp,bf16,int8,fp8}] [--quantize-draft] [--sync | --async] \
        [--chunk-tokens N] [--priority K] [--deadline S] [--stream] \
        [--cache-dir DIR] [--replicas R [--router POLICY] [--hash-tier T]]
    PYTHONPATH=src python -m repro_torch.launch.serve --config qwen2-moe
    PYTHONPATH=src python -m repro_torch.launch.serve --config qwen3
    PYTHONPATH=src python -m repro_torch.launch.serve --config rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --config gemma3
    PYTHONPATH=src python -m repro_torch.launch.serve --config recurrentgemma
    PYTHONPATH=src python -m repro_torch.launch.serve --config llama-vision
    PYTHONPATH=src python -m repro_torch.launch.serve --config seamless
    PYTHONPATH=src python -m repro_torch.launch.serve --config rwkv6-3b \
        --device cpu --layers 2 --requests 2 --max-steps 1 --max-step-tokens 4

The real checkpoints are not in the repository, so weights are random
(seeded): the run exercises the serving path at the published widths, and
its tokens carry no meaning.  ``--layers`` cuts the depth of all three
models equally (an encoder's too, to at most that many layers); widths are
never cut.  Serving is pipelined by default (``--async``, as in the
reference): the scheduler keeps one step ticket in flight and harvests
and admits while it runs, and prints an ``async pipeline:
overlap_fraction=...`` line; ``--sync`` selects the lock-step
loop (identical tokens).  ``--kv-dtype`` (with ``--paged``) picks the page
storage format and ``--quantize-draft`` rounds the draft's weights through
int8, as in the reference's CLI.  ``--tp`` raises.

``--replicas R`` (R > 1) serves through a fleet of R data-parallel
replicas behind a :class:`ReplicaRouter`: each replica has its own engine,
page pool and radix index over one shared set of weight tensors (the
full-width bf16 triple is about 31 GiB, so copies would not fit beside the
pages), ``--capacity`` is split between them, ``--router`` picks the
placement policy and ``--hash-tier`` affinity's hash.  The pipelined
default drives the fleet with one thread per replica, each on its own CUDA
stream; ``--sync`` steps the replicas in turn.  Each replica's prefix hit
rate is printed:

    PYTHONPATH=src python -m repro_torch.launch.serve --config toy \
        --device cpu --paged --replicas 2 --router affinity

The SLO options are the reference's: ``--chunk-tokens N`` meters prompt
prefill to N tokens per engine step, ``--priority K`` submits every K-th
request at priority 1 (with ``--deadline S`` seconds as its SLO), which
arms the preemption of priority-0 slots, ``--stream`` prints the first
request's tokens as they are harvested (one ``stream`` line per event),
and ``--cache-dir DIR`` (with ``--paged``) restores the radix cache from
``DIR/cache-r{i}.npz`` (one per replica) before serving, if it is there,
and saves it back after.  A second start with the same seed and
``--cache-dir`` serves its first requests from the restored pages:

    PYTHONPATH=src python -m repro_torch.launch.serve --config toy \
        --device cpu --paged --chunk-tokens 16 --priority 3 --deadline 5 \
        --stream --cache-dir /tmp/gsi-cache

``--config qwen2-moe`` serves a mixture-of-experts target: the
Qwen2.5-Math-1.5B draft, ``qwen2-moe-a2.7b`` (24 layers, 60 routed experts
top-4 laid out as 64, 4 shared) and the Qwen2.5-Math PRM, all on the Qwen
tokenizer (the PRM's vocabulary of 152,064 is padding beyond the others'
151,936).  ``--config qwen3`` serves the paper's second pair,
``qwen3-1.7b`` and ``qwen3-14b``, with the same PRM.

``--config rwkv6-3b`` serves the RWKV-6 family: draft, target and PRM all
have ``rwkv6-3b``'s shape (the PRM adds the reward head), with seeds 0, 1
and 2.  The repository registers only this one RWKV model, so the triple
covers the RWKV serving path (the WKV6 scan kernel in every layer) and
says nothing about GSI's speed-up: its draft costs what its target does.
``--config gemma3`` and ``--config recurrentgemma`` serve the two Gemma
families the same way, each one model's shape as draft, target and PRM:
``gemma3-1b`` (sliding-window and global attention at head_dim 256, a
vocabulary of 262,144; about 6 GB of bf16 weights for the three) and
``recurrentgemma-9b`` (two RG-LRU layers per local-attention layer; about
56 GB of bf16 weights for the three, so on one 80 GB card only).  Their
vocabularies differ, so neither drafts for the other.  A hybrid stack
turns prefix sharing off, as an RWKV one does.
``--config llama-vision`` (``llama-3.2-vision-11b``: a cross-attention
layer every 5th of 40, over 6,404 patch embeddings; about 56.5 GiB of bf16
weights for the three, so on one 80 GB card only) and ``--config
seamless`` (``seamless-m4t-medium``: 12 decoder layers that all
cross-attend to a 12-layer encoder's output over 1,024 frames) serve the
cross-attention families the same way.  Their requests are text-only, as
in the reference's engine, which takes no source: each slot's cross KV
stays zero, and prefix sharing is off for such stacks.
``toy`` is a small fp32 triple.  With ``--train-steps N`` (``toy`` only)
the CLI first trains it on the synthetic arithmetic task, as the
reference's CLI does (:func:`train_triple`: the draft for N // 2 steps,
the target and the PRM for N steps), then serves ``--requests`` task
problems with the reference's task settings (steps of up to 8 tokens, up
to 8 steps, early stop below a 0.1 reward) and prints each model's first
and last loss and the accuracy next to the accept rate and tokens/s:

    PYTHONPATH=src python -m repro_torch.launch.serve --config toy \
        --train-steps 300 --requests 16 --capacity 8 --paged

Every triple but ``toy`` refuses ``--train-steps``: those triples serve
seeded random weights at the published widths, and nothing here trains a
7B model to a useful accuracy.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.config import GSIConfig, ModelConfig, TrainConfig, \
    get_config
from repro_torch.configs import qwen25_math, qwen2_moe_a27b, qwen3
from repro_torch.data import SyntheticReasoningTask
from repro_torch.device import resolve_device
from repro_torch.models import random_params
from repro_torch.serving import (HASH_TIERS, POLICIES, GSIScheduler,
                                 GSIServingEngine, ReplicaRouter)
from repro_torch.train import Trainer


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


def train_triple(task, draft_cfg, target_cfg, prm_cfg, *, steps_draft=200,
                 steps_target=600, batch=32, seq=64, seed=0, device="cuda"):
    """Train the triple on ``task`` as the reference does (the target
    trained longer, so it is genuinely stronger than the draft): lr 1e-3,
    warmup 20, a cosine decay over each model's own step count.

    Returns the three parameter dicts (tensors on ``device``) and the three
    trainers' loss histories (first and last step included).
    """
    tc = TrainConfig(learning_rate=1e-3, total_steps=steps_target,
                     warmup_steps=20, seed=seed)
    tr_s = Trainer(draft_cfg, dataclasses.replace(tc, total_steps=steps_draft),
                   device=device)
    tr_s.fit((task.lm_batch(batch, seq) for _ in iter(int, 1)), steps_draft)
    tr_b = Trainer(target_cfg, tc, device=device)
    tr_b.fit((task.lm_batch(batch, seq) for _ in iter(int, 1)), steps_target)
    tr_p = Trainer(prm_cfg, tc, prm=True, device=device)
    tr_p.fit((task.prm_batch(batch, seq) for _ in iter(int, 1)),
             steps_target)
    params = tuple({k: p.detach() for k, p in tr.params.items()}
                   for tr in (tr_s, tr_b, tr_p))
    return (*params, [tr.history for tr in (tr_s, tr_b, tr_p)])


def accuracy(task, problems, res) -> float:
    """Share of ``problems`` whose served response ends in the right total
    (``res`` from :func:`serve`, one request per problem in order)."""
    correct = sum(task.is_correct(prob, list(res["responses"][rid].tokens))
                  for prob, rid in zip(problems, res["ids"]))
    return correct / max(1, len(problems))


def self_triple(name: str):
    """One registered model as draft and target, and as the PRM with a
    reward head (``<name>-prm``): the triple of a family whose models share
    no tokenizer with the Qwen PRM."""
    cfg = get_config(name)
    return cfg, cfg, dataclasses.replace(cfg, name=f"{name}-prm",
                                         reward_head=True)


TRIPLES = {"qwen2.5-math": lambda: qwen25_math.TRIPLE, "toy": toy_triple,
           "rwkv6-3b": lambda: self_triple("rwkv6-3b"),
           "gemma3": lambda: self_triple("gemma3-1b"),
           "recurrentgemma": lambda: self_triple("recurrentgemma-9b"),
           "llama-vision": lambda: self_triple("llama-3.2-vision-11b"),
           "seamless": lambda: self_triple("seamless-m4t-medium"),
           "qwen2-moe": lambda: (qwen25_math.DRAFT, qwen2_moe_a27b.CONFIG,
                                 qwen25_math.PRM),
           "qwen3": lambda: (qwen3.DRAFT, qwen3.TARGET, qwen25_math.PRM)}


def build_triple(name: str, *, layers: int = 0):
    """The named config triple; ``layers > 0`` cuts every model's depth to
    ``layers`` (its encoder's to at most that), never a width."""
    cfgs = TRIPLES[name]()
    if layers:
        cfgs = tuple(dataclasses.replace(
            c, num_layers=layers,
            encoder_layers=min(c.encoder_layers, layers)) for c in cfgs)
    return cfgs


def build_engines(cfgs, gcfg: GSIConfig, count: int, *, seed: int = 0,
                  device="cuda", **engine_kw):
    """``count`` serving engines (one per replica) over ONE set of seeded
    random weights made directly on ``device`` (seeds ``seed``, ``seed+1``,
    ``seed+2``), as the reference's CLI passes the same parameters to every
    replica's engine.  Each engine has its own caches and page pool."""
    dev = resolve_device(device)
    params = [random_params(cfg, seed + i, dev) for i, cfg in enumerate(cfgs)]
    return [GSIServingEngine(*cfgs, *params, gcfg, device=dev, **engine_kw)
            for _ in range(count)]


def build_engine(cfgs, gcfg: GSIConfig, *, seed: int = 0, device="cuda",
                 **engine_kw) -> GSIServingEngine:
    """One serving engine over the triple with seeded random weights (see
    :func:`build_engines`)."""
    return build_engines(cfgs, gcfg, 1, seed=seed, device=device,
                         **engine_kw)[0]


def random_prompts(count: int, *, seed: int, vocab: int, lo: int, hi: int,
                   reserved=(0, 1, 2)):
    """``count`` seeded prompts with lengths in [lo, hi] and no token in
    ``reserved`` (PAD, sep, eos)."""
    rng = np.random.default_rng(seed)
    allowed = np.setdiff1d(np.arange(vocab), np.asarray(reserved))
    return [rng.choice(allowed, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(count)]


def make_frontend(engines, *, capacity: int, continuous: bool = True,
                  collect_stats: bool = False, policy: str = "affinity",
                  sync: bool = True, hash_tier: str = "mod",
                  chunk_tokens: int = 0):
    """One serving frontend over one or many engines.

    One engine (or a 1-list) gets a :class:`GSIScheduler`; a list of N > 1
    engines gets a :class:`ReplicaRouter` fronting N replicas of
    ``capacity`` slots each, placed by ``policy`` (affinity's hash per
    ``hash_tier``).  ``sync=False`` selects the pipelined loop and, for a
    router, the thread-per-replica fleet loop.  Each frontend keeps its own
    ``cache_aware`` default (off for a scheduler, on for a router), as in
    the reference.  Both frontends expose the same
    submit / run / stats / prefix_stats / pipeline_stats surface.
    """
    if isinstance(engines, GSIServingEngine):
        engines = [engines]
    engines = list(engines)
    if len(engines) == 1:
        return GSIScheduler(engines[0], capacity=capacity,
                            continuous=continuous,
                            collect_stats=collect_stats, sync=sync,
                            chunk_tokens=chunk_tokens)
    return ReplicaRouter(engines, capacity=capacity, policy=policy,
                         continuous=continuous, collect_stats=collect_stats,
                         sync=sync, threaded=not sync, hash_tier=hash_tier,
                         chunk_tokens=chunk_tokens)


def frontend_schedulers(sched):
    """The per-engine schedulers behind a frontend (router or single)."""
    if isinstance(sched, ReplicaRouter):
        return [rep.scheduler for rep in sched.replicas]
    return [sched]


def load_frontend_cache(sched, cache_dir: str) -> int:
    """Warm-restart a frontend from ``cache_dir``: load ``cache-r{i}.npz``
    (written by :func:`save_frontend_cache`) into replica ``i``'s state
    through the engine's snapshot codec, so restored radix subtrees serve
    their first requests from spliced pages.  A missing file is skipped (a
    replica added since the last save starts cold).  Returns the number of
    replicas restored."""
    loaded = 0
    for i, s in enumerate(frontend_schedulers(sched)):
        path = os.path.join(cache_dir, f"cache-r{i}.npz")
        if not os.path.exists(path):
            continue
        s.state = s.engine.load_cache(s.state, path)
        loaded += 1
    return loaded


def save_frontend_cache(sched, cache_dir: str) -> int:
    """Persist every replica's cached radix subtrees, one
    ``cache_dir/cache-r{i}.npz`` each (engines without a live prefix cache
    are skipped).  Returns the number of snapshots written."""
    saved = 0
    for i, s in enumerate(frontend_schedulers(sched)):
        eng = s.engine
        if not eng.paged or not eng.prefix_cache:
            continue
        os.makedirs(cache_dir, exist_ok=True)
        eng.save_cache(s.state, os.path.join(cache_dir, f"cache-r{i}.npz"))
        saved += 1
    return saved


def serve(engine, prompts, *, capacity: int, seed: int = 0,
          continuous: bool = True, sync: bool = True, chunk_tokens: int = 0,
          policy: str = "affinity", hash_tier: str = "mod",
          priority_every: int = 0, deadline_s=None, stream=None,
          cache_dir: str = "") -> dict:
    """Submit ``prompts`` up front and drain them through the frontend of
    :func:`make_frontend`, lock-step (``sync=True``) or pipelined.

    ``engine`` is one engine or a list of them (one per replica, behind a
    router placing by ``policy`` and ``hash_tier``; ``capacity`` is per
    replica).  ``chunk_tokens`` goes to the scheduler(s).
    ``priority_every=k`` submits every k-th request at priority 1, with
    ``deadline_s`` as its SLO; ``stream`` is attached to the first
    request; ``cache_dir`` restores the radix cache from a snapshot there
    before serving (if one exists) and saves it back after, as the
    reference's ``evaluate_queued`` does.

    Returns the responses and the serving counters; ``wall_s`` is the host
    clock around the whole drain, which ends in a device synchronize, so it
    includes the device work.
    """
    sched = make_frontend(engine, capacity=capacity, continuous=continuous,
                          collect_stats=True, sync=sync, policy=policy,
                          hash_tier=hash_tier, chunk_tokens=chunk_tokens)
    devices = {s.engine.device for s in frontend_schedulers(sched)}
    restored = load_frontend_cache(sched, cache_dir) if cache_dir else 0
    ids = []
    for i, p in enumerate(prompts):
        hi = bool(priority_every) and i % priority_every == 0
        ids.append(sched.submit(p, priority=1 if hi else 0,
                                deadline_s=deadline_s if hi else None,
                                stream=stream if i == 0 else None))
    if isinstance(sched, ReplicaRouter):
        gen = seed            # each replica seeds its own generator from it
    else:
        gen = torch.Generator(device=sched.engine.device)
        gen.manual_seed(seed)
    t0 = time.perf_counter()
    out = sched.run(gen)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    saved = save_frontend_cache(sched, cache_dir) if cache_dir else 0
    tokens = sum(out[r].num_tokens for r in ids if r in out)
    ttft = [out[r].ttft for r in ids if r in out
            and not np.isnan(out[r].ttft)]
    s = sched.stats
    return {"responses": out, "ids": ids, "finished": len(out),
            "steps": sched.engine_steps, "tokens": tokens, "wall_s": wall,
            "routing": getattr(sched, "routing", None),
            "tokens_per_s": tokens / max(wall, 1e-9),
            "accept_rate": s.accept_rate, "draft_tokens": s.draft_tokens,
            "target_tokens": s.target_tokens, "prefix": sched.prefix_stats(),
            "pipeline": sched.pipeline_stats(), "stats": s,
            "preemptions": s.preemptions, "resumes": s.resumes,
            "deadline_misses": s.deadline_misses,
            "prefill_commit_max": s.prefill_commit_max,
            "ttft_p50": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "cache_restored": restored, "cache_saved": saved}


def _print_stream(event) -> None:
    """One printed line per stream event, as the reference's CLI prints."""
    tag = f"[{event.finish_reason}]" if event.final \
        else " ".join(map(str, event.tokens.tolist()))
    print(f"stream {event.request_id} step {event.step}: {tag}", flush=True)


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
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel serving replicas (each its own "
                         "engine, page pool and radix index over shared "
                         "weights; --capacity is split between them)")
    ap.add_argument("--router", default="affinity", choices=list(POLICIES),
                    help="replica placement policy (preamble affinity "
                         "keeps shared-prefix requests on one replica)")
    ap.add_argument("--hash-tier", default="mod", choices=list(HASH_TIERS),
                    help="affinity's preamble hash: mod (blake2b mod N) or "
                         "rendezvous (a new replica takes only the groups "
                         "it wins)")
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
    ap.add_argument("--train-steps", type=int, default=0,
                    help="train the toy triple on the synthetic task for "
                         "this many steps first, then serve task problems "
                         "and report accuracy (toy only; 0 = random "
                         "weights)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="per-step prefill token budget (chunked prefill; "
                         "0 = admit whole prompts at once)")
    ap.add_argument("--priority", type=int, default=0, metavar="K",
                    help="submit every K-th request at priority 1 (arms "
                         "preemption of priority-0 slots; 0 = one class)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="SLO deadline (seconds, arrival to finish) of the "
                         "priority-1 requests")
    ap.add_argument("--stream", action="store_true",
                    help="print the first request's tokens as they are "
                         "harvested (one line per stream event)")
    ap.add_argument("--cache-dir", default="",
                    help="warm-restart directory: the radix cache snapshots "
                         "(cache-r{i}.npz, one per replica) are restored "
                         "from here before serving and saved back after "
                         "(needs --paged)")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        raise ValueError("--replicas must be >= 1")
    if args.tp > 1:
        raise NotImplementedError("--tp is not ported yet")
    if args.train_steps and args.config != "toy":
        raise ValueError(f"--train-steps trains the toy triple only: "
                         f"--config {args.config} serves seeded random "
                         f"weights at the published widths (no checkpoint "
                         f"is in the repository, and the toy task cannot "
                         f"train a 7B triple to a useful accuracy here)")

    cfgs = build_triple(args.config, layers=args.layers)
    engine_kw = dict(mode=args.method, max_seq=args.max_seq,
                     paged=args.paged, page_size=args.page_size,
                     kv_dtype=None if args.kv_dtype == "fp"
                     else args.kv_dtype, quantize_draft=args.quantize_draft)
    task = problems = None
    if args.train_steps:
        dev = resolve_device(args.device)
        task = SyntheticReasoningTask(seed=args.seed)
        print("training draft/target/PRM triple ...", flush=True)
        *params, hist = train_triple(
            task, *cfgs, steps_draft=args.train_steps // 2,
            steps_target=args.train_steps, seed=args.seed, device=dev)
        for cfg, h in zip(cfgs, hist):
            print(f"trained {cfg.name}: {h[-1]['step'] + 1} steps, loss "
                  f"{h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}", flush=True)
        # the reference CLI's task settings
        gcfg = GSIConfig(n=args.n, beta=args.beta, threshold_u=args.u,
                         temperature=args.temperature, max_step_tokens=8,
                         max_steps=8)
        engines = [GSIServingEngine(*cfgs, *params, gcfg, device=dev,
                                    **engine_kw)
                   for _ in range(args.replicas)]
        problems = [task.sample_problem() for _ in range(args.requests)]
        prompts = [np.asarray(p.prompt, np.int32) for p in problems]
    else:
        gcfg = GSIConfig(n=args.n, beta=args.beta, threshold_u=args.u,
                         temperature=args.temperature,
                         max_step_tokens=args.max_step_tokens,
                         max_steps=args.max_steps, min_step_reward=0.0)
        engines = build_engines(cfgs, gcfg, args.replicas, seed=args.seed,
                                device=args.device, **engine_kw)
        prompts = random_prompts(args.requests, seed=args.seed,
                                 vocab=cfgs[0].vocab_size, lo=24, hi=72)
    # --capacity is the fleet's: each replica gets its share
    capacity = max(1, args.capacity // args.replicas)
    res = serve(engines if args.replicas > 1 else engines[0], prompts,
                capacity=capacity, seed=args.seed, continuous=not args.gang,
                sync=args.sync, policy=args.router, hash_tier=args.hash_tier,
                chunk_tokens=args.chunk_tokens, priority_every=args.priority,
                deadline_s=args.deadline or None,
                stream=_print_stream if args.stream else None,
                cache_dir=args.cache_dir)
    if args.cache_dir:
        print(f"cache-dir {args.cache_dir}: restored "
              f"{res['cache_restored']} snapshot(s), saved "
              f"{res['cache_saved']}; prefix {res['prefix']}", flush=True)
    if args.priority or args.chunk_tokens:
        print(f"slo: preemptions={res['preemptions']} "
              f"resumes={res['resumes']} "
              f"deadline_misses={res['deadline_misses']} "
              f"prefill_commit_max={res['prefill_commit_max']} "
              f"ttft_p50={res['ttft_p50'] * 1e3:.0f}ms", flush=True)
    if args.replicas > 1:
        px = res["prefix"]
        print(f"fleet: {args.replicas} replicas ({args.router}, "
              f"{args.hash_tier}), routing {res['routing']}, "
              f"prefix hit_rate={px['hit_rate']:.2f}", flush=True)
        for i, p in enumerate(px["per_replica"]):
            print(f"  replica {i} ({args.router}): "
                  f"hit_rate={p['hit_rate']:.2f} "
                  f"({p['hits']}/{p['queries']} admissions) "
                  f"prefill_tokens={p['prefill_tokens']}", flush=True)
    print(f"{args.config} ({cfgs[1].num_layers} layers) method={args.method}"
          f" n={args.n} capacity={capacity}"
          f"{f' x {args.replicas} replicas' if args.replicas > 1 else ''} "
          f"device={engines[0].device} "
          f"{'paged' if args.paged else 'dense'} kv={args.kv_dtype}"
          f"{' draft=int8' if args.quantize_draft else ''}: "
          f"finished={res['finished']}/{args.requests} steps={res['steps']} "
          f"tokens={res['tokens']} wall={res['wall_s']:.2f}s "
          f"tokens/s={res['tokens_per_s']:.1f} "
          f"accept={res['accept_rate']:.2f} draft_tokens="
          f"{res['draft_tokens']} target_tokens={res['target_tokens']} "
          f"({'sync' if args.sync else 'async'})"
          + (f" accuracy={accuracy(task, problems, res):.3f}"
             if task is not None else ""))
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
