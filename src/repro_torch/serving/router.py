"""Multi-replica request router with preamble-affinity placement.

A port of ``repro.serving.router``.  :class:`ReplicaRouter` fronts N
independent engine/scheduler replicas (:mod:`repro_torch.serving.replica`)
and decides, per request, which replica's queue it joins.  Three policies:

``affinity`` (default)
    Keep requests that share a prompt preamble on one replica, so its radix
    prefix cache serves the preamble's pages to all of them.  Tier 1: the
    replica whose radix index holds the longest cached prefix of the prompt
    (ties to the less-loaded replica).  Tier 2, a miss everywhere: a hash
    of the prompt's first full page-size chunk (``hash_tier``), so a burst
    of same-preamble requests submitted before any page is published still
    lands on one replica.  Tier 3, a prompt shorter than one page plus its
    pending token: least-loaded.  A placement that would put a replica more
    than ``skew`` requests past the least-loaded one falls back to
    least-loaded.

``round_robin``
    Cycle replicas in submission order (the locality-blind baseline).

``least_loaded``
    The replica with the fewest outstanding requests; ties to the lowest
    index.

The hash tier is ``mod`` (blake2b of the chunk mod N) or ``rendezvous``
(highest random weight: growing the fleet from N to N+1 moves only the
groups the new replica wins).  Both hash the chunk's int32 bytes in the
machine's order, as the reference does, so a prompt goes to the same
replica in both packages.

The fleet is driven sequentially (``threaded=False``: ``step`` loops over
the replicas in host code) or by a thread per replica.  Each thread owns
its replica's scheduler, engine and state; on a CUDA engine it runs under
the replica's own stream and device (``Replica.context``).  ``run`` makes
each replica stream wait for the caller's stream before the threads start
(the state was built there) and synchronizes every replica stream before
it returns, so ``add_replica``, ``save_cache`` and the caller see finished
work.  A thread that fails parks its exception; ``run`` aborts the fleet
and re-raises it.  Each replica draws from its own generator
(``Replica.seed_rng``) in both loops, so the threaded fleet commits the
sequential fleet's tokens at any temperature.

The port has no device mesh: ``mesh=`` raises in the engine, so the
reference's submesh checks have nothing to check here.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.gsi_engine import EngineStats, merge_engine_stats
from repro_torch.serving.replica import Replica, build_replicas, own_streams
from repro_torch.serving.scheduler import GSIScheduler, Response

POLICIES = ("affinity", "round_robin", "least_loaded")
HASH_TIERS = ("mod", "rendezvous")


def _chunk_bytes(tokens) -> bytes:
    return np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()


def preamble_hash(tokens, num_replicas: int) -> int:
    """Deterministic replica index for a token chunk (blake2b mod N),
    stable across processes, unlike the salted builtin ``hash``."""
    digest = hashlib.blake2b(_chunk_bytes(tokens), digest_size=8).digest()
    return int.from_bytes(digest, "big") % num_replicas


def preamble_rendezvous(tokens, num_replicas: int) -> int:
    """Rendezvous (highest-random-weight) replica index for a chunk: each
    replica's weight is a blake2b over (chunk, index), and the chunk goes
    to the heaviest.  Adding replica N leaves the N existing weights as
    they were, so a chunk moves iff the new replica wins."""
    data = _chunk_bytes(tokens)
    best, best_w = 0, b""
    for i in range(num_replicas):
        w = hashlib.blake2b(data + i.to_bytes(4, "big"),
                            digest_size=8).digest()
        if w > best_w:
            best, best_w = i, w
    return best


class ReplicaRouter:
    """Route requests across N independent serving replicas.

    engines:    one :class:`GSIServingEngine` per replica (distinct
                objects; they may share weight tensors).
    capacity:   scheduler slots per replica.
    policy:     ``affinity`` | ``round_robin`` | ``least_loaded``.
    skew:       affinity's load guard (None: pure affinity).
    hash_tier:  ``mod`` or ``rendezvous``.
    cache_aware, sync, continuous, prompt_pad_len, collect_stats,
    chunk_tokens: forwarded to each replica's :class:`GSIScheduler`.
    threaded:   ``run`` drives one thread per replica; False steps the
                replicas in turn on the calling thread.
    """

    def __init__(self, engines, *, capacity: int,
                 policy: str = "affinity", skew: Optional[int] = 4,
                 hash_tier: str = "mod", continuous: bool = True,
                 prompt_pad_len: int = 0, collect_stats: bool = False,
                 cache_aware: bool = True, sync: bool = True,
                 threaded: bool = True, chunk_tokens: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {POLICIES}")
        if hash_tier not in HASH_TIERS:
            raise ValueError(f"unknown hash tier {hash_tier!r}; "
                             f"choose from {HASH_TIERS}")
        # affinity assumes a request produces the same pages whichever
        # replica serves it
        dtypes = {getattr(e, "kv_dtype", None) for e in engines}
        if len(dtypes) > 1:
            raise ValueError(f"replicas disagree on kv_dtype: "
                             f"{sorted(map(str, dtypes))}")
        self.kv_dtype: Optional[str] = next(iter(dtypes), None)
        # kept so add_replica builds a scheduler with the fleet's settings
        self._sched_kwargs = dict(
            capacity=capacity, continuous=continuous,
            prompt_pad_len=prompt_pad_len, collect_stats=collect_stats,
            cache_aware=cache_aware, sync=sync, chunk_tokens=chunk_tokens)
        self.replicas: List[Replica] = build_replicas(
            engines, **self._sched_kwargs)
        self.policy = policy
        self.skew = skew
        self.hash_tier = hash_tier
        self.capacity = capacity
        self.threaded = threaded
        self.responses: Dict[str, Response] = {}
        self.routing = {"affinity_matched": 0, "affinity_hashed": 0,
                        "fallback_load": 0}
        self._replica_of: Dict[str, int] = {}
        self._rr = 0
        self._seq = 0
        # the response ledger's lock, the fleet's wake signal, and the
        # exception a failed replica thread parks for run() to re-raise
        self._lock = threading.Lock()
        self._fleet_cv = threading.Condition()
        self._fleet_error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def loads(self) -> List[int]:
        """Outstanding requests (inbox + queued + live) per replica."""
        return [r.load for r in self.replicas]

    def _least_loaded(self, loads: Sequence[int]) -> int:
        return int(np.argmin(loads))          # ties -> lowest index

    def route(self, prompt) -> int:
        """The replica index for ``prompt`` under the policy (placement
        only; ``submit`` hands the request over)."""
        if self.policy == "round_robin":
            i = self._rr
            self._rr = (self._rr + 1) % self.num_replicas
            return i
        loads = self.loads()
        if self.policy == "least_loaded":
            return self._least_loaded(loads)
        return self._route_affinity(
            np.asarray(prompt, np.int32).reshape(-1), loads)

    def _hash_replica(self, chunk) -> int:
        """Tier 2: hash the page-aligned preamble chunk."""
        if self.hash_tier == "rendezvous":
            return preamble_rendezvous(chunk, self.num_replicas)
        return preamble_hash(chunk, self.num_replicas)

    def _route_affinity(self, prompt: np.ndarray,
                        loads: Sequence[int]) -> int:
        """Longest cached prefix, then the hash, then least-loaded, with
        the skew guard over the first two (one routing counter each)."""
        best, best_len = None, 0
        for rep in self.replicas:
            _, matched = rep.engine.match_prefix(prompt)
            if matched > best_len or (
                    matched == best_len and matched > 0
                    and loads[rep.index] < loads[best]):
                best, best_len = rep.index, matched
        if best is not None:
            tier = "affinity_matched"
        else:
            page_size = self.replicas[0].engine.page_size
            if prompt.size - 1 >= page_size:
                best = self._hash_replica(prompt[:page_size])
                tier = "affinity_hashed"
            else:
                self.routing["fallback_load"] += 1
                return self._least_loaded(loads)
        if self.skew is not None and loads[best] - min(loads) > self.skew:
            # a skew override counts as the fallback it was
            self.routing["fallback_load"] += 1
            return self._least_loaded(loads)
        self.routing[tier] += 1
        return best

    # ------------------------------------------------------------------
    # Scale-out with cache migration
    # ------------------------------------------------------------------
    def add_replica(self, engine) -> Dict[str, int]:
        """Grow the fleet by one replica, migrating hot cache to it.

        The new engine joins as replica N with the fleet's scheduler
        settings.  Then every preamble group (root radix chunk) of every
        existing replica is hashed again over the grown fleet: a group that
        now maps elsewhere has its cached subtree pushed through the
        snapshot codec (``snapshot_state(..., roots=[chunk])``) into the
        destination's state, and is then dropped from the source
        (``PagePool.forget``), so longest-match affinity follows the pages.
        Under ``rendezvous`` every moved group lands on the new replica;
        under ``mod`` most groups move.  Groups whose root page a live
        slot pins stay put.  Call between runs, not during a threaded
        ``run``.  Returns ``{"groups_moved": g, "pages_moved": p}``.
        """
        from repro_torch.serving.snapshot import snapshot_state

        if any(engine is rep.engine for rep in self.replicas):
            raise ValueError(
                "replicas must not share engine objects: a paged engine "
                "backs one live state at a time; build a fresh engine for "
                "the new replica")
        if getattr(engine, "kv_dtype", None) != self.kv_dtype:
            raise ValueError(
                f"new replica kv_dtype {getattr(engine, 'kv_dtype', None)!r}"
                f" != fleet kv_dtype {self.kv_dtype!r}")
        rep = Replica(len(self.replicas),
                      GSIScheduler(engine, **self._sched_kwargs))
        self.replicas.append(rep)
        own_streams(self.replicas)
        groups_moved = pages_moved = 0
        for src in self.replicas[:-1]:
            pager = src.engine.pager
            if pager is None or pager.index is None:
                continue
            for chunk in pager.index.groups():
                dest = self._hash_replica(np.asarray(chunk, np.int32))
                if dest == src.index:
                    continue
                node = pager.index.root.children.get(chunk)
                if node is None or node.page not in pager.cached:
                    continue          # pinned by a live slot: stays put
                snap = snapshot_state(src.engine, src.scheduler.state,
                                      roots=[chunk])
                if snap["pages"].size:
                    dst = self.replicas[dest]
                    dst.scheduler.state = dst.engine.load_cache(
                        dst.scheduler.state, snap)
                pages_moved += pager.forget(node.page)
                groups_moved += 1
        return {"groups_moved": groups_moved, "pages_moved": pages_moved}

    # ------------------------------------------------------------------
    # Submission / stepping
    # ------------------------------------------------------------------
    def submit(self, prompt, *, request_id: Optional[str] = None,
               max_steps: Optional[int] = None,
               arrival_time: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None, stream=None) -> str:
        """Route a prompt to a replica's inbox; returns the request id.

        Ids are unique fleet-wide (``req-N`` by default; a caller's id is
        checked against every replica).  The inbox is thread-safe, so
        submitting while a threaded ``run`` drains is safe.
        """
        if request_id is None:
            while f"req-{self._seq}" in self._replica_of:
                self._seq += 1
            request_id = f"req-{self._seq}"
        elif request_id in self._replica_of:
            raise ValueError(f"request id {request_id!r} already routed "
                             f"to replica {self._replica_of[request_id]}")
        self._seq += 1
        idx = self.route(prompt)
        self.replicas[idx].submit(prompt, request_id=request_id,
                                  max_steps=max_steps,
                                  arrival_time=arrival_time,
                                  priority=priority, deadline_s=deadline_s,
                                  stream=stream)
        self._replica_of[request_id] = idx
        with self._fleet_cv:
            self._fleet_cv.notify_all()   # wake a sequential idle wait
        return request_id

    def replica_of(self, request_id: str) -> int:
        """The replica index a submitted request was routed to."""
        return self._replica_of[request_id]

    def step(self, seed: Optional[int] = None) -> List[Response]:
        """Step every replica once on the calling thread; returns the
        responses finished now.  The fleet ``seed`` seeds the replicas'
        generators on the first step after construction or
        ``fresh_state``; later steps go on with each replica's own
        generator.  Idle replicas run no engine step."""
        unseeded = [rep for rep in self.replicas if rep._gen is None]
        if unseeded:
            if seed is None:
                raise RuntimeError("the first step needs the fleet seed to "
                                   "seed the replicas' generators")
            for rep in unseeded:
                rep.seed_rng(seed)
        finished: List[Response] = []
        for rep in self.replicas:
            for resp in rep.step():
                self.responses[resp.request_id] = resp
                finished.append(resp)
        return finished

    # ------------------------------------------------------------------
    # Fleet loop
    # ------------------------------------------------------------------
    def run(self, seed: int) -> Dict[str, Response]:
        """Drain every replica; returns id -> Response across the fleet.

        The fleet ``seed`` restarts every replica's generator
        (``Replica.seed_rng``).  ``threaded=True``: one thread per replica,
        each under its replica's stream, while this thread waits on a
        condition variable; ``threaded=False``: the replicas are stepped in
        turn here.  Both draw the same numbers.
        """
        for rep in self.replicas:
            rep.seed_rng(seed)
        if not self.threaded:
            return self._run_sequential()
        self._fleet_error = None
        for rep in self.replicas:
            if rep.stream is not None:
                # the state was built on the caller's stream
                rep.stream.wait_stream(
                    torch.cuda.current_stream(rep.engine.device))
        stop = threading.Event()
        threads = [threading.Thread(target=self._serve, args=(rep, stop),
                                    name=f"replica-{rep.index}",
                                    daemon=True)
                   for rep in self.replicas]
        for t in threads:
            t.start()
        try:
            with self._fleet_cv:
                while self._fleet_error is None and \
                        any(rep.has_work for rep in self.replicas):
                    # woken by the threads on progress, idle or error; the
                    # timeout covers a missed notification
                    self._fleet_cv.wait(timeout=0.2)
        finally:
            stop.set()
            for rep in self.replicas:
                with rep.cv:
                    rep.cv.notify_all()
            for t in threads:
                t.join()
            for rep in self.replicas:
                if rep.stream is not None:
                    rep.stream.synchronize()
        if self._fleet_error is not None:
            raise RuntimeError("a replica fleet-loop thread failed; the run "
                               "was aborted") from self._fleet_error
        return dict(self.responses)

    def _serve(self, rep: Replica, stop: threading.Event) -> None:
        """Fleet-loop body: drive one replica, under its device and stream,
        until the run stops; an exception is parked for ``run``."""
        try:
            with rep.context():
                self._serve_loop(rep, stop)
        except BaseException as exc:                  # noqa: BLE001
            with self._fleet_cv:
                if self._fleet_error is None:
                    self._fleet_error = exc
                self._fleet_cv.notify_all()

    def _serve_loop(self, rep: Replica, stop: threading.Event) -> None:
        """The per-replica drive loop: idle replicas park on their
        condition variable, arrival gaps wait exactly the gap, and finished
        responses go to the ledger under its lock."""
        sched = rep.scheduler
        while True:
            if stop.is_set() and self._fleet_error is not None:
                return            # a peer failed: abort, do not drain
            rep.drain_inbox()
            now = sched._now()
            busy = sched.pool.num_live > 0 or sched.has_pending
            if not busy and not sched._ready(now):
                nxt = rep.next_arrival()
                if nxt is None:
                    # drained: tell the fleet waiter, then park
                    with self._fleet_cv:
                        self._fleet_cv.notify_all()
                    with rep.cv:
                        if stop.is_set():
                            return
                        if not rep.inbox:
                            rep.cv.wait(timeout=0.05)
                    continue
                wait = nxt - now
                if wait > 0:
                    with rep.cv:
                        if not rep.inbox and not stop.is_set():
                            rep.cv.wait(timeout=wait)
                continue
            finished = sched.step(rep.generator)
            if finished:
                with self._lock:
                    for resp in finished:
                        self.responses[resp.request_id] = resp
                with self._fleet_cv:
                    self._fleet_cv.notify_all()

    def _run_sequential(self) -> Dict[str, Response]:
        """Step the fleet on this thread until drained; when nothing is
        live and the earliest arrival is ahead, wait out the gap (woken
        early by a submit)."""
        while any(rep.has_work for rep in self.replicas):
            busy = any(rep.scheduler.pool.num_live
                       or rep.scheduler.has_pending
                       for rep in self.replicas)
            if not busy:
                waits = [rep.next_arrival() - rep.scheduler._now()
                         for rep in self.replicas
                         if rep.next_arrival() is not None]
                wait = min(waits) if waits else 0.0
                if wait > 0:
                    with self._fleet_cv:
                        self._fleet_cv.wait(timeout=wait)
                    continue
            self.step()
        return dict(self.responses)

    # ------------------------------------------------------------------
    # Fleet-level stats
    # ------------------------------------------------------------------
    @property
    def engine_steps(self) -> int:
        """Engine steps summed over the fleet."""
        return sum(rep.scheduler.engine_steps for rep in self.replicas)

    @property
    def engine_steps_max(self) -> int:
        """Engine steps of the busiest replica (parallel-time proxy)."""
        return max(rep.scheduler.engine_steps for rep in self.replicas)

    @property
    def stats(self) -> EngineStats:
        """The fleet's EngineStats (``merge_engine_stats``)."""
        return merge_engine_stats([rep.scheduler.stats
                                   for rep in self.replicas])

    def prefix_stats(self) -> Dict[str, object]:
        """Fleet prefix-cache counters: the scheduler's keys summed,
        ``hit_rate`` from the sums, and ``per_replica`` with each replica's
        own (how affinity quality is read)."""
        per = [rep.scheduler.prefix_stats() for rep in self.replicas]
        agg: Dict[str, object] = {k: sum(p[k] for p in per)
                                  for k in per[0] if k != "hit_rate"}
        agg["hit_rate"] = agg["hits"] / max(1, agg["queries"])
        agg["per_replica"] = per
        return agg

    def pipeline_stats(self) -> Dict[str, object]:
        """Fleet pipeline counters: seconds summed, ``overlap_fraction``
        from the sums, ``per_replica`` with each replica's own."""
        per = [rep.scheduler.pipeline_stats() for rep in self.replicas]
        agg: Dict[str, object] = {
            k: sum(p[k] for p in per)
            for k in per[0] if k not in ("sync", "overlap_fraction")}
        total = agg["overlap_host_s"] + agg["serial_host_s"]
        agg["overlap_fraction"] = \
            agg["overlap_host_s"] / total if total > 0 else 0.0
        agg["sync"] = per[0]["sync"]
        agg["per_replica"] = per
        return agg

    def fresh_state(self) -> None:
        """Reset every replica for a new serving phase: each scheduler's
        ``fresh_state`` (state, pages, radix index, counters), its inbox
        and generator, and the router's response and routing ledgers and
        request ids."""
        for rep in self.replicas:
            with rep.cv:
                rep.inbox.clear()
            rep.scheduler.fresh_state()
            rep.routed = 0
            rep._gen = None
        self.responses = {}
        self._replica_of = {}
        self.routing = {k: 0 for k in self.routing}
        self._rr = 0
        self._seq = 0
        self._fleet_error = None
