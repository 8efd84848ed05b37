"""One data-parallel serving replica: an engine + scheduler pair.

A port of ``repro.serving.replica``.  A *replica* is the unit of
data-parallel scale-out: one :class:`GSIServingEngine` (its own page pool
and radix prefix index) driven by one :class:`GSIScheduler` (its own queue,
slot pool and stats).  Replicas share no pages, trie or state, only the
read-only weight tensors their engines were built over, so a fleet is N
independent copies of the single-engine serving stack, and the one
cross-replica component is the :class:`~repro_torch.serving.router.
ReplicaRouter` that assigns requests.

For the thread-per-replica fleet loop each replica carries a thread-safe
*inbox*: ``submit`` only enqueues (any thread, no scheduler state touched)
and the thread driving the replica drains the inbox into the scheduler
before each admission round.

Two things differ from the reference:

* **Generators.**  The reference's key chain (``fold_in(fleet_key,
  index)``) becomes the replica's own ``torch.Generator`` on its engine's
  device, seeded from the fleet seed and the replica's index only
  (:func:`replica_seed`), so no peer and no thread schedule changes its
  stream.  A step draws from it only inside a dispatched engine step, and
  the threaded and the sequential fleet step every replica through the same
  generator, so the two produce the same tokens at any temperature.
* **Streams.**  A replica whose engine is on a CUDA device owns a
  ``torch.cuda.Stream``; the fleet thread driving it runs under that stream
  and under ``torch.cuda.device(engine.device)`` (:meth:`Replica.context`).
  The kernels' per-stream fp32 scratch (``kernels/streams.py``) is then the
  replica's own: on one shared stream, two threads' split and combine
  launches would interleave over one buffer.
"""
from __future__ import annotations

import contextlib
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.gsi_engine import GSIServingEngine
from repro_torch.serving.scheduler import GSIScheduler, Response


def replica_seed(fleet_seed: int, index: int) -> int:
    """The seed of replica ``index``'s generator: a function of the fleet
    seed and the index only (numpy's ``SeedSequence`` mixes the pair)."""
    words = np.random.SeedSequence((int(fleet_seed), int(index))) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@dataclass
class Replica:
    """One router-fronted serving replica (engine + scheduler + index).

    ``index`` is the replica's stable position in the fleet (what the
    affinity hash maps to).  ``routed`` counts the requests assigned here.
    ``inbox``/``cv`` are the thread-safe submit queue and wake signal of
    the fleet loop; only the thread driving the replica touches the
    scheduler itself.  ``stream`` is the replica's CUDA stream (None on the
    CPU).
    """

    index: int
    scheduler: GSIScheduler
    routed: int = 0
    inbox: deque = field(default_factory=deque, repr=False)
    cv: threading.Condition = field(default_factory=threading.Condition,
                                    repr=False, compare=False)
    stream: Optional["torch.cuda.Stream"] = field(default=None, repr=False,
                                                  compare=False)
    _gen: Optional[torch.Generator] = field(default=None, repr=False,
                                            compare=False)

    @property
    def engine(self) -> GSIServingEngine:
        """The replica's engine (owns this replica's pages and trie)."""
        return self.scheduler.engine

    @property
    def load(self) -> int:
        """Outstanding work: inbox + queued requests + live slots (what
        least-loaded placement and the skew guard compare)."""
        return len(self.inbox) + len(self.scheduler.queue) \
            + self.scheduler.pool.num_live

    @property
    def cached_groups(self) -> List[Tuple[int, ...]]:
        """First-chunk keys of the radix root whose pages are cached
        (reference-free): the unit ``add_replica``'s migration moves.
        Empty for a dense or cache-less engine."""
        pager = self.engine.pager
        if pager is None or pager.index is None:
            return []
        return [chunk for chunk in pager.index.groups()
                if pager.index.root.children[chunk].page in pager.cached]

    @property
    def has_work(self) -> bool:
        """True while anything is inboxed, queued, decoding or still in the
        scheduler's pipeline on this replica."""
        return bool(self.inbox) or bool(self.scheduler.queue) \
            or self.scheduler.pool.num_live > 0 \
            or self.scheduler.has_pending

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival time across inbox and queue (None if empty);
        the inbox is read under the replica lock, since a concurrent
        ``submit`` may append to it."""
        with self.cv:
            times = [item[3] for item in self.inbox]
        if self.scheduler.queue:
            times.append(float(self.scheduler.queue[0].arrival_time))
        return min(times) if times else None

    # -- submission (any thread) ---------------------------------------
    def submit(self, prompt, *, request_id: str,
               max_steps: Optional[int] = None,
               arrival_time: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None, stream=None) -> str:
        """Enqueue a routed request on the inbox (thread-safe) and wake the
        replica's fleet-loop thread if it is idle."""
        with self.cv:
            self.routed += 1
            self.inbox.append((prompt, request_id, max_steps,
                               float(arrival_time), int(priority),
                               deadline_s, stream))
            self.cv.notify_all()
        return request_id

    # -- driving (owner thread only) -----------------------------------
    def drain_inbox(self) -> int:
        """Move inboxed requests into the scheduler queue; returns how many
        moved.  Called only by the thread driving the replica."""
        moved = 0
        while True:
            with self.cv:
                if not self.inbox:
                    return moved
                (prompt, rid, max_steps, arrival, priority, deadline_s,
                 stream) = self.inbox.popleft()
            self.scheduler.submit(prompt, request_id=rid,
                                  max_steps=max_steps, arrival_time=arrival,
                                  priority=priority, deadline_s=deadline_s,
                                  stream=stream)
            moved += 1

    def seed_rng(self, fleet_seed: int) -> None:
        """(Re)start this replica's generator from the fleet seed: seeded
        by :func:`replica_seed`, whatever the fleet size or thread
        schedule."""
        gen = torch.Generator(device=self.engine.device)
        gen.manual_seed(replica_seed(fleet_seed, self.index))
        self._gen = gen

    @property
    def generator(self) -> torch.Generator:
        """The replica's generator (``seed_rng`` first)."""
        if self._gen is None:
            raise RuntimeError("seed_rng() must be called before stepping "
                               "a replica through its own generator")
        return self._gen

    def context(self):
        """The device and stream the replica's work runs under: its CUDA
        stream and device for a CUDA engine, nothing on the CPU."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.engine.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def step(self) -> List[Response]:
        """One scheduler step (admit / decode / harvest) on this replica,
        drawing from its own generator.  Drains the inbox first, so a
        sequential fleet sees every routed request; a replica with no live
        slots and nothing ready to admit runs no engine step and draws
        nothing."""
        self.drain_inbox()
        return self.scheduler.step(self.generator)


def own_streams(replicas: List[Replica]) -> None:
    """Give every replica on a CUDA engine a stream of its own.

    PyTorch hands out streams from a fixed per-device pool in turn, so a
    new ``torch.cuda.Stream`` may be one a peer already holds; draw again
    until each replica's stream is distinct from every other's and from
    the default stream."""
    taken = {(r.engine.device, r.stream.cuda_stream) for r in replicas
             if r.stream is not None}
    for rep in replicas:
        dev = rep.engine.device
        if dev.type != "cuda" or rep.stream is not None:
            continue
        for _ in range(64):
            stream = torch.cuda.Stream(device=dev)
            key = (dev, stream.cuda_stream)
            if key not in taken and stream.cuda_stream != 0:
                break
        else:
            raise RuntimeError(f"no free CUDA stream for replica "
                               f"{rep.index} on {dev}")
        taken.add(key)
        rep.stream = stream


def build_replicas(engines, *, capacity: int, continuous: bool = True,
                   prompt_pad_len: int = 0, collect_stats: bool = False,
                   cache_aware: bool = True, sync: bool = True,
                   chunk_tokens: int = 0) -> List[Replica]:
    """Wrap N independent engines into router-ready replicas.

    Each engine must be a distinct object: a paged engine backs one live
    state (its page allocator is host state), so replicas never share one.
    ``capacity`` is per replica.  ``cache_aware`` turns on cache-aware
    admission inside each replica, ``sync=False`` gives every replica the
    pipelined scheduler, and ``chunk_tokens`` sets every replica's
    per-step prefill budget.  Replicas on CUDA engines get distinct
    streams (:func:`own_streams`).
    """
    engines = list(engines)
    if len(set(map(id, engines))) != len(engines):
        raise ValueError(
            "replicas must not share engine objects: a paged engine backs "
            "one live state at a time (one page pool, one radix index); "
            "build one engine per replica")
    reps = [Replica(i, GSIScheduler(eng, capacity=capacity,
                                    continuous=continuous,
                                    prompt_pad_len=prompt_pad_len,
                                    collect_stats=collect_stats,
                                    cache_aware=cache_aware, sync=sync,
                                    chunk_tokens=chunk_tokens))
            for i, eng in enumerate(engines)]
    own_streams(reps)
    return reps
