"""Continuous-batching request scheduler for the GSI serving engine.

A port of ``repro.serving.scheduler``, lock-step and pipelined.  The engine
decodes a fixed-capacity batch; the scheduler keeps it full.  Requests wait
in an arrival queue, admission maps them onto free slots (prompt prefill
into the vacated row via the engine's masked ``admit``), and every engine
step the scheduler harvests finished slots — EOS, per-request step budget,
or the paper's B.2 early stop — frees them, and admits queued prompts on
the next step.

With a paged engine, admission consults the radix prefix cache: the longest
cached page-aligned prefix of each prompt is spliced into the new slot's
block table and only the tail is prefilled; under pool pressure cached
pages are evicted before a request is deferred.  As decode commits fill
pages, they are published too (``_publish_decode``), so later requests that
share a trajectory splice it.

``continuous=False`` degrades to gang scheduling (admit only into an empty
pool).

``sync=False`` runs the two-stage pipeline: one step ticket stays in
flight (``GSIServingEngine.dispatch_decode``), and the host harvests the
previous step while it runs.  Each call materializes the in-flight ticket,
retires it (finish reasons, slot and page release: release is deferred
until the freeing step's tokens are on the host), admits, then dispatches
the next step; the retired step's heavy harvest (token slicing, response
assembly, stats) runs under that next step.  Admission sees the same free
slots and pages, and the generator the same draws, as the lock-step loop,
so both produce the same tokens.

Not ported yet, and raising: ``chunk_tokens`` (chunked prefill),
``cache_aware`` ordering, priorities and preemption, deadlines and token
streams.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.gsi_engine import (EngineStats, GSIServingEngine,
                                            StepResult, StepTicket)
from repro_torch.serving.slots import PAD, SlotPool, pack_prompts


@dataclass
class Request:
    """A queued prompt awaiting admission (scheduler-internal record)."""

    id: str
    prompt: np.ndarray            # 1-D int32 token array (no padding)
    max_steps: int                # per-request reasoning-step budget
    arrival_time: float = 0.0     # seconds after scheduler start


@dataclass
class Response:
    """One finished request: its step tokens, finish reason and timing."""

    request_id: str
    steps: List[np.ndarray] = field(default_factory=list)
    finish_reason: str = ""       # "eos" | "low_reward" | "max_steps"
    engine_steps: int = 0         # decode steps this request consumed
    admitted_at: float = 0.0      # seconds since scheduler start
    finished_at: float = 0.0
    arrival_time: float = 0.0
    first_token_at: Optional[float] = None

    @property
    def tokens(self) -> np.ndarray:
        """All committed step tokens concatenated (PAD stripped)."""
        if not self.steps:
            return np.zeros((0,), np.int32)
        return np.concatenate([np.asarray(s, np.int32) for s in self.steps])

    @property
    def num_tokens(self) -> int:
        return int(self.tokens.size)

    @property
    def latency(self) -> float:
        """Queueing + decode latency, seconds since the request arrived."""
        return self.finished_at - self.arrival_time


@dataclass
class _InflightStep:
    """A dispatched, unmaterialized engine step (async pipeline).

    ``bound`` snapshots slot -> partial :class:`Response` at dispatch
    time, so the harvest attributes the step's rows to the requests that
    occupied the slots, even after the slots are released and re-admitted.
    """

    ticket: StepTicket
    bound: Dict[int, Response]


@dataclass
class _RetiredStep:
    """A materialized step awaiting its deferred (overlapped) harvest.

    ``res`` is host numpy (the ticket was materialized before any of its
    slots could be released); ``finished`` carries the finish decisions,
    (slot, response, reason, decided_at), made at release time.
    """

    res: StepResult
    bound: Dict[int, Response]
    finished: List[Tuple[int, Response, str, float]]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


class GSIScheduler:
    """Drives ``GSIServingEngine`` steps over a slot pool.

    capacity:      number of slots == engine batch size.
    continuous:    admit into freed slots mid-flight (True) or only into an
                   empty pool (False, gang discipline).
    collect_stats: forward per-step reward/ratio arrays into ``stats``.
    sync:          True (default) runs the lock-step loop: every ``step``
                   dispatches one engine step and waits for its results.
                   False runs the two-stage pipeline: one ticket stays in
                   flight and the previous step's harvest overlaps it
                   (``step`` then returns the responses finalized this
                   call, which lag the decode by one step until the
                   pipeline drains).  Tokens are identical either way.
    """

    def __init__(self, engine: GSIServingEngine, *, capacity: int,
                 continuous: bool = True, prompt_pad_len: int = 0,
                 collect_stats: bool = False, cache_aware: bool = False,
                 sync: bool = True, chunk_tokens: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if chunk_tokens:
            raise _not_ported("chunked prefill (chunk_tokens)")
        if cache_aware:
            raise _not_ported("cache-aware admission ordering")
        self.engine = engine
        self.capacity = capacity
        self.continuous = continuous
        self.collect_stats = collect_stats
        self.sync = bool(sync)
        self._pad = int(prompt_pad_len)
        self._seq = 0
        self.queue: deque = deque()
        # idle handling: woken by submit(), waits out exact arrival gaps
        self._wake = threading.Condition()
        self.fresh_state()

    def fresh_state(self) -> None:
        """Reset for a new serving phase (back-to-back runs).

        Rebuilds the engine state (for a paged engine also the page pool
        and radix index) and resets all scheduler bookkeeping with it:
        queue, slot pool, responses, the pipeline and the counters
        ``prefix_stats()`` and ``pipeline_stats()`` read.
        """
        cap = self.capacity
        self.state = self.engine.fresh_state(cap)
        self.pool = SlotPool(cap)
        self.queue.clear()
        self.stats = EngineStats()
        self.responses: Dict[str, Response] = {}
        self.engine_steps = 0
        self._partial: Dict[int, Response] = {}      # slot -> in-flight
        self._steps_taken = np.zeros((cap,), np.int64)
        self._budget = np.zeros((cap,), np.int64)
        self._t0: Optional[float] = None
        # decode-time page publication: each slot's committed context and
        # how many of its full pages are already in the radix index
        self._ctx: Dict[int, np.ndarray] = {}
        self._pub_full: Dict[int, int] = {}
        self._ids: set = set()
        # async pipeline state: at most one dispatched, unmaterialized
        # ticket plus one materialized, unharvested step
        self._inflight: Optional[_InflightStep] = None
        self._retired: Optional[_RetiredStep] = None
        # host/device overlap accounting (pipeline_stats)
        self._overlap_host_s = 0.0       # host work under an in-flight step
        self._serial_host_s = 0.0        # host work with no step in flight
        self._materialize_wait_s = 0.0   # blocked waiting on device results
        self._dispatch_s = 0.0           # enqueueing steps

    # ------------------------------------------------------------------
    # Submission / admission control
    # ------------------------------------------------------------------
    def submit(self, prompt, *, request_id: Optional[str] = None,
               max_steps: Optional[int] = None,
               arrival_time: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None, stream=None) -> str:
        """Queue a prompt; returns the request id (unique for the
        scheduler's lifetime)."""
        if priority:
            raise _not_ported("priority scheduling and preemption")
        if deadline_s is not None:
            raise _not_ported("deadline accounting")
        if stream is not None:
            raise _not_ported("token streaming")
        g = self.engine.gcfg
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        budget = int(max_steps if max_steps is not None else g.max_steps)
        if budget < 1:
            raise ValueError("max_steps must be >= 1")
        need = self.engine.positions_needed(prompt.size, budget)
        if need > self.engine.max_seq:
            raise ValueError(
                f"request needs up to {need} cache positions but engine "
                f"max_seq={self.engine.max_seq}; shorten the prompt or "
                f"lower max_steps")
        if self.engine.paged:
            blocks = self.engine.blocks_needed(prompt.size, budget)
            if blocks > self.engine.num_pages:
                raise ValueError(
                    f"request needs up to {blocks} pages but the pool "
                    f"only has {self.engine.num_pages}; it could never "
                    f"be admitted")
        if request_id is None:
            while f"req-{self._seq}" in self._ids:
                self._seq += 1
            request_id = f"req-{self._seq}"
        elif request_id in self._ids:
            raise ValueError(f"duplicate request id {request_id!r}")
        self._ids.add(request_id)
        self._seq += 1
        self.queue.append(Request(id=request_id, prompt=prompt,
                                  max_steps=budget,
                                  arrival_time=float(arrival_time)))
        if len(self.queue) > 1 and \
                arrival_time < self.queue[-2].arrival_time:
            self.queue = deque(sorted(self.queue,
                                      key=lambda r: r.arrival_time))
        with self._wake:
            self._wake.notify_all()
        return request_id

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def _ready(self, now: float) -> bool:
        return bool(self.queue) and self.queue[0].arrival_time <= now

    def _admit_ready(self, now: float) -> List[str]:
        """Move arrived requests from the queue into free slots (FIFO).

        Each admission splices its longest cached prefix and prefills only
        the tail.  A request that does not fit (no free slot or pages)
        stays queued — back-pressure, never dropped — and blocks the
        requests behind it until a later step frees room.
        """
        if not self.continuous and self.pool.num_live > 0:
            return []
        batch: Dict[int, Tuple[Request, np.ndarray]] = {}
        starts = np.zeros((self.capacity,), np.int32)
        committed_total = 0
        while self._ready(now):
            free = [s for s in self.pool.free_slots() if s not in batch]
            req = self.queue[0]
            shared, hit_tok = self.engine.match_prefix(req.prompt)
            if not free or not self.engine.admit_ok(
                    req.prompt.size, req.max_steps, shared=shared):
                break
            self.queue.popleft()
            slot = free[0]
            self.engine.claim_slot(slot, req.prompt.size, req.max_steps,
                                   shared=shared)
            tail = req.prompt.size - hit_tok
            committed_total += tail
            batch[slot] = (req, req.prompt)
            starts[slot] = hit_tok
            self.stats.bump(
                prefix_queries=1, prefix_hits=int(bool(hit_tok)),
                prefix_hit_tokens=int(hit_tok),
                prefix_pages_reused=len(shared),
                prefill_tokens=max(tail - 1, 0))
        if not batch:
            return []
        longest = max(p.size for _, p in batch.values())
        if longest > self._pad:
            self._pad = -(-longest // 8) * 8
        packed = pack_prompts({s: p for s, (_, p) in batch.items()},
                              self.capacity, self._pad)
        mask = np.zeros((self.capacity,), bool)
        for slot, (req, prompt) in batch.items():
            mask[slot] = True
            self.pool.claim(slot, req.id)
            # admit() publishes exactly the prompt's full pages
            self._ctx[slot] = np.asarray(prompt, np.int32)
            self._pub_full[slot] = max(prompt.size - 1, 0) \
                // self.engine.page_size
            self._steps_taken[slot] = 0
            self._budget[slot] = req.max_steps
            self._partial[slot] = Response(request_id=req.id,
                                           admitted_at=now,
                                           arrival_time=req.arrival_time)
        self.state = self.engine.admit(self.state, mask, packed, starts)
        self.stats.prefill_commit_max = max(self.stats.prefill_commit_max,
                                            committed_total)
        if self.engine.pager is not None:
            self.stats.pages_evicted = self.engine.pager.evicted
        return [req.id for req, _ in batch.values()]

    # ------------------------------------------------------------------
    # Decode-time page publication
    # ------------------------------------------------------------------
    def _publish_decode(self, slot: int, toks: np.ndarray) -> None:
        """Fold one harvested step's tokens into the slot's committed
        context and publish every newly filled page to the radix index.

        Runs after the step's commit was issued on the device stream and
        before the slot can be released, so a published page's content is
        complete and its refcount still held.  Per the engine invariant the
        context's last token is pending: ``(len - 1) // page_size`` pages
        are full.
        """
        ctx = self._ctx.get(slot)
        if ctx is None:
            return
        if toks.size:
            ctx = np.concatenate([ctx, np.asarray(toks, np.int32)])
            self._ctx[slot] = ctx
        eng = self.engine
        if not eng.decode_publish:
            return
        full = max(ctx.size - 1, 0) // eng.page_size
        if full <= self._pub_full.get(slot, 0):
            return                        # no page filled this step
        published = eng.publish_prefix(slot, ctx)
        self._pub_full[slot] = full
        if published:
            self.stats.bump(decode_pages_published=published)

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache admission counters."""
        s = self.stats
        pager = self.engine.pager
        return {
            "queries": s.prefix_queries,
            "hits": s.prefix_hits,
            "hit_rate": s.prefix_hit_rate,
            "hit_tokens": s.prefix_hit_tokens,
            "pages_reused": s.prefix_pages_reused,
            "prefill_tokens": s.prefill_tokens,
            "pages_evicted": s.pages_evicted,
            "pages_published_decode": s.decode_pages_published,
            "pages_cached": 0 if pager is None else pager.num_cached,
        }

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------
    def step(self, gen, gen_target=None) -> List[Response]:
        """Admit ready requests, run one engine decode step, harvest and
        free finished slots.

        ``sync=True``: dispatches and materializes one step, returning the
        responses finished *this* step.  ``sync=False``: pumps the pipeline
        (harvest, materialize, retire, admit) and dispatches the next step
        without waiting for it; the returned responses are the ones
        finalized this call, which lag the decode by one step until the
        pipeline drains (``flush``).
        """
        if self.sync:
            return self._step_sync(gen, gen_target)
        finished = self._pump(self._now())
        if self.pool.num_live:
            self._dispatch(gen, gen_target)
        else:
            finished += self.flush()
        return finished

    def _step_sync(self, gen, gen_target=None) -> List[Response]:
        """The lock-step path: one dispatched and materialized step."""
        now = self._now()
        self._admit_ready(now)
        if self.pool.num_live == 0:
            return []
        self.state, res = self.engine.step_decode(
            self.state, gen, gen_target, stats=self.stats,
            collect_stats=self.collect_stats)
        self.engine_steps += 1
        finished: List[Response] = []
        force_done = np.zeros((self.capacity,), bool)
        for slot in self.pool.live_slots():
            if res.done_prev[slot]:
                continue
            resp = self._partial[slot]
            toks = res.chosen[slot]
            kept = toks[toks != PAD]
            self._emit_step(resp, kept, self._now())
            # publish the pages this step filled before a release below
            # could drop the slot's page references
            self._publish_decode(slot, kept)
            self._steps_taken[slot] += 1
            reason = self._finish_reason(slot, res)
            if reason:
                force_done[slot] = reason == "max_steps"
                self._release(slot)
                self._finalize(resp, reason, self._now())
                finished.append(resp)
        self.state = self.engine.force_done(self.state, force_done)
        return finished

    def _finish_reason(self, slot: int, res: StepResult) -> str:
        """Why ``slot`` finished at step ``res`` ("" if it did not)."""
        if res.eos[slot]:
            return "eos"
        if res.failed[slot]:
            return "low_reward"
        if self._steps_taken[slot] >= self._budget[slot]:
            return "max_steps"
        return ""

    def _release(self, slot: int) -> None:
        """Free a finished slot and its pages (admission may reuse them)."""
        self.pool.release(slot)
        self.engine.release_slot(slot)
        del self._partial[slot]
        self._ctx.pop(slot, None)
        self._pub_full.pop(slot, None)

    def _emit_step(self, resp: Response, toks: np.ndarray,
                   now: float) -> None:
        """Append one harvested step's tokens to ``resp``."""
        resp.steps.append(toks)
        resp.engine_steps += 1
        if toks.size and resp.first_token_at is None:
            resp.first_token_at = now

    def _finalize(self, resp: Response, reason: str, at: float) -> None:
        """Stamp a finished response and record it."""
        resp.finish_reason = reason
        resp.finished_at = at
        self.responses[resp.request_id] = resp
        self.stats.bump(requests_finished=1)

    # ------------------------------------------------------------------
    # Async pipeline (sync=False)
    # ------------------------------------------------------------------
    @property
    def has_pending(self) -> bool:
        """True while the pipeline holds an unharvested step."""
        return self._inflight is not None or self._retired is not None

    def _pump(self, now: float) -> List[Response]:
        """Advance the pipeline up to (not including) the next dispatch.

        1. harvest the step retired last call (token slicing, response
           finalization, stats) while the in-flight step runs on the
           device: the overlapped host work the pipeline exists for;
        2. materialize the in-flight ticket, the only point where the
           host waits on the device;
        3. retire it: finish reasons, slot and page release (deferred
           exactly one step, the final tokens already in host memory);
        4. admit, seeing the free slots and pages the lock-step loop sees
           before this engine step.
        """
        finished: List[Response] = []
        t0 = time.perf_counter()
        overlapped = self._inflight is not None
        if self._retired is not None:
            retired, self._retired = self._retired, None
            finished = self._harvest(retired)
        t1 = time.perf_counter()
        if overlapped:
            self._overlap_host_s += t1 - t0
        else:
            self._serial_host_s += t1 - t0
        if self._inflight is not None:
            pend, self._inflight = self._inflight, None
            res = self.engine.materialize(pend.ticket)
            t2 = time.perf_counter()
            self._materialize_wait_s += t2 - t1
            self._retire(pend, res)
            self._admit_ready(now)
            self._serial_host_s += time.perf_counter() - t2
        else:
            self._admit_ready(now)
            self._serial_host_s += time.perf_counter() - t1
        return finished

    def _retire(self, pend: _InflightStep, res: StepResult) -> None:
        """Decide finishes for a just-materialized step and free slots.

        The cheap, order-critical part of the harvest: decode-page
        publication, budget counting, finish reasons, slot and page
        release and the budget force-done, all that admission parity with
        the lock-step loop depends on.  The rest waits in
        ``self._retired`` for ``_harvest``, which must have taken the
        previous retired step already.
        """
        assert self._retired is None, "a retired step was not harvested"
        now = self._now()
        force_done = np.zeros((self.capacity,), bool)
        finished: List[Tuple[int, Response, str, float]] = []
        for slot, resp in pend.bound.items():
            if res.done_prev[slot]:
                continue
            toks = res.chosen[slot]
            # commit-then-publish, before the release, as the lock-step
            # loop does
            self._publish_decode(slot, toks[toks != PAD])
            self._steps_taken[slot] += 1
            reason = self._finish_reason(slot, res)
            if reason:
                force_done[slot] = reason == "max_steps"
                self._release(slot)
                finished.append((slot, resp, reason, now))
        self.state = self.engine.force_done(self.state, force_done)
        self._retired = _RetiredStep(res=res, bound=pend.bound,
                                     finished=finished)

    def _harvest(self, retired: _RetiredStep) -> List[Response]:
        """Heavy harvest of a retired step (runs under the next step).

        Appends every bound slot's step tokens to its partial response,
        finalizes the responses whose finish reason fired, and folds the
        step into ``stats``: host numpy only, on data materialized before
        any of these slots could be reused.
        """
        res = retired.res
        now = self._now()
        for slot, resp in retired.bound.items():
            if res.done_prev[slot]:
                continue
            toks = res.chosen[slot]
            self._emit_step(resp, toks[toks != PAD], now)
        done_now: List[Response] = []
        for _, resp, reason, _ in retired.finished:
            # finalized at harvest time, when its tokens are visible
            self._finalize(resp, reason, now)
            done_now.append(resp)
        self.engine.fold_step_stats(res, self.stats, self.collect_stats)
        return done_now

    def _dispatch(self, gen, gen_target=None) -> None:
        """Dispatch the next engine step and leave its ticket in flight.

        The caches are written in place, so a step may be dispatched only
        after the previous one was materialized."""
        if self._inflight is not None:
            raise RuntimeError("dispatch with a step still in flight: "
                               "materialize it first (_pump or flush)")
        t0 = time.perf_counter()
        self.state, ticket = self.engine.dispatch_decode(
            self.state, gen, gen_target)
        self.engine_steps += 1
        self._inflight = _InflightStep(ticket=ticket,
                                       bound=dict(self._partial))
        self._dispatch_s += time.perf_counter() - t0

    def flush(self) -> List[Response]:
        """Drain the pipeline without dispatching: harvest the retired
        step, materialize and retire the in-flight ticket (if any), and
        harvest it.  Returns the responses finalized by the drain, in
        step order."""
        finished: List[Response] = []
        if self._inflight is not None:
            if self._retired is not None:
                # the previous step first: retiring the in-flight one
                # would otherwise replace it, unharvested
                retired, self._retired = self._retired, None
                t0 = time.perf_counter()
                finished = self._harvest(retired)
                self._overlap_host_s += time.perf_counter() - t0
            pend, self._inflight = self._inflight, None
            t0 = time.perf_counter()
            res = self.engine.materialize(pend.ticket)
            self._materialize_wait_s += time.perf_counter() - t0
            self._retire(pend, res)
        if self._retired is not None:
            retired, self._retired = self._retired, None
            t0 = time.perf_counter()
            finished += self._harvest(retired)
            self._serial_host_s += time.perf_counter() - t0
        return finished

    def pipeline_stats(self) -> Dict[str, float]:
        """Host/device overlap accounting for the async pipeline.

        ``overlap_fraction`` is the share of host bookkeeping time
        (harvest and admission) that ran while an engine step was in
        flight; 0.0 for the lock-step loop.  ``materialize_wait_s`` is the
        time the host spent blocked on device results.  ``dispatch_s`` is
        reported apart: it is the time spent enqueueing steps, and it
        includes the host's wait for each draft phase, whose ``accept``
        decides the fallback on the host.
        """
        total = self._overlap_host_s + self._serial_host_s
        return {
            "sync": self.sync,
            "overlap_host_s": self._overlap_host_s,
            "serial_host_s": self._serial_host_s,
            "materialize_wait_s": self._materialize_wait_s,
            "dispatch_s": self._dispatch_s,
            "overlap_fraction":
                self._overlap_host_s / total if total > 0 else 0.0,
        }

    # ------------------------------------------------------------------
    # Run loops
    # ------------------------------------------------------------------
    def _wait_next_arrival(self) -> None:
        """Idle until the head queued request arrives (or a submit wakes
        the scheduler)."""
        wait = self.queue[0].arrival_time - self._now()
        if wait > 0:
            with self._wake:
                self._wake.wait(timeout=wait)

    def run(self, gen) -> Dict[str, Response]:
        """Drain the queue and all live slots; returns id -> Response.

        ``gen`` is a ``torch.Generator`` on the engine's device; every
        dispatched engine step draws its noise from it in order, in both
        loops, so they draw the same numbers.
        """
        self._t0 = time.perf_counter()
        if not self.sync:
            return self._run_async(gen)
        while self.queue or self.pool.num_live:
            if self.pool.num_live == 0 and not self._ready(self._now()):
                self._wait_next_arrival()
                continue
            self._step_sync(gen)
        return dict(self.responses)

    def _run_async(self, gen) -> Dict[str, Response]:
        """The pipelined drain: the generator is drawn from only inside a
        dispatch, never on a drain-only iteration."""
        while self.queue or self.pool.num_live or self.has_pending:
            now = self._now()
            if (self.pool.num_live == 0 and not self.has_pending
                    and not self._ready(now)):
                self._wait_next_arrival()
                continue
            self._pump(now)
            if self.pool.num_live:
                self._dispatch(gen)
            else:
                self.flush()
        return dict(self.responses)
