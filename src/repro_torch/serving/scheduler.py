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

Three SLO mechanisms ride on top, as in the reference:

* **chunked prefill** (``chunk_tokens > 0``): prompt prefill is metered to
  at most ``chunk_tokens`` committed tokens per engine step, shared between
  new admissions and mid-prefill continuations.  A long prompt is admitted
  truncated (its slot stays done on the device, inert under the decode
  masks) and grows by one chunk per step through the engine's ``extend``,
  so live requests keep decoding.  At temperature 0 the committed context,
  hence every token, is the same chunked or not.
* **priority preemption**: requests carry ``priority`` (larger is more
  urgent) and an optional ``deadline_s``.  When a higher-priority arrival
  cannot be admitted, the lowest-priority live slot is paused: its full
  committed pages are published to the radix cache, its slot and pages are
  released, and the request requeues with prompt + generated tokens as its
  resume context, spliced back from the cache on re-admission.  A pause,
  never a drop: ``free + referenced + cached == num_pages`` holds across
  every preemption and resume.
* **token streams**: ``submit(..., stream=cb)`` delivers a
  :class:`StreamEvent` per harvested step and a final one, in materialize
  order, which gives each request's TTFT and inter-token latency;
  :class:`TokenStream` turns the callback into a blocking iterator.

``cache_aware=True`` admits, within a priority class, the queued request
with the longest live radix match first, bypassing the class's FIFO head
at most ``_bypass_limit`` admissions in a row.
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
    submitted_at: float = 0.0     # host clock (perf_counter) at submit
    priority: int = 0             # larger = more urgent (0 = default class)
    deadline_s: Optional[float] = None   # SLO: finish within s of arrival


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
    priority: int = 0
    deadline_s: Optional[float] = None
    first_token_at: Optional[float] = None  # scheduler clock, first token
    preemptions: int = 0          # times this request was paused

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

    @property
    def ttft(self) -> float:
        """Time to the first committed token since arrival (NaN if none)."""
        if self.first_token_at is None:
            return float("nan")
        return self.first_token_at - self.arrival_time

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (NaN with fewer than
        two tokens)."""
        n = self.num_tokens
        if self.first_token_at is None or n < 2:
            return float("nan")
        return (self.finished_at - self.first_token_at) / (n - 1)

    @property
    def deadline_missed(self) -> bool:
        """True iff a deadline was set and the latency exceeded it."""
        return self.deadline_s is not None and self.latency > self.deadline_s


@dataclass
class StreamEvent:
    """One incremental update of a request's stream.

    A per-step event carries the step's non-PAD tokens, in materialize
    order; the final event (``final=True``, possibly no tokens) carries the
    finish reason.  ``t`` is the scheduler clock (seconds since start): the
    first event's ``t`` minus the request's arrival time is its TTFT, and
    the gaps between events are inter-token latencies.
    """

    request_id: str
    tokens: np.ndarray
    step: int                     # engine steps the request has consumed
    final: bool = False
    finish_reason: str = ""
    t: float = 0.0


class TokenStream:
    """A thread-safe stream consumer: a callback that is also an iterator.

    Pass one as ``submit(..., stream=...)`` and iterate it from any thread:
    iteration yields :class:`StreamEvent` objects as the scheduler harvests
    them and ends after the final one.
    """

    def __init__(self):
        self._events: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def __call__(self, event: StreamEvent) -> None:
        """Producer side: enqueue one event (the scheduler's thread)."""
        with self._cv:
            self._events.append(event)
            if event.final:
                self._closed = True
            self._cv.notify_all()

    def __iter__(self):
        """Consumer side: wait for events until the final one arrives."""
        while True:
            with self._cv:
                while not self._events and not self._closed:
                    self._cv.wait()
                if not self._events:
                    return
                event = self._events.popleft()
            yield event
            if event.final:
                return


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


@dataclass
class _Prefill:
    """A slot mid chunked prefill: how much of its prompt is committed.

    ``committed`` counts the prompt tokens the engine holds for the slot
    (the pending one and the prefix-cache match included); the next chunk
    is ``req.prompt[committed:committed + chunk]``.  The slot is claimed
    and done on the device until its final chunk commits.
    """

    req: Request
    committed: int


class GSIScheduler:
    """Drives ``GSIServingEngine`` steps over a slot pool.

    capacity:      number of slots == engine batch size.
    continuous:    admit into freed slots mid-flight (True) or only into an
                   empty pool (False, gang discipline).
    collect_stats: forward per-step reward/ratio arrays into ``stats``.
    cache_aware:   within the highest arrived priority class, admit the
                   request with the longest live radix match first (it
                   skips prefill now and pins its pages before they can be
                   evicted); equal matches keep arrival order, a deferral
                   still blocks the queue, and the class's FIFO head is
                   bypassed at most ``_bypass_limit`` admissions in a row.
    sync:          True (default) runs the lock-step loop: every ``step``
                   dispatches one engine step and waits for its results.
                   False runs the two-stage pipeline: one ticket stays in
                   flight and the previous step's harvest overlaps it
                   (``step`` then returns the responses finalized this
                   call, which lag the decode by one step until the
                   pipeline drains).  Tokens are identical either way.
    chunk_tokens:  per-step prefill token budget (0: whole prompts in one
                   admit).  Admissions and mid-prefill continuations share
                   it; greedy outputs are the same with chunking on or off.
    """

    def __init__(self, engine: GSIServingEngine, *, capacity: int,
                 continuous: bool = True, prompt_pad_len: int = 0,
                 collect_stats: bool = False, cache_aware: bool = False,
                 sync: bool = True, chunk_tokens: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if chunk_tokens < 0:
            raise ValueError("chunk_tokens must be >= 0")
        self.engine = engine
        self.capacity = capacity
        self.continuous = continuous
        self.collect_stats = collect_stats
        self.cache_aware = bool(cache_aware)
        self.sync = bool(sync)
        self._chunk = int(chunk_tokens)
        # cache-aware ordering may prefer hits over the class's FIFO head,
        # but never more than this many admissions in a row
        self._bypass_limit = 8
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
        self._ids: set = set()                       # every id submitted
        # SLO state: chunked prefill, preemption, streams
        self._prefill: Dict[int, _Prefill] = {}      # slot -> mid-prefill
        self._live_req: Dict[int, Request] = {}      # slot -> its request
        self._paused: Dict[str, Response] = {}       # preempted, unfinished
        self._streams: Dict[str, object] = {}        # id -> stream callback
        self._head_bypassed = 0
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
        scheduler's lifetime: a reused id raises, even once its request
        has finished).

        ``priority`` (larger is more urgent) orders admission across
        classes and arms preemption: a deferring higher-priority request
        pauses the lowest-priority live slot.  ``deadline_s`` is the SLO
        latency target, arrival to finish; it is accounting only
        (``Response.deadline_missed``).  ``stream`` is an optional callable
        (a :class:`TokenStream`, say) that receives one
        :class:`StreamEvent` per harvested step and a final one.
        """
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
        if stream is not None:
            self._streams[request_id] = stream
        self._seq += 1
        self.queue.append(Request(
            id=request_id, prompt=prompt, max_steps=budget,
            arrival_time=float(arrival_time),
            submitted_at=time.perf_counter(), priority=int(priority),
            deadline_s=deadline_s))
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

    def _pick_ready(self, now: float):
        """The next request to admit: ``(queue index, shared pages, hit
        tokens)``, its radix match computed once here.

        The highest priority among arrived requests wins outright, over
        FIFO order and the bypass bound.  Within that class: FIFO, or with
        ``cache_aware`` the longest live radix match, arrival order
        breaking ties, the class's FIFO head bypassed at most
        ``_bypass_limit`` admissions in a row.
        """
        tier: List[int] = []
        top = None
        for i, req in enumerate(self.queue):
            if req.arrival_time > now:
                break                  # the queue is arrival-ordered
            if top is None or req.priority > top:
                top, tier = req.priority, [i]
            elif req.priority == top:
                tier.append(i)
        if not tier:
            tier = [0]                 # the caller checked _ready(now)
        lead = tier[0]
        if not self.cache_aware or len(tier) == 1 \
                or self._head_bypassed >= self._bypass_limit:
            return (lead,) + self.engine.match_prefix(
                self.queue[lead].prompt)
        best = None
        for i in tier:
            shared, hit = self.engine.match_prefix(self.queue[i].prompt)
            if best is None or hit > best[2]:
                best = (i, shared, hit)
        return best

    def _admit_ready(self, now: float) -> List[str]:
        """Advance the mid-prefill slots, then move arrived requests from
        the queue into free slots.

        Each admission splices its longest cached prefix and prefills only
        the tail.  A request that does not fit (no free slot or pages) may
        preempt a strictly lower-priority live slot (``_try_preempt``);
        otherwise it stays queued (back-pressure, never dropped) and blocks
        the requests behind it until a later step frees room.  With
        ``chunk_tokens`` set, continuations and admissions share one
        per-step budget, and a prompt whose tail exceeds what is left is
        admitted truncated, to be completed by ``extend``.
        """
        budget = self._chunk if self._chunk else None
        budget = self._advance_prefill(budget)
        if not self.continuous and self.pool.num_live > 0:
            return []
        batch: Dict[int, Tuple[Request, np.ndarray]] = {}
        starts = np.zeros((self.capacity,), np.int32)
        live = np.ones((self.capacity,), bool)
        committed_total = 0
        while self._ready(now):
            if budget is not None and budget <= 0:
                break                  # this step's prefill budget is spent
            free = [s for s in self.pool.free_slots() if s not in batch]
            pick, shared, hit_tok = self._pick_ready(now)
            req = self.queue[pick]
            if not free or not self.engine.admit_ok(
                    req.prompt.size, req.max_steps, shared=shared):
                if self._try_preempt(req, now):
                    continue           # re-pick: a slot and pages freed
                break                  # back-pressure: defer, keep order
            if pick and req.priority == self.queue[0].priority:
                self._head_bypassed += 1
            elif not pick:
                self._head_bypassed = 0
            del self.queue[pick]
            slot = free[0]
            if self._inflight is not None and slot in self._inflight.bound:
                # a slot bound by a ticket in flight has not had its final
                # tokens materialized: admission must never reacquire it
                raise RuntimeError(
                    f"slot {slot} reacquired while its step is still in "
                    f"flight (deferred-release invariant violated)")
            self.engine.claim_slot(slot, req.prompt.size, req.max_steps,
                                   shared=shared)
            tail = req.prompt.size - hit_tok
            take = tail if budget is None else min(tail, budget)
            committed = hit_tok + take
            if committed < req.prompt.size:
                # chunked admission: only prompt[:committed] prefills now
                live[slot] = False
                self._prefill[slot] = _Prefill(req=req, committed=committed)
            if budget is not None:
                budget -= take
            committed_total += take
            batch[slot] = (req, req.prompt[:committed])
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
            self._live_req[slot] = req
            # admit() publishes exactly the committed prompt's full pages
            self._ctx[slot] = np.asarray(prompt, np.int32)
            self._pub_full[slot] = max(prompt.size - 1, 0) \
                // self.engine.page_size
            self._steps_taken[slot] = 0
            self._budget[slot] = req.max_steps
            resp = self._paused.pop(req.id, None)
            if resp is not None:
                self.stats.bump(resumes=1)   # resumed after a preemption
            else:
                resp = Response(request_id=req.id, admitted_at=now,
                                arrival_time=req.arrival_time,
                                priority=req.priority,
                                deadline_s=req.deadline_s)
            self._partial[slot] = resp
        self.state = self.engine.admit(self.state, mask, packed, starts,
                                       live=live)
        self.stats.prefill_commit_max = max(self.stats.prefill_commit_max,
                                            committed_total)
        if self.engine.pager is not None:
            self.stats.pages_evicted = self.engine.pager.evicted
        return [req.id for req, _ in batch.values()]

    def _advance_prefill(self, budget: Optional[int]) -> Optional[int]:
        """Commit the next chunk of every mid-prefill slot, in slot order,
        spending from this step's prefill ``budget``; returns what is left
        for admissions.

        A slot whose final chunk commits comes up live (it decodes from
        this engine step on, as a one-shot admit would have left it) and
        its prompt's full pages are published to the radix index.
        """
        if not self._prefill:
            return budget
        mask = np.zeros((self.capacity,), bool)
        live = np.zeros((self.capacity,), bool)
        chunks: Dict[int, np.ndarray] = {}
        total = 0
        for slot in sorted(self._prefill):
            if budget is not None and budget <= 0:
                break
            pf = self._prefill[slot]
            remaining = pf.req.prompt.size - pf.committed
            take = remaining if budget is None else min(remaining, budget)
            chunks[slot] = pf.req.prompt[pf.committed:pf.committed + take]
            mask[slot] = True
            pf.committed += take
            self._ctx[slot] = pf.req.prompt[:pf.committed].astype(np.int32)
            total += take
            if budget is not None:
                budget -= take
            if pf.committed == pf.req.prompt.size:
                live[slot] = True
        if not chunks:
            return budget
        # the longest chunk: every column costs a decode step of each model
        width = max(c.size for c in chunks.values())
        packed = np.full((self.capacity, width), PAD, np.int32)
        for slot, c in chunks.items():
            packed[slot, :c.size] = c
        self.state = self.engine.extend(self.state, mask, packed, live)
        self.stats.prefill_commit_max = max(self.stats.prefill_commit_max,
                                            total)
        for slot in np.nonzero(live)[0]:
            pf = self._prefill.pop(int(slot))
            self.engine.publish_prefix(int(slot), pf.req.prompt)
            self._pub_full[int(slot)] = \
                max(pf.req.prompt.size - 1, 0) // self.engine.page_size
        return budget

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

    def _drop_ctx(self, slot: int) -> None:
        """Forget a released or preempted slot's publication bookkeeping."""
        self._ctx.pop(slot, None)
        self._pub_full.pop(slot, None)

    # ------------------------------------------------------------------
    # Priority preemption
    # ------------------------------------------------------------------
    def _try_preempt(self, req: Request, now: float) -> bool:
        """Pause the lowest-priority live slot strictly below
        ``req.priority`` so that ``req`` can be admitted; False if there is
        no such victim.

        Victims go lowest priority first, then fewest decode steps taken
        (the least progress to replay), then lowest slot.  A mid-prefill
        slot is never a victim: its request has produced nothing and holds
        no published pages.
        """
        victim = None
        for slot in self.pool.live_slots():
            if slot in self._prefill:
                continue
            vreq = self._live_req[slot]
            if vreq.priority >= req.priority:
                continue
            key = (vreq.priority, int(self._steps_taken[slot]), slot)
            if victim is None or key < victim:
                victim = key
        if victim is None:
            return False
        self._preempt(victim[2], now)
        return True

    def _preempt(self, slot: int, now: float) -> None:
        """Pause the live request in ``slot``: publish its committed pages,
        release the slot and its pages, and requeue it for a resume.

        The committed context (prompt + every harvested step) becomes the
        resume prompt; its full pages were just published, so re-admission
        splices them back and re-prefills at most a page of tail.  The
        partial :class:`Response` waits in ``_paused`` and keeps growing on
        resume.
        """
        req = self._live_req.pop(slot)
        resp = self._partial.pop(slot)
        # pipelined: the victim's latest step may still await its deferred
        # harvest; fold its tokens in before building the context
        if self._retired is not None and slot in self._retired.bound:
            res = self._retired.res
            self._retired.bound.pop(slot)
            if not res.done_prev[slot]:
                toks = res.chosen[slot]
                self._emit_step(resp, toks[toks != PAD], now)
        context = np.concatenate([req.prompt.astype(np.int32), resp.tokens])
        mask = np.zeros((self.capacity,), bool)
        mask[slot] = True
        self.state = self.engine.force_done(self.state, mask)
        self.engine.preempt_slot(slot, context)
        self.pool.release(slot)
        self._drop_ctx(slot)
        remaining = int(self._budget[slot] - self._steps_taken[slot])
        resp.preemptions += 1
        self.stats.bump(preemptions=1)
        self._paused[req.id] = resp
        resumed = Request(
            id=req.id, prompt=context, max_steps=remaining,
            arrival_time=req.arrival_time, submitted_at=req.submitted_at,
            priority=req.priority, deadline_s=req.deadline_s)
        self.queue.appendleft(resumed)
        if len(self.queue) > 1 and \
                self.queue[1].arrival_time < resumed.arrival_time:
            self.queue = deque(sorted(self.queue,
                                      key=lambda r: r.arrival_time))

    def preempt(self, request_id: str) -> bool:
        """Pause a live request by hand (the mechanism priority admission
        uses).  False when the request cannot be paused: unknown, queued,
        mid-prefill or finished.

        Drains the pipeline first, so the request's last harvested state
        is known; the drain may even finish it (an EOS in flight), and then
        there is nothing to pause.  ``flush`` harvests a retired step
        before it retires the one in flight, so no step is lost.
        """
        if self.has_pending:
            self.flush()
        slot = self.pool.slot_of(request_id)
        if slot is None or slot in self._prefill:
            return False
        self._preempt(slot, self._now())
        return True

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
        self._live_req.pop(slot, None)
        self._drop_ctx(slot)

    def _emit_step(self, resp: Response, toks: np.ndarray,
                   now: float) -> None:
        """Append one harvested step's tokens to ``resp`` and fire its
        stream callback (streams see materialize order)."""
        resp.steps.append(toks)
        resp.engine_steps += 1
        if toks.size and resp.first_token_at is None:
            resp.first_token_at = now
        cb = self._streams.get(resp.request_id)
        if cb is not None and toks.size:
            cb(StreamEvent(request_id=resp.request_id, tokens=toks,
                           step=resp.engine_steps, t=now))

    def _finalize(self, resp: Response, reason: str, at: float) -> None:
        """Stamp a finished response, account its deadline and close its
        stream with one final event carrying the finish reason."""
        resp.finish_reason = reason
        resp.finished_at = at
        self.responses[resp.request_id] = resp
        self.stats.bump(requests_finished=1)
        if resp.deadline_missed:
            self.stats.bump(deadline_misses=1)
        cb = self._streams.pop(resp.request_id, None)
        if cb is not None:
            cb(StreamEvent(request_id=resp.request_id,
                           tokens=np.zeros((0,), np.int32),
                           step=resp.engine_steps, final=True,
                           finish_reason=reason, t=at))

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
