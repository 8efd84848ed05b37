"""The GSI three-model serving engine (Algorithm 1, end to end).

A port of ``repro.serving.gsi_engine`` for one device.  Draft pi_S, target
pi_B and the PRM run the step-level loop:

  draft phase   — n branches of the committed draft cache; sample n
                  candidate steps; score them under pi_B and the PRM
                  (``score_and_append`` on branch caches); tilted soft
                  best-of-n select + threshold (``core.gsi``).
  target phase  — on rejection: n candidate steps sampled from pi_B, PRM
                  rewards, raw-reward soft best-of-n (lines 9-12).
  commit        — append the chosen step to all three committed caches.

The same engine, re-parameterized, runs every baseline of the paper:
``gsi | gsi_norej | rsd | sbon_s | sbon_b``, on dense or paged caches,
over attention, hybrid RG-LRU or RWKV-6 stacks (a recurrent layer keeps
dense per-slot state in either layout, and cross-request prefix sharing
turns itself off unless all three stacks are attention-only, as in the
reference).
Paged pools may be stored as bf16, int8 or fp8 (``kv_dtype``; quantized
pools carry per-page scales), the draft's weights may be rounded through
int8 at load (``quantize_draft``), and ``shared_scoring`` scores the n
draft candidates under pi_B and the PRM in one pass against the shared
committed cache (``models/scoring.py``) instead of n branch caches.

**Fallback: a host-checked branch.**  The reference folds the target phase
into its jitted step under ``lax.cond(jnp.all(accept), ...)``.  Here the
host reads ``accept`` and runs ``_target_phase`` iff ``not accept.all()``
— the same predicate, over every row (done rows included) — then selects
per row with ``torch.where``.  When every row accepts, the target phase is
skipped, exactly as the reference's ``cond`` skips it.

**In-place caches.**  Caches and page pools are updated in place, never
copied per token: the reference's functional ``.at[].set`` would copy
every pool on every layer and token in eager PyTorch, which at full width
is gigabytes per step.  In place is safe for the same reasons the
reference's scatter is race-free (``repro/serving/engine.py`` module notes,
``repro/models/attention.py`` ``_write_cache_paged*``):

* branch writes land only in per-branch scratch pages (``branch_pages``
  points the write range there; ``branch_cache`` copies the partial page
  into the branch's first scratch page), or in the trash page;
* commits land only in slot-owned tail pages at ``pos`` and beyond, which
  admission guarantees lie past every spliced (shared) prefix page;
* rows that are done or never admitted resolve to the trash page, whose
  content is garbage by design and masked on every read;
* dense branches are copies (``repeat_cache``), so a branch never writes
  the committed rows.

A paged engine backs one live state at a time (its page allocator is host
state); the generation stamp ``state["gen"]`` is a plain int.

**Dispatch and materialize.**  ``dispatch_decode`` enqueues a step and
returns a :class:`StepTicket`: the outcome as device tensors, packed into
one int64 and one float32 buffer whose copies into host memory of the
ticket's own (pinned on a CUDA engine) are already queued on the step's
stream behind one recorded event.  ``materialize`` waits on that event and
unpacks the buffers into a :class:`StepResult`; it is the step's only
device-to-host transfer.  The one other host sync is the fallback check
above, which ``dispatch_decode`` passes through.  ``step_decode`` is the
two back to back, so the lock-step and the pipelined scheduler run the
same step.  At most one step is in flight: the caches are written in
place, so the next dispatch must follow the last ``materialize``.

**SLO serving and the warm cache.**  ``extend`` commits the next chunk of a
chunked prefill through the same commit path (the scheduler's
``chunk_tokens``); ``preempt_slot`` publishes a paused slot's full pages,
then releases them; ``save_cache`` / ``load_cache`` snapshot and restore the
cached radix subtrees (``serving/snapshot.py``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import GSIConfig, ModelConfig
from repro_torch.core import gsi_select, rsd_select, soft_bon_select
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.models import Model
from repro_torch.models.attention import _cache_len
from repro_torch.models.common import adtype
from repro_torch.models.scoring import score_candidates
from repro_torch.sampling import sample_steps, score_and_append
from repro_torch.serving.engine import (branch_cache, branch_pages,
                                        expand_requests, fold_candidates,
                                        paged_view, repeat_cache,
                                        reset_cache_rows, take_candidates,
                                        take_per_request)
from repro_torch.serving.pages import PagePool, RadixIndex, pages_for
from repro_torch.serving.quant import quantize_draft_params
from repro_torch.serving.slots import pack_tails

PAD = 0
MODES = ("gsi", "gsi_norej", "rsd", "sbon_s", "sbon_b")


class StepResult(NamedTuple):
    """Host-side outcome of one engine decode step (all numpy, (B,...)).

    The trailing fields (``done`` onward) serve the async pipeline:
    ``done``/``pos`` are the post-step bookkeeping a pipelined caller needs
    without touching device state, and the ``*_tokens`` / trace fields
    carry everything ``fold_step_stats`` records, so stats folding can be
    deferred off the dispatch critical path.
    """

    chosen: np.ndarray       # (B, L) committed step tokens (PAD-padded)
    done_prev: np.ndarray    # (B,) slot was already done before this step
    eos: np.ndarray          # (B,) step emitted EOS
    failed: np.ndarray       # (B,) B.2 early-stop: all draft rewards low
    accept: np.ndarray       # (B,) draft step accepted (True in sbon_b)
    done: Optional[np.ndarray] = None    # (B,) done *after* this step
    pos: Optional[np.ndarray] = None     # (B,) cache position after commit
    draft_tokens: int = 0    # non-PAD draft candidate tokens this step
    target_tokens: int = 0   # non-PAD target candidate tokens this step
    rewards: Optional[np.ndarray] = None      # (B, n) PRM rewards
    tilted: Optional[np.ndarray] = None       # (B, n) tilted rewards (gsi)
    logp_ratio: Optional[np.ndarray] = None   # (B, n) log pi_B - log pi_S


class StepTicket(NamedTuple):
    """An in-flight engine step: device tensors, no wait on the device.

    Returned by ``dispatch_decode`` once the step is enqueued; every
    outcome field is a tensor on the engine's device (or None for fields
    the engine mode does not produce).  ``host`` holds the int64 and
    float32 buffers (the float one None when no float field exists) that
    the outcome was packed into and copied to, host memory of this ticket
    alone (pinned on a CUDA engine), and ``ready`` the CUDA event recorded
    after those copies (None on the CPU).  ``materialize`` turns a ticket
    into a :class:`StepResult`; until then the host is free to run
    admission, harvest and page bookkeeping for neighbouring steps.  A
    ticket's buffers are never reused, so releasing or re-admitting the
    slots it covers cannot corrupt it, nor can a later step.
    """

    chosen: torch.Tensor             # (B, L) long
    done_prev: torch.Tensor          # (B,) bool
    eos: torch.Tensor
    failed: torch.Tensor
    accept: torch.Tensor
    done: torch.Tensor
    pos: torch.Tensor                # (B,) long
    draft_tokens: torch.Tensor       # () long
    target_tokens: torch.Tensor      # () long
    rewards: Optional[torch.Tensor]  # (B, n) float32
    tilted: Optional[torch.Tensor]
    logp_ratio: Optional[torch.Tensor]
    host: Tuple[torch.Tensor, Optional[torch.Tensor]] = ()
    ready: Optional["torch.cuda.Event"] = None


# the ticket's fields as packed into its two host buffers, in order
_INT_FIELDS = ("chosen", "done_prev", "eos", "failed", "accept", "done",
               "pos", "draft_tokens", "target_tokens")
_BOOL_FIELDS = ("done_prev", "eos", "failed", "accept", "done")
_FLOAT_FIELDS = ("rewards", "tilted", "logp_ratio")


def _to_host(buf: torch.Tensor) -> torch.Tensor:
    """Queue one copy of ``buf`` into host memory of its own: pinned, and
    ordered on the current stream, for a CUDA tensor (the caller records
    the event that marks its end); a CPU tensor is returned as it is."""
    if buf.device.type == "cpu":
        return buf
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    return host


@dataclass
class EngineStats:
    """Serving counters + bounded trace arrays for one engine/scheduler.

    ``record_trace`` keeps at most ``trace_limit`` arrays per trace while
    folding every array into exact running moments (Chan/Welford).
    Compound updates serialize on an internal lock.
    """

    steps: int = 0
    accepted: int = 0
    decisions: int = 0
    draft_tokens: int = 0
    target_tokens: int = 0
    requests_finished: int = 0
    prefix_queries: int = 0       # admissions that consulted the radix index
    prefix_hits: int = 0          # admissions with matched_len > 0
    prefix_hit_tokens: int = 0    # prompt tokens whose prefill was skipped
    prefix_pages_reused: int = 0  # cached/shared pages spliced into tables
    prefill_tokens: int = 0       # prompt tokens actually prefill-committed
    pages_evicted: int = 0        # cached pages evicted to admit (LRU)
    decode_pages_published: int = 0
    preemptions: int = 0          # live slots paused for a higher priority
    resumes: int = 0              # paused requests re-admitted
    deadline_misses: int = 0      # finished requests past their deadline_s
    prefill_commit_max: int = 0   # most prompt tokens in one admit/extend
    trace_limit: int = 512
    tilted_rewards: list = field(default_factory=list)
    raw_rewards: list = field(default_factory=list)
    logp_ratio: list = field(default_factory=list)   # log pi_B - log pi_S
    moments: dict = field(default_factory=dict)      # name -> [n, mean, M2]
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @property
    def accept_rate(self) -> float:
        """Fraction of live-slot decisions that accepted the draft step."""
        return self.accepted / max(1, self.decisions)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admissions whose prompt matched cached pages."""
        return self.prefix_hits / max(1, self.prefix_queries)

    def bump(self, **deltas: int) -> None:
        """Atomically add ``deltas`` to the named scalar counters."""
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def record_trace(self, name: str, arr) -> None:
        """Append ``arr`` to the named trace (bounded) and fold it into
        the running moments."""
        arr = np.asarray(arr)
        x = arr.astype(np.float64).ravel()
        with self._lock:
            lst = getattr(self, name)
            if len(lst) < self.trace_limit:
                lst.append(arr)
            if x.size == 0:
                return
            mean_b = float(x.mean())
            self.moments[name] = _chan(
                self.moments.get(name, _EMPTY), x.size, mean_b,
                float(((x - mean_b) ** 2).sum()))

    def trace_mean(self, name: str) -> float:
        """Exact mean of every value ever recorded into ``name``."""
        return self.moments.get(name, _EMPTY)[1]

    def trace_var(self, name: str) -> float:
        """Exact population variance of the named trace."""
        n, _, m2 = self.moments.get(name, _EMPTY)
        return m2 / n if n else 0.0

    def trace_count(self, name: str) -> int:
        """Total values folded into the named trace's moments."""
        return self.moments.get(name, _EMPTY)[0]


_EMPTY = (0, 0.0, 0.0)
# the scalar counters merge_engine_stats sums (prefill_commit_max is a max)
_COUNTERS = ("steps", "accepted", "decisions", "draft_tokens",
             "target_tokens", "requests_finished", "prefix_queries",
             "prefix_hits", "prefix_hit_tokens", "prefix_pages_reused",
             "prefill_tokens", "pages_evicted", "decode_pages_published",
             "preemptions", "resumes", "deadline_misses")


def _chan(a, n_b: int, mean_b: float, m2_b: float) -> list:
    """Chan/Welford: the moments ``a = (n, mean, M2)`` combined with
    those of ``n_b`` more values."""
    n_a, mean_a, m2_a = a
    n = n_a + n_b
    delta = mean_b - mean_a
    return [n, mean_a + delta * n_b / n,
            m2_a + m2_b + delta * delta * n_a * n_b / n]


def merge_engine_stats(parts: Sequence[EngineStats]) -> EngineStats:
    """Combine per-replica :class:`EngineStats` into one fleet view.

    Counters sum and ``prefill_commit_max`` is a max; the running moments
    merge exactly by the combine ``record_trace`` uses, so the fleet's
    ``trace_mean`` / ``trace_var`` are what one scheduler would have
    measured; the bounded trace lists concatenate up to ``trace_limit``.
    Each part is snapshotted under its own lock (replica threads may still
    be recording), and the parts are left untouched.
    """
    out = EngineStats()
    if not parts:
        return out
    out.trace_limit = parts[0].trace_limit
    for p in parts:
        with p._lock:
            for f in _COUNTERS:
                setattr(out, f, getattr(out, f) + getattr(p, f))
            out.prefill_commit_max = max(out.prefill_commit_max,
                                         p.prefill_commit_max)
            for trace in ("tilted_rewards", "raw_rewards", "logp_ratio"):
                lst = getattr(out, trace)
                lst.extend(getattr(p, trace)[:max(out.trace_limit
                                                  - len(lst), 0)])
            part_moments = {k: tuple(v) for k, v in p.moments.items()}
        for name, (n_b, mean_b, m2_b) in part_moments.items():
            if n_b:
                out.moments[name] = _chan(out.moments.get(name, _EMPTY),
                                          n_b, mean_b, m2_b)
    return out


class GSIServingEngine:
    """mode: gsi | gsi_norej | rsd | sbon_s | sbon_b.

    ``params_s/b/p`` are the port's parameter dicts (``models.param_specs``
    names: from ``models.bridge.params_from_numpy`` or
    ``models.random_params``); they are moved to ``device`` (no copy when
    already there).  ``device`` defaults to ``"cuda"`` and raises where
    CUDA is absent; tests pass ``device="cpu"``.

    ``kv_dtype`` (paged only) stores the page pools as ``None`` (the
    activation dtype), ``"bf16"``, ``"int8"`` or ``"fp8"``;
    ``quantize_draft`` rounds the draft's matmul weights through int8 at
    load; ``shared_scoring`` scores candidates against the shared cache.
    """

    def __init__(self, draft_cfg: ModelConfig, target_cfg: ModelConfig,
                 prm_cfg: ModelConfig, params_s, params_b, params_p,
                 gcfg: GSIConfig, *, mode: str = "gsi",
                 rsd_threshold: float = 0.7, max_seq: int = 512,
                 shared_scoring: bool = False, paged: bool = False,
                 page_size: int = 16, num_pages: int = 0,
                 prefix_cache: bool = True, decode_publish: bool = True,
                 kv_dtype: Optional[str] = None,
                 quantize_draft: bool = False, mesh=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if not prm_cfg.reward_head:
            raise ValueError("the PRM config needs reward_head=True")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mesh is not None:
            raise NotImplementedError("mesh is not ported yet")
        quant.validate_kv_dtype(kv_dtype)
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype requires the paged KV layout "
                             "(pass paged=True)")
        self.kv_dtype = kv_dtype
        # score candidates against ONE shared cache instead of n branch
        # caches (models/scoring.py): the same math, far less cache traffic
        self.shared_scoring = bool(shared_scoring)
        self.mode = mode
        self.gcfg = gcfg
        self.rsd_threshold = rsd_threshold
        self.max_seq = max_seq
        self.paged = paged
        self.page_size = page_size
        self.nblk = -(-max_seq // page_size)
        self.nmax = max(gcfg.n, gcfg.n_target or gcfg.n)
        # pages one candidate branch can write in one reasoning step:
        # positions pos .. pos+max_step_tokens, worst-case page phase
        self.span = (page_size - 1 + gcfg.max_step_tokens) // page_size + 1
        self._num_pages = num_pages
        self.num_pages = 0            # set when a paged state is created
        self.pager: Optional[PagePool] = None
        self._trash = 0               # trash page id (last pool row)
        self._released: set = set()   # slots whose pt rows await trash-reset
        self._gen = 0                 # live-state generation
        if quantize_draft:
            # fake-quant at load: every draft matmul sees int8-rounded
            # weights; target and PRM weights stay untouched
            params_s = quantize_draft_params(
                draft_cfg, {k: t.to(self.device) for k, t in params_s.items()})
        self.draft = Model(draft_cfg, params_s, device=self.device)
        self.target = Model(target_cfg, params_b, device=self.device)
        self.prm = Model(prm_cfg, params_p, device=self.device)
        # cross-request prefix sharing is exact only where every layer's
        # serving state lives in position-addressed pages
        self.prefix_cache = bool(prefix_cache and paged
                                 and self._prefix_supported())
        self.decode_publish = bool(decode_publish and self.prefix_cache)
        # host mirrors of per-slot pos/done, refreshed at admit and after
        # every step: page assignment reads these, not the device state
        self._known_pos = np.zeros((0,), np.int64)
        self._known_done = np.zeros((0,), bool)
        self._inflight_steps = 0      # dispatched but not yet materialized

    def _prefix_supported(self) -> bool:
        """Sharing is exact iff every layer of all three models keeps its
        serving state in the paged (position-addressed) KV pools: an RWKV
        or RG-LRU layer's state summarises the whole prefix and cannot be
        spliced, and a cross layer keeps dense per-slot cross KV."""
        return all(k in ("full", "local")
                   for m in (self.draft, self.target, self.prm)
                   for k in m.kinds)

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------
    def _fresh_caches(self, batch: int, *, pages: int = 0):
        kw = dict(pages=pages, page_size=self.page_size,
                  kv_dtype=self.kv_dtype)
        return {"S": self.draft.init_cache(batch, self.max_seq, **kw),
                "B": self.target.init_cache(batch, self.max_seq, **kw),
                "P": self.prm.init_cache(batch, self.max_seq, **kw)}

    def fresh_state(self, batch: int):
        """An all-free slot-pool state: every row is done/inert until a
        prompt is admitted into it (scheduler API)."""
        dev = self.device
        state = {
            "pending": torch.full((batch,), PAD, dtype=torch.long,
                                  device=dev),
            "pos": torch.zeros((batch,), dtype=torch.long, device=dev),
            "done": torch.ones((batch,), dtype=torch.bool, device=dev),
        }
        self._known_pos = np.zeros((batch,), np.int64)
        self._known_done = np.ones((batch,), bool)
        self._inflight_steps = 0
        if not self.paged:
            state["caches"] = self._fresh_caches(batch)
            return state
        # `num_pages` allocatable pages + a static scratch region for
        # copy-on-write branching + one trash page
        self.num_pages = self._num_pages or batch * self.nblk
        n_scratch = batch * self.nmax * self.span
        total = self.num_pages + n_scratch + 1
        index = RadixIndex(self.page_size) if self.prefix_cache else None
        # bytes-weighted LRU: one page of this kv_dtype costs its payload
        # plus its scales, so a cached int8 page outlives a bf16 one
        mem = self.cache_memory_report(batch)
        self.pager = PagePool(self.num_pages, self.page_size, index=index,
                              kv_dtype=self.kv_dtype,
                              page_bytes=mem["bytes_per_page"]
                              + mem["scale_bytes_per_page"])
        self._trash = total - 1
        self._released = set()
        scratch = (self.num_pages + np.arange(n_scratch, dtype=np.int32)
                   ).reshape(batch, self.nmax, self.span)
        state["caches"] = self._fresh_caches(batch, pages=total)
        # one extra (trash) column absorbs clamped writes at pos == max_seq;
        # unassigned entries also point at the trash page
        state["pt"] = torch.full((batch, self.nblk + 1), total - 1,
                                 dtype=torch.int32, device=dev)
        state["scratch"] = torch.as_tensor(scratch, device=dev)
        self._gen += 1
        state["gen"] = self._gen
        return state

    def init_state(self, prompts: np.ndarray):
        """prompts: (B, Lp) PAD-padded token array (the fixed-batch API).

        All-PAD rows (padding a partial batch up to capacity) start done,
        so they never decode or hold up ``run``'s all-done early exit.
        """
        prompts = np.asarray(prompts)
        B = prompts.shape[0]
        dev = self.device
        state = self.fresh_state(B)
        state["pending"] = torch.as_tensor(prompts[:, 0], dtype=torch.long,
                                           device=dev)
        done = (prompts == PAD).all(axis=1)
        state["done"] = torch.as_tensor(done, device=dev)
        lengths = (prompts != PAD).sum(axis=1)
        self._known_done = done.copy()
        if self.paged:
            for b in range(B):
                if lengths[b]:
                    self.pager.claim(b, self.blocks_needed(
                        int(lengths[b]), self.gcfg.max_steps))
            state = self._assign_pages(state, np.maximum(lengths - 1, 0))
        if prompts.shape[1] > 1:
            state = self._commit(state, torch.as_tensor(
                prompts[:, 1:], dtype=torch.long, device=dev))
        self._known_pos = np.maximum(lengths - 1, 0).astype(np.int64)
        return state

    def _check_gen(self, state):
        if state["gen"] != self._gen:
            raise RuntimeError(
                "stale paged state: fresh_state() was called on this engine "
                "after the state was created, resetting the page allocator.")

    # ------------------------------------------------------------------
    # Page accounting (host side; no-ops for the dense engine)
    # ------------------------------------------------------------------
    def positions_needed(self, prompt_len: int, budget: int) -> int:
        """Worst-case cache positions a request can touch: committed
        prompt + ``budget`` full reasoning steps."""
        return prompt_len - 1 + budget * self.gcfg.max_step_tokens

    def blocks_needed(self, prompt_len: int, budget: int) -> int:
        """Worst-case pages a request can touch (admission reservation)."""
        # +1 position: the trailing garbage-at-pos write of the last commit
        need = self.positions_needed(prompt_len, budget) + 1
        return min(self.nblk, pages_for(need, self.page_size))

    def match_prefix(self, prompt) -> Tuple[List[int], int]:
        """Radix lookup: the longest cached page-aligned prefix of
        ``prompt`` (at most ``len(prompt) - 1`` tokens: the last prompt
        token stays pending)."""
        if not self.paged or self.pager is None or not self.prefix_cache:
            return [], 0
        prompt = np.asarray(prompt).reshape(-1)
        lim = (prompt.size - 1) // self.page_size * self.page_size
        return self.pager.match(prompt[:max(lim, 0)])

    def admit_ok(self, prompt_len: int, budget: int,
                 shared: Sequence[int] = ()) -> bool:
        """Can a request be admitted now (enough free + evictable pages)?"""
        if not self.paged or self.pager is None:
            return True
        tail = self.blocks_needed(prompt_len, budget) - len(shared)
        return self.pager.can_claim(tail, shared)

    def claim_slot(self, slot: int, prompt_len: int, budget: int,
                   shared: Sequence[int] = ()) -> None:
        """Reserve the request's worst-case tail pages, splicing the
        matched ``shared`` pages in as blocks 0..len(shared)-1."""
        if self.paged:
            tail = self.blocks_needed(prompt_len, budget) - len(shared)
            self.pager.claim(slot, tail, shared=shared)

    def release_slot(self, slot: int) -> int:
        """Return a finished request's pages to the pool (no zeroing); its
        table row is re-pointed at the trash page before the next phase."""
        if self.paged and slot in self.pager.assigned:
            self._released.add(slot)
            return self.pager.release(slot)
        return 0

    def _flush_released(self, state):
        """Point released slots' table rows at the trash page (in place)."""
        if self._released:
            rows = torch.as_tensor(sorted(self._released), device=self.device)
            self._released = set()
            state["pt"][rows] = self._trash
        return state

    def cache_memory_report(self, batch: int) -> dict:
        """Device-memory accounting: dense per-slot caches vs the paged
        pool, per-step candidate-branch scratch (dense branching copies n
        whole caches; paged branching ``n * span`` pages per slot), and the
        pool's capacity at the engine's ``kv_dtype`` (page payload at the
        pool's storage dtype, per-page scales counted apart), keyed as the
        reference's report on one device.  Only attention layers count, as
        in the reference: an RWKV or RG-LRU layer's O(1) state is not
        paged."""
        g = self.gcfg
        models = (self.draft, self.target, self.prm)

        def attn_layers(model):
            return [k for k in model.kinds
                    if k not in ("rwkv", "recurrent")]

        def row_bytes(model, dtype=None):
            cfg = model.cfg
            dt = dtype or quant.pool_dtype(self.kv_dtype, adtype(cfg))
            item = torch.empty((), dtype=dt).element_size()
            return len(attn_layers(model)) * 2 * cfg.num_kv_heads \
                * cfg.head_dim * item

        def scale_bytes(model):
            if not quant.is_quantized(self.kv_dtype):
                return 0
            return len(attn_layers(model)) * 2 * model.cfg.num_kv_heads * 4

        def dense_bytes(model):
            cfg = model.cfg
            item = torch.empty((), dtype=adtype(cfg)).element_size()
            return batch * sum(2 * cfg.num_kv_heads * cfg.head_dim * item
                               * _cache_len(cfg, k, self.max_seq)
                               for k in attn_layers(model))

        branched = [self.draft, self.prm]
        if self.mode in ("gsi", "gsi_norej") and not self.shared_scoring:
            branched.append(self.target)
        page_b = sum(row_bytes(m) for m in models) * self.page_size
        scale_b = sum(scale_bytes(m) for m in models)
        fp_page_b = sum(row_bytes(m, adtype(m.cfg))
                        for m in models) * self.page_size
        num_pages = self.num_pages or batch * self.nblk
        n_scratch = batch * self.nmax * self.span
        total_pages = num_pages + n_scratch + 1
        rep = {
            "kv_dtype": self.kv_dtype or "fp",
            "page_size": self.page_size,
            "num_pages": num_pages,
            "scratch_pages": n_scratch,
            "bytes_per_page": page_b,
            "scale_bytes_per_page": scale_b,
            "fp_bytes_per_page": fp_page_b,
            "capacity_pages": num_pages,
            "capacity_tokens": num_pages * self.page_size,
            "capacity_bytes": num_pages * (page_b + scale_b),
            "dense_committed_bytes": sum(dense_bytes(m) for m in models),
            "dense_branch_bytes": g.n * sum(dense_bytes(m)
                                            for m in branched),
            "paged_pool_bytes": total_pages * (page_b + scale_b),
            "paged_branch_bytes": n_scratch * (page_b + scale_b),
        }
        rep["branch_reduction"] = (rep["dense_branch_bytes"]
                                   / max(1, rep["paged_branch_bytes"]))
        rep["devices"] = 1
        rep["bytes_per_device"] = rep["capacity_bytes"]
        rep["capacity_tokens_per_device"] = round(
            rep["capacity_tokens"] * rep["bytes_per_device"]
            / max(1, rep["capacity_bytes"]))     # 0 when no layer is paged
        if self.pager is not None:
            # distinct pages are what the device holds: a page spliced
            # into several slots' tables occupies one page
            rep["pages_assigned"] = self.pager.num_referenced
            rep["pages_slot_view"] = self.pager.num_assigned
            rep["pages_peak"] = self.pager.peak_assigned
            rep["paged_assigned_bytes"] = self.pager.num_referenced * page_b
            rep["paged_peak_bytes"] = self.pager.peak_assigned * page_b
            rep["pages_cached"] = self.pager.num_cached
            rep["pages_evicted"] = self.pager.evicted
            rep["prefix_cached_bytes"] = self.pager.num_cached * page_b
        return rep

    def _ensure_blocks(self, state, wants: dict, splice=None):
        """Assign pages so each slot covers ``wants[slot]`` table blocks and
        write the new (block -> page) entries (plus ``splice``, the
        prefix-cache splice of shared pages) into the device table."""
        rows, cols, vals = splice if splice is not None else ([], [], [])
        for slot, nb in wants.items():
            for blk, page in self.pager.ensure(slot, nb):
                rows.append(slot)
                cols.append(blk)
                vals.append(page)
        if rows:
            dev = self.device
            state["pt"][torch.as_tensor(rows, device=dev),
                        torch.as_tensor(cols, device=dev)] = torch.as_tensor(
                np.asarray(vals, np.int32), device=dev)
        return state

    def _assign_pages(self, state, ahead):
        """Lazily assign pages so every live slot's table covers the blocks
        the next step may write (up to ``pos + ahead``, ``ahead`` a scalar
        or one per slot), from the host-side ``pos``/``done`` mirrors, so
        a dispatch never waits on the device; capped at the slot's
        reservation."""
        state = self._flush_released(state)
        pos, done = self._known_pos, self._known_done
        ahead = np.broadcast_to(np.asarray(ahead), pos.shape)
        wants = {}
        for slot in list(self.pager.assigned):
            if done[slot] and self.pager.blocks_assigned(slot):
                continue          # pos is frozen; blocks already cover it
            wants[slot] = min(self.nblk, self.pager.max_blocks(slot),
                              pages_for(int(pos[slot]) + int(ahead[slot]) + 1,
                                        self.page_size))
        return self._ensure_blocks(state, wants)

    def force_done(self, state, mask) -> dict:
        """Mark ``mask`` slots done on the device and in the host mirror
        (scheduler budget exhaustion).  No-op when the mask is empty."""
        mask = np.asarray(mask, bool)
        if not mask.any():
            return state
        state = dict(state)
        state["done"] = state["done"] | torch.as_tensor(mask,
                                                        device=self.device)
        self._known_done = self._known_done | mask
        return state

    # ------------------------------------------------------------------
    # Phases
    # ------------------------------------------------------------------
    def _commit(self, state, step_tokens, row_live=None):
        """Append step_tokens (B,L) to the three committed caches."""
        caches = state["caches"]
        pt = state.get("pt")
        kw = dict(row_live=row_live, pt=pt)
        _, pos = score_and_append(self.draft, caches["S"], state["pending"],
                                  state["pos"], step_tokens, **kw)
        score_and_append(self.target, caches["B"], state["pending"],
                         state["pos"], step_tokens, **kw)
        score_and_append(self.prm, caches["P"], state["pending"],
                         state["pos"], step_tokens, **kw)
        pending = state["pending"]
        if step_tokens.shape[1]:
            length = (step_tokens != PAD).sum(dim=1)
            if row_live is not None:
                length = torch.where(row_live, length, 0)
            last = torch.gather(step_tokens, 1,
                                (length - 1).clamp(min=0)[:, None])[:, 0]
            pending = torch.where(length > 0, last, pending)
        out = dict(state)
        out.update(caches=caches, pending=pending, pos=pos)
        return out

    def _admit(self, state, admit_mask, tails, starts, live):
        """Prefill prompt *tails* (B,Lt) into the slots where ``admit_mask``
        is True; every other slot passes through untouched.  Admitted rows
        reset to the engine invariant (cache holds prompt[:-1], pending =
        prompt[-1], the matched prefix living in spliced pages below
        ``starts``) and the tail is teacher-forced through all three
        models with ``row_live`` masking."""
        for cache in state["caches"].values():
            reset_cache_rows(cache, admit_mask)
        new = dict(state)
        new.update(
            pending=torch.where(admit_mask, tails[:, 0], state["pending"]),
            pos=torch.where(admit_mask, starts, state["pos"]),
            done=torch.where(admit_mask, ~live, state["done"]))
        return self._commit(new, tails[:, 1:], row_live=admit_mask)

    def _extend(self, state, mask, chunks, live):
        """Commit continuation prefill ``chunks`` (B,W; PAD-padded) into
        the mid-prefill slots where ``mask`` is True (chunked prefill).

        The commit path teacher-forces ``pending`` + ``chunks[:, :-1]`` and
        leaves each chunk's last token pending, so after the final chunk a
        row holds what a one-shot admit leaves (cache prompt[:-1], pending
        prompt[-1], pos len-1).  ``live`` turns the rows whose final chunk
        this is to done=False; the others stay done, inert under the decode
        masks."""
        new = self._commit(state, chunks, row_live=mask)
        new["done"] = torch.where(mask, ~live, state["done"])
        return new

    def _branch(self, cache, n, state):
        """n branches of a committed cache: dense n-way copy, or paged
        copy-on-write aliasing.  Returns (cache, branch_pt)."""
        if not self.paged:
            return repeat_cache(cache, n), None
        scr = state["scratch"][:, :n]
        bpt = branch_pages(state["pt"], state["pos"], scr, self.page_size)
        return branch_cache(cache, n, state["pt"], state["pos"], scr,
                            self.page_size), bpt

    def _score_cache(self, key, state):
        """The committed cache of model ``key`` as shared scoring reads it:
        the dense rows, or the paged pools gathered (and dequantized)."""
        cache = state["caches"][key]
        return paged_view(cache, state["pt"]) if self.paged else cache

    def _draft_phase(self, state, gen):
        """Sample n draft candidates; score with target + PRM; select."""
        g = self.gcfg
        n = g.n
        pend = expand_requests(state["pending"], n)
        pos = expand_requests(state["pos"], n)
        done = expand_requests(state["done"], n)
        scratch_s, bpt = self._branch(state["caches"]["S"], n, state)
        steps = sample_steps(
            self.draft, scratch_s, pend, pos, gen,
            max_tokens=g.max_step_tokens, sep_token=g.sep_token_id,
            eos_token=g.eos_token_id, temperature=g.temperature,
            top_p=g.top_p, already_done=done, pt=bpt)
        cands = fold_candidates(steps.tokens, n)             # (B,n,L)
        if self.shared_scoring:
            # the PRM's logp is computed and discarded, as the reference's
            _, rewards = score_candidates(
                self.prm, self._score_cache("P", state), state["pending"],
                state["pos"], cands, return_rewards=True)
        else:
            scratch_p, _ = self._branch(state["caches"]["P"], n, state)
            _, _, rewards_flat = score_and_append(
                self.prm, scratch_p, pend, pos, steps.tokens,
                return_rewards=True, pt=bpt)
            rewards = fold_candidates(rewards_flat, n)
        out = {"cands": cands, "logp_S": fold_candidates(steps.logprob, n),
               "rewards": rewards}
        if self.mode in ("gsi", "gsi_norej"):
            if self.shared_scoring:
                out["logp_B"] = score_candidates(
                    self.target, self._score_cache("B", state),
                    state["pending"], state["pos"], cands)
            else:
                scratch_b, _ = self._branch(state["caches"]["B"], n, state)
                logp_B, _ = score_and_append(self.target, scratch_b, pend,
                                             pos, steps.tokens, pt=bpt)
                out["logp_B"] = fold_candidates(logp_B, n)
            dec = gsi_select(gen, rewards, out["logp_B"], out["logp_S"],
                             beta=g.beta, threshold_u=g.threshold_u)
            accept = dec.accept if (self.mode == "gsi" and g.use_rejection) \
                else torch.ones_like(dec.accept)
            out.update(index=dec.index, accept=accept,
                       selected=dec.selected_tilted, tilted=dec.tilted)
        elif self.mode == "rsd":
            dec = rsd_select(gen, rewards, beta=g.beta,
                             threshold=self.rsd_threshold)
            out.update(index=dec.index, accept=dec.accept,
                       selected=dec.selected_reward, tilted=rewards)
        else:  # sbon_s: always accept the soft-BoN choice
            idx = soft_bon_select(gen, rewards, g.beta)
            out.update(index=idx,
                       accept=torch.ones(idx.shape[0], dtype=torch.bool,
                                         device=idx.device),
                       selected=take_per_request(rewards, idx),
                       tilted=rewards)
        out["chosen"] = take_candidates(cands, out["index"])
        out["max_reward"] = rewards.max(dim=-1).values
        return out

    def _target_phase(self, state, gen):
        """Soft best-of-n with the target model (rejection fallback and
        sbon_b)."""
        g = self.gcfg
        n = g.n_target or g.n
        pend = expand_requests(state["pending"], n)
        pos = expand_requests(state["pos"], n)
        done = expand_requests(state["done"], n)
        scratch_b, bpt = self._branch(state["caches"]["B"], n, state)
        steps = sample_steps(
            self.target, scratch_b, pend, pos, gen,
            max_tokens=g.max_step_tokens, sep_token=g.sep_token_id,
            eos_token=g.eos_token_id, temperature=g.temperature,
            top_p=g.top_p, already_done=done, pt=bpt)
        scratch_p, _ = self._branch(state["caches"]["P"], n, state)
        _, _, rewards = score_and_append(self.prm, scratch_p, pend, pos,
                                         steps.tokens, return_rewards=True,
                                         pt=bpt)
        cands = fold_candidates(steps.tokens, n)
        r = fold_candidates(rewards, n)
        idx = soft_bon_select(gen, r, g.beta)
        return {"chosen": take_candidates(cands, idx), "cands": cands,
                "rewards": r, "selected": take_per_request(r, idx)}

    def _decode_core(self, state, gen, gen_target):
        """One engine step: draft phase, the host-checked fallback target
        phase (iff not every row accepted), commit, and the EOS / B.2 done
        fold.  Returns ``(new_state, StepTicket)`` with device tensors and
        no host buffers yet."""
        g = self.gcfg
        zero = torch.zeros((), dtype=torch.long, device=self.device)
        rewards = tilted = ratio = None
        if self.mode == "sbon_b":
            tp = self._target_phase(state, gen)
            chosen = tp["chosen"]
            accept = torch.ones_like(state["done"])
            max_r = tp["rewards"].max(dim=-1).values
            draft_count = zero
            target_count = (tp["cands"] != PAD).sum()
        else:
            dp = self._draft_phase(state, gen)
            accept = dp["accept"]
            max_r = dp["max_reward"]
            draft_count = (dp["cands"] != PAD).sum()
            rewards = dp["rewards"]
            if "logp_B" in dp:
                tilted = dp["tilted"]
                ratio = dp["logp_B"] - dp["logp_S"]
            if bool(accept.all()):
                chosen, target_count = dp["chosen"], zero
            else:
                tp = self._target_phase(state, gen_target)
                chosen = torch.where(accept[:, None], dp["chosen"],
                                     tp["chosen"])
                target_count = (tp["cands"] != PAD).sum()
        done_prev = state["done"]
        failed = max_r < g.min_step_reward      # paper B.2 early stop
        new_state = self._commit(state, chosen)
        eos = (chosen == g.eos_token_id).any(dim=1)
        new_done = done_prev | eos | (failed & ~done_prev)
        new_state["done"] = new_done
        ticket = StepTicket(
            chosen=chosen, done_prev=done_prev, eos=eos, failed=failed,
            accept=accept, done=new_done, pos=new_state["pos"],
            draft_tokens=draft_count, target_tokens=target_count,
            rewards=rewards, tilted=tilted, logp_ratio=ratio)
        return new_state, ticket

    def dispatch_decode(self, state, gen, gen_target=None):
        """Enqueue one engine step; returns ``(state, StepTicket)``.

        Page assignment reads the host-side position mirrors, with one
        ``max_step_tokens`` of look-ahead per dispatched, unmaterialized
        step.  The step's outcome is packed into two buffers whose copies
        into the ticket's host memory are queued behind the step, followed
        by one CUDA event; nothing is fetched.  The call does wait once:
        the host reads ``accept.all()`` to decide the fallback, so it
        returns only after the draft phase has run on the device.  Pair
        with :meth:`materialize`; ``step_decode`` is the synchronous
        composition of the two.  ``gen`` draws the draft phase's noise,
        ``gen_target`` (default ``gen``) the fallback target phase's.
        """
        if gen_target is None:
            gen_target = gen
        if self.paged:
            self._check_gen(state)
            ahead = (self._inflight_steps + 1) * self.gcfg.max_step_tokens
            state = self._assign_pages(state, ahead)
        new_state, ticket = self._decode_core(state, gen, gen_target)
        ints = torch.cat([getattr(ticket, f).reshape(-1).long()
                          for f in _INT_FIELDS])
        floats = [getattr(ticket, f).reshape(-1).float()
                  for f in _FLOAT_FIELDS if getattr(ticket, f) is not None]
        host = (_to_host(ints),
                _to_host(torch.cat(floats)) if floats else None)
        ready = None
        if ints.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._inflight_steps += 1
        return new_state, ticket._replace(host=host, ready=ready)

    def materialize(self, ticket: StepTicket) -> StepResult:
        """The host copy of a dispatched step's outcome, as a StepResult.

        Waits on the ticket's event (blocking only until the step and its
        two copies have run on the device), unpacks the ticket's own host
        buffers, and refreshes the host-side ``pos``/``done`` mirrors the
        next dispatch assigns pages from.  Stats folding is split out
        (:meth:`fold_step_stats`) so a pipelined scheduler can defer it.
        """
        if ticket.ready is not None:
            ticket.ready.synchronize()
        ints, floats = (h if h is None else h.numpy() for h in ticket.host)
        B, L = ticket.chosen.shape
        kw = {"chosen": ints[:B * L].reshape(B, L)}
        at = B * L
        for f in _BOOL_FIELDS:
            kw[f] = ints[at:at + B].astype(bool)
            at += B
        kw["pos"] = ints[at:at + B]
        kw["draft_tokens"] = int(ints[at + B])
        kw["target_tokens"] = int(ints[at + B + 1])
        at = 0
        for f in _FLOAT_FIELDS:
            t = getattr(ticket, f)
            kw[f] = None
            if t is not None:
                kw[f] = floats[at:at + t.numel()].reshape(t.shape)
                at += t.numel()
        res = StepResult(**kw)
        self._known_pos = res.pos.astype(np.int64)
        self._known_done = res.done.copy()
        self._inflight_steps = max(0, self._inflight_steps - 1)
        return res

    def fold_step_stats(self, res: StepResult, stats: EngineStats,
                        collect_stats: bool = False) -> None:
        """Fold one materialized step's outcome into ``stats``."""
        if self.mode == "sbon_b":
            stats.bump(steps=1, target_tokens=res.target_tokens)
            return
        live = ~res.done_prev
        stats.bump(steps=1, draft_tokens=res.draft_tokens,
                   target_tokens=res.target_tokens,
                   decisions=int(live.sum()),
                   accepted=int((res.accept & live).sum()))
        if collect_stats:
            stats.record_trace("raw_rewards", res.rewards)
            if res.logp_ratio is not None:
                stats.record_trace("logp_ratio", res.logp_ratio)
                stats.record_trace("tilted_rewards", res.tilted)

    def step_decode(self, state, gen, gen_target=None, *,
                    stats: Optional[EngineStats] = None,
                    collect_stats: bool = False):
        """One engine step over the whole (fixed-size) batch.

        ``gen`` (a ``torch.Generator`` on the engine's device) draws the
        draft phase's noise; ``gen_target`` (default ``gen``) the fallback
        target phase's.  Returns ``(state, StepResult)``.  This is
        ``dispatch_decode`` + ``materialize`` back to back: the lock-step
        and the pipelined scheduler run the same step.
        """
        state, ticket = self.dispatch_decode(state, gen, gen_target)
        res = self.materialize(ticket)
        if stats is not None:
            self.fold_step_stats(res, stats, collect_stats)
        return state, res

    def run(self, prompts: np.ndarray, gen, *, collect_stats: bool = True):
        """Fixed-batch run to completion: generate until EOS/max_steps.

        ``gen`` is a ``torch.Generator`` on the engine's device; every step
        draws its noise from it in order.  Returns (responses, stats);
        responses is a list of B lists of step-token arrays.  The
        continuous-batching path lives in ``serving.scheduler``.
        """
        prompts = np.asarray(prompts)
        B = prompts.shape[0]
        state = self.init_state(prompts)
        stats = EngineStats()
        responses = [[] for _ in range(B)]
        res = None
        for _ in range(self.gcfg.max_steps):
            state, res = self.step_decode(state, gen, stats=stats,
                                          collect_stats=collect_stats)
            for b in range(B):
                if not res.done_prev[b]:
                    toks = res.chosen[b]
                    responses[b].append(toks[toks != PAD])
            if res.done.all():
                break
        stats.requests_finished = 0 if res is None else int(res.done.sum())
        return responses, stats

    def admit(self, state, admit_mask: np.ndarray, prompts: np.ndarray,
              starts=None, live=None):
        """Scheduler API: prefill ``prompts`` (B,Lp) into masked slots.

        ``starts`` (B,) gives each admitted slot's prefix-cache match length
        (a multiple of ``page_size``; 0 = no match).  Matched blocks are
        spliced into the slot's table, only the tail ``prompt[start:]`` is
        prefilled, and the prompt's full committed pages are published to
        the radix index after the prefill commit is issued.
        """
        admit_mask = np.asarray(admit_mask, bool)
        prompts = np.asarray(prompts, np.int32)
        B = prompts.shape[0]
        live_np = np.ones((B,), bool) if live is None \
            else np.asarray(live, bool)
        starts_np = np.zeros((B,), np.int32) if starts is None \
            else np.asarray(starts, np.int32).copy()
        lengths = (prompts != PAD).sum(axis=1)
        publish = []
        if self.paged:
            self._check_gen(state)
            state = self._flush_released(state)
            wants = {}
            rows, cols, vals = [], [], []
            for slot in np.nonzero(admit_mask)[0]:
                slot = int(slot)
                if slot not in self.pager.assigned:
                    # direct engine use (no scheduler claim): worst case
                    starts_np[slot] = 0
                    self.claim_slot(slot, int(lengths[slot]),
                                    self.gcfg.max_steps)
                nshared = int(starts_np[slot]) // self.page_size
                for blk, page in enumerate(
                        self.pager.assigned[slot][:nshared]):
                    rows.append(slot)
                    cols.append(blk)
                    vals.append(page)
                # tail prefill writes positions start .. Lp-1
                wants[slot] = min(self.nblk,
                                  pages_for(max(int(lengths[slot]), 1),
                                            self.page_size))
                full = max(int(lengths[slot]) - 1, 0) // self.page_size
                if self.prefix_cache and full:
                    publish.append(
                        (prompts[slot, :full * self.page_size], slot, full))
            state = self._ensure_blocks(state, wants,
                                        splice=(rows, cols, vals))
        elif starts_np.any():
            raise ValueError("prefix-cache starts require a paged engine")
        tails = pack_tails(prompts, starts_np)
        dev = self.device
        out = self._admit(
            state, torch.as_tensor(admit_mask, device=dev),
            torch.as_tensor(tails, dtype=torch.long, device=dev),
            torch.as_tensor(starts_np, dtype=torch.long, device=dev),
            torch.as_tensor(live_np, device=dev))
        for tokens, slot, full in publish:
            self.pager.publish(tokens, self.pager.assigned[slot][:full])
        admitted = np.nonzero(admit_mask)[0]
        self._known_pos[admitted] = np.maximum(lengths[admitted] - 1, 0)
        self._known_done[admitted] = ~live_np[admitted]
        return out

    def extend(self, state, mask, chunks, live):
        """Scheduler API: commit continuation prefill chunks (chunked
        prefill) into mid-prefill slots.

        ``chunks`` (B,W; PAD-padded) holds each masked slot's next run of
        prompt tokens; ``live`` marks the rows whose final chunk this is
        (they come up decoding).  Pages for the chunk's positions are drawn
        lazily from the slot's admission claim, and the host ``pos``/``done``
        mirrors advance, so a pipelined dispatch keeps assigning pages
        without reading device state.  Publishing the prompt's full pages
        stays the scheduler's job (``publish_prefix`` after the final
        chunk): a page becomes matchable only once its commit is queued.
        """
        mask = np.asarray(mask, bool)
        chunks = np.asarray(chunks, np.int32)
        live_np = np.asarray(live, bool)
        lengths = (chunks != PAD).sum(axis=1)
        if self.paged:
            self._check_gen(state)
            state = self._flush_released(state)
            wants = {}
            for slot in np.nonzero(mask)[0]:
                slot = int(slot)
                # the chunk commits positions pos .. pos+len-1, plus the
                # benign garbage write at the new pos
                need = int(self._known_pos[slot]) + int(lengths[slot]) + 1
                wants[slot] = min(self.nblk, self.pager.max_blocks(slot),
                                  pages_for(need, self.page_size))
            state = self._ensure_blocks(state, wants)
        dev = self.device
        out = self._extend(
            state, torch.as_tensor(mask, device=dev),
            torch.as_tensor(chunks, dtype=torch.long, device=dev),
            torch.as_tensor(live_np, device=dev))
        sel = np.nonzero(mask)[0]
        self._known_pos[sel] = self._known_pos[sel] + lengths[sel]
        self._known_done[sel] = ~live_np[sel]
        return out

    def preempt_slot(self, slot: int, tokens) -> int:
        """Pause a live slot: publish its full committed pages (a later
        re-admission splices them back through the prefix match), then
        release its pages and claim.  Returns the pages published.

        Publication precedes the release: ``publish`` requires the caller
        to hold a reference to every page it publishes.  The caller does
        the rest: force the row done, free the scheduler slot and requeue
        ``tokens`` as the resume prompt."""
        published = self.publish_prefix(slot, tokens)
        self.release_slot(slot)
        return published

    def save_cache(self, state, path=None, *, roots=None) -> dict:
        """Snapshot the cached (reference-free) radix subtrees of ``state``:
        token chunks, LRU clocks and the cached pages' rows, scale rows
        included for quantized pools (``serving.snapshot`` format).

        Returns the host-side snapshot dict and, given ``path``, also
        writes it as one ``.npz``.  ``roots`` restricts it to the given
        first chunks; ``None`` takes everything cached.  Empty on dense
        engines or with the prefix cache off."""
        from repro_torch.serving.snapshot import save_snapshot, \
            snapshot_state
        snap = snapshot_state(self, state, roots=roots)
        if path is not None:
            save_snapshot(snap, path)
        return snap

    def load_cache(self, state, snapshot):
        """Splice a snapshot (a dict or an ``.npz`` path) into ``state``'s
        prefix cache; returns the state.

        Page ids are remapped through the pool's free list, so a restore
        never overwrites a page a live slot references; when the pool has
        fewer free pages than the snapshot has records, the coldest
        subtrees are dropped.  Conservation and the ``scale_slots``
        lockstep hold after every restore; an empty snapshot changes
        nothing."""
        from repro_torch.serving.snapshot import load_snapshot, \
            restore_state
        if isinstance(snapshot, (str, bytes)) or hasattr(snapshot,
                                                         "__fspath__"):
            snapshot = load_snapshot(snapshot)
        return restore_state(self, state, snapshot)

    def publish_prefix(self, slot: int, tokens) -> int:
        """Publish ``slot``'s full committed pages of ``tokens`` (its
        context; the last token is pending) to the radix index; returns the
        pages newly retained."""
        if not self.prefix_cache or self.pager is None \
                or slot not in self.pager.assigned:
            return 0
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        full = min(max(tokens.size - 1, 0) // self.page_size,
                   len(self.pager.assigned[slot]))
        if not full:
            return 0
        return self.pager.publish(tokens[:full * self.page_size],
                                  self.pager.assigned[slot][:full])
