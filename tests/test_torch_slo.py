"""The port's SLO serving on the CPU: chunked prefill, preemption,
deadlines, token streams and cache-aware admission.

Twins of the reference's ``tests/test_slo.py``, run on the port with the
plain kernels, over the reference's tiny triple carried across through the
numpy weight bridge:

* chunked prefill commits the one-shot admission's greedy tokens, paged
  and dense, lock-step and pipelined, at chunks of 8 and 16, and across
  full, sliding-window and RWKV-6 stacks, while ``prefill_commit_max``
  drops to the chunk;
* preempt -> resume through a radix splice gives the never-preempted
  tokens, with pages conserved; the states that cannot be preempted;
* a deferring higher-priority request pauses the lowest live slot;
  priority orders admission; deadlines are accounting only;
* streams reassemble their responses, in materialize order under the
  pipeline; duplicate ids are refused;
* ``cache_aware`` admits radix hits first, and its bypass is bounded (the
  twins of ``tests/test_router.py``'s two cases).

Then parity with the reference at temperature 0 with chunking and
preemption on (tokens, finish reasons, engine steps and the SLO and prefix
counters identical), and a hypothesis property over submit / step / flush
/ preempt on the pipelined loop.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.config import GSIConfig as JGSIConfig
from repro.models import build_model
from repro.serving import GSIScheduler as JScheduler
from repro.serving import GSIServingEngine as JEngine
from repro_torch.config import GSIConfig, ModelConfig, get_config, \
    reduced_config
from repro_torch.models import random_params
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import GSIScheduler, GSIServingEngine, TokenStream

torch.set_num_threads(1)
PRE_A = np.asarray([5 + (i % 24) for i in range(17)], np.int32)
PRE_B = np.asarray([30 + (i % 20) for i in range(17)], np.int32)
# temperature 0: a row's trajectory depends only on its committed context,
# so any scheduling of the same prompts gives the same tokens
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              min_step_reward=-1.0, temperature=0.0)
# no EOS and no early stop: a victim keeps decoding to its budget
NOSTOP = dict(GREEDY, eos_token_id=-1, min_step_reward=-1e9)


def _prompt(pre, tail):
    return np.concatenate([pre, np.asarray(tail, np.int32)])


@pytest.fixture(scope="module")
def triple(tiny_triple):
    """The reference's tiny triple and its weights, bridged to the port."""
    params = [build_model(c).init(jax.random.PRNGKey(i))
              for i, c in enumerate(tiny_triple)]
    tcfgs = [ModelConfig(**{f.name: getattr(c, f.name)
                            for f in dataclasses.fields(c)})
             for c in tiny_triple]
    tparams = [params_from_numpy(tc, jax.tree.map(np.asarray, p))
               for tc, p in zip(tcfgs, params)]
    return tiny_triple, params, tcfgs, tparams


def _engine(triple, g=GREEDY, max_seq=96, **kw):
    _, _, tcfgs, tparams = triple
    return GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g),
                            max_seq=max_seq, device="cpu", **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _serve(engine, prompts, budgets, *, sync=True, capacity=2, seed=42,
           chunk_tokens=0, cache_aware=False):
    sched = GSIScheduler(engine, capacity=capacity, sync=sync,
                         cache_aware=cache_aware, chunk_tokens=chunk_tokens)
    ids = [sched.submit(p, request_id=f"r{i}", max_steps=budgets[i])
           for i, p in enumerate(prompts)]
    out = sched.run(_gen(seed))
    return {r: out[r].tokens.tolist() for r in ids}, sched


def _conserved(pool):
    return pool.num_free + pool.num_referenced + pool.num_cached \
        == pool.num_pages


# ----------------------------------------------------------------------
# Chunked prefill == one-shot prefill (greedy identity)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_identity_paged(triple, sync, chunk):
    """Chunked admission commits the one-shot greedy tokens, and the most
    prompt tokens one admit or extend commits is bounded by the chunk."""
    prompts = [_prompt(PRE_A, [33 + i, 34, 4]) for i in range(3)] + \
              [_prompt(PRE_B, [43, 44, 4])]
    budgets = [1, 2, 2, 1]
    plain, sched_p = _serve(_engine(triple, paged=True, page_size=8),
                            prompts, budgets, sync=sync, cache_aware=True)
    chunked, sched_c = _serve(_engine(triple, paged=True, page_size=8),
                              prompts, budgets, sync=sync, cache_aware=True,
                              chunk_tokens=chunk)
    assert chunked == plain
    assert 0 < sched_c.stats.prefill_commit_max <= chunk
    assert sched_p.stats.prefill_commit_max >= max(p.size for p in prompts)
    assert sched_c.stats.prefill_commit_max \
        < sched_p.stats.prefill_commit_max
    assert _conserved(sched_c.engine.pager)


def test_chunked_prefill_identity_dense(triple):
    """Dense engines chunk through the same extend path."""
    prompts = [_prompt(PRE_A, [33 + i, 34, 4]) for i in range(3)]
    budgets = [1, 2, 1]
    plain, _ = _serve(_engine(triple), prompts, budgets)
    chunked, sched = _serve(_engine(triple), prompts, budgets,
                            chunk_tokens=8)
    assert chunked == plain
    assert sched.stats.prefill_commit_max <= 8


def _stack(pattern, window):
    """A triple with the port's own seeded weights: full,
    full + local, recurrent + full (RG-LRU decays that carry the state),
    or the reduced rwkv6-3b (decays that carry the state)."""
    if pattern == "rwkv":
        base = reduced_config(get_config("rwkv6-3b"), vocab=64)
    else:
        base = ModelConfig(
            name=f"t-slo-{'-'.join(pattern)}-{window}", family="dense",
            num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=64, head_dim=16, dtype="float32",
            param_dtype="float32", layer_pattern=pattern,
            window_size=window or 4096)
    target = dataclasses.replace(base, name=base.name + "-t", num_layers=3)
    prm = dataclasses.replace(target, name=base.name + "-p",
                              reward_head=True)
    cfgs = (base, target, prm)
    params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    gen = torch.Generator().manual_seed(100)
    for p in params:
        for name, t in p.items():
            if name.endswith(".tm.decay_base"):
                t.copy_(torch.empty(t.shape).uniform_(-6.0, -0.5,
                                                      generator=gen))
            if name.endswith(".rec.lam"):       # RG-LRU decays that carry
                t.copy_(torch.empty(t.shape).uniform_(-9.0, -4.0,
                                                      generator=gen))
    return None, None, cfgs, params


@pytest.mark.parametrize("pattern,window", [
    (("full",), 0),
    (("full", "local"), 12),
    ("rwkv", 0),
    (("recurrent", "full"), 0),
])
def test_chunked_identity_across_stacks(pattern, window):
    """Sliding windows and the RWKV and RG-LRU states advance the same
    whether the prompt arrives in one commit or in chunks."""
    stack = _stack(pattern, window)
    prompts = [_prompt(PRE_A, [33 + i, 34, 4]) for i in range(3)]
    budgets = [1, 2, 1]
    plain, _ = _serve(_engine(stack, paged=True, page_size=8), prompts,
                      budgets)
    chunked, sched = _serve(_engine(stack, paged=True, page_size=8),
                            prompts, budgets, chunk_tokens=8)
    assert chunked == plain
    assert sched.stats.prefill_commit_max <= 8


# ----------------------------------------------------------------------
# Preempt / resume
# ----------------------------------------------------------------------

def test_preempt_resume_round_trip(triple):
    """Pause -> publish the committed pages -> resume through a radix
    splice: the never-preempted tokens, pages conserved, and the resume
    admission hits the prefix cache."""
    victim = _prompt(PRE_A, [33, 34, 4])
    base, _ = _serve(_engine(triple, NOSTOP, paged=True, page_size=8),
                     [victim], [3], capacity=1, cache_aware=True)
    eng = _engine(triple, NOSTOP, paged=True, page_size=8)
    sched = GSIScheduler(eng, capacity=1, cache_aware=True)
    rid = sched.submit(victim, request_id="v", max_steps=3)
    gen = _gen(42)
    sched.step(gen)                       # one decode step, then the pause
    hits_before = sched.stats.prefix_hits
    assert sched.preempt(rid)
    assert sched.pool.slot_of(rid) is None
    assert _conserved(eng.pager)
    assert sched.queue and sched.queue[0].id == rid   # paused, not dropped
    out = sched.run(gen)
    assert out[rid].tokens.tolist() == base["r0"]
    assert out[rid].preemptions == 1
    assert sched.stats.preemptions == sched.stats.resumes == 1
    assert sched.stats.prefix_hits > hits_before
    assert _conserved(eng.pager)


def test_preempt_not_preemptible_states(triple):
    """preempt() is False for unknown, queued, mid-prefill and finished
    ids."""
    eng = _engine(triple, NOSTOP, paged=True, page_size=8)
    sched = GSIScheduler(eng, capacity=1, cache_aware=True)
    assert not sched.preempt("nope")
    a = sched.submit(_prompt(PRE_A, [33, 34, 4]), max_steps=1)
    b = sched.submit(_prompt(PRE_B, [43, 44, 4]), max_steps=1)
    assert not sched.preempt(b)           # still queued (capacity 1)
    out = sched.run(_gen(0))
    assert set(out) == {a, b}
    assert not sched.preempt(a)           # finished
    # a slot mid chunked prefill holds no published pages: not preemptible
    chunked = GSIScheduler(_engine(triple, NOSTOP, paged=True, page_size=8),
                           capacity=1, chunk_tokens=8)
    c = chunked.submit(_prompt(PRE_A, [35, 36, 4]), max_steps=1)
    chunked.step(_gen(0))
    assert c in [chunked.pool.request_of(s) for s in chunked._prefill]
    assert not chunked.preempt(c)
    assert sched.stats.preemptions == chunked.stats.preemptions == 0


@pytest.mark.parametrize("sync", [True, False])
def test_priority_preemption_pauses_lowest(triple, sync):
    """A deferring higher-priority request pauses the lowest-priority live
    slot; both finish with their uncontended greedy tokens."""
    low = _prompt(PRE_A, [33, 34, 4])
    high = _prompt(PRE_B, [43, 44, 4])
    base_low, _ = _serve(_engine(triple, NOSTOP, paged=True, page_size=8),
                         [low], [3], cache_aware=True)
    base_high, _ = _serve(_engine(triple, NOSTOP, paged=True, page_size=8),
                          [high], [2], cache_aware=True)
    eng = _engine(triple, NOSTOP, paged=True, page_size=8)
    sched = GSIScheduler(eng, capacity=1, sync=sync, cache_aware=True)
    lo = sched.submit(low, request_id="lo", max_steps=3)
    gen = _gen(42)
    sched.step(gen)                       # low holds the only slot
    hi = sched.submit(high, request_id="hi", max_steps=2, priority=1)
    out = sched.run(gen)
    assert out[lo].tokens.tolist() == base_low["r0"]
    assert out[hi].tokens.tolist() == base_high["r0"]
    assert sched.stats.preemptions >= 1
    assert sched.stats.resumes == sched.stats.preemptions
    assert out[lo].preemptions >= 1 and out[hi].preemptions == 0
    assert _conserved(eng.pager)


def test_priority_orders_admission(triple):
    """The highest arrived priority class admits first, FIFO inside it."""
    sched = GSIScheduler(_engine(triple), capacity=1)
    sched.submit([5, 6, 4], request_id="p0", max_steps=1)
    sched.submit([7, 3, 4], request_id="p2", max_steps=1, priority=2)
    sched.submit([9, 8, 4], request_id="p1", max_steps=1, priority=1)
    out = sched.run(_gen(0))
    order = sorted(out.values(), key=lambda r: r.admitted_at)
    assert [r.request_id for r in order] == ["p2", "p1", "p0"]


# ----------------------------------------------------------------------
# Deadlines
# ----------------------------------------------------------------------

def test_deadline_miss_accounting(triple):
    """A missed deadline is counted and flagged; the request still
    finishes normally."""
    sched = GSIScheduler(_engine(triple), capacity=2)
    miss = sched.submit([5, 6, 4], request_id="miss", max_steps=2,
                        deadline_s=0.0)
    make = sched.submit([7, 3, 4], request_id="make", max_steps=1,
                        deadline_s=3600.0)
    none = sched.submit([9, 8, 4], request_id="none", max_steps=1)
    out = sched.run(_gen(0))
    assert out[miss].finish_reason
    assert out[miss].deadline_missed
    assert not out[make].deadline_missed
    assert not out[none].deadline_missed
    assert sched.stats.deadline_misses == 1
    for r in out.values():
        assert r.ttft >= 0 and r.latency >= r.ttft
        assert np.isnan(r.tpot) or r.tpot >= 0


# ----------------------------------------------------------------------
# Streams
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sync", [True, False])
def test_stream_reassembles_response(triple, sync):
    """A stream reassembles its response's tokens exactly, with monotone
    steps and one trailing final event carrying the finish reason."""
    sched = GSIScheduler(_engine(triple, paged=True, page_size=8),
                         capacity=2, sync=sync, cache_aware=True)
    streams = {}
    for i in range(3):
        streams[f"r{i}"] = TokenStream()
        sched.submit(_prompt(PRE_A, [33 + i, 34, 4]), request_id=f"r{i}",
                     max_steps=2, stream=streams[f"r{i}"])
    out = sched.run(_gen(7))
    for rid, stream in streams.items():
        events = list(stream)
        assert events and events[-1].final
        assert events[-1].finish_reason == out[rid].finish_reason
        assert all(not e.final for e in events[:-1])
        steps = [e.step for e in events[:-1]]
        assert steps == sorted(steps) and len(set(steps)) == len(steps)
        got = np.concatenate([np.asarray(e.tokens, np.int32)
                              for e in events])
        assert got.tolist() == out[rid].tokens.tolist()
        assert events[0].t >= out[rid].arrival_time


def test_stream_order_matches_materialize_order_async(triple):
    """Under the pipeline a request's events fire in materialize order:
    timestamps never run backwards, one final event per request, last."""
    sched = GSIScheduler(_engine(triple, paged=True, page_size=8),
                         capacity=2, sync=False, cache_aware=True)
    seen = []

    def tap(event):
        seen.append((event.request_id, event.step, event.final, event.t))

    for i in range(4):
        sched.submit(_prompt(PRE_A, [33 + i, 34, 4]), request_id=f"r{i}",
                     max_steps=2, stream=tap)
    sched.run(_gen(7))
    times = [t for *_x, t in seen]
    assert seen and times == sorted(times)
    for rid in {s[0] for s in seen}:
        mine = [s for s in seen if s[0] == rid]
        assert [s[2] for s in mine].count(True) == 1 and mine[-1][2]
        steps = [s[1] for s in mine[:-1]]
        assert steps == sorted(steps)


# ----------------------------------------------------------------------
# Duplicate ids
# ----------------------------------------------------------------------

def test_duplicate_request_id_rejected(triple):
    """A reused id is refused: queued, live, or finished."""
    sched = GSIScheduler(_engine(triple), capacity=1)
    sched.submit([5, 6, 4], request_id="dup", max_steps=1)
    with pytest.raises(ValueError, match="duplicate request id"):
        sched.submit([7, 3, 4], request_id="dup", max_steps=1)
    assert set(sched.run(_gen(0))) == {"dup"}
    with pytest.raises(ValueError, match="duplicate request id"):
        sched.submit([9, 8, 4], request_id="dup", max_steps=1)
    assert set(sched.responses) == {"dup"}


# ----------------------------------------------------------------------
# Cache-aware admission ordering
# ----------------------------------------------------------------------

def _drain(sched, rid, gen):
    while rid not in sched.responses:
        sched.step(gen)


@pytest.mark.parametrize("cache_aware,first", [(True, "hit"),
                                               (False, "cold")])
def test_cache_aware_admission_prefers_radix_hits(triple, cache_aware,
                                                  first):
    sched = GSIScheduler(_engine(triple, paged=True, page_size=8),
                         capacity=1, cache_aware=cache_aware)
    gen = _gen(5)
    warm = sched.submit(_prompt(PRE_A, [33, 34, 4]), max_steps=1)
    _drain(sched, warm, gen)
    assert sched.engine.pager.num_cached > 0
    # the cold request (another preamble) is submitted before the hit
    sched.submit(_prompt(PRE_B, [35, 36, 4]), request_id="cold",
                 max_steps=1)
    sched.submit(_prompt(PRE_A, [37, 38, 4]), request_id="hit",
                 max_steps=1)
    done = sched.step(gen)
    # budget 1: the request admitted first also finished first
    assert [r.request_id for r in done] == [first]
    _drain(sched, "cold", gen)
    _drain(sched, "hit", gen)
    assert set(sched.responses) == {warm, "cold", "hit"}


def test_cache_aware_bypass_is_bounded(triple):
    """Fresher cache hits cannot starve a cold head-of-queue request: after
    ``_bypass_limit`` bypasses in a row the head goes through."""
    sched = GSIScheduler(_engine(triple, paged=True, page_size=8),
                         capacity=1, cache_aware=True)
    sched._bypass_limit = 2
    gen = _gen(9)
    warm = sched.submit(_prompt(PRE_A, [33, 34, 4]), max_steps=1)
    _drain(sched, warm, gen)
    sched.submit(_prompt(PRE_B, [35, 36, 4]), request_id="cold",
                 max_steps=1)
    for i in range(4):
        sched.submit(_prompt(PRE_A, [40 + i, 34, 4]),
                     request_id=f"hit{i}", max_steps=1)
    order = []
    while len(sched.responses) < 6:
        order.extend(r.request_id for r in sched.step(gen))
    assert order[:3] == ["hit0", "hit1", "cold"]


# ----------------------------------------------------------------------
# Parity with the reference at temperature 0
# ----------------------------------------------------------------------

SLO_COUNTERS = ("preemptions", "resumes", "deadline_misses",
                "prefill_commit_max", "requests_finished", "steps")


def _slo_drive(sched, prompts, step):
    """Three low-priority requests (one shares r0's preamble), two steps,
    then two priority-1 arrivals (one with a deadline it cannot meet, one
    it meets); then drain."""
    for i in range(3):
        sched.submit(prompts[i], request_id=f"r{i}", max_steps=3)
    step()
    step()
    sched.submit(prompts[3], request_id="r3", max_steps=2, priority=1,
                 deadline_s=0.0)
    sched.submit(prompts[4], request_id="r4", max_steps=2, priority=1,
                 deadline_s=3600.0)


def test_slo_matches_reference_greedy(triple):
    """The port's lock-step and pipelined schedulers against the
    reference's, paged with the prefix cache, chunks of 8, priority
    preemption and deadlines: tokens, finish reasons, engine steps, the
    SLO counters and the prefix stats identical."""
    cfgs, params, _, _ = triple
    prompts = [_prompt(PRE_A, [33, 34, 4]), _prompt(PRE_B, [43, 44, 4]),
               _prompt(PRE_A, [35, 36, 4]), _prompt(PRE_B, [45, 4]),
               np.asarray([7, 3, 9, 11, 4], np.int32)]
    kw = dict(max_seq=96, paged=True, page_size=8)
    outs = []
    je = JEngine(*cfgs, *params, JGSIConfig(**NOSTOP), **kw)
    js = JScheduler(je, capacity=2, chunk_tokens=8)
    rng = [jax.random.PRNGKey(3)]

    def jstep():
        rng[0], k = jax.random.split(rng[0])
        js.step(k)

    runs = [(js, jstep, lambda: js.run(rng[0]))]
    for sync in (True, False):
        ts = GSIScheduler(_engine(triple, NOSTOP, **kw), capacity=2,
                          chunk_tokens=8, sync=sync)
        gen = _gen(3)
        runs.append((ts, lambda s=ts, g=gen: s.step(g),
                     lambda s=ts, g=gen: s.run(g)))
    for sched, step, run in runs:
        _slo_drive(sched, prompts, step)
        out = run()
        outs.append((
            {r: (out[r].tokens.tolist(), out[r].finish_reason,
                 out[r].engine_steps, out[r].preemptions,
                 out[r].deadline_missed) for r in sorted(out)},
            sched.engine_steps, sched.prefix_stats(),
            [getattr(sched.stats, f) for f in SLO_COUNTERS]))
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    stats = dict(zip(SLO_COUNTERS, outs[0][3]))
    assert stats["preemptions"] >= 1
    assert stats["resumes"] == stats["preemptions"]
    assert stats["deadline_misses"] == 1
    assert 0 < stats["prefill_commit_max"] <= 8
    assert outs[0][2]["hits"] > 0


# ----------------------------------------------------------------------
# Page conservation and preemption count under interleaving (hypothesis)
# ----------------------------------------------------------------------

_PROP = {}


def _prop_sched():
    """One tiny paged engine and pipelined scheduler, reset per example."""
    if "sched" not in _PROP:
        draft = ModelConfig(
            name="prop-slo-d", family="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=32,
            head_dim=16, dtype="float32", param_dtype="float32")
        target = dataclasses.replace(draft, name="prop-slo-t")
        prm = dataclasses.replace(draft, name="prop-slo-p",
                                  reward_head=True)
        cfgs = (draft, target, prm)
        params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
        g = GSIConfig(n=2, max_step_tokens=4, max_steps=2, beta=4.0,
                      min_step_reward=-1.0)
        eng = GSIServingEngine(*cfgs, *params, g, max_seq=64, paged=True,
                               page_size=8, num_pages=12, device="cpu")
        _PROP["sched"] = GSIScheduler(eng, capacity=2, sync=False,
                                      prompt_pad_len=24, chunk_tokens=8)
    sched = _PROP["sched"]
    sched.fresh_state()
    return sched


@settings(database=None, derandomize=True, deadline=None, max_examples=6)
@given(data=st.data())
def test_slo_pipeline_conservation_under_interleaving(data):
    """Interleaved submit (at priority 0 or 1) / step / flush / preempt on
    the pipelined loop with chunked prefill keeps the page ledger conserved
    after every operation, never drops a paused request, counts every
    pause (manual ones among them) and drains to a complete set in which
    every pause was resumed.

    The reference's own property over the same operations
    (``tests/test_property.py::
    test_async_pipeline_page_conservation_under_interleaving``) fails at
    random: its ``flush`` retires the in-flight ticket over a retired,
    unharvested one, so a step is lost.  The port's ``flush`` harvests
    first, and this property holds it to that under preemption.
    """
    sched = _prop_sched()
    pool = sched.engine.pager
    gen = _gen(data.draw(st.integers(0, 2**31 - 1), label="seed"))
    submitted = [0]
    preempted = [0]

    def check():
        assert _conserved(pool)
        assert pool.num_in_use <= pool.num_pages

    def op_submit():
        pre = data.draw(st.sampled_from([0, 1]), label="preamble")
        tail = data.draw(st.lists(st.integers(3, 9), min_size=1,
                                  max_size=4), label="tail")
        sched.submit(np.asarray([5 + pre] * 9 + tail, np.int32),
                     request_id=f"p{submitted[0]}",
                     max_steps=data.draw(st.integers(1, 2), label="budget"),
                     priority=data.draw(st.integers(0, 1), label="priority"))
        submitted[0] += 1

    def op_preempt():
        if not submitted[0]:
            return
        which = data.draw(st.integers(0, submitted[0] - 1),
                          label="preempt_id")
        if sched.preempt(f"p{which}"):
            preempted[0] += 1

    ops = {"submit": op_submit, "step": lambda: sched.step(gen),
           "flush": sched.flush, "preempt": op_preempt}
    for _ in range(data.draw(st.integers(1, 12), label="steps")):
        ops[data.draw(st.sampled_from(sorted(ops)), label="op")]()
        check()
    for _ in range(12 * submitted[0] + 4 * preempted[0] + 4):
        if not (sched.queue or sched.pool.num_live or sched.has_pending):
            break
        sched.step(gen)
        check()
    assert len(sched.responses) == submitted[0]
    assert sched.pool.num_free == sched.capacity
    assert sched.stats.preemptions >= preempted[0]
    assert sched.stats.resumes == sched.stats.preemptions
    assert sum(r.preemptions for r in sched.responses.values()) \
        == sched.stats.preemptions
    assert sched.stats.steps == sched.engine_steps
