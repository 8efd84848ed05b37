"""The port's pipelined serving loop (``GSIScheduler(sync=False)``) on the CPU.

Twins of the reference's ``tests/test_async.py`` cases that need no fleet
and no SLO feature, run on the port alone:

* async == sync at temperature > 0 (the strictest check: the generator's
  draws, slot bindings and admission order must all match), dense and
  paged with the prefix cache, and across full, full+local and RWKV-6
  stacks;
* the step API drains the pipeline, deferred slot reuse, page
  backpressure, and the condition-variable idle wait in both loops;
* ``flush`` after a pipelined ``step`` loses no step (the reference's
  ``flush`` does: it retires the in-flight ticket over an unharvested one);
* a page-conservation property over interleaved submit / step / flush.

Then parity with the reference at temperature 0, through the numpy weight
bridge: the port's async scheduler against the reference's sync one, and
``GSIServingEngine.run`` against the reference's ``run`` (tokens, finish
reasons, engine steps and counters identical).
"""
import dataclasses
import threading

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
from repro_torch.serving import GSIScheduler, GSIServingEngine

torch.set_num_threads(1)
PRE_A = np.asarray([5 + (i % 24) for i in range(17)], np.int32)
PRE_B = np.asarray([30 + (i % 20) for i in range(17)], np.int32)
# temperature > 0: sampled trajectories depend on every draw and on the
# slot binding of every step
SAMPLED = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
               min_step_reward=-1.0)
GREEDY = dict(SAMPLED, temperature=0.0, threshold_u=0.3)
COUNTERS = ("steps", "accepted", "decisions", "draft_tokens",
            "target_tokens", "requests_finished")


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


def _engine(triple, g=SAMPLED, max_seq=96, **kw):
    _, _, tcfgs, tparams = triple
    return GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g),
                            max_seq=max_seq, device="cpu", **kw)


def _serve(engine, prompts, budgets, *, sync, capacity=2, seed=42):
    sched = GSIScheduler(engine, capacity=capacity, sync=sync)
    ids = [sched.submit(p, request_id=f"r{i}", max_steps=budgets[i])
           for i, p in enumerate(prompts)]
    out = sched.run(torch.Generator().manual_seed(seed))
    tokens = {r: out[r].tokens.tolist() for r in ids}
    reasons = {r: out[r].finish_reason for r in ids}
    return tokens, reasons, sched


# ----------------------------------------------------------------------
# async == sync
# ----------------------------------------------------------------------

def test_async_equals_sync_dense_sampling(triple):
    prompts = [np.asarray([5, 6, 7, 4 + i], np.int32) for i in range(6)]
    budgets = [1, 3, 2, 3, 1, 2]
    tok_s, fin_s, sched_s = _serve(_engine(triple), prompts, budgets,
                                   sync=True)
    tok_a, fin_a, sched_a = _serve(_engine(triple), prompts, budgets,
                                   sync=False)
    assert tok_a == tok_s
    assert fin_a == fin_s
    assert sched_a.engine_steps == sched_s.engine_steps
    for f in COUNTERS:
        assert getattr(sched_a.stats, f) == getattr(sched_s.stats, f), f
    assert sched_a.pipeline_stats()["overlap_host_s"] > 0
    assert sched_s.pipeline_stats()["overlap_fraction"] == 0.0
    assert sched_a.pipeline_stats()["sync"] is False


def test_async_equals_sync_paged_prefix(triple):
    """Radix lookups, page claims and decode publication ride the
    pipeline: tokens and prefix-cache counters match the sync run."""
    prompts = [_prompt(PRE_A, [33 + i, 34, 4]) for i in range(4)] + \
              [_prompt(PRE_B, [43 + i, 44, 4]) for i in range(2)]
    budgets = [1, 2, 1, 2, 1, 2]
    runs = {}
    for sync in (True, False):
        eng = _engine(triple, paged=True, page_size=8)
        runs[sync] = _serve(eng, prompts, budgets, sync=sync)
    assert runs[False][:2] == runs[True][:2]
    assert runs[False][2].prefix_stats() == runs[True][2].prefix_stats()
    assert runs[True][2].prefix_stats()["hits"] > 0
    assert runs[False][2].engine_steps == runs[True][2].engine_steps
    assert runs[False][2].pipeline_stats()["overlap_host_s"] > 0


def _stack(pattern, window):
    if pattern == "rwkv":
        base = reduced_config(get_config("rwkv6-3b"), vocab=64)
    else:
        base = ModelConfig(
            name=f"t-async-{'-'.join(pattern)}-{window}", family="dense",
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
    for p in params:              # decays that carry the recurrent state
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
def test_async_equals_sync_across_stacks(pattern, window):
    """full / sliding-window / RWKV-6 / hybrid RG-LRU stacks (RWKV and
    RG-LRU turn prefix sharing off, and their state is written in place
    under the live mask)."""
    stack = _stack(pattern, window)
    prompts = [_prompt(PRE_A, [33 + i, 34, 4]) for i in range(4)]
    budgets = [1, 2, 2, 1]
    runs = [_serve(_engine(stack, paged=True, page_size=8), prompts,
                   budgets, sync=sync) for sync in (True, False)]
    assert runs[1][:2] == runs[0][:2]
    assert runs[1][2].engine_steps == runs[0][2].engine_steps


# ----------------------------------------------------------------------
# The step API, flush, deferred release, backpressure
# ----------------------------------------------------------------------

def test_async_step_api_drains_pipeline(triple):
    """Responses lag one step while the pipeline is full, and repeated
    step() calls drain everything."""
    sched = GSIScheduler(_engine(triple), capacity=1, sync=False)
    first = sched.submit([5, 6, 4], max_steps=1)
    second = sched.submit([7, 3, 4], max_steps=1)
    gen = torch.Generator().manual_seed(0)
    finished, calls = [], 0
    for calls in range(1, 17):
        finished.extend(r.request_id for r in sched.step(gen))
        if len(finished) == 2:
            break
    assert finished == [first, second]
    assert calls == 3                     # one step of lag, then the drain
    assert not sched.has_pending
    assert sched.engine_steps == sched.stats.steps == 2


def test_flush_after_pipelined_step_loses_no_step(triple):
    """submit (budget 1), submit (budget 2), step, step, flush: the second
    step's dispatch leaves the first step retired but unharvested beside
    the in-flight one, and flush must harvest it before retiring the
    second (the reference's flush overwrites it: 1 response of 2)."""
    sched = GSIScheduler(_engine(triple, paged=True, page_size=8),
                         capacity=2, sync=False)
    sched.submit(_prompt(PRE_A, [33, 34, 4]), request_id="p0", max_steps=1)
    sched.submit(_prompt(PRE_A, [35, 34, 4]), request_id="p1", max_steps=2)
    gen = torch.Generator().manual_seed(0)
    assert sched.step(gen) == []
    assert sched.step(gen) == []
    assert sched._inflight is not None and sched._retired is not None
    got = [r.request_id for r in sched.flush()]
    for _ in range(4):
        if not (sched.queue or sched.pool.num_live or sched.has_pending):
            break
        got += [r.request_id for r in sched.step(gen)]
    assert sorted(got) == ["p0", "p1"]
    assert sorted(sched.responses) == ["p0", "p1"]
    assert sched.stats.steps == sched.engine_steps == 2
    assert [len(sched.responses[r].steps) for r in ("p0", "p1")] == [1, 2]


def test_dispatch_refuses_a_second_step_in_flight(triple):
    sched = GSIScheduler(_engine(triple), capacity=1, sync=False)
    sched.submit([5, 6, 4], max_steps=2)
    gen = torch.Generator().manual_seed(0)
    sched.step(gen)
    with pytest.raises(RuntimeError, match="in flight"):
        sched._dispatch(gen)


def test_deferred_release_slot_reuse(triple, monkeypatch):
    """A slot freed at step k is re-admitted only after step k's ticket
    was materialized, and never while its ticket is in flight."""
    eng = _engine(triple, paged=True, page_size=8)
    sched = GSIScheduler(eng, capacity=1, sync=False)
    events = []
    real_materialize, real_claim = eng.materialize, eng.claim_slot

    def spy_materialize(ticket):
        events.append(("materialize",))
        return real_materialize(ticket)

    def spy_claim(slot, *a, **kw):
        assert sched._inflight is None or \
            slot not in sched._inflight.bound, \
            "slot reacquired while its step is still in flight"
        events.append(("claim", slot))
        return real_claim(slot, *a, **kw)

    monkeypatch.setattr(eng, "materialize", spy_materialize)
    monkeypatch.setattr(eng, "claim_slot", spy_claim)
    for i in range(3):
        sched.submit(_prompt(PRE_A, [33 + i, 34, 4]), request_id=f"r{i}",
                     max_steps=1)
    out = sched.run(torch.Generator().manual_seed(5))
    assert set(out) == {"r0", "r1", "r2"}
    claims = [i for i, e in enumerate(events) if e[0] == "claim"]
    assert len(claims) == 3
    for prev, nxt in zip(claims, claims[1:]):
        assert any(e[0] == "materialize" for e in events[prev:nxt]), \
            "slot re-claimed before the freeing step's harvest"


def test_async_respects_page_backpressure(triple):
    """Requests queue under page pressure (never drop) and all finish."""
    eng = _engine(triple, paged=True, page_size=8, num_pages=8)
    sched = GSIScheduler(eng, capacity=2, sync=False)
    ids = [sched.submit(_prompt(PRE_A, [33 + i, 34, 4]),
                        request_id=f"r{i}", max_steps=2) for i in range(4)]
    out = sched.run(torch.Generator().manual_seed(11))
    assert set(out) == set(ids)
    pool = eng.pager
    assert pool.num_free + pool.num_referenced + pool.num_cached \
        == pool.num_pages


@pytest.mark.parametrize("sync", [True, False])
def test_idle_wait_is_condition_based_not_sleep_poll(triple, sync,
                                                     monkeypatch):
    """Arrival gaps are waited out on a condition variable: run() never
    calls time.sleep, and a submit from another thread wakes it."""
    import repro_torch.serving.scheduler as sched_mod

    def no_sleep(_):
        raise AssertionError("run() must not sleep-poll idle gaps")

    sched = GSIScheduler(_engine(triple), capacity=1, sync=sync)
    sched.submit([5, 6, 4], max_steps=1)
    sched.run(torch.Generator().manual_seed(0))
    monkeypatch.setattr(sched_mod.time, "sleep", no_sleep)
    sched.submit([5, 6, 4], request_id="near", max_steps=1,
                 arrival_time=0.02)

    def late_submit():
        threading.Event().wait(0.005)
        sched.submit([7, 3, 4], request_id="now", max_steps=1)

    t = threading.Thread(target=late_submit)
    t.start()
    out = sched.run(torch.Generator().manual_seed(1))
    t.join(timeout=10)
    assert not t.is_alive()
    assert {"near", "now"} <= set(out)


def test_fresh_state_resets_the_pipeline(triple):
    sched = GSIScheduler(_engine(triple, paged=True, page_size=8),
                         capacity=2, sync=False)
    prompts = [_prompt(PRE_A, [33 + i, 34, 4]) for i in range(3)]
    outs = []
    for _ in range(2):
        ids = [sched.submit(p, request_id=f"r{i}", max_steps=2)
               for i, p in enumerate(prompts)]
        out = sched.run(torch.Generator().manual_seed(3))
        outs.append(([out[r].tokens.tolist() for r in ids],
                     sched.engine_steps, sched.prefix_stats()))
        sched.fresh_state()
        assert not sched.has_pending and sched.engine_steps == 0
        assert sched.pipeline_stats()["overlap_host_s"] == 0.0
    assert outs[0] == outs[1]


# ----------------------------------------------------------------------
# Page conservation under interleaving (hypothesis)
# ----------------------------------------------------------------------

_PROP = {}


def _prop_sched():
    """One tiny paged engine and pipelined scheduler, reset per example."""
    if "sched" not in _PROP:
        draft = ModelConfig(
            name="prop-async-d", family="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=32,
            head_dim=16, dtype="float32", param_dtype="float32")
        target = dataclasses.replace(draft, name="prop-async-t")
        prm = dataclasses.replace(draft, name="prop-async-p",
                                  reward_head=True)
        cfgs = (draft, target, prm)
        params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
        g = GSIConfig(n=2, max_step_tokens=4, max_steps=2, beta=4.0,
                      min_step_reward=-1.0)
        eng = GSIServingEngine(*cfgs, *params, g, max_seq=64, paged=True,
                               page_size=8, num_pages=12, device="cpu")
        _PROP["sched"] = GSIScheduler(eng, capacity=2, sync=False,
                                      prompt_pad_len=24)
    sched = _PROP["sched"]
    sched.fresh_state()
    return sched


@settings(database=None, derandomize=True, deadline=None, max_examples=6)
@given(data=st.data())
def test_async_pipeline_page_conservation_under_interleaving(data):
    """Interleaved submit / step / flush keeps the page ledger conserved
    after every operation and drains to a complete response set, one
    step counted per engine step."""
    sched = _prop_sched()
    pool = sched.engine.pager
    gen = torch.Generator().manual_seed(
        data.draw(st.integers(0, 2**31 - 1), label="seed"))
    submitted = [0]

    def check():
        assert pool.num_free + pool.num_referenced + pool.num_cached \
            == pool.num_pages
        assert pool.num_in_use <= pool.num_pages

    def op_submit():
        pre = data.draw(st.sampled_from([0, 1]), label="preamble")
        tail = data.draw(st.lists(st.integers(3, 9), min_size=1,
                                  max_size=4), label="tail")
        sched.submit(np.asarray([5 + pre] * 9 + tail, np.int32),
                     request_id=f"p{submitted[0]}",
                     max_steps=data.draw(st.integers(1, 2), label="budget"))
        submitted[0] += 1

    ops = {"submit": op_submit, "step": lambda: sched.step(gen),
           "flush": sched.flush}
    for _ in range(data.draw(st.integers(1, 12), label="steps")):
        ops[data.draw(st.sampled_from(sorted(ops)), label="op")]()
        check()
    for _ in range(8 * submitted[0] + 4):
        if not (sched.queue or sched.pool.num_live or sched.has_pending):
            break
        sched.step(gen)
        check()
    assert len(sched.responses) == submitted[0]
    assert sched.pool.num_free == sched.capacity
    assert sched.stats.steps == sched.engine_steps


# ----------------------------------------------------------------------
# Parity with the reference at temperature 0
# ----------------------------------------------------------------------

def test_async_matches_reference_sync_greedy(triple):
    """The port's pipelined scheduler against the reference's lock-step
    one, paged with the prefix cache: same tokens, finish reasons, engine
    steps, counters and prefix stats."""
    cfgs, params, _, _ = triple
    rng = np.random.default_rng(1)
    shared = rng.integers(3, 64, 17).tolist()
    prompts = [shared + [5, 6, 4], [7, 3, 4], shared + [9, 4],
               rng.integers(3, 64, 11).tolist(), shared + [11, 5, 4]]
    budgets = [3, 3, 2, 1, 3]
    kw = dict(max_seq=48, paged=True, page_size=8)
    je = JEngine(*cfgs, *params, JGSIConfig(**GREEDY), **kw)
    te = _engine(triple, GREEDY, **kw)
    outs = []
    for sched, gen in ((JScheduler(je, capacity=2), jax.random.PRNGKey(7)),
                       (GSIScheduler(te, capacity=2, sync=False),
                        torch.Generator().manual_seed(7))):
        ids = [sched.submit(p, max_steps=m) for p, m in zip(prompts, budgets)]
        out = sched.run(gen)
        outs.append(({r: (out[r].tokens.tolist(), out[r].finish_reason,
                          out[r].engine_steps) for r in ids},
                     sched.engine_steps, sched.prefix_stats(),
                     [getattr(sched.stats, f) for f in COUNTERS]))
    assert outs[1] == outs[0]
    assert outs[1][2]["hits"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_engine_run_matches_reference(triple, paged):
    """The fixed-batch API: ``init_state`` + ``run`` (a partial batch
    padded with an all-PAD row) against the reference's."""
    cfgs, params, _, _ = triple
    prompts = np.zeros((4, 9), np.int32)
    rng = np.random.default_rng(0)
    for b, n in enumerate([9, 4, 6]):
        prompts[b, :n] = rng.integers(3, 64, n)
    kw = dict(max_seq=48, paged=paged, page_size=8)
    je = JEngine(*cfgs, *params, JGSIConfig(**GREEDY), **kw)
    te = _engine(triple, GREEDY, **kw)
    j_resp, j_stats = je.run(prompts, jax.random.PRNGKey(0))
    t_resp, t_stats = te.run(prompts, torch.Generator().manual_seed(0))
    assert [[s.tolist() for s in r] for r in t_resp] == \
        [[np.asarray(s).tolist() for s in r] for r in j_resp]
    assert t_resp[3] == []                # the all-PAD row never decodes
    for f in COUNTERS:
        assert getattr(t_stats, f) == getattr(j_stats, f), f
    np.testing.assert_allclose(t_stats.moments["raw_rewards"],
                               j_stats.moments["raw_rewards"], rtol=1e-5)
