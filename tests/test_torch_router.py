"""The port's replica fleet against ``repro``'s on the CPU.

Twins of the reference's router tests, run on the port with the plain
kernels over the reference's own weights (numpy bridge):

* ``preamble_hash`` and ``preamble_rendezvous`` pick the reference's
  replica for random chunks and 1 to 5 replicas;
* under affinity (``mod`` and ``rendezvous``), round robin, least loaded,
  affinity with a skew guard of 0, and short prompts, every request goes to
  the reference's replica, the ``routing`` counters and each replica's
  prefix counters equal the reference's, and the tokens at temperature 0
  are the reference's;
* the threaded fleet (pipelined replicas) commits the sequential fleet's
  tokens at temperature 0, where both equal one scheduler's, and at 0.7,
  where each replica draws from its own generator in both loops;
* ``merge_engine_stats`` equals the reference's (counters, moments within
  1e-12);
* ``add_replica`` moves the reference's groups and pages under both hash
  tiers, and a moved group's next request hits on its new replica; a shared
  engine or another ``kv_dtype`` is refused;
* ``PagePool.forget`` leaves the reference's ledger after the same
  operations, and a hypothesis property (``database=None``) keeps
  ``free + referenced + cached == num_pages`` under forget among claims,
  releases and evictions;
* a failing replica thread aborts ``run`` with its cause; ``fresh_state``
  resets the fleet;
* ``serve.main(... --replicas 2 --cache-dir DIR)`` serves through the fleet
  and restores one ``cache-r{i}.npz`` per replica on a second start.
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
from repro.config import ModelConfig as JModelConfig
from repro.models import build_model
from repro.serving import EngineStats as JEngineStats
from repro.serving import GSIServingEngine as JEngine
from repro.serving import PagePool as JPagePool
from repro.serving import RadixIndex as JRadixIndex
from repro.serving import ReplicaRouter as JRouter
from repro.serving import merge_engine_stats as j_merge
from repro.serving import preamble_hash as j_hash
from repro.serving import preamble_rendezvous as j_rendezvous
from repro_torch.config import GSIConfig, ModelConfig
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import (EngineStats, GSIScheduler,
                                 GSIServingEngine, PagePool, RadixIndex,
                                 ReplicaRouter, merge_engine_stats,
                                 pages_for, preamble_hash,
                                 preamble_rendezvous)

torch.set_num_threads(1)
PS = 8
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              min_step_reward=-1.0, temperature=0.0)


def _pre(start, span):
    """17 tokens: two full pages of preamble and one spill token."""
    return np.asarray([start + (i % span) for i in range(17)], np.int32)


# four preamble groups; the fleet tests place them by their first page
PRES = [_pre(5, 24), _pre(30, 20), _pre(7, 11), _pre(40, 13)]


def _prompt(pre, tail):
    return np.concatenate([pre, np.asarray(tail, np.int32)])


@pytest.fixture(scope="module")
def triple():
    """A full-attention fp32 triple, the reference's weights and the same
    weights bridged to the port."""
    base = JModelConfig(
        name="t-rt-full", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64, head_dim=16,
        dtype="float32", param_dtype="float32")
    target = dataclasses.replace(base, name=base.name + "-t", num_layers=3)
    prm = dataclasses.replace(target, name=base.name + "-p",
                              reward_head=True)
    jcfgs = (base, target, prm)
    cfgs = [ModelConfig(**{f.name: getattr(c, f.name)
                           for f in dataclasses.fields(c)}) for c in jcfgs]
    params = [build_model(c).init(jax.random.PRNGKey(i))
              for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(c, jax.tree.map(np.asarray, p))
               for c, p in zip(cfgs, params)]
    return jcfgs, params, cfgs, tparams


def _jengine(triple, g=GREEDY, **kw):
    jcfgs, params, _, _ = triple
    return JEngine(*jcfgs, *params, JGSIConfig(**g), max_seq=96,
                   paged=True, page_size=PS, **kw)


def _engine(triple, g=GREEDY, **kw):
    _, _, cfgs, tparams = triple
    return GSIServingEngine(*cfgs, *tparams, GSIConfig(**g), max_seq=96,
                            paged=True, page_size=PS, device="cpu", **kw)


@pytest.fixture(scope="module")
def engines(triple):
    """Three reference and three port engines, reused by every fleet (a
    new router rebuilds each engine's state)."""
    return ([_jengine(triple) for _ in range(3)],
            [_engine(triple) for _ in range(3)])


def _outcome(router, ids):
    """What the fleet decided: placements, counters, per-replica prefix
    counters, each request's tokens and finish reason."""
    px = router.prefix_stats()
    keys = ("queries", "hits", "hit_tokens", "pages_reused",
            "prefill_tokens")
    return {"replica_of": [router.replica_of(r) for r in ids],
            "routing": dict(router.routing),
            "per_replica": [{k: p[k] for k in keys}
                            for p in px["per_replica"]],
            "tokens": {r: (router.responses[r].tokens.tolist(),
                           router.responses[r].finish_reason)
                       for r in ids}}


def _drive(router, waves, seed):
    """Submit each wave (prompt, budget), then drain it, in turn."""
    ids = []
    for w, wave in enumerate(waves):
        for i, (p, m) in enumerate(wave):
            ids.append(router.submit(p, request_id=f"w{w}-{i}",
                                     max_steps=m))
        router.run(jax.random.PRNGKey(seed + w) if isinstance(
            router, JRouter) else seed + w)
    return _outcome(router, ids)


# ----------------------------------------------------------------------
# Placement
# ----------------------------------------------------------------------

@pytest.mark.parametrize("replicas", [1, 2, 3, 4, 5])
def test_preamble_hashes_match_reference(replicas):
    rng = np.random.default_rng(replicas)
    for _ in range(40):
        chunk = rng.integers(0, 2 ** 31 - 1, int(rng.integers(1, 20)))
        assert preamble_hash(chunk, replicas) == j_hash(chunk, replicas)
        assert preamble_rendezvous(chunk, replicas) \
            == j_rendezvous(chunk, replicas)
    assert preamble_hash(list(range(16)), replicas) \
        == preamble_hash(np.arange(16), replicas)


# (policy, hash tier, skew, first wave, second wave): the second wave
# finds the first's published pages (tier 1); short prompts are below one
# page plus the pending token
_SHORT = [(np.asarray([9, 8, 7, 4], np.int32), 2),
          (np.asarray([11, 12, 13, 14, 15, 4], np.int32), 1)]
_WAVE1 = [(_prompt(PRES[g], [33 + i, 34, 4]), 1 + i % 3)
          for i, g in enumerate([0, 1, 2, 0, 3, 1])]
_WAVE2 = [(_prompt(PRES[g], [45 + i, 4]), 2) for i, g in enumerate(
    [1, 0, 3, 2])]
ROUTES = {
    "affinity-mod": ("affinity", "mod", None, _WAVE1, _WAVE2),
    "affinity-rendezvous": ("affinity", "rendezvous", None, _WAVE1, _WAVE2),
    "round-robin": ("round_robin", "mod", 4, _WAVE1, _WAVE2),
    "least-loaded": ("least_loaded", "mod", 4, _WAVE1, _WAVE2),
    # one hot preamble: skew 0 spreads it over both replicas
    "affinity-skew0": ("affinity", "mod", 0,
                       [(_prompt(PRES[0], [33 + i, 34, 4]), 1 + i % 2)
                        for i in range(4)] + _WAVE1, []),
    "short-prompts": ("affinity", "mod", None, _SHORT + _WAVE1[:2],
                      _SHORT),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_and_tokens_match_reference(engines, case):
    policy, tier, skew, *waves = ROUTES[case]
    waves = [w for w in waves if w]
    jengs, tengs = engines
    kw = dict(capacity=2, policy=policy, hash_tier=tier, skew=skew,
              threaded=False)
    want = _drive(JRouter(jengs[:2], **kw), waves, 7)
    got = _drive(ReplicaRouter(tengs[:2], **kw), waves, 7)
    assert got == want
    if case.startswith("affinity-") and case != "affinity-skew0":
        assert want["routing"]["affinity_matched"] > 0
        assert want["routing"]["affinity_hashed"] > 0
    if case == "affinity-skew0":
        assert want["routing"]["fallback_load"] > 0


# ----------------------------------------------------------------------
# The fleet loop
# ----------------------------------------------------------------------

def _fleet_tokens(engs, prompts, *, threaded, sync, seed=3):
    router = ReplicaRouter(engs, capacity=2, skew=None, threaded=threaded,
                           sync=sync)
    ids = [router.submit(p, request_id=f"r{i}", max_steps=m)
           for i, (p, m) in enumerate(prompts)]
    out = router.run(seed)
    return {r: out[r].tokens.tolist() for r in ids}, router


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_threaded_fleet_equals_sequential(triple, temperature):
    g = dict(GREEDY, temperature=temperature)
    engs = [_engine(triple, g) for _ in range(2)]
    prompts = _WAVE1 + _WAVE2
    seq, _ = _fleet_tokens(engs, prompts, threaded=False, sync=True)
    for _ in range(2):
        thr, router = _fleet_tokens(engs, prompts, threaded=True,
                                    sync=False)
        assert thr == seq
    assert router.pipeline_stats()["sync"] is False
    if temperature == 0.0:
        sched = GSIScheduler(engs[0], capacity=2, cache_aware=True)
        ids = [sched.submit(p, request_id=f"r{i}", max_steps=m)
               for i, (p, m) in enumerate(prompts)]
        out = sched.run(torch.Generator().manual_seed(0))
        assert {r: out[r].tokens.tolist() for r in ids} == seq


def test_failing_replica_thread_aborts_run(engines):
    _, tengs = engines
    router = ReplicaRouter(tengs[:2], capacity=1, policy="round_robin")
    boom = ValueError("replica 1 failed")

    def fail(gen):
        raise boom

    router.replicas[1].scheduler.step = fail
    for i in range(4):
        router.submit(_prompt(PRES[0], [33 + i, 4]), max_steps=1)
    done = []

    def drive():
        with pytest.raises(RuntimeError, match="aborted") as err:
            router.run(0)
        done.append(err.value.__cause__)

    t = threading.Thread(target=drive)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and done == [boom]


def test_router_fresh_state_resets_fleet(engines):
    _, tengs = engines
    router = ReplicaRouter(tengs[:2], capacity=1, skew=None,
                           collect_stats=True)
    for i in range(3):
        router.submit(_prompt(PRES[0], [33 + i, 4]), request_id=f"a{i}",
                      max_steps=1)
    router.run(1)
    assert router.prefix_stats()["hits"] > 0 and router.responses
    router.fresh_state()
    px = router.prefix_stats()
    assert px["queries"] == px["hits"] == px["pages_cached"] == 0
    assert not router.responses and router.engine_steps == 0
    assert set(router.routing.values()) == {0}
    assert all(r.routed == 0 and r._gen is None and not r.inbox
               for r in router.replicas)
    assert router.stats.steps == 0
    # the ids are free again, and a cold preamble is hashed, not matched
    router.submit(_prompt(PRES[0], [33, 4]), request_id="a0", max_steps=1)
    assert router.routing["affinity_hashed"] == 1
    router.run(2)
    assert set(router.responses) == {"a0"}


def test_cuda_streams_only_for_cuda_engines(engines):
    """Replicas on the CPU own no stream and run under no CUDA context."""
    _, tengs = engines
    router = ReplicaRouter(tengs[:2], capacity=1)
    assert all(r.stream is None for r in router.replicas)
    with router.replicas[0].context():
        pass


# ----------------------------------------------------------------------
# Stats
# ----------------------------------------------------------------------

def test_merge_engine_stats_matches_reference():
    rng = np.random.default_rng(4)
    counters = ("steps", "accepted", "decisions", "draft_tokens",
                "target_tokens", "requests_finished", "prefix_queries",
                "prefix_hits", "prefix_hit_tokens", "prefix_pages_reused",
                "prefill_tokens", "pages_evicted", "decode_pages_published",
                "preemptions", "resumes", "deadline_misses")
    names = ("tilted_rewards", "raw_rewards", "logp_ratio")
    parts, jparts = [], []
    recorded = {name: [] for name in names}
    for k in range(3):
        tp, jp = EngineStats(trace_limit=4), JEngineStats(trace_limit=4)
        for f in counters:
            v = int(rng.integers(0, 50))
            tp.bump(**{f: v})
            jp.bump(**{f: v})
        tp.prefill_commit_max = jp.prefill_commit_max = int(
            rng.integers(0, 99))
        for _ in range(k + 2):
            for name in names:
                arr = rng.normal(k, 1 + k, size=(3, 2))
                tp.record_trace(name, arr)
                jp.record_trace(name, arr)
                recorded[name].append(arr)
        parts.append(tp)
        jparts.append(jp)
    got, want = merge_engine_stats(parts), j_merge(jparts)
    for f in counters + ("prefill_commit_max", "trace_limit"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.prefill_commit_max == max(p.prefill_commit_max
                                         for p in parts)
    for name in names:
        assert got.trace_count(name) == want.trace_count(name) == 54
        assert abs(got.trace_mean(name) - want.trace_mean(name)) <= 1e-12
        assert abs(got.trace_var(name) - want.trace_var(name)) <= 1e-12
        assert len(getattr(got, name)) == len(getattr(want, name)) == 4
        # one scheduler recording every array measures the same moments
        flat = np.concatenate([np.ravel(a) for a in recorded[name]])
        assert abs(got.trace_mean(name) - flat.mean()) <= 1e-12
        assert abs(got.trace_var(name) - flat.var()) <= 1e-12
    assert merge_engine_stats([]).steps == 0
    # the parts are left untouched
    assert parts[0].trace_count("raw_rewards") == 12


# ----------------------------------------------------------------------
# Scale-out with cache migration
# ----------------------------------------------------------------------

_GROUPS = [_prompt(PRES[g], [33 + g, 34, 4]) for g in range(4)]
_NEXT = [_prompt(PRES[g], [50 + g, 4]) for g in range(4)]


def _grow(router, new_engine, seed):
    """A wave over every group, ``add_replica``, then the next request of
    every group; returns the migration, the placements and the hits."""
    for g, p in enumerate(_GROUPS):
        router.submit(p, request_id=f"g{g}", max_steps=1)
    router.run(jax.random.PRNGKey(seed) if isinstance(router, JRouter)
               else seed)
    moved = router.add_replica(new_engine)
    cached = [sorted(rep.cached_groups) for rep in router.replicas]
    for g, p in enumerate(_NEXT):
        router.submit(p, request_id=f"n{g}", max_steps=1)
    router.run(jax.random.PRNGKey(seed + 1) if isinstance(router, JRouter)
               else seed + 1)
    return moved, cached, _outcome(router, [f"g{g}" for g in range(4)]
                                   + [f"n{g}" for g in range(4)])


@pytest.mark.parametrize("tier", ["mod", "rendezvous"])
def test_add_replica_migrates_as_reference(engines, tier):
    jengs, tengs = engines
    kw = dict(capacity=2, skew=None, hash_tier=tier, threaded=False)
    want = _grow(JRouter(jengs[:2], **kw), jengs[2], 5)
    router = ReplicaRouter(tengs[:2], **kw)
    got = _grow(router, tengs[2], 5)
    assert got == want
    moved, cached, out = got
    assert moved["groups_moved"] >= 1 and moved["pages_moved"] >= 1
    # the grown fleet holds every group's pages exactly once
    assert sum(len(c) for c in cached) == len(_GROUPS)
    new = router.num_replicas - 1
    if tier == "rendezvous":
        # every moved group moved to the new replica, and its next
        # request hits there
        assert len(cached[new]) == moved["groups_moved"]
        assert out["per_replica"][new]["hits"] == moved["groups_moved"]
    assert out["routing"]["affinity_matched"] == len(_NEXT)
    assert sum(p["hits"] for p in out["per_replica"]) == len(_NEXT)


def test_add_replica_rejects_shared_engine_and_other_kv_dtype(triple,
                                                              engines):
    _, tengs = engines
    router = ReplicaRouter(tengs[:2], capacity=1)
    with pytest.raises(ValueError, match="share engine"):
        router.add_replica(tengs[0])
    with pytest.raises(ValueError, match="kv_dtype"):
        router.add_replica(_engine(triple, kv_dtype="int8"))
    with pytest.raises(ValueError, match="share engine"):
        ReplicaRouter([tengs[0], tengs[0]], capacity=1)
    with pytest.raises(ValueError, match="share engine"):
        serve.make_frontend([tengs[0], tengs[0]], capacity=1)
    assert router.num_replicas == 2


# ----------------------------------------------------------------------
# PagePool.forget
# ----------------------------------------------------------------------

def _pool_ops(pool, pages_for_, rng):
    """Claims over a small alphabet (shared radix paths), publications,
    releases and ``forget`` of whole groups, driven by ``rng``."""
    slot = 0
    for step in range(40):
        op = rng.integers(0, 4)
        if op < 2:
            toks = rng.integers(1, 3, int(rng.integers(PS, 4 * PS)))
            shared, _ = pool.match(toks[:(len(toks) - 1) // PS * PS])
            need = pages_for_(len(toks) + 1, PS) - len(shared)
            if not pool.can_claim(need, shared):
                continue
            pool.claim(slot, need, shared=shared)
            pool.ensure(slot, pages_for_(len(toks), PS))
            full = (len(toks) - 1) // PS
            if full:
                pool.publish(toks[:full * PS], pool.assigned[slot][:full])
            slot += 1
        elif op == 2 and pool.assigned:
            pool.release(sorted(pool.assigned)[int(rng.integers(
                0, len(pool.assigned)))])
        elif op == 3 and pool.index.groups():
            groups = pool.index.groups()
            chunk = groups[int(rng.integers(0, len(groups)))]
            pool.forget(pool.index.root.children[chunk].page)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_page_pool_forget_matches_reference(kv_dtype):
    from repro.serving import pages_for as j_pages_for
    tp = PagePool(12, PS, index=RadixIndex(PS), kv_dtype=kv_dtype)
    jp = JPagePool(12, PS, index=JRadixIndex(PS), kv_dtype=kv_dtype)
    _pool_ops(tp, pages_for, np.random.default_rng(3))
    _pool_ops(jp, j_pages_for, np.random.default_rng(3))
    for f in ("free", "cached", "retained", "refcount", "scale_slots",
              "assigned", "claimed", "evicted"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.num_free + tp.num_referenced + tp.num_cached == tp.num_pages


@settings(database=None, derandomize=True, deadline=None, max_examples=25)
@given(data=st.data())
def test_forget_conserves_pages(data):
    num_pages = data.draw(st.integers(3, 10), label="pages")
    kv_dtype = data.draw(st.sampled_from([None, "int8"]), label="kv")
    pool = PagePool(num_pages, PS, index=RadixIndex(PS), kv_dtype=kv_dtype)
    slot = 0
    for _ in range(data.draw(st.integers(1, 25), label="ops")):
        op = data.draw(st.sampled_from(["claim", "release", "evict",
                                        "forget"]), label="op")
        if op == "claim":
            toks = data.draw(st.lists(st.integers(1, 3), min_size=PS,
                                      max_size=PS * 4), label="prompt")
            shared, _ = pool.match(toks[:(len(toks) - 1) // PS * PS])
            need = pages_for(len(toks) + 1, PS) - len(shared)
            if not pool.can_claim(need, shared):
                continue
            pool.claim(slot, need, shared=shared)
            pool.ensure(slot, pages_for(len(toks), PS))
            full = (len(toks) - 1) // PS
            if full:
                pool.publish(toks[:full * PS], pool.assigned[slot][:full])
            slot += 1
        elif op == "release" and pool.assigned:
            pool.release(data.draw(st.sampled_from(sorted(pool.assigned)),
                                   label="slot"))
        elif op == "evict":
            pool.evict(data.draw(st.integers(1, num_pages), label="n"))
        elif op == "forget" and pool.retained:
            evicted = pool.evicted
            cached = pool.num_cached
            freed = pool.forget(data.draw(
                st.sampled_from(sorted(pool.retained)), label="page"))
            assert pool.evicted == evicted
            assert pool.num_cached == cached - freed
        free, referenced, cached = (set(pool.free), set(pool.refcount),
                                    set(pool.cached))
        assert len(pool.free) + len(referenced) + len(cached) \
            == num_pages
        assert free | referenced | cached == set(range(num_pages))
        assert cached == pool.retained - referenced
        assert set(pool.index.nodes) == pool.retained
        if pool.quantized:
            assert pool.scale_slots == referenced | cached


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------

def test_serve_cli_fleet_and_warm_restart(tmp_path, capsys):
    argv = ["--config", "toy", "--device", "cpu", "--layers", "1",
            "--paged", "--replicas", "2", "--requests", "4", "--max-steps",
            "1", "--max-step-tokens", "4", "--cache-dir", str(tmp_path)]
    serve.main(argv)
    first = capsys.readouterr().out
    assert "restored 0 snapshot(s), saved 2" in first
    assert "replica 0 (affinity)" in first and "replica 1 (affinity)" \
        in first and "finished=4/4" in first
    assert {p.name for p in tmp_path.iterdir()} == {"cache-r0.npz",
                                                    "cache-r1.npz"}
    serve.main(argv + ["--sync", "--hash-tier", "rendezvous"])
    second = capsys.readouterr().out
    assert "restored 2 snapshot(s)" in second and "finished=4/4" in second
