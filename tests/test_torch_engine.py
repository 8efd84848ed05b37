"""The port's GSI engine and scheduler against ``repro.serving``.

Both engines get the same bridged weights and prompts.  At temperature 0
the n candidates of a row are identical, so the selection noise (threefry
on one side, a torch generator on the other) cannot change a token: the
committed tokens, accept decisions and done flags must be identical and
the PRM rewards agree within 1e-5 — for all five modes on the paged layout
and for ``gsi`` on the dense one.  The decision functions and the token
sampler are checked on their own with the reference's Gumbel noise
injected.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig
from repro.core import gsi_select as j_gsi_select
from repro.core import rsd_select as j_rsd_select
from repro.models import build_model
from repro.sampling.sampler import sample_token as j_sample_token
from repro.sampling.sampler import top_p_filter as j_top_p_filter
from repro.serving import GSIScheduler as JScheduler
from repro.serving import GSIServingEngine as JEngine
from repro.serving import branch_pages as j_branch_pages
from repro_torch.config import GSIConfig as TGSIConfig
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.core import gsi_select, rsd_select
from repro_torch.models.bridge import params_from_numpy
from repro_torch.sampling import sample_token, top_p_filter
from repro_torch.serving import (GSIScheduler, GSIServingEngine, PagePool,
                                 branch_pages)

torch.set_num_threads(1)
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              temperature=0.0, threshold_u=0.3, min_step_reward=-1.0)


@pytest.fixture(scope="module")
def triple(tiny_triple):
    params = [build_model(c).init(jax.random.PRNGKey(i))
              for i, c in enumerate(tiny_triple)]
    tcfgs = [TModelConfig(**{f.name: getattr(c, f.name)
                             for f in dataclasses.fields(c)})
             for c in tiny_triple]
    tparams = [params_from_numpy(tc, jax.tree.map(np.asarray, p))
               for tc, p in zip(tcfgs, params)]
    return tiny_triple, params, tcfgs, tparams


def _prompts():
    rng = np.random.default_rng(0)
    prompts = np.zeros((3, 9), np.int32)
    for b, n in enumerate([9, 4, 6]):
        prompts[b, :n] = rng.integers(3, 64, n)
    return prompts


@pytest.mark.parametrize("mode,paged", [
    ("gsi", True), ("gsi_norej", True), ("rsd", True), ("sbon_s", True),
    ("sbon_b", True), ("gsi", False)])
def test_engine_steps_match_reference(triple, mode, paged):
    cfgs, params, tcfgs, tparams = triple
    kw = dict(mode=mode, max_seq=48, paged=paged, page_size=8)
    je = JEngine(*cfgs, *params, GSIConfig(**GREEDY), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, TGSIConfig(**GREEDY),
                          device="cpu", **kw)
    prompts = _prompts()
    mask = np.ones(len(prompts), bool)
    js = je.admit(je.fresh_state(len(prompts)), mask, prompts)
    ts = te.admit(te.fresh_state(len(prompts)), mask, prompts)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    accepts = []
    for _ in range(3):
        key, k1, k2 = jax.random.split(key, 3)
        js, jr = je.step_decode(js, k1, k2)
        ts, tr = te.step_decode(ts, gen)
        np.testing.assert_array_equal(tr.chosen, np.asarray(jr.chosen))
        np.testing.assert_array_equal(tr.accept, jr.accept)
        np.testing.assert_array_equal(tr.done, jr.done)
        np.testing.assert_array_equal(tr.pos, jr.pos)
        assert (tr.target_tokens, tr.draft_tokens) == \
            (jr.target_tokens, jr.draft_tokens)
        if jr.rewards is not None:
            np.testing.assert_allclose(tr.rewards, jr.rewards, atol=1e-5,
                                       rtol=0)
        accepts.extend(jr.accept.tolist())
    if mode == "gsi":          # both branches of the fallback are covered
        assert True in accepts and False in accepts


def test_scheduler_matches_reference(triple):
    """Sync continuous batching with the radix prefix cache: same
    per-request tokens, same prefix hits."""
    cfgs, params, tcfgs, tparams = triple
    rng = np.random.default_rng(1)
    shared = rng.integers(3, 64, 17).tolist()     # two full pages of 8
    prompts = [shared + [5, 6, 4], [7, 3, 4], shared + [9, 4],
               rng.integers(3, 64, 11).tolist(), shared + [11, 5, 4]]
    budgets = [3, 3, 2, 1, 3]
    kw = dict(max_seq=48, paged=True, page_size=8)
    je = JEngine(*cfgs, *params, GSIConfig(**GREEDY), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, TGSIConfig(**GREEDY),
                          device="cpu", **kw)
    outs = []
    for sched, gen in ((JScheduler(je, capacity=2), jax.random.PRNGKey(7)),
                       (GSIScheduler(te, capacity=2),
                        torch.Generator().manual_seed(7))):
        ids = [sched.submit(p, max_steps=m) for p, m in zip(prompts, budgets)]
        out = sched.run(gen)
        outs.append(({r: (out[r].tokens.tolist(), out[r].finish_reason)
                      for r in ids}, sched.engine_steps,
                     sched.prefix_stats()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
    assert outs[0][2] == outs[1][2]
    assert outs[1][2]["hits"] > 0
    pager = te.pager
    assert pager.num_free + pager.num_cached == te.num_pages


def test_gsi_and_rsd_select_match_with_injected_gumbel():
    rng = np.random.default_rng(2)
    r = rng.uniform(size=(5, 4)).astype(np.float32)
    lb = rng.normal(-3, 1, size=(5, 4)).astype(np.float32)
    ls = rng.normal(-3, 1, size=(5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (5, 4))))
    jd = j_gsi_select(key, jnp.asarray(r), jnp.asarray(lb), jnp.asarray(ls),
                      beta=4.0, threshold_u=0.4)
    td = gsi_select(None, torch.from_numpy(r), torch.from_numpy(lb),
                    torch.from_numpy(ls), beta=4.0, threshold_u=0.4,
                    gumbel=g)
    np.testing.assert_array_equal(td.index.numpy(), np.asarray(jd.index))
    np.testing.assert_array_equal(td.accept.numpy(), np.asarray(jd.accept))
    np.testing.assert_allclose(td.tilted.numpy(), np.asarray(jd.tilted),
                               atol=1e-6)
    jr = j_rsd_select(key, jnp.asarray(r), beta=4.0, threshold=0.5)
    tr = rsd_select(None, torch.from_numpy(r), beta=4.0, threshold=0.5,
                    gumbel=g)
    np.testing.assert_array_equal(tr.index.numpy(), np.asarray(jr.index))
    np.testing.assert_array_equal(tr.accept.numpy(), np.asarray(jr.accept))


@pytest.mark.parametrize("temperature,top_p", [(0.7, 1.0), (1.0, 0.8),
                                               (0.0, 1.0)])
def test_sample_token_matches_with_injected_gumbel(temperature, top_p):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, size=(6, 50)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (6, 50))))
    want = np.asarray(j_sample_token(key, jnp.asarray(logits), temperature,
                                     top_p))
    got = sample_token(None, torch.from_numpy(logits), temperature, top_p,
                       gumbel=g).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        top_p_filter(torch.from_numpy(logits), 0.8).numpy(),
        np.asarray(j_top_p_filter(jnp.asarray(logits), 0.8)))


def test_branch_pages_matches_reference():
    pt = np.array([[3, 4, 5, 9], [6, 7, 9, 9]], np.int32)    # 9 = trash
    pos = np.array([12, 4])
    scratch = np.arange(10, 22, dtype=np.int32).reshape(2, 2, 3)
    want = np.asarray(j_branch_pages(jnp.asarray(pt), jnp.asarray(pos),
                                     jnp.asarray(scratch), 8))
    got = branch_pages(torch.from_numpy(pt), torch.from_numpy(pos),
                       torch.from_numpy(scratch), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_page_pool_conservation_under_sharing():
    """free + referenced + cached == num_pages through claims, splices,
    publication, release and eviction."""
    from repro_torch.serving.radix import RadixIndex
    pool = PagePool(8, page_size=2, index=RadixIndex(2))
    pool.claim(0, 3)
    pages = [p for _, p in pool.ensure(0, 3)]
    pool.publish([1, 2, 3, 4, 5, 6], pages)
    shared, hit = pool.match([1, 2, 3, 4, 9])
    assert hit == 4 and shared == pages[:2]
    pool.claim(1, 2, shared=shared)
    pool.ensure(1, 4)

    def total():
        return pool.num_free + pool.num_referenced + pool.num_cached

    assert total() == 8
    pool.release(0)
    assert total() == 8 and pool.num_cached == 1      # pages[2] parks
    pool.release(1)
    assert total() == 8 and pool.num_cached == 3
    pool.claim(2, 7)                                   # forces eviction
    assert pool.evicted >= 2 and total() == 8
    quantized = PagePool(4, page_size=2, kv_dtype="int8")
    quantized.claim(0, 2)
    quantized.ensure(0, 2)
    assert quantized.scale_slots == set(quantized.refcount)
    quantized.release(0)
    assert not quantized.scale_slots and quantized.num_free == 4
