"""The port's mixture-of-experts family against ``repro`` on the CPU.

The same numpy inputs (from a seed) or the reference's own weights, carried
across by the numpy bridge, go through ``repro.models.moe`` and
``repro_torch.models.moe`` and through the stacks built on them, in fp32.
Outputs agree within 1e-5 of their scale, and tokens at temperature 0 are
identical:

* ``moe_ffn``'s output and load-balance loss on the reduced
  ``qwen2-moe-a2.7b`` and ``kimi-k2-1t-a32b`` at three capacities: the
  reduced configs' lossless factor, the published 1.25 at a call where the
  reference's own routing drops slots (checked), and 1e-9 (at most 8 slots
  an expert); a zero router, where every real expert ties and the top-k
  must take the lower indices, as ``jax.lax.top_k`` does;
* the bridge's MoE leaves against ``param_specs`` at full width (the
  padded layout: 64 experts for qwen2-moe's 60), and no dense FFN for a
  config with experts;
* ``decode_step`` dense and paged, step after step, ``forward`` logits
  with the summed aux, ``lm_loss`` with the weighted aux, and
  ``score_candidates`` under a MoE target;
* a GSI engine whose target is the reduced qwen2-moe: steps equal to the
  reference engine's (paged, dense, shared scoring), the pipelined loop
  equal to the lock-step loop, and a chunked-prefill scheduler run equal
  to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig as JGSIConfig
from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro.models.scoring import score_candidates as j_score_candidates
from repro.serving import GSIScheduler as JScheduler
from repro.serving import GSIServingEngine as JEngine
from repro.train.trainer import lm_loss as j_lm_loss
from repro_torch.config import GSIConfig, ModelConfig
from repro_torch.models import Model, layer_slots, param_specs
from repro_torch.models import moe
from repro_torch.models.bridge import cache_to_numpy, params_from_numpy
from repro_torch.models.scoring import score_candidates
from repro_torch.serving import GSIScheduler, GSIServingEngine
from repro_torch.train.trainer import lm_loss

torch.set_num_threads(1)
RTOL = 1e-5
MOE = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
# capacity factors: None keeps the reduced config's lossless factor (its
# expert count); 1.25 is the published one; 1e-9 leaves 8 slots an expert
FACTORS = {"lossless": None, "published": 1.25, "starved": 1e-9}
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              temperature=0.0, min_step_reward=-1.0)


def to_port(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def _reduced(name, factor=None):
    cfg = jreduced_config(jget_config(name))
    if factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
    return cfg


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=RTOL * max(np.abs(want).max(), 1.0),
                               rtol=0)


def _moe_params(cfg, seed, zero_router=False):
    """Fan-in scaled normals at ``moe_specs``' shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in jmoe.moe_specs(cfg).items():
        fan_in = s.shape[-2]
        out[name] = (rng.standard_normal(s.shape)
                     / np.sqrt(fan_in)).astype(np.float32)
    if zero_router:
        out["router"][:] = 0.0
    return out


def _moe_input(cfg, B, S, seed):
    """Hidden states with a shared mean direction, as a layer's inputs
    have: it gives the router a preference, so experts load unevenly."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(cfg.d_model)
    return (rng.standard_normal((B, S, cfg.d_model)) + mean).astype(
        np.float32)


def _dropped(cfg, p, x):
    """Routed slots the reference drops: each real expert keeps at most
    ``_capacity`` of the slots its router sends it."""
    xf = jnp.asarray(x.reshape(-1, cfg.d_model))
    _, top_e, _ = jmoe._route(cfg, jnp.asarray(p["router"]), xf)
    cap = jmoe._capacity(cfg, xf.shape[0], p["router"].shape[1])
    counts = np.bincount(np.asarray(top_e).ravel(),
                         minlength=p["router"].shape[1])
    return int(np.maximum(counts - cap, 0).sum())


def _port_moe(tcfg, p, x):
    return moe.moe_ffn(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("factor", list(FACTORS))
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_reference(name, factor):
    cfg = _reduced(name, FACTORS[factor])
    tcfg = to_port(cfg)
    p = _moe_params(cfg, 1)
    x = _moe_input(cfg, 4, 32, 2)                  # T = 128 slots x k
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(cfg, p, x))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ty, taux = _port_moe(tcfg, p, x)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty.numpy(), jy)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=RTOL)
    dropped = _dropped(cfg, p, x)
    if factor == "lossless":
        assert dropped == 0
    else:                   # the reference's own routing drops here
        assert dropped > 0, (factor, dropped)


@pytest.mark.parametrize("factor", ["lossless", "published"])
def test_zero_router_ties_break_as_reference(factor):
    """Every real expert ties: each token takes experts 0 and 1, and at
    the published factor each of them keeps the first tokens in order."""
    cfg = _reduced("qwen2-moe-a2.7b", FACTORS[factor])
    tcfg = to_port(cfg)
    p = _moe_params(cfg, 3, zero_router=True)
    x = _moe_input(cfg, 2, 16, 4)
    xf = x.reshape(-1, cfg.d_model)
    jw, je, jaux = jmoe._route(cfg, jnp.asarray(p["router"]),
                               jnp.asarray(xf))
    tw, te, taux = moe._route(tcfg, torch.from_numpy(p["router"]),
                              torch.from_numpy(xf))
    k = cfg.experts_per_token
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        te.numpy(), np.broadcast_to(np.arange(k), (xf.shape[0], k)))
    _close(tw.numpy(), jw)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=RTOL)
    jy, _ = jmoe.moe_ffn(cfg, {k_: jnp.asarray(v) for k_, v in p.items()},
                         jnp.asarray(x))
    ty, _ = _port_moe(tcfg, p, x)
    _close(ty.numpy(), jy)
    assert (_dropped(cfg, p, x) > 0) == (factor == "published")


def test_capacity_matches_reference():
    full = jget_config("qwen2-moe-a2.7b")
    tfull = to_port(full)
    for T in (1, 16, 17, 100, 2048):
        assert moe._capacity(tfull, T, 64) == jmoe._capacity(full, T, 64)
    assert moe._capacity(tfull, 16, 64) == 8
    assert moe._capacity(tfull, 2048, 64) == 176
    assert moe.padded_experts(tfull) == jmoe.padded_experts(full) == 64


# ----------------------------------------------------------------------
# specs and the bridge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_param_specs_match_reference_tree_at_full_width(name):
    """The port's flat specs against the reference's parameter tree
    (shapes only, never materialized), layer by layer; no dense FFN."""
    cfg = jget_config(name)
    tcfg = to_port(cfg)
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    specs = param_specs(tcfg)
    want = {f"embed.{k}": v.shape for k, v in shapes["embed"].items()}
    want["final_ln"] = shapes["final_ln"].shape
    for i, (_, group, key, index) in enumerate(layer_slots(tcfg)):
        blk = shapes[group][key]
        for sub, node in blk.items():
            leaves = node.items() if isinstance(node, dict) else [(None,
                                                                    node)]
            for leaf, v in leaves:
                nm = sub if leaf is None else f"{sub}.{leaf}"
                want[f"layers.{i}.{nm}"] = tuple(
                    v.shape if index is None else v.shape[1:])
    assert {k: s.shape for k, s in specs.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert not any(k.endswith(("ffn.wi_gate", "ffn.wi_up", "ffn.wo"))
                   for k in specs)
    e = jmoe.padded_experts(cfg)
    d, ff = cfg.d_model, cfg.moe_d_ff
    assert specs["layers.0.ffn.router"].shape == (d, e)
    assert specs["layers.0.ffn.we_down"].shape == (e, ff, d)
    if name == "qwen2-moe-a2.7b":
        assert e == 64
        n = sum(int(np.prod(s.shape)) for s in specs.values())
        assert n == 14_835_353_600          # as laid out, 64 experts
        assert tcfg.param_count() == cfg.param_count() == 14_004_322_304


def test_bridge_carries_moe_leaves():
    cfg = _reduced("qwen2-moe-a2.7b")
    tcfg = to_port(cfg)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(tcfg, tree)
    specs = param_specs(tcfg)
    assert set(tparams) == set(specs)
    for k, s in specs.items():
        assert tuple(tparams[k].shape) == s.shape, k
    assert sum(t.numel() for t in tparams.values()) == \
        sum(a.size for a in jax.tree.leaves(tree))
    for leaf in ("router", "we_gate", "we_up", "we_down", "shared_gate",
                 "shared_up", "shared_down"):
        np.testing.assert_array_equal(
            tparams[f"layers.1.ffn.{leaf}"].numpy(),
            tree["blocks"]["p0"]["ffn"][leaf][1])
    model = Model(tcfg, tparams)
    assert set(model.layers[0]["ffn"]) == set(jmoe.moe_specs(cfg))


# ----------------------------------------------------------------------
# the stack
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_stack():
    cfg = _reduced("qwen2-moe-a2.7b")
    params = build_model(cfg).init(jax.random.PRNGKey(1))
    tcfg = to_port(cfg)
    model = Model(tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    return cfg, params, tcfg, model


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_matches_reference(moe_stack, paged):
    cfg, params, tcfg, model = moe_stack
    jm = build_model(cfg)
    jstep = jax.jit(jm.decode_step)
    B, S, ps = 3, 16, 4
    rng = np.random.default_rng(5)
    pos = np.array([0, 3, 7])
    if paged:
        nblk = S // ps
        P = B * nblk + 1
        pt = np.random.default_rng(6).permutation(P)[:B * nblk].reshape(
            B, nblk).astype(np.int32)
        jc = jm.init_cache(B, S, pages=P, page_size=ps)
        tc = model.init_cache(B, S, pages=P, page_size=ps)
        jpt, tpt = jnp.asarray(pt), torch.from_numpy(pt)
    else:
        jc, tc = jm.init_cache(B, S), model.init_cache(B, S)
        jpt = tpt = None
    for _ in range(6):
        tok = rng.integers(3, cfg.vocab_size, size=(B, 1))
        lj, jc = jstep(params, jc, jnp.asarray(tok), jnp.asarray(pos),
                       pt=jpt)
        lt = model.decode_step(tc, torch.from_numpy(tok),
                               torch.from_numpy(pos), pt=tpt)
        _close(lt.numpy()[:, :cfg.vocab_size],
               np.asarray(lj)[:, :cfg.vocab_size])
        pos = pos + 1
    got = cache_to_numpy(tcfg, tc)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,factor", [
    ("qwen2-moe-a2.7b", "lossless"), ("qwen2-moe-a2.7b", "published"),
    ("kimi-k2-1t-a32b", "lossless")])
def test_forward_logits_and_aux_match_reference(name, factor):
    cfg = _reduced(name, FACTORS[factor])
    tcfg = to_port(cfg)
    jm = build_model(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2))
    model = Model(tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    toks = np.random.default_rng(7).integers(3, cfg.vocab_size, (4, 24))
    jl, jaux = jax.jit(jm.forward)(params, jnp.asarray(toks))
    tl, taux = model.forward(torch.from_numpy(toks))
    V = cfg.vocab_size
    _close(tl[..., :V].numpy(), np.asarray(jl)[..., :V])
    assert isinstance(taux, torch.Tensor) and taux.dtype == torch.float32
    assert float(jaux) > 0
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=RTOL)


def test_lm_loss_adds_the_weighted_aux(moe_stack):
    cfg, params, tcfg, model = moe_stack
    rng = np.random.default_rng(8)
    toks = rng.integers(3, cfg.vocab_size, (3, 20)).astype(np.int32)
    mask = (rng.random((3, 20)) < 0.7).astype(np.float32)
    jtotal, jm = j_lm_loss(build_model(cfg), params,
                           {"tokens": jnp.asarray(toks),
                            "loss_mask": jnp.asarray(mask)})
    ttotal, tm = lm_loss(model, {"tokens": torch.from_numpy(toks),
                                 "loss_mask": torch.from_numpy(mask)})
    for got, want in ((ttotal, jtotal), (tm["loss"], jm["loss"]),
                      (tm["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(
        float(ttotal - tm["loss"]),
        cfg.router_aux_weight * float(tm["aux_loss"]), rtol=1e-4)
    assert float(tm["aux_loss"]) > 0


def test_score_candidates_under_moe_target(moe_stack):
    """All B * n * (L + 1) feeds of a layer share one MoE call."""
    cfg, params, tcfg, model = moe_stack
    jm = build_model(cfg)
    rng = np.random.default_rng(9)
    B, n, L = 2, 3, 5
    prefix = rng.integers(3, cfg.vocab_size, (B, 10)).astype(np.int32)
    _, jcache = jax.jit(lambda p, x: jm.prefill(p, x, max_seq=24))(
        params, jnp.asarray(prefix[:, :-1]))
    layers = []
    for _, group, key, index in layer_slots(tcfg):
        leaf = jcache[group][key]
        layers.append({k: torch.from_numpy(np.array(
            v if index is None else v[index])) for k, v in leaf.items()})
    pend = prefix[:, -1]
    pos = np.full((B,), 9, np.int32)
    cand = rng.integers(3, cfg.vocab_size, (B, n, L)).astype(np.int32)
    cand[0, 1, 3:] = 0
    want = jax.jit(lambda *a: j_score_candidates(jm, *a))(
        params, jcache, jnp.asarray(pend), jnp.asarray(pos),
        jnp.asarray(cand))
    got = score_candidates(model, layers, torch.from_numpy(pend).long(),
                           torch.from_numpy(pos).long(),
                           torch.from_numpy(cand).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RTOL,
                               rtol=1e-6)


# ----------------------------------------------------------------------
# serving with a MoE target
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_triple():
    """Reduced Qwen2.5-Math draft and PRM around the reduced qwen2-moe
    target (every vocabulary 512), with the reference's weights."""
    cfgs = (jreduced_config(jget_config("qwen2.5-math-1.5b")),
            _reduced("qwen2-moe-a2.7b"),
            jreduced_config(jget_config("qwen2.5-math-prm-7b")))
    params = [jax.jit(build_model(c).init)(jax.random.PRNGKey(10 + i))
              for i, c in enumerate(cfgs)]
    tcfgs = [to_port(c) for c in cfgs]
    tparams = [params_from_numpy(tc, jax.tree.map(np.asarray, p))
               for tc, p in zip(tcfgs, params)]
    return cfgs, params, tcfgs, tparams


def _prompts():
    rng = np.random.default_rng(11)
    prompts = np.zeros((3, 9), np.int32)
    for b, n in enumerate([9, 4, 6]):
        prompts[b, :n] = rng.integers(3, 512, n)
    return prompts


def _threshold(moe_triple, tcfgs=None, **kw):
    """A threshold between two rows' first-step tilted rewards, so the
    engine runs accept and fallback alike (from the port's first step)."""
    _, _, cfgs, tparams = moe_triple
    te = GSIServingEngine(*(tcfgs or cfgs), *tparams, GSIConfig(**GREEDY),
                          device="cpu", max_seq=48, paged=True, page_size=8,
                          **kw)
    prompts = _prompts()
    st = te.admit(te.fresh_state(3), np.ones(3, bool), prompts)
    _, res = te.step_decode(st, torch.Generator().manual_seed(0))
    vals = np.sort(np.asarray(res.tilted)[:, 0])
    gap, lo = max((b - a, a) for a, b in zip(vals, vals[1:]))
    return float(lo + gap / 2)


@pytest.mark.parametrize("paged,shared", [(True, False), (False, False),
                                          (True, True)])
def test_engine_with_moe_target_matches_reference(moe_triple, paged,
                                                  shared):
    cfgs, params, tcfgs, tparams = moe_triple
    g = dict(GREEDY, threshold_u=_threshold(moe_triple))
    kw = dict(mode="gsi", max_seq=48, paged=paged, page_size=8,
              shared_scoring=shared)
    je = JEngine(*cfgs, *params, JGSIConfig(**g), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g), device="cpu",
                          **kw)
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
        np.testing.assert_allclose(tr.rewards, jr.rewards, atol=1e-5,
                                   rtol=0)
        accepts.extend(np.asarray(jr.accept)[~np.asarray(jr.done)].tolist())
    assert True in accepts and False in accepts


@pytest.mark.parametrize("factor", ["published", "starved"])
def test_engine_drops_slots_as_reference(moe_triple, factor, monkeypatch):
    """The MoE target at the published capacity factor and a starved one,
    with shared scoring: the candidates' scoring pass routes enough rows
    that experts overflow and drop slots, and the port's steps still equal
    the reference's, so it drops the same slots."""
    cfgs, params, tcfgs, tparams = moe_triple
    cfgs = (cfgs[0], dataclasses.replace(
        cfgs[1], capacity_factor=FACTORS[factor]), cfgs[2])
    tcfgs = [to_port(c) for c in cfgs]
    kw = dict(mode="gsi", max_seq=48, paged=True, page_size=8,
              shared_scoring=True)
    g = dict(GREEDY, threshold_u=_threshold(moe_triple, tcfgs,
                                            shared_scoring=True))
    drops = []
    moe_ffn = moe.moe_ffn

    def counted(cfg, p, x):
        """The call's routed slots beyond each expert's capacity."""
        xf = x.reshape(-1, x.shape[-1])
        e_pad = p["router"].shape[1]
        _, top_e, _ = moe._route(cfg, p["router"], xf)
        over = torch.bincount(top_e.reshape(-1), minlength=e_pad) \
            - moe._capacity(cfg, xf.shape[0], e_pad)
        drops.append(int(over.clamp(min=0).sum()))
        return moe_ffn(cfg, p, x)

    monkeypatch.setattr(moe, "moe_ffn", counted)
    je = JEngine(*cfgs, *params, JGSIConfig(**g), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g), device="cpu",
                          **kw)
    prompts = _prompts()
    mask = np.ones(len(prompts), bool)
    js = je.admit(je.fresh_state(len(prompts)), mask, prompts)
    ts = te.admit(te.fresh_state(len(prompts)), mask, prompts)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        key, k1, k2 = jax.random.split(key, 3)
        js, jr = je.step_decode(js, k1, k2)
        ts, tr = te.step_decode(ts, gen)
        np.testing.assert_array_equal(tr.chosen, np.asarray(jr.chosen))
        np.testing.assert_array_equal(tr.accept, jr.accept)
        np.testing.assert_array_equal(tr.pos, jr.pos)
        np.testing.assert_allclose(tr.rewards, jr.rewards, atol=1e-5,
                                   rtol=0)
    assert sum(drops) > 0, drops


def _serve(sched, prompts, budgets, gen):
    ids = [sched.submit(p, request_id=f"r{i}", max_steps=m)
           for i, (p, m) in enumerate(zip(prompts, budgets))]
    out = sched.run(gen)
    return ({r: (out[r].tokens.tolist(), out[r].finish_reason) for r in ids},
            sched.engine_steps, sched.prefix_stats())


def _sched_prompts():
    rng = np.random.default_rng(12)
    shared = rng.integers(3, 512, 17).tolist()
    return ([np.asarray(shared + [5, 6, 4], np.int32),
             rng.integers(3, 512, 7).astype(np.int32),
             np.asarray(shared + [9, 4], np.int32),
             rng.integers(3, 512, 11).astype(np.int32)], [3, 2, 3, 2])


def test_pipelined_equals_lock_step_with_moe_target(moe_triple):
    """Temperature 0.7: the two loops draw the same noise in the same
    order, so their tokens agree only if every MoE call is repeatable."""
    _, _, tcfgs, tparams = moe_triple
    g = GSIConfig(**dict(GREEDY, temperature=0.7, threshold_u=0.0))
    prompts, budgets = _sched_prompts()
    outs = []
    for sync in (True, False):
        te = GSIServingEngine(*tcfgs, *tparams, g, device="cpu", max_seq=64,
                              paged=True, page_size=8)
        outs.append(_serve(GSIScheduler(te, capacity=2, sync=sync), prompts,
                           budgets, torch.Generator().manual_seed(4)))
    assert outs[0] == outs[1]


def test_chunked_prefill_scheduler_matches_reference(moe_triple):
    cfgs, params, tcfgs, tparams = moe_triple
    g = dict(GREEDY, threshold_u=_threshold(moe_triple))
    kw = dict(max_seq=64, paged=True, page_size=8)
    prompts, budgets = _sched_prompts()
    je = JEngine(*cfgs, *params, JGSIConfig(**g), **kw)
    want = _serve(JScheduler(je, capacity=2, chunk_tokens=8), prompts,
                  budgets, jax.random.PRNGKey(5))
    te = GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g), device="cpu",
                          **kw)
    got = _serve(GSIScheduler(te, capacity=2, chunk_tokens=8), prompts,
                 budgets, torch.Generator().manual_seed(5))
    assert got == want
