"""The port's RWKV-6 stack against ``repro`` on the CPU.

The WKV6 scan's plain version against the reference's oracle and its
Pallas kernel (interpret mode); ``time_mix``, ``channel_mix`` and the
block in every mode; the model's full-sequence passes, prefill, decode
chain, state leaves and ``live`` freeze; and GSI serving over a toy RWKV
triple, dense and paged, with shared scoring off and on, through the
engine and the scheduler.

At the seeded init the decays ``w = exp(-exp(decay_base + lora))`` lie in
about [2e-24, 1.2e-4]: the WKV state forgets almost everything between
tokens, so a wrong state carry would pass.  Every test here therefore
overwrites ``decay_base`` on the reference's parameters, before bridging,
with a seeded uniform in [-6, -0.5], which puts w in about (0.54, 0.9975).
fp32 values are held to 1e-5 of their scale; tokens, accepts and done
flags must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig, get_config, reduced_config
from repro.kernels import ref
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro.models import blocks as jblocks
from repro.models import build_model
from repro.models import rwkv as jrwkv
from repro.models import scoring as jscoring
from repro.rewards import PRM as JPRM
from repro.serving import GSIScheduler as JScheduler
from repro.serving import GSIServingEngine as JEngine
from repro_torch.config import GSIConfig as TGSIConfig
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.models import Model, blocks, rwkv, scoring
from repro_torch.models.bridge import cache_to_numpy, params_from_numpy
from repro_torch.rewards import PRM
from repro_torch.serving import GSIScheduler, GSIServingEngine
from repro_torch.serving.engine import paged_view

torch.set_num_threads(1)
RTOL = 1e-5
# the toy triple's draft and target disagree (independent random weights),
# so its tilted rewards are negative: a threshold of -2.1 both accepts and
# rejects within three steps
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              temperature=0.0, threshold_u=-2.1, min_step_reward=-1.0)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=RTOL * max(np.abs(want).max(), 1.0),
                               rtol=0)


def to_port(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def carrying_params(cfg, seed):
    """Reference parameters with every ``decay_base`` overwritten by a
    seeded uniform in [-6, -0.5] (w in about (0.54, 0.9975)), as numpy."""
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(100 + seed)
    for group in ("blocks", "rem"):
        for blk in (params.get(group) or {}).values():
            base = blk["tm"]["decay_base"]
            blk["tm"]["decay_base"] = rng.uniform(
                -6.0, -0.5, base.shape).astype(base.dtype)
    return params


def _build(cfg, seed=0):
    params = carrying_params(cfg, seed)
    tcfg = to_port(cfg)
    return params, tcfg, Model(tcfg, params_from_numpy(tcfg, params))


@pytest.fixture(scope="module")
def stack():
    """reduced rwkv6-3b: 2 layers, d 128, 4 heads of 32, vocab 512."""
    cfg = reduced_config(get_config("rwkv6-3b"))
    return (cfg, *_build(cfg))


def _tokens(cfg, B=2, S=13, seed=1):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, size=(B, S)).astype(np.int32)


# ----------------------------------------------------------------------
# The scan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (2, 24, 3, 8, 8),
    (1, 17, 2, 16, 8),   # ragged T vs chunk
    (2, 32, 1, 4, 16),
    (1, 8, 2, 8, 64),    # chunk > T
    (3, 1, 2, 32, 64),   # one decode step
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_scan_matches_reference_and_pallas(B, T, H, hd, chunk, dtype):
    rng = np.random.default_rng(T * 100 + hd)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, T, H, hd))))
         + 0.45).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    jr, jk, jv = (jnp.asarray(a, dtype) for a in (r, k, v))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tr, tk, tv = (torch.from_numpy(a).to(tdt) for a in (r, k, v))
    out, sT = rwkv6_scan_plain(tr, tk, tv, torch.from_numpy(w),
                               torch.from_numpy(u), torch.from_numpy(s0))
    assert out.dtype == sT.dtype == torch.float32
    assert out.shape == (B, T, H, hd) and sT.shape == (B, H, hd, hd)
    want = ref.rwkv6_scan_ref(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                              jnp.asarray(s0))
    kern = rwkv6_scan_pallas(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                             jnp.asarray(s0), chunk=chunk, interpret=True)
    for o, s in (want, kern):
        _close(out.numpy(), o)
        _close(sT.numpy(), s)
    # ops dispatches a CPU tensor to the plain version
    o2, s2 = ops.rwkv6_scan(tr, tk, tv, torch.from_numpy(w),
                            torch.from_numpy(u), torch.from_numpy(s0))
    assert torch.equal(o2, out) and torch.equal(s2, sT)
    if T == 1:   # the model's own decode recurrence
        o, s = jrwkv._wkv_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                               jnp.asarray(s0))
        _close(out.numpy(), o)
        _close(sT.numpy(), s)


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------

def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
    return {"tm_prev": rng.standard_normal((B, d)).astype(np.float32),
            "wkv": (rng.standard_normal((B, H, hd, hd)) * 0.3)
            .astype(np.float32),
            "cm_prev": rng.standard_normal((B, d)).astype(np.float32)}


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"]["p0"])


@pytest.mark.parametrize("T", [1, 7])
def test_time_and_channel_mix_match_reference(stack, T):
    cfg, params, tcfg, model = stack
    jp, tp = _layer0(params), model.layers[0]
    assert float(np.exp(-np.exp(jp["tm"]["decay_base"])).min()) > 0.5
    x, st = _x(cfg, 2, T, 10 + T), _state(cfg, 2, 20 + T)
    for jfn, tfn, part in ((jrwkv.time_mix, rwkv.time_mix, "tm"),
                           (jrwkv.channel_mix, rwkv.channel_mix, "cm")):
        jy, jst = jfn(cfg, _j(jp[part]), jnp.asarray(x), _j(st), "prefill")
        ty, tst = tfn(tcfg, tp[part], torch.from_numpy(x), _t(st))
        _close(ty.numpy(), jy)
        assert set(tst) == set(jst)
        for key in jst:
            _close(tst[key].numpy(), jst[key])
    # the carried state matters: from zeros the output differs
    jy0, _ = jrwkv.time_mix(cfg, _j(jp["tm"]), jnp.asarray(x),
                            _j({k: np.zeros_like(v) for k, v in st.items()}),
                            "prefill")
    jy, _ = jrwkv.time_mix(cfg, _j(jp["tm"]), jnp.asarray(x), _j(st),
                           "prefill")
    assert np.abs(np.asarray(jy0) - np.asarray(jy)).max() > 1e-3


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_block_modes_match_reference(stack, mode):
    cfg, params, tcfg, model = stack
    jp, tp = _layer0(params), model.layers[0]
    T = 1 if mode == "decode" else 9
    x = _x(cfg, 3, T, 30)
    st = _state(cfg, 3, 31) if mode == "decode" else None
    live = np.array([True, False, True]) if mode == "decode" else None
    jy, jst, _ = jblocks.block_apply(
        cfg, "rwkv", jp, jnp.asarray(x), mode=mode,
        positions=jnp.zeros((3,), jnp.int32),
        cache=None if st is None else _j(st),
        live=None if live is None else jnp.asarray(live))
    cache = None if st is None else _t(st)
    ty, tst, taux = blocks.block_apply(
        tcfg, "rwkv", tp, torch.from_numpy(x), mode=mode,
        positions=torch.zeros(3, dtype=torch.long), freqs=model.rope_freqs,
        cache=cache, live=None if live is None else torch.from_numpy(live))
    _close(ty.numpy(), jy)
    assert taux == 0.0
    if mode == "train":
        assert jst is None and tst is None
        return
    if mode == "decode":
        assert tst is cache                      # written in place
        for key in st:                           # row 1 frozen
            assert np.array_equal(tst[key][1].numpy(), st[key][1])
    for key in jst:
        _close(tst[key].numpy(), jst[key])


def test_score_block_extend_matches_reference(stack):
    """Score mode: the state repeats n ways and the block runs over the
    L + 1 feeds (the reference's ``extend``)."""
    cfg, params, tcfg, model = stack
    jp, tp = _layer0(params), model.layers[0]
    B, n, L = 2, 3, 6
    x = _x(cfg, B * n, L + 1, 40)
    st = _state(cfg, B, 41)
    pos = np.array([5, 9])
    jy, _ = jscoring.score_block(cfg, "rwkv", jp, jnp.asarray(x),
                                 cache=_j(st), pos=jnp.asarray(pos), n=n)
    ty = scoring.score_block(tcfg, "rwkv", tp, torch.from_numpy(x),
                             cache=_t(st), pos=torch.from_numpy(pos), n=n,
                             freqs=model.rope_freqs)
    _close(ty.numpy(), jy)


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------

def test_forward_hidden_score_match_reference(stack):
    cfg, params, tcfg, model = stack
    jm = build_model(cfg)
    toks = _tokens(cfg)
    V = cfg.vocab_size
    jl, _ = jm.forward(params, jnp.asarray(toks))
    tl, _ = model.forward(torch.from_numpy(toks))
    _close(tl[..., :V].numpy(), np.asarray(jl)[..., :V])
    _close(model.hidden(torch.from_numpy(toks)).numpy(),
           jm.hidden(params, jnp.asarray(toks)))
    _close(model.score(torch.from_numpy(toks)).numpy(),
           jm.score(params, jnp.asarray(toks)))


def test_prm_reward_matches_reference():
    cfg = dataclasses.replace(reduced_config(get_config("rwkv6-3b")),
                              reward_head=True, num_layers=3)
    params, tcfg, _ = _build(cfg, seed=5)
    jprm = JPRM(cfg, params)
    tprm = PRM(tcfg, params_from_numpy(tcfg, params), device="cpu")
    toks = _tokens(cfg, B=3, S=10, seed=6)
    lengths = np.array([10, 4, 1], np.int32)
    want = jprm.reward_sequences(jnp.asarray(toks))
    _close(tprm.model.reward(torch.from_numpy(toks)).numpy(), want)
    _close(tprm.reward_at_end(torch.from_numpy(toks),
                              torch.from_numpy(lengths)).numpy(),
           jprm.reward_at_end(jnp.asarray(toks), jnp.asarray(lengths)))


def test_prefill_state_and_decode_chain_match_reference(stack):
    """Prefill 8 tokens, then decode 12 more one at a time: the state
    leaves after prefill and after the chain match the reference's leaf by
    leaf, and every step's logits match the reference's decode and its
    full forward (as ``tests/test_models.py`` checks the reference)."""
    cfg, params, tcfg, model = stack
    jm = build_model(cfg)
    step = jax.jit(jm.decode_step)
    B, S, S0 = 2, 20, 8
    V = cfg.vocab_size
    toks = _tokens(cfg, B=B, S=S, seed=4)
    full = np.asarray(jm.forward(params, jnp.asarray(toks))[0])[..., :V]
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :S0]))
    tl, tc = model.prefill(torch.from_numpy(toks[:, :S0]))
    _close(tl[:, :V].numpy(), np.asarray(jl)[:, :V])
    _close(tl[:, :V].numpy(), full[:, S0 - 1])

    def same_state():
        want = jax.tree.map(np.asarray, jc)
        got = cache_to_numpy(tcfg, tc)
        flat_w, tree_w = jax.tree.flatten(want)
        flat_g, tree_g = jax.tree.flatten(got)
        assert tree_w == tree_g
        for w, g in zip(flat_w, flat_g):
            _close(g, w)

    same_state()
    for t in range(S0, S):
        lj, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.full((B,), t, jnp.int32))
        lt = model.decode_step(tc, torch.from_numpy(toks[:, t:t + 1]),
                               torch.full((B,), t))[:, :V].numpy()
        _close(lt, np.asarray(lj)[:, :V])
        _close(lt, full[:, t])
    same_state()


def test_live_mask_freezes_recurrent_state(stack):
    """The port of ``tests/test_models.py``'s check, against the
    reference: a frozen row keeps its (zero) state, a live one moves."""
    cfg, params, tcfg, model = stack
    jm = build_model(cfg)
    tok = np.array([[5], [6]], np.int32)
    live = np.array([True, False])
    jl, jc = jm.decode_step(params, jm.init_cache(2, 16), jnp.asarray(tok),
                            jnp.zeros((2,), jnp.int32),
                            live=jnp.asarray(live))
    cache = model.init_cache(2, 16)
    tl = model.decode_step(cache, torch.from_numpy(tok),
                           torch.zeros(2, dtype=torch.long),
                           live=torch.from_numpy(live))
    _close(tl.numpy(), jl)
    wkv = cache_to_numpy(tcfg, cache)["blocks"]["p0"]["wkv"]
    assert np.abs(wkv[:, 1]).max() == 0.0
    assert np.abs(wkv[:, 0]).max() > 0.0
    want = jax.tree.map(np.asarray, jc)
    for w, g in zip(jax.tree.leaves(want),
                    jax.tree.leaves(cache_to_numpy(tcfg, cache))):
        _close(g, w)


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def triple():
    """The toy RWKV triple: 2-layer draft, 3-layer target, its PRM."""
    draft = reduced_config(get_config("rwkv6-3b"), vocab=64)
    target = dataclasses.replace(draft, name="rw-target", num_layers=3)
    prm = dataclasses.replace(target, name="rw-prm", reward_head=True)
    cfgs = (draft, target, prm)
    params = [carrying_params(c, i) for i, c in enumerate(cfgs)]
    tcfgs = [to_port(c) for c in cfgs]
    tparams = [params_from_numpy(tc, p) for tc, p in zip(tcfgs, params)]
    return cfgs, [_j(p) for p in params], tcfgs, tparams


def _prompts():
    rng = np.random.default_rng(0)
    prompts = np.zeros((3, 9), np.int32)
    for b, n in enumerate([9, 4, 6]):
        prompts[b, :n] = rng.integers(3, 64, n)
    return prompts


@pytest.mark.parametrize("paged,shared", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_engine_steps_match_reference(triple, paged, shared):
    cfgs, params, tcfgs, tparams = triple
    kw = dict(mode="gsi", max_seq=48, paged=paged, page_size=8,
              shared_scoring=shared)
    je = JEngine(*cfgs, *params, GSIConfig(**GREEDY), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, TGSIConfig(**GREEDY),
                          device="cpu", **kw)
    assert te.prefix_cache is False and je.prefix_cache is False
    prompts = _prompts()
    mask = np.ones(len(prompts), bool)
    js = je.admit(je.fresh_state(len(prompts)), mask, prompts)
    ts = te.admit(te.fresh_state(len(prompts)), mask, prompts)
    assert te.cache_memory_report(3) == je.cache_memory_report(3)
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
        np.testing.assert_allclose(tr.rewards, jr.rewards, atol=1e-5,
                                   rtol=0)
        accepts.extend(jr.accept.tolist())
    assert True in accepts and False in accepts
    # the committed state of every layer of the three models
    for m, name in ((te.draft, "S"), (te.target, "B"), (te.prm, "P")):
        got = cache_to_numpy(m.cfg, ts["caches"][name])
        want = jax.tree.map(np.asarray, js["caches"][name])
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            _close(g, w)


def test_scheduler_matches_reference(triple):
    """Sync continuous batching over the paged RWKV triple: same
    per-request tokens, engine steps and prefix stats, with the prefix
    cache off on both sides although the engines were asked for it."""
    cfgs, params, tcfgs, tparams = triple
    rng = np.random.default_rng(1)
    shared = rng.integers(3, 64, 17).tolist()
    prompts = [shared + [5, 6, 4], [7, 3, 4], shared + [9, 4],
               rng.integers(3, 64, 11).tolist()]
    budgets = [3, 2, 2, 1]
    kw = dict(max_seq=48, paged=True, page_size=8, prefix_cache=True)
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
    assert outs[0] == outs[1]
    assert outs[1][2]["hits"] == 0 and not te.prefix_cache


def test_paged_view_passes_dense_leaves_through():
    pools = {"kp": torch.arange(48.).reshape(3, 2, 2, 4),
             "vp": -torch.arange(48.).reshape(3, 2, 2, 4)}
    state = {"tm_prev": torch.ones(2, 8), "wkv": torch.ones(2, 2, 4, 4),
             "cm_prev": torch.zeros(2, 8)}
    pt = torch.tensor([[1, 2], [0, 2]], dtype=torch.int32)
    attn_view, rwkv_view = paged_view([pools, state], pt)
    assert set(attn_view) == {"k", "v"}
    assert torch.equal(attn_view["k"][0, :2], pools["kp"][1])
    assert rwkv_view.keys() == state.keys()
    assert all(rwkv_view[k] is state[k] for k in state)
