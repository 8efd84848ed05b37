"""The port's Gemma families against ``repro`` on the CPU.

The RG-LRU (``repro_torch.models.lru``) and the hybrid ``recurrent`` block,
``gemma3-1b`` and ``recurrentgemma-9b`` at reduced sizes, in fp32, from the
reference's own weights carried across by the numpy bridge or from seeded
numpy inputs:

* the doubling scan against a sequential loop (float64) and the
  reference's ``associative_scan``, at T up to 257, with decays whose
  products underflow to 0;
* the block in train, prefill, decode and extend, and a decode chain that
  ends in prefill's state, with ``live=False`` freezing ``h`` and ``conv``;
* the bridge's ``rec.*`` leaves and ``h``/``conv`` cache leaves;
* logits of reduced gemma3 (one case at head_dim 256) and recurrentgemma:
  forward, score, prefill and decode;
* GSI engines over a hybrid ``(recurrent, recurrent, local)`` triple for 3
  steps at temperature 0 in all five modes, paged with and without shared
  scoring, and over int8 pages with the int8 draft.

At the seeded init ``lam`` is the logit of U[0.9, 0.999], so
``a = exp(-8 softplus(lam) r)`` is at most about e^-9 at r = 0.5: the
state forgets at every step, and a port that dropped it would pass.  Every
test here overwrites ``lam`` with a seeded U[-9, -4] (a in about
[0.93, 0.9995] at r = 0.5).  fp32 values are held to 1e-5 of their scale;
tokens, accepts and positions must be identical, rewards within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig as JGSIConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import get_config, reduced_config
from repro.models import blocks as jblocks
from repro.models import build_model
from repro.models import lru as jlru
from repro.serving import GSIServingEngine as JEngine
from repro.serving.quant import quantize_draft_params as j_quantize
from repro_torch.config import GSIConfig, ModelConfig
from repro_torch.models import Model, blocks, lru, param_specs, scoring
from repro_torch.models.bridge import cache_to_numpy, params_from_numpy
from repro_torch.serving import GSIServingEngine
from repro_torch.serving.quant import quantize_draft_params

torch.set_num_threads(1)
RTOL = 1e-5
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              temperature=0.0, min_step_reward=-1.0)


def to_port(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=rtol * max(np.abs(want).max(), 1.0),
                               rtol=0)


def carrying_params(cfg, seed):
    """Reference parameters with every ``lam`` overwritten by a seeded
    U[-9, -4], so that the RG-LRU state carries; as numpy."""
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(200 + seed)
    for group in ("blocks", "rem"):
        for blk in (params.get(group) or {}).values():
            if "rec" in blk:
                lam = blk["rec"]["lam"]
                blk["rec"]["lam"] = rng.uniform(-9.0, -4.0, lam.shape).astype(
                    lam.dtype)
    return params


def _build(cfg, seed=0):
    params = carrying_params(cfg, seed)
    tcfg = to_port(cfg)
    return params, tcfg, Model(tcfg, params_from_numpy(tcfg, params))


def _rgemma(layers=3):
    """reduced recurrentgemma-9b: (recurrent, recurrent, local), d 128,
    lru_width 128, window 64."""
    return reduced_config(get_config("recurrentgemma-9b"), layers=layers)


def _gemma3(head_dim=0):
    """reduced gemma3-1b with its local and full kinds and a window of 8
    that the 20-token sequences cross; ``head_dim`` 256 keeps the
    published head width over d 64."""
    cfg = dataclasses.replace(
        reduced_config(get_config("gemma3-1b"), layers=3),
        layer_pattern=("local", "local", "full"), window_size=8)
    if head_dim:
        cfg = dataclasses.replace(cfg, d_model=64, num_heads=4,
                                  num_kv_heads=1, head_dim=head_dim, d_ff=96,
                                  lru_width=64)
    return cfg


@pytest.fixture(scope="module")
def stack():
    cfg = _rgemma()
    return (cfg, *_build(cfg))


def _tokens(cfg, B=2, S=20, seed=1):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    w = cfg.lru_width
    return {"h": rng.standard_normal((B, w)).astype(np.float32),
            "conv": rng.standard_normal((B, 3, w)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"]["p0"])


# ----------------------------------------------------------------------
# The scan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 17, 64, 257])
def test_doubling_scan_matches_sequential_and_reference(T):
    """Decays near 1, decays of 1e-30 (every product over two of them
    underflows to 0 in fp32) and exact zeros, against a float64 loop and
    the reference's associative scan."""
    rng = np.random.default_rng(T)
    B, w = 3, 16
    a = rng.uniform(0.9, 1.0, (B, T, w)).astype(np.float32)
    a[:, ::5, :4] = 1e-30
    a[:, 3::7, 4:6] = 0.0
    b = rng.standard_normal((B, T, w)).astype(np.float32)
    h0 = rng.standard_normal((B, w)).astype(np.float32)
    want = np.empty((B, T, w))
    h = h0.astype(np.float64)
    for t in range(T):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    got = lru.lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(h0))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got.numpy(), want)
    _close(got.numpy(), jlru._lru_scan(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(h0)))


# ----------------------------------------------------------------------
# The block
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "extend"])
def test_recurrent_block_matches_reference(stack, mode):
    cfg, params, tcfg, model = stack
    jp, tp = _layer0(params), model.layers[0]
    assert model.kinds[:2] == ["recurrent", "recurrent"]
    T = 1 if mode == "decode" else 9
    B = 3
    x = _x(cfg, B, T, 30)
    st = None if mode == "train" else _state(cfg, B, 31)
    if mode == "extend":
        # the scoring pass's call: the RG-LRU alone over T > 1 feeds
        jy, jst = jlru.recurrent_block(cfg, _j(jp["rec"]), jnp.asarray(x),
                                       _j(st), "extend")
        ty, tst = lru.recurrent_block(tcfg, tp["rec"], torch.from_numpy(x),
                                      _t(st))
        _close(ty.numpy(), jy)
        for key in jst:
            _close(tst[key].numpy(), jst[key])
        return
    live = np.array([True, False, True]) if mode == "decode" else None
    jy, jst, _ = jblocks.block_apply(
        cfg, "recurrent", jp, jnp.asarray(x), mode=mode,
        positions=jnp.zeros((B,), jnp.int32),
        cache=None if st is None else _j(st),
        live=None if live is None else jnp.asarray(live))
    cache = None if st is None else _t(st)
    ty, tst, taux = blocks.block_apply(
        tcfg, "recurrent", tp, torch.from_numpy(x), mode=mode,
        positions=torch.zeros(B, dtype=torch.long), freqs=model.rope_freqs,
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


def test_carried_state_changes_the_output(stack):
    """With ``lam`` overwritten the state carries: from zeros the block's
    output differs (at the seeded init it would not, within 1e-3)."""
    cfg, params, tcfg, model = stack
    p = model.layers[0]["rec"]
    x = torch.from_numpy(_x(cfg, 2, 4, 32))
    st = _t(_state(cfg, 2, 33))
    zero = {k: torch.zeros_like(v) for k, v in st.items()}
    y, _ = lru.recurrent_block(tcfg, p, x, st)
    y0, _ = lru.recurrent_block(tcfg, p, x, zero)
    assert (y - y0)[:, -1].abs().max() > 1e-3


def test_decode_chain_ends_in_prefill_state_and_live_freezes(stack):
    """T decode steps from zeros end where a prefill over the same inputs
    ends; a row with ``live=False`` keeps its ``h`` and ``conv``."""
    cfg, params, tcfg, model = stack
    p = model.layers[0]["rec"]
    B, T = 2, 11
    x = torch.from_numpy(_x(cfg, B, T, 34))
    y_full, full = lru.recurrent_block(tcfg, p, x,
                                       lru.init_lru_state(tcfg, B, "cpu"))
    state = lru.init_lru_state(tcfg, B, "cpu")
    ys = []
    for t in range(T):
        y, same = lru.recurrent_block(tcfg, p, x[:, t:t + 1], state,
                                      in_place=True)
        assert same is state
        ys.append(y)
    _close(torch.cat(ys, dim=1).numpy(), y_full.numpy())
    for key in full:
        _close(state[key].numpy(), full[key].numpy())
    before = {k: v.clone() for k, v in state.items()}
    lru.recurrent_block(tcfg, p, x[:, :1], state,
                        live=torch.tensor([False, True]), in_place=True)
    for key in state:
        assert torch.equal(state[key][0], before[key][0])
        assert not torch.equal(state[key][1], before[key][1])


# ----------------------------------------------------------------------
# Bridge and model
# ----------------------------------------------------------------------

def test_bridge_carries_rec_leaves(stack):
    """Every ``rec.*`` leaf of the scanned and remainder layers arrives
    with the reference's values; the specs match the reference's tree at
    full recurrentgemma width."""
    cfg, params, tcfg, model = stack
    tp = params_from_numpy(tcfg, params)
    np.testing.assert_array_equal(
        tp["layers.1.rec.lam"].numpy(),
        np.asarray(params["blocks"]["p1"]["rec"]["lam"][0]))
    np.testing.assert_array_equal(
        tp["layers.0.rec.wa"].numpy(),
        np.asarray(params["blocks"]["p0"]["rec"]["wa"][0]))
    full = get_config("recurrentgemma-9b")
    want = jax.eval_shape(build_model(full).init, jax.random.PRNGKey(0))
    specs = param_specs(to_port(full))
    rec = {k: s for k, s in specs.items() if ".rec." in k}
    assert len(rec) == 9 * 26                      # 12 x 2 + 2 remainder
    assert specs["layers.37.rec.wo"].shape == tuple(
        want["rem"]["r1"]["rec"]["wo"].shape)
    assert specs["layers.0.rec.conv_w"].shape == tuple(
        want["blocks"]["p0"]["rec"]["conv_w"].shape[1:])
    assert specs["layers.0.rec.conv_w"].axes == \
        tuple(jlru.recurrent_specs(full)["conv_w"].axes)


@pytest.mark.parametrize("which", ["recurrentgemma", "gemma3", "gemma3-hd256"])
def test_model_matches_reference(which):
    """forward, hidden, score; prefill's logits and caches (the
    ``h``/``conv`` leaves and ring buffers, through ``cache_to_numpy``);
    then a decode chain past the window, step by step."""
    cfg = {"recurrentgemma": _rgemma, "gemma3": _gemma3,
           "gemma3-hd256": lambda: _gemma3(256)}[which]()
    params, tcfg, model = _build(cfg, seed=3)
    jm = build_model(cfg)
    B, S, S0 = 2, 20, 7
    V = cfg.vocab_size
    toks = _tokens(cfg, B=B, S=S, seed=4)
    full = np.asarray(jm.forward(params, jnp.asarray(toks))[0])[..., :V]
    tl, _ = model.forward(torch.from_numpy(toks))
    _close(tl[..., :V].numpy(), full)
    _close(model.score(torch.from_numpy(toks)).numpy(),
           jm.score(params, jnp.asarray(toks)))
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :S0]), max_seq=S)
    tl, tc = model.prefill(torch.from_numpy(toks[:, :S0]), max_seq=S)
    _close(tl[:, :V].numpy(), np.asarray(jl)[:, :V])

    def same_cache():
        want = jax.tree.map(np.asarray, jc)
        got = cache_to_numpy(tcfg, tc)
        flat_w, tree_w = jax.tree.flatten(want)
        flat_g, tree_g = jax.tree.flatten(got)
        assert tree_w == tree_g
        for w, g in zip(flat_w, flat_g):
            _close(g, w)

    same_cache()
    step = jax.jit(jm.decode_step)
    for t in range(S0, S):
        lj, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.full((B,), t, jnp.int32))
        lt = model.decode_step(tc, torch.from_numpy(toks[:, t:t + 1]),
                               torch.full((B,), t))[:, :V].numpy()
        _close(lt, np.asarray(lj)[:, :V])
        _close(lt, full[:, t])
    same_cache()


def test_score_block_extends_recurrent_state(stack):
    """Score mode repeats the slot's state n ways and runs the block over
    the L + 1 feeds, as the reference's ``extend``."""
    from repro.models import scoring as jscoring
    cfg, params, tcfg, model = stack
    jp, tp = _layer0(params), model.layers[0]
    B, n, L = 2, 3, 6
    x = _x(cfg, B * n, L + 1, 40)
    st = _state(cfg, B, 41)
    pos = np.array([5, 9])
    jy, _ = jscoring.score_block(cfg, "recurrent", jp, jnp.asarray(x),
                                 cache=_j(st), pos=jnp.asarray(pos), n=n)
    ty = scoring.score_block(tcfg, "recurrent", tp, torch.from_numpy(x),
                             cache=_t(st), pos=torch.from_numpy(pos), n=n,
                             freqs=model.rope_freqs)
    _close(ty.numpy(), jy)


def test_int8_draft_quantizes_hybrid_leaves_as_reference(stack):
    """The int8 draft rounds the recurrent block's matrices (and its
    (4, w) conv taps, per channel, as the reference's axis rule does) and
    leaves ``lam``, the biases and the norms alone."""
    cfg, params, tcfg, model = stack
    want = params_from_numpy(tcfg, jax.tree.map(
        np.asarray, j_quantize(cfg, _j(params))))
    got = quantize_draft_params(tcfg, params_from_numpy(tcfg, params))
    plain = params_from_numpy(tcfg, params)
    assert set(got) == set(want)
    for name in got:
        _close(got[name].numpy(), want[name].numpy())
    for leaf in ("lam", "ba", "bi"):
        assert torch.equal(got[f"layers.0.rec.{leaf}"],
                           plain[f"layers.0.rec.{leaf}"])
    assert not torch.equal(got["layers.0.rec.wa"], plain["layers.0.rec.wa"])


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def triple():
    """A hybrid triple: a (recurrent, recurrent, local) draft, a 4-layer
    target (the pattern plus a recurrent remainder layer) and its PRM;
    d 64, lru_width 64, 4 heads over 2 kv heads of 16, window 12, vocab
    64, fp32, ``lam`` overwritten."""
    draft = JModelConfig(
        name="hy-draft", family="hybrid", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64, head_dim=16,
        layer_pattern=("recurrent", "recurrent", "local"), window_size=12,
        dtype="float32", param_dtype="float32")
    target = dataclasses.replace(draft, name="hy-target", num_layers=4)
    prm = dataclasses.replace(target, name="hy-prm", reward_head=True)
    cfgs = (draft, target, prm)
    params = [carrying_params(c, 10 + i) for i, c in enumerate(cfgs)]
    tcfgs = [to_port(c) for c in cfgs]
    tparams = [params_from_numpy(tc, p) for tc, p in zip(tcfgs, params)]
    return cfgs, [_j(p) for p in params], tcfgs, tparams


def _prompts():
    rng = np.random.default_rng(0)
    prompts = np.zeros((3, 9), np.int32)
    for b, n in enumerate([9, 4, 6]):
        prompts[b, :n] = rng.integers(3, 64, n)
    return prompts


# (mode, engine options): all five modes over paged caches with shared
# scoring, then gsi over paged caches without it, and over int8 pages with
# shared scoring and the int8 draft (chip_smoke's gsi-int8-shared);
# threshold 0.5 sits among this triple's tilted rewards, so gsi both
# accepts and falls back
ENGINE_CASES = {
    "gsi-paged-shared": ("gsi", dict(paged=True, shared_scoring=True)),
    "gsi_norej": ("gsi_norej", dict(paged=True, shared_scoring=True)),
    "rsd": ("rsd", dict(paged=True, shared_scoring=True)),
    "sbon_s": ("sbon_s", dict(paged=True, shared_scoring=True)),
    "sbon_b": ("sbon_b", dict(paged=True, shared_scoring=True)),
    "gsi-paged": ("gsi", dict(paged=True)),
    "gsi-int8-shared": ("gsi", dict(paged=True, shared_scoring=True,
                                    kv_dtype="int8", quantize_draft=True)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_steps_match_reference(triple, case):
    cfgs, params, tcfgs, tparams = triple
    mode, opts = ENGINE_CASES[case]
    g = dict(GREEDY, threshold_u=0.5)
    kw = dict(mode=mode, max_seq=48, page_size=8, **opts)
    je = JEngine(*cfgs, *params, JGSIConfig(**g), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g), device="cpu",
                          **kw)
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
        if jr.rewards is not None:
            np.testing.assert_allclose(tr.rewards, jr.rewards, atol=1e-4,
                                       rtol=0)
        accepts.extend(np.ravel(jr.accept).tolist())
    if mode == "gsi":
        assert True in accepts and False in accepts
    # the recurrent layers' committed state (page pools may differ in
    # pages no table reaches: scratch and trash rows)
    for m, name in ((te.draft, "S"), (te.target, "B"), (te.prm, "P")):
        got = cache_to_numpy(m.cfg, ts["caches"][name])
        want = jax.tree.map(np.asarray, js["caches"][name])
        for group in ("blocks", "rem"):
            for key, leaves in (want[group] or {}).items():
                for leaf in ("h", "conv"):
                    if leaf in leaves:
                        _close(got[group][key][leaf], leaves[leaf],
                               rtol=1e-4)
