"""The port's full-sequence entry points against ``repro.models`` on bridged
weights.

Reference parameters are built by ``repro`` and moved over with
``params_from_numpy``; the same numpy tokens (from a seed) then go through
``forward``, ``hidden``, ``score``, ``reward`` and ``prefill`` on both
sides, in fp32 on the CPU (the plain flash-attention and vocab-gather
versions on the port's side, the reference's jnp oracles on the other).
Values are held to 1e-5 of their scale (the port's parity rule), caches
leaf by leaf to 1e-5.  The stacks cover a full/local pattern whose window
is shorter than the prefill (the local layer's cache is a ring buffer), a
full-attention stack under ``serve_window_override`` (a ring for the full
layers too), and the PRM of the shared tiny triple.  Decoding on from a
prefill cache must match the reference's full forward, as
``tests/test_models.py`` checks for the reference alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig
from repro.models import build_model
from repro.rewards import PRM as JPRM
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.models import Model
from repro_torch.models.bridge import cache_to_numpy, params_from_numpy
from repro_torch.rewards import PRM

torch.set_num_threads(1)
RTOL = 1e-5

STACKS = {
    # one scanned (full, local) pattern block and a remainder layer;
    # window 6 < every prefill length below
    "full-local": ModelConfig(
        name="tf-stack", family="dense", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=60, head_dim=16,
        dtype="float32", param_dtype="float32",
        layer_pattern=("full", "local"), window_size=6),
    # GQA group 2, head_dim 40 (the toy target's), untied embedding, full
    # layers served through an 8-row window
    "serve-window": ModelConfig(
        name="tf-override", family="dense", num_layers=2, d_model=160,
        num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=50, head_dim=40,
        dtype="float32", param_dtype="float32", tie_embeddings=False,
        serve_window_override=8),
}


def to_port(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def _build(cfg, seed=0):
    params = build_model(cfg).init(jax.random.PRNGKey(seed))
    tcfg = to_port(cfg)
    model = Model(tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    return params, tcfg, model


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    cfg = STACKS[request.param]
    return (cfg, *_build(cfg))


def _tokens(cfg, B=2, S=13, seed=1):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=RTOL * max(np.abs(want).max(), 1.0),
                               rtol=0)


def test_forward_and_hidden_match_reference(stack):
    cfg, params, _, model = stack
    jm = build_model(cfg)
    toks = _tokens(cfg)
    jl, aux = jm.forward(params, jnp.asarray(toks))
    tl, taux = model.forward(torch.from_numpy(toks))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert float(aux) == taux == 0.0
    _close(tl[..., :cfg.vocab_size].numpy(), jl[..., :cfg.vocab_size])
    _close(model.hidden(torch.from_numpy(toks)).numpy(),
           jm.hidden(params, jnp.asarray(toks)))


def test_score_matches_reference_and_forward(stack):
    cfg, params, _, model = stack
    toks = _tokens(cfg, S=11, seed=2)
    want = build_model(cfg).score(params, jnp.asarray(toks))
    got = model.score(torch.from_numpy(toks))
    assert got.shape == (2, 10) and got.dtype == torch.float32
    _close(got.numpy(), want)
    # the gather is log_softmax(forward logits) at the labels
    logits, _ = model.forward(torch.from_numpy(toks[:, :-1]))
    lp = torch.log_softmax(logits[..., :cfg.vocab_size], dim=-1)
    picked = torch.gather(lp, -1, torch.from_numpy(toks[:, 1:]).long()
                          [..., None])[..., 0]
    _close(got.numpy(), picked.numpy())


@pytest.mark.parametrize("S0", [5, 11])
def test_prefill_cache_and_logits_match_reference(stack, S0):
    """S0 = 11 is longer than both windows (the local layer's 6, the
    override's 8): those caches are ring buffers; S0 = 5 pads them."""
    cfg, params, tcfg, model = stack
    jm = build_model(cfg)
    toks = _tokens(cfg, S=S0, seed=3)
    jl, jc = jm.prefill(params, jnp.asarray(toks), max_seq=20)
    tl, tc = model.prefill(torch.from_numpy(toks), max_seq=20)
    _close(tl[:, :cfg.vocab_size].numpy(), jl[:, :cfg.vocab_size])
    got = cache_to_numpy(tcfg, tc)
    want = jax.tree.map(np.asarray, jc)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    # a window layer keeps window rows (padded when S0 is shorter)
    ring = cfg.serve_window_override or cfg.window_size
    assert min(c["k"].shape[1] for c in tc) == ring


def test_decode_from_prefill_matches_reference(stack):
    """Prefill 9 tokens into a 20-row cache, then decode 8 more one at a
    time: every step's logits match the reference's full forward (as
    ``tests/test_models.py`` checks the reference against itself) and the
    reference's own decode from its prefill cache."""
    cfg, params, _, model = stack
    jm = build_model(cfg)
    step = jax.jit(jm.decode_step)
    B, S, S0 = 2, 17, 9
    toks = _tokens(cfg, B=B, S=S, seed=4)
    full, _ = jm.forward(params, jnp.asarray(toks))
    full = np.asarray(full)[..., :cfg.vocab_size]
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :S0]), max_seq=20)
    tl, tc = model.prefill(torch.from_numpy(toks[:, :S0]), max_seq=20)
    tl = tl[:, :cfg.vocab_size].numpy()
    _close(tl, np.asarray(jl)[:, :cfg.vocab_size])
    # serve_window_override narrows prefill and decode, not forward
    windowed = bool(cfg.serve_window_override)
    if not windowed:
        _close(tl, full[:, S0 - 1])
    for t in range(S0, S):
        lj, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.full((B,), t, jnp.int32))
        lt = model.decode_step(tc, torch.from_numpy(toks[:, t:t + 1]),
                               torch.full((B,), t))
        lt = lt[:, :cfg.vocab_size].numpy()
        _close(lt, np.asarray(lj)[:, :cfg.vocab_size])
        if not windowed:
            _close(lt, full[:, t])


@pytest.fixture(scope="module")
def prm(tiny_triple):
    cfg = tiny_triple[2]
    params, tcfg, _ = _build(cfg, seed=5)
    jprm = JPRM(cfg, params)
    tprm = PRM(tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                          params)),
               device="cpu")
    return cfg, jprm, tprm


def test_prm_rewards_match_reference(prm):
    cfg, jprm, tprm = prm
    toks = _tokens(cfg, B=3, S=10, seed=6)
    lengths = np.array([10, 4, 1], np.int32)
    want_seq = jprm.reward_sequences(jnp.asarray(toks))
    got_seq = tprm.reward_sequences(torch.from_numpy(toks))
    _close(got_seq.numpy(), want_seq)
    want = jprm.reward_at_end(jnp.asarray(toks), jnp.asarray(lengths))
    got = tprm.reward_at_end(torch.from_numpy(toks),
                             torch.from_numpy(lengths))
    assert got.shape == (3,)
    _close(got.numpy(), want)
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    # Model.reward is the same pass
    _close(tprm.model.reward(torch.from_numpy(toks)).numpy(), want_seq)


def test_reward_needs_head_and_sources_raise(stack, tiny_triple):
    cfg, _, tcfg, model = stack
    toks = torch.from_numpy(_tokens(cfg))
    with pytest.raises(ValueError):
        model.reward(toks)
    with pytest.raises(ValueError):
        PRM(tcfg, model.state_dict(), device="cpu")
    with pytest.raises(NotImplementedError):
        model.forward(toks, source=torch.zeros(2, 4, cfg.d_model))
    # full-sequence passes are forward-only: no autograd graph is built
    assert not model.hidden(toks).requires_grad
