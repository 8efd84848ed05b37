"""The port's model stack against ``repro.models`` on bridged weights.

Reference parameters are built by ``repro`` and moved over with
``params_from_numpy``; ``decode_step`` then runs on both sides from zeroed
caches, step after step, dense and paged, and the logits (1e-5 relative to
their scale) and every cache leaf must agree.  The port's own dense and
paged paths must agree with each other too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig
from repro.models import blocks as jblocks
from repro.models import build_model
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.models import Model, param_specs, random_params
from repro_torch.models.attention import self_attention
from repro_torch.models.blocks import block_specs
from repro_torch.models.bridge import cache_to_numpy, params_from_numpy

torch.set_num_threads(1)
RTOL = 1e-5


def to_port(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def stack():
    """A 3-layer full/local stack: one scanned pattern block and one
    remainder layer, so the bridge's unstacking is exercised."""
    cfg = ModelConfig(
        name="tt-stack", family="dense", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=60, head_dim=16,
        dtype="float32", param_dtype="float32",
        layer_pattern=("full", "local"), window_size=6)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = to_port(cfg)
    model = Model(tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    return cfg, params, tcfg, model


def _assert_trees_close(a, b, atol):
    flat_a, tree_a = jax.tree.flatten(a)
    flat_b, tree_b = jax.tree.flatten(b)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(x), y, atol=atol, rtol=0)


def test_bridge_round_trips_shapes(stack, tiny_triple):
    cfg, params, tcfg, model = stack
    specs = param_specs(tcfg)
    state = model.state_dict()
    assert set(state) == set(specs)
    for name, s in specs.items():
        assert tuple(state[name].shape) == s.shape, name
    # the reference's tree holds exactly the same number of values
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_ref == sum(t.numel() for t in state.values())
    # layer 2 is the unscanned remainder block r0
    np.testing.assert_array_equal(
        state["layers.2.attn.wq"].numpy(),
        np.asarray(params["rem"]["r0"]["attn"]["wq"]))
    np.testing.assert_array_equal(
        state["layers.1.ffn.wo"].numpy(),
        np.asarray(params["blocks"]["p1"]["ffn"]["wo"][0]))
    # PRM (untied + reward head) of the shared tiny triple
    prm = tiny_triple[2]
    tp = to_port(prm)
    ref = jax.tree.map(np.asarray,
                       build_model(prm).init(jax.random.PRNGKey(1)))
    Model(tp, params_from_numpy(tp, ref))


def test_cache_layout_matches_reference(stack):
    cfg, _, tcfg, model = stack
    jm = build_model(cfg)
    for kw in ({}, {"pages": 7, "page_size": 4}):
        want = jax.tree.map(lambda a: a.shape, jm.init_cache(2, 16, **kw))
        got = jax.tree.map(lambda a: a.shape,
                           cache_to_numpy(tcfg, model.init_cache(2, 16, **kw)))
        assert want == got


def _run(stack, paged, steps=8):
    cfg, params, tcfg, model = stack
    jm = build_model(cfg)
    B, S, ps = 3, 24, 4
    rng = np.random.default_rng(1)               # tokens
    pos = np.array([0, 5, 11])
    if paged:
        nblk = S // ps
        P = B * nblk + 1
        pt = np.random.default_rng(2).permutation(P)[:B * nblk].reshape(
            B, nblk).astype(np.int32)
        jc = jm.init_cache(B, S, pages=P, page_size=ps)
        tc = model.init_cache(B, S, pages=P, page_size=ps)
        jpt, tpt = jnp.asarray(pt), torch.from_numpy(pt)
    else:
        jc, tc = jm.init_cache(B, S), model.init_cache(B, S)
        jpt = tpt = None
    logits = []
    for _ in range(steps):
        tok = rng.integers(3, cfg.vocab_size, size=(B, 1))
        lj, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(pos), pt=jpt)
        lt = model.decode_step(tc, torch.from_numpy(tok),
                               torch.from_numpy(pos), pt=tpt)
        lj = np.asarray(lj)[:, :cfg.vocab_size]
        lt = lt.numpy()[:, :cfg.vocab_size]
        scale = np.abs(lj).max()
        np.testing.assert_allclose(lt, lj, atol=RTOL * scale, rtol=0)
        logits.append(lt)
        pos = pos + 1
    _assert_trees_close(jax.tree.map(np.asarray, jc),
                        cache_to_numpy(tcfg, tc), atol=1e-5)
    return np.stack(logits)


@pytest.fixture(scope="module")
def runs(stack):
    """Port logits per layout, each checked step by step against the
    reference inside ``_run`` (computed once per module)."""
    return {}


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_matches_reference(stack, runs, paged):
    runs[paged] = _run(stack, paged)


def test_port_dense_and_paged_agree(stack, runs):
    dense = runs[False] if False in runs else _run(stack, False)
    paged = runs[True] if True in runs else _run(stack, True)
    np.testing.assert_allclose(paged, dense,
                               atol=RTOL * np.abs(dense).max(), rtol=0)


def test_random_params_are_seeded_and_shaped(tiny_triple):
    cfg = to_port(tiny_triple[2])
    a = random_params(cfg, 3, "cpu")
    b = random_params(cfg, 3, "cpu")
    c = random_params(cfg, 4, "cpu")
    specs = param_specs(cfg)
    assert set(a) == set(specs)
    for name, s in specs.items():
        assert tuple(a[name].shape) == s.shape
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
    assert not torch.equal(a["layers.0.attn.wq"], c["layers.0.attn.wq"])
    # "1 + gamma" norms start at gamma = 0; projections are fan-in scaled
    assert not a["final_ln"].any()
    std = a["layers.0.attn.wq"].std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


def test_unported_kinds_and_modes_raise(stack):
    cfg, _, tcfg, model = stack
    # the cross kind is ported: the reference's names and shapes (its
    # values in tests/test_torch_cross.py)
    want = {".".join(p.key for p in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jblocks.block_specs(cfg, "cross"),
                is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {k: s.shape for k, s in block_specs(tcfg, "cross").items()} \
        == want
    with pytest.raises(NotImplementedError):
        block_specs(tcfg, "mamba")
    x = torch.zeros(1, 4, tcfg.d_model)
    # a source on a stack with no cross layer is ignored, as in the
    # reference; a mode the reference lacks is refused
    toks = torch.ones(1, 4, dtype=torch.long)
    torch.testing.assert_close(model.prefill(toks, source=x)[0],
                               model.prefill(toks)[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        self_attention(tcfg, model.layers[0]["attn"], x, kind="full",
                       mode="extend", positions=torch.arange(4),
                       freqs=model.rope_freqs)
