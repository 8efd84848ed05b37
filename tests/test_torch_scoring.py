"""The port's shared-prefix scoring and fused vocab gather against ``repro``.

The same numpy inputs (from a seed) go through the reference and the port:

* ``logprob_gather_plain`` against ``ref.logprob_gather_ref`` and the
  Pallas kernel in interpret mode: T not a multiple of the token tile, V not
  a multiple of the vocab tile, ``vocab_size < V``, W row-major and a tied
  embedding's transpose; atol 1e-5 in fp32;
* ``_slot_abs_positions`` on full and ring caches;
* ``score_candidates`` with rewards on a dense cache (full and sliding
  window layers) and on paged views of bf16 and int8 pools, in fp32: atol
  1e-5, plus rtol 1e-6 for the log-likelihoods, which sum several
  log-probs of random models to magnitudes near 100, where one fp32 ulp
  is already 8e-6;
* the engine at temperature 0, paged, with ``shared_scoring=True`` and
  ``kv_dtype`` bf16, int8 and fp8 (int8 with the draft's weights rounded
  through int8 too): committed tokens, accept decisions and done flags
  identical, PRM rewards within 1e-4, and log pi_B - log pi_S within a
  relative 1e-3: a last-ulp difference upstream can move a K/V value across
  a bf16 or int8 rounding boundary, which shifts a step log-likelihood of
  magnitude ~20 by about 1e-4 of itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig
from repro.kernels import quant as jquant
from repro.kernels import ref
from repro.kernels.logprob_gather import logprob_gather_pallas
from repro.models import build_model
from repro.models.scoring import \
    _slot_abs_positions as j_slot_abs_positions
from repro.models.scoring import score_candidates as j_score_candidates
from repro.serving import GSIServingEngine as JEngine
from repro.serving import paged_view as j_paged_view
from repro_torch.config import GSIConfig as TGSIConfig
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                logprob_gather_plain)
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model import layer_slots
from repro_torch.models.scoring import _slot_abs_positions, score_candidates
from repro_torch.serving import GSIServingEngine
from repro_torch.serving.engine import paged_view

torch.set_num_threads(1)
ATOL = 1e-5
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              temperature=0.0, threshold_u=0.3, min_step_reward=-1.0)


def _tcfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def _tensor(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _jax_tree(tcfg, layers):
    """Per-layer numpy dicts -> the reference's cache pytree layout."""
    blocks, rem = {}, {}
    for (_, _, key, index), layer in zip(layer_slots(tcfg), layers):
        if index is None:
            rem[key] = layer
        else:
            blocks.setdefault(key, []).append(layer)
    return {"blocks": {k: {n: np.stack([lay[n] for lay in v]) for n in v[0]}
                       for k, v in blocks.items()} or None,
            "rem": rem or None}


# ----------------------------------------------------------------------
# the fused vocab gather
# ----------------------------------------------------------------------

@pytest.mark.parametrize("T,V,vocab,tied", [
    (45, 40, 33, False),       # T, V off every tile, masked tail
    (300, 2560, 2500, True),   # T > 256 and V > 2048, neither a multiple
    (7, 64, 64, False)])       # vocab_size == V
def test_logprob_gather_plain_matches_reference_and_pallas(T, V, vocab,
                                                           tied):
    rng = np.random.default_rng(T + V)
    d = 24
    h = rng.standard_normal((1, T, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, vocab, (1, T)).astype(np.int32)
    labels[0, 0], labels[0, -1] = 0, vocab - 1
    tw = torch.from_numpy(w)
    if tied:                                # E.T of a row-major (V, d) E
        tw = tw.T.contiguous().T
    got = logprob_gather_plain(torch.from_numpy(h), tw,
                               torch.from_numpy(labels), vocab).numpy()
    jargs = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), vocab)
    np.testing.assert_allclose(got, np.asarray(ref.logprob_gather_ref(
        *jargs)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(logprob_gather_pallas(
        *jargs, interpret=True)), atol=ATOL, rtol=0)


def test_logprob_gather_dispatch_cpu_and_cuda_wrapper_refuses_cpu():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 12, (2, 3)))
    before = logprob_gather_cuda.launches
    torch.testing.assert_close(ops.logprob_gather(h, w, lab, 12),
                               logprob_gather_plain(h, w, lab, 12),
                               rtol=0, atol=0)
    assert logprob_gather_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        logprob_gather_cuda(h, w, lab, 12)


# ----------------------------------------------------------------------
# score_candidates
# ----------------------------------------------------------------------

def test_slot_abs_positions_matches_reference():
    for pos, size in (([5, 0, 8], 8), ([10, 3, 4], 4), ([0, 1, 17], 16)):
        got = _slot_abs_positions(torch.tensor(pos), size).numpy()
        want = np.asarray(j_slot_abs_positions(jnp.asarray(pos), size))
        np.testing.assert_array_equal(got, want)


def _prm(tiny_dense, pattern):
    cfg = dataclasses.replace(tiny_dense, reward_head=True, num_layers=3,
                              layer_pattern=pattern, window_size=6)
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(3))
    model = Model(_tcfg(cfg), params_from_numpy(
        _tcfg(cfg), jax.tree.map(np.asarray, params)))
    return cfg, build_model(cfg), params, model


def _cands(rng, B, n, L):
    cand = rng.integers(3, 60, (B, n, L)).astype(np.int32)
    cand[0, 1, 3:] = 0                      # a short candidate (PAD tail)
    cand[1, 0, 1:] = 0
    return cand


def _j_score(jm, *args):
    """The reference's score_candidates, jitted whole (one compile instead
    of one per eager op)."""
    fn = jax.jit(lambda *a: j_score_candidates(jm, *a, return_rewards=True))
    return fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args])


def _assert_scores_match(got, want):
    logp, rewards = got
    np.testing.assert_allclose(logp.numpy(), np.asarray(want[0]), atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(want[1]),
                               atol=ATOL, rtol=0)


def test_score_candidates_dense_matches_reference(tiny_dense):
    """A full layer, a sliding-window layer (ring cache of 6 slots, which
    the prefix of 9 positions has wrapped) and an unscanned remainder."""
    cfg, jm, jparams, model = _prm(tiny_dense, ("full", "local"))
    rng = np.random.default_rng(5)
    B, n, L = 2, 3, 5
    prefix = rng.integers(3, 60, (B, 10)).astype(np.int32)
    _, jcache = jax.jit(lambda p, x: jm.prefill(p, x, max_seq=24))(
        jparams, jnp.asarray(prefix[:, :-1]))
    layers = []
    for _, group, key, index in layer_slots(model.cfg):
        leaf = jcache[group][key]
        layers.append({k: _tensor(v if index is None else v[index])
                       for k, v in leaf.items()})
    pend = prefix[:, -1]
    pos = np.full((B,), 9, np.int32)
    cand = _cands(rng, B, n, L)
    want = _j_score(jm, jparams, jcache, pend, pos, cand)
    got = score_candidates(model, layers, torch.from_numpy(pend).long(),
                           torch.from_numpy(pos).long(),
                           torch.from_numpy(cand).long(),
                           return_rewards=True)
    _assert_scores_match(got, want)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_score_candidates_paged_matches_reference(tiny_dense, kv_dtype):
    """Paged pools of random (stale) content read through a block table
    with the trash column, as the engine's shared-scoring pass reads them;
    bf16 and int8 pools promote the fp32 pass as jnp does."""
    cfg, jm, jparams, model = _prm(tiny_dense, ("full",))
    rng = np.random.default_rng(6)
    B, n, L, ps, nblk = 2, 2, 4, 4, 5
    P = B * nblk + 1
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        layer = {}
        for key in ("k", "v"):
            fp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
            if kv_dtype == "bf16":
                layer[key + "p"] = np.asarray(jnp.asarray(fp, jnp.bfloat16))
            else:
                sc = np.maximum(np.abs(fp).max(axis=(1, 3)), 1e-8) / 127.0
                layer[key + "p"] = np.asarray(jquant.quantize_codes(
                    jnp.asarray(fp / sc[:, None, :, None]), jnp.int8))
                layer[key + "s"] = sc.astype(np.float32)
        layers.append(layer)
    pt = rng.permutation(P - 1).reshape(B, nblk)
    pt = np.concatenate([pt, np.full((B, 1), P - 1)], axis=1).astype(np.int32)
    pend = rng.integers(3, 60, (B,)).astype(np.int32)
    pos = np.array([7, 13], np.int32)
    cand = _cands(rng, B, n, L)
    jview = j_paged_view(_jax_tree(model.cfg, layers), jnp.asarray(pt))
    want = _j_score(jm, jparams, jview, pend, pos, cand)
    view = paged_view([{k: _tensor(v) for k, v in layer.items()}
                       for layer in layers], torch.from_numpy(pt))
    got = score_candidates(model, view, torch.from_numpy(pend).long(),
                           torch.from_numpy(pos).long(),
                           torch.from_numpy(cand).long(),
                           return_rewards=True)
    _assert_scores_match(got, want)


# ----------------------------------------------------------------------
# the engine with shared scoring over quantized pools
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def triple(tiny_triple):
    params = [jax.jit(build_model(c).init)(jax.random.PRNGKey(i))
              for i, c in enumerate(tiny_triple)]
    tcfgs = [_tcfg(c) for c in tiny_triple]
    tparams = [params_from_numpy(tc, jax.tree.map(np.asarray, p))
               for tc, p in zip(tcfgs, params)]
    return tiny_triple, params, tcfgs, tparams


@pytest.mark.parametrize("kv_dtype,quantize_draft", [
    ("bf16", False), ("int8", True), ("fp8", False)])
def test_shared_scoring_engine_matches_reference(triple, kv_dtype,
                                                 quantize_draft):
    cfgs, params, tcfgs, tparams = triple
    kw = dict(max_seq=48, paged=True, page_size=8, shared_scoring=True,
              kv_dtype=kv_dtype, quantize_draft=quantize_draft)
    je = JEngine(*cfgs, *params, GSIConfig(**GREEDY), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, TGSIConfig(**GREEDY),
                          device="cpu", **kw)
    rng = np.random.default_rng(0)
    prompts = np.zeros((3, 9), np.int32)
    for b, m in enumerate([9, 4, 6]):
        prompts[b, :m] = rng.integers(3, 64, m)
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
        np.testing.assert_array_equal(tr.done, jr.done)
        np.testing.assert_array_equal(tr.pos, jr.pos)
        np.testing.assert_allclose(tr.rewards, jr.rewards, atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(tr.logp_ratio, jr.logp_ratio, atol=1e-4,
                                   rtol=1e-3)
    pool = te.pager
    assert pool.scale_slots == (set(pool.refcount) | pool.cached
                                if pool.quantized else set())
