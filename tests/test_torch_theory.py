"""The port's decision math and theory against ``repro.core`` on the CPU.

* ``theory``'s bounds, divergences and estimators, the ``ToyEnv`` closed
  forms, ``tilted_policy``, ``log_partition``, ``hard_bon_select`` and
  ``soft_bon_weights``: the same numbers as the reference (float32 on both
  sides; 1e-6 relative for the transcendental ones, equal for the rest).
* ``ToyEnv.run_gsi``, ``run_rsd`` and ``run_sbon`` by distribution: the
  port's torch draws and the reference's JAX draws, 100,000 trials each
  over 6 outcomes, against the exact distributions of Algorithm 1
  enumerated over every tuple of candidates.  The expected total-variation
  distance of such a histogram is about 0.003; each is held to 0.012.
* ``speculative_verify`` with the reference's uniform and Gumbel draws
  injected: identical accept counts, masks and resampled tokens.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sbon as jsbon
from repro.core import spec_decode as jspec
from repro.core import theory as jtheory
from repro.core import tilting as jtilting
from repro.core.toy import ToyEnv as JToyEnv
from repro_torch.core import sbon, spec_decode, theory, tilting
from repro_torch.core.toy import ToyEnv

TV_BOUND = 0.012
TRIALS = 100_000


def _eq(got, want, rtol=1e-6, atol=1e-37):
    """Equal to ``rtol``; XLA flushes float32 subnormals to zero on the CPU
    and torch keeps them, hence the absolute 1e-37."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_theory_functions_match_reference():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(9), size=4).astype(np.float32)
    q = rng.dirichlet(np.ones(9), size=4).astype(np.float32)
    p[0, 3] = 0.0                                 # a zero of P is skipped
    r = rng.uniform(0, 1, (4, 9)).astype(np.float32)
    chi2 = np.float32(1.7)
    logp_b = rng.normal(-3, 1, 50).astype(np.float32)
    logp_s = rng.normal(-3, 1, 50).astype(np.float32)
    counts = rng.integers(0, 50, (4, 9)).astype(np.float32)
    n = np.arange(1, 5, dtype=np.float32)
    cases = [
        ("kl_divergence", (p, q), {}),
        ("chi2_divergence", (p, q), {}),
        ("theorem1_n_bound", (chi2, 2.0, 0.8, 0.1), {}),
        ("theorem1_kl_bound", (n, chi2, 2.0, 0.8), {}),
        ("sbon_kl_bound", (4, p, r, 3.0), {}),
        ("coefficient_of_variation", (p, r, 3.0), {}),
        ("theorem2_gap_bound", (n, 0.7, chi2, np.float32(0.4), 2.0, 0.8,
                                1.0), {}),
        ("chi2_mc_estimate", (logp_b, logp_s), {}),
        ("kl_mc_estimate", (p, counts), {}),
    ]
    for name, args, kw in cases:
        want = getattr(jtheory, name)(*[jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in args], **kw)
        got = getattr(theory, name)(*[_t(a) if isinstance(a, np.ndarray)
                                      else a for a in args], **kw)
        _eq(got, want)


def test_tilting_and_bon_match_reference():
    rng = np.random.default_rng(1)
    pi = rng.dirichlet(np.ones(7), size=3).astype(np.float32)
    pi[1, 2] = 0.0                                # clamped to 1e-38
    r = rng.uniform(-1, 1, (3, 7)).astype(np.float32)
    for beta in (0.5, 20.0):
        _eq(tilting.tilted_policy(_t(pi), _t(r), beta),
            jtilting.tilted_policy(jnp.asarray(pi), jnp.asarray(r), beta))
        # log Z near 0 is a sum of terms of order beta: 1e-6 of their size
        _eq(tilting.log_partition(_t(pi), _t(r), beta),
            jtilting.log_partition(jnp.asarray(pi), jnp.asarray(r), beta),
            atol=1e-6 * max(beta, 1.0))
        _eq(sbon.soft_bon_weights(_t(r), beta),
            jsbon.soft_bon_weights(jnp.asarray(r), beta))
    assert np.array_equal(sbon.hard_bon_select(_t(r)).numpy(),
                          np.asarray(jsbon.hard_bon_select(jnp.asarray(r))))


def test_toy_closed_forms_match_reference():
    for kw in ({"m": 12, "seed": 0}, {"m": 6, "seed": 3, "skew": 2.0,
                                      "reward_seed": 9}):
        ref, port = JToyEnv(**kw), ToyEnv(**kw, device="cpu")
        for name in ("pi_B", "pi_S", "r", "r_star"):
            assert np.array_equal(getattr(port, name).numpy(),
                                  np.asarray(getattr(ref, name))), name
        _eq(port.chi2, ref.chi2)
        for beta in (1.0, 8.0):
            _eq(port.cv(beta), ref.cv(beta))
            _eq(port.tilted(beta), ref.tilted(beta))
            _eq(port.expected_golden(port.tilted(beta)),
                ref.expected_golden(ref.tilted(beta)))
        outcomes = np.random.default_rng(2).integers(0, port.m, 500)
        _eq(port.histogram(_t(outcomes)),
            ref.histogram(jnp.asarray(outcomes)))


def _sbon_exact(pi, score, beta, n):
    """P(selected outcome = y) of soft best-of-n: n i.i.d. candidates from
    ``pi``, one picked with probability softmax(beta * score)."""
    out = np.zeros(len(pi))
    for ys in itertools.product(range(len(pi)), repeat=n):
        ys = list(ys)
        w = np.exp(beta * score[ys] - np.max(beta * score[ys]))
        out += np.prod(pi[ys]) * np.bincount(ys, w / w.sum(), len(pi))
    return out


def _exact(env, kind, n, beta, u):
    """(final, selected-before-the-test, accept probability)."""
    pi_B, pi_S, r = (getattr(env, k).double().numpy()
                     for k in ("pi_B", "pi_S", "r"))
    if kind == "sbon_b":
        return _sbon_exact(pi_B, r, beta, n), None, None
    if kind == "sbon_s":
        return _sbon_exact(pi_S, r, beta, n), None, None
    score = r + (np.log(pi_B) - np.log(pi_S)) / beta if kind == "gsi" else r
    sel = _sbon_exact(pi_S, score, beta, n)
    ok = score >= u
    base = _sbon_exact(pi_B, r, beta, n)
    accept = float(sel[ok].sum())
    return np.where(ok, sel, 0.0) + (1.0 - accept) * base, sel, accept


def _tv(hist, exact):
    return 0.5 * float(np.abs(np.asarray(hist, np.float64) - exact).sum())


@pytest.mark.parametrize("kind", ["gsi", "rsd", "sbon_b", "sbon_s"])
def test_toy_runs_match_exact_distributions(kind):
    n, beta = 3, 4.0
    port, ref = ToyEnv(m=6, seed=1, device="cpu"), JToyEnv(m=6, seed=1)
    r_t = (port.r + (torch.log(port.pi_B) - torch.log(port.pi_S)) / beta)
    u = float(torch.median(r_t if kind == "gsi" else port.r))
    final, sel, accept = _exact(port, kind, n, beta, u)
    gen = torch.Generator().manual_seed(11)
    key = jax.random.PRNGKey(11)
    if kind in ("sbon_b", "sbon_s"):
        base = kind == "sbon_b"
        runs = [port.run_sbon(gen, n=n, beta=beta, base=base, trials=TRIALS),
                ref.run_sbon(key, n=n, beta=beta, base=base, trials=TRIALS)]
        for env, out in zip((port, ref), runs):
            assert _tv(env.histogram(out), final) <= TV_BOUND
        return
    if kind == "gsi":
        runs = [port.run_gsi(gen, n=n, beta=beta, u=u, trials=TRIALS),
                ref.run_gsi(key, n=n, beta=beta, u=u, trials=TRIALS)]
    else:
        runs = [port.run_rsd(gen, n=n, beta=beta, threshold=u,
                             trials=TRIALS),
                ref.run_rsd(key, n=n, beta=beta, threshold=u,
                            trials=TRIALS)]
    assert 0.05 < accept < 0.95
    for env, trial in zip((port, ref), runs):
        assert _tv(env.histogram(trial.outcomes), final) <= TV_BOUND
        assert _tv(env.histogram(trial.outcomes_tilde), sel) <= TV_BOUND
        assert abs(float(np.mean(np.asarray(trial.accept))) - accept) \
            <= TV_BOUND


def test_speculative_verify_with_injected_draws_matches_reference():
    rng = np.random.default_rng(4)
    B, k, V = 6, 4, 11
    logits_S = rng.normal(0, 2, (B, k, V)).astype(np.float32)
    logits_B = rng.normal(0, 2, (B, k, V)).astype(np.float32)
    logits_B[0] = logits_S[0]          # draft == target: all accepted
    logits_B[1, 0] = logits_S[1, 0] - 50.0 * (np.arange(V) != 3)
    draft = rng.integers(0, V, (B, k)).astype(np.int32)
    draft[1, 0] = 3                    # target certain of the draft token
    key = jax.random.PRNGKey(7)
    want = jspec.speculative_verify(key, jnp.asarray(draft),
                                    jnp.asarray(logits_S),
                                    jnp.asarray(logits_B))
    k_acc, k_res = jax.random.split(key)
    uni = np.asarray(jax.random.uniform(k_acc, (B, k)))
    gum = np.asarray(jax.random.gumbel(k_res, (B, V), jnp.float32))
    got = spec_decode.speculative_verify(
        None, _t(draft), _t(logits_S), _t(logits_B), uniform=_t(uni),
        gumbel=_t(gum))
    assert int(got.num_accepted[0]) == k
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the generator path draws its own noise and keeps the contract
    gen = torch.Generator().manual_seed(0)
    res = spec_decode.speculative_verify(gen, _t(draft), _t(logits_S),
                                         _t(logits_B))
    assert torch.equal(res.accept_mask, torch.arange(k)[None]
                       < res.num_accepted[:, None])
    assert int(res.num_accepted[0]) == k
