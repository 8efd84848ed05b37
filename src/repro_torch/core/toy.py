"""Categorical toy environment — *exact* validation of Theorems 1 & 2.

A port of ``repro.core.toy``.  Y is a finite outcome set; pi_S, pi_B are
explicit categoricals and r an explicit reward vector, so the optimal
tilted policy pi_{beta,B}, chi^2, CV and every bound are in closed form,
while GSI itself is simulated as Algorithm 1, vectorized over many trials.
The closed forms come from the reference's numpy draws, so they are the
reference's numbers; the simulations draw from a ``torch.Generator`` (on
the environment's device), so they agree with the reference in
distribution, not draw for draw.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.sbon import soft_bon_select
from repro_torch.core.tilting import tilted_policy
from repro_torch.device import resolve_device


class GSITrials(NamedTuple):
    outcomes: torch.Tensor        # (T,) final outcome per trial (with rejection)
    outcomes_tilde: torch.Tensor  # (T,) outcome of pi~_GSI (no rejection)
    accept: torch.Tensor          # (T,) acceptance indicator


class ToyEnv:
    def __init__(self, m: int = 12, *, seed: int = 0, skew: float = 1.5,
                 reward_seed=None, device="cuda"):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # draft is a smoothed/perturbed version of the base => finite chi^2
        logits_b = rng.normal(0, skew, m)
        logits_s = logits_b + rng.normal(0, skew / 2, m)
        self.pi_B = self._f32(_softmax(logits_b))
        self.pi_S = self._f32(_softmax(0.7 * logits_s))
        rr = np.random.default_rng(
            seed if reward_seed is None else reward_seed)
        r = rr.uniform(0, 1, m).astype(np.float32)
        self.r = self._f32(r)
        # golden reward: noisy monotone transform of r (r "approximates" r*)
        self.r_star = self._f32(
            np.clip(r + rr.normal(0, 0.1, m).astype(np.float32), 0, 1))
        self.m = m

    def _f32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    # -- closed forms -------------------------------------------------------
    def tilted(self, beta: float):
        return tilted_policy(self.pi_B, self.r, beta)

    @property
    def chi2(self):
        return theory.chi2_divergence(self.pi_B, self.pi_S)

    def cv(self, beta: float):
        return theory.coefficient_of_variation(self.pi_B, self.r, beta)

    def expected_golden(self, policy):
        return torch.sum(policy * self.r_star)

    # -- Algorithm 1, vectorized over trials --------------------------------
    def _draw(self, gen, pi, trials: int, n: int):
        """(trials, n) i.i.d. outcomes of the categorical ``pi``."""
        return torch.multinomial(pi.expand(trials, self.m), n,
                                 replacement=True, generator=gen)

    def _sbon(self, gen, ys, scores, beta: float):
        """Soft best-of-n over each row's candidates: (outcome, score)."""
        idx = soft_bon_select(gen, scores, beta)[:, None]
        return (torch.gather(ys, 1, idx)[:, 0],
                torch.gather(scores, 1, idx)[:, 0])

    def run_gsi(self, gen, *, n: int, beta: float, u: float,
                trials: int = 200_000, n_target: int = 0) -> GSITrials:
        """Algorithm 1; n_target > 0 decouples the resampling-side n
        (the paper's flagged future-work knob)."""
        ys = self._draw(gen, self.pi_S, trials, n)          # draft candidates
        log_ratio = torch.log(self.pi_B) - torch.log(self.pi_S)
        r_t = self.r[ys] + log_ratio[ys] / beta              # (T,n)
        sel, sel_rt = self._sbon(gen, ys, r_t, beta)
        accept = sel_rt >= u
        # rejection branch: S-BoN with pi_B and raw rewards
        yb = self._draw(gen, self.pi_B, trials, n_target or n)
        selb, _ = self._sbon(gen, yb, self.r[yb], beta)
        return GSITrials(torch.where(accept, sel, selb), sel, accept)

    def run_rsd(self, gen, *, n: int, beta: float, threshold: float,
                trials: int = 200_000) -> GSITrials:
        ys = self._draw(gen, self.pi_S, trials, n)
        sel, sel_r = self._sbon(gen, ys, self.r[ys], beta)
        accept = sel_r >= threshold
        yb = self._draw(gen, self.pi_B, trials, n)
        selb, _ = self._sbon(gen, yb, self.r[yb], beta)
        return GSITrials(torch.where(accept, sel, selb), sel, accept)

    def run_sbon(self, gen, *, n: int, beta: float, base: bool,
                 trials: int = 200_000):
        """Plain S-BoN with pi_B (base=True) or pi_S."""
        ys = self._draw(gen, self.pi_B if base else self.pi_S, trials, n)
        return self._sbon(gen, ys, self.r[ys], beta)[0]

    # -- empirical distribution helpers -------------------------------------
    def histogram(self, outcomes):
        counts = torch.bincount(outcomes, minlength=self.m)
        return counts / outcomes.shape[0]


def _softmax(x):
    e = np.exp(x - np.max(x))
    return e / e.sum()
