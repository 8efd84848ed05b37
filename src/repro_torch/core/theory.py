"""Theorems 1 & 2: bounds, divergences and their Monte-Carlo estimators.

A port of ``repro.core.theory``, in float32 as the reference computes:
  * Theorem 1 n-bound and the KL bound it inverts (Appendix A.1),
  * Theorem 2 golden-reward gap bound (Appendix A.2),
  * S-BoN KL bound, eq. (2) (Verdun et al., 2025),
  * chi^2 Monte-Carlo estimator used for Table 4 (Appendix C.5).
Arguments may be tensors, numpy arrays or Python numbers.
"""
from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


# ---------------------------------------------------------------------------
# Exact divergences for categorical distributions (toy environment)
# ---------------------------------------------------------------------------

def kl_divergence(p, q, eps: float = 1e-12):
    p = torch.clamp(_f32(p), min=0.0)
    ratio = torch.log(torch.clamp(p, min=eps)) \
        - torch.log(torch.clamp(_f32(q), min=eps))
    return torch.sum(torch.where(p > 0, p * ratio, 0.0), dim=-1)


def chi2_divergence(p, q, eps: float = 1e-12):
    """chi^2(P || Q) = sum_y P(y)^2 / Q(y) - 1."""
    p = _f32(p)
    return torch.sum(torch.where(p > 0, p * p / torch.clamp(_f32(q), min=eps),
                                 0.0), dim=-1) - 1.0


# ---------------------------------------------------------------------------
# Theorem 1
# ---------------------------------------------------------------------------

def theorem1_n_bound(chi2, beta: float, r_max: float, eps: float):
    """Smallest n guaranteeing KL(pi_{beta,B} || pi~_GSI) <= eps."""
    num = (_f32(chi2) + 1.0) * torch.exp(_f32(2.0 * beta * r_max)) - 1.0
    return num / (torch.exp(_f32(eps)) - 1.0)


def theorem1_kl_bound(n, chi2, beta: float, r_max: float):
    """KL bound as a function of n (the last display of the A.1 proof)."""
    n = _f32(n)
    return torch.log((_f32(chi2) + 1.0) * torch.exp(_f32(2.0 * beta * r_max))
                     / n + (n - 1.0) / n)


def _moments(pi_B, r, beta: float):
    """E and Var of e^{beta r} under pi_B."""
    pi_B = _f32(pi_B)
    w = torch.exp(beta * _f32(r))
    e = torch.sum(pi_B * w, dim=-1)
    var = torch.sum(pi_B * (w - e[..., None]) ** 2, dim=-1)
    return e, var


def sbon_kl_bound(n, pi_B, r, beta: float):
    """Eq. (2): KL(pi_{beta,B} || pi^n_{beta,B}) <= log(1 + Var/(n E^2))."""
    e, var = _moments(pi_B, r, beta)
    return torch.log1p(var / (_f32(n) * e ** 2))


# ---------------------------------------------------------------------------
# Theorem 2
# ---------------------------------------------------------------------------

def coefficient_of_variation(pi_B, r, beta: float):
    """CV(e^{beta r}) under pi_B."""
    e, var = _moments(pi_B, r, beta)
    return torch.sqrt(var) / e


def theorem2_gap_bound(n, p_accept, chi2, cv, beta: float, r_max: float,
                       r_star_max: float):
    """E_{pi_{beta,B}}[r*] - E_{pi_GSI}[r*] <= this (Theorem 2, formal)."""
    n, p_accept, cv = _f32(n), _f32(p_accept), _f32(cv)
    term_a = torch.sqrt(p_accept) * torch.exp(_f32(beta * r_max)) \
        * torch.sqrt(_f32(chi2) + 1.0)
    term_b = (1.0 - p_accept) ** 0.25 * torch.sqrt(cv ** 2 + 1.0)
    return r_star_max / torch.sqrt(n) * (term_a + term_b)


# ---------------------------------------------------------------------------
# Monte-Carlo estimators (Appendix C.5, Table 4)
# ---------------------------------------------------------------------------

def chi2_mc_estimate(logp_B, logp_S):
    """(1/N) sum_i (exp(logp_B_i - logp_S_i) - 1)^2 with y_i ~ pi_S.

    The paper's per-step estimator: logp arrays of shape (N,).
    """
    ratio = torch.exp(torch.clamp(_f32(logp_B) - _f32(logp_S), -30.0, 30.0))
    return torch.mean((ratio - 1.0) ** 2)


def kl_mc_estimate(p_exact, empirical_counts, eps: float = 1e-9):
    """KL(P || Q_hat) with Q_hat from MC counts (add-eps smoothing)."""
    q = _f32(empirical_counts) + eps
    q = q / torch.sum(q, dim=-1, keepdim=True)
    return kl_divergence(p_exact, q)
