"""Reward tilting — the central identity of GSI (paper §4).

pi_{beta,B}(y|x) ∝ pi_S(y|x) exp(beta * r~(x,y)) with
r~ = r + (1/beta) * log(pi_B / pi_S), so soft best-of-n over draft samples
with the tilted rewards approximates the tilted target policy
(Theorem 1).  A port of ``repro.core.tilting``.
"""
from __future__ import annotations

import torch


def tilted_rewards(r, logp_B, logp_S, beta: float):
    """r~ = r + (log pi_B - log pi_S) / beta  (elementwise)."""
    return r.float() + (logp_B.float() - logp_S.float()) / beta


def _tilted_logits(pi_B, r, beta: float):
    return torch.log(torch.clamp(pi_B, min=1e-38)) + beta * r


def tilted_policy(pi_B, r, beta: float):
    """Exact tilted categorical pi_{beta,B} ∝ pi_B * exp(beta r).

    pi_B: (..., m) probabilities; r: (..., m) rewards.
    """
    return torch.softmax(_tilted_logits(pi_B, r, beta), dim=-1)


def log_partition(pi_B, r, beta: float):
    """log Z_{beta,B} = log E_{pi_B}[e^{beta r}]."""
    return torch.logsumexp(_tilted_logits(pi_B, r, beta), dim=-1)
