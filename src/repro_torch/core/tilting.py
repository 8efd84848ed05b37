"""Reward tilting — the central identity of GSI (paper §4).

pi_{beta,B}(y|x) ∝ pi_S(y|x) exp(beta * r~(x,y)) with
r~ = r + (1/beta) * log(pi_B / pi_S), so soft best-of-n over draft samples
with the tilted rewards approximates the tilted target policy.
(``tilted_policy`` and ``log_partition`` arrive with ``core/theory.py``.)
"""
from __future__ import annotations


def tilted_rewards(r, logp_B, logp_S, beta: float):
    """r~ = r + (log pi_B - log pi_S) / beta  (elementwise)."""
    return r.float() + (logp_B.float() - logp_S.float()) / beta
