"""(Soft) best-of-n selection (Verdun et al., 2025; Beirami et al., 2025)."""
from __future__ import annotations

import torch

from repro_torch.sampling.sampler import gumbel_noise


def soft_bon_select(gen, rewards, beta: float, gumbel=None):
    """Sample index i ~ softmax(beta * rewards) per row: argmax of the
    logits plus Gumbel noise (from ``gen``, or ``gumbel`` when given).

    rewards: (..., n) -> indices (...,).  beta -> inf recovers hard BoN,
    beta -> 0 uniform choice.
    """
    logits = beta * rewards.float()
    if gumbel is None:
        gumbel = gumbel_noise(gen, logits.shape, logits.device)
    return torch.argmax(logits + gumbel, dim=-1)


def hard_bon_select(rewards):
    """argmax_i r_i (greedy best-of-n)."""
    return torch.argmax(rewards, dim=-1)


def soft_bon_weights(rewards, beta: float):
    """softmax(beta * rewards) over the candidates."""
    return torch.softmax(beta * rewards.float(), dim=-1)
