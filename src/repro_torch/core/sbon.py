"""(Soft) best-of-n selection (Verdun et al., 2025; Beirami et al., 2025)."""
from __future__ import annotations

import torch

from repro_torch.sampling.sampler import gumbel_noise


def soft_bon_select(gen, rewards, beta: float, gumbel=None):
    """Sample index i ~ softmax(beta * rewards) per row: argmax of the
    logits plus Gumbel noise (from ``gen``, or ``gumbel`` when given).

    rewards: (..., n) -> indices (...,).
    """
    logits = beta * rewards.float()
    if gumbel is None:
        gumbel = gumbel_noise(gen, logits.shape, logits.device)
    return torch.argmax(logits + gumbel, dim=-1)
