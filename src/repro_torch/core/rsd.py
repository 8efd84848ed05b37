"""Reward-guided speculative decoding baseline (Liao et al., 2025): raw PRM
rewards, no likelihood-ratio tilting, raw-reward acceptance threshold."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sbon import soft_bon_select


class RSDDecision(NamedTuple):
    index: torch.Tensor
    selected_reward: torch.Tensor
    accept: torch.Tensor


def rsd_select(gen, rewards, *, beta: float, threshold: float,
               gumbel=None) -> RSDDecision:
    """rewards: (B, n) raw PRM rewards of the draft candidates."""
    idx = soft_bon_select(gen, rewards, beta, gumbel=gumbel)
    sel = torch.gather(rewards.float(), 1, idx[:, None])[:, 0]
    return RSDDecision(idx, sel, sel >= threshold)
