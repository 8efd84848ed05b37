"""GSI per-step decision (Algorithm 1, lines 4-6).

Tilted rewards, soft-BoN sample of the index, accept iff the selected tilted
reward clears the threshold u.  The resampling fallback lives in
``repro_torch.serving.gsi_engine``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sbon import soft_bon_select
from repro_torch.core.tilting import tilted_rewards


class GSIDecision(NamedTuple):
    index: torch.Tensor            # (B,) selected candidate i*
    tilted: torch.Tensor           # (B, n) tilted rewards r~
    selected_tilted: torch.Tensor  # (B,) r~_{i*}
    accept: torch.Tensor           # (B,) r~_{i*} >= u


def gsi_select(gen, rewards, logp_B, logp_S, *, beta: float,
               threshold_u: float, gumbel=None) -> GSIDecision:
    """rewards/logp_B/logp_S: (B, n) per draft candidate."""
    r_t = tilted_rewards(rewards, logp_B, logp_S, beta)
    idx = soft_bon_select(gen, r_t, beta, gumbel=gumbel)
    sel = torch.gather(r_t, 1, idx[:, None])[:, 0]
    return GSIDecision(idx, r_t, sel, sel >= threshold_u)
