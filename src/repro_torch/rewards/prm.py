"""Process reward models: a transformer with a scalar sigmoid head.

A port of ``repro.rewards.prm.PRM`` (rewards in [0,1], like
Qwen2.5-Math-PRM-7B in the paper).  Its rewards come from one full-sequence
pass, so every attention layer runs the flash kernel on the card.
``OracleRewardModel`` needs the synthetic task (``repro.data.synthetic``)
and arrives with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model


class PRM:
    """r(x, y): reward of a (prompt, partial-response) pair.

    ``params`` is the model's flat parameter dict (see
    :func:`repro_torch.models.param_specs`, or
    :func:`repro_torch.models.random_params` for seeded random weights);
    tensors already on ``device`` are not copied.
    """

    def __init__(self, cfg: ModelConfig, params, *, device="cuda"):
        if not cfg.reward_head:
            raise ValueError(f"{cfg.name}: a PRM needs cfg.reward_head")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, params, device=self.device)

    def reward_sequences(self, tokens, *, source=None):
        """(B,S) tokens -> (B,S) per-position process rewards."""
        tokens = torch.as_tensor(tokens, device=self.device)
        return self.model.reward(tokens, source=source)

    def reward_at_end(self, tokens, lengths, *, source=None):
        """Reward at the last real token of each sequence -> (B,)."""
        r = self.reward_sequences(tokens, source=source)
        idx = torch.as_tensor(lengths, device=r.device).long().clamp(min=1) - 1
        return torch.gather(r, 1, idx[:, None])[:, 0]
