"""AdamW + cosine schedule + global-norm clipping over flat parameter dicts.

A port of ``repro.optim.adamw``, step for step: the schedule and the bias
corrections in float32, the moments kept in ``opt_state_dtype`` and
updated in fp32, clipped gradients and new parameters cast back to their
own dtypes.  Written in tensor ops rather than ``torch.optim.AdamW``, whose
order of operations and rounding differ.  The parameters are updated in
place (their storage is reused, so a step holds one copy of the weights);
``update`` also returns them, as the reference's functional update does.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.config import TrainConfig


def cosine_schedule(tcfg: TrainConfig) -> Callable:
    """step -> learning rate (float32 tensor): linear warmup, then a cosine
    decay to 0 at ``total_steps``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = tcfg.learning_rate * step / max(1, tcfg.warmup_steps)
        frac = torch.clamp((step - tcfg.warmup_steps)
                           / max(1, tcfg.total_steps - tcfg.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac)) * tcfg.learning_rate
        return torch.where(step < tcfg.warmup_steps, warm, cos)
    return lr


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))`` of the
    global fp32 norm; returns (clipped grads in their dtypes, norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


class AdamW:
    """Stateless namespace: ``init`` / ``update`` over ``{name: tensor}``."""

    def __init__(self, tcfg: TrainConfig):
        self.cfg = tcfg
        self.lr_fn = cosine_schedule(tcfg)

    def init(self, params: dict) -> dict:
        dt = getattr(torch, self.cfg.opt_state_dtype)
        return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                      for k, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """One AdamW step; writes the new parameters (and moments) in place
        and returns ``(params, state, {"grad_norm", "lr"})``."""
        c = self.cfg
        grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
        count = state["count"] + 1
        b1, b2 = c.beta1, c.beta2
        dt = getattr(torch, c.opt_state_dtype)
        lr = self.lr_fn(count)
        # float32 scalars, as the reference computes them; a Python float
        # holds each exactly and enters the ops below as float32
        n = torch.tensor(count, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** n)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** n)
        step = float(lr)
        for k, p in params.items():
            g32 = grads[k].float()
            m = state["m"][k]
            v = state["v"][k]
            m.copy_((b1 * m.float() + (1 - b1) * g32).to(dt))
            v.copy_((b2 * v.float() + (1 - b2) * g32 * g32).to(dt))
            mh = m.float() / bc1
            vh = v.float() / bc2
            p32 = p.float()
            delta = mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p32
            p.copy_((p32 - step * delta).to(p.dtype))
        state["count"] = count
        return params, state, {"grad_norm": gnorm, "lr": lr}
