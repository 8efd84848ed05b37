"""Training loop: LM cross-entropy and PRM regression train steps.

A port of ``repro.train.trainer``.  The reference's train step is a pure
function of a parameter pytree, jitted; here a step runs eagerly over a
:class:`~repro_torch.models.Model` built with ``trainable=True``: the loss
is a full-sequence pass with autograd on (flash attention's backward
kernel in every attention layer on the card), ``torch.autograd.grad``
gives the gradients, and :class:`~repro_torch.optim.AdamW` writes the new
parameters into the model's own tensors.  A model with experts adds
``router_aux_weight`` times its layers' summed load-balance loss to the LM
loss, as the reference does.  A model with cross layers trains on batches
that carry a ``source`` (patch or frame embeddings, (B, S_src, d)),
through ``make_train_step(..., with_source=True)``: the encoder and every
cross layer's non-causal attention go through flash attention's forward
and backward kernels on the card too.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model, random_params
from repro_torch.optim import AdamW


def lm_loss(model, batch, *, source=None):
    """Next-token CE over loss_mask positions (+ the weighted MoE aux loss,
    0 without experts)."""
    tokens = batch["tokens"]
    mask = batch["loss_mask"][:, :-1]
    logits, aux = model.forward(tokens[:, :-1], source=source)
    labels = tokens[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - picked
    n = torch.sum(mask)
    loss = torch.sum(nll * mask) / torch.clamp(n, min=1.0)
    total = loss + model.cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": n}


def prm_loss(model, batch):
    """BCE of the reward head vs golden process rewards at step ends."""
    r = model.reward(batch["tokens"])                  # (B,S)
    y = batch["reward_labels"]
    m = batch["reward_mask"]
    eps = 1e-6
    bce = -(y * torch.log(r + eps) + (1 - y) * torch.log(1 - r + eps))
    n = torch.sum(m)
    loss = torch.sum(bce * m) / torch.clamp(n, min=1.0)
    return loss, {"loss": loss, "aux_loss": torch.zeros((), device=r.device),
                  "tokens": n}


def _make_step(model: Model, tcfg: TrainConfig, loss_fn) -> Callable:
    opt = AdamW(tcfg)

    def train_step(params, opt_state, batch):
        total, metrics = loss_fn(model, batch)
        # a parameter the loss does not read (the PRM's unembedding under
        # prm_loss) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_train_step(model: Model, tcfg: TrainConfig,
                    with_source: bool = False) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)`` for
    the LM loss; ``params`` is ``dict(model.named_parameters())``, updated
    in place (the reference's step takes the config and returns new
    arrays).  ``with_source`` passes ``batch["source"]`` to the model."""
    if with_source:
        def loss(model, batch):
            return lm_loss(model, batch, source=batch["source"])
        return _make_step(model, tcfg, loss)
    return _make_step(model, tcfg, lm_loss)


def make_prm_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """The same for the PRM's BCE loss."""
    return _make_step(model, tcfg, prm_loss)


class Trainer:
    """Host-side training loop (single process; used by the CLIs,
    ``chip_smoke.py`` and the tests).

    Starts from ``params`` (a flat dict, copied onto ``device``) when given,
    else from ``random_params(cfg, tcfg.seed, device)``.  Batches are dicts
    of numpy arrays (or tensors) moved to the device each step.  A model
    with cross layers trains the LM loss on each batch's ``source``.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *, prm=False,
                 params: Optional[dict] = None, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if params is None:
            params = random_params(cfg, tcfg.seed, self.device)
        else:
            params = {k: v.detach().to(self.device, copy=True)
                      for k, v in params.items()}
        self.model = Model(cfg, params, trainable=True)
        self.params = dict(self.model.named_parameters())
        self.opt = AdamW(tcfg)
        self.opt_state = self.opt.init(self.params)
        self._step = make_prm_train_step(self.model, tcfg) if prm \
            else make_train_step(self.model, tcfg,
                                 with_source="cross" in self.model.kinds)
        self.history = []

    def _batch(self, batch: dict) -> dict:
        """A numpy batch as tensors on the device: token ids as int64,
        masks, labels and the source as float32 (the model casts a source
        to its activation dtype)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            out[k] = t.to(self.device, torch.long if k == "tokens"
                          else torch.float32)
        return out

    def step(self, batch: dict) -> dict:
        """One train step on ``batch``; returns its metrics (tensors)."""
        self.params, self.opt_state, m = self._step(
            self.params, self.opt_state, self._batch(batch))
        return m

    def fit(self, batches, steps: int, log_every: int = 50):
        for i, batch in enumerate(batches):
            if i >= steps:
                break
            m = self.step(batch)
            if i % log_every == 0 or i == steps - 1:
                self.history.append(
                    {"step": i, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
        return self.history
