"""The decoder model as an ``nn.Module``: full-sequence passes and decode
steps over dense or paged KV.

A port of ``repro.models.model.Model`` for the attention stacks and the
RWKV-6 (``ssm``) stacks:

* ``forward(tokens)`` — (B,S) tokens -> (logits (B,S,V), 0.0);
* ``hidden(tokens)`` — final hidden states (B,S,d);
* ``prefill(tokens, max_seq=0)`` — last-token logits (B,V) and per-layer
  dense caches (an RWKV layer's state dict) that ``decode_step`` continues
  from;
* ``score(tokens)`` — log pi(tokens[t] | tokens[<t]) for t >= 1, (B,S-1),
  through the fused vocabulary gather;
* ``reward(tokens)`` — the PRM head at every position, (B,S);
* ``decode_step(cache, tokens, positions, pt=None, live=None)`` — one
  token per row; the cache (a list with one dict per layer) is updated in
  place, and ``live`` (B,) freezes the recurrent state of rows where it is
  False;
* ``init_cache(batch, max_seq, pages=0, page_size=0)`` — dense rows or
  page pools;
* ``reward_from_hidden(h)`` — the PRM head.

Every attention layer of the full-sequence passes goes through the flash
kernel on a CUDA tensor, and every RWKV layer of every pass (decode steps
included) through the WKV6 scan kernel.  They run under
``torch.no_grad()``: the kernels have no backward yet, and training is a
later slice.  Encoder ``source`` inputs raise (no cross-attention family
is ported).

Parameters keep the reference's per-weight layouts (``wq (d,H,hd)``,
``wo (H,hd,d)``, ...) under flat names such as ``layers.3.attn.wq`` or
``layers.3.tm.wr``; layer ``L`` is the ``L``-th layer the reference applies
(see :func:`layer_slots`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import blocks
from repro_torch.models.common import (embed_specs, embed_tokens,
                                       init_params, norm_spec, rms_norm,
                                       rope_freqs, spec, unembed)


def layer_slots(cfg: ModelConfig) -> list:
    """``(kind, group, key, index)`` of every layer in execution order.

    The reference groups layers into scanned pattern blocks
    (``blocks/p{i}``, stacked ``index`` along a leading dim) followed by the
    unscanned remainder (``rem/r{i}``, ``index`` None); the bridge and the
    cache converters map port layer ``L`` to entry ``L`` of this list.
    An ``ssm`` stack is all ``rwkv`` layers, grouped as its pattern's
    length says (the reference's ``effective_pattern``).
    """
    pattern = tuple(cfg.layer_pattern)
    if cfg.family == "ssm":
        pattern = ("rwkv",) * len(pattern)
    n = len(pattern)
    repeats = cfg.num_layers // n if cfg.scan_layers else 0
    if cfg.scan_layers:
        remainder = pattern[:cfg.num_layers - repeats * n]
    else:
        remainder = tuple(pattern * (-(-cfg.num_layers // n)))[
            :cfg.num_layers]
    slots = [(kind, "blocks", f"p{i}", r)
             for r in range(repeats) for i, kind in enumerate(pattern)]
    slots += [(kind, "rem", f"r{i}", None) for i, kind in enumerate(remainder)]
    return slots


def param_specs(cfg: ModelConfig) -> dict:
    """Flat ``{name: ParamSpec}`` of the whole model."""
    out = {f"embed.{k}": s for k, s in embed_specs(cfg).items()}
    out["final_ln"] = norm_spec(cfg.d_model)
    for i, (kind, *_) in enumerate(layer_slots(cfg)):
        for k, s in blocks.block_specs(cfg, kind).items():
            out[f"layers.{i}.{k}"] = s
    if cfg.reward_head:
        out["reward_head.w"] = spec((cfg.d_model, 1), ("embed", None))
        out["reward_head.b"] = spec((1,), (None,), "zeros")
    return out


def random_params(cfg: ModelConfig, seed: int, device) -> dict:
    """Seeded random weights at the config's shapes, made on ``device``."""
    return init_params(param_specs(cfg), seed, getattr(torch, cfg.param_dtype),
                       device)


def _frozen(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer's weights: ``ln1``, ``ln2`` and, for each group of dotted
    names (``attn.*`` and ``ffn.*``, or ``tm.*`` and ``cm.*``), a
    ``ParameterDict``; ``block["attn"]`` etc. for ``blocks.block_apply``."""

    def __init__(self, kind: str, tensors: dict):
        super().__init__()
        self.kind = kind
        groups: dict = {}
        for name, t in tensors.items():
            group, _, leaf = name.partition(".")
            if leaf:
                groups.setdefault(group, {})[leaf] = _frozen(t)
            else:
                setattr(self, name, _frozen(t))
        for group, leaves in groups.items():
            setattr(self, group, nn.ParameterDict(leaves))

    def __getitem__(self, name):
        return getattr(self, name)


class Model(nn.Module):
    """A decoder stack holding ``params`` (``{name: tensor}``, see
    :func:`param_specs`); tensors already on ``device`` are not copied."""

    def __init__(self, cfg: ModelConfig, params: dict, *, device=None):
        super().__init__()
        specs = param_specs(cfg)
        if set(params) != set(specs):
            raise KeyError(
                f"{cfg.name}: parameter names differ from the config's; "
                f"missing {sorted(set(specs) - set(params))[:4]}, "
                f"unexpected {sorted(set(params) - set(specs))[:4]}")
        tensors = {}
        for name, s in specs.items():
            t = params[name] if device is None else params[name].to(device)
            if tuple(t.shape) != s.shape:
                raise ValueError(f"{cfg.name}: {name} has shape "
                                 f"{tuple(t.shape)}, config wants {s.shape}")
            tensors[name] = t
        self.cfg = cfg
        self.kinds = [kind for kind, *_ in layer_slots(cfg)]
        self.embed = nn.ParameterDict(
            {k[6:]: _frozen(v) for k, v in tensors.items()
             if k.startswith("embed.")})
        self.final_ln = _frozen(tensors["final_ln"])
        self.layers = nn.ModuleList()
        for i, kind in enumerate(self.kinds):
            pre = f"layers.{i}."
            self.layers.append(Block(kind, {
                k[len(pre):]: v for k, v in tensors.items()
                if k.startswith(pre)}))
        if cfg.reward_head:
            self.reward_head = nn.ParameterDict(
                {"w": _frozen(tensors["reward_head.w"]),
                 "b": _frozen(tensors["reward_head.b"])})
        self.register_buffer("rope_freqs", torch.as_tensor(
            rope_freqs(cfg.head_dim, cfg.rope_theta),
            device=self.final_ln.device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.final_ln.device

    def _run_stack(self, x, *, mode, positions, cache=None, max_seq=0,
                   window_override=0, pt=None, pos32=None, live=None):
        """Every layer in ``mode``, then the final norm; returns the hidden
        states and the per-layer caches the blocks return."""
        cfg = self.cfg
        caches = []
        for i, layer in enumerate(self.layers):
            x, c = blocks.block_apply(
                cfg, layer.kind, layer, x, mode=mode, positions=positions,
                freqs=self.rope_freqs,
                cache=None if cache is None else cache[i],
                window_override=window_override, max_seq=max_seq, pt=pt,
                pos32=pos32, live=live)
            caches.append(c)
        return rms_norm(x, self.final_ln, cfg.norm_eps), caches

    def _full_sequence(self, tokens, source, **kw):
        if source is not None:
            raise NotImplementedError(
                "encoder / cross-attention sources are not ported yet")
        x = embed_tokens(self.cfg, self.embed, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        return self._run_stack(x, positions=positions, **kw)

    @torch.no_grad()
    def forward(self, tokens, *, source=None):
        """Training-shaped forward: (B,S) tokens -> (logits (B,S,V), 0.0)
        (no MoE family is ported, so the auxiliary loss is 0)."""
        x, _ = self._full_sequence(tokens, source, mode="train")
        return unembed(self.cfg, self.embed, x), 0.0

    @torch.no_grad()
    def hidden(self, tokens, *, source=None):
        """Final hidden states (B,S,d), read by ``score`` and ``reward``."""
        return self._full_sequence(tokens, source, mode="train")[0]

    @torch.no_grad()
    def prefill(self, tokens, *, source=None, max_seq: int = 0):
        """(B,S) tokens -> (last-token logits (B,V), cache): one dense
        ``{'k','v'}`` cache per attention layer with ``max_seq`` (default S)
        rows, or a ring buffer for a sliding-window layer, and the state
        dict of each RWKV layer, which ``decode_step`` continues from at
        position S."""
        cfg = self.cfg
        x, cache = self._full_sequence(
            tokens, source, mode="prefill", max_seq=max_seq or tokens.shape[1],
            window_override=cfg.serve_window_override)
        return unembed(cfg, self.embed, x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def score(self, tokens, *, source=None):
        """log pi(tokens[t] | tokens[<t]) for t >= 1 -> (B, S-1) float32.

        One full-sequence pass and the fused log-softmax gather; a tied
        embedding is read through its transpose's strides, never copied.
        """
        h = self.hidden(tokens[:, :-1], source=source)
        emb = self.embed
        w = emb["unembed"] if "unembed" in emb else emb["embedding"].T
        return ops.logprob_gather(h, w, tokens[:, 1:], self.cfg.vocab_size)

    @torch.no_grad()
    def reward(self, tokens, *, source=None):
        """PRM: per-position reward in [0,1] -> (B,S)."""
        if not self.cfg.reward_head:
            raise ValueError(f"{self.cfg.name}: reward() needs "
                             f"cfg.reward_head")
        return self.reward_from_hidden(self.hidden(tokens, source=source))

    @torch.no_grad()
    def decode_step(self, cache, tokens, positions, *,
                    return_hidden: bool = False, pt=None, live=None):
        """One serving step: tokens (B,1), positions (B,) -> logits (B,V).

        Writes each attention layer's K/V for ``positions`` and each RWKV
        layer's new state into ``cache`` in place; ``live`` (B,) bool keeps
        the old RWKV state of rows where it is False (finished requests,
        slots passing through an admission), as the reference's freeze.
        ``pt`` (B, nblk1) int32 routes every attention layer through the
        paged kernel.  ``return_hidden`` also returns the final hidden state
        (B,d), which the PRM reward head reads.
        """
        cfg = self.cfg
        x = embed_tokens(cfg, self.embed, tokens)
        x, _ = self._run_stack(
            x, mode="decode", positions=positions, cache=cache,
            window_override=cfg.serve_window_override, pt=pt,
            pos32=None if pt is None else positions.to(torch.int32),
            live=live)
        logits = unembed(cfg, self.embed, x)[:, 0]
        if return_hidden:
            return logits, x[:, 0]
        return logits

    @torch.no_grad()
    def reward_from_hidden(self, h):
        """PRM head on a hidden state (..., d) -> reward in [0,1]."""
        rh = self.reward_head
        logit = (h.float() @ rh["w"].float())[..., 0] + rh["b"].float()
        return torch.sigmoid(logit)

    def init_cache(self, batch: int, max_seq: int, *, pages: int = 0,
                   page_size: int = 0, kv_dtype=None) -> list:
        """Zeroed per-layer caches on the model's device; ``pages > 0``
        selects the paged layout (page pools shared by all rows, stored as
        ``kv_dtype``, see :mod:`repro_torch.kernels.quant`)."""
        return [blocks.init_block_cache(self.cfg, kind, batch, max_seq,
                                        device=self.device, pages=pages,
                                        page_size=page_size,
                                        kv_dtype=kv_dtype)
                for kind in self.kinds]
