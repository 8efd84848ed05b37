"""Decoder blocks: pre-norm self-attention + SwiGLU FFN (``full``/``local``)
and RWKV-6 time-mix + channel-mix (``rwkv``, the ssm family).

A port of ``repro.models.blocks`` for these kinds, in the train, prefill
and decode modes.  Recurrent, cross and encoder blocks belong to later
slices and raise.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import rwkv
from repro_torch.models.common import (ffn_apply, ffn_specs, norm_spec,
                                       rms_norm)

KINDS = ("full", "local", "rwkv")


def check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (only {KINDS})")


def block_specs(cfg, kind: str) -> dict:
    """Flat ``{name: ParamSpec}`` of one block (names relative to it)."""
    check_kind(kind)
    if kind == "rwkv":
        return rwkv.rwkv_block_specs(cfg)
    d = cfg.d_model
    out = {"ln1": norm_spec(d), "ln2": norm_spec(d)}
    out.update({f"attn.{k}": s for k, s in attn.attn_specs(cfg).items()})
    out.update({f"ffn.{k}": s for k, s in ffn_specs(d, cfg.d_ff).items()})
    return out


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, *, device,
                     pages: int = 0, page_size: int = 0,
                     kv_dtype=None) -> dict:
    """Zeroed decode cache of one block; ``pages > 0`` selects page pools
    stored as ``kv_dtype`` for attention.  RWKV state stays dense per slot
    in either layout."""
    check_kind(kind)
    if kind == "rwkv":
        return rwkv.init_rwkv_state(cfg, batch, device)
    if pages:
        return attn.init_paged_self_cache(cfg, pages, page_size, device,
                                          kv_dtype)
    return attn.init_self_cache(cfg, kind, batch, max_seq, device)


def _freeze(live, new, old):
    """Per-row state freeze: ``old`` where ``live`` is False."""
    if live is None:
        return new
    mask = live.reshape((live.shape[0],) + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old.to(new.dtype))


def block_apply(cfg, kind: str, p, x, *, mode: str, positions, freqs,
                cache=None, window_override: int = 0, max_seq: int = 0,
                pt=None, pos32=None, live=None):
    """One block in ``mode``; returns ``(x, cache)``.

    Attention kinds go through :func:`repro_torch.models.attention.
    self_attention` (a decode step writes the given cache in place; ``live``
    is ignored, as in the reference).  ``rwkv`` runs from ``cache`` (zeros
    when None); ``train`` returns no state, ``prefill`` the new state, and
    ``decode`` writes the new state into ``cache`` in place, keeping the
    old one in rows where ``live`` (B,) is False.

    ``p`` maps ``ln1``, ``ln2`` and ``attn``/``ffn`` or ``tm``/``cm`` to
    the block's weights.
    """
    if kind == "rwkv":
        state = cache if cache is not None else rwkv.init_rwkv_state(
            cfg, x.shape[0], x.device)
        x, new = rwkv.rwkv_block(cfg, p, x, state)
        if mode == "train":
            return x, None
        if mode == "decode":
            for k, leaf in cache.items():
                leaf.copy_(_freeze(live, new[k], leaf))
            return x, cache
        return x, new
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, cache = attn.self_attention(
        cfg, p["attn"], h, kind=kind, mode=mode, positions=positions,
        freqs=freqs, cache=cache, window_override=window_override,
        max_seq=max_seq, pt=pt, pos32=pos32)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h), cache
