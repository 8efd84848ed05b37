"""Decoder and encoder blocks: pre-norm self-attention + SwiGLU or MoE FFN
(``full``/``local``), the same with a pre-norm cross-attention step to a
source sequence between them (``cross``), bidirectional self-attention
(``enc``, the encoder stack's layers), pre-norm RG-LRU + FFN
(``recurrent``, the hybrid family) and RWKV-6 time-mix + channel-mix
(``rwkv``, the ssm family).

A port of ``repro.models.blocks``, in the train, prefill and decode modes.
A config with experts (``num_experts > 0``) gets the mixture-of-experts
FFN of :mod:`repro_torch.models.moe` in every attention or recurrent
block, never a dense one.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import lru, moe, rwkv
from repro_torch.models.common import (adtype, ffn_apply, ffn_specs,
                                       norm_spec, rms_norm)

KINDS = ("full", "local", "cross", "enc", "recurrent", "rwkv")


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
    if kind == "recurrent":
        out.update({f"rec.{k}": s
                    for k, s in lru.recurrent_specs(cfg).items()})
    else:
        out.update({f"attn.{k}": s for k, s in attn.attn_specs(cfg).items()})
    if kind == "cross":
        out["lnx"] = norm_spec(d)
        out.update({f"xattn.{k}": s
                    for k, s in attn.cross_attn_specs(cfg).items()})
    ffn = moe.moe_specs(cfg) if cfg.num_experts else ffn_specs(d, cfg.d_ff)
    out.update({f"ffn.{k}": s for k, s in ffn.items()})
    return out


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, *, device,
                     pages: int = 0, page_size: int = 0,
                     kv_dtype=None) -> dict:
    """Zeroed decode cache of one block; ``pages > 0`` selects page pools
    stored as ``kv_dtype`` for attention.  RWKV and RG-LRU state and a
    cross layer's ``ck``/``cv`` (batch, S_src, KV, hd) stay dense per slot
    in either layout (O(1) or written once)."""
    check_kind(kind)
    if kind == "rwkv":
        return rwkv.init_rwkv_state(cfg, batch, device)
    if kind == "recurrent":
        return lru.init_lru_state(cfg, batch, device)
    if pages:
        c = attn.init_paged_self_cache(cfg, pages, page_size, device,
                                       kv_dtype)
    else:
        c = attn.init_self_cache(cfg, kind, batch, max_seq, device)
    if kind == "cross":
        shape = (batch, cfg.encoder_seq or cfg.cross_source_seq,
                 cfg.num_kv_heads, cfg.head_dim)
        c["ck"] = torch.zeros(shape, dtype=adtype(cfg), device=device)
        c["cv"] = torch.zeros_like(c["ck"])
    return c


def _freeze(live, new, old):
    """Per-row state freeze: ``old`` where ``live`` is False."""
    if live is None:
        return new
    mask = live.reshape((live.shape[0],) + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old.to(new.dtype))


def block_apply(cfg, kind: str, p, x, *, mode: str, positions, freqs,
                cache=None, window_override: int = 0, max_seq: int = 0,
                pt=None, pos32=None, live=None, source=None):
    """One block in ``mode``; returns ``(x, cache, aux)``, ``aux`` the MoE
    FFN's load-balance loss (0.0 for a dense FFN and for ``rwkv``).

    Attention kinds go through :func:`repro_torch.models.attention.
    self_attention` (a decode step writes the given cache in place; ``live``
    is ignored, as in the reference).  ``rwkv`` runs from ``cache`` (zeros
    when None); ``train`` returns no state, ``prefill`` the new state, and
    ``decode`` writes the new state into ``cache`` in place, keeping the
    old one in rows where ``live`` (B,) is False: the scan writes the
    ``wkv`` leaf itself, and the two token-shift leaves are frozen here.
    ``recurrent`` runs its RG-LRU from ``cache`` (zeros when None) with the
    same returns, a decode step writing ``h`` and ``conv`` in place under
    ``live``.  ``enc`` is a ``full`` block with bidirectional attention.
    ``cross`` is a ``full`` block with a cross-attention step after the
    self-attention: outside decode it projects ``source`` (B, S_src, d) to
    the cross KV, which ``prefill`` returns in the cache as ``ck``/``cv``
    beside ``k``/``v``; a decode step reads them from ``cache``.

    ``p`` maps ``ln1``, ``ln2`` and ``attn``/``rec``/``ffn`` (and ``lnx``,
    ``xattn`` for ``cross``) or ``tm``/``cm`` to the block's weights.
    """
    if kind == "rwkv":
        state = cache if cache is not None else rwkv.init_rwkv_state(
            cfg, x.shape[0], x.device)
        decode = mode == "decode"
        x, new = rwkv.rwkv_block(cfg, p, x, state, live,
                                 wkv_in_place=decode)
        if mode == "train":
            return x, None, 0.0
        if decode:
            for k in ("tm_prev", "cm_prev"):
                cache[k].copy_(_freeze(live, new[k], cache[k]))
            return x, cache, 0.0
        return x, new, 0.0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "recurrent":
        state = cache if cache is not None else lru.init_lru_state(
            cfg, x.shape[0], x.device)
        y, cache = lru.recurrent_block(cfg, p["rec"], h, state, live=live,
                                       in_place=mode == "decode")
        if mode == "train":
            cache = None
    else:
        # a decode step writes the self-attention rows of ``cache`` in place
        # and leaves a cross layer's ck/cv alone
        y, new = attn.self_attention(
            cfg, p["attn"], h, kind="full" if kind in ("cross", "enc")
            else kind, mode=mode, positions=positions, freqs=freqs,
            cache=cache, window_override=window_override, max_seq=max_seq,
            pt=pt, pos32=pos32, causal=kind != "enc")
        if kind == "cross":
            x = x + y
            h = rms_norm(x, p["lnx"], cfg.norm_eps)
            decode = mode == "decode"
            if not decode and source is None:
                raise ValueError(f"{cfg.name}: a cross layer needs a source "
                                 f"(B, S_src, d) outside decode")
            ckv = {k: cache[k] for k in ("ck", "cv")} if decode \
                else attn.compute_cross_kv(cfg, p["xattn"], source)
            y = attn.cross_attention(cfg, p["xattn"], h, ckv, decode=decode)
            if mode == "prefill":
                new.update(ckv)
        cache = new
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        y, aux = moe.moe_ffn(cfg, p["ffn"], h)
        return x + y, cache, aux
    return x + ffn_apply(p["ffn"], h), cache, 0.0
