"""Pre-norm decoder block: self-attention + SwiGLU FFN (``full``/``local``).

A port of ``repro.models.blocks`` for the attention kinds, in the train,
prefill and decode modes.  Recurrent, RWKV, cross and encoder blocks belong
to later slices and raise.
"""
from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models.common import (ffn_apply, ffn_specs, norm_spec,
                                       rms_norm)

KINDS = ("full", "local")


def check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (only {KINDS})")


def block_specs(cfg, kind: str) -> dict:
    """Flat ``{name: ParamSpec}`` of one block (names relative to it)."""
    check_kind(kind)
    d = cfg.d_model
    out = {"ln1": norm_spec(d), "ln2": norm_spec(d)}
    out.update({f"attn.{k}": s for k, s in attn.attn_specs(cfg).items()})
    out.update({f"ffn.{k}": s for k, s in ffn_specs(d, cfg.d_ff).items()})
    return out


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, *, device,
                     pages: int = 0, page_size: int = 0,
                     kv_dtype=None) -> dict:
    """Zeroed decode cache of one block; ``pages > 0`` selects page pools
    stored as ``kv_dtype``."""
    check_kind(kind)
    if pages:
        return attn.init_paged_self_cache(cfg, pages, page_size, device,
                                          kv_dtype)
    return attn.init_self_cache(cfg, kind, batch, max_seq, device)


def block_apply(cfg, kind: str, p, x, *, mode: str, positions, freqs,
                cache=None, window_override: int = 0, max_seq: int = 0,
                pt=None, pos32=None):
    """One block in ``mode``; returns ``(x, cache)`` as
    :func:`repro_torch.models.attention.self_attention` does (a decode
    step writes the given cache in place).

    ``p`` maps ``ln1``, ``ln2``, ``attn`` and ``ffn`` to the block's weights.
    """
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, cache = attn.self_attention(
        cfg, p["attn"], h, kind=kind, mode=mode, positions=positions,
        freqs=freqs, cache=cache, window_override=window_override,
        max_seq=max_seq, pt=pt, pos32=pos32)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h), cache
