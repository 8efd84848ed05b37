"""GQA self-attention: full-sequence (train/prefill) and decode modes.

A port of ``repro.models.attention`` for the self-attention kinds.

* ``train`` / ``prefill``: full-sequence causal (or sliding-window)
  attention through :func:`repro_torch.kernels.ops.flash_attention`, so a
  CUDA tensor reaches the hand-written flash kernel; ``prefill`` also
  returns the layer's dense cache, padded to capacity or, for a local
  layer whose window is shorter than the prefill, as a ring buffer.
* ``decode``: one token against the cache, updated **in place**: the dense
  rows of the request's own slot, or the page-pool rows the block table
  resolves ``pos`` to.  Every paged call goes through
  :func:`repro_torch.kernels.ops.paged_attention` (or
  ``paged_attention_quant`` for int8/fp8 pools).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, quant
from repro_torch.models.common import adtype, apply_rope, spec

NEG_INF = -1e30


def attn_specs(cfg):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": spec((d, H, hd), ("embed", "heads", "head")),
        "wk": spec((d, KV, hd), ("embed", "kv", "head")),
        "wv": spec((d, KV, hd), ("embed", "kv", "head")),
        "wo": spec((H, hd, d), ("heads", "head", "embed")),
    }


def gqa_attention(q, k, v, mask, scale):
    """q: (B,Sq,H,hd) k/v: (B,Sk,KV,hd) mask: (B or 1, Sq, Sk) boolean."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    scores = scores + torch.where(mask, 0.0, NEG_INF)[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def _cache_len(cfg, kind: str, max_seq: int) -> int:
    if kind == "local" or (cfg.serve_window_override and kind == "full"):
        w = cfg.window_size if kind == "local" else cfg.serve_window_override
        return min(w, max_seq)
    return max_seq


def init_self_cache(cfg, kind: str, batch: int, max_seq: int, device):
    """Zeroed dense cache for one attention layer: (B, S, KV, hd) rows."""
    shape = (batch, _cache_len(cfg, kind, max_seq), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=adtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=adtype(cfg), device=device)}


def init_paged_self_cache(cfg, total_pages: int, page_size: int, device,
                          kv_dtype=None):
    """Paged cache for one attention layer: K/V page pools, no batch dim.

    Positions are stored absolutely for every layer kind: the page of
    position p is block-table entry ``p // page_size``.  ``kv_dtype`` picks
    the pool format (:mod:`repro_torch.kernels.quant`): ``None`` keeps the
    activation dtype, ``"bf16"`` casts, and ``"int8"`` / ``"fp8"`` store
    codes plus ``ks``/``vs`` float32 scales shaped ``(P, KV)``.
    """
    shape = (total_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = quant.pool_dtype(kv_dtype, adtype(cfg))
    out = {"kp": torch.zeros(shape, dtype=dt, device=device),
           "vp": torch.zeros(shape, dtype=dt, device=device)}
    if quant.is_quantized(kv_dtype):
        for key in ("ks", "vs"):
            out[key] = torch.zeros((total_pages, cfg.num_kv_heads),
                                   dtype=torch.float32, device=device)
    return out


def self_attention(cfg, p, x, *, kind: str, mode: str, positions, freqs,
                   cache=None, window_override: int = 0, max_seq: int = 0,
                   pt=None, pos32=None):
    """Returns ``(out, cache)``.

    positions: (S,) for train/prefill (shared across the batch), (B,) for
    decode; ``freqs`` the model's RoPE frequencies.  ``train`` returns no
    cache, ``prefill`` a new dense ``{'k','v'}`` cache of capacity
    ``max_seq`` (default S), ``decode`` the given cache, written in place:
    ``pt`` (B, nblk1) selects the paged path when it holds page pools
    ({'kp','vp'}); ``pos32`` is ``positions`` as int32 for the kernel
    (computed once per decode step).
    """
    B, S = x.shape[:2]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d = cfg.d_model
    scale = hd ** -0.5
    window = cfg.window_size if kind == "local" else 0
    if window_override:
        window = window_override if window == 0 else min(window,
                                                         window_override)

    q = (x @ p["wq"].reshape(d, H * hd).to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].reshape(d, KV * hd).to(x.dtype)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].reshape(d, KV * hd).to(x.dtype)).reshape(B, S, KV, hd)
    if mode in ("train", "prefill"):
        pos = positions[None, :]                         # (1, S)
        q = apply_rope(q, pos, freqs)
        k = apply_rope(k, pos, freqs)
        # the flash kernel on a CUDA tensor (no switch sends it elsewhere),
        # its plain version, the reference's causal-mask einsum, on the CPU
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  scale=scale)
        if mode == "prefill":
            cache = _fill_cache(cfg, kind, k, v, max_seq or S)
        else:
            cache = None
    elif mode == "decode":
        pos_b = positions[:, None]
        q = apply_rope(q, pos_b, freqs)
        k = apply_rope(k, pos_b, freqs)
        if pt is not None and "kp" in cache:
            if pos32 is None:
                pos32 = positions.to(torch.int32)
            if "ks" in cache:
                _write_cache_paged_quant(cache, k, v, positions, pt)
                out = ops.paged_attention_quant(
                    q, cache["kp"], cache["vp"], cache["ks"], cache["vs"],
                    pt, pos32, window=window, scale=scale)
            else:
                _write_cache_paged(cache, k, v, positions, pt)
                out = ops.paged_attention(q, cache["kp"], cache["vp"], pt,
                                          pos32, window=window, scale=scale)
        else:
            _write_cache(cache, k, v, positions)
            mask = _decode_mask(cache["k"].shape[1], positions,
                                ring=(window > 0))
            out = gqa_attention(q, cache["k"], cache["v"], mask, scale)
    else:
        raise ValueError(f"attention mode {mode!r}: train, prefill or "
                         f"decode")
    y = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, d).to(x.dtype)
    return y, cache


def _fill_cache(cfg, kind, k, v, max_seq):
    """The capacity-sized dense cache from prefill keys (rope'd) and
    values: zero-padded past S, or a ring buffer when the layer keeps fewer
    rows than S (slot j holds the latest position p with p % size == j)."""
    B, S, KV, hd = k.shape
    size = _cache_len(cfg, kind, max_seq)
    if size > S:             # decode continues writing at pos >= S
        out = {}
        for name, t in (("k", k), ("v", v)):
            full = t.new_zeros((B, size, KV, hd))
            full[:, :S] = t
            out[name] = full
        return out
    if size == S:
        return {"k": k, "v": v}
    start = S - size
    idx = start + (torch.arange(size, device=k.device) - start) % size
    return {"k": k[:, idx], "v": v[:, idx]}


def _write_cache(cache, k, v, positions):
    """Write the new (B,1,KV,hd) kv at per-request slots (ring aware)."""
    size = cache["k"].shape[1]
    rows = torch.arange(k.shape[0], device=k.device)
    slots = positions % size
    cache["k"][rows, slots] = k[:, 0]
    cache["v"][rows, slots] = v[:, 0]


def _write_cache_paged(cache, k, v, positions, pt):
    """Write the new (B,1,KV,hd) kv through the block table, in place.

    Physical row of position p for request b is
    ``pt[b, p // ps] * ps + p % ps``.  Rows that are done (or never
    admitted) resolve to scratch or trash pages the host allocator set up,
    so the unconditional write never lands in a page another row reads.
    """
    kp, vp = cache["kp"], cache["vp"]
    P, ps = kp.shape[0], kp.shape[1]
    blk = torch.clamp(positions // ps, max=pt.shape[1] - 1)
    page = torch.gather(pt, 1, blk[:, None].long())[:, 0].long()
    rows = page * ps + positions % ps                          # (B,)
    kp.view(P * ps, *kp.shape[2:])[rows] = k[:, 0].to(kp.dtype)
    vp.view(P * ps, *vp.shape[2:])[rows] = v[:, 0].to(vp.dtype)


def _write_cache_paged_quant(cache, k, v, positions, pt):
    """Quantized paged write, in place: re-quantize each touched page whole.

    Request b's new (KV,hd) key/value lands in page ``pt[b, pos // ps]`` at
    row ``pos % ps``.  The page is read back and dequantized with its
    current scale, the new row inserted, the rows beyond it zeroed (stale
    content of an earlier occupant must not inflate the amax), and the page
    re-quantized against a fresh per-kv-head scale ``amax / QMAX``: the
    reference's plain-jnp write, op for op, so codes and scales come out bit
    for bit the same.  Duplicate page indices occur only for the shared
    trash page, whose content is garbage by design.
    """
    ps = cache["kp"].shape[1]
    dt = cache["kp"].dtype
    qmax = quant.QMAX["int8"] if dt == torch.int8 else quant.QMAX["fp8"]
    blk = torch.clamp(positions // ps, max=pt.shape[1] - 1)
    page = torch.gather(pt, 1, blk[:, None].long())[:, 0].long()   # (B,)
    row = positions % ps
    lane = torch.arange(ps, device=positions.device)[None, :]
    at_row = (lane == row[:, None])[:, :, None, None]
    valid = (lane <= row[:, None])[:, :, None, None]
    for pool_key, sc_key, new in (("kp", "ks", k), ("vp", "vs", v)):
        pool, sc = cache[pool_key], cache[sc_key]
        fp = pool[page].float() * sc[page][:, None, :, None]
        fp = torch.where(at_row, new[:, 0].float()[:, None], fp)
        fp = torch.where(valid, fp, 0.0)
        amax = fp.abs().amax(dim=(1, 3))                       # (B, KV)
        nsc = torch.clamp(amax, min=quant.EPS) / qmax
        pool[page] = quant.quantize_codes(fp / nsc[:, None, :, None], dt)
        sc[page] = nsc


def _decode_mask(sk: int, positions, *, ring: bool):
    """(B,1,Sk) validity mask for decode against a (ring) cache."""
    slots = torch.arange(sk, device=positions.device)[None]
    pos = positions[:, None]
    if not ring:
        return (slots <= pos)[:, None]
    filled = (slots <= pos) | (pos >= sk)
    return filled[:, None]
