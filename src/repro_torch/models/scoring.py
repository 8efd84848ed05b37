"""Shared-prefix candidate scoring: n candidates against ONE committed cache.

A port of ``repro.models.scoring`` for the attention and RWKV kinds.  Each
candidate's queries attend jointly to the shared committed cache and to its
own prefix (a two-block softmax), so the committed prefix is read once per
request instead of once per candidate, and nothing is written to any cache.
The log-likelihood of every candidate token comes from the fused vocabulary
pass :func:`repro_torch.kernels.ops.logprob_gather` (the hand-written kernel
on a CUDA tensor); the joint-softmax attention stays plain torch, as the
reference leaves it to XLA.

Dtypes follow ``jnp``'s promotion: a dequantized (fp32) cache view under
bf16 activations promotes the attention output, and from there the rest of
the pass, to fp32.  An RWKV layer repeats its O(1) state n ways and runs
its block over the L + 1 feeds, as the reference does (one WKV6 scan
launch with T = L + 1 on the card).  Recurrent and cross kinds raise, as
the port's blocks do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import rwkv
from repro_torch.models.blocks import check_kind
from repro_torch.models.common import (apply_rope, embed_tokens, ffn_apply,
                                       matmul, rms_norm)

NEG = -1e30


def _slot_abs_positions(pos, size: int):
    """Absolute position held by ring slot j given next-write position
    ``pos``: ``a_j = pos-1 - ((pos-1-j) mod size)``; ``a_j < 0`` means the
    slot is empty.  For full caches (size >= pos) ``a_j = j`` for j < pos."""
    j = torch.arange(size, device=pos.device)[None, :]
    p1 = pos[:, None] - 1
    return p1 - torch.remainder(p1 - j, size)


def score_attention(cfg, p, x, *, cache, pos, n: int, kind: str, freqs,
                    window_override: int = 0):
    """x: (B*n, L, d); cache: {'k','v'} (B, S, KV, hd); pos: (B,).

    Returns the attention block's output (B*n, L, d).  No cache writes.
    """
    BN, L, d = x.shape
    B = pos.shape[0]
    N = BN // B
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    scale = hd ** -0.5
    window = cfg.window_size if kind == "local" else 0
    if window_override:
        window = window_override if window == 0 else min(window,
                                                         window_override)

    q = (x @ p["wq"].reshape(d, H * hd).to(x.dtype)).reshape(BN, L, H, hd)
    k = (x @ p["wk"].reshape(d, KV * hd).to(x.dtype)).reshape(BN, L, KV, hd)
    v = (x @ p["wv"].reshape(d, KV * hd).to(x.dtype)).reshape(BN, L, KV, hd)
    ar = torch.arange(L, device=x.device)
    qabs = pos.repeat_interleave(N)[:, None] + ar[None, :]     # (BN, L)
    q = apply_rope(q, qabs, freqs)
    k = apply_rope(k, qabs, freqs)

    qr = q.reshape(B, N, L, KV, G, hd)
    kr = k.reshape(B, N, L, KV, hd)
    vr = v.reshape(B, N, L, KV, hd)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]

    # scores against the shared committed cache (fp32, as
    # preferred_element_type=float32: bf16 products are exact in fp32)
    sc = torch.einsum("bnlkgh,bskh->bnkgls", qr.float(), ck.float()) * scale
    a = _slot_abs_positions(pos, S)                      # (B, S)
    qa = pos[:, None] + ar[None, :]                      # (B, L)
    mask_c = (a[:, None, :] >= 0) & (a[:, None, :] < pos[:, None, None])
    if window:
        mask_c = mask_c & (a[:, None, :] > qa[:, :, None] - window)
    sc = sc + torch.where(mask_c[:, None, None, None], 0.0, NEG)

    # causal scores within each candidate
    ss = torch.einsum("bnlkgh,bnmkh->bnkglm", qr.float(), kr.float()) * scale
    mask_s = ar[:, None] >= ar[None, :]
    if window:
        mask_s = mask_s & (ar[:, None] - ar[None, :] < window)
    ss = ss + torch.where(mask_s, 0.0, NEG)

    # joint softmax over [cache | own prefix]
    probs = torch.softmax(torch.cat([sc, ss], dim=-1), dim=-1).to(x.dtype)
    pc, pl = probs[..., :S], probs[..., S:]
    dt = torch.promote_types(pc.dtype, cv.dtype)     # fp32 over a dequant view
    out = torch.einsum("bnkgls,bskh->bnlkgh", pc.to(dt), cv.to(dt)) \
        + torch.einsum("bnkglm,bnmkh->bnlkgh", pl, vr)
    return matmul(out.reshape(BN, L, H * hd),
                  p["wo"].reshape(H * hd, d).to(x.dtype))


def score_block(cfg, kind: str, p, x, *, cache, pos, n: int, freqs,
                window_override: int = 0):
    """One decoder block in score mode; returns x (no cache writes)."""
    check_kind(kind)
    if kind == "rwkv":
        state = {k: v.repeat_interleave(n, dim=0) for k, v in cache.items()}
        return rwkv.rwkv_block(cfg, p, x, state)[0]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + score_attention(cfg, p["attn"], h, cache=cache, pos=pos, n=n,
                            kind=kind, freqs=freqs,
                            window_override=window_override)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h)


@torch.no_grad()
def score_candidates(model, cache, pending, pos, cand_tokens, *,
                     return_rewards: bool = False):
    """Score n candidate steps against one shared committed cache.

    cand_tokens: (B, n, L) PAD-padded; pending/pos: (B,) engine invariant
    (the cache holds positions < pos; ``pending`` sits at pos, not yet
    cached); ``cache`` a list of per-layer {'k','v'} (B, S, KV, hd) or RWKV
    state dicts, a dense cache or :func:`repro_torch.serving.engine.
    paged_view` of a paged one.

    Returns logp (B, n) — log pi(candidate | prefix) — and, with
    ``return_rewards``, the PRM reward (B, n) at each candidate's last real
    token.
    """
    cfg = model.cfg
    B, n, L = cand_tokens.shape
    feeds = torch.cat([pending[:, None, None].expand(B, n, 1).to(
        cand_tokens.dtype), cand_tokens], dim=2).reshape(B * n, L + 1)
    x = embed_tokens(cfg, model.embed, feeds)
    for layer, c in zip(model.layers, cache):
        x = score_block(cfg, layer.kind, layer, x, cache=c, pos=pos, n=n,
                        freqs=model.rope_freqs,
                        window_override=cfg.serve_window_override)
    x = rms_norm(x, model.final_ln, cfg.norm_eps)

    # log-probs of the candidate tokens (fused gather over the vocabulary)
    emb = model.embed
    w = emb["unembed"] if "unembed" in emb else emb["embedding"].T
    labels = cand_tokens.reshape(B * n, L)
    lp_tok = ops.logprob_gather(x[:, :L], w, labels.clamp(min=0),
                                cfg.vocab_size)
    live = labels != 0
    logp = torch.where(live, lp_tok, 0.0).sum(dim=1).reshape(B, n)
    if not return_rewards:
        return logp
    lengths = live.sum(dim=1)                            # (B*n,)
    h_at_end = x[torch.arange(B * n, device=x.device), lengths]
    return logp, model.reward_from_hidden(h_at_end).reshape(B, n)
