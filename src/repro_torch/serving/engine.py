"""Serving-engine primitives: cache branching and candidate selection.

A port of ``repro.serving.engine``.  A cache is a list with one dict per
layer: dense rows ``{"k","v"}`` shaped ``(B, S, KV, hd)`` or page pools
``{"kp","vp"}`` shaped ``(P, ps, KV, hd)`` addressed through a block table
(plus ``{"ks","vs"}`` ``(P, KV)`` per-page scales for int8/fp8 pools, which
travel with their pages); an RWKV layer keeps dense per-slot state
``{"tm_prev","wkv","cm_prev"}``, an RG-LRU layer ``{"h","conv"}`` and a
cross layer its cross KV ``{"ck","cv"}`` ``(B, S_src, KV, hd)`` beside its
self-attention rows or pools, in either layout.  The engine takes no
source, so its ``ck``/``cv`` stay the zeros ``init_cache`` makes (the
requests are text-only, as in the reference).

* Dense branching (``repeat_cache``) copies each slot's rows n times, row
  ``b*n+j`` being candidate j of request b.
* Paged branching is copy-on-write: ``branch_pages`` forks the table so the
  n branches alias the committed prefix's pages and point their write range
  at reserved scratch pages; ``branch_cache`` copies only the partial page
  each branch extends, into its first scratch page, **in place** in the
  shared pool.  Committed pages are never written by a branch, so the
  in-place copy cannot disturb any other reader.
* ``paged_view`` gathers a paged cache into the dense per-slot layout
  (dequantized) for the shared-prefix scoring pass.
"""
from __future__ import annotations

import torch

_PAGED_KEYS = ("kp", "vp", "ks", "vs")


def repeat_cache(cache, n: int):
    """Expand every dense leaf's batch dim B -> B*n (candidate-major)."""
    return [{k: v.repeat_interleave(n, dim=0) for k, v in layer.items()}
            for layer in cache]


def reset_cache_rows(cache, reset_mask) -> None:
    """Zero, in place, the dense rows of slots where ``reset_mask`` is True.

    Paged pools are shared across slots (and across requests through the
    radix cache) and are never zeroed: a page is always written before the
    decode mask can expose it.
    """
    for layer in cache:
        for k, leaf in layer.items():
            if k not in _PAGED_KEYS:
                leaf[reset_mask] = 0


def branch_pages(pt, pos, scratch_ids, page_size: int):
    """Fork the committed block table for n candidate branches.

    pt: (B, nblk1) committed table (last column is the trash block);
    pos: (B,); scratch_ids: (B, n, span).  Returns the (B*n, nblk1) branch
    table: entries below the write block ``pos // page_size`` alias the
    committed pages; the ``span`` entries from it on point at the branch's
    scratch pages, clamped into the trash column past the table end (for
    several clamped entries the last one wins, as in the reference).
    """
    B, n, span = scratch_ids.shape
    nblk1 = pt.shape[1]
    bpt = pt.repeat_interleave(n, dim=0)                    # (B*n, nblk1)
    blk0 = (pos // page_size).repeat_interleave(n)          # (B*n,)
    rows = torch.arange(B * n, device=pt.device)
    ids = scratch_ids.reshape(B * n, span).to(pt.dtype)
    for j in range(span):
        cols = torch.clamp(blk0 + j, max=nblk1 - 1)
        bpt[rows, cols] = ids[:, j]
    return bpt


def branch_cache(cache, n: int, pt, pos, scratch_ids, page_size: int):
    """Copy-on-write counterpart of ``repeat_cache`` for a paged cache.

    Each branch's first scratch page receives the content of the committed
    page holding ``pos`` (so in-page committed rows below ``pos`` stay
    visible while the branch writes land in scratch).  Pools are updated in
    place and shared; dense leaves (recurrent state, cross KV) repeat as in
    the dense engine.
    """
    B = scratch_ids.shape[0]
    blk = (pos // page_size)[:, None]
    src = torch.gather(pt, 1, blk.long())[:, 0].long().repeat_interleave(n)
    dst = scratch_ids[:, :n, 0].reshape(B * n).long()
    out = []
    for layer in cache:
        new = {}
        for k, leaf in layer.items():
            if k in _PAGED_KEYS:
                leaf[dst] = leaf[src]
                new[k] = leaf
            else:
                new[k] = leaf.repeat_interleave(n, dim=0)
        out.append(new)
    return out


def paged_view(cache, pt):
    """The dense per-slot view of a paged cache: each layer's pools gathered
    through the block table ``pt (B, nblk1)`` into ``{"k","v"}`` shaped
    ``(B, nblk1 * ps, KV, hd)`` (absolute positions).  Quantized pools are
    dequantized on the way out, every row of logical block j carrying block
    j's page scale, so they come out float32; other pools keep their dtype.
    Dense leaves (an RWKV or RG-LRU layer's state) pass through as they
    are, as do a cross layer's ``ck``/``cv``.  Read by the shared-prefix
    scoring pass; decode never builds it."""
    B, nblk = pt.shape
    ptc = pt.long()

    def gather(pool, sc=None):                          # (P, ps, KV, hd)
        P, ps = pool.shape[:2]
        rows = (ptc[:, :, None] * ps
                + torch.arange(ps, device=pt.device)).reshape(B, nblk * ps)
        out = pool.reshape((P * ps,) + tuple(pool.shape[2:]))[rows]
        if sc is not None:                              # (P, KV) scales
            per_row = sc[ptc].repeat_interleave(ps, dim=1)
            out = out.float() * per_row[..., None]
        return out

    out = []
    for layer in cache:
        view = {k: v for k, v in layer.items() if k not in _PAGED_KEYS}
        if "kp" in layer:
            view["k"] = gather(layer["kp"], layer.get("ks"))
            view["v"] = gather(layer["vp"], layer.get("vs"))
        out.append(view)
    return out


def expand_requests(x, n: int):
    """(B, ...) -> (B*n, ...) by repeating each request n times."""
    return x.repeat_interleave(n, dim=0)


def fold_candidates(x, n: int):
    """(B*n, ...) -> (B, n, ...)."""
    return x.reshape((x.shape[0] // n, n) + tuple(x.shape[1:]))


def take_candidates(cands, idx):
    """cands: (B, n, L); idx: (B,) -> (B, L)."""
    return cands[torch.arange(cands.shape[0], device=cands.device), idx]


def take_per_request(x, idx):
    """x: (B, n); idx: (B,) -> (B,)."""
    return torch.gather(x, 1, idx[:, None])[:, 0]
