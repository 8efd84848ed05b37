"""Mixture-of-Experts FFN: top-k routing, shared experts, capacity dispatch.

A port of ``repro.models.moe`` on its mesh-less path.  The router's softmax
runs over the real experts (the padding experts the layout adds get logit
-1e30), the k largest probabilities are renormalized, and every routed
slot goes through a capacity-bounded gather -> three batched products over
``(E, C, d)`` -> combine.  A slot beyond its expert's capacity is dropped in
the order of a stable counting sort over ``(token, choice)``, so a row's
output depends on every other row of the same call: callers route every
row they are given (dead rows and PAD columns included) and never compact
the batch.

Three choices keep the port's results those of the reference, and
repeatable on the card:

* ties in the router's top-k break towards the lower expert index, as
  ``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
  promises no order);
* each bucket's first sorted slot comes from ``torch.searchsorted`` over
  the sorted buckets, the exclusive prefix sum of the reference's
  ``bincount`` (which on a CUDA tensor reads its input's range on the host
  and so synchronizes the stream);
* the combine gathers each token's k contributions into ``(T, k, d)`` and
  sums over k, where the reference scatter-adds them: an ``index_add_`` on
  the card adds with atomics in no fixed order.

The reference's expert-parallel branches (``shard_map`` over a device
mesh, chosen by ``REPRO_MOE_MODE``) wait for the multi-GPU slice; nothing
here reads that variable.  No part of this layer is a Pallas kernel in the
reference, so its products stay ``torch.bmm`` and its routing plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import matmul, spec


def padded_experts(cfg, model_axis: int = 16) -> int:
    """Routed experts as laid out: a multiple of ``model_axis`` (the
    reference's expert-parallel width), e.g. qwen2-moe's 60 -> 64."""
    m = max(model_axis, 1)
    return (cfg.num_experts + m - 1) // m * m


def moe_specs(cfg) -> dict:
    """``{name: ParamSpec}`` of one MoE FFN (names relative to ``ffn``)."""
    d, ff = cfg.d_model, cfg.moe_d_ff
    e = padded_experts(cfg)
    s = {
        "router": spec((d, e), ("embed", "expert_in")),
        "we_gate": spec((e, d, ff), ("expert", "embed", "expert_mlp")),
        "we_up": spec((e, d, ff), ("expert", "embed", "expert_mlp")),
        "we_down": spec((e, ff, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * cfg.moe_d_ff
        s["shared_gate"] = spec((d, sff), ("embed", "mlp"))
        s["shared_up"] = spec((d, sff), ("embed", "mlp"))
        s["shared_down"] = spec((sff, d), ("mlp", "embed"))
    return s


def _capacity(cfg, tokens_local: int, e_pad: int) -> int:
    """Slots per expert: ``tokens x k / E x capacity_factor`` over the
    *real* experts (padding experts receive no traffic), rounded up to a
    multiple of 8 and at least 8, as the reference sizes it."""
    c = int(math.ceil(tokens_local * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, int(math.ceil(c / 8)) * 8)


def _route(cfg, router_w, x):
    """Router: softmax over the real experts, top-k, renormalized weights.

    x: (T, d).  Returns ``top_w`` (T, k) in x's dtype, ``top_e`` (T, k)
    int64 and the Switch-style load-balance loss ``E * sum_e f_e * p_e``
    (a 0-dim fp32 tensor); logits and probabilities are fp32.
    """
    e_pad = router_w.shape[1]
    k = cfg.experts_per_token
    logits = (x @ router_w.to(x.dtype)).float()
    real = torch.arange(e_pad, device=x.device) < cfg.num_experts
    logits = torch.where(real, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # ties to the lower expert index, as jax.lax.top_k
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[:, :k], idx[:, :k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    load = torch.zeros_like(probs).scatter_(1, top_e, 1.0)  # k distinct
    fe = load.mean(dim=0) / k
    aux = cfg.num_experts * torch.sum(fe * me)
    return top_w.to(x.dtype), top_e, aux


def _local_expert_ffn(cfg, p_local, x, top_w, top_e, e0: int, e_local: int,
                      capacity: int):
    """x: (T, d); top_w/top_e: (T, k); experts [e0, e0 + e_local) here.

    Returns their contribution (T, d) in x's dtype: every slot is ranked
    within its expert by a stable sort of (token, choice) order, the first
    ``capacity`` of each expert are gathered into ``(E, C, d)``, and the
    rest are dropped.
    """
    T, d = x.shape
    k = top_e.shape[1]
    slots = T * k
    dev = x.device
    flat_e = top_e.reshape(slots) - e0               # local expert index
    flat_w = top_w.reshape(slots)
    valid = (flat_e >= 0) & (flat_e < e_local)
    bucket = torch.where(valid, flat_e, e_local)     # drop bucket at the end

    # stable counting sort: sorted slot i has rank i - starts[bucket]
    order = torch.argsort(bucket, stable=True)
    starts = torch.searchsorted(bucket[order], torch.arange(
        e_local + 1, device=dev, dtype=bucket.dtype))
    rank = torch.argsort(order) - starts[bucket]     # per slot, in order
    keep = (bucket < e_local) & (rank < capacity)
    buf_pos = torch.where(keep, bucket * capacity + rank, 0)

    # expert e's row c holds sorted slot starts[e] + c, if it has one
    col = torch.arange(capacity, device=dev)
    filled = col[None, :] < (starts[1:] - starts[:-1])[:, None]  # (E, C)
    src = (starts[:-1, None] + col[None, :]).clamp(max=slots - 1)
    tok = torch.div(order[src], k, rounding_mode="floor")
    dt = torch.promote_types(x.dtype, p_local["we_gate"].dtype)
    xb = torch.where(filled[..., None], x[tok], 0.0).to(dt)
    gate = torch.nn.functional.silu(
        torch.bmm(xb, p_local["we_gate"].to(dt)))
    up = torch.bmm(xb, p_local["we_up"].to(dt))
    h = torch.bmm(gate * up, p_local["we_down"].to(dt))
    h = h.reshape(e_local * capacity, d)

    # the inverse of the sort: each token's k contributions, summed in
    # choice order (no atomics)
    contrib = torch.where(keep[:, None], h[buf_pos] * flat_w[:, None], 0.0)
    return contrib.reshape(T, k, d).sum(dim=1).to(x.dtype)


def _shared_ffn(p, x):
    """The always-on experts, one SwiGLU of width ``shared x moe_d_ff``."""
    gate = torch.nn.functional.silu(matmul(x, p["shared_gate"]))
    return matmul(gate * matmul(x, p["shared_up"]), p["shared_down"])


def moe_ffn(cfg, p, x):
    """x: (B, S, d) -> (y (B, S, d), aux loss), on one device: every row
    of the call is routed and shares the experts' capacity."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    e_pad = p["router"].shape[1]
    cap = _capacity(cfg, B * S, e_pad)
    top_w, top_e, aux = _route(cfg, p["router"], xf)
    y = _local_expert_ffn(cfg, p, xf, top_w, top_e, 0, e_pad, cap)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(p, xf)
    return y.reshape(B, S, d), aux
