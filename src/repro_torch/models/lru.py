"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

A port of ``repro.models.lru``, in the reference's dtypes and op order.
The block takes x (B,T,d) to a linear branch ``x Wx`` and a gate branch
``gelu(x Wgate)`` (tanh approximation, ``jax.nn.gelu``'s default); the
linear branch goes through a width-4 causal depthwise conv, then the
Real-Gated LRU:

    r_t = sigmoid(xc_t Wa + ba)               (recurrence gate)
    i_t = sigmoid(xc_t Wi + bi)               (input gate)
    log a_t = -c * softplus(lam) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xc_t)

and ``y = (gate * h) Wo``.  ``r``, ``i``, ``a``, ``b`` and ``h`` are fp32;
``gate * h`` is cast to the activation dtype before ``Wo``.  The decay is
``softplus(lam)`` as the reference writes it, not Griffin's
``softplus(-lam)``.

State per layer: ``h`` (B, w) fp32 and the conv tail ``conv`` (B, 3, w)
in the activation dtype.  Over T > 1 steps (train, prefill, the scoring
pass's ``extend``) the recurrence runs as a log-depth doubling scan over
T with the reference's associative combine ``(a1, b1), (a2, b2) -> (a1 a2,
a2 b1 + b2)``: it multiplies decays and never divides by a cumulative one,
so products that underflow to 0 stay exact zeros.  The reference computes
its ``associative_scan`` outside any Pallas kernel, so this stays plain
PyTorch on the card too.  A decode step (T = 1) is the one-step update,
and :func:`recurrent_block` with ``in_place=True`` writes ``h`` and
``conv`` into the given state, keeping the old values in rows where
``live`` is False.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import adtype, matmul, spec

LRU_C = 8.0
CONV_W = 4


def recurrent_specs(cfg) -> dict:
    """Flat ``{name: ParamSpec}`` of one block's ``rec`` group: the
    reference's names, shapes and axes."""
    d, w = cfg.d_model, cfg.lru_width
    return {
        "wx": spec((d, w), ("embed", "mlp")),
        "wgate": spec((d, w), ("embed", "mlp")),
        "conv_w": spec((CONV_W, w), (None, "mlp"), scale=0.5),
        "wa": spec((w, w), ("mlp", "mlp_out")),
        "ba": spec((w,), ("mlp",), "zeros"),
        "wi": spec((w, w), ("mlp", "mlp_out")),
        "bi": spec((w,), ("mlp",), "zeros"),
        "lam": spec((w,), ("mlp",), "uniform_decay"),
        "wo": spec((w, d), ("mlp", "embed")),
    }


def init_lru_state(cfg, batch: int, device) -> dict:
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, w), dtype=adtype(cfg),
                            device=device),
    }


def _causal_conv(p, xb, conv_state):
    """Depthwise causal conv of width 4.  xb: (B,T,w); conv_state: (B,3,w).
    Returns the conv output and the new tail (the last 3 inputs)."""
    dt = torch.promote_types(xb.dtype, conv_state.dtype)
    ext = torch.cat([conv_state.to(dt), xb.to(dt)], dim=1)   # (B,T+3,w)
    T = xb.shape[1]
    out = 0
    for i in range(CONV_W):
        out = out + ext[:, i:i + T] * p["conv_w"][i]
    return out, ext[:, -(CONV_W - 1):]


def lru_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over axis 1 from h0 (B, w); a, b: (B,T,w)
    fp32.  Returns h (B,T,w).

    Hillis-Steele doubling with the reference's combine: after the pass at
    offset s, (A_t, B_t) composes steps max(0, t - 2s + 1) .. t, so
    ``ceil(log2 T)`` passes give every prefix; then h_t = A_t h0 + B_t.
    """
    T = a.shape[1]
    s = 1
    while s < T:
        a_prev, b_prev = a[:, :-s], b[:, :-s]
        a_new = torch.cat([a[:, :s], a_prev * a[:, s:]], dim=1)
        b = torch.cat([b[:, :s], a[:, s:] * b_prev + b[:, s:]], dim=1)
        a = a_new
        s *= 2
    return a * h0[:, None] + b


def recurrent_block(cfg, p, x, state, *, live=None, in_place=False):
    """x: (B,T,d) from ``state`` -> ``(y, new_state)``.

    T = 1 is a decode step (the one-step update), T > 1 the scan.  With
    ``in_place`` the new ``h`` and ``conv`` are written into ``state``
    (rows where ``live`` (B,) is False keep their old values) and that dict
    is returned.
    """
    xb = matmul(x, p["wx"])
    gate = torch.nn.functional.gelu(matmul(x, p["wgate"]), approximate="tanh")
    xc, conv_state = _causal_conv(p, xb, state["conv"])

    r = torch.sigmoid(matmul(xc, p["wa"]) + p["ba"]).float()
    i = torch.sigmoid(matmul(xc, p["wi"]) + p["bi"]).float()
    log_a = -LRU_C * torch.nn.functional.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())

    if x.shape[1] == 1:
        h = a[:, 0] * state["h"] + b[:, 0]
        h_seq = h[:, None]
    else:
        h_seq = lru_scan(a, b, state["h"])
        h = h_seq[:, -1]

    y = matmul(gate * h_seq.to(x.dtype), p["wo"])
    if not in_place:
        return y, {"h": h, "conv": conv_state}
    for key, new in (("h", h), ("conv", conv_state)):
        old = state[key]
        if live is not None:
            mask = live.reshape((live.shape[0],) + (1,) * (new.dim() - 1))
            new = torch.where(mask, new.to(old.dtype), old)
        old.copy_(new)
    return y, state
