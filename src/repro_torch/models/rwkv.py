"""RWKV-6 "Finch" blocks: time-mix with data-dependent decay + channel-mix.

A port of ``repro.models.rwkv`` (arXiv:2404.05892 §3 with the reference's
two simplifications: RMSNorm instead of LayerNorm, one shared 32-dim LoRA
rank for the five token-shift mixes), in the reference's dtypes and op
order: the decays ``w`` come from an fp32 clip, ``r``, ``k`` and ``v`` stay
in the activation dtype, and the per-head group norm runs on the fp32 scan
output before casting back.

State per layer: the time-mix shift ``tm_prev`` (B,d), the WKV state
``wkv`` (B,H,hd,hd) fp32 and the channel-mix shift ``cm_prev`` (B,d).
The functions here are pure: they return a new state dict, and the decode
path in ``blocks`` writes it into the cache in place.

**The scan runs through ``ops.rwkv6_scan`` for every T, T = 1 included.**
The reference calls its Pallas kernel only when T > 1 and leaves a decode
step to XLA's fused update: one Pallas launch per step costs a TPU more
than the fusion.  Here the alternative is about six eager ops per layer on
a decode path that is host-bound, and a CUDA tensor reaches the kernel, by
the port's rule.  On the CPU the plain version at T = 1 is exactly the
reference's ``_wkv_scan``.  The reference's chunked matmul form
(``_wkv_chunked``, a lowering aid for its dry-run) is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import adtype, matmul, rms_norm, spec

LORA_RANK = 32
DECAY_RANK = 64


def timemix_specs(cfg) -> dict:
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    return {
        "mu_x": spec((d,), ("embed",), "zeros"),
        "mu_5": spec((5, d), (None, "embed"), "zeros"),
        "tm_w1": spec((d, 5 * LORA_RANK), ("embed", None), scale=0.1),
        "tm_w2": spec((5, LORA_RANK, d), (None, None, "embed"), scale=0.1),
        "decay_base": spec((d,), ("embed",), "uniform_decay"),
        "decay_w1": spec((d, DECAY_RANK), ("embed", None), scale=0.1),
        "decay_w2": spec((DECAY_RANK, d), (None, "embed"), scale=0.1),
        "bonus_u": spec((H, hd), ("heads", "head"), scale=0.5),
        "wr": spec((d, d), ("embed", "heads_flat")),
        "wk": spec((d, d), ("embed", "heads_flat")),
        "wv": spec((d, d), ("embed", "heads_flat")),
        "wg": spec((d, d), ("embed", "heads_flat")),
        "wo": spec((d, d), ("heads_flat", "embed")),
        "ln_x": spec((d,), ("embed",), "zeros"),
    }


def channelmix_specs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": spec((d,), ("embed",), "zeros"),
        "mu_r": spec((d,), ("embed",), "zeros"),
        "wk": spec((d, ff), ("embed", "mlp")),
        "wv": spec((ff, d), ("mlp", "embed")),
        "wr": spec((d, d), ("embed", "embed_out")),
    }


def rwkv_block_specs(cfg) -> dict:
    """Flat ``{name: ParamSpec}`` of one block (names relative to it)."""
    d = cfg.d_model
    out = {"ln1": spec((d,), ("embed",), "zeros"),
           "ln2": spec((d,), ("embed",), "zeros")}
    out.update({f"tm.{k}": s for k, s in timemix_specs(cfg).items()})
    out.update({f"cm.{k}": s for k, s in channelmix_specs(cfg).items()})
    return out


def init_rwkv_state(cfg, batch: int, device) -> dict:
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    return {
        "tm_prev": torch.zeros((batch, d), dtype=adtype(cfg), device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "cm_prev": torch.zeros((batch, d), dtype=adtype(cfg), device=device),
    }


def _shift(prev, x):
    """(x_prev - x) with x_prev the sequence shifted by one, ``prev`` first."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1) - x


def _ddlerp(p, x, sx):
    """Data-dependent token-shift mixes for (w,k,v,r,g).

    x, sx: (B,T,d) with sx = x_prev - x.  Returns 5 tensors (B,T,d).
    """
    base = x + sx * p["mu_x"]
    lo = torch.tanh(matmul(base, p["tm_w1"]))          # (B,T,5*R)
    B, T = x.shape[:2]
    lo = lo.reshape(B, T, 5, LORA_RANK)
    w2 = p["tm_w2"]
    dt = torch.promote_types(lo.dtype, w2.dtype)
    delta = torch.einsum("btfr,frd->btfd", lo.to(dt), w2.to(dt))
    mixes = p["mu_5"][None, None] + delta
    out = x[:, :, None] + sx[:, :, None] * mixes
    return [out[:, :, i] for i in range(5)]


def _decay(p, xw):
    """Data-dependent per-channel decay w_t in (0,1), fp32.  xw: (B,T,d)."""
    lora = matmul(torch.tanh(matmul(xw, p["decay_w1"])), p["decay_w2"])
    log_w = -torch.exp(torch.clamp((p["decay_base"] + lora).float(),
                                   -8.0, 4.0))
    return torch.exp(log_w)


def time_mix(cfg, p, x, state):
    """x: (B,T,d).  Returns ``(y, new_state)``."""
    B, T, d = x.shape
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    sx = _shift(state["tm_prev"], x)
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)

    r = matmul(xr, p["wr"]).reshape(B, T, H, hd)
    k = matmul(xk, p["wk"]).reshape(B, T, H, hd)
    v = matmul(xv, p["wv"]).reshape(B, T, H, hd)
    g = torch.nn.functional.silu(matmul(xg, p["wg"]))
    w = _decay(p, xw).reshape(B, T, H, hd)
    u = p["bonus_u"].float()
    out, S = ops.rwkv6_scan(r, k, v, w, u, state["wkv"])

    # per-head group norm on the fp32 scan output
    mean2 = torch.mean(out * out, dim=-1, keepdim=True)
    out = out * torch.rsqrt(mean2 + cfg.norm_eps)
    out = out.reshape(B, T, d).to(x.dtype)
    out = out * (1.0 + p["ln_x"]) * g
    new_state = dict(state)
    new_state["tm_prev"] = x[:, -1]
    new_state["wkv"] = S
    return matmul(out, p["wo"]), new_state


def channel_mix(cfg, p, x, state):
    sx = _shift(state["cm_prev"], x)
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(torch.relu(matmul(xk, p["wk"])))
    y = torch.sigmoid(matmul(xr, p["wr"])) * matmul(k, p["wv"])
    new_state = dict(state)
    new_state["cm_prev"] = x[:, -1]
    return y, new_state


def rwkv_block(cfg, p, x, state):
    """One block over x (B,T,d) from ``state``; returns ``(x, new_state)``.
    ``p`` maps ``ln1``, ``ln2``, ``tm`` and ``cm`` to the block's weights."""
    h, state = time_mix(cfg, p["tm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                        state)
    x = x + h
    h, state = channel_mix(cfg, p["cm"], rms_norm(x, p["ln2"], cfg.norm_eps),
                           state)
    return x + h, state
