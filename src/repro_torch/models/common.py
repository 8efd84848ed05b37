"""Shared model machinery: ParamSpec init, norms, RoPE, FFN, embeddings.

A port of ``repro.models.common`` without the tensor-parallel hooks.  Every
model describes its parameters as a flat ``{name: ParamSpec}`` dict; the
same dict materializes seeded random weights directly on a device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | embed | uniform_decay
    scale: float = 1.0    # stddev multiplier for "normal"


def spec(shape, axes, init="normal", scale=1.0) -> ParamSpec:
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale)


def init_params(specs: dict, seed: int, dtype, device) -> dict:
    """Materialize ``{name: ParamSpec}`` into tensors on ``device``.

    Leaf ``i`` (in the dict's order) draws from its own generator seeded
    with ``(seed, i)``, so a weight does not depend on how many others
    precede it in memory.  The normals are drawn in fp32 and cast.
    """
    out = {}
    for i, (name, s) in enumerate(specs.items()):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + i)
        out[name] = _materialize(s, gen, dtype, device)
    return out


def _materialize(s: ParamSpec, gen, dtype, device):
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    if s.init == "uniform_decay":
        # logit of U[0.9, 0.999], drawn in fp32 and cast (as the reference)
        u = torch.rand(s.shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(0.999 - 0.9).add_(0.9)
        return (torch.log(u) - torch.log1p(-u)).to(dtype)
    if s.init == "embed":
        std = 1.0
    else:
        # fan-in scaled normal; for 3-D projections (d, H, hd) fan-in = d
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        if len(s.shape) >= 3:
            fan_in = s.shape[-3] if s.axes[-1] == "head" else s.shape[-2]
        std = 1.0 / math.sqrt(max(1, fan_in))
    arr = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                      device=device)
    return arr.mul_(std * s.scale).to(dtype)


def rms_norm(x, gamma, eps):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def norm_spec(d):
    return spec((d,), ("embed",), "zeros")  # "1+gamma" parametrization


def rope_freqs(head_dim: int, theta: float):
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x, positions, freqs):
    """x: (..., S, H, hd); positions broadcastable to (..., S); ``freqs``
    the (hd/2,) fp32 :func:`rope_freqs` on x's device (models keep it as a
    buffer: building it per call would copy host memory to the card and
    synchronize the stream twice per layer)."""
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                        # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def ffn_specs(d, ff):
    return {
        "wi_gate": spec((d, ff), ("embed", "mlp")),
        "wi_up": spec((d, ff), ("embed", "mlp")),
        "wo": spec((ff, d), ("mlp", "embed")),
    }


def matmul(a, b):
    """``a @ b`` in the promoted dtype of the two, as ``jnp`` computes a
    product of mixed dtypes (torch's ``@`` raises on them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def ffn_apply(p, x):
    """SwiGLU FFN: silu(x Wg) * (x Wu) Wo (fp32 activations over bf16
    weights compute in fp32, as the reference's scoring pass does)."""
    gate = torch.nn.functional.silu(matmul(x, p["wi_gate"]))
    return matmul(gate * matmul(x, p["wi_up"]), p["wo"])


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_vocab(cfg) -> int:
    """Vocab padded to a multiple of 512, as the reference lays it out."""
    return round_up(cfg.vocab_size, 512)


def embed_specs(cfg):
    v = padded_vocab(cfg)
    s = {"embedding": spec((v, cfg.d_model), ("vocab", "embed"), "embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = spec((cfg.d_model, v), ("embed", "vocab"))
    return s


def adtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def embed_tokens(cfg, p, tokens):
    return p["embedding"].to(adtype(cfg))[tokens]


def unembed(cfg, p, x):
    """Project hidden states to logits; padded vocab columns get -1e30."""
    w = p["unembed"] if "unembed" in p else p["embedding"].T
    logits = (x @ w.to(x.dtype)).to(getattr(torch, cfg.logit_dtype))
    v = padded_vocab(cfg)
    if v != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
