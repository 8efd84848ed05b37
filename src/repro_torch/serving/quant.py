"""Int8 weight fake-quantization of the draft model at load.

A port of ``repro.serving.quant``: every draft matmul weight is quantized to
int8 per channel and immediately dequantized back to its dtype, so each
product sees exactly the values an int8 kernel would compute with.  There is
no kernel: the rounding happens once, when the engine is built.

Channels follow the :class:`~repro_torch.models.common.ParamSpec` axis
names.  The port stores layers one by one (``layers.3.attn.wq``) where the
reference stacks them under a leading ``layer`` axis that its reduction
keeps, so the scales come out per layer and per channel on both sides:

* the trailing axis is the output channel: scales keep it and reduce the
  leading (input) axes;
* when the input side has named axes (``embed``, ``mlp``) other than the
  trailing one, only those are reduced (``wq (embed, heads, head)`` gets one
  scale per (head, head_dim));
* embeddings, the reward head and every leaf with fewer than two dims (norm
  gains, biases) stay full precision.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant
from repro_torch.models.model import param_specs

#: Top-level parameter groups never quantized.
_SKIP_GROUPS = ("embed", "reward_head")

#: Axis names that mark a reducible input dimension of a weight.
_INPUT_AXES = ("embed", "mlp")


def _reduce_axes(spec) -> tuple:
    """Axes of ``spec`` to amax-reduce for per-channel scales: the named
    input axes when there are any besides the trailing one, else every
    leading axis."""
    nd = len(spec.shape)
    named = tuple(i for i, name in enumerate(spec.axes)
                  if name in _INPUT_AXES and i != nd - 1)
    return named or tuple(range(nd - 1))


def _quantizable(name: str, spec) -> bool:
    return name.split(".")[0] not in _SKIP_GROUPS and len(spec.shape) >= 2


def _fake_quant(t, spec):
    """Quantize-dequantize one weight to int8 per channel."""
    f = t.float()
    amax = f.abs().amax(dim=_reduce_axes(spec), keepdim=True)
    sc = torch.clamp(amax, min=quant.EPS) / quant.QMAX["int8"]
    codes = quant.quantize_codes(f / sc, torch.int8)
    return (codes.float() * sc).to(t.dtype)


def quantize_draft_params(cfg, params: dict) -> dict:
    """The draft's parameters with every quantizable weight rounded through
    int8 (a new dict; embeddings, heads and vectors pass through as they
    are)."""
    specs = param_specs(cfg)
    return {name: _fake_quant(t, specs[name])
            if _quantizable(name, specs[name]) else t
            for name, t in params.items()}


def quantized_fraction(cfg, params: dict) -> float:
    """Fraction of the parameter elements the int8 scheme touches."""
    specs = param_specs(cfg)
    total = sum(t.numel() for t in params.values())
    touched = sum(t.numel() for name, t in params.items()
                  if _quantizable(name, specs[name]))
    return touched / max(1, total)
