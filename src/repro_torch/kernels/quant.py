"""Quantized KV-page numerics shared by the kernels and the cache owner.

A copy of ``repro.kernels.quant`` for the port.  A page pool shaped
``(P, ps, KV, hd)`` stores int8 (or fp8-e4m3) codes; a companion scale
tensor shaped ``(P, KV)`` float32 holds one positive scale per (page, kv
head), with ``fp ~= code * scale``.  Scales are ``amax / QMAX`` over the
valid rows of the page at write time, so a page is re-quantized whole on
every token append.  ``"bf16"`` is the unquantized half-width mode (a plain
cast, no scale tensor).
"""
from __future__ import annotations

import torch

#: Accepted values for the serving-level ``kv_dtype`` switch.  ``None``
#: keeps pages in the activation dtype.
KV_DTYPES = (None, "bf16", "int8", "fp8")

#: kv_dtype values that carry a companion scale tensor.
QUANTIZED = ("int8", "fp8")

#: Largest representable magnitude per quantized format: int8 clips to
#: +-127 (symmetric, -128 unused), float8_e4m3fn tops out at +-448.
QMAX = {"int8": 127.0, "fp8": 448.0}

#: Scale floor: an all-zero (page, head) slice still gets a positive scale.
EPS = 1e-8

#: Inputs beyond this magnitude leave the e4m3 range: the reference's cast
#: (ml_dtypes, round to nearest even) turns them into NaN, while a torch
#: cast may saturate to 448, so :func:`quantize_codes` makes them NaN itself.
_FP8_OVERFLOW = 464.0


def validate_kv_dtype(kv_dtype):
    """Return ``kv_dtype`` if it is a known mode, else raise ValueError."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                         f"choose from {KV_DTYPES}")
    return kv_dtype


def is_quantized(kv_dtype) -> bool:
    """True iff the mode stores codes + per-page scales (int8 / fp8)."""
    return kv_dtype in QUANTIZED


def pool_dtype(kv_dtype, fallback) -> torch.dtype:
    """Storage dtype of the page pools for ``kv_dtype``; ``fallback`` (the
    activation dtype) when quantization is off."""
    validate_kv_dtype(kv_dtype)
    return {None: fallback, "bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]


def quantize_codes(x, dtype):
    """Round/clip an already-scaled fp tensor into storage codes.

    int8 rounds half to even and clips to +-127; fp8 rounds to nearest even,
    and a magnitude past the e4m3 range becomes NaN, bit for bit as the
    reference's cast.  ``x`` must already be divided by the scale.
    """
    if dtype == torch.int8:
        return torch.clamp(torch.round(x), -QMAX["int8"],
                           QMAX["int8"]).to(torch.int8)
    if dtype == torch.float8_e4m3fn:
        nan = torch.full_like(x, float("nan"))
        x = torch.where(x.abs() > _FP8_OVERFLOW, torch.copysign(nan, x), x)
    return x.to(dtype)
