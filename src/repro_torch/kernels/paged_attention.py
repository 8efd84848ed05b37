"""Paged decode attention: the plain PyTorch version and the CUDA kernel.

One query token per request row against K/V page pools ``(P, ps, KV, hd)``
gathered through a block table ``pt (B, nblk)``: logical block ``i`` of row
``b`` lives in page ``pt[b, i]``.  Position ``kpos`` is live iff
``kpos <= pos[b]`` (and ``kpos > pos[b] - window`` for sliding-window
layers); stale rows of recycled pages are masked, never zeroed.

* :func:`paged_attention_plain` mirrors ``repro.kernels.ref.
  paged_attention_ref``: the same gather, mask and single-softmax order with
  fp32 scores, probabilities cast to the activation dtype before the P.V
  product.  The CPU path, and the yardstick the kernel is held to.
* :func:`paged_attention_cuda` launches ``csrc/paged_attention.cu`` (the
  Hopper kernel that replaces ``paged_attention_pallas``) and counts its
  launches in ``paged_attention_cuda.launches``.
* :func:`paged_attention_quant_plain` and :func:`paged_attention_quant_cuda`
  are the same pair over int8 or fp8-e4m3 code pools with per-page
  per-kv-head scales (``csrc/paged_attention_quant.cu`` replaces
  ``paged_attention_quant_pallas``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30
MAX_GROUP = 16        # query heads per kv head the kernel serves
MAX_HEAD_DIM = 256
MAX_PAGE = 32         # rows per page (one warp lane each in the softmax)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, pool dtype) pairs the unquantized kernel takes; fp32 queries
# over bf16 pools widen K and V as they are read, as the plain version's
# promotion does
_PAIR_CODE = {(torch.float32, torch.float32): 0,
              (torch.bfloat16, torch.bfloat16): 1,
              (torch.float32, torch.bfloat16): 2}


def paged_attention_plain(q, kp, vp, pt, pos, *, window: int = 0,
                          scale=None):
    """q: (B,1,H,hd); kp/vp: (P,ps,KV,hd); pt: (B,nblk); pos: (B,)."""
    B, _, H, hd = q.shape
    P, ps, KV, _ = kp.shape
    nblk = pt.shape[1]
    S = nblk * ps
    if scale is None:
        scale = hd ** -0.5
    lanes = torch.arange(ps, device=q.device)
    rows = (pt.long()[:, :, None] * ps + lanes).reshape(B, S)
    k = kp.reshape(P * ps, KV, hd)[rows]                    # (B,S,KV,hd)
    v = vp.reshape(P * ps, KV, hd)[rows]
    slots = torch.arange(S, device=q.device)[None, :]
    pos = pos.long()[:, None]
    mask = slots <= pos
    if window:
        mask &= slots > pos - window
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    s = s + torch.where(mask, 0.0, NEG)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    # bf16 pools under fp32 queries: v promotes to fp32, as jnp does
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(p.dtype))
    return out.reshape(B, 1, H, hd)


def paged_attention_quant_plain(q, kp, vp, ks, vs, pt, pos, *,
                                window: int = 0, scale=None):
    """Quantized pools: kp/vp (P,ps,KV,hd) int8 or fp8 codes, ks/vs (P,KV)
    fp32 per-page per-kv-head scales.  Mirrors ``repro.kernels.ref.
    paged_attention_quant_ref``: codes dequantized while gathering (every
    row of logical block j carries block j's page scale), fp32 math, one
    softmax, the output cast to q's dtype."""
    B, _, H, hd = q.shape
    P, ps, KV, _ = kp.shape
    nblk = pt.shape[1]
    S = nblk * ps
    if scale is None:
        scale = hd ** -0.5
    ptc = pt.long()
    lanes = torch.arange(ps, device=q.device)
    rows = (ptc[:, :, None] * ps + lanes).reshape(B, S)
    sk = ks.float()[ptc].repeat_interleave(ps, dim=1)       # (B,S,KV)
    sv = vs.float()[ptc].repeat_interleave(ps, dim=1)
    k = kp.reshape(P * ps, KV, hd)[rows].float() * sk[..., None]
    v = vp.reshape(P * ps, KV, hd)[rows].float() * sv[..., None]
    slots = torch.arange(S, device=q.device)[None, :]
    pos = pos.long()[:, None]
    mask = slots <= pos
    if window:
        mask &= slots > pos - window
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * scale
    s = s + torch.where(mask, 0.0, NEG)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _check(who, q, kp, vp, pt, pos, *, hd_multiple, scales=()):
    """The checks both kernels' wrappers make before a launch: devices,
    index dtypes, shapes, the kernels' limits, contiguity and the current
    device.  Raises on anything the kernels do not take."""
    B, one, H, hd = q.shape
    P, ps, KV, hd_k = kp.shape
    named = [("q", q), ("kp", kp), ("vp", vp), ("pt", pt), ("pos", pos)]
    named += list(zip(("ks", "vs"), scales))
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{who}: {name} must be on {q.device} (CUDA), "
                             f"got {t.device}")
    if pt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{who}: pt and pos must be int32")
    if one != 1 or hd_k != hd or vp.shape != kp.shape or H % KV \
            or pt.dim() != 2 or pt.shape[0] != B or pos.shape != (B,) \
            or any(t.shape != (P, KV) for t in scales):
        raise ValueError(f"{who}: bad shapes " + " ".join(
            f"{name} {tuple(t.shape)}" for name, t in named))
    if H // KV > MAX_GROUP or hd > MAX_HEAD_DIM or hd % hd_multiple \
            or ps > MAX_PAGE:
        raise ValueError(f"{who}: needs H/KV <= {MAX_GROUP}, head_dim <= "
                         f"{MAX_HEAD_DIM} and a multiple of {hd_multiple}, "
                         f"page size <= {MAX_PAGE}")
    if not all(t.is_contiguous() for _, t in named[1:]):
        raise ValueError(f"{who}: pools, scales, pt and pos must be "
                         f"contiguous")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{who}: tensors on {q.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def _aligned(who, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{who}: tensors must be 16-byte aligned")


def _library():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q, kp, vp, pt, pos, *, window: int = 0,
                         scale=None):
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`paged_attention_plain`.  q and the pools are float32 or bfloat16
    of one dtype, or float32 q over bfloat16 pools (fp32 output).
    ``pt``/``pos`` must be int32, the pools contiguous; ``q`` is made
    contiguous.  Raises on anything the kernel does not take (any other
    mixed pair among them), and on a failed launch."""
    who = "paged_attention_cuda"
    _check(who, q, kp, vp, pt, pos,
           hd_multiple=16 // min(q.element_size(), kp.element_size()))
    code = _PAIR_CODE.get((q.dtype, kp.dtype))
    if code is None or vp.dtype != kp.dtype:
        raise TypeError(f"{who} takes float32 or bfloat16 q/kp/vp of one "
                        f"dtype, or float32 q over bfloat16 kp/vp; got "
                        f"{q.dtype}, {kp.dtype}, {vp.dtype}")
    B, _, H, hd = q.shape
    ps, KV = kp.shape[1], kp.shape[2]
    q = q.contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    _aligned(who, q, kp, vp, out)
    err = _library()(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, H, KV, hd, ps, pt.shape[1],
        int(window), float(hd ** -0.5 if scale is None else scale), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


_CODE_KIND = {torch.int8: 0, torch.float8_e4m3fn: 1}


def _quant_library():
    lib = build.load("paged_attention_quant")
    fn = lib.paged_attention_quant_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_quant_cuda(q, kp, vp, ks, vs, pt, pos, *,
                               window: int = 0, scale=None):
    """Launch the quantized CUDA kernel on the current stream; same
    contract as :func:`paged_attention_quant_plain`.  ``q`` is float32 or
    bfloat16 (made contiguous), the pools int8 or float8_e4m3fn of one
    dtype, ``ks``/``vs`` float32 ``(P, KV)``, ``pt``/``pos`` int32; pools,
    scales, table and positions contiguous.  Raises on anything the kernel
    does not take, and on a failed launch."""
    who = "paged_attention_quant_cuda"
    _check(who, q, kp, vp, pt, pos, hd_multiple=4, scales=(ks, vs))
    if q.dtype not in _DTYPE_CODE or kp.dtype not in _CODE_KIND \
            or vp.dtype != kp.dtype:
        raise TypeError(f"{who} takes float32 or bfloat16 q over int8 or "
                        f"float8_e4m3fn pools of one dtype, got {q.dtype}, "
                        f"{kp.dtype}, {vp.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"{who}: ks and vs must be float32")
    B, _, H, hd = q.shape
    ps, KV = kp.shape[1], kp.shape[2]
    q = q.contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    _aligned(who, q, kp, vp, out)
    err = _quant_library()(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), pt.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H,
        KV, hd, ps, pt.shape[1], int(window),
        float(hd ** -0.5 if scale is None else scale), _DTYPE_CODE[q.dtype],
        _CODE_KIND[kp.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention_quant kernel launch failed: "
                           f"CUDA error {err}")
    paged_attention_quant_cuda.launches += 1
    return out


paged_attention_quant_cuda.launches = 0
