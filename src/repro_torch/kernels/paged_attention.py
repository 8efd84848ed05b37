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
  launches in ``paged_attention_cuda.launches``: one per call, whether the
  C entry point ran its split kernel alone or with the combine kernel.
* :func:`split_plan` is the host's half of both kernels' flash-decoding
  split (``csrc/paged_decode.cuh``): how many blocks share a row's sweep,
  from the shapes alone, so that no call reads ``pos`` or ``pt`` on the
  host.
* :func:`paged_attention_quant_plain` and :func:`paged_attention_quant_cuda`
  are the same pair over int8 or fp8-e4m3 code pools with per-page
  per-kv-head scales (``csrc/paged_attention_quant.cu`` replaces
  ``paged_attention_quant_pallas``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG = -1e30
MAX_GROUP = 16        # query heads per kv head the kernel serves
MAX_HEAD_DIM = 256
MAX_PAGE = 32         # rows per page (at most one warp lane each)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WARPS = 4             # warps per split block (paged::kWarps)
MAX_PAGES_PER_WARP = 32
MIN_ROWS_PER_WARP = 16
MAX_SPLITS = 32
SPLIT_BLOCKS = 8 * 132  # about eight blocks per SM of an H100 at most
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


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KV: int, nblk1: int, ps: int) -> tuple:
    """``(splits, bps)``: the sweep over a table row's ``nblk1`` logical
    blocks is cut into ``splits`` ranges of ``bps`` blocks, one block of the
    grid per (row, kv head, range); warp ``w`` of a block takes the range's
    blocks ``w, w + WARPS, ...``.  A pure function of the shapes: the
    kernels find a row's live blocks from ``pos`` on the card.

    Each warp gets at least ``MIN_ROWS_PER_WARP`` rows (one page of 16 or
    more rows, two of 8, ...), as many splits as that allows up to
    ``MAX_SPLITS`` and ``SPLIT_BLOCKS`` blocks in all, and at most
    ``MAX_PAGES_PER_WARP`` pages per warp (lane k of a warp holds its k-th
    page id).  At the main path's shapes (16 x 4, 16 x 2 and 4 x 4 (row,
    kv head) pairs, a 33-column table of 16-row pages) that is 9 splits of
    4 blocks: one page per warp and 144 to 576 blocks."""
    ppw = -(-MIN_ROWS_PER_WARP // ps)
    cap = max(1, min(MAX_SPLITS, SPLIT_BLOCKS // (B * KV)))
    ppw = min(MAX_PAGES_PER_WARP, max(ppw, -(-nblk1 // (WARPS * cap))))
    bps = WARPS * ppw
    return -(-nblk1 // bps), bps


_SCRATCH: dict = {}


def _scratch(dev, stream, n):
    """fp32 scratch of at least ``n`` elements for the split kernel's
    partials, or ``None`` (a null pointer) when one split covers the table.

    Calls on one stream run in order (the next call's split kernel starts
    after this call's combine kernel), so each (device, stream) keeps one
    buffer, grown as needed, and a call pays no allocation; another stream
    gets its own.  Under CUDA-graph capture the scratch is allocated afresh
    from the graph's pool, so that every captured graph owns its own."""
    if n == 0:
        return None
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(n, dtype=torch.float32, device=dev)
    buf = _SCRATCH.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[dev, stream] = torch.empty(n, dtype=torch.float32,
                                                  device=dev)
    return buf


def _check(who, q, kp, vp, pt, pos, *, hd_multiple, scales=()):
    """The checks both kernels' wrappers make before a launch: devices,
    index dtypes, shapes, the kernels' limits, contiguity and the current
    device.  Raises on anything the kernels do not take; returns the
    device's index.  Written for the host's clock: a decode step calls it
    once per attention layer and model, thousands of times."""
    B, one, H, hd = q.shape
    P, ps, KV, hd_k = kp.shape
    tensors = (q, kp, vp, pt, pos, *scales)
    dev = q.get_device()                       # -1 off the card
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        name, t = next((n, t) for n, t in zip(
            ("q", "kp", "vp", "pt", "pos", "ks", "vs"), tensors)
            if not t.is_cuda or t.device != q.device)
        raise ValueError(f"{who}: {name} must be on {q.device} (CUDA), "
                         f"got {t.device}")
    if pt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{who}: pt and pos must be int32")
    if one != 1 or hd_k != hd or vp.shape != kp.shape or H % KV \
            or pt.dim() != 2 or pt.shape[0] != B or pos.shape != (B,) \
            or any(t.shape != (P, KV) for t in scales):
        raise ValueError(f"{who}: bad shapes " + " ".join(
            f"{name} {tuple(t.shape)}" for name, t in zip(
                ("q", "kp", "vp", "pt", "pos", "ks", "vs"), tensors)))
    if H // KV > MAX_GROUP or hd > MAX_HEAD_DIM or hd % hd_multiple \
            or ps > MAX_PAGE:
        raise ValueError(f"{who}: needs H/KV <= {MAX_GROUP}, head_dim <= "
                         f"{MAX_HEAD_DIM} and a multiple of {hd_multiple}, "
                         f"page size <= {MAX_PAGE}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError(f"{who}: pools, scales, pt and pos must be "
                         f"contiguous")
    if dev != torch.cuda.current_device():
        raise ValueError(f"{who}: tensors on {q.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return dev


def _aligned(who, *ptrs):
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{who}: tensors must be 16-byte aligned")


def _partials(B, KV, H, hd, splits):
    """fp32 elements of the partials (acc, m, l of each (row, kv head,
    split)); 0 for a single split, whose blocks write the output."""
    return 0 if splits == 1 else B * H * splits * (hd + 2)


def _stream(dev):
    """The current stream's handle, as an int.  torch.cuda.current_stream
    builds a Stream object (about 5 microseconds of host time on the H100
    machines, a third of this wrapper's); the raw getter, which PyTorch's
    own Triton launchers use, does not."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _library():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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
    dev = _check(who, q, kp, vp, pt, pos,
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
    nblk1 = pt.shape[1]
    splits, bps = split_plan(B, KV, nblk1, ps)
    stream = _stream(dev)
    part = _scratch(dev, stream, _partials(B, KV, H, hd, splits))
    ptrs = [t.data_ptr() for t in (q, kp, vp, pt, pos, out)]
    _aligned(who, *ptrs[:3], ptrs[5])
    err = _library()(
        *ptrs, None if part is None else part.data_ptr(), B, H, KV, hd, ps,
        nblk1, int(window), float(hd ** -0.5 if scale is None else scale),
        splits, bps, code, stream)
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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    dev = _check(who, q, kp, vp, pt, pos, hd_multiple=4, scales=(ks, vs))
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
    nblk1 = pt.shape[1]
    splits, bps = split_plan(B, KV, nblk1, ps)
    stream = _stream(dev)
    part = _scratch(dev, stream, _partials(B, KV, H, hd, splits))
    ptrs = [t.data_ptr() for t in (q, kp, vp, ks, vs, pt, pos, out)]
    _aligned(who, *ptrs[:3], ptrs[7])
    err = _quant_library()(
        *ptrs, None if part is None else part.data_ptr(), B, H, KV, hd, ps,
        nblk1, int(window),
        float(hd ** -0.5 if scale is None else scale), splits, bps,
        _DTYPE_CODE[q.dtype], _CODE_KIND[kp.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention_quant kernel launch failed: "
                           f"CUDA error {err}")
    paged_attention_quant_cuda.launches += 1
    return out


paged_attention_quant_cuda.launches = 0
