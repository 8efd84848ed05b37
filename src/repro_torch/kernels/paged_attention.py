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
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(B, 1, H, hd)


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
    :func:`paged_attention_plain`.  ``pt``/``pos`` must be int32, the
    pools contiguous; ``q`` is made contiguous.  Raises on anything the
    kernel does not take, and on a failed launch."""
    B, one, H, hd = q.shape
    P, ps, KV, hd_k = kp.shape
    tensors = {"q": q, "kp": kp, "vp": vp, "pt": pt, "pos": pos}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention_cuda: {name} must be on "
                             f"{q.device} (CUDA), got {t.device}")
    if q.dtype not in _DTYPE_CODE or kp.dtype != q.dtype \
            or vp.dtype != q.dtype:
        raise TypeError(f"paged_attention_cuda takes float32 or bfloat16 "
                        f"q/kp/vp of one dtype, got {q.dtype}, {kp.dtype}, "
                        f"{vp.dtype}")
    if pt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention_cuda: pt and pos must be int32")
    if one != 1 or hd_k != hd or vp.shape != kp.shape or H % KV \
            or pt.dim() != 2 or pt.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"paged_attention_cuda: bad shapes q {tuple(q.shape)}"
                         f" kp {tuple(kp.shape)} vp {tuple(vp.shape)} pt "
                         f"{tuple(pt.shape)} pos {tuple(pos.shape)}")
    vec = 16 // q.element_size()
    if H // KV > MAX_GROUP or hd > MAX_HEAD_DIM or hd % vec \
            or ps > MAX_PAGE:
        raise ValueError(f"paged_attention_cuda: needs H/KV <= {MAX_GROUP}, "
                         f"head_dim <= {MAX_HEAD_DIM} and a multiple of "
                         f"{vec}, page size <= {MAX_PAGE}")
    if not (kp.is_contiguous() and vp.is_contiguous()
            and pt.is_contiguous() and pos.is_contiguous()):
        raise ValueError("paged_attention_cuda: pools, pt and pos must be "
                         "contiguous")
    q = q.contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    for t in (q, kp, vp, out):
        if t.data_ptr() % 16:
            raise ValueError("paged_attention_cuda: tensors must be "
                             "16-byte aligned")
    if scale is None:
        scale = hd ** -0.5
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"paged_attention_cuda: tensors on {q.device} but "
                         f"the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    fn = _library()
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
             pos.data_ptr(), out.data_ptr(), B, H, KV, hd, ps, pt.shape[1],
             int(window), float(scale), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
