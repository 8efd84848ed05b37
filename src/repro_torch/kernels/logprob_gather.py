"""Fused log-softmax + label gather: the plain PyTorch version and the kernel.

``out[b, s] = log_softmax(h[b, s] @ w)[labels[b, s]]`` over the first
``vocab_size`` columns of ``w (d, V)`` (the padded columns are masked), in
fp32.  The GSI scoring pass reads the log-likelihood of every candidate
token through it.

* :func:`logprob_gather_plain` mirrors ``repro.kernels.ref.
  logprob_gather_ref``: the full fp32 logits, a masked logsumexp and a
  gather.  The CPU path, and the yardstick the kernel is held to.
* :func:`logprob_gather_cuda` launches ``csrc/logprob_gather.cu`` (the
  Hopper kernel that replaces ``logprob_gather_pallas``; the ``(T, V)``
  logits never reach device memory) and counts its launches in
  ``logprob_gather_cuda.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30
TOKEN_TILE = 64       # tokens per block of the kernel
VOCAB_TILE = 64       # vocab columns per tile of the kernel
BLOCKS_PER_SM = 4     # grid size the vocab split aims at
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (h, w) dtype pairs the kernel takes
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
          (torch.float32, torch.float32)}


def logprob_gather_plain(h, w, labels, vocab_size: int):
    """h: (B,S,d); w: (d,V); labels: (B,S) int -> (B,S) float32."""
    logits = h.float() @ w.float()
    V = logits.shape[-1]
    if vocab_size < V:
        valid = torch.arange(V, device=logits.device) < vocab_size
        logits = torch.where(valid, logits, NEG)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return picked - logz


def _library():
    lib = build.load("logprob_gather")
    fn = lib.logprob_gather_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def vocab_split(tokens: int, vocab_size: int, sms: int):
    """``(tiles_per_split, nsplit)``: the vocabulary's tiles cut so that
    token tiles x splits is about ``BLOCKS_PER_SM`` blocks per SM, with no
    split empty."""
    ttiles = -(-tokens // TOKEN_TILE)
    vtiles = -(-vocab_size // VOCAB_TILE)
    want = max(1, min(vtiles, -(-BLOCKS_PER_SM * sms // ttiles)))
    per = -(-vtiles // want)
    return per, -(-vtiles // per)


def logprob_gather_cuda(h, w, labels, vocab_size: int):
    """Launch the CUDA kernels (partials over vocab splits, then their
    merge) on the current stream; same contract as
    :func:`logprob_gather_plain`.  ``w`` is read through its strides, one of
    which must be 1 (a row-major ``(d, V)`` matrix or the transpose of a
    row-major ``(V, d)`` one, such as a tied embedding's ``.T``); ``h`` is
    made contiguous and ``labels`` int32.  Raises on anything the kernel
    does not take, and on a failed launch."""
    B, S, d = h.shape
    d_w, V = w.shape
    for name, t in (("h", h), ("w", w), ("labels", labels)):
        if not t.is_cuda or t.device != h.device:
            raise ValueError(f"logprob_gather_cuda: {name} must be on "
                             f"{h.device} (CUDA), got {t.device}")
    if (h.dtype, w.dtype) not in _PAIRS:
        raise TypeError(f"logprob_gather_cuda takes (h, w) dtypes "
                        f"bf16/bf16, fp32/bf16 or fp32/fp32, got {h.dtype}, "
                        f"{w.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError("logprob_gather_cuda: labels must be int32 or int64")
    if d_w != d or labels.shape != (B, S) or not 0 < vocab_size <= V:
        raise ValueError(f"logprob_gather_cuda: bad shapes h "
                         f"{tuple(h.shape)} w {tuple(w.shape)} labels "
                         f"{tuple(labels.shape)} vocab_size {vocab_size}")
    if w.stride(0) == 1 and d > 1:
        kcontig, ldw = 1, w.stride(1)         # W[k, n] at n * ldw + k
    elif w.stride(1) == 1:
        kcontig, ldw = 0, w.stride(0)         # W[k, n] at k * ldw + n
    else:
        raise ValueError(f"logprob_gather_cuda: w needs one unit stride, got "
                         f"strides {tuple(w.stride())}")
    ew, eh = 16 // w.element_size(), 16 // h.element_size()
    if d % eh or d % ew or ldw % ew or (not kcontig and V % ew) \
            or w.data_ptr() % 16:
        raise ValueError(f"logprob_gather_cuda: needs 16-byte aligned rows: "
                         f"d={d}, V={V}, leading stride {ldw}")
    T = B * S
    out = torch.empty(T, dtype=torch.float32, device=h.device)
    if T == 0:
        return out.reshape(B, S)
    if h.device.index != torch.cuda.current_device():
        raise ValueError(f"logprob_gather_cuda: tensors on {h.device} but "
                         f"the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    hf = h.reshape(T, d).contiguous()
    lab = labels.reshape(T).to(torch.int32).contiguous()
    if hf.data_ptr() % 16:
        raise ValueError("logprob_gather_cuda: h must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    per, nsplit = vocab_split(T, vocab_size, sms)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=h.device)
    err = _library()(hf.data_ptr(), w.data_ptr(), lab.data_ptr(),
                     part.data_ptr(), out.data_ptr(), T, d, V,
                     int(vocab_size), ldw, kcontig, per, nsplit,
                     _DTYPE_CODE[h.dtype], _DTYPE_CODE[w.dtype],
                     torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"logprob_gather kernel launch failed: CUDA error "
                           f"{err}")
    logprob_gather_cuda.launches += 1
    return out.reshape(B, S)


logprob_gather_cuda.launches = 0
