"""Fused log-softmax + label gather: the plain PyTorch version and the kernel.

``out[b, s] = log_softmax(h[b, s] @ w)[labels[b, s]]`` over the first
``vocab_size`` columns of ``w (d, V)`` (the padded columns are masked), in
fp32.  The GSI scoring pass reads the log-likelihood of every candidate
token through it.

* :func:`logprob_gather_plain` mirrors ``repro.kernels.ref.
  logprob_gather_ref``: the full fp32 logits, a masked logsumexp and a
  gather.  The CPU path, and the yardstick the kernel is held to.
* :func:`logprob_gather_cuda` launches ``csrc/logprob_gather.cu`` (the
  Hopper kernels that replace ``logprob_gather_pallas``; the ``(T, V)``
  logits never reach device memory) and counts its launches in
  ``logprob_gather_cuda.launches``.  bf16 W goes to the TMA/wgmma kernel:
  bf16 h as it is, fp32 h as the three bf16 parts of :func:`bf16_split`;
  fp32 h over fp32 W (the toy models) to the CUDA-core kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, streams

NEG = -1e30
# (tokens per block, vocab columns per strip, blocks per SM the vocab split
# aims at) of the TMA/wgmma kernel (bf16 W: 192 KB of shared memory, one
# block an SM) and of the CUDA-core kernel (fp32 W)
HOPPER_TILES = (128, 256, 1)
FP32_TILES = (64, 64, 4)
# (h, w) dtype pairs the kernels take -> the C interface's h dtype code
# (2: fp32 h as three bf16 parts) and w dtype code
_CODES = {(torch.bfloat16, torch.bfloat16): (1, 1),
          (torch.float32, torch.bfloat16): (2, 1),
          (torch.float32, torch.float32): (0, 0)}


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


def bf16_split(h):
    """Three bf16 parts of fp32 ``h`` stacked as ``(3, *h.shape)``:
    h1 = bf16(h), h2 = bf16(h - h1), h3 = bf16(h - h1 - h2).  Each
    subtraction is exact in fp32 and each part takes the next 8 bits, so
    h1 + h2 + h3 leaves a residual below 2^-24 |h|; since a bf16 x bf16
    product is exact in fp32, sum_i h_i @ W on the tensor cores is h @ W in
    fp32 up to summation order."""
    h = h.float()
    h1 = h.bfloat16()
    r = h - h1.float()
    h2 = r.bfloat16()
    return torch.stack((h1, h2, (r - h2.float()).bfloat16()))


def vocab_split(tokens: int, vocab_size: int, sms: int, tiles):
    """``(tiles_per_split, nsplit)``: the vocabulary's strips (``tiles[1]``
    columns) cut so that token tiles (``tiles[0]`` tokens) x splits is
    about ``tiles[2]`` blocks per SM, with no split empty."""
    token_tile, strip, per_sm = tiles
    ttiles = -(-tokens // token_tile)
    vtiles = -(-vocab_size // strip)
    want = max(1, min(vtiles, -(-per_sm * sms // ttiles)))
    per = -(-vtiles // want)
    return per, -(-vtiles // per)


def logprob_gather_cuda(h, w, labels, vocab_size: int):
    """Launch the CUDA kernels (partials over vocab splits, then their
    merge) on the current stream; same contract as
    :func:`logprob_gather_plain`.  ``w`` is read through its strides, one of
    which must be 1 (a row-major ``(d, V)`` matrix or the transpose of a
    row-major ``(V, d)`` one, such as a tied embedding's ``.T``); ``h`` is
    made contiguous (fp32 h over bf16 W: split by :func:`bf16_split`) and
    ``labels`` int32.  Raises on anything the kernel does not take, and on
    a failed launch."""
    B, S, d = h.shape
    d_w, V = w.shape
    for name, t in (("h", h), ("w", w), ("labels", labels)):
        if not t.is_cuda or t.device != h.device:
            raise ValueError(f"logprob_gather_cuda: {name} must be on "
                             f"{h.device} (CUDA), got {t.device}")
    if (h.dtype, w.dtype) not in _CODES:
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
    hcode, wcode = _CODES[(h.dtype, w.dtype)]
    # rows of whole 16-byte chunks (h and its parts share W's dtype, or are
    # fp32 with fp32 W); the fp32 kernel's copies also read V-wide rows
    e = 16 // w.element_size()
    if d % e or ldw % e or (not wcode and not kcontig and V % e) \
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
    if hcode == 2:
        hf = bf16_split(hf)
    lab = labels.reshape(T).to(torch.int32).contiguous()
    if hf.data_ptr() % 16:
        raise ValueError("logprob_gather_cuda: h must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    per, nsplit = vocab_split(T, vocab_size, sms,
                              HOPPER_TILES if wcode else FP32_TILES)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=h.device)
    err = _library()(hf.data_ptr(), w.data_ptr(), lab.data_ptr(),
                     part.data_ptr(), out.data_ptr(), T, d, V,
                     int(vocab_size), ldw, kcontig, per, nsplit, hcode,
                     wcode, torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"logprob_gather kernel launch failed: CUDA error "
                           f"{err}")
    streams.launched(logprob_gather_cuda)
    return out.reshape(B, S)


logprob_gather_cuda.launches = 0
