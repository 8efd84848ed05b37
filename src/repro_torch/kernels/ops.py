"""Public kernel entry points: the tensor's device picks the implementation.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written CUDA kernel, which launches or raises.  There is no
switch that sends a CUDA tensor to the plain version.  Flash attention and
the WKV6 scan on inputs that require a gradient go through their autograd
Functions, whose backward is the backward kernel on a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                logprob_gather_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain,
                                                 paged_attention_quant_cuda,
                                                 paged_attention_quant_plain)
from repro_torch.kernels.rwkv6_scan import (WKV6Scan, rwkv6_scan_cuda,
                                            rwkv6_scan_cuda_,
                                            rwkv6_scan_plain,
                                            rwkv6_scan_plain_)


def flash_attention(q, k, v, *, causal=True, window: int = 0, scale=None):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd); differentiable
    when an input requires a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 scale=scale)


def paged_attention(q, kp, vp, pt, pos, *, window: int = 0, scale=None):
    """q: (B,1,H,hd); kp/vp: (P,ps,KV,hd); pt: (B,nblk); pos: (B,)."""
    if q.is_cuda:
        return paged_attention_cuda(q, kp, vp, pt, pos, window=window,
                                    scale=scale)
    return paged_attention_plain(q, kp, vp, pt, pos, window=window,
                                 scale=scale)


def paged_attention_quant(q, kp, vp, ks, vs, pt, pos, *, window: int = 0,
                          scale=None):
    """Quantized pools: kp/vp (P,ps,KV,hd) int8/fp8 codes, ks/vs (P,KV)
    float32 per-page per-kv-head scales; otherwise as paged_attention."""
    if q.is_cuda:
        return paged_attention_quant_cuda(q, kp, vp, ks, vs, pt, pos,
                                          window=window, scale=scale)
    return paged_attention_quant_plain(q, kp, vp, ks, vs, pt, pos,
                                       window=window, scale=scale)


def logprob_gather(h, w, labels, vocab_size: int):
    """log_softmax(h @ w)[labels] over the first ``vocab_size`` columns.

    h: (B,S,d); w: (d,V); labels: (B,S) -> (B,S) float32 log-probs.
    """
    if h.is_cuda:
        return logprob_gather_cuda(h, w, labels, vocab_size)
    return logprob_gather_plain(h, w, labels, vocab_size)


def rwkv6_scan(r, k, v, w, u, state):
    """WKV6 recurrence: r/k/v/w (B,T,H,hd), u (H,hd), state (B,H,hd,hd)
    -> (out (B,T,H,hd) fp32, final state fp32); differentiable when an
    input requires a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV6Scan.apply(r, k, v, w, u, state)
    if r.is_cuda:
        return rwkv6_scan_cuda(r, k, v, w, u, state)
    return rwkv6_scan_plain(r, k, v, w, u, state)


def rwkv6_scan_(r, k, v, w, u, state, live=None):
    """The in-place WKV6 recurrence of a decode step: the final state is
    written over ``state`` (B,H,hd,hd) fp32 in the rows where ``live`` (B,)
    bool is True (every row when None), the others keep theirs bit for
    bit.  Returns ``out (B,T,H,hd) fp32``, computed for every row."""
    if r.is_cuda:
        return rwkv6_scan_cuda_(r, k, v, w, u, state, live)
    return rwkv6_scan_plain_(r, k, v, w, u, state, live)
