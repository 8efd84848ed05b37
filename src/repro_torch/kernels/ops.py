"""Public kernel entry points: the tensor's device picks the implementation.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written CUDA kernel, which launches or raises.  There is no
switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                logprob_gather_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain,
                                                 paged_attention_quant_cuda,
                                                 paged_attention_quant_plain)
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                            rwkv6_scan_plain)


def flash_attention(q, k, v, *, causal=True, window: int = 0, scale=None):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
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
    -> (out (B,T,H,hd) fp32, final state fp32)."""
    if r.is_cuda:
        return rwkv6_scan_cuda(r, k, v, w, u, state)
    return rwkv6_scan_plain(r, k, v, w, u, state)
