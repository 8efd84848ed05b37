"""Public kernel entry points: the tensor's device picks the implementation.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written CUDA kernel, which launches or raises.  There is no
switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)


def paged_attention(q, kp, vp, pt, pos, *, window: int = 0, scale=None):
    """q: (B,1,H,hd); kp/vp: (P,ps,KV,hd); pt: (B,nblk); pos: (B,)."""
    if q.is_cuda:
        return paged_attention_cuda(q, kp, vp, pt, pos, window=window,
                                    scale=scale)
    return paged_attention_plain(q, kp, vp, pt, pos, window=window,
                                 scale=scale)
