"""Token-level speculative decoding (Leviathan et al., 2023) — baseline.

A port of ``repro.core.spec_decode``.  Given k draft tokens with
draft/target probabilities, accept each token with prob min(1, p_B/p_S);
on first rejection resample from the residual distribution
max(0, p_B - p_S).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sampling.sampler import gumbel_noise


class SpecDecodeResult(NamedTuple):
    num_accepted: torch.Tensor   # (B,) tokens accepted (0..k)
    accept_mask: torch.Tensor    # (B,k)
    resample_tok: torch.Tensor   # (B,) token drawn from residual at rejection


def speculative_verify(gen, draft_tokens, logits_S, logits_B, *,
                       uniform=None, gumbel=None) -> SpecDecodeResult:
    """draft_tokens: (B,k); logits_*: (B,k,V) at each draft position.

    The acceptance uniforms (B,k) and the resample's Gumbel noise (B,V)
    come from ``gen``, or from ``uniform`` and ``gumbel`` when given (a
    test injects the reference's draws).  Exactness: the output sequence
    is distributed as target sampling.
    """
    B, k, V = logits_B.shape
    dev = logits_B.device
    p_S = torch.softmax(logits_S.float(), dim=-1)
    p_B = torch.softmax(logits_B.float(), dim=-1)
    tok = draft_tokens.long()[..., None]
    ps = torch.gather(p_S, -1, tok)[..., 0]              # (B,k)
    pb = torch.gather(p_B, -1, tok)[..., 0]
    if uniform is None:
        uniform = torch.rand((B, k), generator=gen, device=dev)
    ok = uniform < torch.clamp(pb / torch.clamp(ps, min=1e-20), max=1.0)
    # accepted prefix length = index of the first rejection (k if none)
    first_rej = torch.argmin(torch.cat(
        [ok, torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1).int(),
        dim=1)
    accept_mask = torch.arange(k, device=dev)[None, :] < first_rej[:, None]
    # residual resample at the first rejected position
    rows = torch.arange(B, device=dev)
    pos = torch.clamp(first_rej, max=k - 1)
    pb_pos, ps_pos = p_B[rows, pos], p_S[rows, pos]
    resid = torch.clamp(pb_pos - ps_pos, min=0.0)
    resid = resid / torch.clamp(torch.sum(resid, -1, keepdim=True),
                                min=1e-20)
    # fall back to the target distribution if the residual is degenerate
    degenerate = torch.sum(resid, -1) < 1e-6
    dist = torch.where(degenerate[:, None], pb_pos, resid)
    if gumbel is None:
        gumbel = gumbel_noise(gen, dist.shape, dev)
    resample = torch.argmax(torch.log(torch.clamp(dist, min=1e-20)) + gumbel,
                            dim=-1)
    return SpecDecodeResult(first_rej, accept_mask, resample)
