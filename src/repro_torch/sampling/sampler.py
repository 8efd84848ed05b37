"""Token sampling + reasoning-step generation / scoring.

A port of ``repro.sampling.sampler``: the reference's ``lax.scan`` loops
become Python loops over ``Model.decode_step``, which writes each token's
K/V (or RWKV state) into the cache in place; rows that are done, or whose
fed token is not kept, pass ``live=False`` so their recurrent state stays
frozen, as in the reference.  A *reasoning step* ends at the sep token or
EOS.  Categorical sampling is ``argmax(logits + Gumbel noise)``, exactly how
``jax.random.categorical`` samples; the noise comes from a
``torch.Generator`` or, for tests, is passed in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PAD = 0


class StepBatch(NamedTuple):
    tokens: torch.Tensor     # (B, L) sampled step tokens (PAD after end)
    length: torch.Tensor     # (B,) tokens in the step (incl. sep/eos)
    logprob: torch.Tensor    # (B,) sum log pi(token) over the step
    ended: torch.Tensor      # (B,) step terminated naturally (sep or eos)
    eos: torch.Tensor        # (B,) step terminated with EOS
    positions: torch.Tensor  # (B,) position after the step


def gumbel_noise(gen, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` drawn from ``gen``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def top_p_filter(logits, top_p: float):
    """Nucleus filtering by cutoff value: every token whose logit is >= the
    boundary token's logit is kept, so boundary ties are all kept."""
    if top_p >= 1.0:
        return logits
    sort = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sort, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p
    cutoff = torch.where(keep_sorted, sort, torch.inf).min(
        dim=-1, keepdim=True).values
    return torch.where(logits >= cutoff, logits, -1e30)


def sample_token(gen, logits, temperature: float = 1.0, top_p: float = 1.0,
                 gumbel=None):
    """logits: (B,V) -> tokens (B,). Greedy when temperature == 0.

    ``gumbel`` (B,V) replaces the generator's draw (tests feed both sides
    the same noise)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / max(temperature, 1e-6)
    scaled = top_p_filter(scaled, top_p)
    if gumbel is None:
        gumbel = gumbel_noise(gen, scaled.shape, scaled.device)
    return torch.argmax(scaled + gumbel, dim=-1)


@torch.no_grad()
def sample_steps(model, cache, last_token, positions, gen, *,
                 max_tokens: int, sep_token: int, eos_token: int,
                 temperature: float = 0.7, top_p: float = 1.0,
                 already_done=None, pt=None) -> StepBatch:
    """Sample one reasoning step per request into ``cache`` (in place).

    last_token/positions: (B,) — the last committed token and its position.
    ``logprob`` is the *model* log-likelihood of the sampled tokens
    (temperature affects sampling only).  Every row runs ``max_tokens``
    decode steps, as the reference's scan does; finished rows emit PAD.
    """
    B = last_token.shape[0]
    dev = last_token.device
    done = torch.zeros(B, dtype=torch.bool, device=dev) \
        if already_done is None else already_done
    tok, pos = last_token, positions
    lp = torch.zeros(B, dtype=torch.float32, device=dev)
    toks = []
    for _ in range(max_tokens):
        logits = model.decode_step(cache, tok[:, None], pos, pt=pt,
                                   live=~done)
        nxt = sample_token(gen, logits, temperature, top_p)
        logp_all = torch.log_softmax(logits.float(), dim=-1)
        logp_tok = torch.gather(logp_all, 1, nxt[:, None])[:, 0]
        nxt = torch.where(done, PAD, nxt)
        lp = lp + torch.where(done, 0.0, logp_tok)
        ended_now = (nxt == sep_token) | (nxt == eos_token)
        pos = torch.where(done, pos, pos + 1)
        done = done | ended_now
        tok = nxt
        toks.append(nxt)
    tokens = torch.stack(toks, dim=1)                   # (B, L)
    length = (tokens != PAD).sum(dim=1)
    eos = (tokens == eos_token).any(dim=1)
    return StepBatch(tokens, length, lp, done, eos, pos)


@torch.no_grad()
def score_and_append(model, cache, last_token, positions, step_tokens, *,
                     return_rewards: bool = False, row_live=None, pt=None):
    """Teacher-force ``step_tokens`` (B,L; PAD-padded) into ``cache``.

    Returns (logprob (B,), new_positions[, rewards (B,)]).  ``rewards`` (PRM
    models) is the reward head at the *last* real token of each step.  The
    cache advances by exactly the real tokens.  ``row_live`` (B,) freezes
    whole rows regardless of their tokens (prompt prefill into some slots
    while the others pass through untouched).
    """
    B, L = step_tokens.shape
    dev = step_tokens.device
    tok, pos = last_token, positions
    lp = torch.zeros(B, dtype=torch.float32, device=dev)
    rw = torch.zeros(B, dtype=torch.float32, device=dev)
    fed_live = torch.ones(B, dtype=torch.bool, device=dev)
    # one extra PAD iteration so the reward of the final token is captured
    xs = torch.cat([step_tokens,
                    torch.zeros((B, 1), dtype=step_tokens.dtype, device=dev)],
                   dim=1)
    for t in range(L + 1):
        target = xs[:, t]
        live = target != PAD
        if row_live is not None:
            live = live & row_live
        out = model.decode_step(cache, tok[:, None], pos, live=live,
                                return_hidden=return_rewards, pt=pt)
        if return_rewards:
            logits, hidden = out
            # reward of the token *fed* this iteration, if it was a real one
            rw = torch.where(fed_live, model.reward_from_hidden(hidden), rw)
        else:
            logits = out
        logp_all = torch.log_softmax(logits.float(), dim=-1)
        lp_tok = torch.gather(logp_all, 1, target.clamp(min=0)[:, None])[:, 0]
        lp = lp + torch.where(live, lp_tok, 0.0)
        pos = torch.where(live, pos + 1, pos)
        tok = torch.where(live, target, tok)
        fed_live = live
    if return_rewards:
        return lp, pos, rw
    return lp, pos
