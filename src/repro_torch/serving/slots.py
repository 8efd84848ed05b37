"""Slot-pool KV-cache management for the continuous-batching scheduler.

The engine's state is a fixed-capacity batch: every row ("slot") owns one
row of each of the three committed caches (draft pi_S, target pi_B, PRM),
``pos``/``pending``/``done`` bookkeeping, and — while occupied — one live
request.  :class:`SlotPool` is the host-side ledger mapping slots to
request ids; the array-level work (zeroing freed rows, masked prompt
prefill) lives in ``serving/engine.py::reset_cache_rows`` and
``GSIServingEngine._admit``.

Why slots are safe to reuse without re-allocating caches: the decode
attention mask only admits cache positions ``<= pos``, so after a slot's
``pos`` is reset to 0 the previous occupant's KV is invisible and gets
overwritten as the new request advances; recurrent/RWKV state and ring
buffers are explicitly zeroed by ``reset_cache_rows``.

Under the paged cache a slot no longer *owns* its rows: its block table
may splice in pages shared with other slots (or retained by the radix
prefix cache), so freeing a slot decrements per-page refcounts in
:class:`~repro_torch.serving.pages.PagePool` — never zeroes shared rows.
``pack_tails`` builds the tail-only prefill array for prefix-cache hits
(the matched prefix is spliced, not re-committed).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

PAD = 0


@dataclass
class SlotPool:
    """Fixed-capacity slot ledger: request id per slot (None = free)."""
    capacity: int
    slot_request: List[Optional[str]] = field(default=None)

    def __post_init__(self):
        """Start all-free and build the O(1) request-id -> slot map."""
        if self.slot_request is None:
            self.slot_request = [None] * self.capacity
        assert len(self.slot_request) == self.capacity
        # request-id -> slot index, kept in sync by claim/release so
        # slot_of is O(1) (it runs per finished request per step)
        self._slot_of: Dict[str, int] = {
            r: i for i, r in enumerate(self.slot_request) if r is not None}

    # -- queries -------------------------------------------------------
    def free_slots(self) -> List[int]:
        """Slot indices currently holding no request (ascending)."""
        return [i for i, r in enumerate(self.slot_request) if r is None]

    def live_slots(self) -> List[int]:
        """Slot indices currently occupied by a request (ascending)."""
        return [i for i, r in enumerate(self.slot_request) if r is not None]

    @property
    def num_free(self) -> int:
        """Number of free slots."""
        return len(self.free_slots())

    @property
    def num_live(self) -> int:
        """Number of occupied (decoding) slots."""
        return self.capacity - self.num_free

    def request_of(self, slot: int) -> Optional[str]:
        """Request id occupying ``slot`` (None when free)."""
        return self.slot_request[slot]

    def slot_of(self, request_id: str) -> Optional[int]:
        """Slot a live request occupies (None when not live); O(1)."""
        return self._slot_of.get(request_id)

    # -- transitions ---------------------------------------------------
    def claim(self, slot: int, request_id: str) -> None:
        """Bind a request id to a free slot (raises if occupied)."""
        if self.slot_request[slot] is not None:
            raise ValueError(f"slot {slot} already holds "
                             f"{self.slot_request[slot]!r}")
        self.slot_request[slot] = request_id
        self._slot_of[request_id] = slot

    def release(self, slot: int) -> str:
        """Free an occupied slot; returns the request id it held."""
        rid = self.slot_request[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is already free")
        self.slot_request[slot] = None
        del self._slot_of[rid]
        return rid


def pack_tails(prompts: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Shift each packed prompt row left past its prefix-cache match.

    ``prompts``: (B, W) PAD-padded admission array; ``starts``: (B,) match
    lengths.  Row b of the result is ``prompts[b, starts[b]:]`` padded back
    to width W — the tail the engine actually prefills (``tails[b, 0]``
    seeds ``pending`` at position ``starts[b]``).  Width is preserved, as
    in the reference.
    """
    prompts = np.asarray(prompts, np.int32)
    starts = np.asarray(starts, np.int64)
    B, W = prompts.shape
    if not starts.any():
        return prompts
    tails = np.full((B, W), PAD, np.int32)
    for b in range(B):
        s = int(starts[b])
        if not 0 <= s < W:
            raise ValueError(f"start {s} outside prompt width {W}")
        tails[b, :W - s] = prompts[b, s:]
    return tails


def pack_prompts(prompts: Dict[int, np.ndarray], capacity: int,
                 pad_len: int) -> np.ndarray:
    """Build the (capacity, pad_len) admission array: slot -> prompt tokens,
    PAD everywhere else (non-admitted rows are inert under row_live)."""
    out = np.full((capacity, pad_len), PAD, np.int32)
    for slot, toks in prompts.items():
        toks = np.asarray(toks, np.int32)
        if toks.ndim != 1 or toks.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if toks.size > pad_len:
            raise ValueError(f"prompt length {toks.size} > pad_len {pad_len}")
        out[slot, :toks.size] = toks
    return out
