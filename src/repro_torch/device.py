"""Device selection for the port's entry points: explicit, never silent."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but absent.

    Entry points default to ``"cuda"``.  A machine without a card must pass
    ``device="cpu"`` itself: nothing here falls back to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
