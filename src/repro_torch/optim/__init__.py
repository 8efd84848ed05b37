"""Optimizers of the port."""
from repro_torch.optim.adamw import (AdamW, clip_by_global_norm,  # noqa: F401
                                     cosine_schedule)
