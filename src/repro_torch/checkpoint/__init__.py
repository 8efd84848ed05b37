"""Checkpoints of the port's flat parameter dicts."""
from repro_torch.checkpoint.ckpt import (load_checkpoint,  # noqa: F401
                                         save_checkpoint)
