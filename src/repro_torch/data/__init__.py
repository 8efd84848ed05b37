"""Training and evaluation data of the port (numpy, host side)."""
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticReasoningTask, VOCAB, PAD, SEP, EOS)
from repro_torch.data.lm import lm_batches  # noqa: F401
