"""Sampling and reasoning-step generation of the port."""
from repro_torch.sampling.sampler import (PAD, StepBatch,  # noqa: F401
                                          gumbel_noise, sample_steps,
                                          sample_token, score_and_append,
                                          top_p_filter)
