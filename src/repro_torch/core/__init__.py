"""The paper's decision math (model-free): tilting, soft best-of-n, GSI, RSD,
token-level speculative decoding, the theorems and the categorical toy."""
from repro_torch.core.sbon import (hard_bon_select,  # noqa: F401
                                   soft_bon_select, soft_bon_weights)
from repro_torch.core.tilting import (log_partition,  # noqa: F401
                                      tilted_policy, tilted_rewards)
from repro_torch.core.gsi import GSIDecision, gsi_select  # noqa: F401
from repro_torch.core.rsd import RSDDecision, rsd_select  # noqa: F401
from repro_torch.core import theory  # noqa: F401
from repro_torch.core.toy import ToyEnv  # noqa: F401
