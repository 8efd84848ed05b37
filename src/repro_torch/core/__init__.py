"""The paper's decision math (model-free): tilting, soft best-of-n, GSI, RSD."""
from repro_torch.core.sbon import soft_bon_select  # noqa: F401
from repro_torch.core.tilting import tilted_rewards  # noqa: F401
from repro_torch.core.gsi import GSIDecision, gsi_select  # noqa: F401
from repro_torch.core.rsd import RSDDecision, rsd_select  # noqa: F401
