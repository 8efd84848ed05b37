"""Model stack of the port: full-sequence passes and decode steps."""
from repro_torch.models.model import (Model, layer_slots,  # noqa: F401
                                      param_specs, random_params)
