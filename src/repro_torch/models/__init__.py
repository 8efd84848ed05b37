"""Model stack of the port (decode path)."""
from repro_torch.models.model import (Model, layer_slots,  # noqa: F401
                                      param_specs, random_params)
