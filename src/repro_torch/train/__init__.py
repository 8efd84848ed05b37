"""Training of the port: losses, train steps and the host loop."""
from repro_torch.train.trainer import (Trainer, lm_loss,  # noqa: F401
                                       make_prm_train_step, make_train_step,
                                       prm_loss)
