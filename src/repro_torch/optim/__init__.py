"""Optimizers and learning-rate schedules of the port. Counterpart of
``repro/optim``."""
from repro_torch.optim.optimizers import OptState, adamw, apply_updates, inertia_sgd, sgd
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup

__all__ = ["OptState", "adamw", "apply_updates", "constant", "cosine_decay", "inertia_sgd",
           "linear_warmup", "sgd"]
