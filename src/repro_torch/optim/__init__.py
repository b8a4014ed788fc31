"""Optimizers and learning-rate schedules (the port's counterparts of
``repro.optim``)."""
from .optimizers import Optimizer, adamw, clip_by_global_norm, global_norm
from .schedule import constant_schedule, warmup_cosine

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "constant_schedule", "warmup_cosine"]
