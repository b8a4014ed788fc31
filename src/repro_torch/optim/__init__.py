"""Optimizers, learning-rate schedules and int8 gradient compression (the
port's counterparts of ``repro.optim``)."""
from .grad_compress import (compress_state_init, compressed_gradients,
                            int8_compress, int8_decompress)
from .optimizers import Optimizer, adamw, clip_by_global_norm, global_norm
from .schedule import constant_schedule, warmup_cosine

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "constant_schedule", "warmup_cosine", "compress_state_init",
           "compressed_gradients", "int8_compress", "int8_decompress"]
