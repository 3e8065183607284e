"""Optimizers and gradient compression, ported from ``repro.optim``."""
from .compression import compress_int8, decompress_int8, error_feedback_update
from .optimizers import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)
