from .optimizers import (
    AdamState,
    FactorState,
    LionState,
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    lion,
    make_optimizer,
    opt_state_from_numpy,
    sgdm,
    state_pspec,
)
from .schedule import constant, inverse_sqrt, warmup_cosine

__all__ = ["AdamState", "FactorState", "LionState", "Optimizer", "adafactor",
           "adamw", "clip_by_global_norm", "constant", "inverse_sqrt", "lion",
           "make_optimizer", "opt_state_from_numpy", "sgdm", "state_pspec",
           "warmup_cosine"]
