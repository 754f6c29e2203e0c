from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)

__all__ = [
    "Optimizer",
    "adafactor_init",
    "adafactor_update",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "make_optimizer",
]
