from repro_torch.distributed.sharding import (
    batch_axes,
    batch_specs,
    cache_specs,
    opt_state_specs,
    param_specs,
)

__all__ = [
    "batch_axes",
    "batch_specs",
    "cache_specs",
    "opt_state_specs",
    "param_specs",
]
