from repro_torch.optim.adamw import (
    AdamWState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from repro_torch.optim.schedule import (
    constant,
    linear_decay,
    linear_warmup_cosine,
)

__all__ = [
    "AdamWState", "Optimizer", "adamw", "clip_by_global_norm",
    "constant", "global_norm", "linear_decay", "linear_warmup_cosine", "sgd",
]
