from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    warmup_cosine,
)

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "warmup_cosine"]
