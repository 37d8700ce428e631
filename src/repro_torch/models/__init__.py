"""The LM substrate of the port: dense attention + MLP stacks."""
from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.convert import params_from_numpy  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    count_params,
    decode_step,
    forward,
    init_params,
    prefill_step,
)
