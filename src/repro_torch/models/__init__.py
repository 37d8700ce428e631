"""The LM substrate of the port: attention, Mamba and RWKV6 mixers, MLP
and MoE feed-forwards, the ten architectures of ``repro_torch.configs``,
and the training loss."""
from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.convert import (  # noqa: F401
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models.model import (  # noqa: F401
    cache_specs,
    count_active_params,
    count_params,
    decode_step,
    forward,
    init_params,
    param_specs,
    prefill_step,
    train_loss,
)
