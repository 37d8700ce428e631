"""Architecture registry of the port: ``get_arch(name)`` / ``list_archs()``
(the counterpart of ``repro.configs``).

Each module defines CONFIG (the exact assigned dimensions) and
SMOKE_CONFIG (a reduced same-family config for CPU tests), equal to the
reference's. All ten architectures build; on one 80 GB card the dense
ones, InternVL2-1B, MusicGen-medium and RWKV6-1.6B run whole, Jamba (52B)
runs cut in depth, and Granite-34B, Kimi-K2 (1T) and Llama-4 Maverick
(400B) are counted on the meta device (``models.count_params``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "smollm_360m",
    "granite_34b",
    "qwen3_0_6b",
    "qwen1_5_0_5b",
    "jamba_v0_1_52b",
    "internvl2_1b",
    "rwkv6_1_6b",
    "kimi_k2_1t_a32b",
    "llama4_maverick_400b_a17b",
    "musicgen_medium",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    """The ``ArchConfig`` of ``name`` (or its smoke config)."""
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def list_archs() -> list[str]:
    """The architecture IDs, in the reference's order."""
    return list(ARCH_IDS)
