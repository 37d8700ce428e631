"""Architecture registry of the port: ``get_arch(name)`` / ``list_archs()``
(the counterpart of ``repro.configs``).

Each module defines CONFIG (the exact assigned dimensions) and
SMOKE_CONFIG (a reduced same-family config for CPU tests). The port
covers the dense attention + MLP architectures it runs; the others are
not ported yet and raise.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = ["smollm_360m", "qwen3_0_6b"]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    """The ``ArchConfig`` of ``name`` (or its smoke config); an ID the
    port does not cover raises ``NotImplementedError``."""
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP.md, Queue 1 "
            "item 15: the rest of the LM substrate)")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def list_archs() -> list[str]:
    """The architecture IDs the port builds."""
    return list(ARCH_IDS)
