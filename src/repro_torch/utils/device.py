"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises.

    The port's entry points never fall back to the CPU on their own:
    running there is the caller's explicit ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_generator(seed, device) -> torch.Generator:
    """``seed`` as a ``torch.Generator`` for ``device``: an int seeds a new
    one there; a generator must already live on that device type."""
    device = torch.device(device)
    if isinstance(seed, torch.Generator):
        if seed.device.type != device.type:
            raise ValueError(f"generator on {seed.device}, work on {device}")
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def full_precision_matmul() -> None:
    """Keep float32 products in full float32 (no TF32) on the card.

    A TF32 ``x @ a`` changes QALSH ranks and therefore the buckets, so
    the fit and predict entry points call this before any product.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def parts_to_device(parts: tuple, device) -> tuple:
    """Move raw parts to ``device`` with the types JAX would give them
    (64-bit off): floats as float32, integers as int32, bool masks as
    bool; ``None`` parts stay ``None``."""
    out = []
    for p in parts:
        if p is not None:
            p = torch.as_tensor(p, device=device)
            if p.dtype.is_floating_point:
                p = p.to(torch.float32)
            elif p.dtype != torch.bool:
                p = p.to(torch.int32)
        out.append(p)
    return tuple(out)


def tree_to(obj, device):
    """``obj`` with every tensor in it moved to ``device``: dataclasses
    (a ``GeekModel``, its index and transform), named tuples, tuples and
    lists are rebuilt around the moved tensors; anything else is kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_to(v, device) for v in obj)
    return obj


def indexed(device) -> torch.device:
    """``device`` resolved (``resolve_device``) with its index made
    explicit (``cuda`` -> ``cuda:<current>``), so that it compares equal
    to a tensor's ``.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
