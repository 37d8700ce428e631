"""Carry the reference's parameters into the port.

``params_from_numpy`` takes ``repro.models.init_params``' pytree with
numpy leaves (``jax.tree.map(np.asarray, params)``): ``layers`` a list,
one entry per position of the layer period, of dictionaries whose leaves
lead with the ``nper`` axis; ``final_norm``, ``head`` and ``embed``
dictionaries. It returns the port's tree: one dictionary per layer, in
layer order (layer ``li * period + pos`` is slice ``li`` of period
position ``pos``, as the reference's per-layer loop numbers them). The
``(in, out)`` weight layout and the dtype are kept, so the carry is a
copy, not a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.utils.device import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (float32, bfloat16 from ``ml_dtypes``, integer) as a
    tensor of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    period = cfg.period()
    if len(tree["layers"]) != period:
        raise ValueError(f"expected {period} period positions, got "
                         f"{len(tree['layers'])}")
    layers = [_tree(lambda a, i=i: tensor_from_numpy(
        np.asarray(a)[i // period], dev), tree["layers"][i % period])
        for i in range(cfg.num_layers)]
    out = {"layers": layers}
    for name, sub in tree.items():
        if name != "layers":
            out[name] = _tree(lambda a: tensor_from_numpy(a, dev), sub)
    return out
