"""Carry parameters (and state trees shaped like them) across the seam
between the reference's layout and the port's, both ways.

``params_from_numpy`` takes ``repro.models.init_params``' pytree with
numpy leaves (``jax.tree.map(np.asarray, params)``): ``layers`` a list,
one entry per position of the layer period, of dictionaries whose leaves
lead with the ``nper`` axis; ``final_norm``, ``head`` and ``embed``
dictionaries. It returns the port's tree: one dictionary per layer, in
layer order (layer ``li * period + pos`` is slice ``li`` of period
position ``pos``, as the reference's per-layer loop numbers them). The
``(in, out)`` weight layout and the dtype are kept, so the carry is a
copy, not a transpose.

``params_to_numpy`` is the inverse: the port's per-layer tensors stacked
back into the reference's period-stacked numpy tree. An optimizer state
whose subtrees mirror the parameters (AdamW's ``mu`` and ``nu``) crosses
either way subtree by subtree. numpy has no bfloat16 without
``ml_dtypes``, which the port does not use: a bfloat16 tensor becomes an
array of raw 2-byte words (dtype ``V2``, what ``np.load`` returns for
the reference's bfloat16 ``.npy`` files), and ``tensor_from_numpy``
reads ``V2`` arrays back as bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import P
from repro_torch.utils.device import resolve_device


#: numpy's name for the raw 2-byte words that carry a bfloat16 leaf
BF16_WORDS = np.dtype("V2")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (float32, bfloat16 from ``ml_dtypes`` or as raw
    ``V2`` words, integer) as a tensor of the same dtype on ``device``; a
    tensor is copied there."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_WORDS:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of its dtype that owns its memory
    (a copy, also of a CPU tensor); bfloat16 as raw ``V2`` words (its
    bits, unchanged)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy().view(BF16_WORDS)
    return t.to("cpu", copy=True).numpy()


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_reference_layout(tree, cfg: ArchConfig, leaf):
    """A tree in the reference's layout (``layers`` a list of period
    positions whose leaves lead with the ``nper`` axis) in the port's:
    ``leaf`` of each layer's slice of every stacked leaf (layer
    ``li * period + pos`` is slice ``li`` of position ``pos``), and of
    every other leaf."""
    period = cfg.period()
    if len(tree["layers"]) != period:
        raise ValueError(f"expected {period} period positions, got "
                         f"{len(tree['layers'])}")
    out = {"layers": [_tree(lambda a, i=i: leaf(a[i // period]),
                            tree["layers"][i % period])
                      for i in range(cfg.num_layers)]}
    for name, sub in tree.items():
        if name != "layers":
            out[name] = _tree(leaf, sub)
    return out


def _stack(fn, trees):
    """``fn`` on the list of leaves found at each place of ``trees``
    (dictionaries of one structure)."""
    if isinstance(trees[0], dict):
        return {k: _stack(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(trees)


def to_reference_layout(tree, cfg: ArchConfig, stack, leaf):
    """The port's per-layer tree (parameters, or a tree shaped like them)
    in the reference's layout: period position ``pos`` holds, at each
    leaf, ``stack`` of the list of that leaf over layers ``pos, pos +
    period, ...`` (the reference's ``nper`` axis, in order); every other
    leaf becomes ``leaf`` of it."""
    period = cfg.period()
    layers = tree["layers"]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"expected {cfg.num_layers} layers, got "
                         f"{len(layers)}")
    out = {"layers": [_stack(stack, layers[pos::period])
                      for pos in range(period)]}
    for name, sub in tree.items():
        if name != "layers":
            out[name] = _tree(leaf, sub)
    return out


def _stack_spec(specs):
    """The reference's spec of a period-stacked leaf: ``None`` (the
    stacking axis) in front of the layers' one spec."""
    if any(s != specs[0] for s in specs):
        raise ValueError(f"layers of one period position differ: {specs}")
    return P(None, *specs[0])


def specs_to_reference_layout(specs, cfg: ArchConfig):
    """A spec tree of the port (``param_specs``, an optimizer's
    ``state_specs`` subtree, or ``cache_specs``' list of layers) in the
    reference's period-stacked layout, each stacked leaf with a leading
    ``None``."""
    if isinstance(specs, list):
        return to_reference_layout({"layers": specs}, cfg, _stack_spec,
                                   None)["layers"]
    return to_reference_layout(specs, cfg, _stack_spec, lambda s: s)


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The reference's parameter pytree (numpy leaves, or tensors as
    ``CheckpointManager.restore`` gives them) as the port's parameters on
    ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    return from_reference_layout(tree, cfg,
                                 lambda a: tensor_from_numpy(a, dev))


def params_to_numpy(params, cfg: ArchConfig):
    """The port's parameters (or a tree shaped like them) as the
    reference's pytree with numpy leaves: ``layers`` period-stacked
    (stacked on the tensors' device, then copied to the host), the rest
    leaf by leaf. The inverse of ``params_from_numpy``."""
    return to_reference_layout(
        params, cfg, lambda ts: tensor_to_numpy(torch.stack(ts)),
        tensor_to_numpy)
