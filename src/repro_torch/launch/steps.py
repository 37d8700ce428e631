"""Step factories and abstract inputs for every (arch × shape) cell (the
counterpart of ``repro.launch.steps``).

Shapes (assignment):
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
    decode_32k   seq 32,768  global_batch 128   -> decode_step (serve)
    long_500k    seq 524,288 global_batch 1     -> decode_step (serve;
                 sub-quadratic archs only — full attention skips)

Abstract parameters, caches and batches are tensors on the ``meta``
device: shapes and dtypes, no storage (the reference's
``ShapeDtypeStruct`` stand-ins); ``batch_specs`` and ``token_specs``
return them with their logical PartitionSpecs (``models.sharding.P``),
as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as MODEL
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import P
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig):
    """The parameter tree on the ``meta`` device."""
    return MODEL._init(cfg, None, _META)


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int):
    """The per-layer caches on the ``meta`` device."""
    return T.stack_cache_init(cfg, batch, max_len, _META)


def batch_specs(cfg: ArchConfig, case: ShapeCase):
    """The data batch's shapes and dtypes, ``{"inputs", "labels"}`` on
    the ``meta`` device (token ids, or bf16 embeddings for stub
    frontends), and their logical PartitionSpecs."""
    B, S = case.batch, case.seq
    if MODEL.has_token_embed(cfg):
        inputs = torch.empty((B, S), dtype=torch.int32, device=_META)
        in_spec = P("dp", None)
    else:
        inputs = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                             device=_META)
        in_spec = P("dp", None, None)
    labels = torch.empty((B, S), dtype=torch.int32, device=_META)
    return ({"inputs": inputs, "labels": labels},
            {"inputs": in_spec, "labels": P("dp", None)})


def token_specs(cfg: ArchConfig, batch: int):
    """One decode step's input on the ``meta`` device and its logical
    PartitionSpec."""
    if MODEL.has_token_embed(cfg):
        return (torch.empty((batch, 1), dtype=torch.int32, device=_META),
                P("dp", None))
    return (torch.empty((batch, 1, cfg.d_model), dtype=torch.bfloat16,
                        device=_META), P("dp", None, None))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def loss_and_grads(cfg: ArchConfig, params, batch):
    """(loss, {"ce", "aux"}, grads): ``MODEL.train_loss`` and its gradient
    with respect to every parameter (``jax.value_and_grad``'s), grads in
    the parameters' dtypes and tree. ``params`` are not modified."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        live = [t.detach().requires_grad_() for t in leaves]
        loss, parts = MODEL.train_loss(tree_unflatten(treedef, live), cfg,
                                       batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_unflatten(treedef, grads))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    max_grad_norm: float = 1.0, grad_accum: int = 1,
                    accum_dtype=torch.float32):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, metrics)``, metrics ``{"loss", "grad_norm", "ce", "aux"}``.

    ``grad_accum > 1`` splits the batch's rows into that many
    micro-batches (micro-batch i is rows ``[i·mb, (i+1)·mb)``), sums
    their gradients in ``accum_dtype`` from zeros and averages, as the
    reference's scan does: peak activation memory drops ~grad_accum
    times. Then ``aux`` is reported as 0 and ``ce`` as the mean loss, as
    the reference reports them."""

    def train_step(params, opt_state, step, batch):
        if grad_accum == 1:
            loss, parts, grads = loss_and_grads(cfg, params, batch)
        else:
            mb = next(iter(batch.values())).shape[0] // grad_accum
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, _, g = loss_and_grads(cfg, params, micro)
                gsum = tree_map(lambda s, x: s + x.to(accum_dtype), gsum, g)
                lsum = lsum + loss
                del g
            grads = tree_map(lambda g: g / grad_accum, gsum)
            loss = lsum / grad_accum
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        new_params, new_state = optimizer.update(grads, opt_state, params,
                                                 step)
        metrics = {"loss": loss, "grad_norm": gnorm, **parts}
        return new_params, new_state, step + 1, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill(params, inputs):
        return MODEL.prefill_step(params, cfg, inputs)
    return prefill


def make_decode_step(cfg: ArchConfig):
    def decode(params, caches, cache_len, tokens):
        return MODEL.decode_step(params, cfg, caches, cache_len, tokens)
    return decode
