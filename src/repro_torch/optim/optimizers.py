"""Optimizers as plain tensor ops: AdamW and Adafactor (the counterpart
of ``repro.optim.optimizers``).

Each optimizer is ``Optimizer(init, update, state_specs)`` over the
reference's state
trees: AdamW keeps ``{"mu", "nu"}`` in float32; Adafactor keeps
``{"mu" (bfloat16), "vr", "vc"}``, factored (row and column means of the
squared gradient) for leaves of two or more dimensions. Trees are nests
of dicts, lists and tuples of tensors (``utils.tree``). The step's
arithmetic runs in float32 tensors in the reference's order: the bias
corrections ``1 - b ** (step + 1)``, the schedule's ``cos(pi · frac)``,
each leaf's update, then the cast back to the parameter's dtype.
``torch.optim`` is not used: its state is not the reference's, and it
rounds in another order.

``state_specs(pspecs, abstract_params)`` gives the state's logical
PartitionSpecs from the parameters' (``models.param_specs``), in the
same tree; Adafactor's need the parameters' ranks (``abstract_params``:
the parameters, or their ``meta``-device stand-ins).
Adafactor factors a leaf by its own shape, as the reference does; the
reference stacks each layer's leaves over the periods of its layer plan,
so on a model the two factor (and clip the update's RMS) over different
groups: layer by layer here, over the stack there. AdamW works element by
element and is the same on either layout.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.sharding import P, is_spec
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


class Optimizer(NamedTuple):
    init: Callable          # params -> state
    update: Callable        # (grads, state, params, step) -> (new_params, state)
    state_specs: Callable   # (param specs, abstract params) -> state specs


def _step_tensor(step, params) -> torch.Tensor:
    """``step`` (an int or an integer tensor) as a tensor on the
    parameters' device."""
    dev = tree_leaves(params)[0].device
    return torch.as_tensor(step, device=dev)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup over ``warmup`` steps to ``peak_lr``, then a cosine
    decay to ``floor · peak_lr`` at ``total``. The returned function maps
    a step (int or tensor) to a float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global L2 norm is at most ``max_norm``,
    each cast back to its dtype; the norm before, float32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _split(out, n: int):
    """Per-leaf n-tuples of ``out`` (a list) as n lists."""
    return [[o[i] for o in out] for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: Callable | float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        step = _step_tensor(step, params)
        stepf = step.to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), m, v

        leaves, treedef = tree_flatten(params)
        out = [upd(*xs) for xs in zip(tree_leaves(grads),
                                      tree_leaves(state["mu"]),
                                      tree_leaves(state["nu"]), leaves)]
        new_p, mu, nu = (tree_unflatten(treedef, part)
                         for part in _split(out, 3))
        return new_p, {"mu": mu, "nu": nu}

    def state_specs(pspecs, abstract_params=None):
        return {"mu": pspecs, "nu": pspecs}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; bf16 first moment)
# ---------------------------------------------------------------------------

def adafactor(lr: Callable | float, *, b1=0.9, decay=0.99, eps=1e-30,
              weight_decay=0.0, clip_rms=1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def vrow(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vcol(p):
            shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return {"mu": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.bfloat16, device=p.device), params),
                "vr": tree_map(vrow, params),
                "vc": tree_map(vcol, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(_step_tensor(step, params))

        def upd(g, m, vr, vc, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p):
                vr = decay * vr + (1 - decay) * g2.mean(-1)
                vc = decay * vc + (1 - decay) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                vr = decay * vr + (1 - decay) * g2
                u = g * torch.rsqrt(torch.clamp(vr, min=eps))
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_rms, min=1.0)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * u
            u = m32 + weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - lr_t * u).to(p.dtype),
                    m32.to(torch.bfloat16), vr, vc)

        leaves, treedef = tree_flatten(params)
        out = [upd(*xs) for xs in zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["vr"]), tree_leaves(state["vc"]), leaves)]
        new_p, mu, vr, vc = (tree_unflatten(treedef, part)
                             for part in _split(out, 4))
        return new_p, {"mu": mu, "vr": vr, "vc": vc}

    def state_specs(pspecs, abstract_params):
        """Needs the parameters' ranks to know which leaves are factored."""
        def norm(s, nd):
            return tuple(s) + (None,) * (nd - len(tuple(s)))

        def row(s, p):
            if _factored(p):
                return P(*norm(s, p.ndim)[:-1])
            return P(*norm(s, p.ndim))

        def col(s, p):
            if _factored(p):
                t = norm(s, p.ndim)
                return P(*(t[:-2] + t[-1:]))
            return P(None)

        vr = tree_map(row, pspecs, abstract_params, is_leaf=is_spec)
        vc = tree_map(col, pspecs, abstract_params, is_leaf=is_spec)
        return {"mu": pspecs, "vr": vr, "vc": vc}

    return Optimizer(init, update, state_specs)
