"""Mixture-of-Experts with sort-based dispatch (the counterpart of
``repro.models.moe``).

Dispatch is a gather/scatter over a stable argsort by expert id: no dense
one-hot (T, E, C) product. Each expert gets a buffer of ``cap`` rows;
tokens over capacity are dropped (standard capacity MoE) and the
Switch-style auxiliary loss pushes the router toward uniform load.

Tokens are cut into ``g = gcd(T, dp_size())`` groups of ``T / g``, each
dispatched on its own with a capacity of its own, as the reference
vmaps its dispatch over the mesh's batch axis: one group (the whole
batch) on one card or with no mesh. Under a mesh (``sharding.
activation_sharding``) the tokens are a DTensor cut over the batch axes,
so each rank holds its own groups; the dispatch, the expert products and
the combine run on them as plain tensors (``sharding.local``, like the
reference's per-group vmap). The experts stay cut over "model" (expert
parallelism, the reference's ``"tp"`` on the expert axis): each rank of
"model" dispatches its groups whole, runs only its block of the experts
(their weights gathered over the batch axes alone) and adds only their
rows in the combine, so the block's output is summed over "model".

Ties and orders follow the reference:

- ``lax.top_k`` puts the lower expert first on equal probabilities; so
  does a stable descending sort (``torch.topk`` promises no order);
- the sort by expert id is stable (``jnp.argsort`` is);
- the combine adds a token's k contributions in sorted (expert-id) order
  into zeros, as the reference's scatter-add does: here a gather, then k
  adds in that fixed order, never ``index_add_``, whose atomics on the
  card would add them in any order. So a CUDA graph's replay repeats the
  eager run's bits, and the CPU repeats the reference's.

Nothing here reads the device on the host: the decode step, MoE layers
included, is captured as one CUDA graph (``serve.kv_cluster``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, normal
from repro_torch.models.sharding import (P, constrain, dp_size, local,
                                        placed)

_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn}


def moe_init(gen, cfg: ArchConfig, device="cpu"):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    dt = dtype_of(cfg)
    p = {"router": normal(gen, (d, e), d ** -0.5, torch.float32, device),
         "gate": normal(gen, (e, d, f), d ** -0.5, dt, device),
         "up": normal(gen, (e, d, f), d ** -0.5, dt, device),
         "down": normal(gen, (e, f, d), f ** -0.5, dt, device)}
    if cfg.moe_shared_experts:
        fs = f * cfg.moe_shared_experts
        p |= {"sh_gate": normal(gen, (d, fs), d ** -0.5, dt, device),
              "sh_up": normal(gen, (d, fs), d ** -0.5, dt, device),
              "sh_down": normal(gen, (fs, d), fs ** -0.5, dt, device)}
    return p


def moe_spec(cfg: ArchConfig):
    s = {"router": P("fsdp", None),
         "gate": P("tp", "fsdp", None), "up": P("tp", "fsdp", None),
         "down": P("tp", None, "fsdp")}
    if cfg.moe_shared_experts:
        s |= {"sh_gate": P("fsdp", "tp"), "sh_up": P("fsdp", "tp"),
              "sh_down": P("tp", "fsdp")}
    return s


def groups(tokens: int) -> int:
    """The dispatch's groups for ``tokens`` tokens: ``gcd(T, dp_size())``
    (1 with no mesh)."""
    return math.gcd(tokens, dp_size())


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Rows of each expert's buffer for ``tokens`` tokens in one group:
    ``capacity_factor · T · k / E``, truncated, rounded up to a multiple
    of 8, at least 8 (from shapes only)."""
    cap = int(cfg.moe_capacity_factor * tokens * cfg.moe_top_k
              / cfg.moe_num_experts)
    return max(8, -(-cap // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_local(xg, probs, k: int, e: int, cap: int):
    """xg: (T, d); probs: (T, E) float32. Returns (buf (E, cap, d), st,
    sg, keep, slot, order): the expert buffers, and for each of the T·k
    (token, choice) pairs in sorted order its token, gate, whether it
    fits its expert's capacity and its buffer row (``E·cap`` when
    dropped); ``order`` maps sorted positions to flat (token, choice)
    pairs."""
    tl, d = xg.shape
    dev = xg.device
    gate_vals, expert_idx = top_k(probs, k)                  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    fe = expert_idx.reshape(-1)                              # (T·k,)
    ft = torch.arange(tl, device=dev).repeat_interleave(k)
    fg = gate_vals.reshape(-1)
    order = torch.argsort(fe, stable=True)
    se, st, sg = fe[order], ft[order], fg[order]
    ar = torch.arange(tl * k, device=dev)
    first = torch.full((e,), tl * k, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, se, ar, reduce="amin")
    pos = ar - first[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xg.dtype, device=dev)
    buf[slot] = xg[st]      # only dropped pairs share a row: the spare one
    return buf[:-1].reshape(e, cap, d), st, sg, keep, slot, order


def _expert_weights(p, cfg: ArchConfig):
    """The expert weights as the products take them: the parameters, or
    with ``moe_weight_dtype`` set their cast to that type (the reference
    casts before the FSDP gather to halve its wire bytes)."""
    if not cfg.moe_weight_dtype:
        return p["gate"], p["up"], p["down"]
    dt = _FP8[cfg.moe_weight_dtype]
    return p["gate"].to(dt), p["up"].to(dt), p["down"].to(dt)


def _expert_product(a: torch.Tensor, w: torch.Tensor, acc: torch.dtype):
    """``einsum("ecd,edf->ecf", a.astype(w.dtype), w,
    preferred_element_type=acc)``: with fp8 weights both operands are
    rounded to fp8 and multiplied in ``acc`` (exact products of fp8
    values, sums in ``acc``), since no general fp8 product exists off the
    tensor cores."""
    if w.dtype != acc:
        a, w = a.to(w.dtype).to(acc), w.to(acc)
    return torch.bmm(a.to(acc), w)


def _combine_local(y, st, sg, keep, slot, order, tl: int, k: int):
    """y: (E, cap, d) -> (T, d): each token's k gated expert rows added
    into zeros in sorted (expert-id) order, dropped pairs adding 0."""
    e, cap, d = y.shape
    yflat = y.reshape(e * cap, d)
    contrib = torch.where(keep[:, None],
                          yflat[torch.clamp(slot, max=e * cap - 1)],
                          torch.zeros((), dtype=y.dtype, device=y.device))
    contrib = contrib * sg[:, None].to(y.dtype)
    # sorted position of every (token, choice) pair; a token's pairs sorted
    # by that position are its contributions in expert-id order
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), device=order.device)
    where = torch.sort(where.reshape(tl, k), dim=-1).values
    out = torch.zeros((tl, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + contrib[where[:, j]]
    return out


def _top1_counts(probs: torch.Tensor, e: int) -> torch.Tensor:
    """How many of the (..., E) rows of ``probs`` pick each expert first
    (argmax: the first on ties), float32."""
    top1 = torch.argmax(probs, dim=-1).reshape(-1)
    return torch.zeros((e,), dtype=torch.float32, device=probs.device
                       ).index_add(0, top1, torch.ones(
                           (top1.numel(),), dtype=torch.float32,
                           device=probs.device))


def _experts(xg, probs, wg, wu, wd, k: int, cap: int, acc, first: int):
    """Dispatch, expert products and combine of each group: xg (G, Tl, d),
    probs (G, Tl, E) -> (G, Tl, d). The weights are experts ``first``
    onwards (all of them, or this rank's block under a mesh): the other
    experts' rows add nothing here."""
    e, el = probs.shape[-1], wg.shape[0]
    outs = []
    for i in range(xg.shape[0]):
        buf, st, sg, keep, slot, order = _dispatch_local(xg[i], probs[i], k,
                                                         e, cap)
        if el < e:
            buf = buf[first:first + el]
        h = _expert_product(buf, wg, acc)
        u = _expert_product(buf, wu, acc)
        y = _expert_product(F.silu(h) * u, wd, acc)
        if el < e:
            y = F.pad(y, (0, 0, 0, 0, first, e - first - el))
        outs.append(_combine_local(y, st, sg, keep, slot, order,
                                   xg.shape[1], k))
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def _route(p, x: torch.Tensor, cfg: ArchConfig):
    """(xf (g, Tl, d), probs (g, Tl, E) float32, g, cap) of x (B, S, d)."""
    B, S, d = x.shape
    T = B * S
    g = groups(T)
    xf = constrain(x.reshape(g, T // g, d), "dp", None, None)
    logits = xf.to(torch.float32) @ p["router"]              # (g, Tl, E) f32
    probs = constrain(torch.softmax(logits, dim=-1), "dp", None, None)
    return xf, probs, g, capacity(cfg, T // g)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (y (B, S, d), aux_loss float32 scalar)."""
    B, S, d = x.shape
    T = B * S
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    xf, probs, g, cap = _route(p, x, cfg)

    # Switch-style aux loss over the global batch
    rows = placed("dp", None, None)
    me = probs.reshape(T, e).mean(0)
    ce = local(_top1_counts, probs, e, out=placed(None, summed=("dp",)),
               ins=(rows, None)) / T
    aux = e * torch.sum(me * ce)

    # each rank of "model" adds its experts' share of every token's rows;
    # their weights' gradients are summed over the batch axes
    wg, wu, wd = _expert_weights(p, cfg)
    share, wp = placed("dp", None, None, summed=("tp",)), placed("tp", None,
                                                                  None)
    first = sharding.tp_rank() * (e // sharding.tp_size())
    out = local(
        lambda xl, pl, *ws: _experts(xl, pl, *ws, k, cap, dtype_of(cfg),
                                     first),
        xf, probs, wg, wu, wd, out=share, ins=(rows, rows, wp, wp, wp),
        grads=(share, share) + (placed("tp", None, None,
                                       summed=("dp",)),) * 3)
    out = constrain(out, "dp", None, None).reshape(B, S, d)
    if "sh_gate" in p:   # shared expert(s): applied to every token
        xflat = x.reshape(T, d)
        sh = constrain(F.silu(xflat @ p["sh_gate"]) * (xflat @ p["sh_up"]),
                       "dp", "tp")
        out = out + constrain(sh @ p["sh_down"], "dp", None).reshape(B, S, d)
    return out, aux


def dropped(cfg: ArchConfig, x: torch.Tensor, p) -> torch.Tensor:
    """The number of (token, choice) pairs of ``x`` (B, S, d) that
    ``moe_apply`` drops over capacity, summed over its groups (and over
    the ranks under a mesh), as a device tensor (a diagnostic: the same
    router and dispatch, no expert products)."""
    xf, probs, _, cap = _route(p, x, cfg)

    def count(xg, pg):
        return sum((~_dispatch_local(xg[i], pg[i], cfg.moe_top_k,
                                     cfg.moe_num_experts, cap)[3]).sum()
                   for i in range(xg.shape[0]))
    with torch.no_grad():
        rows = placed("dp", None, None)
        return sharding.value(local(count, xf, probs,
                                    out=placed(summed=("dp",)),
                                    ins=(rows, rows)))
