"""Mixture-of-Experts with sort-based dispatch (the counterpart of
``repro.models.moe``).

Dispatch is a gather/scatter over a stable argsort by expert id: no dense
one-hot (T, E, C) product. Each expert gets a buffer of ``cap`` rows;
tokens over capacity are dropped (standard capacity MoE) and the
Switch-style auxiliary loss pushes the router toward uniform load.

One card holds the whole batch, so the reference's groups over the mesh's
batch axis are one group here (``g = gcd(T, 1) = 1``): the dispatch runs
on (T, d) directly. Groups over a mesh come with the sharding slice
(ROADMAP.md).

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

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, normal

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


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (y (B, S, d), aux_loss float32 scalar)."""
    B, S, d = x.shape
    T = B * S
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = capacity(cfg, T)
    xf = x.reshape(T, d)
    logits = xf.to(torch.float32) @ p["router"]              # (T, E) f32
    probs = torch.softmax(logits, dim=-1)

    # Switch-style aux loss over the batch (argmax: the first on ties)
    me = probs.mean(0)
    top1 = torch.argmax(probs, dim=-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add(
        0, top1, torch.ones((T,), dtype=torch.float32, device=x.device)) / T
    aux = e * torch.sum(me * ce)

    buf, st, sg, keep, slot, order = _dispatch_local(xf, probs, k, e, cap)
    wg, wu, wd = _expert_weights(p, cfg)
    acc = dtype_of(cfg)
    h = _expert_product(buf, wg, acc)
    u = _expert_product(buf, wu, acc)
    y = _expert_product(F.silu(h) * u, wd, acc)
    out = _combine_local(y, st, sg, keep, slot, order, T, k).reshape(B, S, d)
    if "sh_gate" in p:   # shared expert(s): applied to every token
        sh = F.silu(xf @ p["sh_gate"]) * (xf @ p["sh_up"])
        out = out + (sh @ p["sh_down"]).reshape(B, S, d)
    return out, aux


def dropped(cfg: ArchConfig, x: torch.Tensor, p) -> torch.Tensor:
    """The number of (token, choice) pairs of ``x`` (B, S, d) that
    ``moe_apply`` drops over capacity, as a device tensor (a diagnostic:
    the same router and dispatch, no expert products)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs = torch.softmax(xf.to(torch.float32) @ p["router"], dim=-1)
    keep = _dispatch_local(xf, probs, cfg.moe_top_k, cfg.moe_num_experts,
                           capacity(cfg, B * S))[3]
    return (~keep).sum()
