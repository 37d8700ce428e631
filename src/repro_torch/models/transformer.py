"""Block assembly and the layer stack (the counterpart of
``repro.models.transformer``).

A *block* is (norm -> attention) + (norm -> MLP) with residuals. The
reference stacks parameters over periods with a leading ``nper`` axis and
scans; the port keeps one parameter dictionary per layer and loops over
the layers in Python, handing an attention override the global layer
index as the reference's per-layer loop does. Only dense attention + MLP
blocks are ported: the MoE, Mamba and RWKV blocks raise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def _check_block(mix: str, ffn: str) -> None:
    if mix != "attn" or ffn != "mlp":
        raise NotImplementedError(
            f"{mix}/{ffn} blocks are not ported yet (ROADMAP.md, Queue 1 "
            "item 15: MoE, Mamba and RWKV blocks)")


def layer_plan(cfg: ArchConfig) -> list[tuple[str, str]]:
    """``cfg.layer_plan()``, refused unless every block is attention +
    MLP (the blocks the port builds)."""
    plan = cfg.layer_plan()
    for mix, ffn in plan:
        _check_block(mix, ffn)
    return plan


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ArchConfig, mix: str, ffn: str, device="cpu"):
    _check_block(mix, ffn)
    return {"norm1": L.norm_init(cfg, device=device),
            "attn": L.attn_init(gen, cfg, device),
            "norm2": L.norm_init(cfg, device=device),
            "mlp": L.mlp_init(gen, cfg, device)}


def block_cache_init(cfg: ArchConfig, mix: str, batch: int, max_len: int,
                     device="cpu"):
    _check_block(mix, "mlp")
    return L.attn_cache_init(cfg, batch, max_len, device)


def block_apply(p, x, cfg: ArchConfig, mix: str, ffn: str, *, positions,
                cache=None, cache_len=None, attn_override=None):
    """Returns (x, new_cache, aux).

    ``attn_override``, when given, replaces ``L.attn_apply``: called as
    ``override(p_attn, h, positions=, cache=, cache_len=) -> (y,
    new_cache)`` (the clustered-KV decode path).
    """
    _check_block(mix, ffn)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    attn_fn = attn_override if attn_override is not None else \
        functools.partial(L.attn_apply, cfg=cfg)
    y, new_cache = attn_fn(p["attn"], h, positions=positions, cache=cache,
                           cache_len=cache_len)
    x = x + y
    h = L.rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Stack (a loop over layers)
# ---------------------------------------------------------------------------

def stack_init(gen, cfg: ArchConfig, device="cpu") -> list[dict]:
    """One parameter dictionary per layer, in layer order."""
    return [block_init(gen, cfg, mix, ffn, device)
            for mix, ffn in layer_plan(cfg)]


def stack_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                     device="cpu") -> list[dict]:
    """One ``{"k", "v"}`` cache of (batch, max_len, Hkv, hd) per layer."""
    return [block_cache_init(cfg, mix, batch, max_len, device)
            for mix, _ in layer_plan(cfg)]


def stack_apply(layers, x, cfg: ArchConfig, *, positions, caches=None,
                cache_len=None, attn_override=None):
    """layers: one parameter dictionary per layer; caches: one cache per
    layer, or None. Returns (x, new_caches, aux_total).

    ``attn_override``: optional per-layer attention replacement, called
    as ``override(global_layer, p_attn, h, positions=, cache=,
    cache_len=) -> (y, new_cache)``.
    """
    plan = layer_plan(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for layer, (mix, ffn) in enumerate(plan):
        override = None
        if attn_override is not None:
            override = functools.partial(attn_override, layer)
        x, nc, a = block_apply(
            layers[layer], x, cfg, mix, ffn, positions=positions,
            cache=caches[layer] if caches is not None else None,
            cache_len=cache_len, attn_override=override)
        aux = aux + a
        if caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux
