"""Block assembly and the layer stack (the counterpart of
``repro.models.transformer``).

A *block* is (norm -> mix) + (norm -> ffn) with residuals, where
  mix in {attn, mamba, rwkv time mix}   ffn in {mlp, moe, rwkv channel mix}.

The reference stacks parameters over the periods of ``cfg.layer_plan()``
(1 for uniform stacks, 8 for Jamba's 1:7 interleave) and scans; the port
keeps one parameter dictionary per layer and loops over the layers in
Python, handing an attention override the global layer index as the
reference's per-layer loop does. Caches (attention K/V, Mamba and RWKV
states) are one dictionary per layer, updated in place. With
``cfg.remat``, grad enabled and no caches, each period of layers is
recomputed in the backward pass (``torch.utils.checkpoint``), as the
reference checkpoints each period: only the periods' inputs are kept.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv6 as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import constrain

# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, mix: str, ffn: str, device="cpu"):
    p = {"norm1": L.norm_init(cfg, device=device)}
    if mix == "attn":
        p["attn"] = L.attn_init(gen, cfg, device)
    elif mix == "mamba":
        p["mamba"] = S.mamba_init(gen, cfg, device)
    elif mix == "rwkv":
        p["rwkv"] = R.rwkv_init(gen, cfg, device)
    else:
        raise ValueError(mix)
    p["norm2"] = L.norm_init(cfg, device=device)
    if ffn == "mlp":
        p["mlp"] = L.mlp_init(gen, cfg, device)
    elif ffn == "moe":
        p["moe"] = M.moe_init(gen, cfg, device)
    elif ffn != "rwkv_ffn":   # the channel mix's params live in p["rwkv"]
        raise ValueError(ffn)
    return p


def block_spec(cfg: ArchConfig, mix: str, ffn: str):
    s = {"norm1": L.norm_spec(cfg), "norm2": L.norm_spec(cfg)}
    if mix == "attn":
        s["attn"] = L.attn_spec(cfg)
    elif mix == "mamba":
        s["mamba"] = S.mamba_spec(cfg)
    elif mix == "rwkv":
        s["rwkv"] = R.rwkv_spec(cfg)
    if ffn == "mlp":
        s["mlp"] = L.mlp_spec(cfg)
    elif ffn == "moe":
        s["moe"] = M.moe_spec(cfg)
    return s


def block_cache_init(cfg: ArchConfig, mix: str, batch: int, max_len: int,
                     device="cpu"):
    if mix == "attn":
        return L.attn_cache_init(cfg, batch, max_len, device)
    if mix == "mamba":
        return S.mamba_cache_init(cfg, batch, device)
    if mix == "rwkv":
        return R.rwkv_cache_init(cfg, batch, device)
    raise ValueError(mix)


def block_cache_spec(cfg: ArchConfig, mix: str):
    if mix == "attn":
        return L.attn_cache_spec(cfg)
    if mix == "mamba":
        return S.mamba_cache_spec(cfg)
    if mix == "rwkv":
        return R.rwkv_cache_spec(cfg)
    raise ValueError(mix)


def block_apply(p, x, cfg: ArchConfig, mix: str, ffn: str, *, positions,
                cache=None, cache_len=None, attn_override=None):
    """Returns (x, new_cache, aux).

    ``attn_override``, when given, replaces ``L.attn_apply`` for attention
    mixes: called as ``override(p_attn, h, positions=, cache=,
    cache_len=) -> (y, new_cache)`` (the clustered-KV decode path).
    """
    x = constrain(x, "dp", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    if mix == "attn":
        attn_fn = attn_override if attn_override is not None else \
            functools.partial(L.attn_apply, cfg=cfg)
        y, new_cache = attn_fn(p["attn"], h, positions=positions, cache=cache,
                               cache_len=cache_len)
    elif mix == "mamba":
        y, new_cache = S.mamba_apply(p["mamba"], h, cfg, cache=cache)
    elif mix == "rwkv":
        y, new_cache = R.rwkv_time_mix(p["rwkv"], h, cfg, cache=cache)
    else:
        raise ValueError(mix)
    x = x + y

    h = L.rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if ffn == "mlp":
        y = L.mlp_apply(p["mlp"], h)
    elif ffn == "moe":
        y, aux = M.moe_apply(p["moe"], h, cfg)
    elif ffn == "rwkv_ffn":
        y, new_cache = R.rwkv_channel_mix(p["rwkv"], h, cache=new_cache)
    else:
        raise ValueError(ffn)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# Stack (a loop over layers)
# ---------------------------------------------------------------------------

def stack_init(gen, cfg: ArchConfig, device="cpu") -> list[dict]:
    """One parameter dictionary per layer, in layer order."""
    return [block_init(gen, cfg, mix, ffn, device)
            for mix, ffn in cfg.layer_plan()]


def stack_spec(cfg: ArchConfig) -> list[dict]:
    """One spec dictionary per layer (no stacking axis)."""
    return [block_spec(cfg, mix, ffn) for mix, ffn in cfg.layer_plan()]


def stack_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                     device="cpu") -> list[dict]:
    """One cache per layer: ``{"k", "v"}`` of (batch, max_len, Hkv, hd)
    for attention, ``{"h", "conv"}`` for Mamba, ``{"s", "x_tm", "x_cm"}``
    for RWKV."""
    return [block_cache_init(cfg, mix, batch, max_len, device)
            for mix, _ in cfg.layer_plan()]


def stack_cache_spec(cfg: ArchConfig) -> list[dict]:
    """One cache spec dictionary per layer."""
    return [block_cache_spec(cfg, mix) for mix, _ in cfg.layer_plan()]


def stack_apply(layers, x, cfg: ArchConfig, *, positions, caches=None,
                cache_len=None, attn_override=None):
    """layers: one parameter dictionary per layer; caches: one cache per
    layer, or None. Returns (x, new_caches, aux_total).

    ``attn_override``: optional per-layer attention replacement, called
    as ``override(global_layer, p_attn, h, positions=, cache=,
    cache_len=) -> (y, new_cache)``.
    """
    plan = cfg.layer_plan()
    period = cfg.period()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None

    def run(layer0, x, aux):
        """Layers ``layer0 .. layer0 + period - 1``: (x, aux, their caches)."""
        ncs = []
        for layer in range(layer0, layer0 + period):
            mix, ffn = plan[layer]
            override = None
            if attn_override is not None and mix == "attn":
                override = functools.partial(attn_override, layer)
            x, nc, a = block_apply(
                layers[layer], x, cfg, mix, ffn, positions=positions,
                cache=caches[layer] if caches is not None else None,
                cache_len=cache_len, attn_override=override)
            aux = aux + a
            ncs.append(nc)
        return x, aux, ncs

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for layer0 in range(0, cfg.num_layers, period):
        if remat:
            x, aux = checkpoint(lambda x, aux, l0=layer0: run(l0, x, aux)[:2],
                                x, aux, use_reentrant=False)
        else:
            x, aux, ncs = run(layer0, x, aux)
            if caches is not None:
                new_caches.extend(ncs)
    return x, new_caches, aux
