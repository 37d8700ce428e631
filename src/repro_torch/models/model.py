"""Top-level model API: init / forward / train loss / prefill / decode
(the counterpart of ``repro.models.model``).

Parameters are a dictionary: ``layers`` (one dictionary per layer),
``final_norm``, ``head`` and, for token inputs, ``embed``. Weights from
the reference carry across with ``models.convert.params_from_numpy``.
Caches are one dictionary per layer (attention K/V, Mamba or RWKV
state), updated in place. ``train_loss`` is the mean token cross
entropy (``layers.chunked_cross_entropy``) plus the MoE auxiliary loss;
``launch.steps.make_train_step`` differentiates it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import constrain, local, placed
from repro_torch.utils.device import full_precision_matmul, resolve_device


def has_token_embed(cfg: ArchConfig) -> bool:
    """Stub frontends (vlm/audio) feed precomputed embeddings directly."""
    return cfg.frontend is None


def _init(cfg: ArchConfig, gen, device):
    p = {"layers": T.stack_init(gen, cfg, device),
         "final_norm": L.norm_init(cfg, device=device),
         "head": L.head_init(gen, cfg, device)}
    if has_token_embed(cfg):
        p["embed"] = L.embed_init(gen, cfg, device)
    return p


def init_params(cfg: ArchConfig, generator, device=None):
    """Random parameters with the reference's std formulas, drawn from
    ``generator`` (a ``torch.Generator`` on the device's type, or an int
    seed). ``device=None`` means ``cuda`` and raises without a card."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    return _init(cfg, generator, dev)


def param_specs(cfg: ArchConfig):
    """The parameters' logical PartitionSpecs, in the port's tree: one
    dictionary per layer (the reference's period-stacked tree, with its
    leading ``None``, is ``convert.specs_to_reference_layout`` of it)."""
    s = {"layers": T.stack_spec(cfg),
         "final_norm": L.norm_spec(cfg),
         "head": L.head_spec(cfg)}
    if has_token_embed(cfg):
        s["embed"] = L.embed_spec(cfg)
    return s


def cache_specs(cfg: ArchConfig):
    """The caches' logical PartitionSpecs, one dictionary per layer."""
    return T.stack_cache_spec(cfg)


def _embed(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return w[ids.to(torch.long)]


def forward(params, cfg: ArchConfig, inputs, *, positions=None, caches=None,
            cache_len=None, attn_override=None):
    """inputs: (B, S) int tokens, or (B, S, d) embeddings for stub
    frontends. Returns (hidden (B, S, d), new_caches, aux). With
    ``caches`` (``T.stack_cache_init``) the fresh K/V are written at rows
    ``cache_len`` (an int) onwards and the recurrent states advanced, in
    place. ``attn_override`` is
    threaded to ``T.stack_apply``. float32 products stay full float32 on
    the card (no TF32). Under a mesh the embedding's rows are gathered on
    each rank's token ids with the table whole (``local``), its gradient
    summed over the batch axes: DTensor's rule for the gather's backward
    (an ``index_put``) fails on torch 2.11."""
    full_precision_matmul()
    if inputs.ndim == 2:
        ids, table = placed("dp", None), placed(None, None)
        x = local(_embed, inputs, params["embed"]["w"],
                  out=placed("dp", None, None), ins=(ids, table),
                  grads=(ids, placed(None, None, summed=("dp",))))
    else:
        x = constrain(inputs.to(L.dtype_of(cfg)), "dp", None, None)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x, new_caches, aux = T.stack_apply(params["layers"], x, cfg,
                                       positions=positions, caches=caches,
                                       cache_len=cache_len,
                                       attn_override=attn_override)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, new_caches, aux


def train_loss(params, cfg: ArchConfig, batch, *, aux_weight: float = 0.01):
    """batch: {"inputs": tokens or embeds, "labels": (B, S) int}. Returns
    (ce + aux_weight · aux, {"ce": ce, "aux": aux}), float32 scalars."""
    x, _, aux = forward(params, cfg, batch["inputs"])
    ce = L.chunked_cross_entropy(x, params["head"]["w"], batch["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def prefill_step(params, cfg: ArchConfig, inputs):
    """Process a full prompt; return last-token float32 logits and caches
    seeded with the prompt (sized to the prompt length)."""
    B, S = inputs.shape[:2]
    device = params["head"]["w"].device
    caches = T.stack_cache_init(cfg, B, S, device)
    x, new_caches, _ = forward(params, cfg, inputs, caches=caches, cache_len=0)
    logits = (x[:, -1] @ params["head"]["w"]).to(torch.float32)
    return logits, new_caches


def decode_step(params, cfg: ArchConfig, caches, cache_len, tokens,
                attn_override=None):
    """One decode step. tokens: (B, 1) ids or (B, 1, d) stub embeddings;
    ``cache_len``: tokens already in the cache, an int or a one-element
    integer tensor on the device (then the step never reads it on the
    host, and a CUDA graph of it replays at any position). Returns
    (logits (B, V) float32, caches), the caches updated in place.
    ``attn_override`` swaps the attention step per layer (see
    ``T.stack_apply``)."""
    B = tokens.shape[0]
    if isinstance(cache_len, torch.Tensor):
        positions = cache_len.reshape(1, 1).to(torch.int32).expand(B, 1)
    else:
        positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                               device=params["head"]["w"].device)
    x, new_caches, _ = forward(params, cfg, tokens, positions=positions,
                               caches=caches, cache_len=cache_len,
                               attn_override=attn_override)
    logits = (x[:, -1] @ params["head"]["w"]).to(torch.float32)
    return logits, new_caches


def count_params(cfg: ArchConfig) -> int:
    """Total parameter count (shapes only, on the ``meta`` device)."""
    return sum(math.prod(t.shape)
               for t in leaves(_init(cfg, None, torch.device("meta"))))


def count_active_params(cfg: ArchConfig) -> int:
    """Parameters active per token: the routed experts of each MoE layer
    count ``top_k / num_experts`` of their size (shared experts count
    whole). Shapes only, on the ``meta`` device."""
    total = count_params(cfg)
    if cfg.moe_num_experts == 0:
        return total
    params = _init(cfg, None, torch.device("meta"))
    expert = sum(math.prod(layer["moe"][name].shape)
                 for layer in params["layers"] if "moe" in layer
                 for name in ("gate", "up", "down"))
    return total - expert + int(expert * cfg.moe_top_k / cfg.moe_num_experts)


def leaves(tree):
    """The tensors of a parameter or cache tree (dicts and lists), in
    order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        for v in tree:
            yield from leaves(v)
