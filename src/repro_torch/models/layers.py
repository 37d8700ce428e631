"""Transformer layers of the LM substrate: RMSNorm, RoPE, GQA attention
(+qk-norm, +bias, +KV cache), SwiGLU/GELU MLP, embeddings (the
counterpart of ``repro.models.layers``).

Plain functions on tensors and dictionaries of tensors. Weights keep the
reference's ``(in, out)`` layout, so a layer is ``x @ w`` in both
packages. Every ``*_init`` has a matching ``*_spec`` returning the same
dictionary of *logical* PartitionSpecs (``sharding.P``), in the axis
names:
    "dp"   -> batch axes  (("pod","data") on the multi-pod mesh)
    "fsdp" -> parameter sharding over the batch axes (ZeRO-3)
    "tp"   -> tensor-parallel axis ("model")
    "sp"   -> sequence dimension sharding (long-context KV)
``launch.mesh.resolve_spec`` maps them to mesh axes. ``sharding.constrain``
pins activations at the reference's places; with no mesh it is the
identity.

KV caches are updated in place (the reference returns new arrays): a
decode step writes one row per layer instead of copying the cache.
``cache_len`` is the number of rows already cached: a Python int, or a
one-element integer tensor on the cache's device, which a captured CUDA
graph reads at each replay (``serve.kv_cluster``'s decode step).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ArchConfig
from repro_torch.models import sharding
from repro_torch.models.sharding import P, constrain, local, placed, tp_size

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NEG = -1e30


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    """The parameter and activation dtype of ``cfg``."""
    return _DTYPES[cfg.dtype]


def normal(gen, shape, std: float, dtype, device) -> torch.Tensor:
    """Standard normal draws times ``std``, cast to ``dtype`` (on the
    ``meta`` device: shapes only, no draws, for ``count_params``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 statistics, cast back to ``x.dtype``, then times ``scale``
    (that order decides the bf16 rounding, as in the reference)."""
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * scale


def norm_init(cfg: ArchConfig, device="cpu"):
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype_of(cfg),
                                device=device)}


def norm_spec(cfg: ArchConfig):
    return {"scale": P()}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers. A bf16 ``x`` times
    the float32 angles promotes to float32 and is cast back."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq        # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + optional qk-norm / qkv-bias + KV cache)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ArchConfig, device="cpu"):
    hd = cfg.resolved_head_dim
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    std = d ** -0.5
    dt = dtype_of(cfg)
    p = {"wq": normal(gen, (d, hq * hd), std, dt, device),
         "wk": normal(gen, (d, hkv * hd), std, dt, device),
         "wv": normal(gen, (d, hkv * hd), std, dt, device),
         "wo": normal(gen, (hq * hd, d), std, dt, device)}
    if cfg.qkv_bias:
        p |= {"bq": torch.zeros((hq * hd,), dtype=dt, device=device),
              "bk": torch.zeros((hkv * hd,), dtype=dt, device=device),
              "bv": torch.zeros((hkv * hd,), dtype=dt, device=device)}
    if cfg.qk_norm:
        p |= {"q_norm": torch.ones((hd,), dtype=dt, device=device),
              "k_norm": torch.ones((hd,), dtype=dt, device=device)}
    return p


def attn_spec(cfg: ArchConfig):
    s = {"wq": P("fsdp", "tp"), "wk": P("fsdp", "tp"), "wv": P("fsdp", "tp"),
         "wo": P("tp", "fsdp")}
    if cfg.qkv_bias:
        s |= {"bq": P("tp"), "bk": P("tp"), "bv": P("tp")}
    if cfg.qk_norm:
        s |= {"q_norm": P(), "k_norm": P()}
    return s


def attn_cache_spec(cfg: ArchConfig):
    """KV cache sharded over batch and sequence."""
    return {"k": P("dp", "sp", None, None), "v": P("dp", "sp", None, None)}


def _heads(t: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(B, S, h·hd) -> (B, S, h, hd); under a mesh whose "model" axis does
    not divide ``h``, gathered over it first (DTensor cannot cut a dim
    into heads that tp does not divide, where XLA reshards)."""
    if h % tp_size():
        t = constrain(t, "dp", None, None)
    return t.reshape(t.shape[0], t.shape[1], h, hd)


def attn_qkv(p, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor):
    """Project x to per-head q/k/v with bias, qk-norm and RoPE applied.

    The shared front half of ``attn_apply``, on its own so that attention
    overrides (``repro_torch.serve.kv_cluster``) consume the post-RoPE
    q/k/v the standard path caches.

    Returns (q (B, S, Hq, hd), k (B, S, Hkv, hd), v (B, S, Hkv, hd)).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = _heads(q, hq, hd), _heads(k, hkv, hd), _heads(v, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                cache_len) -> dict:
    """Write the fresh (B, S, Hkv, hd) K/V at rows ``cache_len`` onwards,
    in place; returns ``cache``. A tensor ``cache_len`` is read on the
    device (``index_copy_``), never by the host."""
    S = k.shape[1]
    if isinstance(cache_len, torch.Tensor):
        rows = cache_len.reshape(-1)[:1].to(torch.int64) + torch.arange(
            S, device=k.device)
        cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
        return cache
    cache["k"][:, cache_len:cache_len + S] = k
    cache["v"][:, cache_len:cache_len + S] = v
    return cache


def cache_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, *,
                    positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Attention of (B, S, Hq, hd) queries over a (B, Smax, Hkv, hd) cache
    that already holds them, in float32: keys past each query's absolute
    position weigh exactly 0. Returns (B, S, Hq, hd) in ``q.dtype``.

    A prefill into an empty cache (``cache_len == 0``, S > 1, positions
    ``0..S-1``) attends causally over the S fresh rows only, the same
    function: ``ops.flash_attention``, the hand-written kernel on the
    card. Otherwise (decode, S == 1) the softmax runs over the whole
    cache in plain torch ops, as the reference computes it outside any
    kernel.
    """
    S = q.shape[1]
    if S > 1 and cache_len == 0:
        o = kops.flash_attention(q.transpose(1, 2), kc[:, :S].transpose(1, 2),
                                 vc[:, :S].transpose(1, 2), causal=True)
        return o.transpose(1, 2)
    return cache_attention_ref(q, kc, vc, positions=positions)


def cache_attention_ref(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        *, positions: torch.Tensor) -> torch.Tensor:
    """The reference's cache branch: a softmax over the whole cache with
    keys past each query's position masked to -1e30, in float32 (float64
    for float64 inputs). Returns (B, S, Hq, hd) in ``q.dtype``."""
    B, S, hq, hd = q.shape
    Smax, hkv = kc.shape[1], kc.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(ct), kc.to(ct)) * hd ** -0.5
    keymask = (torch.arange(Smax, device=q.device)[None, None, :]
               <= positions[:, :, None])                     # (B, S, Smax)
    s = torch.where(keymask[:, None, None, :, :], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, vc.to(ct))
    return o.reshape(B, S, hq, hd).to(q.dtype)


def causal_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Causal attention of (B, S, hkv, g, hd) grouped queries over (B, S,
    hkv, hd) keys and values: bf16 operands, float32 products and sums
    (exact products of bf16 values), as the reference's
    preferred_element_type=f32, float32 statistics, the weights rounded to
    ``dtype``. Returns (B, S, hkv, g, hd) float32."""
    S, hd = qg.shape[1], qg.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=qg.device))
    s = torch.where(causal, s, _NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(dtype).to(torch.float32),
                        v.to(torch.float32))


class _SumOver(torch.autograd.Function):
    """A tensor summed over the ranks of ``group``, its gradient summed
    over them too: every rank's copy of the sum feeds only that rank's
    work (the context-parallel softmax's denominator)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def context_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dtype: torch.dtype, *, group, rank: int) -> torch.Tensor:
    """``causal_attention`` over one block of the keys, the reference's
    key-sequence mode (context parallel): (B, S, hkv, g, hd) queries
    whole, (B, S/tp, hkv, hd) keys and values from row ``rank · S/tp``.
    The softmax's max and denominator are reduced over ``group``, the
    ranks that hold the other blocks. Returns this rank's share of the
    (B, S, hkv, g, hd) float32 output, to be summed over ``group``."""
    import torch.distributed as dist
    S, sk, hd = qg.shape[1], k.shape[1], qg.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    keys = rank * sk + torch.arange(sk, device=qg.device)
    s = torch.where(keys <= torch.arange(S, device=qg.device)[:, None], s,
                    _NEG)
    m = s.detach().amax(-1, keepdim=True)  # any shift: no gradient
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - m)
    w = e / _SumOver.apply(e.sum(-1, keepdim=True), group)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(dtype).to(torch.float32),
                        v.to(torch.float32))


def attn_apply(p, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
               cache: dict | None = None, cache_len: int | None = None,
               return_kv: bool = False):
    """x: (B, S, d). Without a cache: causal full attention over x, with
    bf16 operands and float32 statistics (``return_kv`` hands back the
    fresh K/V). With a cache (B, Smax, Hkv, hd) holding ``cache_len``
    rows: the fresh K/V are written into it and attended with the cached
    ones (``cache_attention``). Returns (y, new_cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = attn_qkv(p, x, cfg, positions=positions)
    if cache is None:
        # score sharding under a mesh, the reference's three modes: kv
        # heads when tp divides them, else q groups, else the key sequence
        # (context parallel: ``context_attention``). The attention runs on
        # each rank's shards (``local``): DTensor has no rule for the
        # einsums' flattening of two cut dims. ``shared`` names the
        # inputs whose gradient each rank holds only its share of: k and
        # v's when the q groups are cut, q's when the keys are.
        g, tp = hq // hkv, tp_size()
        core = functools.partial(causal_attention, dtype=x.dtype)
        if hkv % tp == 0:
            qm, km, shared = ("dp", None, "tp", None, None), \
                ("dp", None, "tp", None), ""
        elif g % tp == 0:
            qm, km, shared = ("dp", None, None, "tp", None), \
                ("dp", None, None, None), "kv"
        else:
            qm, km, shared = ("dp", None, None, None, None), \
                ("dp", "tp", None, None), "q"
            core = functools.partial(context_attention, dtype=x.dtype,
                                     group=sharding.tp_group(),
                                     rank=sharding.tp_rank())
        qp, kp = placed(*qm), placed(*km)
        qs = placed(*qm, summed=("tp",)) if shared == "q" else qp
        ks = placed(*km, summed=("tp",)) if shared == "kv" else kp
        if hkv % tp:    # DTensor cannot cut the heads into hkv groups
            q = constrain(q, "dp", None, None, None)
        o = local(core, q.reshape(B, S, hkv, g, hd), k, v, out=qs,
                  ins=(qp, kp, kp), grads=(qs, ks, ks))
        # the heads gathered (the key blocks' shares summed) before they
        # are flattened
        o = constrain(o, "dp", None, None, None, None)
        o = constrain(o.reshape(B, S, hq * hd).to(x.dtype), "dp", None, None)
        new_cache = {"k": k, "v": v} if return_kv else None
    else:
        cache_write(cache, k, v, cache_len)
        o = cache_attention(q, cache["k"], cache["v"], positions=positions,
                            cache_len=cache_len)
        o = o.reshape(B, S, hq * hd).to(x.dtype)
        new_cache = cache
    return o @ p["wo"], new_cache


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, device="cpu"):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ArchConfig, device="cpu"):
    d = cfg.d_model
    f = cfg.d_ff_dense or cfg.d_ff
    dt = dtype_of(cfg)
    p = {}
    if cfg.mlp_variant == "swiglu":
        p["gate"] = normal(gen, (d, f), d ** -0.5, dt, device)
    p["up"] = normal(gen, (d, f), d ** -0.5, dt, device)
    p["down"] = normal(gen, (f, d), f ** -0.5, dt, device)
    return p


def mlp_spec(cfg: ArchConfig):
    s = {"up": P("fsdp", "tp"), "down": P("tp", "fsdp")}
    if cfg.mlp_variant == "swiglu":
        s["gate"] = P("fsdp", "tp")
    return s


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when ``p`` has a gate, else GELU (tanh form, JAX's default)."""
    if "gate" in p:
        h = constrain(F.silu(x @ p["gate"]) * (x @ p["up"]), "dp", None, "tp")
    else:
        h = constrain(F.gelu(x @ p["up"], approximate="tanh"),
                      "dp", None, "tp")
    return constrain(h @ p["down"], "dp", None, None)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: ArchConfig, device="cpu"):
    return {"w": normal(gen, (cfg.padded_vocab, cfg.d_model),
                        cfg.d_model ** -0.5, dtype_of(cfg), device)}


def embed_spec(cfg: ArchConfig):
    return {"w": P("tp", "fsdp")}


def head_init(gen, cfg: ArchConfig, device="cpu"):
    return {"w": normal(gen, (cfg.d_model, cfg.padded_vocab),
                        cfg.d_model ** -0.5, dtype_of(cfg), device)}


def head_spec(cfg: ArchConfig):
    return {"w": P("fsdp", "tp")}


def _token_ce(logits: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """(B, c, V) float32 logits, (B, c) labels -> (B, c): logsumexp minus
    the gold logit."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].to(torch.long))[..., 0]
    return logz - gold


def _chunk_ce(xc: torch.Tensor, w_head: torch.Tensor,
              lc: torch.Tensor) -> torch.Tensor:
    """Token CE of one chunk: (B, c, d) hidden, (B, c) labels -> (B, c).
    Under a mesh the logits come out vocab-sharded, as the reference pins
    them; the gold logit's gather has no DTensor rule over a cut dim, so
    the logsumexp and the gather run on each rank's rows with the
    vocabulary gathered (``local``)."""
    logits = constrain((xc @ w_head).to(torch.float32),
                       "dp", None, "tp")                      # (B, c, V)
    return local(_token_ce, logits, lc, out=placed("dp", None),
                 ins=(placed("dp", None, None), placed("dp", None)))


def chunked_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, *,
                          chunk: int = 512) -> torch.Tensor:
    """Mean token CE without materializing full (B, S, V) logits: the
    sequence is cut into ``max(S // chunk, 1)`` equal chunks, each
    chunk's logits cast to float32, logsumexp minus the gold logit, then
    the mean over every token. An S that those chunks do not divide
    raises, as the reference's reshape does (no token is dropped).

    With grad enabled each chunk is recomputed in the backward pass
    (``torch.utils.checkpoint``), so only one chunk's (B, c, V) float32
    logits live at a time; the values are the same either way."""
    B, S, d = x.shape
    nchunk = max(S // chunk, 1)
    chunk = S // nchunk
    if nchunk * chunk != S:
        raise ValueError(f"sequence length {S} is not {nchunk} chunks of "
                         f"{chunk}")
    losses = []
    for c0 in range(0, S, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            losses.append(checkpoint(_chunk_ce, xc, w_head, lc,
                                     use_reentrant=False))
        else:
            losses.append(_chunk_ce(xc, w_head, lc))
    return torch.stack(losses).mean()
