"""RWKV6 "Finch" block: attention-free time mixing with a data-dependent
per-channel decay (arXiv:2404.05892), plus the squared-ReLU channel mix
(the counterpart of ``repro.models.rwkv6``).

Recurrence per head (state S: (hd, hd), decay w_t in (0, 1)^hd):
    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
A sequence of S > 1 positions with S a multiple of 128 runs the chunked
closed form (``_wkv_chunked``); any other length, a decode step
included, runs the recurrence step by step, as in the reference. The
port's chunked form is exact for any decay; the reference's clamps its
cumulative log-decays and departs from its recurrence where a chunk's
decay passes e^-25 (``_wkv_chunked``).

As in the reference, the token-shift mixes are static per channel (the
ddlerp LoRA is kept for the decay only). A cache ``{"s", "x_tm",
"x_cm"}`` (``rwkv_cache_init``) is updated in place: the last state and
the last position's normed block inputs of the time and channel mixes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, normal
from repro_torch.models.sharding import P, constrain

_WKV_CHUNK = 128


def rwkv_init(gen, cfg: ArchConfig, device="cpu"):
    d = cfg.d_model
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    lora, f = cfg.rwkv_decay_lora, cfg.d_ff
    dt = dtype_of(cfg)
    std = d ** -0.5

    def mat(shape, scale=std):
        return normal(gen, shape, scale, dt, device)

    return {
        # time mix
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),  # r,k,v,w,g
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=device),
        "w_lora_a": mat((d, lora)),
        "w_lora_b": mat((lora, d), lora ** -0.5),
        "u": normal(gen, (H, hd), 0.1, torch.float32, device),
        "wr": mat((d, d)), "wk": mat((d, d)), "wv": mat((d, d)),
        "wg": mat((d, d)), "wo": mat((d, d)),
        "ln_x": torch.ones((d,), dtype=dt, device=device),
        # channel mix
        "mu_c": torch.full((2, d), 0.5, dtype=dt, device=device),
        "ck": mat((d, f)), "cv": mat((f, d), f ** -0.5), "cr": mat((d, d)),
    }


def rwkv_spec(cfg: ArchConfig):
    return {"mu": P(None, None), "w0": P(), "w_lora_a": P("fsdp", None),
            "w_lora_b": P(None, "fsdp"), "u": P("tp", None),
            "wr": P("fsdp", "tp"), "wk": P("fsdp", "tp"),
            "wv": P("fsdp", "tp"), "wg": P("fsdp", "tp"),
            "wo": P("tp", "fsdp"), "ln_x": P(),
            "mu_c": P(None, None), "ck": P("fsdp", "tp"),
            "cv": P("tp", "fsdp"), "cr": P("fsdp", "tp")}


def rwkv_cache_spec(cfg: ArchConfig):
    return {"s": P("dp", "tp", None, None), "x_tm": P("dp", None),
            "x_cm": P("dp", None)}


def rwkv_cache_init(cfg: ArchConfig, batch: int, device="cpu"):
    d, H, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = dtype_of(cfg)
    return {"s": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((batch, d), dtype=dt, device=device),
            "x_cm": torch.zeros((batch, d), dtype=dt, device=device)}


def _wkv_chunked(r, k, v, w, u, s0):
    """Chunk-parallel WKV: within a chunk of C = 128 positions the
    recurrence has a closed form (per key channel, P_t = ∏_{τ≤t} w_τ):

        y_t = (r_t ⊙ P_{t-1})ᵀ S_0 + Σ_{s<t} (r_t ⊙ P_{t-1}/P_s)·k_s v_s
              + (r_t·u·k_t) v_t
        S_C = diag(P_C) S_0 + Σ_s (k_s ⊙ P_C/P_s) v_sᵀ

    Every decay factor is taken as exp of a difference of cumulative
    log-decays that is ≤ 0, so nothing overflows and no clamp is needed:
    this is the step recurrence's value for any decay. (The reference
    forms r ⊙ P_{t-1} and k / P_s apart, each with its cumulative
    log-decay clamped at -25; where a chunk's decay passes e^-25, as
    RWKV6-1.6B's does at its initial weights, its two factors no longer
    cancel and its chunked branch departs from its own recurrence. Where
    no decay passes the clamp, the two forms agree.) r, k, v, w: (B, S,
    H, hd) float32; u: (H, hd); s0: (B, H, hd, hd). Returns (s_last,
    y (B, S, H·hd) float32)."""
    B, S, H, hd = r.shape
    C = _WKV_CHUNK
    n = S // C
    before = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=r.device), diagonal=-1)

    def resh(a):                                    # -> (n, B, H, C, hd)
        return a.reshape(B, n, C, H, hd).permute(1, 0, 3, 2, 4)

    rs, ks, vs = resh(r), resh(k), resh(v)
    lws = resh(torch.log(torch.clamp(w, min=1e-38)))
    s = s0
    ys = []
    for i in range(n):
        rc, kc, vc, lw = rs[i], ks[i], vs[i], lws[i]        # (B, H, C, hd)
        L = torch.cumsum(lw, dim=2)                         # log P_t
        Lp = L - lw                                         # log P_{t-1}
        # log(P_{t-1} / P_s) for s < t, -inf elsewhere: (B, H, t, s, hd)
        gap = (Lp[:, :, :, None] - L[:, :, None]).masked_fill(
            ~before[:, :, None], float("-inf"))
        A = torch.sum(rc[:, :, :, None] * kc[:, :, None] * torch.exp(gap),
                      dim=-1)                               # (B, H, C, C)
        y = A @ vc + (rc * torch.exp(Lp)) @ s
        diag = torch.sum(rc * u[None, :, None, :] * kc, dim=-1, keepdim=True)
        y = y + diag * vc
        last = L[:, :, -1:]                                 # log P_C
        s = torch.exp(last).transpose(2, 3) * s + \
            (kc * torch.exp(last - L)).transpose(2, 3) @ vc
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H * hd)
    return s, y


def _wkv_steps(r, k, v, w, u, s):
    """The recurrence one position at a time. Shapes as ``_wkv_chunked``.
    Returns (s_last, y (B, S, H·hd) float32)."""
    B, S, H, hd = r.shape
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hd)
        kv = kt[..., None] * vt[..., None, :]                 # (B, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               s + u[None, :, :, None] * kv))
        s = wt[..., None] * s + kv
    return s, torch.stack(ys, dim=1).reshape(B, S, H * hd)


def _shift(x: torch.Tensor, prev: torch.Tensor | None):
    """Token shift: x_{t-1} along the sequence (``prev`` seeds position
    0, zeros when None)."""
    prev = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int, eps: float):
    """Per-head normalization in float32 (population variance), cast back
    to ``y.dtype``, then times ``scale``."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).to(torch.float32)
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return yh.reshape(B, S, d).to(y.dtype) * scale


def rwkv_time_mix(p, x: torch.Tensor, cfg: ArchConfig,
                  cache: dict | None = None):
    """x: (B, S, d), the normed block input -> (out, cache). With a cache
    the state and the shift start from it; it is updated in place."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xprev = _shift(x, cache["x_tm"] if cache is not None else None)

    def lerp(mu):
        return x + (xprev - x) * mu

    def heads(t):
        return constrain(t.reshape(B, S, H, hd).to(torch.float32),
                         "dp", None, "tp", None)

    r = heads(lerp(p["mu"][0]) @ p["wr"])
    k = heads(lerp(p["mu"][1]) @ p["wk"])
    v = heads(lerp(p["mu"][2]) @ p["wv"])
    g = F.silu(lerp(p["mu"][4]) @ p["wg"])
    # the data-dependent decay (the Finch contribution), in float32
    wlog = p["w0"] + torch.tanh(lerp(p["mu"][3]).to(torch.float32)
                                @ p["w_lora_a"].to(torch.float32)) \
        @ p["w_lora_b"].to(torch.float32)
    w = constrain(torch.exp(-torch.exp(wlog)).reshape(B, S, H, hd),
                  "dp", None, "tp", None)                     # (0, 1)

    s0 = constrain(cache["s"] if cache is not None else torch.zeros(
        (B, H, hd, hd), dtype=torch.float32, device=x.device),
        "dp", "tp", None, None)
    if S > 1 and S % _WKV_CHUNK == 0:
        s_last, y = _wkv_chunked(r, k, v, w, p["u"], s0)
    else:
        s_last, y = _wkv_steps(r, k, v, w, p["u"], s0)
    y = _group_norm(y.to(x.dtype), p["ln_x"], H, cfg.norm_eps) * g
    out = y @ p["wo"]
    if cache is not None:
        cache["s"].copy_(s_last)
        cache["x_tm"].copy_(x[:, -1])
    return out, cache


def rwkv_channel_mix(p, x: torch.Tensor, cache: dict | None = None):
    """x: (B, S, d), the normed input -> (out, cache); the cache's
    ``x_cm`` seeds the shift and is updated in place."""
    xprev = _shift(x, cache["x_cm"] if cache is not None else None)
    xk = x + (xprev - x) * p["mu_c"][0]
    xr = x + (xprev - x) * p["mu_c"][1]
    r = torch.sigmoid(xr @ p["cr"])
    k = torch.square(torch.relu(xk @ p["ck"]))
    out = r * (k @ p["cv"])
    if cache is not None:
        cache["x_cm"].copy_(x[:, -1])
    return out, cache
