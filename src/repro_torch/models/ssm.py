"""Mamba (selective SSM) block, the sub-quadratic mixer of Jamba's 1:7
interleave (the counterpart of ``repro.models.ssm``).

The scan runs sequentially over chunks of ``min(256, S)`` positions,
carrying the (B, d_inner, d_state) float32 state, and in parallel within
a chunk by a doubling (Hillis-Steele) prefix scan of log2(chunk) steps
over the chunk's (B, chunk, d_inner, d_state) discretized tensors. The
reference scans a chunk with ``lax.associative_scan``, whose association
order differs: the two agree to float32 rounding, not bit for bit.

A cache ``{"h", "conv"}`` (``mamba_cache_init``) is updated in place:
the last state and the last ``conv - 1`` rows of the conv input are
copied into it, so a captured decode step replays on the same storage.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, normal
from repro_torch.models.sharding import P, constrain, local, placed

_CHUNK = 256


def mamba_init(gen, cfg: ArchConfig, device="cpu"):
    d, di = cfg.d_model, cfg.mamba_d_inner
    ds, dtr, ck = cfg.mamba_d_state, cfg.resolved_dt_rank, cfg.mamba_conv
    dt = dtype_of(cfg)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device)).expand(di, ds).clone()
    return {
        "in_proj": normal(gen, (d, 2 * di), d ** -0.5, dt, device),
        "conv_w": normal(gen, (ck, di), ck ** -0.5, dt, device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": normal(gen, (di, dtr + 2 * ds), di ** -0.5, dt, device),
        "dt_w": normal(gen, (dtr, di), dtr ** -0.5, dt, device),
        "dt_b": torch.full((di,), -4.6, dtype=dt, device=device),
        "A_log": a_log,
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": normal(gen, (di, d), di ** -0.5, dt, device),
    }


def mamba_spec(cfg: ArchConfig):
    return {"in_proj": P("fsdp", "tp"), "conv_w": P(None, "tp"),
            "conv_b": P("tp"), "x_proj": P("tp", None), "dt_w": P(None, "tp"),
            "dt_b": P("tp"), "A_log": P("tp", None), "D": P("tp"),
            "out_proj": P("tp", "fsdp")}


def mamba_cache_spec(cfg: ArchConfig):
    return {"h": P("dp", "tp", None), "conv": P("dp", None, "tp")}


def mamba_cache_init(cfg: ArchConfig, batch: int, device="cpu"):
    di, ds, ck = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_conv
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, ck - 1, di), dtype=dtype_of(cfg),
                                device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None):
    """Depthwise causal conv over the sequence (a cross-correlation, no
    flip). x: (B, S, di); w: (ck, di); history: (B, ck - 1, di) rows
    before x, zeros when None. Returns (out (B, S, di), the last ck - 1
    rows of the padded input)."""
    ck = w.shape[0]
    pad = history if history is not None else torch.zeros(
        (x.shape[0], ck - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad.to(x.dtype), x], dim=1)
    out = F.conv1d(xp.transpose(1, 2), w.t()[:, None, :].to(x.dtype),
                   groups=x.shape[2]).transpose(1, 2)
    return out + b, xp[:, xp.shape[1] - (ck - 1):]


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps h -> a·h + b:
    returns (A_t, B_t) with h_t = A_t·h_0 + B_t. Doubling steps: after the
    step of offset o, position t holds the composition of positions
    max(0, t - 2o + 1)..t."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_new = a.clone()
        b_new = b.clone()
        b_new[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        a_new[:, off:] = a[:, off:] * a[:, :-off]
        a, b = a_new, b_new
        off *= 2
    return a, b


def _ssm_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              xin: torch.Tensor, A: torch.Tensor, h0: torch.Tensor | None):
    """Chunked selective scan; the discretized (B, chunk, di, ds) tensors
    exist one chunk at a time. dt, xin: (B, S, di) float32; Bm, Cm:
    (B, S, ds) float32; A: (di, ds); h0: (B, di, ds), zeros when None.
    Returns (h_last, y (B, S, di) float32)."""
    B, S, di = dt.shape
    if h0 is None:
        h0 = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                         device=dt.device)
    cs = min(_CHUNK, S)
    if S % cs:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"scan chunk {cs}")
    h = h0
    ys = []
    for c0 in range(0, S, cs):
        dtc, bc = dt[:, c0:c0 + cs], Bm[:, c0:c0 + cs]
        cc, xc = Cm[:, c0:c0 + cs], xin[:, c0:c0 + cs]
        abar = torch.exp(dtc[..., None] * A)                 # (B, cs, di, ds)
        bx = (dtc * xc)[..., None] * bc[:, :, None, :]
        aa, bb = _prefix_scan(abar, bx)
        h_all = aa * h[:, None] + bb
        ys.append(torch.einsum("bcns,bcs->bcn", h_all, cc))  # (B, cs, di)
        h = h_all[:, -1]
    return h, torch.cat(ys, dim=1)


def mamba_apply(p, x: torch.Tensor, cfg: ArchConfig, cache: dict | None = None):
    """x: (B, S, d) -> (y, cache). Without a cache the state starts at
    zero (training form); with one, it starts from the cache, which is
    updated in place and returned."""
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dtr = cfg.resolved_dt_rank

    xz = constrain(x @ p["in_proj"], "dp", None, "tp")
    xin, z = xz[..., :di], xz[..., di:]
    hist = cache["conv"] if cache is not None else None
    # under a mesh the conv and the scan run on each rank's channels
    # (``local``: DTensor has no rule for a grouped conv over cut
    # channels); their weights' gradients are summed over the batch axes,
    # and the channels' shares of the B and C projections over "model"
    chan = placed("dp", None, "tp")
    xin, new_hist = local(
        _causal_conv, xin, p["conv_w"], p["conv_b"], hist,
        out=(chan, chan), ins=(chan, placed(None, "tp"), placed("tp"),
                               None if hist is None else chan),
        grads=(chan, placed(None, "tp", summed=("dp",)),
               placed("tp", summed=("dp",)), chan))
    xin = constrain(F.silu(xin), "dp", None, "tp")

    xdbl = xin @ p["x_proj"]
    # softplus in the parameter dtype, then float32
    dt = F.softplus(xdbl[..., :dtr] @ p["dt_w"] + p["dt_b"]).to(torch.float32)
    Bm = xdbl[..., dtr:dtr + ds].to(torch.float32)
    Cm = xdbl[..., dtr + ds:].to(torch.float32)
    A = -torch.exp(p["A_log"])                               # (di, ds) f32

    h0 = cache["h"] if cache is not None else None
    rows, state = placed("dp", None, None), placed("dp", "tp", None)
    h_last, y = local(
        _ssm_scan, dt, Bm, Cm, xin.to(torch.float32), A, h0,
        out=(state, chan),
        ins=(chan, rows, rows, chan, placed("tp", None),
             None if h0 is None else state),
        grads=(chan, placed("dp", None, None, summed=("tp",)),
               placed("dp", None, None, summed=("tp",)), chan,
               placed("tp", None, summed=("dp",)), state))
    y = constrain(y + p["D"] * xin.to(torch.float32), "dp", None, "tp")
    y = constrain((y.to(x.dtype) * F.silu(z)) @ p["out_proj"],
                  "dp", None, None)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_hist)
    return y, cache

