"""Plain PyTorch versions of the kernels: the ground truth they are held
to, and the CPU path (the counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.lsh import minhash_over_segments
from repro_torch.kernels.pack import packed_hamming
from repro_torch.utils.hashing import hash_u32, mix_u32

INT32_MAX = 2**31 - 1


def distance_argmin_l2_ref(x, centers, center_valid):
    """(labels int32, squared distances clamped >= 0) in float32."""
    x = x.to(torch.float32)
    centers = centers.to(torch.float32)
    d2 = (torch.sum(x * x, -1, keepdim=True) - 2.0 * (x @ centers.T)
          + torch.sum(centers * centers, -1)[None, :])
    d2 = torch.where(center_valid[None, :], d2, torch.finfo(torch.float32).max)
    mind, lab = torch.min(d2, dim=-1)
    return lab.to(torch.int32), torch.clamp(mind, min=0.0)


def distance_argmin_l2_heads_ref(x, centers, csq, center_valid):
    """Head by head ``core.assign.assign_l2``: x (H, n, d) against centers
    (H, k, d) -> (labels (H, n) int32, squared distances (H, n) float32).
    ``assign_l2`` computes ‖c‖² itself (as a per-head ``predict`` on the
    CPU does), so ``csq`` (H, k), the kernel's input, is not read."""
    from repro_torch.core.assign import assign_l2
    del csq
    out = [assign_l2(x[h].to(torch.float32), centers[h].to(torch.float32),
                     center_valid[h].to(torch.bool))
           for h in range(x.shape[0])]
    return (torch.stack([lab for lab, _ in out]),
            torch.stack([d2 for _, d2 in out]))


def distance_argmin_l2_acc_sums_ref(x, labels, k, slots, bn):
    """The accumulating kernel's (k, d) sums in its own order, in plain
    float32: slot s takes the bn-row tiles s, s + slots, s + 2·slots, ...
    and adds their rows in row order, starting from 0; the slots are then
    added in slot order. Each step adds one row into every slot at once
    (distinct targets, so one rounding each); padding goes to a spare
    cluster k. The kernel's sums equal these bit for bit."""
    n, d = x.shape
    dev = x.device
    r = torch.arange(n, device=dev)
    tile = r // bn
    slot = tile % slots
    pos = (tile // slots) * bn + r % bn
    table = torch.full((int(pos.max()) + 1, slots), n, dtype=torch.long,
                       device=dev)
    table[pos, slot] = r
    xp = torch.cat([x.float(), torch.zeros((1, d), device=dev)])
    lp = torch.cat([labels.long(), torch.full((1,), k, device=dev)])
    acc = torch.zeros((slots * (k + 1), d), device=dev)
    base = torch.arange(slots, device=dev) * (k + 1)
    for rows in table:
        idx = base + lp[rows]
        acc[idx] = acc[idx] + xp[rows]
    out = torch.zeros((k, d), device=dev)
    for part in acc.view(slots, k + 1, d)[:, :k]:
        out = out + part
    return out


def distance_argmin_hamming_ref(codes, centers, center_valid):
    """(labels int32, mismatch counts int32); an invalid center counts
    d + 1, as ``core.assign.assign_hamming`` (the reference's main path)
    has it. Unblocked: (n, k, d) at once."""
    d = codes.shape[1]
    dist = d - (codes[:, None, :] == centers[None, :, :]).sum(
        -1, dtype=torch.int32)
    dist = torch.where(center_valid[None, :], dist, d + 1)
    mind, lab = torch.min(dist, dim=-1)
    return lab.to(torch.int32), mind


#: the equality kernel's edge cases: codes equal to the -1 / -2 pad
#: sentinels of the TPU kernel on both sides, int32's extremes, every
#: center the same row (ties: the first valid center wins), a dead tile of
#: 32 centers between live ones with k not a multiple of 32, no valid
#: center; each at every width of ``EQUALITY_WIDTHS``
EQUALITY_CASES = ("pad sentinels", "int32 extremes", "every center identical",
                  "dead tile between live ones", "no valid center")
#: every width of the kernel's one-chunk path up to 17, its last two, and
#: two of the chunked path (d > 32)
EQUALITY_WIDTHS = (*range(1, 18), 31, 32, 33, 45)
INT32_MIN = -2**31


def equality_case(case: str, d: int, n: int, gen: torch.Generator,
                  device=None):
    """(codes (n, d), centers (k, d) int32, valid (k,) bool) of one of
    ``EQUALITY_CASES`` at width ``d``, drawn from ``gen`` on ``device``
    (its device by default). Shared by the card tests, ``chip_smoke.py``
    and ``tools/kernel_variants.py``."""
    device = gen.device if device is None else device
    if case not in EQUALITY_CASES:
        raise ValueError(f"unknown equality case {case!r}")

    def draw(values, shape):
        v = torch.tensor(values, dtype=torch.int32, device=device)
        return v[torch.randint(0, len(values), shape, generator=gen,
                               device=device)]
    k = 100 if case == "dead tile between live ones" else 70
    i = torch.arange(k, device=device)
    valid = i % 7 != 3
    if case == "pad sentinels":
        cen = draw((-2, -1, 0, 1), (k, d))
        codes = draw((-2, -1, 0, 1), (n, d))
    elif case == "int32 extremes":
        ext = (INT32_MIN, INT32_MIN + 1, -1, 0, INT32_MAX - 1, INT32_MAX)
        cen, codes = draw(ext, (k, d)), draw(ext, (n, d))
    else:
        cen = torch.randint(0, 12, (k, d), generator=gen, device=device,
                            dtype=torch.int32)
        codes = torch.randint(0, 12, (n, d), generator=gen, device=device,
                              dtype=torch.int32)
    if case == "every center identical":
        cen[:] = cen[0]
        valid = i >= 5
    elif case == "dead tile between live ones":
        valid = (i < 20) | (i >= 64)
        codes[::3] = cen[40]                    # the dead tile's center
        codes[1::3] = cen[70]
        return codes, cen, valid
    elif case == "no valid center":
        valid = torch.zeros(k, dtype=torch.bool, device=device)
    codes[::3] = cen[torch.randint(0, k, (codes[::3].shape[0],),
                                   generator=gen, device=device)]
    return codes, cen, valid


def distance_argmin_hamming_keys(codes, centers, center_valid, *, bk=32):
    """The equality kernel's arithmetic for d <= 32, in plain torch (the
    tests hold it to the reference): a center's key is its offset, d·bk +
    j when valid and (2d + 1)·bk + j when not (j its index in its tile of
    bk), less bk for every equal column, so count·bk + j; a tile's least
    key is its least count, first index on ties; each tile with a valid
    center is merged into (count, label) with a strict '<', tiles in
    ascending order. Returns (labels int32, counts int32)."""
    n, d = codes.shape
    k = centers.shape[0]
    j = torch.arange(k, device=codes.device) % bk
    off = torch.where(center_valid, d, 2 * d + 1) * bk + j
    eq = (codes[:, None, :] == centers[None, :, :]).sum(-1)
    key = off[None, :] - bk * eq
    best = torch.full((n,), d + 1, dtype=torch.int64, device=codes.device)
    best_i = torch.zeros_like(best)
    for t0 in range(0, k, bk):
        if not bool(center_valid[t0:t0 + bk].any()):
            continue
        tmin = key[:, t0:t0 + bk].min(dim=1).values
        take = tmin // bk < best
        best = torch.where(take, tmin // bk, best)
        best_i = torch.where(take, t0 + tmin % bk, best_i)
    return best_i.to(torch.int32), best.to(torch.int32)


def distance_argmin_hamming_packed_ref(packed, packed_centers, center_valid,
                                       *, bits, d=None):
    """Packed-domain plain version: XOR + per-field collapse + popcount;
    an invalid center counts ``d + 1`` (int32 max without ``d``)."""
    dist = packed_hamming(packed, packed_centers, bits)
    dist = torch.where(center_valid[None, :], dist,
                       INT32_MAX if d is None else d + 1)
    mind, lab = torch.min(dist, dim=-1)
    return lab.to(torch.int32), mind


def minhash_even_buckets_ref(ids, keys):
    """ids: (nb, bsz) int32, keys: (K, 2) uint32 -> (nb,) uint32, all
    uint32 in the int64 carrier."""
    sig = torch.zeros((ids.shape[0],), dtype=torch.int64, device=ids.device)
    for k in range(keys.shape[0]):
        h = hash_u32(ids, keys[k, 0], keys[k, 1])
        sig = mix_u32(sig, torch.min(h, dim=-1).values)
    return sig


def minhash_segments_ref(ids_flat, offsets, keys):
    """CSR segments (``offsets`` (S+1,)) -> (S,) signatures: the segment
    MinHash of ``core.lsh.minhash_over_segments``, reading only
    ``ids_flat[offsets[0]:offsets[-1]]`` as the kernel does."""
    S = offsets.shape[0] - 1
    pos = torch.arange(ids_flat.shape[0], device=ids_flat.device,
                       dtype=offsets.dtype)
    seg = torch.searchsorted(offsets, pos, right=True) - 1
    inside = (seg >= 0) & (seg < S)
    return minhash_over_segments(ids_flat, seg.clamp(0, max(S - 1, 0)), S,
                                 keys, valid=inside)


def centroid_attention_ref(q, centers, v_cent, log_mass):
    """q: (B, Hq, S, dh); centers/v_cent: (B, Hkv, K, dh); log_mass:
    (B, Hkv, K). Mass-weighted non-causal float32 softmax over centroids
    (GQA by repetition); ``log_mass = -1e30`` rows are excluded, and with
    every row excluded the output is the mean of ``v_cent``. Output in
    q's dtype."""
    dh = q.shape[-1]
    rep = q.shape[1] // centers.shape[1]
    c = centers.repeat_interleave(rep, dim=1)
    vc = v_cent.repeat_interleave(rep, dim=1)
    lm = log_mass.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     c.to(torch.float32)) / (dh ** 0.5)
    s = s + lm[:, :, None, :].to(torch.float32)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        vc.to(torch.float32)).to(q.dtype)


def centroid_decode_ref(q, centers, v_cent, mass, center_valid,
                        extra_k=None, extra_v=None):
    """The decode routine's function: q (B, 1, Hq, dh) over one layer's
    state, centers and v_cent (Hkv, K, dh), mass and center_valid (Hkv,
    K), the log-mass by ``OnlineKVCluster.head_state``'s rule, plus the
    fresh rows extra_k, extra_v (B, 1, Hkv, dh) with log-mass 0: exactly
    ``serve.kv_cluster.clustered_attention(q, state, extra_k=, extra_v=)``.
    Returns (B, 1, Hq, dh) in q's dtype."""
    B = q.shape[0]
    hkv, K, dh = centers.shape
    live = center_valid & (mass > 0)
    lm = torch.where(live, torch.log(torch.clamp(mass, min=1e-9)), -1e30)
    c = centers.to(torch.float32).expand(B, hkv, K, dh)
    vc = v_cent.to(torch.float32).expand(B, hkv, K, dh)
    lm = lm.to(torch.float32).expand(B, hkv, K)
    if extra_k is not None:
        c = torch.cat([c, extra_k.to(torch.float32).transpose(1, 2)], dim=2)
        vc = torch.cat([vc, extra_v.to(torch.float32).transpose(1, 2)], dim=2)
        lm = torch.cat([lm, torch.zeros((B, hkv, 1), dtype=torch.float32,
                                        device=q.device)], dim=2)
    o = centroid_attention_ref(q.transpose(1, 2), c, vc, lm)
    return o.transpose(1, 2).to(q.dtype)


def attention_ref(q, k, v, *, causal=True):
    """q: (B, Hq, S, dh); k, v: (B, Hkv, S, dh). float32 softmax, GQA by
    head repetition, keys past each query masked to -1e30 when causal.
    Output in q's dtype."""
    S, dh = q.shape[2], q.shape[3]
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (dh ** 0.5)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
