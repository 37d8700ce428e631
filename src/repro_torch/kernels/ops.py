"""Device dispatch for the kernels, and nothing else.

A CUDA tensor launches the hand-written kernel, which raises if it
cannot run; there is no fallback. A CPU tensor takes the plain PyTorch
version. (The reference's ops fall back quietly to jnp on a GPU; the
port does not.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import distance_argmin_hamming as _dh
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import minhash_buckets as _mh
from repro_torch.kernels import ref as _ref


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def distance_argmin_l2(x, centers, center_valid, *, accumulate: bool = False,
                       block: int = 4096):
    """(labels, squared distances); with ``accumulate`` also float32
    per-cluster sums (k, d) and counts (k,) of the rows (one Lloyd
    sweep's local work). ``block`` rows per step on the CPU."""
    if _on_cpu(x):
        from repro_torch.core.assign import assign_l2, assign_l2_with_partials
        fn = assign_l2_with_partials if accumulate else assign_l2
        return fn(x, centers, center_valid, block=block)
    if accumulate:
        return _da.distance_argmin_l2_accumulate(x, centers, center_valid)
    return _da.distance_argmin_l2(x, centers, center_valid)


def distance_argmin_l2_heads(x, centers, csq, center_valid):
    """Head-batched L2 assignment: x (H, n, d) against centers (H, k, d),
    ‖c‖² (H, k) and validity (H, k) -> (labels (H, n) int32, d² (H, n)).
    One launch for all heads on the card; head by head ``assign_l2`` on
    the CPU."""
    if _on_cpu(x):
        return _ref.distance_argmin_l2_heads_ref(x, centers, csq,
                                                 center_valid)
    return _da.distance_argmin_l2_heads(x, centers, csq, center_valid)


def l2_absorb_heads(keys, values, centers, v_cent, radius, v_radius, mass,
                    center_valid, v_max, csq, *, ema, decay):
    """The decode step's absorb of one layer's kv heads, in place: keys
    and values (H, 1, d) routed against the state and EMA-drifted into the
    hit clusters -> (labels (H, 1) int32, d² (H, 1)). One launch for all
    heads on the card (``decay``, the EMA's factor for one row as a (1,)
    device tensor, feeds the kernel); ``serve.kv_cluster.absorb_plain``
    with ``ema`` (the head-batched route, then one EMA) on the CPU."""
    if _on_cpu(keys):
        from repro_torch.serve.kv_cluster import absorb_plain
        return absorb_plain(keys, values, centers, v_cent, radius, v_radius,
                            mass, center_valid, v_max, csq, ema=ema)
    return _da.l2_absorb_heads(keys, values, centers, v_cent, radius,
                               v_radius, mass, center_valid, v_max, csq,
                               decay)


def distance_argmin_hamming(codes, centers, center_valid, *,
                            block: int = 4096):
    """(labels int32, mismatch counts float32), the contract of
    ``core.assign.assign_hamming``; ``block`` rows per step on the CPU."""
    if _on_cpu(codes):
        from repro_torch.core.assign import assign_hamming
        return assign_hamming(codes, centers, center_valid, block=block)
    labels, counts = _dh.distance_argmin_hamming(codes, centers, center_valid)
    return labels, counts.to(torch.float32)


def distance_argmin_hamming_packed(packed, packed_centers, center_valid, *,
                                   bits: int, d: int | None = None,
                                   block: int = 4096):
    """(labels int32, mismatch counts float32), the contract of
    ``core.assign.assign_hamming_packed``."""
    if _on_cpu(packed):
        from repro_torch.core.assign import assign_hamming_packed
        return assign_hamming_packed(packed, packed_centers, center_valid,
                                     bits=bits, d=d, block=block)
    labels, counts = _dh.distance_argmin_hamming_packed(
        packed, packed_centers, center_valid, bits=bits, d=d)
    return labels, counts.to(torch.float32)


def minhash_segments(ids_flat, offsets, keys):
    """Bucket MinHash over CSR segments: (S,) uint32 in the int64 carrier."""
    if _on_cpu(ids_flat):
        return _ref.minhash_segments_ref(ids_flat, offsets, keys)
    return _mh.minhash_segments(ids_flat, offsets, keys)


def minhash_even_buckets(ids, keys):
    """Bucket MinHash over (nb, bsz) rows: (nb,) uint32 in the carrier."""
    if _on_cpu(ids):
        return _ref.minhash_even_buckets_ref(ids, keys)
    return _mh.minhash_even_buckets(ids, keys)


def flash_attention(q, k, v, *, causal: bool = True):
    """GQA attention of q (B, Hq, S, dh) over k, v (B, Hkv, S, dh), float32
    inside, output in q's dtype: ``ref.attention_ref``'s function. The
    kernel is forward only: a CUDA input that requires grad while grad
    mode is on raises (``flash_attention.forward_only``); the CPU's plain
    version is differentiable."""
    if _on_cpu(q):
        return _ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def flash_centroid_attention(q, centers, v_cent, log_mass):
    """``softmax_K(q·c/√dh + log_mass) @ v_cent`` of q (B, Hq, S, dh) over
    (B, Hkv, K, dh) centroids: ``ref.centroid_attention_ref``'s function."""
    if _on_cpu(q):
        return _ref.centroid_attention_ref(q, centers, v_cent, log_mass)
    return _fa.flash_centroid_attention(q, centers, v_cent, log_mass)


def flash_centroid_decode(q, centers, v_cent, mass, center_valid,
                          extra_k=None, extra_v=None):
    """The decode step's centroid attention over one layer's state, read in
    place: ``ref.centroid_decode_ref``'s function."""
    if _on_cpu(q):
        return _ref.centroid_decode_ref(q, centers, v_cent, mass,
                                        center_valid, extra_k, extra_v)
    return _fa.flash_centroid_decode(q, centers, v_cent, mass, center_valid,
                                     extra_k, extra_v)


#: every wrapper that counts its launches (``fn.launches``)
COUNTED = (_da.distance_argmin_l2, _da.distance_argmin_l2_heads,
           _da.distance_argmin_l2_accumulate, _da.l2_absorb_heads,
           _dh.distance_argmin_hamming, _dh.distance_argmin_hamming_packed,
           _mh.minhash_segments,
           _fa.flash_attention, _fa.flash_centroid_attention,
           _fa.flash_centroid_decode)
