"""Compressed collectives: an int8 quantized all-reduce, and lossless
narrow-integer all-to-all.

The counterpart of ``repro.distributed.compression``, on a
``utils.compat.Mesh``. ``compressed_psum`` moves int8 on the wire in both
of its phases (reduce-scatter by all-to-all, then all-gather), 4x fewer
bytes than a float32 all-reduce; the caller may feed its residual back
(error feedback). The table-sync fit's Lloyd refine sweeps use it under
``GeekConfig.compress_collectives`` (``core.distributed``).
``narrow_int_all_to_all`` ships small non-negative integers as uint8 or
16 bits, exactly: the sharded discovery's bucket-map exchange.

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
reduce-scatter adds the ranks' blocks in rank order, so the results are
the reference's on the same inputs.
"""
from __future__ import annotations

import torch

from repro_torch.utils.compat import Mesh, all_gather, all_to_all, axis_size


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale, residual)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    resid = x32 - q.to(torch.float32) * scale
    return q, scale, resid


def compressed_psum(x: torch.Tensor, mesh: Mesh):
    """Mean over the mesh with an int8 wire format. Returns (mean,
    residual); feed the residual back into the next step's input (error
    feedback)."""
    g = axis_size(mesh)
    shape, n = x.shape, x.numel()
    flat = torch.nn.functional.pad(x.reshape(-1).to(torch.float32),
                                   (0, (-n) % g))
    q, scale, resid = quantize_int8(flat)
    # phase 1: reduce-scatter, int8 on the wire; row i is rank i's block
    recv = all_to_all(q.reshape(g, -1), mesh, split_axis=0, concat_axis=0)
    scales = all_gather(scale, mesh)                          # (g,) float32
    part = recv.to(torch.float32) * scales[:, None]
    local = part[0]
    for i in range(1, g):
        local = local + part[i]
    local = local / g
    # phase 2: all-gather the reduced block, int8 on the wire
    q2, scale2, _ = quantize_int8(local)
    gq = all_gather(q2, mesh)                                 # (g, n/g)
    gs = all_gather(scale2, mesh)                             # (g,)
    out = (gq.to(torch.float32) * gs[:, None]).reshape(-1)[:n]
    return out.reshape(shape).to(x.dtype), resid[:n].reshape(shape)


def narrow_int_all_to_all(x: torch.Tensor, mesh: Mesh, num_values: int, *,
                          split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled ``all_to_all`` of integers in ``[0, num_values)``, narrow on
    the wire and exact: uint8 when ``num_values <= 2**8``, 16 bits when
    ``<= 2**16`` (offset by 2**15 into int16, and sent as its bytes: NCCL
    and gloo take no 16-bit integer), else unchanged."""
    if num_values <= 1 << 8:
        wire = all_to_all(x.to(torch.uint8), mesh, split_axis=split_axis,
                          concat_axis=concat_axis)
        return wire.to(x.dtype)
    if num_values <= 1 << 16:
        wire = all_to_all((x.to(torch.int32) - (1 << 15)).to(torch.int16),
                          mesh, split_axis=split_axis,
                          concat_axis=concat_axis)
        return (wire.to(torch.int32) + (1 << 15)).to(x.dtype)
    return all_to_all(x, mesh, split_axis=split_axis, concat_axis=concat_axis)


def compressed_psum_tree(grads, mesh: Mesh):
    """``compressed_psum`` over a nest of dicts, lists and tuples of
    tensors. Returns (means, residuals), each nested as ``grads``."""
    if isinstance(grads, torch.Tensor):
        return compressed_psum(grads, mesh)
    if isinstance(grads, dict):
        outs = {k: compressed_psum_tree(v, mesh) for k, v in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    if isinstance(grads, (list, tuple)):
        outs = [compressed_psum_tree(v, mesh) for v in grads]
        return (type(grads)(o[0] for o in outs),
                type(grads)(o[1] for o in outs))
    raise TypeError(f"expected tensors in dicts, lists or tuples, got "
                    f"{type(grads).__name__}")
