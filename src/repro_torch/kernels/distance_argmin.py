"""Fused L2 distance + argmin, the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/distance_argmin.py::distance_argmin_l2`` with
``accumulate=False`` (the TPU kernel ``_l2_kernel``): GEEK's one-pass
assignment (paper §3.3), O(n·d·k), run once in every fit and predict.

Bound on this card: operations. At 1M × 1024 × 128 the work is 2.7·10¹¹
float32 FMA-flops against 0.5 GB read, so the FP32 (non-tensor) rate, not
memory, is the limit; with a fitted model's k* valid centers, the work the
data needs is 2·n·k*·d. Design (``csrc/distance_argmin.cu``): one block of
128 threads per 128 rows loops over the center tiles, in place of the
TPU's sequential grid axis that carried the running min in scratch. A
tile of 64 centers with none valid is skipped (its exact candidate,
FLT_MAX at its first index, is folded in instead), so the work follows
k*, not k_max. The block's rows are read once and stay in shared memory
for d ≤ 256; center chunks stream through a ``cp.async`` double buffer;
each thread keeps an 8 × 8 register tile of float32 FMA products. Ties go
to the lowest center index by a lexicographic (d², index) reduction. The
plain version is ``ref.distance_argmin_l2_ref`` (and, row-blocked,
``core.assign.assign_l2``).

``distance_argmin_l2_heads`` is a head-batched entry of the same kernel:
the decode step of the KV-cache clustering routes each kv head's new keys
against that head's centroids, all heads of a layer in one launch (grid:
row tiles × heads), each head's labels and d² the bits of one launch on
that head. Its plain version is ``ref.distance_argmin_l2_heads_ref``.

``distance_argmin_l2_accumulate`` replaces the same function with
``accumulate=True`` (the TPU kernel ``_l2_acc_kernel``), the assignment of
each Lloyd refine sweep of the table-sync fit: the same labels and d², bit
for bit (one shared device function), plus float32 per-cluster sums (k, d)
and counts (k,) from the same pass over x. Bound on this card: the same
operations as above, plus n·d adds. The sums take no float atomics: a
fixed grid of ``ACC_SLOTS`` blocks adds its rows in row order into a slot
of its own, and a second kernel sums the slots in slot order, so two calls
give the same bits (``ref.distance_argmin_l2_acc_sums_ref`` rebuilds the
order). A slot holds only the live clusters (the valid centers and the
first invalid one), each tile's rows are added from shared memory, grouped
by label, one register chain a (label, column). Its plain version is
``core.assign.assign_l2_with_partials``.

``l2_absorb_heads`` is the decode step's absorb of one attention layer
(the KV-cache clustering's ``route`` + ``ema_update`` for one new key a
kv head, ``repro/serve/kv_cluster.py``, whose route is
``distance_argmin_l2``): one launch labels every head's key with the bits
of ``distance_argmin_l2_heads`` and applies the plain EMA's update to the
hit rows of the layer's state in place. Bound: bytes, a few kilobytes, so
in practice one launch's latency; a warp a head, no tiles. Its plain
version is the unfused path, ``serve.kv_cluster.absorb_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
             + [ctypes.c_int, ctypes.c_void_p])
_HEADS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
_ACC_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
_ABSORB_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])

#: the accumulating kernel's grid: one (k, d) partial slot per block
ACC_SLOTS = 256
BN = 128   # rows per tile, as in the source


def _entry():
    fn = build.load("distance_argmin").repro_l2_argmin_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _heads_entry():
    fn = build.load("distance_argmin").repro_l2_argmin_heads_f32
    fn.argtypes, fn.restype = _HEADS_ARGTYPES, ctypes.c_int
    return fn


def _acc_entry():
    fn = build.load("distance_argmin").repro_l2_argmin_acc_f32
    fn.argtypes, fn.restype = _ACC_ARGTYPES, ctypes.c_int
    return fn


def _absorb_entry():
    fn = build.load("distance_argmin").repro_l2_absorb_heads_f32
    fn.argtypes, fn.restype = _ABSORB_ARGTYPES, ctypes.c_int
    return fn


def _prepare(x, centers, center_valid):
    """Check the inputs; return (xf, cf, csq, valid int32), contiguous."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"distance_argmin_l2 runs on CUDA tensors, got {dev}")
    if centers.device != dev or center_valid.device != dev:
        raise ValueError("x, centers and center_valid must share a device")
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"expected x (n, d) and centers (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centers.shape)}")
    n, d = x.shape
    k = centers.shape[0]
    if tuple(center_valid.shape) != (k,):
        raise ValueError(f"center_valid must be ({k},)")
    if k == 0 or d == 0:
        raise ValueError("need at least one center and one feature")
    for t in (x, centers):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"expected float32 or bfloat16, got {t.dtype}")
    if n >= 2**31 or k >= 2**31:
        raise ValueError("n and k must fit in int32")
    xf = x.to(torch.float32).contiguous()
    cf = centers.to(torch.float32).contiguous()
    csq = torch.sum(cf * cf, dim=-1).contiguous()
    return xf, cf, csq, center_valid.to(torch.int32).contiguous()


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def distance_argmin_l2(x: torch.Tensor, centers: torch.Tensor,
                       center_valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: (labels (n,) int32, squared distances (n,) f32).

    ``x`` (n, d) and ``centers`` (k, d) are float32 or bfloat16 (cast to
    float32 here), ``center_valid`` (k,) bool, all on one CUDA device.
    ``||c||²`` is computed here in plain torch, as the reference does
    outside its kernel. Counts one launch in ``distance_argmin_l2.launches``.
    """
    dev = x.device
    xf, cf, csq, valid = _prepare(x, centers, center_valid)
    n, d = xf.shape
    k = cf.shape[0]
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return labels, d2
    err = _entry()(xf.data_ptr(), cf.data_ptr(), csq.data_ptr(),
                   valid.data_ptr(), n, k, d, labels.data_ptr(),
                   d2.data_ptr(), _device_index(dev),
                   torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "distance_argmin_l2")
    distance_argmin_l2.launches += 1
    return labels, d2


distance_argmin_l2.launches = 0


def distance_argmin_l2_heads(x: torch.Tensor, centers: torch.Tensor,
                             csq: torch.Tensor, center_valid: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the head-batched kernel once for all heads: (labels (H, n)
    int32, squared distances (H, n) float32).

    ``x`` (H, n, d) and ``centers`` (H, k, d) float32 or bfloat16 (cast to
    float32 here), ``csq`` (H, k) float32 the centers' squared norms (the
    caller computes them once per update of the centers), ``center_valid``
    (H, k) bool or int32, all on one CUDA device. Head h's result equals
    ``distance_argmin_l2(x[h], centers[h], center_valid[h])`` bit for bit
    when ``csq[h]`` has its bits. Counts one launch in
    ``distance_argmin_l2_heads.launches``.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"distance_argmin_l2_heads runs on CUDA tensors, "
                         f"got {dev}")
    if x.ndim != 3 or centers.ndim != 3 or x.shape[0] != centers.shape[0] \
            or x.shape[2] != centers.shape[2]:
        raise ValueError(f"expected x (H, n, d) and centers (H, k, d), got "
                         f"{tuple(x.shape)} and {tuple(centers.shape)}")
    H, n, d = x.shape
    k = centers.shape[1]
    if tuple(csq.shape) != (H, k) or tuple(center_valid.shape) != (H, k):
        raise ValueError(f"csq and center_valid must be ({H}, {k})")
    if any(t.device != dev for t in (centers, csq, center_valid)):
        raise ValueError("x, centers, csq and center_valid must share a "
                         "device")
    if H == 0 or k == 0 or d == 0:
        raise ValueError("need at least one head, center and feature")
    if H * max(n, k) * d >= 2**31:
        raise ValueError("the stacked arrays must index in int32")
    xf = x.to(torch.float32).contiguous()
    cf = centers.to(torch.float32).contiguous()
    cq = csq.to(torch.float32).contiguous()
    valid = center_valid.to(torch.int32).contiguous()
    labels = torch.empty((H, n), dtype=torch.int32, device=dev)
    d2 = torch.empty((H, n), dtype=torch.float32, device=dev)
    if n == 0:
        return labels, d2
    err = _heads_entry()(xf.data_ptr(), cf.data_ptr(), cq.data_ptr(),
                         valid.data_ptr(), H, n, k, d, labels.data_ptr(),
                         d2.data_ptr(), _device_index(dev),
                         torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "distance_argmin_l2_heads")
    distance_argmin_l2_heads.launches += 1
    return labels, d2


distance_argmin_l2_heads.launches = 0


def distance_argmin_l2_accumulate(x: torch.Tensor, centers: torch.Tensor,
                                  center_valid: torch.Tensor):
    """Launch the accumulating kernel: (labels (n,) int32, d² (n,) f32,
    sums (k, d) f32, counts (k,) f32).

    Labels and d² equal ``distance_argmin_l2``'s bit for bit; ``sums[j]``
    adds the float32 rows labelled j and ``counts[j]`` counts them, in an
    order fixed by the shapes alone. Inputs as for ``distance_argmin_l2``.
    Reads the number of valid centers on the host (the slots' size).
    Counts one launch in ``distance_argmin_l2_accumulate.launches``.
    """
    dev = x.device
    xf, cf, csq, valid = _prepare(x, centers, center_valid)
    n, d = xf.shape
    k = cf.shape[0]
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    cnt = torch.empty((k,), dtype=torch.float32, device=dev)
    if n == 0:
        return labels, d2, sums.zero_(), cnt.zero_()
    slots = min(ACC_SLOTS, -(-n // BN))
    n_valid = int(torch.count_nonzero(valid))
    live = n_valid + (n_valid < k)      # the valid centers, the first invalid
    slot_sums = torch.empty((slots, live, d), dtype=torch.float32, device=dev)
    slot_cnt = torch.empty((slots, live), dtype=torch.float32, device=dev)
    cmap = torch.empty((k,), dtype=torch.int32, device=dev)
    err = _acc_entry()(xf.data_ptr(), cf.data_ptr(), csq.data_ptr(),
                       valid.data_ptr(), n, k, d, live, labels.data_ptr(),
                       d2.data_ptr(), slot_sums.data_ptr(),
                       slot_cnt.data_ptr(), cmap.data_ptr(), slots,
                       sums.data_ptr(), cnt.data_ptr(), _device_index(dev),
                       torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "distance_argmin_l2_accumulate")
    distance_argmin_l2_accumulate.launches += 1
    return labels, d2, sums, cnt


distance_argmin_l2_accumulate.launches = 0


def l2_absorb_heads(keys: torch.Tensor, values: torch.Tensor,
                    centers: torch.Tensor, v_cent: torch.Tensor,
                    radius: torch.Tensor, v_radius: torch.Tensor,
                    mass: torch.Tensor, center_valid: torch.Tensor,
                    v_max: torch.Tensor, csq: torch.Tensor,
                    decay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the decode step's absorb once for all kv heads of a layer:
    route each head's new key and EMA-drift the hit cluster, in place.
    Returns (labels (H, 1) int32, squared distances (H, 1) float32).

    ``keys`` and ``values`` (H, 1, d) float32 or bfloat16 (one type; any
    head stride, each row contiguous: the layer's fresh K/V as a view);
    the layer's state, written in place: ``centers`` and ``v_cent`` (H, K,
    d), ``radius``, ``v_radius`` and ``mass`` (H, K), ``v_max`` (H,), all
    float32; ``center_valid`` (H, K) bool; ``csq`` (H, K) float32 the
    centers' squared norms (``torch.sum(centers * centers, -1)``, so the
    labels and d² are ``distance_argmin_l2_heads``' bits); ``decay`` (1,)
    float32, the EMA's factor for one row, ``torch.pow(1 - ema, 1.0)`` as
    the plain EMA computes it on this device. Only n = 1 (a decode step):
    other n raise. Counts one launch in ``l2_absorb_heads.launches``.
    """
    what = "l2_absorb_heads"
    if keys.ndim != 3 or keys.shape[1] != 1 or values.shape != keys.shape:
        raise ValueError(f"{what}: expected keys and values (H, 1, d), got "
                         f"{tuple(keys.shape)} and {tuple(values.shape)}")
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    H, _, d = keys.shape
    state = (centers, v_cent, radius, v_radius, mass, v_max, csq)
    if any(t.device != dev for t in state + (values, center_valid, decay)):
        raise ValueError(f"{what}: inputs must share a device")
    if centers.ndim != 3 or centers.shape[0] != H or centers.shape[2] != d \
            or v_cent.shape != centers.shape:
        raise ValueError(f"{what}: centers and v_cent must be ({H}, K, {d})")
    K = centers.shape[1]
    if any(tuple(t.shape) != (H, K) for t in (radius, v_radius, mass, csq,
                                               center_valid)) \
            or tuple(v_max.shape) != (H,) or tuple(decay.shape) != (1,):
        raise ValueError(f"{what}: radius, v_radius, mass, csq and "
                         f"center_valid must be ({H}, {K}), v_max ({H},), "
                         "decay (1,)")
    if any(t.dtype != torch.float32 for t in state + (decay,)) \
            or center_valid.dtype != torch.bool:
        raise TypeError(f"{what}: the state is float32, center_valid bool")
    if keys.dtype != values.dtype or keys.dtype not in (torch.float32,
                                                        torch.bfloat16):
        raise TypeError(f"{what}: keys and values must be both float32 or "
                        f"both bfloat16, got {keys.dtype}, {values.dtype}")
    if not all(t.is_contiguous() for t in state + (center_valid,)):
        raise ValueError(f"{what}: the state must be contiguous (it is "
                         "written in place)")
    if H == 0 or K == 0 or d == 0 or 8 * d > 48 * 1024:
        raise ValueError(f"{what}: need heads, centers and 1 <= d <= 6144")
    keys, values = (t if t.stride(-1) == 1 else t.contiguous()
                    for t in (keys, values))
    labels = torch.empty((H, 1), dtype=torch.int32, device=dev)
    d2 = torch.empty((H, 1), dtype=torch.float32, device=dev)
    err = _absorb_entry()(
        keys.data_ptr(), keys.stride(0), values.data_ptr(), values.stride(0),
        int(keys.dtype == torch.bfloat16), centers.data_ptr(),
        v_cent.data_ptr(), radius.data_ptr(), v_radius.data_ptr(),
        mass.data_ptr(), center_valid.data_ptr(), csq.data_ptr(),
        v_max.data_ptr(), decay.data_ptr(), H, K, d, labels.data_ptr(),
        d2.data_ptr(), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    l2_absorb_heads.launches += 1
    return labels, d2


l2_absorb_heads.launches = 0
