"""Flash attention and mass-weighted centroid attention, the hand-written
CUDA kernels' wrappers.

``flash_attention`` replaces ``repro/kernels/flash_attention.py::
flash_attention`` (the TPU kernel ``_kernel`` under it): the causal or
non-causal GQA online-softmax forward, float32 inside, output in q's
dtype. In the port it runs the LM's prefill into an empty KV cache
(``models.layers.cache_attention``), which the reference computes as a
masked float32 softmax over the cache: the same function.

``flash_centroid_attention`` replaces ``flash_centroid_attention``: the
clustered-KV decode step ``softmax_K(q·c/√dh + log_mass) @ v_cent``
(``serve.kv_cluster.clustered_attention``). The reference reuses its
flash kernel through an augmented ``dh + 1`` lane; here ``log_mass`` is a
bias added after the product, in the same tile routine.

``flash_centroid_decode`` is the same function for the decode step alone
(S = 1), a kernel of its own: it reads one layer's stacked clustered
state in place (centroids, value centroids, mass and validity) and the
step's fresh K/V row through two more pointers with log-mass 0, computing
the log-mass from the mass inside the kernel, so the step builds no
snapshot and concatenates nothing. One block per kv head serves its group
of query heads. Its plain version is ``ref.centroid_decode_ref``.

Bound on this card: the prefill's attention is bound by operations (8.6
GFLOP causal against 12.6 MB at Qwen3-0.6B's S = 2,048), the decode
step's by launch latency. Design (``csrc/flash_attention.cu``): one block
per (64-query tile, query head, batch), the key loop ending at the causal
frontier; ragged S and K masked in the kernel. Two routines, by element
type (``ROUTINES``): bf16 q, k, v (the prefill) run on the tensor cores
(``mma.sync`` for Q·Kᵀ and P·V, K and V tiles staged by ``cp.async``,
double-buffered; P enters P·V as three bf16 parts so that it keeps
float32 accuracy); float32 runs float32 FMA on the CUDA cores. The centroid
kernel shares the float32 routine's tile code. The plain versions are
``ref.attention_ref`` and ``ref.centroid_attention_ref``.

The kernels are forward only, as the reference's are (it trains through
XLA's attention): each wrapper writes into a fresh tensor, which autograd
cannot see into. So every entry raises on an input that requires grad
while grad mode is on, rather than return an output cut off from the
graph; training takes the plain attention (``models.layers.attn_apply``
without a cache).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p])
_CENTROID_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_void_p,
                                               ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_void_p, ctypes.c_float,
                                              ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the routine ``flash_attention`` launches for each element type
ROUTINES = {torch.bfloat16: "bf16 tensor cores (mma.sync, cp.async)",
            torch.float32: "float32 CUDA cores (FMA)"}
MAX_DH = 128
#: the decode routine's shared memory limit (Hopper: 227 KiB a block)
_MAX_SMEM = 227 * 1024


_entries: dict = {}


def _entry(name: str, argtypes):
    """The C entry ``name``, its argument types set once."""
    if name not in _entries:
        fn = getattr(build.load("flash_attention"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def forward_only(what: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires grad: the kernel has
    no backward pass, and its output would not carry the gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel is forward only and its output would be cut "
            "off from the autograd graph; call it under torch.no_grad(), or "
            "train through the plain attention (attn_apply without a cache)")


def _prepare(q, kv: tuple, what: str):
    """Check the inputs; return them in one element type (q's when all
    share a type the kernel takes, else float32), each with a contiguous
    feature axis (other strides, broadcasts included, pass as they are)."""
    forward_only(what, q, *kv)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    if any(t.device != dev for t in kv):
        raise ValueError(f"{what}: inputs must share a device")
    if q.ndim != 4 or any(t.ndim != 4 for t in kv):
        raise ValueError(f"{what}: expected 4-d (B, H, S, dh) inputs")
    B, Hq, _, dh = q.shape
    shape = kv[0].shape
    if any(t.shape != shape for t in kv) or shape[0] != B or shape[3] != dh:
        raise ValueError(f"{what}: q {tuple(q.shape)} and keys/values "
                         f"{[tuple(t.shape) for t in kv]} do not match")
    if shape[1] == 0 or Hq % shape[1]:
        raise ValueError(f"{what}: GQA needs Hkv | Hq, got {shape[1]}, {Hq}")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"{what}: head dim {dh} not in [1, {MAX_DH}]")
    types = {q.dtype, *(t.dtype for t in kv)}
    if not types <= set(_DTYPES):
        raise TypeError(f"{what}: expected float32 or bfloat16, got {types}")
    dt = q.dtype if len(types) == 1 else torch.float32
    out = [t.to(dt) for t in (q, *kv)]
    return [t if t.stride(-1) == 1 else t.contiguous() for t in out], dt


def _strides(*tensors) -> list[int]:
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, S, dh), k and v (B, Hkv, S, dh), float32
    or bfloat16 on one CUDA device, Hkv | Hq, dh ≤ 128. Returns (B, Hq, S,
    dh) in q's dtype. Counts one launch in ``flash_attention.launches``,
    and one in ``flash_attention.by_routine`` under the routine it took
    (``ROUTINES``: all bf16 inputs take the tensor cores, any float32 input
    the float32 routine)."""
    (qc, kc, vc), dt = _prepare(q, (k, v), "flash_attention")
    B, Hq, S, dh = qc.shape
    if kc.shape[2] != S:
        raise ValueError(f"flash_attention: keys have {kc.shape[2]} rows, "
                         f"queries {S}")
    out = torch.empty((B, Hq, S, dh), dtype=dt, device=q.device)
    if B * S == 0:
        return out.to(q.dtype)
    dims = (ctypes.c_longlong * 5)(B, Hq, kc.shape[1], S, dh)
    strides = (ctypes.c_longlong * 9)(*_strides(qc, kc, vc))
    err = _entry("repro_flash_attention", _ARGTYPES)(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        _DTYPES[dt], dims, strides, int(causal), 1.0 / math.sqrt(dh),
        _device_index(q.device), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.by_routine[ROUTINES[dt]] += 1
    return out.to(q.dtype)


flash_attention.launches = 0
flash_attention.by_routine = dict.fromkeys(ROUTINES.values(), 0)


def flash_centroid_attention(q: torch.Tensor, centers: torch.Tensor,
                             v_cent: torch.Tensor,
                             log_mass: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``softmax_K(q·c/√dh + log_mass) @ v_cent`` of q
    (B, Hq, S, dh) over centers and v_cent (B, Hkv, K, dh), log_mass
    (B, Hkv, K) (``-1e30`` = dead; all dead gives the mean of v_cent).
    Returns (B, Hq, S, dh) in q's dtype. Counts one launch in
    ``flash_centroid_attention.launches`` (which ``flash_centroid_decode``
    ticks too)."""
    forward_only("flash_centroid_attention", log_mass)
    (qc, cc, vc), dt = _prepare(q, (centers, v_cent),
                                "flash_centroid_attention")
    B, Hq, S, dh = qc.shape
    Hkv, K = cc.shape[1], cc.shape[2]
    if tuple(log_mass.shape) != (B, Hkv, K) or log_mass.device != q.device:
        raise ValueError(f"flash_centroid_attention: log_mass must be "
                         f"({B}, {Hkv}, {K}) on {q.device}")
    if K == 0:
        raise ValueError("flash_centroid_attention: no centroid rows")
    lm = log_mass.to(torch.float32)
    if lm.stride(-1) != 1:
        lm = lm.contiguous()
    out = torch.empty((B, Hq, S, dh), dtype=dt, device=q.device)
    if B * S == 0:
        return out.to(q.dtype)
    dims = (ctypes.c_longlong * 6)(B, Hq, Hkv, S, K, dh)
    strides = (ctypes.c_longlong * 11)(*_strides(qc, cc, vc),
                                       *lm.stride()[:2])
    err = _entry("repro_flash_centroid_attention", _CENTROID_ARGTYPES)(
        qc.data_ptr(), cc.data_ptr(), vc.data_ptr(), lm.data_ptr(),
        out.data_ptr(), _DTYPES[dt], dims, strides, 1.0 / math.sqrt(dh),
        _device_index(q.device), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_centroid_attention")
    flash_centroid_attention.launches += 1
    return out.to(q.dtype)


flash_centroid_attention.launches = 0


def _decode_smem_bytes(group: int, rows: int, dh: int) -> int:
    """Shared memory of one decode block (``csrc``'s ``dec::smem_floats``)."""
    return 4 * (128 * (dh + 1) + group * (2 * dh + rows + 1))


def flash_centroid_decode(q: torch.Tensor, centers: torch.Tensor,
                          v_cent: torch.Tensor, mass: torch.Tensor,
                          center_valid: torch.Tensor,
                          extra_k: torch.Tensor | None = None,
                          extra_v: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Launch the decode routine: ``softmax(q·c/√dh + log_mass) @ v_cent``
    of the one-row queries q (B, 1, Hq, dh) (the layer layout) over one
    layer's state, read in place: centers and v_cent (Hkv, K, dh) float32,
    mass (Hkv, K) float32 and center_valid (Hkv, K) bool, log_mass =
    log(max(mass, 1e-9)) where valid and mass > 0, else -1e30; plus, when
    given, the fresh rows extra_k, extra_v (B, 1, Hkv, dh) with log-mass 0.
    Returns (B, 1, Hq, dh) in q's dtype. Counts one launch in
    ``flash_centroid_decode.launches`` and one in
    ``flash_centroid_attention.launches``, which counts both kernels of
    the function."""
    what = "flash_centroid_decode"
    forward_only(what, q, centers, v_cent, mass, extra_k, extra_v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    state = (centers, v_cent, mass, center_valid)
    extras = () if extra_k is None else (extra_k, extra_v)
    if (extra_k is None) != (extra_v is None):
        raise ValueError(f"{what}: give extra_k and extra_v together")
    if any(t.device != dev for t in state + extras):
        raise ValueError(f"{what}: inputs must share a device")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"{what}: expected q (B, 1, Hq, dh), got "
                         f"{tuple(q.shape)}")
    B, _, Hq, dh = q.shape
    if centers.ndim != 3 or v_cent.shape != centers.shape or \
            centers.shape[2] != dh:
        raise ValueError(f"{what}: centers and v_cent must be (Hkv, K, {dh})")
    Hkv, K = centers.shape[:2]
    if tuple(mass.shape) != (Hkv, K) or tuple(center_valid.shape) != (Hkv, K):
        raise ValueError(f"{what}: mass and center_valid must be ({Hkv}, {K})")
    if any(tuple(t.shape) != (B, 1, Hkv, dh) for t in extras):
        raise ValueError(f"{what}: extra rows must be ({B}, 1, {Hkv}, {dh})")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{what}: GQA needs Hkv | Hq, got {Hkv}, {Hq}")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"{what}: head dim {dh} not in [1, {MAX_DH}]")
    rows = K + (1 if extras else 0)
    if rows == 0 or _decode_smem_bytes(Hq // Hkv, rows, dh) > _MAX_SMEM:
        raise ValueError(f"{what}: {rows} rows do not fit one block")
    types = {q.dtype, *(t.dtype for t in extras)}
    if not types <= set(_DTYPES):
        raise TypeError(f"{what}: expected float32 or bfloat16, got {types}")
    dt = q.dtype if len(types) == 1 else torch.float32
    qc, *xs = (t.to(dt) for t in (q, *extras))
    qc, *xs = (t if t.stride(-1) == 1 else t.contiguous() for t in (qc, *xs))
    c, vc, m = (t.to(torch.float32).contiguous()
                for t in (centers, v_cent, mass))
    valid = center_valid.to(torch.bool).contiguous()
    out = torch.empty((B, 1, Hq, dh), dtype=dt, device=dev)
    if B == 0:
        return out.to(q.dtype)
    if xs and xs[0].stride()[:3] != xs[1].stride()[:3]:
        xs = [t.contiguous() for t in xs]     # the kernel takes one stride set
    xk, xv = xs if xs else (None, None)
    dims = (ctypes.c_longlong * 5)(B, Hq, Hkv, K, dh)
    strides = (ctypes.c_longlong * 4)(
        qc.stride(0), qc.stride(2),
        *((xk.stride(0), xk.stride(2)) if xs else (0, 0)))
    err = _entry("repro_flash_centroid_decode", _DECODE_ARGTYPES)(
        qc.data_ptr(), c.data_ptr(), vc.data_ptr(), m.data_ptr(),
        valid.data_ptr(), None if xk is None else xk.data_ptr(),
        None if xv is None else xv.data_ptr(), out.data_ptr(), _DTYPES[dt],
        dims, strides, 1.0 / math.sqrt(dh), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    flash_centroid_decode.launches += 1
    flash_centroid_attention.launches += 1
    return out.to(q.dtype)


flash_centroid_decode.launches = 0
