"""Out-of-core GEEK for every data kind: discover on a reservoir, then
stream the transformation + assignment over host chunks.

The counterpart of ``repro.core.streaming``. The paper's cost split is an
expensive discovery phase (LSH transformation + SILK) and ONE cheap
assignment pass. The streaming fit bounds the pass's device memory by the
chunk instead of n:

1. A stride-sampled reservoir (every ``ceil(n / seed_cap)``-th row) is
   coded, bucketed and SILK-seeded once (``core.api``'s discovery). With
   ``seed_cap=None`` the reservoir is the whole dataset and seeds and
   centers are the in-core fit's, bit for bit. Its device copy is
   released before the pass.
2. The pass streams host chunks of exactly ``chunk`` rows (pieces of any
   size are re-cut and coalesced; a ragged tail is padded with zero
   sentinel rows that count nowhere). Each chunk is coded by the model's
   fit-time transform and assigned by the shared one-pass dispatch, both
   row-independent, so the labels are the in-core fit's whatever the
   chunk size. On the card each chunk is copied into a pinned host buffer
   and from there to the device on a copy stream, two chunks in flight:
   chunk i+1 crosses while chunk i is assigned (where the reference lets
   XLA reuse donated buffers). Labels and distances come back into
   pinned host memory; the per-cluster radius is a running maximum on
   the device.

``data`` may be arrays or tensors (chunks are sliced from them) or an
iterator of host chunks. With ``mesh=`` every rank calls the fit with the
same data: each chunk is split evenly over the ranks, each assigns its
rows, the labels are all-gathered and the radius is ``pmax``-reduced, so
every rank gets the in-core result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core.geek import GeekConfig, GeekResult
from repro_torch.utils import compat
from repro_torch.utils.device import parts_to_device


# ---------------------------------------------------------------------------
# Host-side chunking over tuples of parallel arrays
# ---------------------------------------------------------------------------
# Every streamed input becomes an iterator of part tuples: (x,) dense,
# (x_num, x_cat) hetero, (sets, mask) sparse, absent parts None in every
# tuple.

def _host(p) -> np.ndarray:
    """A part as a host numpy array (a device tensor is copied back)."""
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


def _is_matrix(data) -> bool:
    return hasattr(data, "shape") and len(data.shape) == 2


def _as_piece_stream(data, nparts: int):
    """Normalize array / tuple-of-arrays / iterator input to an iterator
    of part tuples of host arrays (None slots kept)."""
    def to_tuple(piece):
        if nparts == 1 and not isinstance(piece, (tuple, list)):
            piece = (piece,)
        if not isinstance(piece, (tuple, list)) or len(piece) != nparts:
            raise ValueError(f"expected {nparts}-part chunks, got "
                             f"{type(piece).__name__}")
        return tuple(None if p is None else _host(p) for p in piece)

    if nparts == 1 and _is_matrix(data):
        yield to_tuple(data)                      # one whole array
    elif nparts > 1 and isinstance(data, (tuple, list)):
        yield to_tuple(data)                      # whole arrays in one piece
    else:
        for piece in data:
            yield to_tuple(piece)


def _cat_parts(bufs: list[tuple]) -> tuple:
    """Concatenate a list of part tuples row-wise, slot by slot."""
    out = []
    for i in range(len(bufs[0])):
        if bufs[0][i] is None:
            out.append(None)
            continue
        ps = [t[i] for t in bufs]
        out.append(np.concatenate(ps, axis=0) if len(ps) > 1
                   else np.ascontiguousarray(ps[0]))
    return tuple(out)


def _rows(parts: tuple) -> int:
    return next(p.shape[0] for p in parts if p is not None)


def _iter_chunks(pieces, chunk: int):
    """Yield part tuples of exactly ``chunk`` rows (the last one ragged)."""
    buf: list[tuple] = []
    have = 0
    first_slots = None
    for parts in pieces:
        slots = tuple(p is not None for p in parts)
        if first_slots is None:
            first_slots = slots
        elif slots != first_slots:
            raise ValueError("inconsistent None parts across chunks")
        sizes = {p.shape[0] for p in parts if p is not None}
        if not sizes:
            raise ValueError("every part of a chunk is None")
        if len(sizes) != 1:
            raise ValueError(f"chunk parts disagree on rows: {sizes}")
        for p in parts:
            if p is not None and p.ndim != 2:
                raise ValueError(f"chunks must be (m, d), got {p.shape}")
        m, start = sizes.pop(), 0
        while start < m:
            take = min(chunk - have, m - start)
            buf.append(tuple(None if p is None else p[start:start + take]
                             for p in parts))
            have += take
            start += take
            if have == chunk:
                yield _cat_parts(buf)
                buf, have = [], 0
    if have:
        yield _cat_parts(buf)


def _stride_sample(chunks: list[tuple], n: int, seed_cap: int | None,
                   whole: tuple | None):
    """The discovery reservoir: a stride-sampled part tuple and the
    dataset row of each reservoir row (None when it is the dataset).
    ``whole`` is the array input, reused at stride 1 without a copy."""
    stride = 1 if seed_cap is None or seed_cap >= n else -(-n // seed_cap)
    if stride == 1:
        return (whole if whole is not None else _cat_parts(chunks)), None
    bufs, idx_parts, off = [], [], 0
    for parts in chunks:
        m = _rows(parts)
        first = (-off) % stride
        bufs.append(tuple(None if p is None else p[first::stride]
                          for p in parts))
        idx_parts.append(np.arange(off + first, off + m, stride,
                                   dtype=np.int64))
        off += m
    return _cat_parts(bufs), np.concatenate(idx_parts)


def _pad_rows(p: np.ndarray, to: int) -> np.ndarray:
    """Sentinel rows: zeros (False for masks). Rows are assigned
    independently and the padded ones are dropped."""
    pad = np.zeros((to - p.shape[0], p.shape[1]), p.dtype)
    return np.concatenate([p, pad], axis=0)


def _check_mesh_chunk(mesh, chunk: int) -> None:
    """Sharded streaming needs the chunk's rows to split evenly."""
    if mesh is not None and chunk % mesh.size:
        raise ValueError(f"chunk={chunk} must be a multiple of the mesh "
                         f"size g={mesh.size} for sharded streaming")


def _collect(data, nparts: int, chunk: int):
    """Host chunks, the row count, and the no-copy ``whole`` tuple when
    the input was in-memory arrays."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    whole = None
    if nparts == 1 and _is_matrix(data):
        whole = (_host(data),)
    elif nparts > 1 and isinstance(data, (tuple, list)):
        whole = tuple(None if p is None else _host(p) for p in data)
    pieces = _as_piece_stream(whole if whole is not None else data, nparts)
    chunks = list(_iter_chunks(pieces, chunk))
    if not chunks:
        raise ValueError("streaming fit: empty input")
    return chunks, sum(_rows(c) for c in chunks), whole


# ---------------------------------------------------------------------------
# The streamed one-pass assignment
# ---------------------------------------------------------------------------

class _Stager:
    """Host chunks to the card through two pinned buffers a part and a
    copy stream: ``put(i, parts)`` fills slot ``i % 2`` once its previous
    copy has left it, copies it to the device on the copy stream once the
    compute stream is done with that slot's device buffer, and makes the
    compute stream wait for the copy; it returns the slot's device
    buffers cut to the parts' rows (at most ``rows``). ``done(i)`` marks
    slot ``i % 2``'s device buffer free. The buffers are allocated once,
    before the pass (``serve.engine`` shares them between micro-batches
    of up to ``rows`` rows)."""

    def __init__(self, like: tuple, rows: int, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.host, self.dev = [], []
        for _ in range(2):
            hbuf, dbuf = [], []
            for p in like:
                if p is None:
                    hbuf.append(None)
                    dbuf.append(None)
                    continue
                dt = parts_to_device((p[:0],), "cpu")[0].dtype
                shape = (rows, p.shape[1])
                hbuf.append(torch.empty(shape, dtype=dt, pin_memory=True))
                dbuf.append(torch.empty(shape, dtype=dt, device=device))
            self.host.append(hbuf)
            self.dev.append(dbuf)
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.freed = [torch.cuda.Event() for _ in range(2)]

    def put(self, i: int, parts: tuple) -> tuple:
        s, m = i % 2, _rows(parts)
        self.copied[s].synchronize()          # the pinned slot is free again
        for h, p in zip(self.host[s], parts):
            if h is not None:
                h[:m].copy_(torch.from_numpy(p))
        with torch.cuda.stream(self.stream):
            if i >= 2:
                self.stream.wait_event(self.freed[s])
            for d, h in zip(self.dev[s], self.host[s]):
                if d is not None:
                    d[:m].copy_(h[:m], non_blocking=True)
            self.copied[s].record(self.stream)
        torch.cuda.current_stream().wait_event(self.copied[s])
        return tuple(None if d is None else d[:m] for d in self.dev[s])

    def done(self, i: int) -> None:
        self.freed[i % 2].record(torch.cuda.current_stream())


def _streamed_fit(chunks: list[tuple], n: int, cfg: GeekConfig, chunk: int,
                  model, seeds, overflow, sample_idx, *, assigner,
                  mesh=None):
    """The streamed pass over ``chunks`` with a model built on the
    reservoir. Returns (result, model with the pass's radius, the pass's
    device memory in bytes or None on the CPU).

    The result's labels and dists are (n,) host tensors; centers, seeds
    and radius live on the model's device. The pass's memory is its peak
    above what was allocated when it began (the model, and whatever the
    caller holds): on the card the device's peak memory statistics are
    reset when the pass starts and read when it ends.
    """
    dev = model.device
    if sample_idx is not None:   # reservoir positions -> dataset rows
        idx = torch.as_tensor(sample_idx, device=dev)
        gid = idx[torch.clamp(seeds.id.to(torch.int64), 0, idx.numel() - 1)]
        seeds = seeds._replace(id=torch.where(seeds.valid, gid.to(
            seeds.id.dtype), seeds.id))
    g = 1 if mesh is None else mesh.size
    r = 0 if mesh is None else mesh.rank
    cl = chunk // g                          # this rank's rows of a chunk
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        stager = _Stager(chunks[0], cl, dev)
    labels = torch.empty((n,), dtype=torch.int32, pin_memory=on_card)
    dists = torch.empty((n,), dtype=torch.float32, pin_memory=on_card)
    radius = torch.zeros((cfg.k_max,), dtype=torch.float32, device=dev)
    off = 0
    for i, parts in enumerate(chunks):
        m = _rows(parts)
        if m < chunk:    # ragged tail: sentinel rows, dropped below
            parts = tuple(None if p is None else _pad_rows(p, chunk)
                          for p in parts)
        local = tuple(None if p is None else p[r * cl:(r + 1) * cl]
                      for p in parts)
        if on_card:
            dparts = stager.put(i, local)
        else:
            dparts = parts_to_device(local, dev)
        lab, dst = assigner.assign(model, model.encode(*dparts))
        real = min(max(m - r * cl, 0), cl)   # this rank's non-sentinel rows
        radius = torch.maximum(radius, assign_mod.cluster_radius(
            dst[:real], lab[:real], cfg.k_max))
        if mesh is not None:
            lab = compat.all_gather(lab, mesh).reshape(-1)
            dst = compat.all_gather(dst, mesh).reshape(-1)
        labels[off:off + m].copy_(lab[:m], non_blocking=True)
        dists[off:off + m].copy_(dst[:m], non_blocking=True)
        if on_card:
            stager.done(i)
        off += m
    if mesh is not None:
        radius = compat.pmax(radius, mesh)
    peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    model = dataclasses.replace(model, radius=radius)
    result = GeekResult(labels, dists, model.centers, model.center_valid,
                        model.k_star, radius, seeds, overflow)
    return result, model, peak
